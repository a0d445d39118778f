"""Small cells on the CPU for the benchmark's tests: the real cells' files
with the mix cut to a size a test run can hold."""
import time

from h100bench import run

SMALL = {"m": 160, "n": 96, "k": 128, "warmup_calls": 3, "trace_calls": 2}


class FakePower:
    """A steady 300 W, a sample every 20 ms, in place of nvidia-smi."""

    def sample(self):
        time.sleep(0.02)
        return 300.0

    def close(self):
        pass


def small_spec(cell="dgemm-int8-nu16.sq8192", **mix):
    spec = run.cell_spec(cell)
    spec["traffic"].update(SMALL, **mix)
    return spec


def run_small(spec, call=None, seed=2 ** 31 + 7, seconds=0.3, traced=False):
    result, _ = run.run(spec, seed, seconds, traced, "cpu", call=call,
                        sampler=FakePower())
    return result
