"""`correct` comes out false when the timed path is broken underneath, and
when the control (the reference in the nearest lower precision) stands in
the program's place: each fault a GEMM cell can have, driven through the
rest of a run on the CPU at a small size. No cell spans chips, so the
exchange between chips has no fault to plant."""
import pytest
import torch

from h100bench import run
from h100bench_helpers import SMALL, run_small, small_spec

# the warm-up calls set 0, then set 1, then alternate; the window follows
FIRST_TIMED = SMALL["warmup_calls"] + 1
CELLS = ["dgemm-int8-nu16.sq8192", "zgemm-int8-nu16.sq8192",
         "dgemm-int8-nu16.upd8192k512"]


def program(spec):
    return run.entry_module(spec).make(spec["config"], spec["traffic"],
                                       torch.device("cpu"))


def unchanged(spec):
    """A step that returns its state unchanged: every call hands back the
    first call's output, whatever its operands."""
    inner, first = program(spec), []

    def call(ops):
        if not first:
            first.append(inner(ops))
        return first[0].clone()
    return call


def unchanged_in_window(spec):
    """As unchanged, in the timed calls only: from the first of them on,
    every call hands back the last warm-up call's output of set 1."""
    inner, calls, kept = program(spec), [0], []

    def call(ops):
        calls[0] += 1
        if calls[0] < FIRST_TIMED:
            out = inner(ops)
            if calls[0] == 2:
                kept.append(out.clone())
            return out
        return kept[0].clone()
    return call


def half_k(spec):
    """Half of the k-sum left out, the rest doubled (the mean over the
    half kept), as a program that skipped half its products would."""
    inner = program(spec)

    def call(ops):
        h = ops["a"].shape[1] // 2
        part = dict(ops, a=2 * ops["a"][:, :h], b=ops["b"][:h])
        return inner(part)
    return call


def altered(spec, from_call=1):
    """One element of the answer altered where it is produced."""
    inner, calls = program(spec), [0]

    def call(ops):
        calls[0] += 1
        out = inner(ops)
        if calls[0] >= from_call:
            out[out.shape[0] // 2, out.shape[1] // 3] += 1.0
        return out
    return call


def moved_in_window(spec, dim):
    """The right values in the wrong places, in the timed calls only: the
    answer's rows (dim 0) or columns (dim 1) rotated by one, which keeps
    every value and so any plain sum of them."""
    inner, calls = program(spec), [0]

    def call(ops):
        calls[0] += 1
        out = inner(ops)
        return out.roll(1, dims=dim) if calls[0] >= FIRST_TIMED else out
    return call


FAULTS = {"unchanged": unchanged, "unchanged_in_window": unchanged_in_window,
          "half_k": half_k, "altered": altered,
          "altered_in_window": lambda spec: altered(spec, FIRST_TIMED),
          "rows_moved_in_window": lambda spec: moved_in_window(spec, 0),
          "columns_moved_in_window": lambda spec: moved_in_window(spec, 1)}


@pytest.mark.parametrize("cell", CELLS)
def test_sound_program_is_correct(cell):
    result = run_small(small_spec(cell))
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault):
    spec = small_spec(cell)
    result = run_small(spec, call=FAULTS[fault](spec))
    assert result["correct"] is False, (fault, result["checks"])
    assert result["failed"] > 0


@pytest.mark.parametrize("dim", [0, 1])
def test_checksum_sees_values_moved(dim):
    out = torch.randn(160, 96, dtype=torch.float64)
    z = torch.complex(out, torch.randn(160, 96, dtype=torch.float64))
    assert run.checksum(out).tolist() != run.checksum(
        out.roll(1, dims=dim)).tolist()
    assert run.checksum(z).tolist() != run.checksum(
        z.roll(1, dims=dim)).tolist()
    # the real and imaginary parts swapped
    assert run.checksum(z).tolist() != run.checksum(
        torch.complex(z.imag, z.real)).tolist()
    # and the same bits read the same checksum
    assert run.checksum(out).tolist() == run.checksum(out.clone()).tolist()


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    spec = small_spec(cell)
    reference = run.reference_module(spec)
    result = run_small(spec, call=reference.control(spec["config"],
                                                    spec["traffic"]))
    assert result["correct"] is False
    assert result["checks"]["gap"]["value"] > 10 * spec["limits"]["gap"]
