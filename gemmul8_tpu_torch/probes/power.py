"""Power and efficiency on the card: watts and GFLOPS/W of the emulated
GEMM, the counterpart of benchmarks/power.py and the reference's power
protocol (testing/test_watt.hpp, getWatt.hpp:94-121): a sampling thread
reads the draw every --period seconds (100 ms) while a loop of `gemm`
calls (4096^3, nu = 16) runs for at least --seconds, each batch of calls
ending in torch.cuda.synchronize(); the energy is the trapezoidal integral
of the samples that are not NaN, the efficiency flops / energy.

Power sources, in order:
  1. nvidia-smi: ONE streaming process, `nvidia-smi --query-gpu=power.draw
     --format=csv,noheader,nounits -i <idx> -lms <period>`, read a line a
     sample (no process per sample);
  2. Linux RAPL (/sys/class/powercap), the CPU packages;
  3. none: watts and gflops_per_watt are null.
A failed read counts as an error and never stops the sampling thread. The
JAX harness's `tpu-info` source has no counterpart: there is no TPU.

    python -m gemmul8_tpu_torch.probes.power [--size 4096] [--nu 16]
        [--seconds 10] [--period 0.1] [--device cuda|cpu]

Prints one JSON object: the protocol's keys, with `device` (the card's
name and power limit) and `power_source`.
"""
from __future__ import annotations

import argparse
import datetime
import glob
import json
import math
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch


def parse_nvidia_smi_power(text: str) -> float:
    """Watts from nvidia-smi's power.draw query output: one reading a line
    ("312.45", or "312.45 W" without nounits), summed over the lines (one
    line a card). NaN where a line says "[N/A]" or "[Not Supported]", or
    no reading is present."""
    total, found = 0.0, False
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        value = line.split()[0]
        try:
            total += float(value)
        except ValueError:          # "[N/A]", "[Not Supported]", garbage
            return float("nan")
        found = True
    return total if found else float("nan")


class NvidiaSmiSampler:
    """One streaming nvidia-smi process for the card `index`; sample()
    reads its next line, so it paces itself at nvidia-smi's period."""

    paced = True

    def __init__(self, index: int = 0, period: float = 0.1):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=power.draw",
             "--format=csv,noheader,nounits", "-i", str(index),
             "-lms", str(max(1, int(round(period * 1e3))))],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

    @staticmethod
    def available(index: int = 0) -> bool:
        try:
            r = subprocess.run(["nvidia-smi", "--query-gpu=power.draw",
                                "--format=csv,noheader,nounits", "-i",
                                str(index)], timeout=10, capture_output=True,
                               text=True)
            return (r.returncode == 0
                    and not math.isnan(parse_nvidia_smi_power(r.stdout)))
        except Exception:
            return False

    def sample(self) -> float:
        line = self.proc.stdout.readline()
        if not line:
            raise RuntimeError("the nvidia-smi stream ended")
        return parse_nvidia_smi_power(line)

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self.proc.stdout.close()


class RaplSampler:
    """Linux RAPL energy counters (CPU packages): watts from dE/dt."""

    BASE = "/sys/class/powercap"
    paced = False

    @classmethod
    def _zones(cls):
        return sorted(glob.glob(os.path.join(cls.BASE, "intel-rapl:?")))

    @classmethod
    def available(cls) -> bool:
        zones = cls._zones()
        if not zones:
            return False
        try:
            with open(os.path.join(zones[0], "energy_uj")) as f:
                f.read()
            return True
        except Exception:
            return False

    def __init__(self):
        self._last = None

    def sample(self) -> float:
        now = time.time()
        uj = 0
        for z in self._zones():
            with open(os.path.join(z, "energy_uj")) as f:
                uj += int(f.read())
        if self._last is None:
            self._last = (now, uj)
            return float("nan")   # no baseline yet: not a real 0 W reading
        t0, e0 = self._last
        self._last = (now, uj)
        return rapl_watts(e0, uj, now - t0)

    def close(self) -> None:
        pass


def rapl_watts(e0_uj: int, e1_uj: int, dt: float) -> float:
    """Watts from two RAPL energy_uj readings. The counter wraps at
    max_energy_range_uj; a wrapped interval (e1 < e0) cannot be recovered
    without the range, so that sample is NaN and dropped before the energy
    integral."""
    if e1_uj < e0_uj:
        return float("nan")
    return (e1_uj - e0_uj) * 1e-6 / max(dt, 1e-6)


def pick_sampler(index: int = 0, period: float = 0.1):
    """(sampler, source name): nvidia-smi, else RAPL, else (None, "none")."""
    if NvidiaSmiSampler.available(index):
        return NvidiaSmiSampler(index, period), "nvidia-smi"
    if RaplSampler.available():
        return RaplSampler(), "rapl"
    return None, "none"


class Poller:
    """The sampling thread: (time, watts) samples into `samples` until
    stop(); a read that raises is counted in `errors` and taken as NaN, and
    the thread goes on."""

    def __init__(self, sampler, period: float):
        self.sampler, self.period = sampler, period
        self.samples, self.errors = [], 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            failed = False
            try:
                w = self.sampler.sample() if self.sampler else float("nan")
            except Exception:
                if self._stop.is_set():      # the stream closed at stop()
                    break
                self.errors += 1
                w, failed = float("nan"), True
            self.samples.append((time.time(), w))
            paced = getattr(self.sampler, "paced", False)
            self._stop.wait(self.period if failed or not paced else 0)

    def start(self) -> "Poller":
        self._thread.start()
        return self

    def stop(self) -> list:
        """Stop sampling (closing the sampler) and return a snapshot of
        the samples."""
        self._stop.set()
        if self.sampler is not None:
            self.sampler.close()
        self._thread.join(timeout=5)
        return list(self.samples)


def energy(samples):
    """(joules, mean watts) by the trapezoidal rule over the samples whose
    watts are not NaN (getWatt.hpp:94-121); (nan, nan) with fewer than two."""
    snap = [s for s in samples if s[1] == s[1]]
    if len(snap) < 2:
        return float("nan"), float("nan")
    ts = np.array([s[0] for s in snap])
    ws = np.array([s[1] for s in snap])
    trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy < 2.0
    joules = float(trapezoid(ws, ts))
    return joules, joules / (ts[-1] - ts[0])


def measure(size: int = 4096, nu: int = 16, seconds: float = 10.0,
            period: float = 0.1, device="cuda", inner: int = 8) -> dict:
    """The protocol's result: gemm calls, TFLOP/s, watts and GFLOPS/W."""
    import gemmul8_tpu_torch as gt
    from gemmul8_tpu_torch import core
    device = core._device(device)
    on_card = device.type == "cuda"
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((size, size))).to(device)
    b = torch.from_numpy(rng.standard_normal((size, size))).to(device)

    def batch():
        for _ in range(inner):
            gt.gemm(a, b, num_moduli=nu, device=device)
        if on_card:
            torch.cuda.synchronize()

    batch()                                   # warm up
    index = (device.index if device.index is not None
             else torch.cuda.current_device()) if on_card else 0
    sampler, source = pick_sampler(index, period)
    if not on_card and source == "nvidia-smi":
        sampler.close()                       # a CPU run: the card idles
        sampler, source = ((RaplSampler(), "rapl") if RaplSampler.available()
                           else (None, "none"))
    poller = Poller(sampler, period).start()
    calls = 0
    try:
        t0 = time.time()
        while time.time() - t0 < seconds:
            batch()
            calls += inner
        elapsed = time.time() - t0
    finally:
        samples = poller.stop()
    if poller.errors:
        print(f"power: {poller.errors} failed sample(s) dropped",
              file=sys.stderr)
    flops = 2.0 * size ** 3 * calls
    joules, watts = energy(samples) if sampler else (float("nan"),) * 2
    gflops_per_watt = flops / 1e9 / max(joules, 1e-9) if joules == joules \
        else float("nan")

    def _j(v):
        # NaN is not valid JSON: the no-telemetry path reports null
        return None if isinstance(v, float) and v != v else v

    if on_card:
        from .fp8_calls import card
        dev_name = card()
    else:
        dev_name = "cpu"
    return {
        "size": size, "num_moduli": nu, "seconds": round(elapsed, 2),
        "gemm_calls": calls, "tflops": round(flops / elapsed / 1e12, 3),
        "power_source": source, "watts": _j(watts),
        "gflops_per_watt": _j(gflops_per_watt), "device": dev_name,
        "samples": sum(1 for s in samples if s[1] == s[1]),
        "sample_errors": poller.errors,
        "timestamp": datetime.datetime.now().isoformat(timespec="seconds"),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=4096)
    ap.add_argument("--nu", type=int, default=16)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--period", type=float, default=0.1,
                    help="sampling period (reference: 100 ms)")
    ap.add_argument("--device", default="cuda",
                    help="'cpu' runs the port's CPU path")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    result = measure(args.size, args.nu, args.seconds, args.period,
                     args.device)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
