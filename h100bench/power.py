"""The card's power over a window: one streaming `nvidia-smi` read a line a
sample on a thread, and the energy as the trapezoid of the samples (the
reference's getWatt.hpp:94-121). Copied from the port's probes/power.py,
without its fallback to the CPU's RAPL counters, which read the wrong part.
"""
from __future__ import annotations

import subprocess
import threading
import time

import numpy as np


def parse_nvidia_smi_power(text: str) -> float:
    """Watts from nvidia-smi's power.draw query output, summed over its lines
    (one a card); NaN where a line says "[N/A]" or no reading is present."""
    total, found = 0.0, False
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            total += float(line.split()[0])
        except ValueError:          # "[N/A]", "[Not Supported]", garbage
            return float("nan")
        found = True
    return total if found else float("nan")


class NvidiaSmiSampler:
    """One streaming nvidia-smi process for the card `index`; sample() reads
    its next line, so it paces itself at nvidia-smi's period."""

    def __init__(self, index: int = 0, period: float = 0.1):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=power.draw",
             "--format=csv,noheader,nounits", "-i", str(index),
             "-lms", str(max(1, round(period * 1e3)))],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

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


class Poller:
    """The sampling thread: (time.time(), watts) into `samples` until stop();
    a read that raises counts in `errors` and is taken as NaN."""

    def __init__(self, sampler, period: float = 0.1):
        self.sampler, self.period = sampler, period
        self.samples, self.errors = [], 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            try:
                w = self.sampler.sample()
            except Exception:
                if self._stop.is_set():      # the stream closed at stop()
                    break
                self.errors += 1
                w = float("nan")
                self._stop.wait(self.period)
            self.samples.append((time.time(), w))

    def start(self) -> "Poller":
        self._thread.start()
        return self

    def wait_past(self, t: float, timeout: float = 5.0) -> None:
        """Wait until a sample taken after time t is in, or timeout."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            if self.samples and self.samples[-1][0] > t:
                return
            time.sleep(self.period / 4)

    def stop(self) -> list:
        """Stop sampling, close the sampler, wait for the thread, and return
        the samples."""
        self._stop.set()
        self.sampler.close()
        self._thread.join(timeout=15)
        return list(self.samples)


def energy(samples, t0: float, t1: float) -> float:
    """Joules from t0 to t1 by the trapezoidal rule over the samples that
    are not NaN, the draw between samples taken as linear; NaN unless a
    sample lies at or before t0 and one at or after t1."""
    snap = [s for s in samples if s[1] == s[1]]
    if len(snap) < 2 or snap[0][0] > t0 or snap[-1][0] < t1:
        return float("nan")
    ts = np.array([s[0] for s in snap])
    ws = np.array([s[1] for s in snap])
    grid = np.concatenate([[t0], ts[(ts > t0) & (ts < t1)], [t1]])
    trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy < 2.0
    return float(trapezoid(np.interp(grid, ts, ws), grid))
