"""Randomized stress sweep of the public gemm and gemm_planar on the card:
the counterpart of tools/device_stress.py.

Each trial draws dtype, backend, nu, mode, shape (8-399 per dimension, so
the kernels' tile edges are straddled), ops, alpha/beta and the spread phi
from np.random.default_rng(seed) in the tool's order, so that trial t has
the tool's configuration and operands. The operands are made on the host;
the result is held against the host f64 product with the tool's tolerance
(the num_moduli error model, NUMERICS.md section 2). Then max(trials // 5,
3) planar-complex trials (gemm_planar, op_a in N/T/C) against numpy's
complex product. One line per trial; exit code 1 on any failure.

--against-cpu reruns each trial through the port's CPU path, with the
epilogue the card's "auto" resolved to, and requires the card's result to
hold the CPU's bits: the card-versus-CPU rule of chip_smoke.py's phase 5,
carried over to random shapes.

    python -m gemmul8_tpu_torch.probes.device_stress [--trials 40]
        [--seed 0] [--device cuda|cpu] [--against-cpu]

The card is the default device: without CUDA the run raises rather than
drop to the CPU.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def real_trials(trials: int, rng):
    """The tool's real trials, drawn in its order: one dict each, the
    operands host numpy arrays."""
    from gemmul8_tpu_torch import tables
    for t in range(trials):
        dtype = rng.choice([np.float32, np.float64])
        name = np.dtype(dtype).name
        lo, hi = tables.VALID_RANGE[name]
        backend = str(rng.choice(["INT8", "INT8", "INT8", "FP8"]))
        nu = int(rng.integers(max(lo, 4), hi + 1))
        fast = [True, False, "robust"][int(rng.integers(0, 3))]
        m, k, n = (int(rng.integers(8, 400)) for _ in range(3))
        op_a = str(rng.choice(["N", "T"]))
        op_b = str(rng.choice(["N", "T"]))
        alpha = float(rng.choice([1.0, -1.5, 0.5]))
        beta = float(rng.choice([0.0, 1.0, 1.2]))
        phi = float(rng.choice([0.0, 0.5, 1.0]))

        z = rng.standard_normal
        mk = (m, k) if op_a == "N" else (k, m)
        kn = (k, n) if op_b == "N" else (n, k)
        a = ((z(mk) * np.exp(z(mk) * phi))).astype(dtype)
        b = ((z(kn) * np.exp(z(kn) * phi))).astype(dtype)
        cin = z((m, n)).astype(dtype)
        yield dict(t=t, dtype=dtype, name=name, backend=backend, nu=nu,
                   fast=fast, m=m, k=k, n=n, op_a=op_a, op_b=op_b,
                   alpha=alpha, beta=beta, phi=phi, a=a, b=b, cin=cin)


def planar_trials(trials: int, rng):
    """The tool's planar-complex trials, drawn after the real ones."""
    for t in range(max(trials // 5, 3)):
        nu = int(rng.integers(8, 17))
        m, k, n = (int(rng.integers(8, 200)) for _ in range(3))
        op_a = str(rng.choice(["N", "T", "C"]))
        mk = (m, k) if op_a == "N" else (k, m)
        ar, ai = rng.standard_normal(mk), rng.standard_normal(mk)
        br, bi = rng.standard_normal((k, n)), rng.standard_normal((k, n))
        yield dict(t=t, nu=nu, m=m, k=k, n=n, op_a=op_a, ar=ar, ai=ai,
                   br=br, bi=bi)


def real_tolerance(nu: int, backend: str, phi: float, dtype) -> float:
    """The tool's tolerance: quantization error ~2^-(log2P - 6 - 8 phi),
    floored at 2^-22 for f32 inputs, times 50, plus 2^-46."""
    from gemmul8_tpu_torch import tables
    log2p = tables.log2P(nu, backend)
    return max(2.0 ** (-(log2p - 6 - 8 * phi)),
               2.0 ** -22 if dtype == np.float32 else 0.0) * 50 \
        + 2.0 ** -46


def planar_tolerance(nu: int) -> float:
    from gemmul8_tpu_torch import tables
    return 2.0 ** (-(tables.log2P(nu, "INT8") - 8)) * 50 + 2.0 ** -46


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _same_bits(got, ref) -> bool:
    got, ref = np.ascontiguousarray(got), np.ascontiguousarray(ref)
    return (got.dtype == ref.dtype and got.shape == ref.shape
            and np.array_equal(got.view(np.uint8), ref.view(np.uint8)))


def run(trials: int = 40, seed: int = 0, device="cuda",
        against_cpu: bool = False, log=None) -> list:
    """The sweep: one record per trial (label, ok, err, tol, and cpu_equal
    where against_cpu), each trial's line printed to `log` (standard error
    by default) as the tool prints it."""
    import gemmul8_tpu_torch as gt
    from gemmul8_tpu_torch import core
    log = log or sys.stderr
    device = core._device(device)
    # the CPU rerun takes the epilogue the card's "auto" resolves to
    cpu_epilogue = core.resolve_epilogue("auto", device)
    rng = np.random.default_rng(seed)
    records = []
    for tr in real_trials(trials, rng):
        kw = dict(num_moduli=tr["nu"], fastmode=tr["fast"],
                  backend=tr["backend"], alpha=tr["alpha"], beta=tr["beta"],
                  c=tr["cin"], trans_a=tr["op_a"], trans_b=tr["op_b"])
        out = _host(gt.gemm(tr["a"], tr["b"], **kw, device=device))
        a, b, cin = tr["a"], tr["b"], tr["cin"]
        aa = a.T if tr["op_a"] == "T" else a
        bb = b.T if tr["op_b"] == "T" else b
        ref = tr["alpha"] * (aa.astype(np.float64) @ bb.astype(np.float64)) \
            + tr["beta"] * cin.astype(np.float64)
        scale = np.max(np.abs(ref)) + 1e-30
        err = np.max(np.abs(out - ref)) / scale
        tol = real_tolerance(tr["nu"], tr["backend"], tr["phi"], tr["dtype"])
        ok = bool(err < tol and np.isfinite(out).all())
        rec = dict(label=f"{tr['t']:03d}", ok=ok, err=float(err), tol=tol)
        line = (f"[{tr['t']:03d}] {'ok ' if ok else 'FAIL'} {tr['name']} "
                f"{tr['backend']} nu={tr['nu']:2d} fast={tr['fast']} "
                f"({tr['m']},{tr['k']},{tr['n']}) {tr['op_a']}{tr['op_b']} "
                f"a={tr['alpha']} b={tr['beta']} phi={tr['phi']}: "
                f"err={err:.2e} tol={tol:.2e}")
        if against_cpu:
            cpu = _host(gt.gemm(a, b, **kw, epilogue=cpu_epilogue,
                                device="cpu"))
            rec["cpu_equal"] = _same_bits(out, cpu)
            rec["ok"] = ok = ok and rec["cpu_equal"]
            line += (" cpu bit-equal" if rec["cpu_equal"]
                     else " cpu DIFFERS")
        print(line, file=log, flush=True)
        records.append(rec)

    for tr in planar_trials(trials, rng):
        args = (tr["ar"], tr["ai"], tr["br"], tr["bi"])
        kw = dict(num_moduli=tr["nu"], trans_a=tr["op_a"])
        cr, ci = (_host(x) for x in gt.gemm_planar(*args, **kw,
                                                   device=device))
        az = tr["ar"] + 1j * tr["ai"]
        op_a = tr["op_a"]
        az = az.T if op_a == "T" else (az.conj().T if op_a == "C" else az)
        ref = az @ (tr["br"] + 1j * tr["bi"])
        scale = np.max(np.abs(ref)) + 1e-30
        err = max(np.max(np.abs(cr - ref.real)),
                  np.max(np.abs(ci - ref.imag))) / scale
        tol = planar_tolerance(tr["nu"])
        ok = bool(err < tol)
        rec = dict(label=f"z{tr['t']:02d}", ok=ok, err=float(err), tol=tol)
        line = (f"[z{tr['t']:02d}] {'ok ' if ok else 'FAIL'} planar "
                f"nu={tr['nu']:2d} ({tr['m']},{tr['k']},{tr['n']}) "
                f"{op_a}N: err={err:.2e} tol={tol:.2e}")
        if against_cpu:
            cpu = gt.gemm_planar(*args, **kw, epilogue=cpu_epilogue,
                                 device="cpu")
            rec["cpu_equal"] = (_same_bits(cr, _host(cpu[0]))
                                and _same_bits(ci, _host(cpu[1])))
            rec["ok"] = ok = ok and rec["cpu_equal"]
            line += (" cpu bit-equal" if rec["cpu_equal"]
                     else " cpu DIFFERS")
        print(line, file=log, flush=True)
        records.append(rec)
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cpu' runs the port's CPU path")
    ap.add_argument("--against-cpu", action="store_true",
                    help="rerun each trial on the CPU path; require its bits")
    args = ap.parse_args(argv)
    from gemmul8_tpu_torch import core
    device = core._device(args.device)
    if device.type == "cuda":
        from .fp8_calls import card
        print(f"device: {card()}", file=sys.stderr)
    else:
        print(f"device: {device.type}", file=sys.stderr)
    records = run(args.trials, args.seed, device, args.against_cpu)
    failures = sum(not r["ok"] for r in records)
    print("stress passed" if not failures else f"{failures} FAILURES")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
