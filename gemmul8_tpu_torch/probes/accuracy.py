"""Accuracy sweep on the card, the counterpart of benchmarks/accuracy.py and
the reference protocol (testing/test_accuracy.hpp): m = n = 128, k swept in
powers of two, phi in {-1, 0, 0.5, 1, 2, 4}, a num_moduli sweep, max and
median elementwise relative error against numpy's longdouble oracle, CSV
rows named as the JAX harness names them.

Per (k, phi) the operands are drawn from default_rng(12345 + k) and
default_rng(54321 + k), as there. The rows: `native` (the device's own
torch.matmul), `bf16x9` (f32) or `os1-int8` (f64, d = 8; `skipped (k >
2^17)` past OS1's exactness bound), then per nu `oz2-fast` (`oz2-accu`
with --fast 0; `-fp8` appended on the FP8 backend) and, in fast mode,
`oz2-robust`. Complex operands run through gemm on complex tensors.

Dropped flags of the JAX harness: --cpu (here --device cpu) and
--oracle-stored, which round-tripped the operands through the device
because a TPU's f64 is an f32 pair; the card stores IEEE f64, so the
oracle sees the values the emulator sees. The JAX harness's planar route
for complex operands worked around TPU runtimes without complex dtypes;
the card has them.

    python -m gemmul8_tpu_torch.probes.accuracy [--dtype f64] [--kmax 16384]
        [--fast 1] [--backend INT8] [--ks ...] [--phis ...] [--nus ...]
        [--no-robust] [--device cuda|cpu] [--out FILE]

The CSV goes to gemmul8_tpu_torch/_results/ unless --out names a file.
"""
from __future__ import annotations

import argparse
import csv
import datetime
import os
import sys

import numpy as np
import torch

NP_DTYPES = {"f32": np.float32, "f64": np.float64, "c64": np.complex64,
             "c128": np.complex128}
NU_RANGES = {"f32": range(3, 14), "f64": range(9, 21), "c64": range(3, 14),
             "c128": range(9, 21)}
PHIS = (-1.0, 0.0, 0.5, 1.0, 2.0, 4.0)
HEADER = ["k", "phi", "method", "num_moduli", "err_max", "err_median"]
RESULTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_results")


def device_tag(device: torch.device) -> str:
    """The device's name as the CSV file names carry it."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device).replace(" ", "")
    return "cpu"


def result_path(name: str) -> str:
    """A file under gemmul8_tpu_torch/_results/, the directory made."""
    os.makedirs(RESULTS, exist_ok=True)
    return os.path.join(RESULTS, name)


def write_csv(path: str, header, rows) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)


def gen(rng, rows, cols, phi, np_dtype):
    """(U - 0.5) * exp(phi N), or N(0, 1) for phi < 0; complex: two such
    draws."""
    def real(r):
        if phi < 0:
            return r.standard_normal((rows, cols))
        u = r.random((rows, cols))
        z = r.standard_normal((rows, cols))
        return (u - 0.5) * np.exp(z * phi)
    if np.iscomplexobj(np.empty(0, np_dtype)):
        return (real(rng) + 1j * real(rng)).astype(np_dtype)
    return real(rng).astype(np_dtype)


def oracle(a, b):
    """a @ b in numpy's longdouble."""
    if np.iscomplexobj(a):
        ar, ai = a.real.astype(np.longdouble), a.imag.astype(np.longdouble)
        br, bi = b.real.astype(np.longdouble), b.imag.astype(np.longdouble)
        return (ar @ br - ai @ bi) + 1j * (ar @ bi + ai @ br)
    return a.astype(np.longdouble) @ b.astype(np.longdouble)


def errs(c, ref):
    """Max and median elementwise relative error against the oracle."""
    d = np.abs(np.asarray(c, ref.dtype) - ref)
    den = np.maximum(np.abs(ref), np.finfo(np.longdouble).tiny)
    e = (d / den).astype(np.float64)
    return float(np.max(e)), float(np.median(e))


def sweep(dtype="f64", ks=(1024,), phis=PHIS, nus=None, fast=1,
          backend="INT8", robust=True, device="cuda", log=sys.stderr):
    """The harness's rows: [k, phi, method, num_moduli, err_max,
    err_median]."""
    import gemmul8_tpu_torch as gt
    from gemmul8_tpu_torch import compare, core
    device = core._device(device)
    np_dtype = NP_DTYPES[dtype]
    is_cplx = dtype.startswith("c")
    nus = NU_RANGES[dtype] if nus is None else nus
    m = n = 128

    def host(x):
        return x.cpu().resolve_conj().numpy()

    rows = []
    for k in ks:
        for phi in phis:
            a = gen(np.random.default_rng(12345 + k), m, k, phi, np_dtype)
            b = gen(np.random.default_rng(54321 + k), k, n, phi, np_dtype)
            ref = oracle(a, b)
            at = torch.from_numpy(a).to(device)
            bt = torch.from_numpy(b).to(device)
            # the device's own native-path matmul is the comparison row
            nat_max, nat_med = errs(host(torch.matmul(at, bt)), ref)
            rows.append([k, phi, "native", "", nat_max, nat_med])
            print(f"k={k} phi={phi} native: {nat_max:.3e}", file=log)
            # alternative-emulation rows (reference: test_accuracy.hpp:
            # 84-156 BF16x9 / ozaki1.hpp "OS1")
            if not is_cplx:
                if dtype == "f32":
                    alt = compare.matmul_bf16x9(at, bt, device=device)
                    rows.append([k, phi, "bf16x9", "",
                                 *errs(host(alt), ref)])
                elif k <= (1 << 17):
                    alt = compare.matmul_os1_int8(at, bt, d=8, device=device)
                    rows.append([k, phi, "os1-int8", 8,
                                 *errs(host(alt), ref)])
                else:
                    # OS1's exact-accumulation bound is k <= 2^17: the
                    # skip is recorded, not hidden
                    rows.append([k, phi, "os1-int8", 8,
                                 "skipped (k > 2^17)", ""])
            for nu in nus:
                c = gt.gemm(at, bt, num_moduli=nu, fastmode=bool(fast),
                            backend=backend, device=device)
                emax, emed = errs(host(c), ref)
                tag = "fast" if fast else "accu"
                if backend != "INT8":
                    tag += "-" + backend.lower()
                rows.append([k, phi, f"oz2-{tag}", nu, emax, emed])
                print(f"k={k} phi={phi} nu={nu}: {emax:.3e}", file=log)
                if fast and robust:
                    # the scale-invariant fast variant next to the
                    # reference-formula row
                    cr = gt.gemm(at, bt, num_moduli=nu, fastmode="robust",
                                 backend=backend, device=device)
                    rtag = ("oz2-robust" if backend == "INT8"
                            else "oz2-robust-" + backend.lower())
                    rows.append([k, phi, rtag, nu, *errs(host(cr), ref)])
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", default="f64", choices=list(NP_DTYPES))
    ap.add_argument("--kmax", type=int, default=16384)
    ap.add_argument("--fast", type=int, default=1)
    ap.add_argument("--backend", default="INT8", choices=["INT8", "FP8"])
    ap.add_argument("--device", default="cuda",
                    help="'cpu' runs the port's CPU path")
    ap.add_argument("--out", default=None)
    ap.add_argument("--phis", default=None,
                    help="comma list overriding the phi sweep")
    ap.add_argument("--nus", default=None,
                    help="comma list overriding the num_moduli sweep")
    ap.add_argument("--ks", default=None,
                    help="comma list overriding the k sweep")
    ap.add_argument("--no-robust", action="store_true",
                    help="skip the oz2-robust comparison rows")
    args = ap.parse_args(argv)
    from gemmul8_tpu_torch import core
    device = core._device(args.device)
    phis = ([float(x) for x in args.phis.split(",")] if args.phis
            else list(PHIS))
    ks = ([int(x) for x in args.ks.split(",")] if args.ks
          else [1 << p for p in range(10, 24) if (1 << p) <= args.kmax])
    nus = [int(x) for x in args.nus.split(",")] if args.nus else None
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        from .fp8_calls import card
        print(card(), file=sys.stderr)
    rows = sweep(args.dtype, ks, phis, nus, args.fast, args.backend,
                 not args.no_robust, device)
    stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
    out = args.out or result_path(
        f"oz2_results_{args.backend}_{args.dtype}_accuracy_"
        f"{device_tag(device)}_{stamp}.csv")
    write_csv(out, HEADER, rows)
    print(f"wrote {out}")
    return dict(rows=rows, out=out)


if __name__ == "__main__":
    main()
