"""getrf's reconstruction error as n grows, on the CPU: max|PA - LU| /
max|A| of the JAX package's getrf and of the port's (device="cpu"), at one
num_moduli, on the same standard-normal matrices, beside LAPACK's getrf
(scipy). Both packages take their default block (512). The error is the
emulated Schur updates': the robust shifts leave about 48 bits of each
operand at nu=14, and the error grows with the number and the length of
the updates. A second witness, besides the port's own, that the growth is
the algorithm's and not the port's.

    PYTHONPATH=. python tests/torch_lu_growth.py [--sizes 1024,2048]
        [--nu 14] [--seed 0]

Prints one line per size and, last, a JSON list of the rows.
"""
import argparse
import json
import time

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import scipy.linalg  # noqa: E402

import gemmul8_tpu as g8  # noqa: E402
import gemmul8_tpu_torch as gt  # noqa: E402


def lu_error(a, lu, perm):
    """max |PA - LU| / max |A|, in f64."""
    el = np.tril(lu, -1) + np.eye(a.shape[0])
    return float(np.max(np.abs(a[perm] - el @ np.triu(lu))) /
                 np.max(np.abs(a)))


def row(n, nu, seed):
    a = np.random.default_rng(seed).standard_normal((n, n))
    t0 = time.perf_counter()
    lu, perm = g8.getrf(a, num_moduli=nu)
    jax_err = lu_error(a, np.asarray(lu), np.asarray(perm))
    t1 = time.perf_counter()
    lu, perm = gt.getrf(a, num_moduli=nu, device="cpu")
    port_err = lu_error(a, lu.numpy(), perm.numpy())
    t2 = time.perf_counter()
    lu, piv = scipy.linalg.lu_factor(a)
    perm = np.arange(n)
    for i, p in enumerate(piv):
        perm[[i, p]] = perm[[p, i]]
    return dict(n=n, num_moduli=nu, jax=jax_err, port=port_err,
                lapack=lu_error(a, lu, perm), jax_s=t1 - t0, port_s=t2 - t1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="1024,2048")
    ap.add_argument("--nu", type=int, default=14)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    rows = []
    for n in (int(s) for s in args.sizes.split(",")):
        r = row(n, args.nu, args.seed)
        rows.append(r)
        print(f"n={n} nu={args.nu}: max|PA - LU|/max|A| JAX {r['jax']!r}, "
              f"port {r['port']!r}, LAPACK {r['lapack']!r} "
              f"({r['jax_s']:.1f} s JAX, {r['port_s']:.1f} s port)",
              flush=True)
    print(json.dumps(rows))


if __name__ == "__main__":
    main()
