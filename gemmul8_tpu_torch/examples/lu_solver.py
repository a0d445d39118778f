"""Dense LU solve with every O(n^3) flop on the int8 tensor cores (the port
of examples/lu_solver.py).

HPL-MxP-style mixed-precision direct solver: blocked right-looking LU where
the panel factorizations run natively (O(n * block^2); cuSOLVER on the
card) but ALL trailing Schur updates and triangular-solve update GEMMs --
the O(n^3) bulk -- go through the emulated GEMM (num_moduli dial). Two
steps of iterative refinement (residuals also emulated) push a cheap nu=6
factorization to full f64 residual quality.

    python -m gemmul8_tpu_torch.examples.lu_solver [--device cpu]
"""
import numpy as np

import gemmul8_tpu_torch as gt

from . import cli, device_of, to_numpy


def main(device=None) -> dict:
    device = device_of(device)
    rng = np.random.default_rng(5)
    n = 512
    a = rng.standard_normal((n, n)) + n * np.eye(n)
    b = rng.standard_normal((n,))

    # full-accuracy factorization (nu=14: f64-equivalent updates)
    x = to_numpy(gt.solve(a, b, num_moduli=14, block=128, device=device))
    r = np.max(np.abs(a @ x - b)) / np.max(np.abs(b))
    print(f"nu=14 LU solve       relative residual: {r:.3e}")
    assert r < 1e-11

    # cheap factorization + refinement (the mixed-precision pattern)
    x0 = to_numpy(gt.solve(a, b, num_moduli=6, block=128, device=device))
    r0 = np.max(np.abs(a @ x0 - b)) / np.max(np.abs(b))
    x2 = to_numpy(gt.solve(a, b, num_moduli=6, block=128, refine_steps=2,
                           device=device))
    r2 = np.max(np.abs(a @ x2 - b)) / np.max(np.abs(b))
    print(f"nu=6  LU solve       relative residual: {r0:.3e}")
    print(f"nu=6  + 2 IR steps   relative residual: {r2:.3e}")
    assert r2 < 1e-12

    # the BLAS-3 surface underneath is public too
    t = np.tril(rng.standard_normal((n, n))) + n * np.eye(n)
    rhs = rng.standard_normal((n, 8))
    y = to_numpy(gt.trsm(t, rhs, num_moduli=14, block=128, device=device))
    rt = np.max(np.abs(t @ y - rhs)) / np.max(np.abs(rhs))
    print(f"trsm (lower, left)   relative residual: {rt:.3e}")
    assert rt < 1e-11
    print("OK")
    return dict(x=x, x0=x0, x2=x2, y=y, r=r, r0=r0, r2=r2, rt=rt)


if __name__ == "__main__":
    cli(main)
