"""The dense linear-algebra stack on the int8 tensor cores (the port of
examples/dense_linalg.py).

QR / least squares (blocked Householder compact-WY), SVD and symmetric
eigendecomposition (block Jacobi), and matrix inverse (LU) -- every
O(n^3) flop routed through the emulated GEMM, with num_moduli as the
accuracy dial; the small native pieces are cuSOLVER's on the card. The
reference (RIKEN-RCCS/GEMMul8) provides the GEMM building block; this is
the building pointed at.

    python -m gemmul8_tpu_torch.examples.dense_linalg [--device cpu]
"""
import numpy as np

import gemmul8_tpu_torch as gt

from . import cli, device_of, to_numpy


def main(device=None) -> dict:
    device = device_of(device)
    rng = np.random.default_rng(42)
    m, n = 384, 256
    a = rng.standard_normal((m, n))

    # --- QR + least squares -------------------------------------------
    q_, r_ = (to_numpy(z) for z in gt.qr(a, num_moduli=14, device=device))
    print(f"qr:    |QR - A|     = {np.max(np.abs(q_ @ r_ - a)):.2e}   "
          f"|Q'Q - I| = {np.max(np.abs(q_.T @ q_ - np.eye(n))):.2e}")

    b = rng.standard_normal((m, 3))
    x = to_numpy(gt.lstsq(a, b, num_moduli=14, device=device))
    xref = np.linalg.lstsq(a, b, rcond=None)[0]
    print(f"lstsq: |x - x_ref|  = {np.max(np.abs(x - xref)):.2e}")

    # --- SVD (one-sided block Jacobi: batched emulated Gram products) --
    u, s, vt = (to_numpy(z) for z in gt.svd(a, device=device))
    sref = np.linalg.svd(a, compute_uv=False)
    print(f"svd:   |USV' - A|   = "
          f"{np.max(np.abs(u @ np.diag(s) @ vt - a)):.2e}   "
          f"max sigma err = {np.max(np.abs(s - sref) / sref):.2e}")

    # --- symmetric eig (two-sided block Jacobi) ------------------------
    h = np.asarray(a.T @ a / m)
    w, v = (to_numpy(z) for z in gt.eigh(h, device=device))
    print(f"eigh:  |Av - vw|    = "
          f"{np.max(np.abs(h @ v - v * w[None, :])):.2e}")

    # --- inverse via LU -------------------------------------------------
    sq = rng.standard_normal((n, n)) + n * np.eye(n)
    inv = to_numpy(gt.inv(sq, num_moduli=14, device=device))
    print(f"inv:   |A^-1 A - I| = {np.max(np.abs(inv @ sq - np.eye(n))):.2e}")

    # the accuracy dial carries through every algorithm
    s8 = to_numpy(gt.svd(a, num_moduli=8, compute_uv=False, device=device))
    print(f"dial:  svd sigma err nu=8 {np.max(np.abs(s8 - sref) / sref):.1e}"
          f"  vs nu=14 {np.max(np.abs(s - sref) / sref):.1e}")
    out = dict(q=q_, r=r_, x=x, u=u, s=s, vt=vt, w=w, v=v, inv=inv, s8=s8)
    assert all(np.isfinite(z).all() for z in out.values())
    print("OK")
    return out


if __name__ == "__main__":
    cli(main)
