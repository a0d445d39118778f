"""Mixed-precision iterative refinement with emulated high-precision
residuals (the port of examples/iterative_refinement.py).

The classic HPC use of GEMM emulation (the reference targets this class of
workloads): solve A x = b where the solver runs in working precision but
the RESIDUAL r = b - A x is computed in emulated high precision (the
num_moduli dial), recovering the accuracy an f32 solve cannot reach, with
bit-reproducible residuals. The f32 "factorization" is numpy's f32 inverse
on the host, as in the JAX script; every residual product is the emulated
gemm on the device.

    python -m gemmul8_tpu_torch.examples.iterative_refinement [--device cpu]
"""
import numpy as np
import torch

import gemmul8_tpu_torch as gt

from . import cli, device_of, to_numpy


def main(device=None) -> dict:
    device = device_of(device)
    rng = np.random.default_rng(11)
    n = 256
    # moderately ill-conditioned SPD system
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    d = np.logspace(0, 6, n)
    a_np = (q * d) @ q.T
    x_true = rng.standard_normal((n, 1))
    b_np = a_np @ x_true

    a = torch.from_numpy(a_np).to(device)
    b = torch.from_numpy(b_np).to(device)
    xt = torch.from_numpy(x_true).to(device)
    # "low-precision factorization": solve in f32
    a32 = np.asarray(a_np, np.float32)
    lu_solve = np.linalg.inv(a32)  # stand-in for an f32 factorization

    x0_err = float(np.max(np.abs(lu_solve @ np.asarray(b_np, np.float32)
                                 - x_true)))
    print(f"plain f32 solve: max |x - x_true| = {x0_err:.3e}")

    x = torch.zeros((n, 1), dtype=torch.float64, device=device)
    errs = []
    for it in range(6):
        # high-precision residual via the emulator (nu=16 ~ f64 quality)
        r = b - gt.gemm(a, x, num_moduli=16, device=device)
        dx = torch.from_numpy(
            (lu_solve @ np.asarray(to_numpy(r), np.float32)).astype(
                np.float64)).to(device)
        x = x + dx
        err = float(torch.max(torch.abs(x - xt)))
        errs.append(err)
        print(f"iter {it}: max |x - x_true| = {err:.3e}")
    # the floor is storage precision x condition number: about 2^-53 * 1e6
    # on the card's IEEE f64, as on the CPU
    assert err < min(x0_err * 1e-3, 1e-6)
    print("OK: refined 3+ orders of magnitude past the plain f32 solve "
          "using emulated high-precision residuals")
    return dict(x=to_numpy(x), x0_err=x0_err, errs=errs)


if __name__ == "__main__":
    cli(main)
