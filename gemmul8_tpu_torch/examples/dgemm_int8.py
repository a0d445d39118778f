"""Minimal DGEMM emulation sample with golden expected values (the port of
examples/dgemm_int8.py).

Analog of the reference sample (sample/dgemm_cuBLAS_int8.cu:24-67): a tiny
4x3x5 DGEMM whose inputs are exactly representable, so the emulated result
must match the exact product bit for bit at sufficient num_moduli.

    python -m gemmul8_tpu_torch.examples.dgemm_int8 [--device cpu]
"""
import numpy as np

import gemmul8_tpu_torch as gt

from . import cli, device_of, to_numpy


def main(device=None) -> dict:
    device = device_of(device)
    a = np.array([[1.0, -2.5, 3.25],
                  [0.5, 4.0, -1.125],
                  [-3.0, 0.25, 2.0],
                  [7.5, -0.75, 1.5]])
    b = np.array([[2.0, -1.0, 0.5, 3.0, -0.25],
                  [1.5, 2.5, -3.0, 0.125, 4.0],
                  [-0.5, 1.0, 2.25, -1.5, 0.75]])
    expected = a @ b  # exact in f64 (short mantissas)

    c = to_numpy(gt.gemm(a, b, num_moduli=8, device=device))
    err = np.abs(c - expected).max()
    print("emulated C =\n", c)
    print("max abs error vs exact:", err)
    assert err == 0.0, "sample must reproduce the exact product bit-for-bit"
    print("OK")
    return dict(c=c, err=err)


if __name__ == "__main__":
    cli(main)
