"""ZGEMM from separate (real, imaginary) arrays, through the planar API (the
port of examples/planar_complex.py).

The 3M residue pipeline is planar inside, so gemm_planar gives CGEMM/ZGEMM
from (real, imag) pairs. The card has complex dtypes, and gemm_planar is bit
for bit gemm on complex tensors there: the example holds the two against
each other.

    python -m gemmul8_tpu_torch.examples.planar_complex [--device cpu]
"""
import numpy as np

import gemmul8_tpu_torch as gt

from . import cli, device_of, to_numpy


def main(device=None) -> dict:
    device = device_of(device)
    rng = np.random.default_rng(3)
    m, k, n = 32, 96, 24
    a = rng.standard_normal((k, m)) + 1j * rng.standard_normal((k, m))
    b = rng.standard_normal((k, n)) + 1j * rng.standard_normal((k, n))

    # C = A^H @ B, planar in, planar out
    cr, ci = gt.gemm_planar(a.real, a.imag, b.real, b.imag, num_moduli=14,
                            trans_a="C", device=device)
    cr, ci = to_numpy(cr), to_numpy(ci)
    ref = a.conj().T @ b
    err = max(np.max(np.abs(cr - ref.real)), np.max(np.abs(ci - ref.imag)))
    print(f"ZGEMM (C,N) {m}x{k}x{n} nu=14 max abs err: {err:.3e}")
    assert err < 1e-12
    # the same product on complex tensors
    cz = to_numpy(gt.gemm(a, b, num_moduli=14, trans_a="C", device=device))
    same = bool(np.array_equal(cz.real, cr) and np.array_equal(cz.imag, ci))
    print(f"gemm on complex128 bit-identical: {same}")
    assert same
    print("OK")
    return dict(cr=cr, ci=ci, cz=cz, err=err)


if __name__ == "__main__":
    cli(main)
