"""Tour of the Level-3 BLAS surface on the residue emulator (the port of
examples/blas3_tour.py).

The reference is GEMM-only (include/gemmul8.hpp:41-94); the package closes
the BLAS-3 set on the same engine: gemm, syrk/herk, syr2k/her2k, symm/hemm,
trmm/trsm (and trtri on top of trsm). Every routine dials accuracy and
speed with the same num_moduli/fastmode/backend knobs and keeps bit-wise
reproducibility. Structural guarantees are exact: rank-2k results are
symmetric/Hermitian bit for bit, symm/hemm never read the unstored
triangle, trtri's complementary triangle is exactly zero.

    python -m gemmul8_tpu_torch.examples.blas3_tour [--device cpu]
"""
import numpy as np

import gemmul8_tpu_torch as gt

from . import cli, device_of, to_numpy


def main(device=None) -> dict:
    device = device_of(device)
    rng = np.random.default_rng(0)
    n, k, m = 96, 64, 48
    nu = 16

    # syr2k: C = alpha (A B^T + B A^T) -- ONE emulated product
    a = rng.standard_normal((n, k))
    b = rng.standard_normal((n, k))
    c = to_numpy(gt.syr2k(a, b, num_moduli=nu, alpha=0.5, device=device))
    want = 0.5 * (a @ b.T + b @ a.T)
    print("syr2k  rel err %.2e  exactly symmetric: %s"
          % (np.abs(c - want).max() / np.abs(want).max(),
             np.array_equal(c, c.T)))

    # her2k: C = alpha A B^H + conj(alpha) B A^H (beta real per BLAS)
    az = rng.standard_normal((n, k)) + 1j * rng.standard_normal((n, k))
    bz = rng.standard_normal((n, k)) + 1j * rng.standard_normal((n, k))
    alpha = 1.0 - 0.5j
    cz = to_numpy(gt.her2k(az, bz, num_moduli=nu, alpha=alpha,
                           device=device))
    wz = (alpha * (az @ bz.conj().T)
          + np.conj(alpha) * (bz @ az.conj().T))
    print("her2k  rel err %.2e  exactly Hermitian: %s  diag real: %s"
          % (np.abs(cz - wz).max() / np.abs(wz).max(),
             np.array_equal(cz, cz.conj().T),
             bool((np.imag(np.diagonal(cz)) == 0).all())))

    # symm: only the stored triangle is read (poison the other to prove it)
    s = rng.standard_normal((n, n))
    s = s + s.T
    stored = np.array(s)
    stored[np.triu_indices(n, 1)] = np.nan
    bb = rng.standard_normal((n, m))
    cs = to_numpy(gt.symm(stored, bb, lower=True, num_moduli=nu,
                          device=device))
    print("symm   rel err %.2e  (NaN-poisoned unread triangle)"
          % (np.abs(cs - s @ bb).max() / np.abs(s @ bb).max()))

    # hemm: Hermitian operand, diagonal imaginary part ignored per BLAS
    h = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    h = h + h.conj().T
    bz2 = rng.standard_normal((n, m)) + 1j * rng.standard_normal((n, m))
    ch = to_numpy(gt.hemm(np.tril(h), bz2, num_moduli=nu, device=device))
    print("hemm   rel err %.2e"
          % (np.abs(ch - h @ bz2).max() / np.abs(h @ bz2).max()))

    # trtri: triangular inverse through the blocked emulated-GEMM trsm
    t = np.tril(rng.standard_normal((n, n))) / np.sqrt(n)
    t[np.arange(n), np.arange(n)] = 1.0 + rng.random(n)
    x = to_numpy(gt.trtri(t, num_moduli=nu, device=device))
    print("trtri  resid %.2e  masked triangle exactly zero: %s"
          % (np.abs(t @ x - np.eye(n)).max() / n,
             bool((np.triu(x, 1) == 0).all())))

    assert np.array_equal(c, c.T) and np.array_equal(cz, cz.conj().T)
    assert bool((np.triu(x, 1) == 0).all())
    print("OK")
    return dict(syr2k=c, her2k=cz, symm=cs, hemm=ch, trtri=x)


if __name__ == "__main__":
    cli(main)
