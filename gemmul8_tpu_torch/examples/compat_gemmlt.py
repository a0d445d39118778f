"""Reference-API (compat layer) samples with golden expected values (the
port of examples/compat_gemmlt.py).

Analogs of the reference's cuBLASLt samples (sample/dgemm_cuBLASLt_int8.cu,
sample/dgemm_cuBLASLt_fp8.cu): the same tiny exactly representable DGEMM
as dgemm_int8, driven through the argument-for-argument
``gemmul8_tpu_torch.compat`` surface: column-major ld-strided 1-D buffers
on the device, in-place C update, handle and skip-scal reuse, ``gemmLt``
for the FP8 backend (the plain ``gemm`` entry rejects FP8, as the
reference's plain-cuBLAS entry does, gemmul8.cu:136-139).

    python -m gemmul8_tpu_torch.examples.compat_gemmlt [--device cpu]
"""
import numpy as np
import torch

from gemmul8_tpu_torch import compat

from . import cli, device_of, to_numpy


def colmajor(x, ld, device):
    """Pack a row-major matrix into a cuBLAS-style column-major 1-D buffer
    on `device` with leading dimension ld (>= rows)."""
    rows, cols = x.shape
    buf = np.zeros(ld * cols, x.dtype)
    for j in range(cols):
        buf[j * ld:j * ld + rows] = x[:, j]
    return torch.from_numpy(buf).to(device)


def main(device=None) -> dict:
    device = device_of(device)
    a = np.array([[1.0, -2.5, 3.25],
                  [0.5, 4.0, -1.125],
                  [-3.0, 0.25, 2.0],
                  [7.5, -0.75, 1.5]])
    b = np.array([[2.0, -1.0, 0.5, 3.0, -0.25],
                  [1.5, 2.5, -3.0, 0.125, 4.0],
                  [-0.5, 1.0, 2.25, -1.5, 0.75]])
    m, k = a.shape
    _, n = b.shape
    expected = a @ b  # exact in f64 (short mantissas)

    def zeros():
        return torch.zeros(ldc * n, dtype=torch.float64, device=device)

    def unpack(c):
        return to_numpy(c).reshape(n, ldc).T[:m]

    # ld-strided column-major device buffers (lda > m on purpose: the
    # stride must be honoured, as with real cuBLAS calls)
    lda, ldb, ldc = m + 2, k, m
    A = colmajor(a, lda, device)
    B = colmajor(b, ldb, device)

    h = compat.create()

    # --- gemm (INT8 backend; plain-cuBLAS entry analog) -----------------
    C = zeros()
    compat.gemm(h, "N", "N", m, n, k, 1.0, A, lda, B, ldb, 0.0, C, ldc,
                num_moduli=8, fastmode=True)
    got = unpack(C)
    err = np.abs(got - expected).max()
    print("compat.gemm INT8 max abs error:", err)
    assert err == 0.0

    # --- gemmLt (FP8 backend; Lt entry analog) --------------------------
    C2 = zeros()
    compat.gemmLt(h, "N", "N", m, n, k, 1.0, A, lda, B, ldb, 0.0, C2, ldc,
                  num_moduli=8, fastmode=True, backend="FP8")
    got2 = unpack(C2)
    err2 = np.abs(got2 - expected).max()
    print("compat.gemmLt FP8 max abs error:", err2)
    assert err2 == 0.0

    # gemm must reject FP8 as the reference's plain entry does
    try:
        compat.gemm(h, "N", "N", m, n, k, 1.0, A, lda, B, ldb, 0.0,
                    zeros(), ldc, num_moduli=8, fastmode=True,
                    backend="FP8")
    except ValueError as e:
        print("plain gemm rejected FP8 as expected:", str(e)[:60], "...")
    else:
        raise AssertionError("compat.gemm must reject backend='FP8'")

    # --- skip-scal reuse: quantize A once, multiply against two Bs ------
    C3 = zeros()
    compat.gemm(h, "N", "N", m, n, k, 1.0, A, lda, B, ldb, 0.0, C3, ldc,
                num_moduli=8, fastmode=True, enable_skip_scalA=True)
    C4 = zeros()
    compat.gemm(h, "N", "N", m, n, k, 1.0, A, lda, B, ldb, 0.0, C4, ldc,
                num_moduli=8, fastmode=True, skip_scalA=True)  # cached planes
    got3, got4 = unpack(C3), unpack(C4)
    assert np.array_equal(got3, got4), "skip-scal reuse must be bit-identical"
    assert np.abs(got3 - expected).max() == 0.0
    print("skip-scal reuse bit-identical: True")

    ws = compat.workSize(m, n, k, 8)
    print(f"workSize({m},{n},{k},nu=8) planning estimate: {ws} bytes")
    compat.destroy(h)
    print("OK")
    return dict(got=got, got2=got2, got3=got3, got4=got4, err=err,
                err2=err2, ws=ws)


if __name__ == "__main__":
    cli(main)
