"""Level-3 BLAS on the emulated GEMM: syr2k/her2k and symm/hemm, with the
planar forms her2k_planar, symm_planar and hemm_planar.

The counterpart of gemmul8_tpu/blas3.py, composed over the port's gemm and
gemm_planar (real or complex, INT8 or FP8, any mode), so that each routine
is bit-equal to the JAX package's on the CPU:

  * syr2k/her2k take one emulated product: B @ op(A) is elementwise the
    (conjugate) transpose of A @ op(B), so C = G + G^T (G + G^H) with
    G = alpha * A @ op(B); the result is exactly (conjugate-)symmetric;
  * symm/hemm mirror the stored triangle of A into the full matrix (exact
    copies; hemm drops the imaginary part of the diagonal, as BLAS assumes
    it zero) and take one emulated product.

Operands are placed on `device`, "cuda" unless the caller asks for the CPU.
"""
from __future__ import annotations

import torch

from . import core, tables
from .complex_gemm import _cmul, _complex_scalar, gemm_planar
from .core import gemm

__all__ = ["syr2k", "her2k", "symm", "hemm",
           "her2k_planar", "hemm_planar", "symm_planar"]


def _check_real_scalar(x, name):
    if isinstance(x, complex) and x.imag != 0:
        raise ValueError(f"{name} must be real (BLAS *her2k/*herk take a "
                         f"real {name}), got {x!r}")


def _scalar(v, dtype, like: torch.Tensor) -> torch.Tensor:
    """The real scalar v as a 0-d tensor of `dtype`, rounded as
    jnp.asarray(v).astype(dtype) rounds it under x64 (through f64)."""
    return torch.tensor(v, dtype=torch.float64, device=like.device).to(dtype)


def syr2k(a, b, *, trans: bool = False, num_moduli: int = 8,
          fastmode="robust", backend: str = tables.Backend.INT8, alpha=1.0,
          beta=0.0, c=None, epilogue: str = "auto",
          device="cuda") -> torch.Tensor:
    """Emulated symmetric rank-2k update (dsyr2k):

      C = alpha * (A @ B^T + B @ A^T) + beta * C          (trans=False)
      C = alpha * (A^T @ B + B^T @ A) + beta * C          (trans=True)

    One emulated GEMM, G = alpha * A @ B^T, and C = G + G^T: exactly
    symmetric bit for bit. Real dtypes; her2k takes complex ones."""
    device = core._device(device)
    a, b = core._as_tensor(a, device), core._as_tensor(b, device)
    if a.dtype.is_complex:
        raise TypeError("syr2k is real-only; use her2k for complex operands")
    g = gemm(a, b, trans_a=bool(trans), trans_b=not trans,
             num_moduli=num_moduli, fastmode=fastmode, backend=backend,
             alpha=alpha, epilogue=epilogue, device=device)
    out = g + g.T
    if c is not None and not (isinstance(beta, (int, float)) and beta == 0):
        c = core._as_tensor(c, device)
        out = out + (c if isinstance(beta, (int, float)) and beta == 1
                     else _scalar(beta, out.dtype, out) * c)
    return out


def her2k(a, b, *, trans: bool = False, num_moduli: int = 8,
          fastmode="robust", backend: str = tables.Backend.INT8, alpha=1.0,
          beta=0.0, c=None, epilogue: str = "auto",
          device="cuda") -> torch.Tensor:
    """Emulated Hermitian rank-2k update (zher2k; beta real as in BLAS):

      C = alpha * A @ B^H + conj(alpha) * B @ A^H + beta * C   (trans=False)
      C = alpha * A^H @ B + conj(alpha) * B^H @ A + beta * C   (trans=True)

    One emulated complex (3M) GEMM, G = alpha * A @ op(B), and C = G + G^H:
    the diagonal exactly real, the matrix exactly Hermitian bit for bit."""
    device = core._device(device)
    a, b = core._as_tensor(a, device), core._as_tensor(b, device)
    if not a.dtype.is_complex:
        raise TypeError("her2k is complex-only; use syr2k for real operands")
    _check_real_scalar(beta, "beta")
    g = gemm(a, b, trans_a="C" if trans else "N",
             trans_b="N" if trans else "C", num_moduli=num_moduli,
             fastmode=fastmode, backend=backend, alpha=alpha,
             epilogue=epilogue, device=device)
    out = g + g.conj().T
    if c is not None and not (isinstance(beta, (int, float)) and beta == 0):
        c = core._as_tensor(c, device)
        if isinstance(beta, (int, float)) and beta == 1:
            out = out + c
        else:
            # beta's real part in the real dtype, promoted to complex and
            # multiplied as jnp multiplies a real scalar by a complex array
            beta_r = _scalar(_complex_scalar(beta).real, out.real.dtype, out)
            out = out + _cmul(beta_r.to(out.dtype), c)
    return out


def _full_from_triangle(a, lower, hermitian):
    """The stored triangle mirrored into a full (conjugate-)symmetric matrix:
    exact, both copies carry the stored values; for hermitian the
    diagonal's imaginary part is dropped (BLAS *hemm never reads it)."""
    strict = torch.tril(a, -1) if lower else torch.triu(a, 1)
    mirror = strict.conj().T if hermitian else strict.T
    d = torch.diagonal(a)
    if hermitian:
        d = d.real.to(a.dtype)
    return strict + mirror + torch.diag(d)


def _symm_hemm(a, b, side, lower, hermitian, num_moduli, fastmode, backend,
               alpha, beta, c, epilogue, name, device):
    device = core._device(device)
    a, b = core._as_tensor(a, device), core._as_tensor(b, device)
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"{name} expects 2-D operands, got A.ndim={a.dim()}, "
                         f"B.ndim={b.dim()}")
    if a.shape[0] != a.shape[1]:
        raise ValueError(f"A must be square, got {tuple(a.shape)}")
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    nd = b.shape[0] if side == "left" else b.shape[1]
    if a.shape[0] != nd:
        raise ValueError(f"A {tuple(a.shape)} does not match B "
                         f"{tuple(b.shape)} for side={side!r}")
    full = _full_from_triangle(a, bool(lower), hermitian)
    lhs, rhs = (full, b) if side == "left" else (b, full)
    return gemm(lhs, rhs, num_moduli=num_moduli, fastmode=fastmode,
                backend=backend, alpha=alpha, beta=beta, c=c,
                epilogue=epilogue, device=device)


def symm(a, b, *, side: str = "left", lower: bool = True,
         num_moduli: int = 8, fastmode="robust",
         backend: str = tables.Backend.INT8, alpha=1.0, beta=0.0,
         c=None, epilogue: str = "auto", device="cuda") -> torch.Tensor:
    """Emulated symmetric matrix product (dsymm):

      C = alpha * sym(A) @ B + beta * C    (side="left";  A is (m, m))
      C = alpha * B @ sym(A) + beta * C    (side="right"; A is (n, n))

    Only the `lower` (or upper) triangle of A is read and mirrored before one
    emulated GEMM. Every dtype the emulator takes; complex A mirrors without
    conjugation (csymm/zsymm; hemm takes Hermitian A)."""
    return _symm_hemm(a, b, side, lower, False, num_moduli, fastmode,
                      backend, alpha, beta, c, epilogue, "symm", device)


def hemm(a, b, *, side: str = "left", lower: bool = True,
         num_moduli: int = 8, fastmode="robust",
         backend: str = tables.Backend.INT8, alpha=1.0, beta=0.0,
         c=None, epilogue: str = "auto", device="cuda") -> torch.Tensor:
    """Emulated Hermitian matrix product (zhemm): as symm, with the mirror
    conjugated and the diagonal's imaginary part dropped. Complex-only."""
    device = core._device(device)
    a = core._as_tensor(a, device)
    if not a.dtype.is_complex:
        raise TypeError("hemm is complex-only; use symm for real operands")
    return _symm_hemm(a, b, side, lower, True, num_moduli, fastmode,
                      backend, alpha, beta, c, epilogue, "hemm", device)


def her2k_planar(ar, ai, br, bi, *, trans: bool = False, num_moduli: int = 8,
                 fastmode="robust", backend: str = tables.Backend.INT8,
                 alpha=1.0, epilogue: str = "auto", device="cuda"):
    """Planar her2k: (Ar, Ai), (Br, Bi) -> (Cr, Ci) = alpha A B^H +
    conj(alpha) B A^H. With G the one product and P + iQ = alpha * G (the
    complex multiply on the planes), Cr = P + P^T is exactly symmetric and
    Ci = Q - Q^T exactly antisymmetric, with a zero diagonal."""
    gr, gi = gemm_planar(ar, ai, br, bi, trans_a="C" if trans else "N",
                         trans_b="N" if trans else "C",
                         num_moduli=num_moduli, fastmode=fastmode,
                         backend=backend, epilogue=epilogue, device=device)
    al = complex(alpha)
    if al != 1:
        a_r = _scalar(al.real, gr.dtype, gr)
        a_i = _scalar(al.imag, gr.dtype, gr)
        gr, gi = a_r * gr - a_i * gi, a_r * gi + a_i * gr
    return gr + gr.T, gi - gi.T


def _full_planar(ar, ai, lower, hermitian):
    """Planar triangle mirror: the real plane symmetric; the imaginary plane
    symmetric (complex-symmetric) or antisymmetric with a zero diagonal
    (Hermitian: the stored diagonal's imaginary part is ignored)."""
    strict_r = torch.tril(ar, -1) if lower else torch.triu(ar, 1)
    strict_i = torch.tril(ai, -1) if lower else torch.triu(ai, 1)
    full_r = strict_r + strict_r.T + torch.diag(torch.diagonal(ar))
    if hermitian:
        full_i = strict_i - strict_i.T
    else:
        full_i = strict_i + strict_i.T + torch.diag(torch.diagonal(ai))
    return full_r, full_i


def _symm_hemm_planar(ar, ai, br, bi, side, lower, hermitian, num_moduli,
                      fastmode, backend, epilogue, device):
    device = core._device(device)
    ar, ai, br, bi = (core._as_tensor(x, device) for x in (ar, ai, br, bi))
    if ar.shape[0] != ar.shape[1]:
        raise ValueError(f"A must be square, got {tuple(ar.shape)}")
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    full_r, full_i = _full_planar(ar, ai, bool(lower), hermitian)
    args = ((full_r, full_i, br, bi) if side == "left"
            else (br, bi, full_r, full_i))
    return gemm_planar(*args, num_moduli=num_moduli, fastmode=fastmode,
                       backend=backend, epilogue=epilogue, device=device)


def hemm_planar(ar, ai, br, bi, *, side: str = "left", lower: bool = True,
                num_moduli: int = 8, fastmode="robust",
                backend: str = tables.Backend.INT8, epilogue: str = "auto",
                device="cuda"):
    """Planar hemm: herm(A) @ B (or B @ herm(A)) on separate real planes;
    bit-equal to hemm() on complex views. Only the `lower` (or upper)
    triangle of (Ar, Ai) is read; the imaginary diagonal is ignored."""
    return _symm_hemm_planar(ar, ai, br, bi, side, lower, True, num_moduli,
                             fastmode, backend, epilogue, device)


def symm_planar(ar, ai, br, bi, *, side: str = "left", lower: bool = True,
                num_moduli: int = 8, fastmode="robust",
                backend: str = tables.Backend.INT8, epilogue: str = "auto",
                device="cuda"):
    """Planar complex-symmetric symm (zsymm): sym(A) @ B with the triangle
    mirrored without conjugation; bit-equal to symm() on complex views."""
    return _symm_hemm_planar(ar, ai, br, bi, side, lower, False, num_moduli,
                             fastmode, backend, epilogue, device)
