"""Blocked Householder QR and least squares over the emulated GEMM.

The counterpart of gemmul8_tpu/qr.py: blocked Householder with compact-WY
block reflectors (Q = I - V T V^H per block, LAPACK geqrf/larft/larfb
structure). With ``mesh`` the Gram products and the trailing updates run
distributed through summa_gemm (solvers._dist_gemm), the Gram a plain
product there, not a syrk.

- The panel factorization (m_rem x block) is native: ``_panel_qr``
  (torch.geqrf, cuSOLVER on the card), O(m * block^2) work.
- The block factor uses the closed form T = inv(diag(1/tau) + striu(V^H V)):
  V^H V is one emulated syrk (herk on complex INT8, gemm on complex FP8)
  and the bw x bw triangular inverse is native (``_tri_inv_upper``).
- Every trailing update C -= V (T^H (V^H C)) -- the O(m n^2) bulk -- runs
  its two large GEMMs through the port's :func:`gemm`; the bw x bw times
  (bw, n_rem) middle product is native (``solvers._small_matmul``).

tau_j == 0 reflectors (H_j = I: every square matrix's last one) take the
exact closed-form limit, T's j-th row and column zero, with no inf on the
device. lstsq needs full column rank. fastmode defaults to "robust" (V^H V
is a Gram product). No function writes into a caller's tensor.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import solvers, tables
from .complex_gemm import herk
from .core import _as_tensor, _device, gemm, syrk
from .solvers import (_blocks, _check_2d, _check_mesh_blocking, _ct,
                      _default_block, _dist_gemm, _schur_update, trsm)

__all__ = ["geqrf", "ormqr", "qr", "lstsq"]


def _panel_qr(panel):
    """Native Householder QR of an (m_rem, bw) panel, LAPACK's packing:
    (R above the diagonal, the reflectors below it, row-major as the panel;
    tau)."""
    return torch.geqrf(panel)


def _tri_inv_upper(m):
    """Native inverse of a small upper-triangular matrix: m @ X = I."""
    eye = torch.eye(m.shape[0], dtype=m.dtype, device=m.device)
    return torch.linalg.solve_triangular(m, eye, upper=True)


def _panel_vt(packed_panel, bw):
    """Unit-lower-trapezoidal V (m_rem, bw) from a packed QR panel."""
    v = torch.tril(packed_panel[:, :bw], -1)
    v.diagonal()[:] = 1
    return v


def _gram(v, *, num_moduli, fastmode, backend, mesh=None):
    """V^H V (V^T V for real) with plane reuse where available: syrk for
    real, herk for complex INT8; complex FP8 takes the generic gemm (its
    split planes cannot derive the 3M difference lane). With `mesh`, the
    distributed product of V^H and V."""
    if mesh is not None:
        return _dist_gemm(_ct(v), v, mesh=mesh, num_moduli=num_moduli,
                          fastmode=fastmode, backend=backend)
    kw = dict(num_moduli=num_moduli, fastmode=fastmode, backend=backend,
              device=v.device)
    if not v.is_complex():
        return syrk(v, trans=True, **kw)
    if backend == tables.Backend.INT8:
        return herk(v, trans=True, **kw)
    return gemm(_ct(v), v, **kw)


def _reciprocal(x):
    """1 / x, on complex x as XLA:CPU divides: Smith's algorithm on the
    larger of |Re x| and |Im x|, its denominator a fused multiply-add."""
    if not x.is_complex():
        return 1.0 / x
    xr, xi = x.real, x.imag
    im_larger = xr.abs() < xi.abs()
    r_i = xr / xi                                  # |Re| < |Im|
    d_i = torch.addcmul(xi, xr, r_i)
    r_r = xi / xr
    d_r = torch.addcmul(xr, xi, r_r)
    return torch.complex(torch.where(im_larger, r_i / d_i, 1 / d_r),
                         torch.where(im_larger, -1 / d_i, -r_r / d_r))


def _block_t(v, tau, *, num_moduli, fastmode, backend, mesh=None):
    """Compact-WY T for one block: T = inv(diag(1/tau) + striu(V^H V)).

    tau_j == 0 means H_j = I. The limit of T as 1/tau_j -> inf is T with row
    and column j zero (row j of striu(V^H V) is zero, since v_k[j] = 0 for
    k > j): solve with a finite dummy diagonal there, then mask those rows
    and columns to the exact limit.
    """
    w = _gram(v, num_moduli=num_moduli, fastmode=fastmode, backend=backend,
              mesh=mesh)
    good = tau != 0
    safe_inv = torch.where(good, _reciprocal(torch.where(good, tau, 1.0)),
                           1.0)
    t = _tri_inv_upper(torch.triu(w, 1) + torch.diag(safe_inv))
    return torch.where(good[:, None] & good[None, :], t, 0.0)


def _apply_block(v, t, c, *, trans, num_moduli, fastmode, backend,
                 mesh=None):
    """(I - V T^H V^H) C when trans else (I - V T V^H) C, the two large
    GEMMs emulated (^H is ^T on real operands; distributed with `mesh`).
    Returns a new tensor."""
    kw = dict(num_moduli=num_moduli, fastmode=fastmode, backend=backend,
              mesh=mesh)
    y = _dist_gemm(_ct(v), c, **kw)
    z = solvers._small_matmul(_ct(t) if trans else t, y)
    return _schur_update(v, z, c, **kw)


def _geqrf_t(a, *, num_moduli, fastmode, backend, block, mesh):
    """geqrf's body, also returning the per-block compact-WY T factors (None
    for the last block when no trailing update needed it), so that qr and
    lstsq hand them to ormqr instead of recomputing one Gram product per
    block."""
    _check_2d(a, "A")
    m, n = a.shape
    kmin = min(m, n)
    blk = block or _default_block(kmin)
    _check_mesh_blocking(mesh, (m, n), blk, "geqrf")
    kw = dict(num_moduli=num_moduli, fastmode=fastmode, backend=backend,
              mesh=mesh)
    a = a.clone()
    taus, ts = [], []
    for (lo, hi) in _blocks(kmin, blk):
        packed_panel, tau = _panel_qr(a[lo:, lo:hi])
        a[lo:, lo:hi] = packed_panel
        taus.append(tau)
        if hi < n:
            v = _panel_vt(packed_panel, hi - lo)
            t = _block_t(v, tau, **kw)
            ts.append(t)
            # trailing: C <- Q^H C = (I - V T^H V^H) C
            a[lo:, hi:] = _apply_block(v, t, a[lo:, hi:], trans=True, **kw)
        else:
            ts.append(None)
    return a, (torch.cat(taus) if len(taus) > 1 else taus[0]), ts


def geqrf(a, *, num_moduli: int = 8, fastmode="robust",
          backend: str = tables.Backend.INT8, block: Optional[int] = None,
          mesh=None, device="cuda"):
    """Blocked Householder QR, LAPACK geqrf convention: (packed, taus) with
    R in the upper triangle of `packed`, the Householder vectors below the
    diagonal (implicit unit diagonal) and `taus` the (min(m, n),) scalar
    factors. The trailing updates run through the emulated GEMM."""
    a = _as_tensor(a, _device(device))
    packed, taus, _ = _geqrf_t(a, num_moduli=num_moduli, fastmode=fastmode,
                               backend=backend, block=block, mesh=mesh)
    return packed, taus


def ormqr(packed, taus, c, *, trans: bool = False, num_moduli: int = 8,
          fastmode="robust", backend: str = tables.Backend.INT8,
          block: Optional[int] = None, mesh=None, ts=None,
          device="cuda") -> torch.Tensor:
    """Apply Q (Q^H with trans=True) from geqrf to C (ormqr, side="L").
    The block reflectors are re-derived from (packed, taus), unless `ts`
    supplies the compact-WY T factors computed during the factorization
    (same `block`); the two large GEMMs per block are emulated."""
    device = _device(device)
    packed, c = _as_tensor(packed, device), _as_tensor(c, device)
    taus = _as_tensor(taus, device)
    _check_2d(packed, "packed")
    _check_2d(c, "C")
    m, n = packed.shape
    kmin = min(m, n)
    if c.shape[0] != m:
        raise ValueError(f"C rows {c.shape[0]} != {m}")
    blk = block or _default_block(kmin)
    _check_mesh_blocking(mesh, (m, kmin), blk, "ormqr",
                         rhs_cols=c.shape[1])
    spans = _blocks(kmin, blk)
    if ts is not None and len(ts) != len(spans):
        raise ValueError(f"ts has {len(ts)} block factors for {len(spans)} "
                         f"blocks -- was geqrf run with the same block?")
    kw = dict(num_moduli=num_moduli, fastmode=fastmode, backend=backend,
              mesh=mesh)
    c = c.clone()
    # Q = (I - V1 T1 V1^H) ... (I - Vp Tp Vp^H): blocks in factorization
    # order for Q^H, in reverse for Q
    order = range(len(spans)) if trans else range(len(spans) - 1, -1, -1)
    for i in order:
        lo, hi = spans[i]
        v = _panel_vt(packed[lo:, lo:hi], hi - lo)
        t = ts[i] if ts is not None and ts[i] is not None else _block_t(
            v, taus[lo:hi], **kw)
        c[lo:] = _apply_block(v, t, c[lo:], trans=trans, **kw)
    return c


def qr(a, *, num_moduli: int = 8, fastmode="robust",
       backend: str = tables.Backend.INT8, block: Optional[int] = None,
       mesh=None, device="cuda"):
    """Reduced QR: (Q (m, kmin), R (kmin, n)) with A = Q @ R. Q comes from
    applying the block reflectors to the identity (blocked orgqr), so its
    O(m^2 kmin) formation is emulated too."""
    device = _device(device)
    a = _as_tensor(a, device)
    _check_2d(a, "A")
    m, n = a.shape
    kmin = min(m, n)
    kw = dict(num_moduli=num_moduli, fastmode=fastmode, backend=backend,
              block=block, mesh=mesh)
    packed, taus, ts = _geqrf_t(a, **kw)
    eye = torch.eye(m, kmin, dtype=a.dtype, device=device)
    q = ormqr(packed, taus, eye, trans=False, ts=ts, device=device, **kw)
    return q, torch.triu(packed[:kmin])


def lstsq(a, b, *, num_moduli: int = 8, fastmode="robust",
          backend: str = tables.Backend.INT8, block: Optional[int] = None,
          mesh=None, device="cuda") -> torch.Tensor:
    """Least-squares solution of A @ X = B (m >= n, full column rank) via
    blocked Householder QR: X = R^{-1} (Q^H B), the R solve through
    :func:`trsm`. `mesh` distributes the factorization; the Q^H B
    application and the triangular solve stay local, as in the JAX
    package."""
    device = _device(device)
    a, b = _as_tensor(a, device), _as_tensor(b, device)
    m, n = a.shape
    if m < n:
        raise ValueError(f"lstsq needs m >= n, got {tuple(a.shape)}")
    squeeze = b.dim() == 1
    if squeeze:
        b = b[:, None]
    if b.shape[0] != m:
        raise ValueError(f"B rows {b.shape[0]} != {m}")
    kw = dict(num_moduli=num_moduli, fastmode=fastmode, backend=backend,
              block=block)
    packed, taus, ts = _geqrf_t(a, mesh=mesh, **kw)
    qtb = ormqr(packed, taus, b, trans=True, ts=ts, device=device, **kw)
    x = trsm(torch.triu(packed[:n]), qtb[:n], lower=False, device=device,
             **kw)
    return x[:, 0] if squeeze else x
