"""Triangular solves, LU and Cholesky over the emulated GEMM.

The counterpart of gemmul8_tpu/solvers.py: every O(n^3) flop -- the
trailing Schur updates of LU and Cholesky and the off-diagonal updates of
the blocked substitutions -- runs through the port's :func:`gemm` (K1, the
int8 products and K2; complex operands through the 3M path), and only the
O(n * block^2) diagonal-block work is native. With ``mesh`` (a 2-D
DeviceMesh from gemmul8_tpu_torch.parallel.make_mesh) those updates run
distributed through :func:`summa_gemm`, as in the JAX package: bit-identical
across mesh shapes, not to mesh=None (SUMMA's shifts differ in the last
bit, and its result is subtracted apart from the product, not in gemm's
fused epilogue). Every rank runs the same call on the same full operands.
Upper-triangular cases reduce to the lower one by the exact reversal
permutation (flip rows and columns), so there is one substitution path.

The native pieces are the module-level functions ``_tri_solve_native``,
``_small_matmul``, ``_panel_lu`` and ``_chol_native``: torch.linalg and
torch.matmul, so cuSOLVER and cuBLAS on the card and LAPACK on the CPU.
Everything around them (block loops, flips, permutations, masks, the
emulated updates) computes what the JAX package computes, bit for bit, on
the same native results. getrf factors its panels with the native pivoted
LU on every device (the H100 has f64 LU); the JAX package's TPU-only
workaround for a missing f64 LuDecomposition has no counterpart here.

fastmode defaults to "robust", as in the JAX package: the updates are
Gram-type products whose diagonals meet the Cauchy-Schwarz bound with
equality, where the reference's fast shifts can wrap the CRT.

Operands are placed with the port's usual rules (``device="cuda"`` by
default; ``device="cpu"`` runs every kernel's plain version). No function
writes into a caller's tensor: each works on its own copy.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import tables
from .complex_gemm import _cmul, _scalar
from .core import _as_tensor, _device, gemm

__all__ = ["trsm", "trmm", "getrf", "lu_solve", "solve", "potrf", "potrs",
           "posv", "inv", "trtri"]


def _check_2d(x, name):
    if x.dim() != 2:
        raise ValueError(f"{name} must be 2-D, got ndim={x.dim()}")


def _blocks(n: int, block: int):
    """Static block partition [0, b, 2b, ..., n] (last block ragged)."""
    cuts = list(range(0, n, block)) + [n]
    return list(zip(cuts[:-1], cuts[1:]))


def _default_block(n: int) -> int:
    # large enough that the update GEMMs dominate, small enough that the
    # native diagonal solves stay O(n * block^2) noise
    return max(32, min(512, n))


def _check_mesh_blocking(mesh, n_or_shape, blk, name, rhs_cols=None):
    """Distributed updates route through SUMMA, which shards every GEMM dim
    over the mesh: block and every block boundary must divide both mesh
    axes (and the RHS column count must divide mesh.y, for the substitution
    updates whose n dimension is the RHS width). Enforced upfront so
    failures name the constraint, not a shape."""
    if mesh is None:
        return
    mx, my = tuple(mesh.mesh.shape)
    dims = (n_or_shape,) if isinstance(n_or_shape, int) else tuple(n_or_shape)
    bad = blk % mx or blk % my or any(d % blk for d in dims)
    if bad:
        raise ValueError(
            f"{name} with mesh {mx}x{my} needs block divisible by both mesh "
            f"axes and dims divisible by block; got block={blk}, dims={dims}")
    if rhs_cols is not None and rhs_cols % my:
        raise ValueError(
            f"{name} with mesh {mx}x{my} needs the RHS column count "
            f"divisible by mesh.y; got {rhs_cols}")


def _ct(x):
    """Conjugate transpose over the last two axes, materialized (a plain
    transpose on real operands)."""
    x = x.transpose(-2, -1)
    return x.conj().resolve_conj() if x.is_complex() else x


def _scale(alpha, x):
    """alpha * x as the JAX package computes jnp.asarray(alpha).astype(
    x.dtype) * x: alpha rounded to x's dtype, then one product (XLA:CPU's
    complex product on complex operands)."""
    if x.is_complex():
        return _cmul(_scalar(complex(alpha), x.dtype, x), x)
    return torch.tensor(float(alpha), dtype=torch.float64,
                        device=x.device).to(x.dtype) * x


def _dist_gemm(a_blk, b_blk, *, mesh=None, num_moduli, fastmode, backend):
    """Plain emulated product a_blk @ b_blk, distributed through SUMMA when
    `mesh` is given (every rank gets the full product, gathered through
    SUMMA's collectives): the one local/distributed dispatch point of the
    solver and QR layers."""
    if mesh is None:
        return gemm(a_blk, b_blk, num_moduli=num_moduli, fastmode=fastmode,
                    backend=backend, device=a_blk.device)
    from .parallel import summa
    c = summa.summa_gemm(a_blk, b_blk, mesh=mesh, num_moduli=num_moduli,
                         fastmode=fastmode, backend=backend)
    return summa.Comm(mesh).gather_all(c.to_local(), 1).to(a_blk.device)


def _schur_update(a_blk, b_blk, c_blk, *, mesh=None, num_moduli, fastmode,
                  backend, sign=-1.0):
    """c_blk + sign * a_blk @ b_blk, emulated, in gemm's fused alpha=sign,
    beta=1 epilogue (sign=-1: Schur complement / substitution update; +1:
    trmm row accumulation); with `mesh` the SUMMA product, then the
    elementwise sum. Returns a new tensor."""
    if mesh is None:
        return gemm(a_blk, b_blk, num_moduli=num_moduli, fastmode=fastmode,
                    backend=backend, alpha=sign, beta=1.0, c=c_blk,
                    device=a_blk.device)
    prod = _dist_gemm(a_blk, b_blk, mesh=mesh, num_moduli=num_moduli,
                      fastmode=fastmode, backend=backend)
    return c_blk - prod if sign == -1.0 else c_blk + prod


# ---------------------------------------------------------------------------
# the native pieces
# ---------------------------------------------------------------------------

def _tri_solve_native(t, rhs, *, unit_diag: bool):
    """Native lower-triangular solve of a small diagonal block. tril()
    makes the contract explicit where t is a packed-LU block whose upper
    triangle holds U."""
    return torch.linalg.solve_triangular(torch.tril(t), rhs, upper=False,
                                         unitriangular=unit_diag)


def _small_matmul(x, y):
    """Native product of a small (block x block) factor with a panel."""
    return torch.matmul(x, y)


def _pivots_to_perm(piv, m: int) -> np.ndarray:
    """LAPACK's sequential row swaps (0-based: row i swapped with row
    piv[i], in order) as the absolute row order perm, (PA)[i] = A[perm[i]]
    -- jax.lax.linalg.lu's convention."""
    perm = np.arange(m)
    for i, p in enumerate(piv):
        perm[i], perm[p] = perm[p], perm[i]
    return perm


def _panel_lu(a):
    """Native pivoted LU of an (m, b) panel, m >= b: (packed LU, perm) with
    perm an int64 tensor of absolute row indices. The pivots come to the
    host once a panel (b swaps to replay)."""
    lu, piv, _ = torch.linalg.lu_factor_ex(a)
    perm = _pivots_to_perm(piv.cpu().numpy() - 1, a.shape[0])
    return lu, torch.from_numpy(perm).to(a.device)


def _chol_native(a):
    """Native lower Cholesky factor of a small Hermitian block (no error
    check, so no host sync: a non-positive pivot gives non-finite values,
    as the JAX package's native cholesky does)."""
    return torch.linalg.cholesky_ex(a).L


def _hermitian_part(x):
    """(x + x^H) / 2 over the last two axes: the input symmetrization
    jax.lax.linalg.cholesky and jnp.linalg.eigh apply before LAPACK."""
    return (x + _ct(x)) / 2


# ---------------------------------------------------------------------------
# blocked substitution and product
# ---------------------------------------------------------------------------

def _trsm_lower_left(t, b, *, unit_diag, num_moduli, fastmode, backend,
                     block, mesh=None):
    """X with T @ X = B, T lower-triangular (m, m), B (m, n).

    Blocked forward substitution: the diagonal solves are native, the
    off-diagonal update B_i -= T[i,:i] @ X[:i] is ONE emulated GEMM per
    block row (alpha=-1, beta=1 fused epilogue; distributed through SUMMA
    when `mesh` is given).
    """
    spans = _blocks(t.shape[0], block)
    if len(spans) == 1:
        return _tri_solve_native(t, b, unit_diag=unit_diag)
    x = torch.empty_like(b)
    for (lo, hi) in spans:
        rhs = b[lo:hi]
        if lo > 0:
            rhs = _schur_update(t[lo:hi, :lo], x[:lo], rhs, mesh=mesh,
                                num_moduli=num_moduli, fastmode=fastmode,
                                backend=backend)
        x[lo:hi] = _tri_solve_native(t[lo:hi, lo:hi], rhs,
                                     unit_diag=unit_diag)
    return x


def _trmm_lower_left(t, b, *, unit_diag, num_moduli, fastmode, backend,
                     block, mesh=None):
    """T @ B with T lower-triangular: per block row, one emulated GEMM over
    the strictly-lower panel plus a native small triangular product."""
    out = torch.empty_like(b)
    for (lo, hi) in _blocks(t.shape[0], block):
        tdiag = torch.tril(t[lo:hi, lo:hi])
        if unit_diag:
            tdiag = (tdiag - torch.diag(torch.diag(tdiag))
                     + torch.eye(hi - lo, dtype=t.dtype, device=t.device))
        row = _small_matmul(tdiag, b[lo:hi])
        if lo > 0:
            row = _schur_update(t[lo:hi, :lo], b[:lo], row, mesh=mesh,
                                num_moduli=num_moduli, fastmode=fastmode,
                                backend=backend, sign=1.0)
        out[lo:hi] = row
    return out


def _canon_tri(a, lower, trans_a):
    """op(A) and whether it is lower-triangular. op 'C' conjugates complex
    operands; on real ones it is identical to 'T'."""
    if isinstance(trans_a, bool):
        t_flag, conj = trans_a, False
    else:
        s = str(trans_a).upper()
        if s not in ("N", "T", "C"):
            raise ValueError(f"bad op {trans_a!r}")
        t_flag, conj = s in ("T", "C"), s == "C"
    t = a.T if t_flag else a
    if conj and a.is_complex():
        t = t.conj().resolve_conj()
    return t, (lower != t_flag)


def _flip2(x):
    return torch.flip(x, (0, 1))


def _tri_operands(a, b, side):
    if a.dtype != b.dtype:
        raise TypeError(f"dtype mismatch: {a.dtype} vs {b.dtype}")
    if a.shape[0] != a.shape[1]:
        raise ValueError(f"A must be square, got {tuple(a.shape)}")
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    nd = b.shape[0] if side == "left" else b.shape[1]
    if a.shape[0] != nd:
        raise ValueError(f"A {tuple(a.shape)} does not match B "
                         f"{tuple(b.shape)} for side={side!r}")


def trsm(a, b, *, side: str = "left", lower: bool = True, trans_a=False,
         unit_diag: bool = False, alpha=1.0, num_moduli: int = 8,
         fastmode="robust", backend: str = tables.Backend.INT8,
         block: Optional[int] = None, mesh=None,
         device="cuda") -> torch.Tensor:
    """Triangular solve with the O(n^3) updates emulated.

    side="left":  solve op(A) @ X = alpha * B   (A is (m, m), B is (m, n))
    side="right": solve X @ op(A) = alpha * B   (A is (n, n), B is (m, n))

    The diagonal blocks (`block` wide, default <= 512) solve natively;
    everything else is blocked substitution whose updates are emulated
    GEMMs. With `mesh` the update GEMMs run distributed through
    summa_gemm (block and the matrix dims divisible as
    _check_mesh_blocking says, the RHS width by mesh.y).
    """
    device = _device(device)
    a, b = _as_tensor(a, device), _as_tensor(b, device)
    _check_2d(a, "A")
    _check_2d(b, "B")
    _tri_operands(a, b, side)
    if not (isinstance(alpha, (int, float)) and alpha == 1):
        b = _scale(alpha, b)
    t, is_lower = _canon_tri(a, bool(lower), trans_a)
    if side == "right":
        # X @ T = B  <=>  T' @ X' = B'
        t, b, is_lower = t.T, b.T, not is_lower
    if not is_lower:
        # reversal trick: P @ U @ P is lower for the exchange permutation P
        t, b = _flip2(t), torch.flip(b, (0,))
    blk = block or _default_block(t.shape[0])
    _check_mesh_blocking(mesh, t.shape[0], blk, "trsm", rhs_cols=b.shape[1])
    x = _trsm_lower_left(t, b, unit_diag=unit_diag, num_moduli=num_moduli,
                         fastmode=fastmode, backend=backend, block=blk,
                         mesh=mesh)
    if not is_lower:
        x = torch.flip(x, (0,))
    return x.T if side == "right" else x


def trmm(a, b, *, side: str = "left", lower: bool = True, trans_a=False,
         unit_diag: bool = False, alpha=1.0, num_moduli: int = 8,
         fastmode="robust", backend: str = tables.Backend.INT8,
         block: Optional[int] = None, mesh=None,
         device="cuda") -> torch.Tensor:
    """Triangular matrix product alpha * op(A) @ B (or B @ op(A)): each
    block row multiplies only its strictly-lower panel through the emulated
    GEMM, plus a native small diagonal product. `mesh` distributes the
    panel GEMMs through summa_gemm (see trsm)."""
    device = _device(device)
    a, b = _as_tensor(a, device), _as_tensor(b, device)
    _check_2d(a, "A")
    _check_2d(b, "B")
    _tri_operands(a, b, side)
    t, is_lower = _canon_tri(a, bool(lower), trans_a)
    if side == "right":
        t, b, is_lower = t.T, b.T, not is_lower
    if not is_lower:
        t, b = _flip2(t), torch.flip(b, (0,))
    blk = block or _default_block(t.shape[0])
    _check_mesh_blocking(mesh, t.shape[0], blk, "trmm", rhs_cols=b.shape[1])
    out = _trmm_lower_left(t, b, unit_diag=unit_diag, num_moduli=num_moduli,
                           fastmode=fastmode, backend=backend, block=blk,
                           mesh=mesh)
    if not is_lower:
        out = torch.flip(out, (0,))
    if side == "right":
        out = out.T
    if not (isinstance(alpha, (int, float)) and alpha == 1):
        out = _scale(alpha, out)
    return out


def potrf(a, *, lower: bool = True, num_moduli: int = 8, fastmode="robust",
          backend: str = tables.Backend.INT8, block: Optional[int] = None,
          mesh=None, device="cuda") -> torch.Tensor:
    """Blocked left-looking Cholesky A = L @ L^H of an SPD/HPD matrix.

    Returns L lower-triangular (upper R = L^H when lower=False; A = R^H R).
    The update of each block column against all finished columns is ONE
    emulated GEMM L[lo:, :lo] @ L[lo:hi, :lo]^H; the diagonal blocks factor
    natively and the subdiagonal panels come from the emulated substitution.
    Reads only the lower triangle (the upper one with lower=False). With
    `mesh` the block-column updates run distributed through summa_gemm;
    the subdiagonal substitutions stay local, as in the JAX package.
    """
    device = _device(device)
    a = _as_tensor(a, device)
    _check_2d(a, "A")
    n = a.shape[0]
    if a.shape[0] != a.shape[1]:
        raise ValueError(f"A must be square, got {tuple(a.shape)}")
    if not lower:
        # potrf uplo='U' reads only the upper triangle: factor A^T (complex:
        # chol_lower(A^T) = conj(L), and the final .T gives L^H = R)
        a = a.T
    blk = block or _default_block(n)
    _check_mesh_blocking(mesh, n, blk, "potrf")
    # the finished block columns go straight into `out`, so L[lo:, :lo] is
    # a view of it
    out = torch.zeros((n, n), dtype=a.dtype, device=device)
    for (lo, hi) in _blocks(n, blk):
        blk_col = a[lo:, lo:hi]
        if lo > 0:
            left = out[lo:, :lo]
            blk_col = _schur_update(left, _ct(left[:hi - lo]), blk_col,
                                    mesh=mesh, num_moduli=num_moduli,
                                    fastmode=fastmode, backend=backend)
        strict = torch.tril(blk_col[:hi - lo], -1)
        diag = _chol_native(_hermitian_part(
            torch.tril(blk_col[:hi - lo]) + _ct(strict)))
        out[lo:hi, lo:hi] = torch.tril(diag)
        if hi < n:
            # L21 = A21 @ L11^{-H}: L11 X^H = A21^H, already lower
            l21 = _trsm_lower_left(
                diag, _ct(blk_col[hi - lo:]), unit_diag=False,
                num_moduli=num_moduli, fastmode=fastmode, backend=backend,
                block=blk)
            out[hi:, lo:hi] = _ct(l21)
    return out.T if not lower else out


def getrf(a, *, num_moduli: int = 8, fastmode="robust",
          backend: str = tables.Backend.INT8, block: Optional[int] = None,
          mesh=None, device="cuda"):
    """Blocked right-looking LU with partial pivoting, PA = LU.

    Returns (lu, perm): `lu` packs L (unit lower) and U like LAPACK getrf;
    `perm` is the length-m int32 row permutation as absolute row indices
    ((PA)[i] == A[perm[i]]). The panels factor natively; the U12 row solves
    and every trailing Schur update A22 -= L21 @ U12 -- the O(n^3) bulk --
    run through the emulated GEMM (HPL-MxP-style mixed-precision LU). With
    `mesh` the Schur updates run distributed through summa_gemm; the panels
    and the U12 substitutions stay local, as in the JAX package.
    """
    device = _device(device)
    a = _as_tensor(a, device)
    _check_2d(a, "A")
    m, n = a.shape
    kmin = min(m, n)
    blk = block or _default_block(kmin)
    _check_mesh_blocking(mesh, (m, n), blk, "getrf")
    a = a.clone()
    # perm[i] = original row index now at row i
    perm = torch.arange(m, device=device)
    for lo in range(0, kmin, blk):
        hi = min(lo + blk, kmin)
        p_lu, p_perm = _panel_lu(a[lo:, lo:hi])
        # the panel's row order applies to the whole trailing rows (factored
        # L columns and unfactored columns alike); then the factored panel
        rows = a[lo:].index_select(0, p_perm)
        rows[:, lo:hi] = p_lu
        a[lo:] = rows
        perm[lo:] = perm[lo:].index_select(0, p_perm)
        if hi < n:
            # U12 = L11^{-1} A12: unit-lower solve, emulated updates
            u12 = _trsm_lower_left(
                a[lo:hi, lo:hi], a[lo:hi, hi:], unit_diag=True,
                num_moduli=num_moduli, fastmode=fastmode, backend=backend,
                block=blk)
            a[lo:hi, hi:] = u12
            if hi < m:
                # Schur: A22 -= L21 @ U12 (the emulated O(n^3) bulk)
                a[hi:, hi:] = _schur_update(
                    a[hi:, lo:hi], u12, a[hi:, hi:], mesh=mesh,
                    num_moduli=num_moduli, fastmode=fastmode,
                    backend=backend)
    return a, perm.to(torch.int32)


def lu_solve(lu, perm, b, *, num_moduli: int = 8, fastmode="robust",
             backend: str = tables.Backend.INT8, block: Optional[int] = None,
             mesh=None, device="cuda") -> torch.Tensor:
    """Solve A @ X = B from getrf's (lu, perm): permute, then two trsm.
    A vector B is solved locally whatever `mesh` says (as in the JAX
    package, where a width-1 RHS cannot meet the mesh's divisibility)."""
    device = _device(device)
    lu, b = _as_tensor(lu, device), _as_tensor(b, device)
    perm = _as_tensor(perm, device)
    squeeze = b.dim() == 1
    if squeeze:
        b = b[:, None]
        mesh = None
    pb = b.index_select(0, perm.long())
    kw = dict(num_moduli=num_moduli, fastmode=fastmode, backend=backend,
              block=block, mesh=mesh, device=device)
    y = trsm(lu, pb, lower=True, unit_diag=True, **kw)
    x = trsm(lu, y, lower=False, unit_diag=False, **kw)
    return x[:, 0] if squeeze else x


def inv(a, *, num_moduli: int = 8, fastmode="robust",
        backend: str = tables.Backend.INT8, block: Optional[int] = None,
        mesh=None, device="cuda") -> torch.Tensor:
    """Matrix inverse via emulated-GEMM LU (getrf + getri analog):
    A^{-1} = lu_solve(I)."""
    device = _device(device)
    a = _as_tensor(a, device)
    _check_2d(a, "A")
    if a.shape[0] != a.shape[1]:
        raise ValueError(f"inv needs a square matrix, got {tuple(a.shape)}")
    kw = dict(num_moduli=num_moduli, fastmode=fastmode, backend=backend,
              block=block, mesh=mesh, device=device)
    lu, perm = getrf(a, **kw)
    eye = torch.eye(a.shape[0], dtype=a.dtype, device=device)
    return lu_solve(lu, perm, eye, **kw)


def trtri(a, *, lower: bool = True, unit_diag: bool = False,
          num_moduli: int = 8, fastmode="robust",
          backend: str = tables.Backend.INT8, block: Optional[int] = None,
          mesh=None, device="cuda") -> torch.Tensor:
    """Triangular matrix inverse (trtri analog): A @ X = I through the
    blocked trsm, then masked to A's triangle, so the other triangle is
    exactly zero. With `unit_diag` the result is unit-diagonal too and A's
    stored diagonal is never read."""
    device = _device(device)
    a = _as_tensor(a, device)
    _check_2d(a, "A")
    if a.shape[0] != a.shape[1]:
        raise ValueError(f"trtri needs a square matrix, got {tuple(a.shape)}")
    n = a.shape[0]
    eye = torch.eye(n, dtype=a.dtype, device=device)
    x = trsm(a, eye, side="left", lower=lower, unit_diag=unit_diag,
             num_moduli=num_moduli, fastmode=fastmode, backend=backend,
             block=block, mesh=mesh, device=device)
    x = torch.tril(x) if lower else torch.triu(x)
    if unit_diag:
        x = x - torch.diag(torch.diagonal(x)) + eye
    return x


def _refine(a, b, x, solve_fn, *, residual_moduli, fastmode, backend):
    """One step of iterative refinement: x + solve(b - a @ x), the residual
    emulated at residual_moduli."""
    bx = x[:, None] if x.dim() == 1 else x
    bb = b[:, None] if b.dim() == 1 else b
    r = gemm(a, bx, num_moduli=residual_moduli, fastmode=fastmode,
             backend=backend, alpha=-1.0, beta=1.0, c=bb, device=a.device)
    if x.dim() == 1:
        r = r[:, 0]
    return x + solve_fn(r)


def _residual_moduli(a, num_moduli, residual_moduli):
    if residual_moduli is not None:
        return residual_moduli
    from .accuracy_model import choose_moduli
    return max(num_moduli, choose_moduli(dtype=a.dtype).num_moduli)


def solve(a, b, *, num_moduli: int = 8, fastmode="robust",
          backend: str = tables.Backend.INT8, block: Optional[int] = None,
          refine_steps: int = 0, residual_moduli: Optional[int] = None,
          mesh=None, device="cuda") -> torch.Tensor:
    """Dense solve A @ X = B via emulated-GEMM LU, with optional iterative
    refinement: a cheap factorization (low num_moduli) plus residuals
    emulated at high accuracy (`residual_moduli`, by default the dtype's
    native-precision setting from choose_moduli, never below num_moduli)
    recover a full-precision solution -- the HPL-MxP pattern."""
    device = _device(device)
    a, b = _as_tensor(a, device), _as_tensor(b, device)
    if refine_steps:
        residual_moduli = _residual_moduli(a, num_moduli, residual_moduli)
    kw = dict(num_moduli=num_moduli, fastmode=fastmode, backend=backend,
              block=block, device=device)
    lu, perm = getrf(a, mesh=mesh, **kw)

    def lu_solve_(rhs):
        return lu_solve(lu, perm, rhs, **kw)

    x = lu_solve_(b)
    for _ in range(refine_steps):
        x = _refine(a, b, x, lu_solve_, residual_moduli=residual_moduli,
                    fastmode=fastmode, backend=backend)
    return x


def potrs(chol, b, *, lower: bool = True, num_moduli: int = 8,
          fastmode="robust", backend: str = tables.Backend.INT8,
          block: Optional[int] = None, mesh=None,
          device="cuda") -> torch.Tensor:
    """Solve A @ X = B from potrf's Cholesky factor: L y = B then L^H x = y
    (or the upper-factor pair with lower=False). A vector B is solved
    locally whatever `mesh` says, as in lu_solve."""
    device = _device(device)
    chol, b = _as_tensor(chol, device), _as_tensor(b, device)
    squeeze = b.dim() == 1
    if squeeze:
        b = b[:, None]
        mesh = None
    kw = dict(lower=lower, num_moduli=num_moduli, fastmode=fastmode,
              backend=backend, block=block, mesh=mesh, device=device)
    # Hermitian factors solve against the conjugate transpose; on real
    # operands 'C' is plain T
    y = trsm(chol, b, trans_a=(False if lower else "C"), **kw)
    x = trsm(chol, y, trans_a=("C" if lower else False), **kw)
    return x[:, 0] if squeeze else x


def posv(a, b, *, lower: bool = True, num_moduli: int = 8, fastmode="robust",
         backend: str = tables.Backend.INT8, block: Optional[int] = None,
         refine_steps: int = 0, residual_moduli: Optional[int] = None,
         mesh=None, device="cuda") -> torch.Tensor:
    """SPD solve A @ X = B via emulated-GEMM Cholesky (posv analog), with
    the same optional iterative refinement as :func:`solve`."""
    device = _device(device)
    a, b = _as_tensor(a, device), _as_tensor(b, device)
    _check_2d(a, "A")
    if a.shape[0] != a.shape[1]:
        raise ValueError(f"posv needs a square matrix, got {tuple(a.shape)}")
    if refine_steps:
        residual_moduli = _residual_moduli(a, num_moduli, residual_moduli)
    kw = dict(lower=lower, num_moduli=num_moduli, fastmode=fastmode,
              backend=backend, block=block, device=device)
    chol = potrf(a, mesh=mesh, **kw)

    def potrs_(rhs):
        return potrs(chol, rhs, **kw)

    x = potrs_(b)
    for _ in range(refine_steps):
        x = _refine(a, b, x, potrs_, residual_moduli=residual_moduli,
                    fastmode=fastmode, backend=backend)
    return x
