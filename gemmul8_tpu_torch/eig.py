"""Block-Jacobi SVD and Hermitian eigendecomposition over the emulated GEMM.

The counterpart of gemmul8_tpu/eig.py. A sweep is a fixed round-robin
schedule of block-pair rotations; each round's work is batched emulated
GEMMs (the pair Gram products and the block-column rotations, through the
port's :func:`gemm_batched`) plus one batched native eigh of the 2b x 2b
rotation subproblems (``_eigh_small``: torch.linalg.eigh, cuSOLVER on the
card). With ``mesh`` (a DeviceMesh from
gemmul8_tpu_torch.parallel.make_mesh) each batched GEMM of a round is split
over the mesh's ranks by pairs, and one all-gather rebuilds the batch: the
pairs are independent, and so are the products, so the bits are those of
mesh=None.

svd:  one-sided (Hestenes) block Jacobi -- orthogonalizes column blocks of
      W = A V; at convergence sigma = column norms, U = W / sigma.
eigh: two-sided block Jacobi -- A <- J^H A J to diagonal form.

The rotations come from emulated products, so the off-diagonal floor
tracks ``num_moduli``. A sweep stops at ``tol`` or when the off-diagonal
stagnates at the emulation's noise floor; reading it is the one host sync
a sweep. Complex dtypes take the same schedules with conjugate-transpose
algebra. No function writes into a caller's tensor.

One difference from the JAX package, a fault it has that the port does not
carry: svd judges stagnation on the Frobenius measure of a sweep's
couplings, not on their largest normalized value, which is not monotone
while many block pairs are still coupled (at 4096^2, block 128, the JAX
rule stops after 5 sweeps with singular values wrong by 2e-2).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import tables
from .complex_gemm import _cmul
from .core import _as_tensor, _device, gemm_batched
from .solvers import _check_2d, _ct, _hermitian_part

__all__ = ["svd", "eigh"]


def _abs2(x):
    """|x|^2 elementwise, as the JAX package's (x * x.conj()).real."""
    if x.is_complex():
        return _cmul(x, x.conj().resolve_conj()).real
    return x * x


def _pick_block(n: int, block: Optional[int]) -> int:
    """Block width: must divide n (uniform 2b-wide batched gathers) and give
    at least two blocks -- a single n-wide block has no rotation pairs.
    (n == 1 is the only single-block case, exact with zero rotations.)"""
    if block is not None:
        if n % block:
            raise ValueError(f"block {block} must divide n={n}")
        if block == n and n > 1:
            raise ValueError(
                f"block {block} == n gives a single block and no rotation "
                f"pairs; need block <= n//2")
        return block
    target = max(8, min(128, n // 8))
    for b in range(min(target, n // 2), 0, -1):
        if n % b == 0:
            return b
    return 1


def _round_robin(nb: int):
    """Round-robin tournament: nb-1 (nb even) or nb (odd) rounds of
    disjoint block pairs covering every pair exactly once per sweep."""
    ids = list(range(nb)) + ([None] if nb % 2 else [])
    nn = len(ids)
    rounds = []
    for _ in range(nn - 1):
        pairs = [(min(ids[k], ids[nn - 1 - k]), max(ids[k], ids[nn - 1 - k]))
                 for k in range(nn // 2)
                 if ids[k] is not None and ids[nn - 1 - k] is not None]
        rounds.append(sorted(pairs))
        ids = [ids[0], ids[-1]] + ids[1:-1]
    return rounds


def _pair_cols(pairs, b: int, device):
    """(P, 2b) column indices for a round's block pairs."""
    out = np.empty((len(pairs), 2 * b), np.int64)
    for p, (i, j) in enumerate(pairs):
        out[p, :b] = np.arange(i * b, (i + 1) * b)
        out[p, b:] = np.arange(j * b, (j + 1) * b)
    return torch.from_numpy(out).to(device)


def _gather_cols(x, cols):
    """x (r, n) -> (P, r, 2b) block-column batch for the round (a copy)."""
    p, w = cols.shape
    return x.index_select(1, cols.reshape(-1)).reshape(
        x.shape[0], p, w).permute(1, 0, 2)


def _scatter_cols(x, cols, upd):
    """Inverse of _gather_cols, in place on x (disjoint pairs: a pure
    permutation)."""
    p, w = cols.shape
    x[:, cols.reshape(-1)] = upd.permute(1, 0, 2).reshape(x.shape[0], p * w)


def _pair_split(mesh, pairs_per_round: int):
    """This rank's share of a round's pairs, as a function that runs a
    batched GEMM on its share and all-gathers the whole batch; None without
    a mesh. A round's pairs are independent, so the split needs no
    collective inside a product."""
    if mesh is None:
        return None
    size = mesh.mesh.numel()
    if pairs_per_round % size:
        raise ValueError(
            f"mesh with {size} devices needs the pairs-per-round "
            f"({pairs_per_round}) divisible by it; pairs-per-round is "
            f"floor(nb/2) for nb = n/block blocks -- pick a block width "
            f"making that a multiple of n_devices")
    from .parallel import summa
    comm = summa.Comm(mesh)
    share = pairs_per_round // size
    me = comm.pos["x"] * comm.size["y"] + comm.pos["y"]
    mine = slice(me * share, (me + 1) * share)

    def run(a, b, **kw):
        return comm.gather_all(gemm_batched(a[mine], b[mine], **kw), 0)
    return run


def _default_nu(dtype) -> int:
    # iterative orthogonalization needs near-dtype-accurate rotations: the
    # dtype's native-precision settings (choose_moduli law)
    return 14 if dtype in (torch.float64, torch.complex128) else 9


def _tolerances(a, tol):
    eps = torch.finfo(a.dtype).eps          # the real component's
    return (32 * eps) if tol is None else float(tol)


def _eigh_small(g):
    """Native batched eigendecomposition of the (P, 2b, 2b) Hermitian
    rotation subproblems (lower triangle read): (ascending eigenvalues,
    eigenvectors)."""
    return torch.linalg.eigh(g)


def _rotations(g):
    """The rotations of a round: eigenvectors of the Hermitian part of g,
    as jnp.linalg.eigh symmetrizes its input first."""
    return _eigh_small(_hermitian_part(g))[1]


def svd(a, *, num_moduli: Optional[int] = None, fastmode="robust",
        backend: str = tables.Backend.INT8, block: Optional[int] = None,
        max_sweeps: int = 24, tol: Optional[float] = None,
        compute_uv: bool = True, mesh=None, device="cuda"):
    """SVD by one-sided block Jacobi on the emulated engine.

    Returns (u, s, vt) with a == u @ diag(s) @ vt (reduced: u is (m, kmin),
    vt (kmin, n), s descending), or s alone with ``compute_uv=False``.
    Every Gram product and rotation -- the O(m n^2) bulk -- is a batched
    emulated GEMM; only the 2b x 2b rotation eigenproblems are native.
    Columns with sigma == 0 get zero columns in u.
    """
    device = _device(device)
    a = _as_tensor(a, device)
    _check_2d(a, "A")
    if a.shape[0] < a.shape[1]:
        # run on A^H: A = (V') S (U')^H  =>  u = vt'^H, vt = u'^H
        res = svd(_ct(a), num_moduli=num_moduli,
                  fastmode=fastmode, backend=backend, block=block,
                  max_sweeps=max_sweeps, tol=tol, compute_uv=compute_uv,
                  mesh=mesh, device=device)
        if not compute_uv:
            return res
        ut, s, vtt = res
        return _ct(vtt), s, _ct(ut)
    m, n = a.shape
    nu = num_moduli if num_moduli is not None else _default_nu(a.dtype)
    b = _pick_block(n, block)
    rounds = _round_robin(n // b)
    batched = _pair_split(mesh, len(rounds[0])) or gemm_batched
    stop = _tolerances(a, tol)
    tiny = torch.finfo(a.dtype).tiny
    kw = dict(num_moduli=nu, fastmode=fastmode, backend=backend,
              device=device)

    w = a.clone()
    v = torch.eye(n, dtype=a.dtype, device=device)
    # ||A||_F^2 = trace(W^H W), which the rotations keep
    fro2 = torch.clamp(torch.sum(_abs2(a)), min=tiny)
    prev_off = None
    for sweep in range(max_sweeps):
        off = torch.zeros((), dtype=w.real.dtype, device=device)
        off2 = torch.zeros((), dtype=w.real.dtype, device=device)
        for pairs in rounds:
            if not pairs:           # nb == 1 (n == 1): nothing to rotate
                continue
            cols = _pair_cols(pairs, b, device)
            x = _gather_cols(w, cols)                       # (P, m, 2b)
            g = batched(_ct(x), x, **kw)
            d = torch.diagonal(g, dim1=1, dim2=2).real      # (P, 2b)
            denom = torch.sqrt(torch.clamp(
                d[:, :b, None] * d[:, None, b:], min=tiny))
            off = torch.maximum(off, torch.max(g[:, :b, b:].abs() / denom))
            off2 = off2 + torch.sum(_abs2(g[:, :b, b:]))
            j = torch.flip(_rotations(g), (2,))             # descending
            _scatter_cols(w, cols, batched(x, j, **kw))
            if compute_uv:
                _scatter_cols(v, cols, batched(
                    _gather_cols(v, cols), j, **kw))
        off_h, off_f = torch.stack([off, torch.sqrt(off2) / fro2]).tolist()
        if off_h <= stop:
            break
        # no improvement after warm-up means the emulation's noise floor
        # (num_moduli) has been reached. Judged on the Frobenius measure of
        # the sweep's couplings, which falls sweep by sweep: the largest
        # normalized coupling (off_h, the JAX package's measure at
        # gemmul8_tpu/eig.py:220) can rise for several sweeps while the
        # pairs are still coupled, and stopping there returns wrong
        # singular values (tests/test_torch_eig.py::
        # test_eig_220_svd_stagnation_on_a_rising_max_coupling)
        if sweep >= 4 and prev_off is not None and off_f >= prev_off:
            break
        prev_off = off_f
    s2 = torch.sum(_abs2(w), dim=0)
    order = torch.argsort(-s2, stable=True)
    kmin = min(m, n)
    s = torch.sqrt(s2[order])[:kmin]
    if not compute_uv:
        return s
    wk = w[:, order[:kmin]]
    u = torch.where(s[None, :] > 0, wk / torch.clamp(s[None, :], min=tiny),
                    0.0)
    return u, s, _ct(v[:, order[:kmin]])


def eigh(a, *, num_moduli: Optional[int] = None, fastmode="robust",
         backend: str = tables.Backend.INT8, block: Optional[int] = None,
         max_sweeps: int = 24, tol: Optional[float] = None, mesh=None,
         device="cuda"):
    """Hermitian eigendecomposition by two-sided block Jacobi.

    Returns (w, v) like torch.linalg.eigh: eigenvalues ascending (real),
    a @ v == v @ diag(w). The input is made Hermitian first ((a + a^H)/2).
    Rotations come from batched native eigh of the 2b x 2b pair subblocks;
    the O(n^3) row and column rotations run through the batched emulated
    GEMM.
    """
    device = _device(device)
    a = _as_tensor(a, device)
    _check_2d(a, "A")
    if a.shape[0] != a.shape[1]:
        raise ValueError(f"eigh needs a square matrix, got {tuple(a.shape)}")
    n = a.shape[0]
    nu = num_moduli if num_moduli is not None else _default_nu(a.dtype)
    b = _pick_block(n, block)
    rounds = _round_robin(n // b)
    batched = _pair_split(mesh, len(rounds[0])) or gemm_batched
    stop = _tolerances(a, tol)
    tiny = torch.finfo(a.dtype).tiny
    kw = dict(num_moduli=nu, fastmode=fastmode, backend=backend,
              device=device)

    def hermitian(x):                    # (x + x^H) * 0.5, a new tensor
        return (x + _ct(x)) * 0.5

    a = hermitian(a)
    fro = torch.sqrt(torch.sum(_abs2(a)))
    v = torch.eye(n, dtype=a.dtype, device=device)
    prev_off = None
    for sweep in range(max_sweeps):
        off2 = torch.zeros((), dtype=fro.dtype, device=device)
        for pairs in rounds:
            if not pairs:           # nb == 1 (n == 1): nothing to rotate
                continue
            cols = _pair_cols(pairs, b, device)
            p, w2 = cols.shape
            idx = cols.reshape(-1)
            rows = a.index_select(0, idx).reshape(p, w2, n)
            s = torch.gather(rows, 2, cols[:, None, :].expand(p, w2, w2))
            off2 = off2 + 2.0 * torch.sum(_abs2(s[:, :b, b:]))
            j = _rotations(s)                               # ascending
            _scatter_cols(a, cols, batched(_gather_cols(a, cols), j,
                                                **kw))
            rows = a.index_select(0, idx).reshape(p, w2, n)
            a[idx, :] = batched(_ct(j), rows, **kw).reshape(-1, n)
            _scatter_cols(v, cols, batched(_gather_cols(v, cols), j,
                                                **kw))
        a = hermitian(a)
        off_h = float(torch.sqrt(off2) / torch.clamp(fro, min=tiny))
        if off_h <= stop:
            break
        if sweep >= 4 and prev_off is not None and off_h >= prev_off:
            break                     # stagnated at the emulation floor
        prev_off = off_h
    wdiag = torch.diagonal(a).real        # Hermitian: eigenvalues are real
    order = torch.argsort(wdiag, stable=True)
    return wdiag[order], v[:, order]
