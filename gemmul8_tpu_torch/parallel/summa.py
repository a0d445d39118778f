"""Distributed 2-D SUMMA emulated GEMM over a torch.distributed device mesh.

The counterpart of gemmul8_tpu/parallel/summa.py:

  * quantize before communicating: the collectives move int8 residue planes
    (FP8: e4m3 split planes, sent as uint8), 8x fewer bytes than f64
    operands;
  * order-free shifts: the row and column maxima are all-reduced with MAX
    (exact) and the fast-mode norm is summed as exact integer pieces, so
    every mesh shape gives the same shifts, hence the same planes;
  * partial products are reduced in residue space, which is exact, and the
    CRT and descale run locally on each block of C.

So the result is bit-identical on every mesh shape (1x1, 1x2, 2x1, 2x2,
...), for the gather and the streaming algorithm, ring or psum broadcast.

Layout (mesh dims ("x", "y")):
  A: (m/X, k/Y) blocks; B: (k/X, n/Y) blocks; C: (m/X, n/Y) blocks.
A's planes are gathered along "y", B's along "x". An operand is either a
DTensor with placements (Shard(0), Shard(1)) on the mesh, or the same full
tensor on every rank, which each rank slices; C comes back as such a
DTensor, made without communication.

The collectives run on the mesh's process groups: NCCL moves device
tensors, gloo moves host tensors (a CUDA block is copied to the host and
back), chosen by the group's backend. The local work is the port's
single-device pipeline: the encode kernels, the int8 products
(core.residue_matmul: the wgmma kernel on the card) or torch._scaled_mm,
and the epilogue kernels (INT8 stream: the raw int32 panel products summed
while exact, then the epilogue kernel, whose wrap takes any int32; FP8
stream: each panel's products reassembled into the int32 accumulator by the
reassembly kernel). On the CPU every kernel runs its plain version. On the card, A's rows and B's columns are zero-padded to
multiples of 128 before the shifts, and the gathered k axis (or a panel's)
after the collectives, as the products need; zero rows, columns and planes
change nothing.

One difference from the JAX package: its FP8 planes are bf16 slots (6 bytes
an element a modulus), the port's e4m3 (3 bytes), so the port's FP8 plane
collectives move half of what summa_bytes_moved models for FP8; the model
keeps the JAX package's numbers.
"""
from __future__ import annotations

import collections
import os

import numpy as np
import torch
import torch.distributed as dist

from .. import complex_gemm as cg
from .. import core, fp8, kernels, quantize, tables
from ..quantize import _f32

# fixed-point scale of the order-free norm samples (floor(z^2 * 2^F) as
# int32, saturating as XLA's conversion does)
_NORM_FIX_BITS = 30
_INT32_MAX = 2 ** 31 - 1
MESH_DIMS = ("x", "y")
# the types the plane collectives carry (FP8 planes and accurate mode's bf16
# bound planes included); everything else a SUMMA call moves is O(m + n)
# shift scalars
PLANE_DTYPES = ("int8", "float8_e4m3fn", "bfloat16")

#: bytes this rank sent through SUMMA's collectives since reset_bytes(), by
#: the dtype they carried, under summa_bytes_moved's rule: an all-gather
#: sends (team - 1) x its block, an all-reduce 2 (team - 1) / team x its
#: tensor, a point-to-point send its tensor
BYTES_SENT: collections.Counter = collections.Counter()


def reset_bytes() -> None:
    BYTES_SENT.clear()


def plane_bytes(sent) -> float:
    """The plane bytes of a BYTES_SENT tally (the traffic summa_bytes_moved
    models)."""
    return sum(v for k, v in sent.items() if k in PLANE_DTYPES)


# ---------------------------------------------------------------------------
# the mesh and its collectives
# ---------------------------------------------------------------------------

def make_mesh(shape=None, device_type: str = "cuda"):
    """A 2-D DeviceMesh (mesh_dim_names ("x", "y")) over the default group's
    world, the largest near-square grid unless `shape` is given. With no
    group initialized it starts a world of one on a HashStore (gloo for
    host tensors, NCCL for CUDA ones where NCCL is built in), so that
    make_mesh() works in one process. On the card each rank takes
    cuda:{LOCAL_RANK % device_count} (0 without LOCAL_RANK)."""
    from torch.distributed.device_mesh import DeviceMesh
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: device_type='cuda' but CUDA is not "
                               "available; pass device_type='cpu'")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                              % torch.cuda.device_count())
    elif device_type != "cpu":
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    if not dist.is_initialized():
        backend = ("cpu:gloo,cuda:nccl" if torch.cuda.is_available()
                   and dist.is_nccl_available() else "gloo")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    n = dist.get_world_size()
    if shape is None:
        x = int(np.floor(np.sqrt(n)))
        while n % x:
            x -= 1
        shape = (x, n // x)
    return DeviceMesh(device_type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=MESH_DIMS)


def mesh_shape(mesh) -> tuple[int, int]:
    return tuple(mesh.mesh.shape)


def _wire(t: torch.Tensor) -> torch.Tensor:
    """t as a collective carries it: e4m3 as uint8, complex as real pairs."""
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8)
    return torch.view_as_real(t) if t.is_complex() else t


def _unwire(w: torch.Tensor, dtype) -> torch.Tensor:
    if dtype == torch.float8_e4m3fn:
        return w.view(dtype)
    return torch.view_as_complex(w) if dtype.is_complex else w


class Comm:
    """The collectives of SUMMA calls on one 2-D mesh, on each mesh dim's
    team (the ranks that share the other coordinate). On a group without
    NCCL a CUDA tensor goes through a host copy. Every byte sent is added to
    BYTES_SENT."""

    def __init__(self, mesh):
        if tuple(mesh.mesh_dim_names or ()) != MESH_DIMS:
            raise ValueError(f"mesh must be a 2-D DeviceMesh with "
                             f"mesh_dim_names {MESH_DIMS}, got "
                             f"{mesh.mesh_dim_names}")
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not in the mesh")
        self.mesh = mesh
        self.device = (torch.device("cpu") if mesh.device_type == "cpu"
                       else torch.device(mesh.device_type,
                                         torch.cuda.current_device()))
        grid = mesh.mesh
        self.pos = {"x": int(coord[0]), "y": int(coord[1])}
        self.size = {"x": grid.shape[0], "y": grid.shape[1]}
        self.ranks = {"x": grid[:, coord[1]].tolist(),
                      "y": grid[coord[0], :].tolist()}
        self.group = {d: mesh.get_group(d) for d in MESH_DIMS}
        self.host = {d: self.device.type == "cuda" and "cuda:nccl" not in
                     dist.get_backend_config(self.group[d])
                     for d in MESH_DIMS}

    def _send_form(self, t, dim):
        w = _wire(t.contiguous())
        return w.cpu() if self.host[dim] else w

    def _back(self, w, dtype, device):
        return _unwire(w, dtype).to(device)

    @staticmethod
    def _tally(dtype, nbytes):
        BYTES_SENT[str(dtype).removeprefix("torch.")] += nbytes

    def all_reduce(self, t, dim, op="sum"):
        """The elementwise sum (or "max") of t over the team, a new tensor."""
        team = self.size[dim]
        w = self._send_form(t, dim).clone()
        self._tally(t.dtype, 2 * (team - 1) * t.nbytes / team)
        dist.all_reduce(w, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=self.group[dim])
        return self._back(w, t.dtype, t.device)

    def all_gather(self, t, dim):
        """The team's blocks of t, in team order (on the host for a gloo
        group and a CUDA t; in the wire form)."""
        team = self.size[dim]
        w = self._send_form(t, dim)
        parts = [torch.empty_like(w) for _ in range(team)]
        self._tally(t.dtype, (team - 1) * t.nbytes)
        dist.all_gather(parts, w, group=self.group[dim])
        return parts

    def gather_k(self, x, dim, k_axis):
        """The team's blocks of the plane stack x concatenated along k (A's
        last axis, k_axis=-1; B's next to last, -2), in x's storage layout:
        a B stack stored k-contiguous is gathered as its (.., n, k) storage.
        On the card k is zero-filled up to a multiple of 128, as the
        products need."""
        if (k_axis == -2 and not x.is_contiguous()
                and x.transpose(-1, -2).is_contiguous()):
            return self.gather_k(x.transpose(-1, -2), dim,
                                 -1).transpose(-1, -2)
        parts = self.all_gather(x, dim)
        k_loc = x.shape[k_axis]
        k = k_loc * len(parts)
        k_out = k if x.device.type == "cpu" else -(-k // 128) * 128
        if k_out == k and len(parts) == 1 and parts[0].device == x.device:
            return _unwire(parts[0], x.dtype)
        shape = list(x.shape)
        shape[k_axis] = k_out
        out = (torch.zeros if k_out > k else torch.empty)(
            shape, dtype=x.dtype, device=x.device)
        for j, p in enumerate(parts):
            out.narrow(k_axis, j * k_loc, k_loc).copy_(_unwire(p, x.dtype))
        return out

    def gather_all(self, t, y_axis):
        """Every rank's block of t: the y team's concatenated along y_axis,
        then the x team's along axis 0 (y_axis=1: the full matrix from its
        (m/X, n/Y) blocks; y_axis=0: the blocks stacked in row-major rank
        order, rank (x, y) at x * Y + y)."""
        row = torch.cat([self._back(p, t.dtype, t.device)
                         for p in self.all_gather(t, "y")], dim=y_axis)
        return torch.cat([self._back(p, t.dtype, t.device)
                          for p in self.all_gather(row, "x")])

    def _p2p(self, op, w, dim, member):
        peer = self.ranks[dim][member]
        return dist.batch_isend_irecv(
            [dist.P2POp(op, w, peer, self.group[dim])])

    def bcast(self, planes, dim, owner, off, w, k_axis, method="ring"):
        """Start delivering the k-panel [off, off + w) of `owner`'s plane
        stack to every member of the team (the owner's own panel included).
        "ring": a bidirectional chain of point-to-point
        sends, the JAX package's schedule (each link carries the panel once);
        "psum": a sum over the team of the owner's panel and everyone else's
        zeros (about twice the bytes). Both deliver the owner's integers.
        Returns a function that waits for the panel and returns it."""
        if (k_axis == -2 and not planes.is_contiguous()
                and planes.transpose(-1, -2).is_contiguous()):
            wait = self.bcast(planes.transpose(-1, -2), dim, owner, off, w,
                              -1, method)
            return lambda: wait().transpose(-1, -2)
        team, me = self.size[dim], self.pos[dim]
        dtype, device = planes.dtype, planes.device
        shape = list(planes.shape)
        shape[k_axis] = w
        window = (planes.narrow(k_axis, off, w).contiguous() if me == owner
                  else None)
        if team == 1:
            return lambda: window
        if method == "psum":
            buf = self._send_form(
                window if me == owner else
                torch.zeros(shape, dtype=dtype, device=device), dim)
            self._tally(dtype, 2 * (team - 1) * buf.nbytes / team)
            work = dist.all_reduce(buf, group=self.group[dim], async_op=True)

            def finish():
                work.wait()
                return self._back(buf, dtype, device)
            return finish
        n_fwd = team // 2
        n_bwd = team - 1 - n_fwd
        if me == owner:
            buf = self._send_form(window, dim)
            peers = ([(owner + 1) % team] if n_fwd else []) + (
                [(owner - 1) % team] if n_bwd else [])
            works = [wk for p in peers
                     for wk in self._p2p(dist.isend, buf, dim, p)]
            self._tally(dtype, len(peers) * buf.nbytes)

            def finish_owner():
                for wk in works:
                    wk.wait()
                return window
            return finish_owner
        d_fwd = (me - owner) % team
        step = 1 if 1 <= d_fwd <= n_fwd else -1
        depth = d_fwd if step == 1 else (owner - me) % team
        last = n_fwd if step == 1 else n_bwd
        buf = torch.empty(shape, dtype=dtype,
                          device="cpu" if self.host[dim] else device)
        buf = _wire(buf)
        works = self._p2p(dist.irecv, buf, dim, (me - step) % team)

        def finish_member():
            for wk in works:
                wk.wait()
            if depth < last:      # pass it on down the chain
                for wk in self._p2p(dist.isend, buf, dim, (me + step) % team):
                    wk.wait()
                self._tally(dtype, buf.nbytes)
            return self._back(buf, dtype, device)
        return finish_member


# ---------------------------------------------------------------------------
# order-free shifts
# ---------------------------------------------------------------------------

def _ilogb_pmax(ax, reduce_axis, comm, dim):
    amax = comm.all_reduce(torch.amax(ax, dim=reduce_axis), dim, "max")
    safe = torch.where(amax > 0, amax, torch.ones_like(amax))
    return quantize.ilogb(safe), amax


def _norm_samples(z):
    """floor(z^2 * 2^F) as int32, saturating at 2^31 - 1 as XLA's f32 ->
    int32 conversion does (z reaches 2, so z^2 * 2^F reaches 2^32)."""
    v = torch.floor((z * z) * _f32(2.0 ** _NORM_FIX_BITS, z))
    return torch.where(v >= 2.0 ** 31,
                       torch.full_like(v, _INT32_MAX, dtype=torch.int32),
                       v.to(torch.int32))


def _shift_fast_dist(x, num_moduli, backend, reduce_axis, comm, dim,
                     variant="reference"):
    """Distributed fast-mode shift: the same bits for any sharding of the
    reduced axis. The amax is all-reduced with MAX (exact); the norm is a sum
    of fixed-point int32 samples, split into three 13-bit pieces whose exact
    int64 sums are all-reduced, then brought to the canonical (total mod
    2^15, total >> 15) pair the JAX package recombines in f32 -- a function
    of the exact global sum only. variant="invariant" is the robust
    (scale-invariant) shift. f64 rows above 2^126 are prescaled by an exact
    power of two from the global amax, on every device (the JAX package's
    CPU branch)."""
    if x.dtype != torch.float32:
        amax_nat = comm.all_reduce(torch.amax(torch.abs(x), dim=reduce_axis),
                                   dim, "max")
        E0 = torch.where(amax_nat > 2.0 ** 126,
                         quantize.ilogb(torch.where(
                             amax_nat > 0, amax_nat,
                             torch.ones_like(amax_nat))),
                         torch.zeros_like(amax_nat, dtype=torch.int32))
        x = quantize.pow2_scale(x, -E0.unsqueeze(reduce_axis))
    else:
        E0 = torch.zeros(x.shape[1 - reduce_axis], dtype=torch.int32,
                         device=x.device)
    c0 = torch.abs(x.to(torch.float32))
    E, amax0 = _ilogb_pmax(c0 * _f32(1.0 + 2.0 ** -22, c0), reduce_axis,
                           comm, dim)
    E = E + E0          # the total exponent; z uses the local one
    z = quantize.pow2_scale(c0, -(E - E0).unsqueeze(reduce_axis))
    fx = _norm_samples(z)
    pieces = torch.stack([torch.sum((fx >> s) & 0x1FFF, dim=reduce_axis,
                                    dtype=torch.int64) for s in (0, 13, 26)])
    total = comm.all_reduce(pieces, dim, "sum")
    lo_c = (total & 0x7FFF).to(torch.float32)
    hi_c = (total >> 15).to(torch.float32)
    p = lo_c + hi_c * _f32(2.0 ** 15, lo_c)
    # +1 makes it a (tiny) upper bias and guards log2(0)
    s2 = ((p[0] + p[1] * _f32(2.0 ** 13, p)) + p[2] * _f32(2.0 ** 26, p)
          + _f32(1.0, p))
    log2vsum = ((torch.log2(s2) - _f32(_NORM_FIX_BITS, s2))
                + _f32(2.0, s2) * E.to(torch.float32)) + _f32(2.0 ** -18, s2)
    log2vnrm = _f32(quantize.LOG2_HALF_RU, s2) * log2vsum
    log2p = _f32(tables.log2P(num_moduli, backend), s2)
    if variant == "invariant":
        exp1 = ((log2p - _f32(1.5, s2)) - log2vnrm) - _f32(
            quantize.SFT_MARGIN, s2)
        sft = torch.floor(exp1).to(torch.int32)
    else:
        exp1 = (((log2p - _f32(1.5, s2))
                 - torch.maximum(_f32(1.0, s2), log2vnrm))
                - _f32(quantize.SFT_MARGIN, s2))
        sft = torch.floor(exp1).to(torch.int32) - E
    return torch.where(amax0 > 0, sft, torch.zeros_like(sft))


def _extract_ub_dist(x, backend, scale_axis, comm, dim):
    """quantize.extract_ub_plane with the amax all-reduced over the team
    (MAX, in x's dtype): the same bound plane for any sharding."""
    reduce_axis = 1 - scale_axis
    ax = torch.abs(x)
    amax = comm.all_reduce(torch.amax(ax, dim=reduce_axis), dim, "max")
    E = quantize.ilogb(torch.where(amax > 0, amax, torch.ones_like(amax)))
    sft_pre = quantize.MAX_UFP[backend] - E
    return quantize.extract_ub_with_pre(ax, sft_pre, reduce_axis,
                                        backend), sft_pre


def _shift_accu_dist(a_blk, b_blk, num_moduli, backend, comm):
    """Distributed accurate-mode shifts: the bound planes gathered along k
    (one int8 or bf16 plane per operand), the estimation product local, its
    row and column maxima all-reduced with MAX."""
    ub_a, pre_a = _extract_ub_dist(a_blk, backend, 0, comm, "y")
    ub_b, pre_b = _extract_ub_dist(b_blk, backend, 1, comm, "x")
    ag = comm.gather_k(ub_a, "y", -1)
    bg = comm.gather_k(ub_b, "x", -2)
    c_hi = quantize.estimate_gemm(ag, bg, backend)
    row_max = comm.all_reduce(torch.amax(c_hi, dim=1), "y", "max")
    col_max = comm.all_reduce(torch.amax(c_hi, dim=0), "x", "max")
    return (quantize.shift_accu_from_chi(row_max, pre_a, num_moduli, backend),
            quantize.shift_accu_from_chi(col_max, pre_b, num_moduli, backend))


def _dist_shifts(a_blk, b_blk, num_moduli, fastmode, backend, comm):
    """(sft_a, sft_b) of A's rows and B's columns, the same on every mesh."""
    if fastmode:
        var = "invariant" if fastmode == "robust" else "reference"
        return (_shift_fast_dist(a_blk, num_moduli, backend, 1, comm, "y",
                                 variant=var),
                _shift_fast_dist(b_blk, num_moduli, backend, 0, comm, "x",
                                 variant=var))
    return _shift_accu_dist(a_blk, b_blk, num_moduli, backend, comm)


def _extract_ub_lanes_dist(re, im, scale_axis, backend, comm, dim):
    """complex_gemm._extract_ub_lanes with the amax of max(|Re|, |Im|)
    all-reduced over the team: one pre-shift per row or column."""
    reduce_axis = 1 - scale_axis
    ar_, ai_ = torch.abs(re), torch.abs(im)
    amax = comm.all_reduce(torch.amax(torch.maximum(ar_, ai_),
                                      dim=reduce_axis), dim, "max")
    E = quantize.ilogb(torch.where(amax > 0, amax, torch.ones_like(amax)))
    pre = quantize.MAX_UFP[backend] - E
    ub_r = quantize.extract_ub_with_pre(ar_, pre, reduce_axis, backend)
    ub_i = quantize.extract_ub_with_pre(ai_, pre, reduce_axis, backend)
    return ub_r, ub_i, ub_r - ub_i, pre


def _shift_accu_dist_cplx(ar, ai, br, bi, num_moduli, backend, comm):
    """Distributed accurate-mode complex shifts: the three 3M estimation
    lanes gathered along k, their products local, the bound's maxima
    all-reduced with MAX."""
    ua_r, ua_i, ua_ri, pre_a = _extract_ub_lanes_dist(ar, ai, 0, backend,
                                                      comm, "y")
    ub_r, ub_i, ub_ri, pre_b = _extract_ub_lanes_dist(br, bi, 1, backend,
                                                      comm, "x")
    lg = comm.gather_k(torch.stack([ua_ri, ua_r, ua_i]), "y", -1)
    bg = comm.gather_k(torch.stack([ub_ri, ub_i, ub_r]), "x", -2)
    d = [quantize.estimate_gemm(lg[i], bg[i], backend) for i in range(3)]
    bound = cg._combine_3m_bound(d)
    row_max = comm.all_reduce(torch.amax(bound, dim=1), "y", "max")
    col_max = comm.all_reduce(torch.amax(bound, dim=0), "x", "max")
    return (quantize.shift_accu_from_chi(row_max, pre_a, num_moduli, backend),
            quantize.shift_accu_from_chi(col_max, pre_b, num_moduli, backend))


def _dist_shifts_cplx(ar, ai, br, bi, num_moduli, fastmode, backend, comm):
    """Shared complex shifts: fast mode on (Re, Im) concatenated along the
    reduced axis (amax of max(|Re|, |Im|), norm^2 of Re^2 + Im^2)."""
    if fastmode:
        var = "invariant" if fastmode == "robust" else "reference"
        return (_shift_fast_dist(torch.cat([ar, ai], dim=1), num_moduli,
                                 backend, 1, comm, "y", variant=var),
                _shift_fast_dist(torch.cat([br, bi], dim=0), num_moduli,
                                 backend, 0, comm, "x", variant=var))
    return _shift_accu_dist_cplx(ar, ai, br, bi, num_moduli, backend, comm)


# ---------------------------------------------------------------------------
# local bodies
# ---------------------------------------------------------------------------

def _pad_blocks(a_blk, b_blk):
    """On the card, A's rows and B's columns zero-padded to multiples of 128
    (zero rows and columns get zero shifts and zero planes); contiguous."""
    if a_blk.device.type != "cpu":
        a_blk, b_blk = core._pad128(a_blk, (0,)), core._pad128(b_blk, (1,))
    return a_blk.contiguous(), b_blk.contiguous()


def _summa_local(a_blk, b_blk, comm, num_moduli, fastmode, backend,
                 epilogue):
    """Gather path: local shifts and planes, the planes gathered along k,
    then the single-device product and epilogue (core._emulated_product)."""
    m_loc, n_loc = a_blk.shape[0], b_blk.shape[1]
    out_dtype = a_blk.dtype
    a_blk, b_blk = _pad_blocks(a_blk, b_blk)
    sft_a, sft_b = _dist_shifts(a_blk, b_blk, num_moduli, fastmode, backend,
                                comm)
    pa = core.encode_side(a_blk, sft_a, 0, num_moduli, backend)
    pb = core.encode_side(b_blk, sft_b, 1, num_moduli, backend)
    ag = comm.gather_k(pa, "y", -1)
    bg = comm.gather_k(pb, "x", -2)
    del pa, pb
    out = core._emulated_product(ag, sft_a, bg, sft_b, num_moduli, backend,
                                 out_dtype, epilogue)
    return out[:m_loc, :n_loc]


def _check_stream(steps, num_moduli, backend):
    """The JAX package's int32 refusal for the streamed residue sum."""
    p_max = int(max(tables.moduli(backend)[:num_moduli]))
    # INT8 sums [0, p) residues per step, FP8 wrapped ones, |.| <= p/2
    acc_bound = steps * p_max if backend == tables.Backend.INT8 \
        else steps * p_max // 2
    if acc_bound >= 2 ** 31:
        raise ValueError(
            f"streamed residue accumulator would overflow int32: {steps} "
            f"steps x p_max={p_max}; raise k_panel or use the gather path")


def _pad_k(x, k_axis):
    """On the card, a panel's k axis zero-padded to a multiple of 128, in
    the panel's storage layout (a B panel stays k-contiguous, as
    torch._scaled_mm needs it)."""
    k = x.shape[k_axis]
    k_out = -(-k // 128) * 128
    if x.device.type == "cpu" or k_out == k:
        return x
    if (k_axis == -2 and not x.is_contiguous()
            and x.transpose(-1, -2).is_contiguous()):
        return _pad_k(x.transpose(-1, -2), -1).transpose(-1, -2)
    shape = list(x.shape)
    shape[k_axis] = k_out
    out = torch.zeros(shape, dtype=x.dtype, device=x.device)
    out.narrow(k_axis, 0, k).copy_(x)
    return out


class _StreamAcc:
    """The residue accumulator of the streamed products, (planes, m, n)
    int32 for the moduli `mods` (one per plane).

    INT8: each panel's exact int32 products are summed raw while the running
    k stays within core.K_CHUNK (exact, as core._chunked_residue_acc's
    chunks); past it the running sum is folded into [0, p) residues first.
    The result is congruent to the JAX package's per-step residue sum, and
    the epilogue kernel wraps any int32. FP8: each panel's 3nu products are
    reassembled into wrapped residues by the reassembly kernel, added into
    the accumulator."""

    def __init__(self, mods, backend):
        self.mods, self.backend = list(mods), backend
        self.acc = self.raw = self.scratch = None
        self.raw_k = 0

    def add(self, ap, bp):
        if self.backend == tables.Backend.FP8:
            c3 = fp8.residue_matmul_fp8(ap, bp)
            if self.acc is None:
                self.acc = kernels.reassemble_fp8(c3, len(self.mods))
            else:
                kernels.reassemble_fp8(c3, len(self.mods), out=self.acc,
                                       accumulate=True)
            return
        w = ap.shape[-1]
        if self.raw is None or self.raw_k + w > core.K_CHUNK:
            if self.raw is not None:
                self._fold()
            self.raw = core.residue_matmul(ap, bp, out=self.raw)
            self.raw_k = w
            return
        self.scratch = core.residue_matmul(ap, bp, out=self.scratch)
        self.raw += self.scratch
        self.raw_k += w

    def _fold(self):
        part = torch.stack([torch.remainder(self.raw[i], p)
                            for i, p in enumerate(self.mods)])
        self.acc = part if self.acc is None else self.acc.add_(part)

    def result(self) -> torch.Tensor:
        if self.backend == tables.Backend.FP8 or self.acc is None:
            return self.raw if self.acc is None else self.acc
        self._fold()
        return self.acc


def _stream(pa, pb, comm, k_panel, k, bcast, acc):
    """The panel loop: step t's panels are A's planes at k in [t w, (t+1) w)
    from their owner along "y" and B's from theirs along "x"; the next
    step's broadcasts start before this step's products, and no broadcast
    follows the last step."""
    w = k_panel
    k_y, k_x = k // comm.size["y"], k // comm.size["x"]

    def start(t):
        return (comm.bcast(pa, "y", (t * w) // k_y, t * w % k_y, w, -1,
                           bcast),
                comm.bcast(pb, "x", (t * w) // k_x, t * w % k_x, w, -2,
                           bcast))

    steps = k // w
    nxt = start(0)
    for t in range(steps):
        ap, bp = (wait() for wait in nxt)
        if t + 1 < steps:
            nxt = start(t + 1)
        acc.add(_pad_k(ap, -1), _pad_k(bp, -2))
    return acc.result()


def _real_epilogue(acc, sft_a, sft_b, num_moduli, backend, out_dtype,
                   epilogue):
    if core.resolve_epilogue(epilogue, acc.device) == "ff":
        return kernels.fused_epilogue(acc, sft_a, sft_b, num_moduli, backend,
                                      out_dtype)
    return core.reconstruct_scale(core.mod_reduce(acc, num_moduli, backend),
                                  sft_a, sft_b, num_moduli, backend,
                                  out_dtype, epilogue)


def _summa_stream_local(a_blk, b_blk, comm, num_moduli, fastmode, backend,
                        epilogue, k_panel, k, bcast):
    """K-panel streaming path: no full-K gather; per step one k-panel of
    each side's planes is broadcast over its team and its products are
    accumulated in residue space, so per-rank panel memory is
    O(nu m_loc k_panel)."""
    m_loc, n_loc = a_blk.shape[0], b_blk.shape[1]
    out_dtype = a_blk.dtype
    _check_stream(k // k_panel, num_moduli, backend)
    a_blk, b_blk = _pad_blocks(a_blk, b_blk)
    sft_a, sft_b = _dist_shifts(a_blk, b_blk, num_moduli, fastmode, backend,
                                comm)
    pa = core.encode_side(a_blk, sft_a, 0, num_moduli, backend)
    pb = core.encode_side(b_blk, sft_b, 1, num_moduli, backend)
    acc = _stream(pa, pb, comm, k_panel, k, bcast,
                  _StreamAcc(tables.moduli(backend)[:num_moduli], backend))
    out = _real_epilogue(acc, sft_a, sft_b, num_moduli, backend, out_dtype,
                         epilogue)
    return out[:m_loc, :n_loc]


def _lanes_epilogue(acc3, sft_a, sft_b, num_moduli, backend, real_dt,
                    epilogue):
    """(re, im) from the (3nu, m, n) int32 lane residue sums."""
    if core.resolve_epilogue(epilogue, acc3.device) == "ff":
        return cg.lanes_epilogue_ff(acc3, sft_a, sft_b, num_moduli, backend,
                                    real_dt)
    mid_r, mid_i = cg._recombine_3m(kernels._lane_mids(acc3, num_moduli,
                                                       backend),
                                    num_moduli, backend)
    return tuple(core.reconstruct_scale(x, sft_a, sft_b, num_moduli, backend,
                                        real_dt, epilogue)
                 for x in (mid_r, mid_i))


def _cplx_operands(ar, ai, br, bi, comm, num_moduli, fastmode, backend):
    """Padded blocks' shared shifts and the three lane plane sets of each
    side."""
    ar, br = _pad_blocks(ar, br)
    ai, bi = _pad_blocks(ai, bi)
    sft_a, sft_b = _dist_shifts_cplx(ar, ai, br, bi, num_moduli, fastmode,
                                     backend, comm)
    pa = cg._quantize_complex(ar, ai, sft_a, 0, num_moduli, backend,
                              conj=False)
    pb = cg._quantize_complex(br, bi, sft_b, 1, num_moduli, backend,
                              conj=False)
    return sft_a, sft_b, pa, pb


def _summa_local_cplx(ar, ai, br, bi, comm, num_moduli, fastmode, backend,
                      epilogue):
    """Planar-complex gather path: shared shifts, the lane plane sets
    gathered along k like real planes, then the single-device lane products,
    3M recombine and dual CRT (complex_gemm._complex_product)."""
    m_loc, n_loc = ar.shape[0], br.shape[1]
    sft_a, sft_b, pa, pb = _cplx_operands(ar, ai, br, bi, comm, num_moduli,
                                          fastmode, backend)
    ag = comm.gather_k(pa, "y", -1)
    bg = comm.gather_k(pb, "x", -2)
    del pa, pb
    cr, ci = cg._complex_product(ag, bg, sft_a, sft_b, num_moduli, backend,
                                 ar.dtype, epilogue)
    return cr[:m_loc, :n_loc], ci[:m_loc, :n_loc]


def _summa_stream_local_cplx(ar, ai, br, bi, comm, num_moduli, fastmode,
                             backend, epilogue, k_panel, k, bcast):
    """Planar-complex streaming path (INT8): the 3nu lane planes stream as
    one stack (lane i of A meets lane i of B), the residue sums go to the
    complex epilogue once."""
    m_loc, n_loc = ar.shape[0], br.shape[1]
    planes = 3 * num_moduli
    _check_stream(k // k_panel, num_moduli, backend)
    sft_a, sft_b, pa, pb = _cplx_operands(ar, ai, br, bi, comm, num_moduli,
                                          fastmode, backend)
    pa = pa.reshape(planes, *pa.shape[2:])
    pb = pb.reshape(planes, *pb.shape[2:])
    acc3 = _stream(pa, pb, comm, k_panel, k, bcast,
                   _StreamAcc(tables.moduli(backend)[:num_moduli] * 3,
                             backend))
    cr, ci = _lanes_epilogue(acc3, sft_a, sft_b, num_moduli, backend,
                             ar.dtype, epilogue)
    return cr[:m_loc, :n_loc], ci[:m_loc, :n_loc]


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _placements():
    from torch.distributed.tensor import Shard
    return [Shard(0), Shard(1)]


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _global_shape(x):
    return tuple(x.shape) if isinstance(x, torch.Tensor) else np.shape(x)


def _dtype_of(x):
    if isinstance(x, torch.Tensor):
        return x.dtype
    return torch.as_tensor(np.asarray(x)[:0]).dtype


def _block(x, comm, name):
    """This rank's (rows/X, cols/Y) block of x on the mesh's device: a
    DTensor's local block, or the slice of a full tensor."""
    if _is_dtensor(x):
        if x.device_mesh != comm.mesh or list(x.placements) != _placements():
            raise ValueError(f"{name} must be a DTensor on the mesh with "
                             f"placements (Shard(0), Shard(1)), or a full "
                             f"tensor")
        return x.to_local().to(comm.device)
    x = core._as_tensor(x, comm.device)
    if x.dim() != 2:
        raise ValueError(f"{name} must be 2-D, got ndim={x.dim()}")
    rows, cols = x.shape[0] // comm.size["x"], x.shape[1] // comm.size["y"]
    xi, yi = comm.pos["x"], comm.pos["y"]
    return x[xi * rows:(xi + 1) * rows, yi * cols:(yi + 1) * cols]


def _check_layout(a_shape, b_shape, mesh_dims):
    """A (m, k) and B (k, n) with m, k divisible by mesh.x and k, n by
    mesh.y (every block the same shape)."""
    X, Y = mesh_dims
    if len(a_shape) != 2 or len(b_shape) != 2:
        raise ValueError(f"summa_gemm expects 2-D operands, got A "
                         f"{a_shape}, B {b_shape}")
    (m, k), (k2, n) = a_shape, b_shape
    if k != k2:
        raise ValueError(f"inner dimensions differ: A {a_shape}, B {b_shape}")
    if m % X or k % X or k % Y or n % Y:
        raise ValueError(
            f"mesh {X}x{Y} needs m and k divisible by mesh.x and k and n by "
            f"mesh.y; got m={m}, k={k}, n={n}")
    return k


def _check_k_panel(k_panel, k, mesh_dims):
    X, Y = mesh_dims
    if k % k_panel or (k // X) % k_panel or (k // Y) % k_panel:
        raise ValueError(
            f"k_panel={k_panel} must divide k/mesh.x={k // X} "
            f"and k/mesh.y={k // Y}")


def summa_gemm(a, b, *, mesh=None, num_moduli: int = 8,
               fastmode: bool | str = True,
               backend: str = tables.Backend.INT8, epilogue: str = "auto",
               k_panel: int | None = None, bcast: str = "ring"):
    """Distributed emulated GEMM: C = A @ B over a 2-D mesh (make_mesh()).

    a (m, k), b (k, n): DTensors sharded (Shard(0), Shard(1)) on the mesh,
    or the same full tensors on every rank; m, k divisible by mesh.x and
    k, n by mesh.y. Returns C (m, n) as a DTensor sharded (Shard(0),
    Shard(1)). Bit-identical for every mesh shape (1x1 included).

    fastmode=False runs the distributed accurate-mode estimation;
    fastmode="robust" the scale-invariant fast shifts. k_panel selects the
    K-panel streaming algorithm (per-rank panel memory O(nu m_loc k_panel));
    it must divide k/mesh.x and k/mesh.y and be <= 2^17 (INT8) or 2^16
    (FP8). bcast picks the streaming broadcast: "ring" (each link carries
    each panel once) or "psum" (a masked all-reduce, about twice the
    bytes). Bit-identical either way. Complex operands take
    summa_gemm_planar.
    """
    from torch.distributed.tensor import DTensor
    if bcast not in ("ring", "psum"):
        raise ValueError(f"bcast must be 'ring' or 'psum', got {bcast!r}")
    if mesh is None:
        mesh = make_mesh()
    dt = _dtype_of(a)
    if dt.is_complex:
        cr, ci = summa_gemm_planar(
            *_planar(a, mesh), *_planar(b, mesh), mesh=mesh,
            num_moduli=num_moduli, fastmode=fastmode, backend=backend,
            epilogue=epilogue, k_panel=k_panel, bcast=bcast)
        return DTensor.from_local(
            torch.complex(cr.to_local(), ci.to_local()).to(dt), mesh,
            _placements())
    if dt not in core._DTYPE_NAMES:
        raise TypeError(f"summa_gemm supports float32 and float64, got {dt}")
    lo, hi = tables.VALID_RANGE[core._DTYPE_NAMES[dt]]
    if not lo <= num_moduli <= hi:
        raise ValueError(f"num_moduli={num_moduli} out of [{lo},{hi}]")
    if backend not in (tables.Backend.INT8, tables.Backend.FP8):
        raise ValueError(f"backend must be 'INT8' or 'FP8', got {backend!r}")
    if fastmode and _global_shape(a)[1] > (1 << 33):
        raise ValueError(
            "fast-mode distributed shifts support k <= 2^33 (two-tier exact "
            "int32 norm pieces); use fastmode=False for larger k")
    comm = Comm(mesh)
    k = _check_layout(_global_shape(a), _global_shape(b), mesh_shape(mesh))
    if k_panel is not None:
        _check_k_panel(k_panel, k, mesh_shape(mesh))
        k_lim = 17 if backend == tables.Backend.INT8 else 16
        if k_panel > (1 << k_lim):
            raise ValueError(
                f"k_panel must be <= 2^{k_lim} for {backend} "
                "(exact accumulation of panel products)")
    a_blk, b_blk = _block(a, comm, "A"), _block(b, comm, "B")
    if a_blk.dtype != b_blk.dtype:
        raise TypeError(f"dtype mismatch: {a_blk.dtype} vs {b_blk.dtype}")
    if k_panel is None:
        c = _summa_local(a_blk, b_blk, comm, num_moduli, fastmode, backend,
                         epilogue)
    else:
        c = _summa_stream_local(a_blk, b_blk, comm, num_moduli, fastmode,
                                backend, epilogue, k_panel, k, bcast)
    return DTensor.from_local(c, mesh, _placements())


def _planar(x, mesh):
    """(re, im) of a complex operand, DTensors stay DTensors."""
    from torch.distributed.tensor import DTensor
    if _is_dtensor(x):
        loc = x.to_local()
        return tuple(DTensor.from_local(p.contiguous(), mesh, _placements())
                     for p in (loc.real, loc.imag))
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return x.real, x.imag


def summa_gemm_planar(ar, ai, br, bi, *, mesh=None, num_moduli: int = 8,
                      fastmode: bool | str = True,
                      backend: str = tables.Backend.INT8,
                      epilogue: str = "auto", k_panel: int | None = None,
                      bcast: str = "ring"):
    """Distributed emulated complex GEMM on planar operands: (Ar, Ai) x
    (Br, Bi) -> (Cr, Ci), each a DTensor sharded (Shard(0), Shard(1)).

    The three lane plane sets (Re, Im, (Re+Im) mod p) shard like real planes
    (three times the collective bytes); the 3M recombine and dual CRT run
    locally. Shifts are shared per row and column and order-free, so the
    result is bit-identical for every mesh shape and between the gather and
    streaming algorithms. k_panel streaming supports the INT8 backend; FP8
    lanes take the gather path.
    """
    from torch.distributed.tensor import DTensor
    if bcast not in ("ring", "psum"):
        raise ValueError(f"bcast must be 'ring' or 'psum', got {bcast!r}")
    if mesh is None:
        mesh = make_mesh()
    dts = [_dtype_of(x) for x in (ar, ai, br, bi)]
    if len(set(dts)) != 1:
        raise TypeError(
            "planar components must share one real dtype, got "
            + "/".join(str(d).removeprefix("torch.") for d in dts))
    shapes = [_global_shape(x) for x in (ar, ai, br, bi)]
    if shapes[0] != shapes[1] or shapes[2] != shapes[3]:
        raise ValueError(
            f"planar component shapes differ: A {shapes[0]} vs {shapes[1]}, "
            f"B {shapes[2]} vs {shapes[3]}")
    if dts[0] not in core._DTYPE_NAMES:
        raise TypeError(f"planar components must be f32/f64 real planes, "
                        f"got {str(dts[0]).removeprefix('torch.')}")
    name = cg._COMPLEX_NAME[dts[0]]
    lo, hi = tables.VALID_RANGE[name]
    if not lo <= num_moduli <= hi:
        raise ValueError(
            f"num_moduli={num_moduli} out of [{lo},{hi}] for {name}")
    if backend not in (tables.Backend.INT8, tables.Backend.FP8):
        raise ValueError(f"backend must be 'INT8' or 'FP8', got {backend!r}")
    if fastmode and shapes[0][1] > (1 << 32):
        raise ValueError(
            "fast-mode distributed complex shifts support k <= 2^32 (the "
            "Re/Im lane concat doubles the two-tier norm sample count); use "
            "fastmode=False for larger k")
    comm = Comm(mesh)
    k = _check_layout(shapes[0], shapes[2], mesh_shape(mesh))
    if k_panel is not None:
        if backend != tables.Backend.INT8:
            raise ValueError(
                "k_panel streaming supports the INT8 backend only for "
                "complex operands; use the gather path (k_panel=None) "
                "for FP8")
        _check_k_panel(k_panel, k, mesh_shape(mesh))
        if k_panel > (1 << 17):
            raise ValueError("k_panel must be <= 2^17 for INT8 "
                             "(exact accumulation of panel products)")
    blocks = [_block(x, comm, n) for x, n in
              zip((ar, ai, br, bi), ("Ar", "Ai", "Br", "Bi"))]
    if k_panel is None:
        cr, ci = _summa_local_cplx(*blocks, comm, num_moduli, fastmode,
                                   backend, epilogue)
    else:
        cr, ci = _summa_stream_local_cplx(*blocks, comm, num_moduli,
                                          fastmode, backend, epilogue,
                                          k_panel, k, bcast)
    return (DTensor.from_local(cr, mesh, _placements()),
            DTensor.from_local(ci, mesh, _placements()))


# ---------------------------------------------------------------------------
# memory and traffic models
# ---------------------------------------------------------------------------

def summa_work_bytes(m: int, n: int, k: int, mesh_shape: tuple[int, int],
                     num_moduli: int, dtype=torch.float64,
                     k_panel: int | None = None,
                     backend: str = tables.Backend.INT8) -> int:
    """Per-rank peak memory model (bytes) of summa_gemm, the JAX package's
    numbers: inputs + residue planes + (gathered K panels | 2 streamed
    panels) + residue accumulator + epilogue buffers + output. FP8 planes
    are modelled as 3 bf16 slots an element (6 B) with an int16 C_mid;
    complex dtypes triple the plane, panel and accumulator terms and double
    the epilogue's."""
    X, Y = mesh_shape
    lanes = 3 if dtype.is_complex else 1
    it = dtype.itemsize
    plane_b = 6 if backend == tables.Backend.FP8 else 1
    mid_b = 2 if backend == tables.Backend.FP8 else 1
    m_l, n_l, k_y, k_x = m // X, n // Y, k // Y, k // X
    nu = num_moduli
    inputs = (m_l * k_y + k_x * n_l) * it
    planes = lanes * nu * plane_b * (m_l * k_y + k_x * n_l)
    if k_panel is None:
        panels = lanes * nu * plane_b * (m_l * k + k * n_l)  # full-K gathers
        k_lim = core.K_CHUNK if backend == tables.Backend.INT8 else (1 << 16)
        acc = 4 * lanes * nu * m_l * n_l if k > k_lim else 0
    else:
        panels = 2 * lanes * nu * plane_b * k_panel * (m_l + n_l)  # dbl-buf
        acc = 4 * lanes * nu * m_l * n_l               # int32 residue acc
    c_mid = lanes * nu * mid_b * m_l * n_l
    epilogue = (2 if lanes == 3 else 1) * 2 * 4 * m_l * n_l  # hi/lo f32 pair
    out = m_l * n_l * it
    return inputs + planes + panels + acc + c_mid + epilogue + out


def summa_bytes_moved(m: int, n: int, k: int, mesh_shape: tuple[int, int],
                      num_moduli: int, k_panel: int | None = None,
                      bcast: str = "ring",
                      backend: str = tables.Backend.INT8,
                      fastmode: bool | str = True,
                      complex_lanes: bool = False) -> int:
    """Plane bytes each rank sends in one summa_gemm, the JAX package's
    model: the gather path's ring all-gathers move (team-1)/team of the
    gathered planes; streaming "ring" moves (team-1)/team of each panel a
    step, "psum" twice that. The fast-mode shift collectives (O(m+n)
    scalars) are excluded; accurate mode adds one gathered bound plane per
    operand (int8, FP8 bf16). complex_lanes=True triples the plane and
    estimation terms. (The port's FP8 planes are e4m3, half the modelled
    6 bytes; see the module docstring.)"""
    X, Y = mesh_shape
    nu = num_moduli
    lanes = 3 if complex_lanes else 1
    plane_b = 6 if backend == tables.Backend.FP8 else 1
    m_l, n_l = m // X, n // Y
    accu = 0
    if fastmode is False:
        ub_b = 2 if backend == tables.Backend.FP8 else 1   # bf16 | int8
        accu = int(lanes * ((Y - 1) / Y * m_l * k * ub_b
                            + (X - 1) / X * k * n_l * ub_b))
    if k_panel is None:
        ag_a = (Y - 1) / Y * lanes * nu * m_l * k * plane_b
        ag_b = (X - 1) / X * lanes * nu * k * n_l * plane_b
        return int(ag_a + ag_b) + accu
    steps = k // k_panel
    pan_a = lanes * nu * m_l * k_panel * plane_b
    pan_b = lanes * nu * k_panel * n_l * plane_b
    fac = 2.0 if bcast == "psum" else 1.0
    return int(steps * fac
               * ((Y - 1) / Y * pan_a + (X - 1) / X * pan_b)) + accu
