"""SUMMA on a mesh of ranks on the card: the cases chip_smoke.py's phase 4
runs on a 2x2 mesh of four processes sharing one card over gloo, and on the
1x1 NCCL mesh they are held against -- DGEMM 4096^3 nu=16 (gather, stream
ring and psum, robust, accurate), FP8 DGEMM nu=14 gather, planar ZGEMM
2048^3 nu=16 (gather, stream), getrf and qr at 2048 with block 512 and eigh
at 512 with its pairs split over the ranks.

Each rank reports, per case, a digest of its block of C (of the whole
result for the solvers), the bytes it sent by dtype (summa.BYTES_SENT) and
the case's time; rank 0 also holds K1 and K2 against their plain versions
at its own block shapes. The operands are made from a seed in every rank.
"""
from __future__ import annotations

import hashlib
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import kernels
from ..parallel import summa

SEED = 20261024
N_GEMM, N_CPLX, N_SOLVER, SOLVER_BLOCK, N_EIGH = 4096, 2048, 2048, 512, 512
EIGH_BLOCK = 32          # 16 blocks: 8 pairs a round, any mesh of <= 8 ranks
PANEL = 1024
NU, NU_FP8, NU_SOLVER = 16, 14, 14


def inputs(device):
    """The operands, the same bits in every rank."""
    rng = np.random.default_rng(SEED)

    def phi(m, n, p=0.5):
        return torch.from_numpy((rng.random((m, n)) - 0.5) * np.exp(
            rng.standard_normal((m, n)) * p)).to(device)
    x = dict(a=phi(N_GEMM, N_GEMM), b=phi(N_GEMM, N_GEMM),
             ar=phi(N_CPLX, N_CPLX), ai=phi(N_CPLX, N_CPLX),
             br=phi(N_CPLX, N_CPLX), bi=phi(N_CPLX, N_CPLX))
    g = torch.from_numpy(rng.standard_normal((N_SOLVER, N_SOLVER))).to(device)
    x["sa"] = g + N_SOLVER * torch.eye(N_SOLVER, dtype=g.dtype,
                                       device=device)
    s = g[:N_EIGH, :N_EIGH]
    x["sym"] = (s + s.T) / 2
    return x


# name -> (operands, keyword arguments); the solvers apart
STREAM = dict(k_panel=PANEL)
GEMM_CASES = {
    "dgemm gather": (("a", "b"), dict(num_moduli=NU)),
    "dgemm stream ring": (("a", "b"), dict(num_moduli=NU, **STREAM)),
    "dgemm stream psum": (("a", "b"), dict(num_moduli=NU, bcast="psum",
                                           **STREAM)),
    "dgemm robust": (("a", "b"), dict(num_moduli=NU, fastmode="robust")),
    "dgemm accurate": (("a", "b"), dict(num_moduli=NU, fastmode=False)),
    "fp8 dgemm gather": (("a", "b"), dict(num_moduli=NU_FP8, backend="FP8")),
    "zgemm planar gather": (("ar", "ai", "br", "bi"), dict(num_moduli=NU)),
    "zgemm planar stream": (("ar", "ai", "br", "bi"),
                            dict(num_moduli=NU, k_panel=512)),
}


def solver_cases():
    import gemmul8_tpu_torch as gt
    kw = dict(num_moduli=NU_SOLVER, block=SOLVER_BLOCK)
    return {
        "getrf 2048": lambda x, m: gt.getrf(x["sa"], mesh=m, **kw),
        "qr 2048": lambda x, m: gt.qr(x["sa"], mesh=m, **kw),
        "eigh 512": lambda x, m: gt.eigh(x["sym"], mesh=m, block=EIGH_BLOCK,
                                         max_sweeps=3, tol=0.0),
    }


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().contiguous().cpu().numpy()
                          .tobytes()).hexdigest()


def run_case(mesh, x, name):
    """One case's outputs (C's local blocks, or the solver's results)."""
    if name in GEMM_CASES:
        keys, kw = GEMM_CASES[name]
        ops = [x[k] for k in keys]
        if len(ops) == 2:
            return (summa.summa_gemm(*ops, mesh=mesh, **kw).to_local(),)
        return tuple(c.to_local()
                     for c in summa.summa_gemm_planar(*ops, mesh=mesh, **kw))
    out = solver_cases()[name](x, mesh)
    return out if isinstance(out, tuple) else (out,)


def case_names():
    return list(GEMM_CASES) + list(solver_cases())


def _sync():
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _timed(fn):
    dist.barrier()
    _sync()
    t0 = time.perf_counter()
    out = fn()
    _sync()
    return out, (time.perf_counter() - t0) * 1e3


def run_all(mesh, x, time_it=False):
    """name -> dict(digests (of each output), bytes sent by dtype, ms): each
    case run once, timed by the host clock to a synchronize
    after a barrier; with time_it a SUMMA case runs a second time, and that
    run is the one timed (the solvers' first run is)."""
    res = {}
    for name in case_names():
        summa.reset_bytes()
        outs, ms = _timed(lambda: run_case(mesh, x, name))
        sent = dict(summa.BYTES_SENT)
        if time_it and name in GEMM_CASES:
            ms = _timed(lambda: run_case(mesh, x, name))[1]
        res[name] = dict(digests=[digest(o) for o in outs], bytes=sent,
                         ms=ms)
        del outs
    return res


def _capture_first(names):
    """Record the arguments of the first call of each kernels.<name>; returns
    (store, restore)."""
    store, orig = {}, {n: getattr(kernels, n) for n in names}

    def wrap(n):
        def call(*a, **k):
            if n not in store:
                store[n] = tuple(v.clone() if torch.is_tensor(v) else v
                                 for v in a)
            return orig[n](*a, **k)
        return call
    for n in names:
        setattr(kernels, n, wrap(n))

    def restore():
        for n, f in orig.items():
            setattr(kernels, n, f)
    return store, restore


def kernel_holds(store):
    """K1 and K2 on the captured arguments against their plain versions:
    name -> (bit-equal, shape)."""
    out = {}
    x, sft, axis, nu, backend = store["encode_planes"][:5]
    got = kernels.encode_planes(x, sft, axis, nu, backend)
    ref = kernels.encode_planes_plain(x, sft, axis, nu, backend)
    out["encode_planes"] = (bool(torch.equal(got, ref)), tuple(x.shape))
    c_hi, sa, sb, nu, backend, dt = store["fused_epilogue"][:6]
    got = kernels.fused_epilogue(c_hi, sa, sb, nu, backend, dt)
    ref = kernels.fused_epilogue_plain(c_hi, sa, sb, nu, backend, dt)
    out["fused_epilogue"] = (bool(torch.equal(got.view(torch.int64),
                                              ref.view(torch.int64))),
                             tuple(c_hi.shape))
    return out


def worker(rank, world, shape, port, queue, linalg=None):
    """One rank of a gloo world on this host's card: every case on a `shape`
    mesh; puts (rank, coordinate, results, holds, imported) on the queue. `linalg` names the preferred linear-algebra library (the
    spawning process's), so that the solvers' native pieces take the same
    routines as there."""
    if linalg is not None:
        torch.backends.cuda.preferred_linalg_library(linalg)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = summa.make_mesh(shape, device_type="cuda")
        x = inputs(summa.Comm(mesh).device)
        store, restore = _capture_first(("encode_planes", "fused_epilogue"))
        try:
            run_case(mesh, x, "dgemm gather")
        finally:
            restore()
        holds = kernel_holds(store) if rank == 0 else {}
        del store
        res = run_all(mesh, x, time_it=True)
        imported = sorted(m for m in ("jax", "gemmul8_tpu")
                          if m in sys.modules)
        queue.put((rank, tuple(mesh.get_coordinate()), res, holds, imported))
    finally:
        dist.destroy_process_group()
