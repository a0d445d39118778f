"""The work of tests/test_torch_parallel_cluster.py's spawned ranks, and of
its world-of-one reference: SUMMA in every mode and the solvers, qr and
eigh with a mesh, on small inputs made from a seed. Imports only torch,
numpy and the port (a spawned rank must not import JAX or the JAX
package; `worker` checks it)."""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

import gemmul8_tpu_torch as gt
from gemmul8_tpu_torch.parallel import summa

SEED = 20261020
M = N = K = 64
PANEL = 16
SOLVER_N, SOLVER_BLOCK, SOLVER_NU = 64, 32, 14
EIGH_BLOCK = 8              # 8 blocks: 4 pairs a round, any mesh of <= 4


def inputs():
    rng = np.random.default_rng(SEED)

    def phi(m, n, p):
        return (rng.random((m, n)) - 0.5) * np.exp(
            rng.standard_normal((m, n)) * p)

    x = dict(a=phi(M, K, 1.0), b=phi(K, N, 1.0),
             ai=phi(M, K, 1.0), bi=phi(K, N, 1.0),
             ia=rng.integers(-40, 40, (M, K)).astype(np.float64),
             ib=rng.integers(-40, 40, (K, N)).astype(np.float64))
    n = SOLVER_N
    g = rng.standard_normal((n, n))
    x["sa"] = rng.standard_normal((n, n)) + n * np.eye(n)
    x["spd"] = g @ g.T / n + 2 * np.eye(n)
    x["tl"] = np.tril(rng.standard_normal((n, n)) / 8) + 2 * np.eye(n)
    x["rhs"] = rng.standard_normal((n, 4))
    x["sym"] = (g + g.T) / 2
    return x


# SUMMA cases: name -> (operands, keyword arguments, summa_bytes_moved's
# arguments for the byte tally, or None where it has no exact model)
def summa_cases():
    real = ("a", "b")
    cplx = ("a", "ai", "b", "bi")
    nu, znu = 10, 12
    stream = dict(k_panel=PANEL)
    return {
        "f64 gather": (real, dict(num_moduli=nu), {}),
        "f64 gather robust": (real, dict(num_moduli=nu, fastmode="robust"),
                              {}),
        "f64 gather accurate": (real, dict(num_moduli=nu, fastmode=False),
                                dict(fastmode=False)),
        "f64 gather ff": (real, dict(num_moduli=nu, epilogue="ff"), {}),
        "f32 gather": (real, dict(num_moduli=7, dtype=torch.float32), {}),
        "f64 stream ring": (real, dict(num_moduli=nu, **stream), stream),
        "f64 stream psum": (real, dict(num_moduli=nu, bcast="psum", **stream),
                            dict(bcast="psum", **stream)),
        "f64 stream accurate": (real, dict(num_moduli=nu, fastmode=False,
                                           **stream),
                                dict(fastmode=False, **stream)),
        "f64 stream robust ff": (real, dict(num_moduli=nu, fastmode="robust",
                                            epilogue="ff", **stream), stream),
        "fp8 gather": (real, dict(num_moduli=9, backend="FP8"),
                       dict(backend="FP8")),
        "fp8 stream": (real, dict(num_moduli=9, backend="FP8", **stream),
                       dict(backend="FP8", **stream)),
        "exact integer": (("ia", "ib"), dict(num_moduli=8), {}),
        "c128 gather": (cplx, dict(num_moduli=znu), dict(complex_lanes=True)),
        "c128 gather accurate": (cplx, dict(num_moduli=znu, fastmode=False),
                                 dict(complex_lanes=True, fastmode=False)),
        "c128 stream ring": (cplx, dict(num_moduli=znu, **stream),
                             dict(complex_lanes=True, **stream)),
        "c128 stream psum ff": (cplx, dict(num_moduli=znu, bcast="psum",
                                           epilogue="ff", **stream),
                                dict(complex_lanes=True, bcast="psum",
                                     **stream)),
        "c64 fp8 gather": (cplx, dict(num_moduli=9, backend="FP8",
                                      dtype=torch.float32),
                           dict(complex_lanes=True, backend="FP8")),
    }


def run_summa(mesh, x, keys, kw):
    kw = dict(kw)
    dtype = kw.pop("dtype", torch.float64)
    ops = [torch.from_numpy(x[k]).to(dtype) for k in keys]
    if len(ops) == 2:
        return (summa.summa_gemm(*ops, mesh=mesh, **kw).to_local(),)
    return tuple(c.to_local()
                 for c in summa.summa_gemm_planar(*ops, mesh=mesh, **kw))


def solver_cases():
    kw = dict(num_moduli=SOLVER_NU, block=SOLVER_BLOCK, device="cpu")
    ekw = dict(block=EIGH_BLOCK, max_sweeps=2, tol=0.0, device="cpu")
    return {
        "getrf": lambda x, m: gt.getrf(x["sa"], mesh=m, **kw),
        "potrf": lambda x, m: gt.potrf(x["spd"], mesh=m, **kw),
        "trsm": lambda x, m: gt.trsm(x["tl"], x["rhs"], mesh=m, **kw),
        "qr": lambda x, m: gt.qr(x["sa"], mesh=m, **kw),
        "lstsq": lambda x, m: gt.lstsq(x["sa"], x["rhs"], mesh=m, **kw),
        "eigh": lambda x, m: gt.eigh(x["sym"], mesh=m, **ekw),
    }


def run_all(mesh):
    """Every case on `mesh`: {name: (this rank's outputs, bytes sent by
    dtype)}."""
    x = inputs()
    out = {}
    for name, (keys, kw, _) in summa_cases().items():
        summa.reset_bytes()
        res = run_summa(mesh, x, keys, kw)
        out[name] = (res, dict(summa.BYTES_SENT))
    for name, fn in solver_cases().items():
        res = fn(x, mesh)
        out[name] = (res if isinstance(res, tuple) else (res,), None)
    return out


def refusal(mesh):
    """The message of the layout refusal (m not divisible by mesh.x, n not
    by mesh.y)."""
    try:
        summa.summa_gemm(torch.ones(M - 1, K, dtype=torch.float64),
                         torch.ones(K, N - 1, dtype=torch.float64), mesh=mesh)
    except ValueError as e:
        return str(e)
    return None


def worker(rank, world, shape, store_path, out_dir):
    """One spawned rank: joins a gloo world of `world` ranks on a FileStore,
    runs every case on a `shape` mesh and saves its results."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        mesh = summa.make_mesh(shape, device_type="cpu")
        res = run_all(mesh)
        torch.save(dict(results=res, coord=tuple(mesh.get_coordinate()),
                        refusal=refusal(mesh),
                        imported=sorted(m for m in ("jax", "gemmul8_tpu")
                                        if m in sys.modules)),
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def example_worker(rank, world, store_path, out_dir):
    """One spawned rank of the distributed_summa example: joins a gloo
    world of `world` ranks on a FileStore, runs the example's main on the
    CPU (its mesh: the world's) and saves what it returned and printed."""
    import contextlib
    import io
    from gemmul8_tpu_torch.examples import distributed_summa
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = distributed_summa.main(device="cpu")
        torch.save(dict(out=out, lines=buf.getvalue().splitlines(),
                        initialized=dist.is_initialized(),
                        imported=sorted(m for m in ("jax", "gemmul8_tpu")
                                        if m in sys.modules)),
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
