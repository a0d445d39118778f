"""Distributed emulated DGEMM: 2-D SUMMA over a torch.distributed device mesh
(the port of examples/distributed_summa.py).

Shows the three distributed modes and the memory model:
  * full-K gather (fastest when the gathered planes fit the card)
  * K-panel streaming (bounded memory -- the 65536^3-class configuration)
  * distributed accurate mode (two-phase product-magnitude estimation)
All three produce BIT-IDENTICAL results on every mesh shape: shifts are
order-free (all-reduced maxima and exact integer norm pieces) and partial
products accumulate in residue space, where addition commutes mod p.

Run alone it is a world of one (NCCL on the card, gloo with --device cpu);
under torchrun the mesh is the world: 2 x (world / 2) when the world is
even and at least 4, else 1 x world. Each rank takes
cuda:{LOCAL_RANK % device_count}.

    python -m gemmul8_tpu_torch.examples.distributed_summa [--device cpu]
    torchrun --nproc-per-node 4 -m gemmul8_tpu_torch.examples.distributed_summa
"""
import os

import numpy as np
import torch
import torch.distributed as dist

from gemmul8_tpu_torch.parallel import make_mesh, summa_gemm, summa_work_bytes

from . import cli, device_of, to_numpy


def mesh_shape(world: int) -> tuple:
    """2 x (world / 2) for an even world of at least 4 ranks, else 1 x
    world."""
    return (2, world // 2) if world >= 4 and world % 2 == 0 else (1, world)


def main(device=None) -> dict:
    device = device_of(device)
    own_group = not dist.is_initialized()
    if own_group and "WORLD_SIZE" in os.environ:     # under torchrun
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                                  % torch.cuda.device_count())
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    try:
        # with no group yet, make_mesh starts a world of one
        world = dist.get_world_size() if dist.is_initialized() else 1
        mesh = make_mesh(mesh_shape(world), device_type=device.type)
        out = _run(mesh, device)
    finally:
        if own_group and dist.is_initialized():
            dist.destroy_process_group()
    return out


def _run(mesh, device) -> dict:
    rank0 = dist.get_rank() == 0

    def say(*a):
        if rank0:
            print(*a)

    rng = np.random.default_rng(0)
    m = n = k = 256
    a_np = rng.standard_normal((m, k))
    b_np = rng.standard_normal((k, n))
    ref = a_np @ b_np
    dev = torch.device(device.type, torch.cuda.current_device()) \
        if device.type == "cuda" else device
    a = torch.from_numpy(a_np).to(dev)
    b = torch.from_numpy(b_np).to(dev)
    say(f"mesh: {tuple(mesh.mesh.shape)} on {device.type}")

    c_gather = summa_gemm(a, b, mesh=mesh, num_moduli=14)
    c_stream = summa_gemm(a, b, mesh=mesh, num_moduli=14, k_panel=32)
    c_accu = summa_gemm(a, b, mesh=mesh, num_moduli=14, fastmode=False)
    blocks = {name: to_numpy(c.to_local()) for name, c in
              (("gather", c_gather), ("stream", c_stream),
               ("accurate", c_accu))}
    full = {name: to_numpy(c.full_tensor()) for name, c in
            (("gather", c_gather), ("stream", c_stream),
             ("accurate", c_accu))}

    gather_err = float(np.max(np.abs(full["gather"] - ref)))
    same = bool(np.array_equal(full["stream"], full["gather"]))
    accu_err = float(np.max(np.abs(full["accurate"] - ref)))
    say("gather  max err:", gather_err)
    say("stream == gather bitwise:", same)
    say("accurate max err:", accu_err)
    assert same, "the stream must equal the gather bit for bit"

    GiB = 1 << 30
    table = []
    for msh in [(2, 4), (4, 8), (8, 16)]:
        s = summa_work_bytes(65536, 65536, 65536, msh, 16, k_panel=4096) / GiB
        g = summa_work_bytes(65536, 65536, 65536, msh, 16) / GiB
        table.append((msh, s, g))
        say(f"65536^3 nu=16 on {msh}: streaming {s:5.1f} GiB/device "
            f"(gather would need {g:5.1f})")
    say("OK")
    return dict(mesh=tuple(mesh.mesh.shape),
                coord=tuple(mesh.get_coordinate()), blocks=blocks, **full,
                gather_err=gather_err, stream_equal=same, accu_err=accu_err,
                work_bytes=table)


if __name__ == "__main__":
    cli(main)
