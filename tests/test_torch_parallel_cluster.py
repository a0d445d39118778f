"""The port's SUMMA across mesh shapes: spawned gloo clusters of 2 and 4
processes on the CPU (1x2, 2x1, 2x2), each rank's results held bit for bit
against the world-of-one (1x1) run of the same cases in this process.

- SUMMA in every mode of tests/torch_mesh_workers.py (gather and stream,
  ring and psum, fast, robust and accurate, "f64" and "ff" epilogues, f32,
  FP8, complex, complex FP8, the exact-integer case): each rank's C block
  is the 1x1 result's block, bit for bit.
- getrf, potrf, trsm, qr, lstsq and eigh with the mesh: every rank's
  results equal the 1x1 mesh's.
- The bytes each rank sent: only int8 / e4m3 / bf16 planes besides the
  O(m + n) shift scalars, and the plane bytes equal summa_bytes_moved's
  model (half of it on FP8, whose e4m3 planes are half the modelled bf16
  slots): the port's counterparts of tests/test_parallel.py's
  test_summa_collectives_are_int8 and
  test_summa_ring_uses_collective_permute_and_halves_bytes.
- No spawned rank imports JAX or the JAX package.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import torch_mesh_workers as w
from gemmul8_tpu_torch.parallel import summa

SHIFT_DTYPES = {"float64", "float32", "int64", "int32"}


@pytest.fixture(scope="module")
def reference():
    """Every case on a world-of-one 1x1 mesh, in this process."""
    mesh = summa.make_mesh(device_type="cpu")
    try:
        yield w.run_all(mesh)
    finally:
        dist.destroy_process_group()


def _run_cluster(shape, tmp_path):
    world = shape[0] * shape[1]
    mp.spawn(w.worker, args=(world, shape, str(tmp_path / "store"),
                             str(tmp_path)), nprocs=world, join=True)
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _block(full, coord, shape):
    (xi, yi), (X, Y) = coord, shape
    r, c = full.shape[0] // X, full.shape[1] // Y
    return full[xi * r:(xi + 1) * r, yi * c:(yi + 1) * c]


def _bits(x):
    x = x.resolve_conj().contiguous().numpy()
    return x.view(np.uint8)


def _expected_plane_bytes(case, shape):
    keys, kw, model_kw = w.summa_cases()[case]
    nu = kw["num_moduli"]
    model = summa.summa_bytes_moved(w.M, w.N, w.K, shape, nu, **model_kw)
    if kw.get("backend") == "FP8":
        # e4m3 planes: 3 bytes an element a modulus, the model's bf16 6
        assert model_kw.get("fastmode", True) is not False
        return model / 2
    return model


@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 2)], ids=str)
def test_cluster_bit_identical_to_1x1(shape, reference, tmp_path):
    ranks = _run_cluster(shape, tmp_path)
    for r, got in enumerate(ranks):
        assert got["imported"] == [], got["imported"]
        assert f"mesh {shape[0]}x{shape[1]} needs" in got["refusal"]
        for name, (outs, sent) in got["results"].items():
            ref_outs, _ = reference[name]
            assert len(outs) == len(ref_outs), name
            for o, ref in zip(outs, ref_outs):
                if name in w.summa_cases():
                    ref = _block(ref, got["coord"], shape)
                np.testing.assert_array_equal(_bits(o), _bits(ref),
                                              err_msg=f"{name} rank {r}")
            if sent is None:
                continue
            # only planes move besides the O(m + n) shift scalars
            planes = {k for k in sent if k in summa.PLANE_DTYPES}
            assert set(sent) - planes <= SHIFT_DTYPES, (name, sent)
            scalars = sum(v for k, v in sent.items() if k not in planes)
            assert scalars <= 64 * (w.M + w.N) * 3, (name, sent)
            want = _expected_plane_bytes(name, shape)
            assert summa.plane_bytes(sent) == want, (name, r, sent)
