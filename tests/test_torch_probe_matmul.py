"""The port's int8 products (kernels.matmul_i8: the plain version of
csrc/matmul_i8_wgmma.cu, driven through gemmul8_tpu_torch.probes) bit-equal
to the probe tools' Pallas products on the CPU:

  * tools/probe_fused.py pallas_matmul_i8_seq / _astat (K7), in TPU
    interpret mode;
  * tools/probe_matmul3.py mm_flat_kloop / _fullk / _kloop_multidot (K9),
    through the generic Pallas interpreter: their ("arbitrary", "parallel",
    "parallel", "arbitrary") grids are refused by the TPU interpret mode,
    whose parallel dimensions must form a prefix of the grid.
"""
import functools
import importlib.util
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from gemmul8_tpu_torch import kernels
from gemmul8_tpu_torch.probes import fused, matmul3
from gemmul8_tpu_torch.probes.timing import k_contiguous

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_tool(name):
    """Load tools/<name>.py; its `from _timing import ...` needs benchmarks/
    on sys.path (the tool inserts the relative path)."""
    bench = os.path.join(_ROOT, "benchmarks")
    if bench not in sys.path:
        sys.path.insert(0, bench)
    spec = importlib.util.spec_from_file_location(
        f"_tool_{name}", os.path.join(_ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


probe_fused = _load_tool("probe_fused")
probe_matmul3 = _load_tool("probe_matmul3")

NU, M, K, N = 2, 256, 512, 256


def _planes(seed, nu=NU, m=M, k=K, n=N):
    rng = np.random.default_rng(seed)
    return (rng.integers(-127, 128, (nu, m, k)).astype(np.int8),
            rng.integers(-127, 128, (nu, k, n)).astype(np.int8))


def _exact(a, b):
    return np.einsum("umk,ukn->umn", a.astype(np.int64), b.astype(np.int64))


@pytest.fixture(scope="module")
def k7_outputs():
    """K7a and K7b on one input, in TPU interpret mode."""
    a, b = _planes(0)
    with pltpu.force_tpu_interpret_mode():
        seq = probe_fused.pallas_matmul_i8_seq(jnp.asarray(a), jnp.asarray(b),
                                               bm=128, bn=128, bk=256)
        astat = probe_fused.pallas_matmul_i8_astat(jnp.asarray(a),
                                                   jnp.asarray(b), bm=128,
                                                   bn=128)
    return a, b, {"seq": np.asarray(seq), "astat": np.asarray(astat)}


@pytest.mark.parametrize("probe,port", [
    ("seq", fused.matmul_i8_seq),
    ("seq", lambda a, b: fused.matmul_i8_seq(a, k_contiguous(b))),
    ("astat", fused.matmul_i8_astat),
    ("astat", lambda a, b: fused.matmul_i8_astat(a, k_contiguous(b))),
])
def test_k7_bit_equal_to_probe_fused(k7_outputs, probe, port):
    a, b, ref = k7_outputs
    got = port(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32 and got.shape == (NU, M, N)
    np.testing.assert_array_equal(got.numpy(), ref[probe])
    np.testing.assert_array_equal(ref[probe], _exact(a, b))


@pytest.fixture
def interpreted_matmul3(monkeypatch):
    """tools/probe_matmul3.py with its pallas_call in the generic
    interpreter."""
    shim = types.SimpleNamespace(**{n: getattr(pl, n) for n in dir(pl)
                                    if not n.startswith("_")})
    shim.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    monkeypatch.setattr(probe_matmul3, "pl", shim)
    return probe_matmul3


K9_BLOCKS = [
    ("mm_flat_kloop", dict(bm=128, bn=128, bk=256)),
    ("mm_flat_fullk", dict(bm=128, bn=128)),
    ("mm_flat_kloop_multidot", dict(bm=128, bn=128, bk=128, nd=2)),
]


def _check_k9(tool, name, blocks):
    a, b = _planes(1)
    dims = dict(nu=NU, m=M, k=K, n=N)
    a2, b2 = a.reshape(NU * M, K), b.reshape(NU * K, N)
    ref = np.asarray(getattr(tool, name)(
        jnp.asarray(a2), jnp.asarray(b2), **dims, **blocks))
    got = getattr(matmul3, name)(torch.from_numpy(a2), torch.from_numpy(b2),
                                 **dims)
    assert got.dtype == torch.int32 and got.shape == (NU * M, N)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(ref.reshape(NU, M, N), _exact(a, b))


@pytest.mark.parametrize("name,blocks", K9_BLOCKS)
def test_k9_bit_equal_to_probe_matmul3(interpreted_matmul3, name, blocks):
    _check_k9(interpreted_matmul3, name, blocks)


def test_k9_tpu_interpret_mode_refuses_its_grid():
    """Why the K9 tests take the generic interpreter."""
    a, b = _planes(2, nu=1, m=128, k=128, n=128)
    with pltpu.force_tpu_interpret_mode(), pytest.raises(Exception,
                                                         match="prefix"):
        jax.block_until_ready(probe_matmul3.mm_flat_kloop(
            jnp.asarray(a[0]), jnp.asarray(b[0]), nu=1, m=128, k=128, n=128,
            bm=128, bn=128, bk=128))


@pytest.mark.parametrize("shape", [(3, 13, 97, 20), (1, 1, 1, 1),
                                   (2, 40, 0, 24)])
@pytest.mark.parametrize("schedule", ["kloop", "astat"])
def test_matmul_i8_odd_shapes_exact(shape, schedule):
    nu, m, k, n = shape
    a, b = _planes(3, nu, m, k, n)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for bb in (tb, k_contiguous(tb)):
        got = kernels.matmul_i8(ta, bb, schedule)
        np.testing.assert_array_equal(got.numpy(), _exact(a, b))


def test_matmul_i8_wraps_int32():
    """Sums past int32 wrap, as the kernel's int32 sums (and torch._int_mm's)
    do: 2^18 products of 127 * 127 at k = 2^18."""
    k = 1 << 18
    a = torch.full((1, 2, k), 127, dtype=torch.int8)
    b = torch.full((1, k, 3), 127, dtype=torch.int8)
    b[0, :, 1] = -127
    got = kernels.matmul_i8(a, b).numpy()
    want = (np.array([1, -1, 1], np.int64) * 127 * 127 * k).astype(np.int32)
    assert got.shape == (1, 2, 3)
    np.testing.assert_array_equal(got[0], np.broadcast_to(want, (2, 3)))


def test_matmul_i8_cpu_takes_plain_version_and_checks_arguments():
    kernels.reset_launches()
    a, b = (torch.from_numpy(x) for x in _planes(4, 2, 16, 32, 8))
    assert torch.equal(kernels.matmul_i8(a, b, "astat"),
                       kernels.matmul_i8_plain(a, b))
    assert not any(kernels.LAUNCHES.values())
    for schedule in ("rows", "seq", "fullk"):
        with pytest.raises(ValueError, match="no .* schedule"):
            kernels.matmul_i8(a, b, schedule)
    with pytest.raises(ValueError, match="layout|row-major"):
        kernels._b_layout(torch.zeros((2, 32, 16), dtype=torch.int8)[:, :, ::2])
    assert kernels._b_layout(b) is False
    assert kernels._b_layout(k_contiguous(b)) is True


def _misaligned(t):
    """A copy of t whose storage starts one byte past an aligned address."""
    flat = torch.zeros(t.numel() + 1, dtype=t.dtype)[1:]
    return flat.view(t.shape).copy_(t)


@pytest.mark.parametrize("k,want", [(16, True), (336, True), (4096, True),
                                    (97, False), (33, False), (8, False),
                                    (0, False)])
def test_product_route_by_k(k, want):
    """TMA needs 16-byte row strides (k % 16 == 0) and k > 0; both B
    layouts are alike."""
    a, b = (torch.from_numpy(x) for x in _planes(6, 2, 20, k, 24))
    assert kernels.tma_addressable(a, b) is want
    assert kernels.tma_addressable(a, k_contiguous(b)) is want


def test_product_route_by_alignment():
    """A misaligned A, or a misaligned k-contiguous B, is not
    TMA-addressable; n-contiguous B is read through an aligned transposed
    scratch, so its own alignment does not matter."""
    a, b = (torch.from_numpy(x) for x in _planes(7, 2, 20, 64, 24))
    b_kc = k_contiguous(b)
    assert kernels.tma_addressable(a, b) is True
    assert kernels.tma_addressable(_misaligned(a), b) is False
    assert kernels.tma_addressable(a, _misaligned(b)) is True
    assert kernels.tma_addressable(a, b_kc) is True
    mis = _misaligned(b_kc.transpose(-1, -2)).transpose(-1, -2)
    assert kernels._b_layout(mis) is True and mis.data_ptr() % 16 != 0
    assert kernels.tma_addressable(a, mis) is False


@pytest.mark.parametrize("schedule", ["kloop", "astat"])
@pytest.mark.parametrize("b_layout", ["n", "k", "misaligned"])
def test_matmul_i8_cpu_every_route_takes_plain_version(schedule, b_layout):
    """On the CPU each schedule returns matmul_i8_plain, TMA-addressable
    operands or not (k = 97), and launches nothing."""
    kernels.reset_launches()
    for k in (48, 97):
        a, b = (torch.from_numpy(x) for x in _planes(8, 2, 36, k, 20))
        bb = {"n": b, "k": k_contiguous(b), "misaligned": _misaligned(b)}[
            b_layout]
        got = kernels.matmul_i8(a, bb, schedule)
        assert torch.equal(got, kernels.matmul_i8_plain(a, b))
    assert not any(kernels.LAUNCHES.values())
    assert set(kernels.LAUNCHES) >= {"matmul_i8_wgmma_kloop",
                                     "matmul_i8_wgmma_astat", "transpose_i8"}


def test_transpose_i8_cpu_plain():
    """transpose_i8 on the CPU: the same values as a view of (nu, n, k)
    storage, nothing launched."""
    kernels.reset_launches()
    _, b = (torch.from_numpy(x) for x in _planes(9, 3, 5, 40, 24))
    t = kernels.transpose_i8(b)
    assert torch.equal(t, b) and t.transpose(-1, -2).is_contiguous()
    assert kernels._b_layout(t) is True
    assert not any(kernels.LAUNCHES.values())


@pytest.mark.parametrize("main", [fused.main, matmul3.main])
def test_probe_mains_need_the_card(main):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the probes run on it (chip_smoke.py)")
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        main()
