"""The striped path of gemmul8_tpu_torch (gemm's m_block/n_block,
emulate_matmul_blocked, pick_blocking, work_bytes) against gemmul8_tpu on
the CPU, bit for bit: fast, robust and accurate mode, f32 and f64, INT8 and
FP8, with alpha/beta and trans; the planning numbers; and the card's
budget rule, with the memory query stubbed."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gemmul8_tpu as g8
import gemmul8_tpu_torch as gt
from gemmul8_tpu import core as jcore
from gemmul8_tpu_torch import core


def _bits_equal(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got.view(np.uint8), ref.view(np.uint8))


@pytest.mark.parametrize("fastmode", [True, "robust", False])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_blocked_gemm_bit_identical(fastmode, dtype):
    """Striped == unstriped == the JAX package's striped and unstriped
    calls, for every mode, odd shapes and stripe tails included
    (tests/test_round3_fixes.py's case)."""
    rng = np.random.default_rng(41)
    m, k, n = 52, 96, 72
    a = rng.standard_normal((m, k)).astype(dtype)
    b = rng.standard_normal((k, n)).astype(dtype)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ref = g8.gemm(ja, jb, num_moduli=9, fastmode=fastmode)
    _bits_equal(g8.gemm(ja, jb, num_moduli=9, fastmode=fastmode, n_block=32),
                ref)
    _bits_equal(gt.gemm(a, b, num_moduli=9, fastmode=fastmode, device="cpu"),
                ref)
    for mb, nb in [(None, 32), (24, 32), (16, 24)]:
        out = gt.gemm(a, b, num_moduli=9, fastmode=fastmode, m_block=mb,
                      n_block=nb, device="cpu")
        _bits_equal(out, ref)


def test_blocked_gemm_alpha_beta_and_trans():
    """tests/test_round3_fixes.py's alpha/beta/trans case: the port's
    striped call equals the JAX package's striped and unstriped ones."""
    rng = np.random.default_rng(42)
    a = rng.standard_normal((40, 64))
    b = rng.standard_normal((24, 64))   # used transposed
    c = rng.standard_normal((40, 24))
    kw = dict(num_moduli=10, trans_b=True, alpha=-1.5, beta=1.25)
    ref = g8.gemm(jnp.asarray(a), jnp.asarray(b), c=jnp.asarray(c), **kw)
    _bits_equal(g8.gemm(jnp.asarray(a), jnp.asarray(b), c=jnp.asarray(c),
                        n_block=8, **kw), ref)
    _bits_equal(gt.gemm(a, b, c=c, n_block=8, device="cpu", **kw), ref)
    _bits_equal(gt.gemm(a.T.copy(), b, c=c, trans_a="T", m_block=16,
                        n_block=8, device="cpu", **kw), ref)


@pytest.mark.parametrize("dtype,alpha,beta", [
    ("float64", 1.0, 1.25), ("float32", -1.5, 1.25), ("float32", 0.7, -1.3)])
def test_blocked_alpha_beta_keeps_unblocked_bits(dtype, alpha, beta):
    """The JAX package's striped path applies alpha/beta in a jit of its own
    (core.py:419-426, _ab_epilogue), where XLA:CPU contracts the sum
    differently from the unstriped jit: for these cases its striped bits
    differ from its unstriped ones. The port applies them through the
    unstriped epilogue (core.ab_epilogue), so its striped call keeps the
    JAX package's unstriped bits."""
    rng = np.random.default_rng(43)
    a = rng.standard_normal((40, 64)).astype(dtype)
    b = rng.standard_normal((64, 24)).astype(dtype)
    c = rng.standard_normal((40, 24)).astype(dtype)
    kw = dict(num_moduli=9, alpha=alpha, beta=beta)
    ref = g8.gemm(jnp.asarray(a), jnp.asarray(b), c=jnp.asarray(c), **kw)
    _bits_equal(gt.gemm(a, b, c=c, n_block=8, device="cpu", **kw), ref)
    _bits_equal(gt.gemm(a, b, c=c, m_block=16, n_block=16, device="cpu",
                        **kw), ref)


@pytest.mark.parametrize("fastmode", [True, False])
def test_blocked_fp8(fastmode):
    """FP8 stripes equal the JAX package's unstriped FP8 call."""
    rng = np.random.default_rng(44)
    a = rng.standard_normal((40, 80))
    b = rng.standard_normal((80, 36))
    ref = g8.gemm(jnp.asarray(a), jnp.asarray(b), num_moduli=6,
                  backend="FP8", fastmode=fastmode)
    _bits_equal(gt.gemm(a, b, num_moduli=6, backend="FP8", fastmode=fastmode,
                        m_block=24, n_block=16, device="cpu"), ref)


@pytest.mark.parametrize("shape,nu,dtype,backend", [
    ((128, 96, 64), 8, "float64", "INT8"),
    ((8192, 8192, 8192), 16, "float64", "INT8"),
    ((8192, 8192, 8192), 14, "float64", "FP8"),
    ((32768, 32768, 8192), 16, "float64", "INT8"),
    ((300, 200, 100), 12, "complex128", "INT8"),
    ((64, 64, 64), 7, "float32", "FP8"),
])
def test_work_bytes_matches_jax(shape, nu, dtype, backend):
    """The port keeps the JAX package's formula and numbers (compat's
    workSize is built on it), for torch dtypes and dtype names alike."""
    want = jcore.work_bytes(*shape, nu, jnp.dtype(dtype), backend)
    assert core.work_bytes(*shape, nu, dtype, backend) == want
    tdt = getattr(torch, dtype)
    assert gt.work_bytes(*shape, nu, tdt, backend) == want


def test_work_bytes_headline_numbers():
    """The numbers the card's budget is weighed against: the 8192^3
    headline calls fit in 7.5 and 24.4 GB; f64 32768x32768x8192 at nu=16
    needs 94,489,542,656 bytes, and a stripe of 8192 columns 26.8 GB."""
    assert core.work_bytes(8192, 8192, 8192, 16) == 7516258304
    assert core.work_bytes(8192, 8192, 8192, 14, torch.float64,
                           "FP8") == 24427692032
    assert core.work_bytes(32768, 32768, 8192, 16) == 94489542656
    assert core.work_bytes(32768, 8192, 8192, 16) == 26843709440


def test_pick_blocking_model():
    """tests/test_round3_fixes.py's model, and the JAX package's choices."""
    budget = 12 * (1 << 30)
    for m, n, k in ((8192, 8192, 8192), (16384, 16384, 16384),
                    (32768, 32768, 32768), (20000, 3000, 4096)):
        want = jcore.pick_blocking(m, n, k, 16, jnp.float64,
                                   budget_bytes=budget)
        got = core.pick_blocking(m, n, k, 16, torch.float64,
                                 budget_bytes=budget)
        assert got == want
    assert core.pick_blocking(8192, 8192, 8192, 16, torch.float64,
                              budget_bytes=budget) == (None, None)
    mb, nb = core.pick_blocking(16384, 16384, 16384, 16, torch.float64,
                                budget_bytes=budget)
    assert nb is not None
    assert core.work_bytes(mb or 16384, nb, 16384, 16) <= budget
    mb2, nb2 = core.pick_blocking(32768, 32768, 32768, 16, torch.float64,
                                  budget_bytes=budget)
    assert mb2 is not None and nb2 is not None
    assert core.work_bytes(mb2, nb2, 32768, 16) <= budget


def test_pick_blocking_cpu_and_env(monkeypatch):
    """Unbounded on the CPU unless GEMMUL8_HBM_BUDGET_GB is set; with it
    set gemm stripes itself there too, bit-equal to the unstriped call."""
    monkeypatch.delenv("GEMMUL8_HBM_BUDGET_GB", raising=False)
    assert core.pick_blocking(1 << 16, 1 << 16, 1 << 16, 20, torch.float64,
                              device="cpu") == (None, None)
    rng = np.random.default_rng(45)
    a = rng.standard_normal((96, 64))
    b = rng.standard_normal((64, 2048))
    ref = gt.gemm(a, b, num_moduli=8, device="cpu")
    calls = []
    orig = core.emulate_matmul_blocked
    monkeypatch.setattr(core, "emulate_matmul_blocked",
                        lambda *x, **kw: calls.append(kw) or orig(*x, **kw))
    # 6 MiB: the unstriped product's 9.0 MB of work does not fit, a stripe
    # of 1024 columns' 4.5 MB does
    monkeypatch.setenv("GEMMUL8_HBM_BUDGET_GB", str(6 / 1024))
    assert core.pick_blocking(96, 2048, 64, 8, torch.float64,
                              device="cpu") == (None, 1024)
    _bits_equal(gt.gemm(a, b, num_moduli=8, device="cpu"), ref)
    assert calls and calls[0]["n_block"] == 1024


def test_device_budget_counts_reserved_free_memory(monkeypatch):
    """On the card the budget is three quarters of the device's total memory
    less what the allocator has allocated, so the caching allocator's
    reserved-but-unallocated blocks count as available (torch.cuda's
    mem_get_info counts them as used and is not asked). With 80 GiB in
    all, 72 GiB reserved and 40 GiB allocated the budget is 30 GiB: the
    8192^3 headline calls do not stripe, though the 8 GiB mem_get_info
    would call free (6 GiB after the quarter) would stripe both."""
    gib = 1 << 30
    stats = {"reserved_bytes": {"all": {"current": 72 * gib}},
             "allocated_bytes": {"all": {"current": 40 * gib}}}
    monkeypatch.delenv("GEMMUL8_HBM_BUDGET_GB", raising=False)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda index: types.SimpleNamespace(
                            total_memory=80 * gib))
    monkeypatch.setattr(torch.cuda, "memory_stats_as_nested_dict",
                        lambda device=None: stats)
    core._total_memory.cache_clear()
    try:
        assert core.device_budget_bytes("cuda") == 30 * gib
        assert core.device_budget_bytes("cuda:0") == 30 * gib
        for nu, backend in ((16, "INT8"), (14, "FP8")):
            assert core.work_bytes(8192, 8192, 8192, nu, torch.float64,
                                   backend) > 6 * gib
            assert core.pick_blocking(8192, 8192, 8192, nu, torch.float64,
                                      backend, device="cuda") == (None, None)
        # 94.5 GB does not fit: four stripes of 8192 columns, m unstriped
        assert core.pick_blocking(32768, 32768, 8192, 16, torch.float64,
                                  device="cuda") == (None, 8192)
        # an allocator that holds nothing yet reports no statistics
        monkeypatch.setattr(torch.cuda, "memory_stats_as_nested_dict",
                            lambda device=None: {})
        assert core.device_budget_bytes("cuda") == 60 * gib
    finally:
        core._total_memory.cache_clear()


def test_complex_operands_pass_no_blocking():
    """As in the JAX package, complex gemm ignores m_block/n_block."""
    rng = np.random.default_rng(46)
    a = rng.standard_normal((12, 20)) + 1j * rng.standard_normal((12, 20))
    b = rng.standard_normal((20, 10)) + 1j * rng.standard_normal((20, 10))
    _bits_equal(gt.gemm(a, b, num_moduli=8, m_block=4, n_block=4,
                        device="cpu"),
                gt.gemm(a, b, num_moduli=8, device="cpu"))


def test_emulate_matmul_blocked_k0_and_one_output():
    """k = 0 gives zeros; the stripes land in one output tensor."""
    z = core.emulate_matmul_blocked(torch.zeros((5, 0)), torch.zeros((0, 7)),
                                    num_moduli=8, n_block=2)
    assert z.shape == (5, 7) and not z.any()
    rng = np.random.default_rng(47)
    a = torch.from_numpy(rng.standard_normal((9, 33)))
    b = torch.from_numpy(rng.standard_normal((33, 11)))
    out = core.emulate_matmul_blocked(a, b, num_moduli=8, n_block=4,
                                      m_block=4)
    assert out.is_contiguous() and out.shape == (9, 11)
    _bits_equal(out, core.emulate_matmul(a, b, num_moduli=8))
