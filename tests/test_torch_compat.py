"""The reference-signature layer of gemmul8_tpu_torch (compat.workSize,
gemm, gemmLt, Handle) against gemmul8_tpu on the CPU, bit for bit:
column-major ld-strided numpy buffers and torch CPU tensors, in-place C,
op chars, alpha/beta, the FP8 entry split, the skip-scal cache and the
phase vector; and one test for each fault of the JAX package's compat.py
that the port does not carry."""
import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gemmul8_tpu as g8
from gemmul8_tpu import compat as jcompat
from gemmul8_tpu_torch import compat


def _bits_equal(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    got, ref = np.ascontiguousarray(got), np.ascontiguousarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got.view(np.uint8), ref.view(np.uint8))


def _colmajor_buf(mat: np.ndarray, ld: int) -> np.ndarray:
    """A 1-D column-major buffer with leading dimension ld holding mat,
    the padding rows poisoned with a sentinel."""
    rows, cols = mat.shape
    buf = np.full(ld * cols, 7777.0, mat.dtype)
    np.copyto(buf.reshape(cols, ld).T[:rows], mat)
    return buf


def _stored(buf, ld, rows, cols):
    return np.asarray(buf).reshape(cols, ld).T[:rows]


def _gemm(*args, **kw):
    return compat.gemm(*args, device="cpu", **kw)


def _jgemm(a, b, **kw):
    return g8.gemm(jnp.asarray(a), jnp.asarray(b), **kw)


@pytest.mark.parametrize("kw", [{}, {"is_complex": True},
                                {"backend": "FP8"}])
def test_worksize_matches_jax(kw):
    assert compat.workSize(128, 96, 64, 8, **kw) == \
        jcompat.workSize(128, 96, 64, 8, **kw)
    total, wa, wb = compat.workSize(128, 96, 64, 8, return_split=True, **kw)
    assert (total, wa, wb) == jcompat.workSize(128, 96, 64, 8,
                                               return_split=True, **kw)
    assert compat.workSize(128, 96, 64, 8, True, False, **kw) == total + wa
    assert compat.workSize(128, 96, 64, 8, False, True, **kw) == total + wb
    with pytest.raises(ValueError):
        compat.workSize(0, 8, 8, 8, **kw)
    with pytest.raises(ValueError):
        compat.workSize(8, 8, 8, 99, **kw)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_gemm_strided_matches_core(dtype):
    m, n, k = 33, 21, 40
    r = np.random.default_rng(1)
    a = r.standard_normal((m, k)).astype(dtype)
    b = r.standard_normal((k, n)).astype(dtype)
    lda, ldb, ldc = m + 3, k + 5, m + 2
    cbuf = _colmajor_buf(np.zeros((m, n), dtype), ldc)
    times = _gemm(None, "N", "N", m, n, k, 1.0, _colmajor_buf(a, lda), lda,
                  _colmajor_buf(b, ldb), ldb, 0.0, cbuf, ldc, num_moduli=8,
                  fastmode=True)
    assert times == [0.0, 0.0, 0.0, 0.0]
    _bits_equal(_stored(cbuf, ldc, m, n), _jgemm(a, b, num_moduli=8))
    assert np.all(cbuf.reshape(n, ldc).T[m:] == 7777.0)


def test_gemm_torch_buffers_in_place():
    """1-D torch CPU tensors with ld strides, ops T/N, alpha/beta: C is
    written in place through its strided view, its padding untouched."""
    m, n, k, ld = 17, 19, 23, 29
    r = np.random.default_rng(11)
    a_st = r.standard_normal((k, m))            # op T: stored k x m
    b = r.standard_normal((k, n))
    c0 = r.standard_normal((m, n))
    tb = [torch.from_numpy(_colmajor_buf(x, ld)) for x in (a_st, b, c0)]
    cref = tb[2]
    compat.gemm(None, "T", "N", m, n, k, 0.7, tb[0], ld, tb[1], ld, -1.3,
                cref, ld, num_moduli=12, fastmode=True, device="cpu")
    assert tb[2] is cref
    want = _jgemm(a_st.T.copy(), b, num_moduli=12, alpha=0.7, beta=-1.3,
                  c=jnp.asarray(c0))
    _bits_equal(_stored(cref.numpy(), ld, m, n), want)
    assert np.all(cref.numpy().reshape(n, ld).T[m:] == 7777.0)


@pytest.mark.parametrize("op_a,op_b", [("T", "N"), ("N", "T"), ("T", "T")])
def test_gemm_ops_alpha_beta(op_a, op_b):
    m, n, k = 17, 19, 23
    r = np.random.default_rng(2)
    a_log, b_log, c0 = (r.standard_normal(s) for s in ((m, k), (k, n),
                                                      (m, n)))
    a_st = a_log.T.copy() if op_a == "T" else a_log
    b_st = b_log.T.copy() if op_b == "T" else b_log
    c = c0.copy()
    _gemm(None, op_a, op_b, m, n, k, -1.5, a_st, a_st.shape[0], b_st,
          b_st.shape[0], 1.2, c, m, num_moduli=12, fastmode=True)
    _bits_equal(c, _jgemm(a_log, b_log, num_moduli=12, alpha=-1.5, beta=1.2,
                          c=jnp.asarray(c0)))


def test_gemm_complex_conjugate_op():
    m = n = k = 12
    r = np.random.default_rng(3)
    a = r.standard_normal((k, m)) + 1j * r.standard_normal((k, m))
    b = r.standard_normal((k, n)) + 1j * r.standard_normal((k, n))
    c = np.zeros((m, n), np.complex128)
    _gemm(None, "C", "N", m, n, k, 1.0, a, k, b, k, 0.0, c, m,
          num_moduli=14, fastmode=True)
    _bits_equal(c, _jgemm(a, b, num_moduli=14, trans_a="C"))
    # complex FP8 (queue 8), once refused here, gives gemmul8_tpu's bits
    compat.gemmLt(None, "C", "N", m, n, k, 1.0, a, k, b, k, 0.0, c, m,
                  num_moduli=8, fastmode=True, backend="FP8", device="cpu")
    _bits_equal(c, _jgemm(a, b, num_moduli=8, trans_a="C", backend="FP8"))


def test_gemm_rejects_fp8_gemmlt_accepts():
    m = n = k = 16
    r = np.random.default_rng(4)
    a, b = r.standard_normal((m, k)), r.standard_normal((k, n))
    c = np.zeros((m, n))
    with pytest.raises(ValueError, match="FP8"):
        _gemm(None, "N", "N", m, n, k, 1.0, a, m, b, k, 0.0, c, m,
              num_moduli=8, fastmode=True, backend="FP8")
    compat.gemmLt(None, "N", "N", m, n, k, 1.0, a, m, b, k, 0.0, c, m,
                  num_moduli=8, fastmode=True, backend="FP8", device="cpu")
    _bits_equal(c, _jgemm(a, b, num_moduli=8, backend="FP8"))


def test_gemm_requires_writable_c_and_device_rule():
    a = np.zeros((4, 4))
    for bad in (jnp.zeros((4, 4)), [[0.0] * 4] * 4):
        with pytest.raises(TypeError, match="writable numpy"):
            _gemm(None, "N", "N", 4, 4, 4, 1.0, a, 4, a, 4, 0.0, bad, 4,
                  num_moduli=8, fastmode=True)
    ro = np.zeros((4, 4))
    ro.flags.writeable = False
    with pytest.raises(TypeError, match="writable numpy"):
        _gemm(None, "N", "N", 4, 4, 4, 1.0, a, 4, a, 4, 0.0, ro, 4,
              num_moduli=8, fastmode=True)
    with pytest.raises(ValueError, match="own device"):
        compat.gemm(None, "N", "N", 4, 4, 4, 1.0, a, 4, a, 4, 0.0,
                    torch.zeros((4, 4), dtype=torch.float64), 4,
                    num_moduli=8, fastmode=True, device="cuda")
    if not torch.cuda.is_available():
        # a numpy C is computed on the card unless the caller asks for the CPU
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            compat.gemm(None, "N", "N", 4, 4, 4, 1.0, a, 4, a, 4, 0.0,
                        np.zeros((4, 4)), 4, num_moduli=8, fastmode=True)


def test_skip_scal_cache_reuse_bitwise():
    m, n, k = 24, 18, 32
    r = np.random.default_rng(5)
    a, b1, b2 = (r.standard_normal(s) for s in ((m, k), (k, n), (k, n)))
    h = compat.create()
    c_ref = np.zeros((m, n))
    _gemm(h, "N", "N", m, n, k, 1.0, a, m, b1, k, 0.0, c_ref, m,
          num_moduli=8, fastmode=True, enable_skip_scalA=True)
    assert len(h._cache) == 1
    c1 = np.zeros((m, n))
    _gemm(h, "N", "N", m, n, k, 1.0, a, m, b2, k, 0.0, c1, m,
          num_moduli=8, fastmode=True, enable_skip_scalA=True,
          skip_scalA=True)
    _bits_equal(c1, _jgemm(a, b2, num_moduli=8))
    _bits_equal(c_ref, _jgemm(a, b1, num_moduli=8))
    compat.destroy(h)
    assert len(h._cache) == 0


def test_with_timing_phase_vector():
    """The phase vector is core.gemm_with_phases'; every phase >= 0 with a
    positive sum (a phase can read 0: ROADMAP section 3); C keeps gemm's
    bits, ops and alpha/beta included."""
    m = n = k = 64
    r = np.random.default_rng(6)
    a, b, c0 = (r.standard_normal((m, k)) for _ in range(3))
    c = c0.copy()
    times = _gemm(None, "T", "N", m, n, k, -0.5, a, m, b, k, 2.0, c, m,
                  num_moduli=14, fastmode=True, with_timing=True)
    assert len(times) == 4 and min(times) >= 0 and sum(times) > 0
    _bits_equal(c, _jgemm(a.T.copy(), b, num_moduli=14, alpha=-0.5,
                          beta=2.0, c=jnp.asarray(c0)))
    with pytest.raises(ValueError, match="real path"):
        _gemm(None, "N", "N", 4, 4, 4, 1.0, np.ones((4, 4), np.complex128),
              4, np.ones((4, 4), np.complex128), 4, 0.0,
              np.zeros((4, 4), np.complex128), 4, num_moduli=8,
              fastmode=True, with_timing=True)


def test_1d_and_2d_buffers_agree():
    m, n, k = 9, 11, 13
    r = np.random.default_rng(7)
    a, b = r.standard_normal((m, k)), r.standard_normal((k, n))
    c_2d = np.zeros((m, n))
    _gemm(None, "N", "N", m, n, k, 1.0, a, m, b, k, 0.0, c_2d, m,
          num_moduli=8, fastmode=True)
    c_1d = np.zeros(m * n)
    _gemm(None, "N", "N", m, n, k, 1.0, _colmajor_buf(a, m), m,
          _colmajor_buf(b, k), k, 0.0, c_1d, m, num_moduli=8, fastmode=True)
    _bits_equal(c_1d.reshape(n, m).T, c_2d)


def test_accurate_mode_and_validation():
    m = n = k = 20
    r = np.random.default_rng(8)
    a, b = r.standard_normal((m, k)), r.standard_normal((k, n))
    c = np.zeros((m, n))
    _gemm(None, "N", "N", m, n, k, 1.0, a, m, b, k, 0.0, c, m,
          num_moduli=10, fastmode=False)
    _bits_equal(c, _jgemm(a, b, num_moduli=10, fastmode=False))
    with pytest.raises(ValueError, match="num_moduli"):
        _gemm(None, "N", "N", m, n, k, 1.0, a, m, b, k, 0.0, c, m,
              num_moduli=25, fastmode=True)
    with pytest.raises(ValueError, match="ops"):
        _gemm(None, "X", "N", m, n, k, 1.0, a, m, b, k, 0.0, c, m,
              num_moduli=8, fastmode=True)
    with pytest.raises(ValueError, match="ld"):
        _gemm(None, "N", "N", m, n, k, 1.0, a.ravel(), m - 1, b, k,
              0.0, c, m, num_moduli=8, fastmode=True)


# ---------------------------------------------------------------------------
# the faults of gemmul8_tpu/compat.py that the port does not carry
# ---------------------------------------------------------------------------

def test_compat_157_complex_alpha_with_real_c_raises():
    """compat.py:157 drops the imaginary part of a complex alpha or beta
    when C is real (alpha=1j became 0.0)."""
    a = np.ones((4, 4))
    for alpha, beta in ((1j, 0.0), (1.0, 0.5 - 2j)):
        with pytest.raises(ValueError, match="complex but C is real"):
            _gemm(None, "N", "N", 4, 4, 4, alpha, a, 4, a, 4, beta,
                  np.zeros((4, 4)), 4, num_moduli=8, fastmode=True)
    # a complex scalar with no imaginary part is a real one
    c = np.zeros((4, 4))
    _gemm(None, "N", "N", 4, 4, 4, 2 + 0j, a, 4, a, 4, 0.0, c, 4,
          num_moduli=8, fastmode=True)
    assert np.all(c == 8.0)


def test_compat_169_skip_cache_drops_collected_buffers():
    """compat.py:169 keys the skip cache on id() alone: a buffer collected
    and a new one of the same shape at the same id was served the dead
    buffer's planes. The port drops an entry with its buffer, and checks
    the buffer's identity on every hit."""
    m, n, k = 16, 12, 24
    r = np.random.default_rng(9)
    b = r.standard_normal((k, n))
    h = compat.create()
    a1 = r.standard_normal((m, k))
    _gemm(h, "N", "N", m, n, k, 1.0, a1, m, b, k, 0.0, np.zeros((m, n)), m,
          num_moduli=8, fastmode=True, enable_skip_scalA=True)
    assert len(h._cache) == 1
    del a1
    gc.collect()
    assert len(h._cache) == 0
    a2 = r.standard_normal((m, k))
    c2 = np.zeros((m, n))
    _gemm(h, "N", "N", m, n, k, 1.0, a2, m, b, k, 0.0, c2, m,
          num_moduli=8, fastmode=True, skip_scalA=True)
    _bits_equal(c2, _jgemm(a2, b, num_moduli=8))
    # an entry found under a buffer's id but holding another buffer is not
    # served either
    a3 = r.standard_normal((m, k))
    (key, entry), = h._cache.items()
    h._cache[(id(a3),) + key[1:]] = entry
    c3 = np.zeros((m, n))
    _gemm(h, "N", "N", m, n, k, 1.0, a3, m, b, k, 0.0, c3, m,
          num_moduli=8, fastmode=True, skip_scalA=True)
    _bits_equal(c3, _jgemm(a3, b, num_moduli=8))


def test_compat_260_robust_mode_keeps_its_shifts():
    """compat.py:260 sends fastmode="robust" (and accurate mode) with a
    skip flag through the fast shifts; the port reuses planes only in fast
    mode proper, so those calls keep their own mode's bits."""
    m, n, k = 20, 16, 48
    r = np.random.default_rng(10)
    a = r.standard_normal((m, k)) * np.logspace(-3, 3, k)
    b = r.standard_normal((k, n))
    for mode in ("robust", False):
        h = compat.create()
        c = np.zeros((m, n))
        _gemm(h, "N", "N", m, n, k, 1.0, a, m, b, k, 0.0, c, m,
              num_moduli=7, fastmode=mode, enable_skip_scalA=True)
        _bits_equal(c, _jgemm(a, b, num_moduli=7, fastmode=mode))
        assert len(h._cache) == 0


@pytest.mark.parametrize("flags", [dict(enable_skip_scalA=True),
                                   dict(enable_skip_scalB=True,
                                        skip_scalB=True)])
def test_compat_263_skip_flags_keep_alpha_beta_bits(flags):
    """compat.py:263: setting a skip flag sent alpha and beta through an
    unfused epilogue, so the bits changed with the flag. The port applies
    them through gemm's own epilogue on every route."""
    m, n, k = 24, 18, 32
    r = np.random.default_rng(12)
    a, b, c0 = (r.standard_normal(s) for s in ((m, k), (k, n), (m, n)))
    want = _jgemm(a, b, num_moduli=8, alpha=-1.5, beta=1.2,
                  c=jnp.asarray(c0))
    for h in (None, compat.create()):
        c = c0.copy()
        _gemm(h, "N", "N", m, n, k, -1.5, a, m, b, k, 1.2, c, m,
              num_moduli=8, fastmode=True, **flags)
        _bits_equal(c, want)
