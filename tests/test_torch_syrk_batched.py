"""syrk and the batched GEMMs of gemmul8_tpu_torch against gemmul8_tpu on the
CPU, bit for bit: syrk in its three modes (fast, the default "robust",
accurate) on INT8 and FP8 with trans and alpha/beta/C; gemm_batched on real
and complex operands and gemm_batched_planar, fast and accurate (the JAX
twins vmap emulate_matmul); plus their argument errors and the device rule.
One shape per entry: XLA:CPU compiles dominate their time."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gemmul8_tpu as g8
import gemmul8_tpu_torch as gt
from gemmul8_tpu import complex_gemm as jcg


def _bits_equal(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got.view(np.uint8), ref.view(np.uint8))


def _phi(rng, shape, dtype=np.float64):
    x = (rng.random(shape) - 0.5) * np.exp(rng.standard_normal(shape))
    return x.astype(dtype)


M, K = 30, 70
SYRK = [
    # backend, nu, fastmode, trans, alpha, beta, epilogue
    ("INT8", 16, "robust", False, 1.0, 0.0, "auto"),
    ("INT8", 16, True, True, -1.5, 0.5, "ff"),
    ("INT8", 16, False, False, -1.5, 1.0, "auto"),
    ("FP8", 14, "robust", True, 1.0, 0.0, "auto"),
    ("FP8", 14, True, False, 2.0, 0.5, "auto"),
    ("FP8", 14, False, False, -1.5, 0.5, "ff"),
]


@pytest.mark.parametrize("backend,nu,fastmode,trans,alpha,beta,epilogue",
                         SYRK)
def test_syrk_bit_equal(backend, nu, fastmode, trans, alpha, beta, epilogue):
    rng = np.random.default_rng(nu + len(str(fastmode)))
    a = _phi(rng, (K, M) if trans else (M, K))
    c = _phi(rng, (M, M))
    kw = dict(num_moduli=nu, fastmode=fastmode, backend=backend, trans=trans,
              alpha=alpha, beta=beta, epilogue=epilogue)
    ref = g8.syrk(jnp.asarray(a), c=jnp.asarray(c), **kw)
    got = gt.syrk(a, c=c, device="cpu", **kw)
    _bits_equal(got, ref)
    # syrk equals gemm(A, A.T) with shared shifts; in accurate mode both
    # sides' shifts come from the same symmetric bound, so the two agree
    if fastmode is False:
        ab = gt.gemm(a, a.T.copy(), num_moduli=nu, fastmode=False,
                     backend=backend, device="cpu")
        _bits_equal(gt.syrk(a, num_moduli=nu, fastmode=False,
                            backend=backend, device="cpu"), ab)


def test_syrk_f32_and_default_mode():
    rng = np.random.default_rng(4)
    a = _phi(rng, (M, K), np.float32)
    _bits_equal(gt.syrk(a, num_moduli=8, device="cpu"),
                g8.syrk(jnp.asarray(a), num_moduli=8))


BATCHED = [
    # dtype, nu, fastmode, backend
    (np.float64, 16, True, "INT8"),
    (np.float32, 8, False, "INT8"),
    (np.float64, 14, False, "FP8"),
    (np.complex128, 16, False, "INT8"),
    (np.complex64, 8, True, "INT8"),
]


@pytest.mark.parametrize("dtype,nu,fastmode,backend", BATCHED)
def test_gemm_batched_bit_equal(dtype, nu, fastmode, backend):
    rng = np.random.default_rng(nu)
    shape_a, shape_b = (3, 20, 36), (3, 36, 12)
    a, b = _phi(rng, shape_a), _phi(rng, shape_b)
    if np.issubdtype(dtype, np.complexfloating):
        a = a + 1j * _phi(rng, shape_a)
        b = b + 1j * _phi(rng, shape_b)
    a, b = a.astype(dtype), b.astype(dtype)
    kw = dict(num_moduli=nu, fastmode=fastmode, backend=backend)
    ref = g8.gemm_batched(jnp.asarray(a), jnp.asarray(b), **kw)
    got = gt.gemm_batched(a, b, device="cpu", **kw)
    _bits_equal(got, ref)
    # each batch element is the 2-D product
    for i in range(a.shape[0]):
        _bits_equal(got[i], gt.gemm(a[i], b[i], device="cpu", **kw))


def test_gemm_batched_planar_bit_equal():
    rng = np.random.default_rng(7)
    ar, ai = _phi(rng, (2, 20, 36)), _phi(rng, (2, 20, 36))
    br, bi = _phi(rng, (2, 36, 12)), _phi(rng, (2, 36, 12))
    kw = dict(num_moduli=16, fastmode=False)
    ref_r, ref_i = jcg.gemm_batched_planar(
        *map(jnp.asarray, (ar, ai, br, bi)), **kw)
    got_r, got_i = gt.gemm_batched_planar(ar, ai, br, bi, device="cpu", **kw)
    _bits_equal(got_r, ref_r)
    _bits_equal(got_i, ref_i)
    # the same bits as the complex entry on complex views of the data
    got = gt.gemm_batched(ar + 1j * ai, br + 1j * bi, device="cpu", **kw)
    _bits_equal(got.real.contiguous(), got_r)
    _bits_equal(got.imag.contiguous(), got_i)


def test_gemm_batched_edges():
    a = np.ones((0, 4, 8))
    b = np.ones((0, 8, 3))
    out = gt.gemm_batched(a, b, device="cpu")
    assert out.shape == (0, 4, 3) and out.dtype == torch.float64
    out = gt.gemm_batched(np.ones((2, 4, 0)), np.ones((2, 0, 3)),
                          fastmode=False, device="cpu")
    assert out.shape == (2, 4, 3) and not out.any()
    re, im = gt.gemm_batched_planar(a, a, b, b, device="cpu")
    assert re.shape == im.shape == (0, 4, 3)
    out = gt.gemm_batched(a.astype(np.complex64), b.astype(np.complex64),
                          device="cpu")
    assert out.shape == (0, 4, 3) and out.dtype == torch.complex64
    # complex FP8 (queue 8), once refused here, takes an empty batch too
    re, im = gt.gemm_batched_planar(a, a, b, b, backend="FP8", device="cpu")
    assert re.shape == im.shape == (0, 4, 3)


@pytest.mark.parametrize("kind,backend,fastmode", [
    ("real", "INT8", False), ("real", "FP8", False),
    ("real", "INT8", "robust"), ("complex", "INT8", False),
    ("complex", "INT8", True)])
def test_symmetric_shifts_are_the_general_ones(kind, backend, fastmode):
    """The shifts syrk and herk take (b=None: the rhs is A.T, or A^H) are
    those of the general product with the rhs spelled out, on both sides;
    and accurate mode's three stages give the shifts the entries take."""
    from gemmul8_tpu_torch import complex_gemm as tcg, core
    rng = np.random.default_rng(11)
    ar, ai = (torch.from_numpy(_phi(rng, (M, K))) for _ in range(2))
    if kind == "real":
        mod, a, b = core, ar, ar.T.contiguous()
    else:
        mod, a, b = tcg, (ar, ai), (ar.T.contiguous(), -ai.T.contiguous())
    sym = mod.shifts(a, None, 16, fastmode, backend)
    full = mod.shifts(a, b, 16, fastmode, backend)
    assert all(torch.equal(x, y) for x, y in zip(sym, full))
    ext = mod.accurate_extract(a, None, backend)
    staged = mod.accurate_combine(mod.accurate_estimate(ext, backend), ext,
                                  16, backend)
    accurate = mod.shifts(a, None, 16, False, backend)
    assert all(torch.equal(x, y) for x, y in zip(staged, accurate))


def test_syrk_batched_errors_and_device_rule():
    a = np.ones((4, 8))
    with pytest.raises(ValueError, match="2-D"):
        gt.syrk(np.ones(8), device="cpu")
    with pytest.raises(NotImplementedError, match="real-only"):
        gt.syrk(a.astype(np.complex128), device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        gt.syrk(a, num_moduli=21, device="cpu")
    with pytest.raises(ValueError, match="backend"):
        gt.syrk(a, backend="int8", device="cpu")
    with pytest.raises(TypeError, match="dtype mismatch"):
        gt.syrk(a, beta=0.5, c=np.ones((4, 4), np.float32), device="cpu")
    with pytest.raises(ValueError, match=r"\(B, m, k\)"):
        gt.gemm_batched(a, a.T.copy(), device="cpu")
    with pytest.raises(ValueError, match=r"\(B, m, k\)"):
        gt.gemm_batched(a[None], a[None], device="cpu")
    with pytest.raises(TypeError, match="dtype mismatch"):
        gt.gemm_batched(a[None], a.T[None].astype(np.float32), device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        gt.gemm_batched(a[None], a.T[None].copy(), num_moduli=1,
                        device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        gt.gemm_batched_planar(a[None], a[None], a.T[None].copy(),
                               a.T[None].copy(), num_moduli=21, device="cpu")
    # complex FP8 (queue 8), once refused here, gives gemmul8_tpu's bits
    ca = a.astype(np.complex128)[None]
    cb = ca.transpose(0, 2, 1).copy()
    _bits_equal(gt.gemm_batched(ca, cb, backend="FP8", device="cpu"),
                g8.gemm_batched(jnp.asarray(ca), jnp.asarray(cb),
                                backend="FP8"))
    if torch.cuda.is_available():
        assert gt.syrk(a).device.type == "cuda"
        assert gt.gemm_batched(a[None], a.T[None].copy()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            gt.syrk(a)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            gt.gemm_batched(a[None], a.T[None].copy())
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            gt.gemm_batched_planar(a[None], a[None], a.T[None].copy(),
                                   a.T[None].copy())
