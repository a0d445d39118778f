"""The port's BLAS level 3 on the emulated GEMM (syr2k, her2k, symm, hemm
and the planar her2k, symm and hemm) against gemmul8_tpu.blas3 on the CPU
under x64, bit for bit (tolerance 0), on the INT8 and the FP8 backend
(complex FP8 included), with both triangles, both sides, trans, alpha and
beta; the symmetry each routine promises; and the error surface. Small
shapes and small num_moduli: XLA:CPU compiles dominate the time."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gemmul8_tpu as g8
import gemmul8_tpu_torch as gt

C128, C64 = np.complex128, np.complex64


def _bits_equal(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got.view(np.uint8), ref.view(np.uint8))


def _rand(rng, shape, dtype):
    x = rng.standard_normal(shape) * np.exp(rng.standard_normal(shape))
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dtype)


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


@pytest.mark.parametrize("dtype,backend,trans,alpha,beta", [
    (np.float64, "INT8", False, -1.5, 0.5),
    (np.float32, "FP8", True, 1.0, 1.0),
])
def test_syr2k_bit_equal(dtype, backend, trans, alpha, beta):
    rng = np.random.default_rng(1)
    shape = (24, 11) if trans else (11, 24)
    a, b = _rand(rng, shape, dtype), _rand(rng, shape, dtype)
    c = _rand(rng, (shape[trans], shape[trans]), dtype)
    kw = dict(trans=trans, num_moduli=6, backend=backend, alpha=alpha,
              beta=beta)
    ref = g8.syr2k(*_j(a, b), c=jnp.asarray(c), **kw)
    got = gt.syr2k(a, b, c=c, device="cpu", **kw)
    _bits_equal(got, ref)
    g = gt.syr2k(a, b, device="cpu", **kw)
    assert torch.equal(g, g.T)


@pytest.mark.parametrize("dtype,backend,trans,alpha,beta", [
    (C128, "INT8", False, 0.5 - 1.25j, 0.75),
    (C64, "FP8", True, 1.0, 1.0),
])
def test_her2k_bit_equal(dtype, backend, trans, alpha, beta):
    rng = np.random.default_rng(2)
    shape = (20, 9) if trans else (9, 20)
    a, b = _rand(rng, shape, dtype), _rand(rng, shape, dtype)
    c = _rand(rng, (shape[trans], shape[trans]), dtype)
    kw = dict(trans=trans, num_moduli=6, backend=backend, alpha=alpha,
              beta=beta)
    ref = g8.her2k(*_j(a, b), c=jnp.asarray(c), **kw)
    got = gt.her2k(a, b, c=c, device="cpu", **kw)
    _bits_equal(got, ref)
    h = gt.her2k(a, b, device="cpu", **kw)
    assert torch.equal(h, h.conj().T.resolve_conj())
    assert not h.diagonal().imag.any()


@pytest.mark.parametrize("dtype,backend,side,lower,alpha,beta", [
    (np.float64, "INT8", "left", True, 1.0, 0.0),
    (C128, "FP8", "right", False, 2.0 - 0.5j, -0.25),
])
def test_symm_bit_equal(dtype, backend, side, lower, alpha, beta):
    rng = np.random.default_rng(3)
    na, nb = 13, 7
    a = _rand(rng, (na, na), dtype)
    b = _rand(rng, (na, nb) if side == "left" else (nb, na), dtype)
    c = _rand(rng, b.shape, dtype)
    kw = dict(side=side, lower=lower, num_moduli=6, backend=backend,
              alpha=alpha, beta=beta)
    ref = g8.symm(*_j(a, b), c=jnp.asarray(c), **kw)
    _bits_equal(gt.symm(a, b, c=c, device="cpu", **kw), ref)
    # only the stored triangle is read
    other = np.triu(a, 1) if lower else np.tril(a, -1)
    _bits_equal(gt.symm(a - 7 * other, b, c=c, device="cpu", **kw), ref)


@pytest.mark.parametrize("dtype,backend,side,lower", [
    (C128, "INT8", "left", True),
    (C64, "FP8", "right", False),
])
def test_hemm_bit_equal(dtype, backend, side, lower):
    rng = np.random.default_rng(4)
    na, nb = 12, 5
    a = _rand(rng, (na, na), dtype)
    b = _rand(rng, (na, nb) if side == "left" else (nb, na), dtype)
    c = _rand(rng, b.shape, dtype)
    kw = dict(side=side, lower=lower, num_moduli=6, backend=backend,
              alpha=-1.0 + 0.5j, beta=1.0)
    ref = g8.hemm(*_j(a, b), c=jnp.asarray(c), **kw)
    _bits_equal(gt.hemm(a, b, c=c, device="cpu", **kw), ref)
    # the stored diagonal's imaginary part is not read
    a2 = a + 3j * np.diag(np.ones(na)).astype(dtype)
    _bits_equal(gt.hemm(a2, b, c=c, device="cpu", **kw), ref)


@pytest.mark.parametrize("backend", ["INT8", "FP8"])
def test_planar_forms_bit_equal(backend):
    rng = np.random.default_rng(5)
    a, b = _rand(rng, (10, 18), C128), _rand(rng, (10, 18), C128)
    sq = _rand(rng, (10, 10), C128)
    planes = lambda x: (np.ascontiguousarray(x.real),  # noqa: E731
                        np.ascontiguousarray(x.imag))
    kw = dict(num_moduli=6, backend=backend)
    ref = g8.her2k_planar(*_j(*planes(a), *planes(b)), alpha=0.5 + 2j, **kw)
    got = gt.her2k_planar(*planes(a), *planes(b), alpha=0.5 + 2j,
                          device="cpu", **kw)
    for g, r in zip(got, ref):
        _bits_equal(g, r)
    assert torch.equal(got[0], got[0].T) and torch.equal(got[1], -got[1].T)
    for name, side, lower in (("symm_planar", "left", False),
                              ("hemm_planar", "right", True)):
        rhs = a if side == "left" else a.T.copy()
        ref = getattr(g8, name)(*_j(*planes(sq), *planes(rhs)), side=side,
                                lower=lower, **kw)
        got = getattr(gt, name)(*planes(sq), *planes(rhs), side=side,
                                lower=lower, device="cpu", **kw)
        for g, r in zip(got, ref):
            _bits_equal(g, r)
    # hemm_planar equals hemm on complex views
    whole = gt.hemm(sq, a.T.copy(), side="right", lower=True, device="cpu",
                    **kw)
    assert torch.equal(torch.complex(*got), whole)


def test_blas3_error_surface():
    a = np.ones((4, 6))
    ca = a.astype(C128)
    with pytest.raises(TypeError, match="real-only"):
        gt.syr2k(ca, ca, device="cpu")
    with pytest.raises(TypeError, match="complex-only"):
        gt.her2k(a, a, device="cpu")
    with pytest.raises(ValueError, match="beta must be real"):
        gt.her2k(ca, ca, beta=1 + 1j, c=np.ones((4, 4), C128), device="cpu")
    with pytest.raises(TypeError, match="complex-only"):
        gt.hemm(np.ones((4, 4)), a, device="cpu")
    with pytest.raises(ValueError, match="square"):
        gt.symm(a, a, device="cpu")
    with pytest.raises(ValueError, match="side"):
        gt.symm(np.ones((4, 4)), a, side="top", device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        gt.symm(np.ones((6, 6)), a, device="cpu")
    with pytest.raises(ValueError, match="2-D"):
        gt.symm(np.ones((4, 4)), np.ones(4), device="cpu")
    with pytest.raises(ValueError, match="square"):
        gt.hemm_planar(a, a, a, a, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            gt.syr2k(a, a)
