"""The debug tier's small-shape sweep (tests/test_debug_sweep.py, after the
reference's debug/test.cu:14-27, 247-299) on gemmul8_tpu_torch: odd sizes
straddling tile boundaries, the op pairs rotated across shapes, nontrivial
alpha/beta, fast and accurate mode, all four dtypes, against the native
product with the same criterion (relative error far below 1). The first case
of each dtype and mode is also held bit for bit against gemmul8_tpu; the rest
run on the port alone, so that the JAX compiles stay few."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest

import gemmul8_tpu as g8
import gemmul8_tpu_torch as gt


def _mk(rng, m, n, dtype):
    x = rng.standard_normal((m, n)) * np.exp(rng.standard_normal((m, n)))
    if np.issubdtype(dtype, np.complexfloating):
        x = x + 1j * (rng.standard_normal((m, n))
                      * np.exp(rng.standard_normal((m, n))))
    return x.astype(dtype)


def _op(x, t):
    if t == "T":
        return x.T
    if t == "C":
        return x.conj().T
    return x


@pytest.mark.parametrize("dtype,nu", [(np.float32, 8), (np.float64, 12),
                                      (np.complex64, 8), (np.complex128, 12)])
@pytest.mark.parametrize("fastmode", [True, False])
def test_odd_shapes_ops_alphabeta(dtype, nu, fastmode):
    rng = np.random.default_rng(2024)
    is_cplx = np.issubdtype(dtype, np.complexfloating)
    ops = ["N", "T", "C"] if is_cplx else ["N", "T"]
    shapes = [(33, 47, 41), (1, 37, 1), (40, 1, 44), (47, 45, 33)]
    ab_pairs = [(1.0, 0.0), (-1.0, 1.0), (-1.5, 1.2)]
    if is_cplx:
        ab_pairs.append((1.5 - 0.5j, -0.25 + 1.0j))
    op_pairs = list(itertools.product(ops, ops))
    cases = [(s, *op_pairs[(i * 2 + j) % len(op_pairs)])
             for i, s in enumerate(shapes) for j in range(2)]
    for n_case, ((m, k, n), ta, tb) in enumerate(cases):
        a_shape = (k, m) if ta != "N" else (m, k)
        b_shape = (n, k) if tb != "N" else (k, n)
        a, b = _mk(rng, *a_shape, dtype), _mk(rng, *b_shape, dtype)
        alpha, beta = ab_pairs[(m + ord(ta) + ord(tb)) % len(ab_pairs)]
        c0 = _mk(rng, m, n, dtype)
        kw = dict(num_moduli=nu, fastmode=fastmode, alpha=alpha, beta=beta,
                  trans_a=ta, trans_b=tb)
        got = gt.gemm(a, b, c=c0, device="cpu", **kw).numpy()
        if n_case == 0:
            ref = np.asarray(g8.gemm(jnp.asarray(a), jnp.asarray(b),
                                     c=jnp.asarray(c0), **kw))
            assert got.dtype == ref.dtype and got.shape == ref.shape
            np.testing.assert_array_equal(got.view(np.uint8),
                                          ref.view(np.uint8))
        want = alpha * (_op(a, ta).astype(np.complex128 if is_cplx
                                          else np.float64) @ _op(b, tb)) \
            + beta * c0
        denom = np.maximum(np.abs(want), np.abs(alpha)
                           * np.abs(_op(np.abs(a), ta)) @ np.abs(_op(np.abs(b),
                                                                     tb))
                           + 1e-30)
        rel = np.max(np.abs(got - want) / denom)
        assert rel < 1e-4, (dtype, nu, fastmode, (m, k, n), ta, tb, rel)
