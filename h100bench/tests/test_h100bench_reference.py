"""The plain reference against exact products at tiny sizes, and the gap
it judges outputs by."""
from fractions import Fraction

import numpy as np
import pytest
import torch

from h100bench.reference import gemm as ref

U = 2.0 ** -53


def exact(a, b, c, alpha, beta):
    """alpha a b + beta c in exact rationals (real parts only)."""
    m, k = a.shape
    n = b.shape[1]
    out = np.empty((m, n), dtype=object)
    for i in range(m):
        for j in range(n):
            s = sum(Fraction(float(a[i, p])) * Fraction(float(b[p, j]))
                    for p in range(k))
            s = Fraction(alpha) * s
            if c is not None:
                s += Fraction(beta) * Fraction(float(c[i, j]))
            out[i, j] = s
    return out


@pytest.mark.parametrize("alpha, beta, with_c", [(1.0, 0.0, False),
                                                 (-1.0, 1.0, True)])
def test_integer_operands_give_the_exact_numpy_product(alpha, beta, with_c):
    rng = np.random.default_rng(5)
    a = rng.integers(-1000, 1000, (7, 33))
    b = rng.integers(-1000, 1000, (33, 5))
    c = rng.integers(-1000, 1000, (7, 5)) if with_c else None
    want = int(alpha) * (a @ b) + (int(beta) * c if with_c else 0)
    f64 = torch.float64
    got = ref.product(torch.tensor(a, dtype=f64), torch.tensor(b, dtype=f64),
                      None if c is None else torch.tensor(c, dtype=f64),
                      alpha, beta, f64)
    assert np.array_equal(got.numpy(), want.astype(np.float64))


def test_reference_within_float64_rounding_of_the_exact_product():
    rng = np.random.default_rng(6)
    a, b, c = (rng.standard_normal(s) for s in ((6, 40), (40, 4), (6, 4)))
    want = exact(a, b, c, -1.0, 1.0)
    got = ref.product(*(torch.tensor(x) for x in (a, b, c)), -1.0, 1.0,
                      torch.float64).numpy()
    bound = np.abs(a) @ np.abs(b) + np.abs(c)
    err = np.array([[abs(Fraction(float(got[i, j])) - want[i, j])
                     for j in range(4)] for i in range(6)], dtype=float)
    assert np.all(err <= 42 * U * bound)      # gamma_k with k + 2 roundings
    # the exact product rounded once is within an ulp-sized gap of it
    rounded = torch.tensor(want.astype(float))
    ops = {"a": torch.tensor(a), "b": torch.tensor(b), "c": torch.tensor(c)}
    mix = {"alpha": -1.0, "beta": 1.0}
    gap = ref.max_gap(rounded, ops, {"dtype": "float64"}, mix, block_rows=4)
    assert 0 < gap <= 42 * U


def test_complex_reference_matches_the_exact_product():
    rng = np.random.default_rng(7)
    ar, ai, br, bi = (rng.integers(-99, 99, s) for s in
                      ((5, 9), (5, 9), (9, 3), (9, 3)))
    want = (ar + 1j * ai) @ (br + 1j * bi)
    a = torch.complex(torch.tensor(ar, dtype=torch.float64),
                      torch.tensor(ai, dtype=torch.float64))
    b = torch.complex(torch.tensor(br, dtype=torch.float64),
                      torch.tensor(bi, dtype=torch.float64))
    got = ref.product(a, b, None, 1.0, 0.0, torch.complex128)
    assert np.array_equal(got.numpy(), want)
    gap = ref.max_gap(got, {"a": a, "b": b, "c": None},
                      {"dtype": "complex128"}, {"alpha": 1.0, "beta": 0.0})
    assert gap == 0.0


def test_gap_fails_nan_wrong_shape_and_differences_where_the_bound_is_0():
    a = torch.tensor([[1.0, 2.0], [0.0, 0.0]], dtype=torch.float64)
    b = torch.eye(2, dtype=torch.float64)
    ops, cfg = {"a": a, "b": b, "c": None}, {"dtype": "float64"}
    mix = {"alpha": 1.0, "beta": 0.0}
    assert ref.max_gap(a.clone(), ops, cfg, mix) == 0.0
    bad = a.clone()
    bad[0, 0] = float("nan")
    assert ref.max_gap(bad, ops, cfg, mix) == float("inf")
    bad = a.clone()
    bad[1, 1] = 1e-300                       # row 1 of A is 0: bound 0
    assert ref.max_gap(bad, ops, cfg, mix) > 1e7
    assert ref.max_gap(a[:1], ops, cfg, mix) == float("inf")
    assert ref.max_gap(a.float(), ops, cfg, mix) == float("inf")


def test_control_rounds_to_the_lower_precision():
    rng = np.random.default_rng(8)
    ops = {"a": torch.tensor(rng.standard_normal((16, 64))),
           "b": torch.tensor(rng.standard_normal((64, 8))), "c": None}
    cfg = {"dtype": "float64", "control_dtype": "float32"}
    mix = {"alpha": 1.0, "beta": 0.0}
    out = ref.control(cfg, mix)(ops)
    assert out.dtype == torch.float64
    gap = ref.max_gap(out, ops, cfg, mix)
    assert 2.0 ** -30 < gap < 2.0 ** -18
