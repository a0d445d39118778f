"""gemmul8_tpu_torch.tables: every accessor bit-equal to gemmul8_tpu.tables.

The constant tables are the state the two packages share: the port keeps a
verbatim copy of the whole generated table, and this test holds each row
and each accessor's value to the JAX package's for every num_moduli and
both backends."""
from fractions import Fraction

import numpy as np
import pytest

from gemmul8_tpu import tables as jt
from gemmul8_tpu_torch import tables as tt

BACKENDS = ["INT8", "FP8"]


def _bits(v):
    return np.asarray(v, np.float64).view(np.uint64)


def test_constants():
    assert tt.NUM_MODULI_MAX == jt.NUM_MODULI_MAX
    assert tt.MAX_EXP == jt.MAX_EXP
    assert tt.NOT_KARATSUBA == jt.NOT_KARATSUBA
    assert tt.VALID_RANGE == jt.VALID_RANGE
    assert (tt.Backend.INT8, tt.Backend.FP8) == (jt.Backend.INT8, jt.Backend.FP8)


@pytest.mark.parametrize("backend", BACKENDS)
def test_moduli_and_thresholds(backend):
    assert tt.moduli(backend) == jt.moduli(backend)
    assert tt.p_is_double(backend) == jt.p_is_double(backend)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("nu", range(2, 21))
def test_accessors_bit_equal(backend, nu):
    for name in ("P_dd", "P_q26", "invP", "log2P", "qPi_f64", "qPi_dd"):
        got = getattr(tt, name)(nu, backend)
        ref = getattr(jt, name)(nu, backend)
        assert np.shape(got) == np.shape(ref), name
        np.testing.assert_array_equal(_bits(got), _bits(ref), err_msg=name)


# the rest of the tables: the plane count, 2^j mod p, the f32 expansions of
# qPi and P, 1/P's f32-table value, and the data module row by row

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("nu", range(2, 21))
def test_f32x_accessors_bit_equal(backend, nu):
    for name in ("qPi_f32x", "P_f32x", "invP_f32"):
        got = getattr(tt, name)(nu, backend)
        ref = getattr(jt, name)(nu, backend)
        assert type(got) is type(ref), name
        assert np.shape(got) == np.shape(ref), name
        np.testing.assert_array_equal(_bits(got), _bits(ref), err_msg=name)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("nu", range(2, 21))
def test_num_mat(backend, nu):
    assert tt.num_mat(nu, backend) == jt.num_mat(nu, backend)
    # INT8: one plane per modulus; FP8: two per square modulus, three per
    # Karatsuba one (tests/test_tables.py's values)
    want = nu if backend == "INT8" else (
        2 * min(nu, 6) + 3 * max(nu - 6, 0))
    assert tt.num_mat(nu, backend) == want


@pytest.mark.parametrize("bad", ["int8", "fp8", "BF16", ""])
def test_num_mat_rejects_backend(bad):
    with pytest.raises(ValueError) as got:
        tt.num_mat(8, bad)
    with pytest.raises(ValueError) as ref:
        jt.num_mat(8, bad)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("backend", BACKENDS)
def test_mod_pow2(backend):
    """Bit-equal to JAX's, and tests/test_tables.py's congruence check:
    every entry is 2^j mod p wrapped into [-p/2, p/2]."""
    got, ref = tt.mod_pow2(backend), jt.mod_pow2(backend)
    assert got.dtype == ref.dtype == np.int32 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    mods = tt.moduli(backend)
    for i, p in enumerate(mods):
        for j in range(tt.MAX_EXP + 1):
            r = int(got[i, j])
            assert (r - pow(2, j, p)) % p == 0
            assert -p // 2 <= r <= p // 2


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("nu", range(2, 21))
def test_qPi_f32x_expansion(backend, nu):
    """tests/test_tables.py's check on every nu and backend: the 4-term
    expansion sums to the f64 qPi (the exact sum, rounded once: numpy's
    f64 sum rounds at each add and is 1 ulp off for FP8 nu=16's modulus
    11), and each term holds at most 24 significant bits."""
    q = tt.qPi_f32x(nu, backend)
    exact = [float(sum(Fraction(float(v)) for v in row)) for row in q]
    np.testing.assert_array_equal(exact, tt.qPi_f64(nu, backend))
    for v in q.reshape(-1)[q.reshape(-1) != 0]:
        scaled = v * 2.0 ** (23 - np.floor(np.log2(abs(v))))
        assert scaled == np.round(scaled)


def test_sqrt_moduli_from_the_table():
    """fp8._sqrt_moduli reads SQRT_MODULI_FP8: the same roots the JAX
    package computes from the moduli."""
    from gemmul8_tpu import fp8 as jfp8
    from gemmul8_tpu_torch import fp8 as tfp8
    got = tfp8._sqrt_moduli()
    assert got == jfp8._sqrt_moduli()
    assert got == tuple(int(np.sqrt(p) + 0.5)
                        for p in tt.moduli("FP8")[:tt.NOT_KARATSUBA])
    assert all(q * q == p for q, p in zip(got, tt.moduli("FP8")))


def _data_names():
    from gemmul8_tpu import _tables_data as jd
    return sorted(n for n in vars(jd) if n.isupper())


@pytest.mark.parametrize("name", _data_names())
def test_data_module_is_whole(name):
    """Every row of the JAX package's generated table is in the port's,
    with the same values bit for bit."""
    from gemmul8_tpu import _tables_data as jd
    from gemmul8_tpu_torch import _tables_data as td
    got, ref = getattr(td, name), getattr(jd, name)

    def leaves(v):
        # (type, value) of each leaf in order; floats by their hex digits,
        # so that -0.0 and 0.0 differ
        if isinstance(v, list):
            return [("list", len(v))] + [x for e in v for x in leaves(e)]
        return [(type(v).__name__, v.hex() if isinstance(v, float) else v)]

    assert leaves(got) == leaves(ref)
