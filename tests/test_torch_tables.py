"""gemmul8_tpu_torch.tables: every accessor bit-equal to gemmul8_tpu.tables.

The constant tables are the state the two packages share: the port keeps a
verbatim copy of the literals it reads, and this test holds each value to
the JAX package's for every num_moduli and both backends."""
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
