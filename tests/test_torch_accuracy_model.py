"""The port's accuracy model and num_moduli chooser against gemmul8_tpu's,
over the whole grid: log2_P for every num_moduli and backend,
modeled_max_rel_err for every (num_moduli, backend, fastmode, output dtype,
spread), and choose_moduli for every (dtype, backend) over targets, spreads
and margins, including the settings both refuse. Tolerance 0: every answer
is the same float (inf included), the same choice, or the same error."""
import math

import numpy as np
import pytest

import gemmul8_tpu as g8
import gemmul8_tpu_torch as gt
from gemmul8_tpu import accuracy_model as jam
from gemmul8_tpu_torch import accuracy_model as tam

BACKENDS = ["INT8", "FP8"]
DTYPES = [np.float64, np.float32, np.complex128, np.complex64]
SPREADS = [0.0, 1.0, 2.75, 5.5, 8.0, 8.5, 11.0, 22.0]


def _same_outcome(fn_t, fn_j):
    """Both return the same value, or both raise the same error."""
    try:
        ref = fn_j()
    except (ValueError, TypeError) as e:
        with pytest.raises(type(e)) as got:
            fn_t()
        assert str(got.value) == str(e)
        return None
    got = fn_t()
    assert got == ref and type(got).__name__ == type(ref).__name__
    return got


def test_exports_and_constants():
    assert gt.choose_moduli is tam.choose_moduli
    assert gt.modeled_max_rel_err is tam.modeled_max_rel_err
    for name in ("CALIBRATED_C", "SPREAD_FACTOR", "FAST_SPREAD_LIMIT",
                 "BITS_PER_PHI", "NATIVE_ERR_BITS",
                 "FLOOR_AMPLIFICATION_BITS", "FLOOR_SPREAD_CAP"):
        assert getattr(tam, name) == getattr(jam, name)
    assert tam.ModuliChoice._fields == jam.ModuliChoice._fields


@pytest.mark.parametrize("backend", BACKENDS)
def test_log2_p_every_num_moduli(backend):
    for nu in range(0, 22):
        _same_outcome(lambda: tam.log2_P(nu, backend),
                      lambda: jam.log2_P(nu, backend))


@pytest.mark.parametrize("fastmode", [True, "robust", False])
@pytest.mark.parametrize("backend", BACKENDS)
def test_modeled_max_rel_err_grid(backend, fastmode):
    seen_inf = False
    for nu in range(1, 21):
        for dtype in DTYPES:
            for spread in SPREADS:
                kw = dict(backend=backend, spread_bits=spread,
                          out_dtype=dtype, fastmode=fastmode)
                got = _same_outcome(
                    lambda: tam.modeled_max_rel_err(nu, **kw),
                    lambda: jam.modeled_max_rel_err(nu, **kw))
                seen_inf |= got == math.inf
    # fast mode past its calibrated spread is refused as inf
    assert seen_inf == (fastmode is True)


def test_modeled_max_rel_err_bad_fastmode():
    _same_outcome(lambda: tam.modeled_max_rel_err(8, fastmode="fast"),
                  lambda: jam.modeled_max_rel_err(8, fastmode="fast"))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_choose_moduli_grid(dtype, backend):
    targets = [None, 2.0 ** -52, 1e-15, 2.0 ** -40, 1e-9, 2.0 ** -20, 1e-4,
               1e-2, 0.5, 0.0, -1.0]
    chosen = set()
    for target in targets:
        for spread in (0.0, 2.75, 5.5, 11.0):
            for margin in (0.0, 3.0):
                kw = dict(dtype=dtype, backend=backend, spread_bits=spread,
                          margin_bits=margin)
                got = _same_outcome(lambda: tam.choose_moduli(target, **kw),
                                    lambda: jam.choose_moduli(target, **kw))
                if got is not None:
                    assert isinstance(got, tam.ModuliChoice)
                    chosen.add((got.num_moduli, got.fastmode))
    assert len(chosen) > 1


def test_choose_moduli_bad_dtype():
    _same_outcome(lambda: tam.choose_moduli(dtype=np.int32),
                  lambda: jam.choose_moduli(dtype=np.int32))
    assert gt.choose_moduli() == tuple(g8.choose_moduli())


TORCH_DTYPES = [("float32", np.float32), ("float64", np.float64),
                ("complex64", np.complex64), ("complex128", np.complex128)]


@pytest.mark.parametrize("tname,npdt", TORCH_DTYPES)
def test_choose_moduli_accepts_torch_dtypes(tname, npdt):
    """The solvers pass a tensor's dtype (solve and posv's refinement):
    torch's four dtypes answer as their numpy names do, targets and errors
    alike; a numpy dtype keeps working."""
    import torch
    t = getattr(torch, tname)
    assert tam.choose_moduli(dtype=t) == tam.choose_moduli(
        dtype=np.dtype(npdt)) == jam.choose_moduli(dtype=npdt)
    for target in (1e-6, 2.0 ** -40):
        _same_outcome(lambda: tam.choose_moduli(target, dtype=t),
                      lambda: jam.choose_moduli(target, dtype=npdt))


@pytest.mark.parametrize("tname,npdt", TORCH_DTYPES)
def test_modeled_max_rel_err_accepts_torch_dtypes(tname, npdt):
    import torch
    t = getattr(torch, tname)
    for nu in (6, 14, 17):
        assert tam.modeled_max_rel_err(nu, out_dtype=t) == \
            tam.modeled_max_rel_err(nu, out_dtype=np.dtype(npdt)) == \
            jam.modeled_max_rel_err(nu, out_dtype=npdt)


def test_other_torch_dtypes_still_refused():
    import torch
    with pytest.raises(TypeError):
        tam.choose_moduli(dtype=torch.int32)
