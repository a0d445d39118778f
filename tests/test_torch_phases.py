"""gemm_with_phases of gemmul8_tpu_torch on the CPU: its C equals gemm's
bits (and the JAX package's gemm_with_phases C) in each mode, backend and
epilogue, K-chunked shapes included; the four phases are there, each >= 0
with a positive sum (a single phase can read 0 on a fast clock, so no
phase is required to be positive alone)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gemmul8_tpu as g8
import gemmul8_tpu_torch as gt
from gemmul8_tpu_torch import core


def _bits_equal(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got.view(np.uint8), ref.view(np.uint8))


def _check_phases(phases):
    assert tuple(phases) == core.PHASES
    assert all(t >= 0 for t in phases.values())
    assert sum(phases.values()) > 0


@pytest.mark.parametrize("dtype,nu,backend,fastmode,epilogue", [
    ("float64", 9, "INT8", True, "auto"),
    ("float32", 6, "INT8", "robust", "ff"),
    ("float64", 9, "INT8", False, "ff"),
    ("float64", 6, "FP8", True, "auto"),
    ("float32", 5, "FP8", True, "ff"),
])
def test_phases_c_equals_gemm(dtype, nu, backend, fastmode, epilogue):
    rng = np.random.default_rng(201)
    a = rng.standard_normal((33, 70)).astype(dtype)
    b = rng.standard_normal((70, 21)).astype(dtype)
    kw = dict(num_moduli=nu, backend=backend, fastmode=fastmode,
              epilogue=epilogue)
    c, phases = gt.gemm_with_phases(a, b, device="cpu", **kw)
    _check_phases(phases)
    _bits_equal(c, gt.gemm(a, b, device="cpu", **kw))
    jc, _ = g8.gemm_with_phases(jnp.asarray(a), jnp.asarray(b), **kw)
    _bits_equal(c, jc)


@pytest.mark.parametrize("backend,nu,k", [("INT8", 8, (1 << 17) + 96),
                                          ("FP8", 6, (1 << 16) + 96)])
def test_phases_k_chunked(backend, nu, k):
    """Past the exact K bound the matmul phase sums residues over K chunks
    and mod_reduce wraps the sums; C still equals gemm's bits."""
    rng = np.random.default_rng(202)
    a = rng.standard_normal((4, k))
    b = rng.standard_normal((k, 3))
    c, phases = gt.gemm_with_phases(a, b, num_moduli=nu, backend=backend,
                                    device="cpu")
    _check_phases(phases)
    _bits_equal(c, gt.gemm(a, b, num_moduli=nu, backend=backend,
                           device="cpu"))


def test_phases_iters_and_errors():
    rng = np.random.default_rng(203)
    a = torch.from_numpy(rng.standard_normal((8, 16)))
    b = torch.from_numpy(rng.standard_normal((16, 8)))
    c, phases = gt.gemm_with_phases(a, b, iters=3, device="cpu")
    _check_phases(phases)
    _bits_equal(c, gt.gemm(a, b, device="cpu"))
    with pytest.raises(ValueError, match="iters"):
        gt.gemm_with_phases(a, b, iters=0, device="cpu")
    with pytest.raises(TypeError, match="float32 and float64"):
        gt.gemm_with_phases(a.to(torch.complex128), b.to(torch.complex128),
                            device="cpu")
    with pytest.raises(ValueError, match="operands"):
        gt.gemm_with_phases(a, a, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            gt.gemm_with_phases(a, b)
