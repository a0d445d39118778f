"""gemmul8_tpu_torch.gemm's BLAS semantics against gemmul8_tpu.gemm on the
CPU: transposes (bools and "N"/"T"/"C") and the alpha/beta classes, bit for
bit (XLA contracts alpha*ab + beta*c to an FMA whose operand depends on the
output dtype and epilogue; the port follows it). Plus the argument errors,
the NotImplementedError of each part not yet ported (and accurate mode, which
is), the device rule and the package's isolation from JAX."""
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gemmul8_tpu as g8
import gemmul8_tpu_torch as gt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NU = {np.float32: 8, np.float64: 16}


def _ops(seed, dtype):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((64, 24)).astype(dtype)     # used as A^T
    b = rng.standard_normal((64, 16)).astype(dtype)
    c = rng.standard_normal((24, 16)).astype(dtype)
    return a, b, c


CASES = [
    # dtype, epilogue, alpha, beta, trans_a, trans_b
    (np.float64, "f64", -1.5, 0.7, True, "N"),
    (np.float64, "ff", -1.5, 0.7, "T", False),
    (np.float32, "ff", -1.5, 0.7, "C", "n"),
    (np.float32, "f64", -1.5, 0.7, np.bool_(True), 0),
    (np.float64, "f64", 1.0, 0.7, "t", None),
    (np.float64, "ff", 1, 0.7, True, False),
    (np.float32, "ff", 1.0, 0.7, True, False),
    (np.float64, "ff", -1.5, 1.0, True, False),
    (np.float32, "f64", -1.5, 0.0, True, False),
]


@pytest.mark.parametrize("dtype,epilogue,alpha,beta,trans_a,trans_b", CASES)
def test_alpha_beta_trans_bit_equal(dtype, epilogue, alpha, beta, trans_a,
                                    trans_b):
    a, b, c = _ops(int(10 * alpha + 100 * beta) % 97, dtype)
    kw = dict(num_moduli=NU[dtype], alpha=alpha, beta=beta, trans_a=trans_a,
              trans_b=trans_b, epilogue=epilogue)
    ref = np.asarray(g8.gemm(jnp.asarray(a), jnp.asarray(b),
                             c=jnp.asarray(c), **kw))
    got = gt.gemm(a, b, c=c, device="cpu", **kw).numpy()
    assert got.dtype == ref.dtype and got.shape == (24, 16)
    np.testing.assert_array_equal(got.view(np.uint8), ref.view(np.uint8))


def test_beta_zero_never_reads_c():
    a, b, _ = _ops(9, np.float64)
    c = np.full((24, 16), np.nan)
    got = gt.gemm(a, b, trans_a=True, c=c, beta=0.0, device="cpu")
    assert torch.isfinite(got).all()


def test_argument_errors():
    a = np.ones((4, 8))
    b = np.ones((8, 3))
    with pytest.raises(ValueError, match="2-D"):
        gt.gemm(np.ones(8), b, device="cpu")
    with pytest.raises(TypeError, match="dtype mismatch"):
        gt.gemm(a, b.astype(np.float32), device="cpu")
    with pytest.raises(ValueError, match="backend"):
        gt.gemm(a, b, backend="int8", device="cpu")
    for nu in (1, 21):
        with pytest.raises(ValueError, match="out of range"):
            gt.gemm(a, b, num_moduli=nu, device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        gt.gemm(a.astype(np.float32), b.astype(np.float32), num_moduli=14,
                device="cpu")
    with pytest.raises(ValueError, match="trans_a"):
        gt.gemm(a, b, trans_a="X", device="cpu")
    with pytest.raises(ValueError, match="epilogue"):
        gt.gemm(a, b, epilogue="fast", device="cpu")


def test_unported_parts_raise_not_implemented():
    """The parts once refused here, naming their ROADMAP queue, now return
    gemmul8_tpu's bits: accurate mode (queue 5), striping (queue 6) and
    complex FP8 (queue 8)."""
    a = np.ones((4, 8))
    b = np.ones((8, 3))
    ca, cb = a.astype(np.complex128), b.astype(np.complex128)
    ref = np.asarray(g8.gemm(jnp.asarray(ca), jnp.asarray(cb), fastmode=False))
    got = gt.gemm(ca, cb, fastmode=False, device="cpu").numpy()
    np.testing.assert_array_equal(got.view(np.uint8), ref.view(np.uint8))
    ref = np.asarray(g8.gemm(jnp.asarray(ca), jnp.asarray(cb), backend="FP8"))
    got = gt.gemm(ca, cb, backend="FP8", device="cpu").numpy()
    np.testing.assert_array_equal(got.view(np.uint8), ref.view(np.uint8))
    # real operands take the FP8 backend
    assert float(gt.gemm(a, b, backend="FP8", device="cpu")[0, 0]) == 8.0
    ref = np.asarray(g8.gemm(jnp.asarray(a), jnp.asarray(b), fastmode=False))
    got = gt.gemm(a, b, fastmode=False, device="cpu").numpy()
    np.testing.assert_array_equal(got.view(np.uint8), ref.view(np.uint8))
    # m_block/n_block (queue 6), once refused here, now stripe the product
    # with the unstriped call's bits
    ref = gt.gemm(a, b, device="cpu").numpy()
    for kw in ({"m_block": 2}, {"n_block": 2}):
        got = gt.gemm(a, b, device="cpu", **kw).numpy()
        np.testing.assert_array_equal(got.view(np.uint8), ref.view(np.uint8))


def test_default_device_is_cuda_never_a_hidden_cpu():
    a = np.ones((32, 64))
    b = np.ones((64, 32))
    if torch.cuda.is_available():
        assert gt.gemm(a, b).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            gt.gemm(a, b)


def test_package_imports_neither_jax_nor_gemmul8_tpu():
    code = ("import sys, numpy as np\n"
            "import gemmul8_tpu_torch as g\n"
            "c = g.gemm(np.ones((4, 8)), np.ones((8, 3)), device='cpu')\n"
            "assert float(c[0, 0]) == 8.0\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'jaxlib', 'gemmul8_tpu.')) or m == 'gemmul8_tpu']\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_package_sources_do_not_name_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|gemmul8_tpu)\b",
                         re.MULTILINE)
    root = os.path.join(REPO, "gemmul8_tpu_torch")
    checked = 0
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name)) as f:
                    src = f.read()
                hits = [m.group(0) for m in pattern.finditer(src)]
                assert not hits, (name, hits)
                checked += 1
    assert checked >= 6
