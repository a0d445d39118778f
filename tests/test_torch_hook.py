"""The interposer of gemmul8_tpu_torch (hook: install/uninstall/refresh/
emulate, interop.torch_gemm/emulate_torch, models.mlp) on CPU tensors,
against gemmul8_tpu's hook on the same numpy inputs: outputs and real
gradients bit for bit, complex gradients equal to the JAX hook's
conjugated; the environment contract and the native fallthrough, batched
shapes, nn.Linear and the MLP (forward and backward emulated, no native
mm), the plane cache (off by default), worker threads, and the
conjugate- and negative-bit operands that gemmul8_tpu.interop fails on."""
import gc
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import gemmul8_tpu as g8
import gemmul8_tpu_torch as gt
from gemmul8_tpu.models import mlp as jmlp
from gemmul8_tpu_torch import hook, interop
from gemmul8_tpu_torch.models import mlp


@pytest.fixture(autouse=True)
def _clean_hook():
    yield
    gt.uninstall()
    g8.uninstall()
    hook.clear_plane_cache()
    for k in list(os.environ):
        if k.startswith("GEMMUL8_"):
            del os.environ[k]


def _bits_equal(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    got, ref = np.ascontiguousarray(got), np.ascontiguousarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got.view(np.uint8), ref.view(np.uint8))


def _rand(shape, seed, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _crand(shape, seed):
    r = np.random.default_rng(seed)
    return r.standard_normal(shape) + 1j * r.standard_normal(shape)


class _NativeMatmuls(TorchDispatchMode):
    """Counts the native matrix products that reach ATen."""
    OPS = ("mm", "addmm", "bmm", "baddbmm", "matmul", "dot", "mv")

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in self.OPS:
            self.count += 1
        return func(*args, **(kwargs or {}))


def test_context_manager_intercepts_matmul():
    a, b = _rand((32, 64), 0), _rand((64, 16), 1)
    direct = g8.gemm(jnp.asarray(a), jnp.asarray(b), num_moduli=10)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    with gt.emulate(num_moduli=10) as mode:
        outs = (ta @ tb, torch.matmul(ta, tb), torch.mm(ta, tb), ta.mm(tb),
                ta.matmul(tb))
    assert mode.intercepted == 5
    for out in outs:
        _bits_equal(out, direct)
    native = ta @ tb
    assert not torch.equal(native, outs[0])
    assert not hook.installed()


def test_env_var_config_and_fallthrough():
    a, b = _rand((16, 32), 2), _rand((32, 8), 3)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    native = ta @ tb
    gt.install()         # env-driven; no variable set -> everything native
    assert torch.equal(ta @ tb, native)
    os.environ["GEMMUL8_NUM_MOD_D"] = "9"
    gt.refresh()         # a no-op: the environment is read on every call
    _bits_equal(ta @ tb, g8.gemm(jnp.asarray(a), jnp.asarray(b),
                                 num_moduli=9))
    os.environ["GEMMUL8_NUM_MOD_D"] = "25"      # out of range: native
    assert torch.equal(ta @ tb, native)
    a32, b32 = ta.float(), tb.float()           # no GEMMUL8_NUM_MOD_S
    before = hook.COUNTS["emulated"]
    a32 @ b32
    assert hook.COUNTS["emulated"] == before
    os.environ["GEMMUL8_NUM_MOD_D"] = "9"
    os.environ["GEMMUL8_FASTMODE_D"] = "exact"
    with pytest.raises(ValueError, match="GEMMUL8_FASTMODE_D"):
        ta @ tb
    os.environ["GEMMUL8_FASTMODE_D"] = "robust"
    assert gt.env_config("float64") == gt.GemmConfig(9, "robust")


def test_batched_shapes_and_fallthrough():
    a, b = _rand((3, 24, 32), 4), _rand((3, 32, 8), 5)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    want = np.stack([np.asarray(g8.gemm(jnp.asarray(a[i]), jnp.asarray(b[i]),
                                        num_moduli=12)) for i in range(3)])
    with gt.emulate(num_moduli=12) as mode:
        for out in (ta @ tb, torch.bmm(ta, tb), ta.bmm(tb),
                    (ta[None] @ tb[None])[0]):
            _bits_equal(out, want)
        assert mode.intercepted == 4
        b2 = torch.from_numpy(_rand((32, 8), 6))
        bcast = ta @ b2                          # broadcast batch: native
        vec = ta[0] @ b2[:, 0]                   # vector: native
        i32 = torch.ones((4, 4), dtype=torch.int32)
        ints = i32 @ i32                         # integer: native
        half = ta[0].bfloat16() @ b2.bfloat16()  # half: native
        assert mode.intercepted == 4
    assert torch.equal(bcast, ta @ b2) and torch.equal(vec, ta[0] @ b2[:, 0])
    assert torch.equal(ints, torch.full((4, 4), 4, dtype=torch.int32))
    assert half.dtype == torch.bfloat16


def test_hooked_matmul_real_grads_match_jax():
    """The backward GEMMs are emulated: the gradients equal the JAX hook's
    custom VJP bit for bit (G @ B^T, A^T @ G)."""
    a, b, g = _rand((8, 16), 7), _rand((16, 4), 8), _rand((8, 4), 9)
    ta = torch.from_numpy(a).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    with gt.emulate(num_moduli=14):
        out = ta @ tb
    out.backward(torch.from_numpy(g))
    with g8.emulate(num_moduli=14):
        jout, vjp = jax.vjp(jnp.matmul, jnp.asarray(a), jnp.asarray(b))
        ga, gb = vjp(jnp.asarray(g))
    _bits_equal(out, jout)
    _bits_equal(ta.grad, ga)
    _bits_equal(tb.grad, gb)


def test_hooked_complex_grads_match_conjugated_jax():
    """torch's complex gradients are G @ B^H and A^H @ G; JAX's convention
    gives their conjugates. With JAX's cotangent conj(G), the port's grads
    equal the JAX hook's conjugated, bit for bit: the port computes them as
    conj(conj(G) @ B^T) and conj(A^T @ conj(G)), the JAX products' own
    operands."""
    a, b, g = _crand((8, 12), 10), _crand((12, 6), 11), _crand((8, 6), 12)
    ta = torch.from_numpy(a).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    with gt.emulate(num_moduli=12):
        out = ta @ tb
    out.backward(torch.from_numpy(g))
    with g8.emulate(num_moduli=12):
        jout, vjp = jax.vjp(jnp.matmul, jnp.asarray(a), jnp.asarray(b))
        ga, gb = vjp(jnp.asarray(np.conj(g)))
    _bits_equal(out, jout)
    _bits_equal(ta.grad, np.conj(np.asarray(ga)))
    _bits_equal(tb.grad, np.conj(np.asarray(gb)))
    # and they are the gradients: close to native autograd's
    ta2 = torch.from_numpy(a).requires_grad_(True)
    (ta2 @ torch.from_numpy(b)).backward(torch.from_numpy(g))
    assert torch.max(torch.abs(ta.grad - ta2.grad)) < 1e-10


def test_interop_180_conj_and_neg_bit_operands():
    """gemmul8_tpu.interop (interop.py:180) fails on a tensor whose
    conjugate or negative bit is set; the port materializes it: A.mH @ B
    equals gemm(A, B, trans_a="C")."""
    a, b = _crand((12, 6), 13), _crand((12, 5), 14)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert ta.mH.is_conj() and torch._neg_view(tb).is_neg()
    want = gt.gemm(a, b, num_moduli=12, trans_a="C", device="cpu")
    _bits_equal(want, g8.gemm(jnp.asarray(a), jnp.asarray(b), num_moduli=12,
                              trans_a="C"))
    with gt.emulate(num_moduli=12) as mode:
        _bits_equal(ta.mH @ tb, want)
        _bits_equal(ta.mH.conj() @ tb.conj(),
                    gt.gemm(a.T.copy(), b.conj(), num_moduli=12,
                            device="cpu"))
        _bits_equal(ta.mH @ torch._neg_view(tb),
                    gt.gemm(a, -b, num_moduli=12, trans_a="C", device="cpu"))
    assert mode.intercepted == 3
    _bits_equal(interop.torch_gemm(ta.mH, tb, num_moduli=12), want)


def test_nn_linear_and_leading_dims():
    torch.manual_seed(0)
    lin = torch.nn.Linear(16, 8, dtype=torch.float64)
    x = torch.from_numpy(_rand((5, 16), 15))
    w, bias = lin.weight.detach().numpy(), lin.bias.detach().numpy()
    with gt.emulate(num_moduli=14) as mode:
        y = lin(x)
        yb = lin(torch.from_numpy(_rand((3, 4, 16), 16)))
    assert mode.intercepted == 2 and yb.shape == (3, 4, 8)
    want = g8.gemm(jnp.asarray(x.numpy()), jnp.asarray(w.T.copy()),
                   num_moduli=14)
    _bits_equal(y, np.asarray(want) + bias)
    assert torch.max(torch.abs(y - lin(x))) < 1e-11


def test_mlp_from_jax_params_and_bitwise_reruns():
    """The JAX hook test's MLP fixture, carried over by from_jax_params:
    logits bit-identical over two runs under the hook, different from
    native, and within the tanh-GELU's rounding of the JAX hook's logits
    (torch and XLA compute tanh differently in the last bits); the first
    layer, before any GELU, is bit-equal."""
    params = jmlp.init_params(jax.random.PRNGKey(0), [64, 128, 128, 10])
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (32, 64),
                                   jnp.float32))
    model = mlp.from_jax_params([(np.asarray(w), np.asarray(b))
                                 for w, b in params], device="cpu")
    assert model.layers[0].weight.shape == (128, 64)
    tx = torch.from_numpy(x)
    with torch.no_grad():
        native = model(tx)
        with gt.emulate(num_moduli=8) as mode:
            l1, l2 = model(tx), model(tx)
            h1 = model.layers[0](tx)
    assert mode.intercepted == 7
    _bits_equal(l1, l2.numpy())
    assert not torch.equal(l1, native)
    with g8.emulate(num_moduli=8):
        jl = np.asarray(jmlp.forward(params, jnp.asarray(x)))
        jh1 = np.asarray(jnp.matmul(jnp.asarray(x), params[0][0])
                         + params[0][1])
    _bits_equal(h1, jh1)
    np.testing.assert_allclose(l1.numpy(), jl, rtol=0, atol=1e-5)
    np.testing.assert_allclose(l1.numpy(), native.numpy(), rtol=0, atol=1e-3)


def test_mlp_defaults_to_the_card(monkeypatch):
    """MLP and from_jax_params build on the card unless the caller passes
    device="cpu": with no card found they raise, never carry on on the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mlp.MLP([4, 8, 2])
    w = np.zeros((4, 2), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mlp.from_jax_params([(w, np.zeros(2, np.float32))])
    assert mlp.MLP([4, 8, 2], device="cpu").layers[0].weight.device.type \
        == "cpu"


def test_mlp_forward_and_backward_all_emulated():
    """Under install() every forward and backward GEMM of the MLP is
    emulated: 2 forward, 3 backward (the input takes no gradient), and no
    native matrix product reaches ATen; grads are bit-identical over two
    runs."""
    model = mlp.MLP([32, 48, 16], seed=3, device="cpu")
    x = torch.from_numpy(_rand((24, 32), 17, np.float32))

    def step():
        model.zero_grad()
        with _NativeMatmuls() as native:
            loss = model(x).square().sum()
            loss.backward()
        return native.count, [p.grad.clone() for p in model.parameters()]

    gt.install(num_moduli=8)
    before = hook.COUNTS["emulated"]
    n1, g1 = step()
    assert hook.COUNTS["emulated"] - before == 5 and n1 == 0
    n2, g2 = step()
    for p, q in zip(g1, g2):
        _bits_equal(p, q.numpy())
    gt.uninstall()
    assert step()[0] > 0                     # native again: mm counted


def test_plane_cache_off_by_default_and_bitwise(monkeypatch):
    """The skip-scal cache is off unless enabled: torch tensors are mutable
    (hook.py:136-183 keys on identity only, safe for immutable jax.Arrays).
    Enabled, repeated calls reuse planes with the same bits; an in-place
    write (a new version) misses; a collected owner leaves the cache."""
    a = torch.from_numpy(_rand((24, 96), 18, np.float32))
    b1 = torch.from_numpy(_rand((96, 16), 19, np.float32))
    b2 = torch.from_numpy(_rand((96, 16), 20, np.float32))
    with gt.emulate(num_moduli=9):
        ref1, ref2 = a @ b1, a @ b2
    assert hook.COUNTS["cache_hits"] == 0 and not hook._plane_cache
    _bits_equal(ref1, g8.gemm(jnp.asarray(a.numpy()), jnp.asarray(b1.numpy()),
                              num_moduli=9))
    monkeypatch.setenv("GEMMUL8_EAGER_CACHE", "1")
    h0 = hook.COUNTS["cache_hits"]
    with gt.emulate(num_moduli=9):
        c1 = a @ b1
        c2 = a @ b2                          # A's planes reused
        c1b = a @ b1                         # both reused
        assert hook.COUNTS["cache_hits"] - h0 == 3
        a.mul_(2.0)                          # a new version: no stale planes
        c3 = a @ b1
        assert hook.COUNTS["cache_hits"] - h0 == 4
    for got, ref in ((c1, ref1), (c2, ref2), (c1b, ref1)):
        _bits_equal(got, ref.numpy())
    n_entries = len(hook._plane_cache)
    del b2
    gc.collect()
    assert len(hook._plane_cache) == n_entries - 1
    monkeypatch.setenv("GEMMUL8_EAGER_CACHE", "0")
    with gt.emulate(num_moduli=9):
        _bits_equal(c3, (a @ b1).numpy())
    monkeypatch.setenv("GEMMUL8_SKIP_SCALE_B", "1")
    assert not gt.config.cache_enabled("A") and gt.config.cache_enabled("B")


def test_install_override_applies_across_threads():
    """install() patches process-wide entries: a matmul on a worker thread
    is emulated too (a TorchFunctionMode, being thread-local, would not see
    it)."""
    a = torch.from_numpy(_rand((24, 96), 21, np.float32))
    b = torch.from_numpy(_rand((96, 16), 22, np.float32))
    gt.install(num_moduli=9)
    try:
        res = {}
        t = threading.Thread(target=lambda: res.__setitem__("c", a @ b))
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
        want = a @ b
    finally:
        gt.uninstall()
    _bits_equal(res["c"], want.numpy())
    assert not torch.equal(res["c"], a @ b)


def test_torch_gemm_matches_core_and_validates():
    a, b = torch.from_numpy(_rand((33, 17), 23)), \
        torch.from_numpy(_rand((17, 21), 24))
    out = interop.torch_gemm(a, b, num_moduli=12)
    _bits_equal(out, g8.gemm(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()),
                             num_moduli=12))
    with pytest.raises(ValueError, match="2-D"):
        interop.torch_gemm(torch.zeros(3), torch.zeros(3))
    with pytest.raises(TypeError):
        interop.torch_gemm(torch.zeros((2, 2), dtype=torch.int32),
                           torch.zeros((2, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="out of range"):
        interop.torch_gemm(a, b.T.contiguous().T, num_moduli=99)
    with interop.emulate_torch(num_moduli=8) as mode:
        c1, c2, c3 = a @ b, torch.matmul(a, b), torch.mm(a, b)
    assert mode.intercepted == 3
    want = interop.torch_gemm(a, b, num_moduli=8)
    for c in (c1, c2, c3):
        _bits_equal(c, want.numpy())


def test_emulate_torch_env_contract(monkeypatch):
    a = torch.from_numpy(_rand((8, 8), 25))
    b = torch.from_numpy(_rand((8, 8), 26))
    with interop.emulate_torch(num_moduli=None) as mode:
        monkeypatch.delenv("GEMMUL8_NUM_MOD_D", raising=False)
        a @ b
        assert mode.intercepted == 0
        monkeypatch.setenv("GEMMUL8_NUM_MOD_D", "10")
        c = a @ b
        assert mode.intercepted == 1
        monkeypatch.setenv("GEMMUL8_NUM_MOD_D", "99")
        a @ b
        assert mode.intercepted == 1
    _bits_equal(c, interop.torch_gemm(a, b, num_moduli=10).numpy())


def test_complex_fp8_refused_and_k0():
    """Complex FP8 (queue 8), once refused here, is emulated with
    gemmul8_tpu's bits; a k = 0 product is zero."""
    a = torch.from_numpy(_crand((4, 8), 27))
    with gt.emulate(num_moduli=8, backend="FP8"):
        got = a @ a.mT
    _bits_equal(got, g8.gemm(jnp.asarray(a.numpy()), jnp.asarray(
        a.mT.numpy()), num_moduli=8, backend="FP8"))
    with gt.emulate(num_moduli=8):
        z = torch.zeros((4, 0)) @ torch.zeros((0, 5))
    assert z.shape == (4, 5) and not z.any()
