"""alpha and beta in K2's store (kernels.fused_epilogue with ab=, the
route core.gemm takes on the card for unstriped real INT8 calls:
core.folds_alpha_beta) on the CPU.

- The wrapper's plain version against its reference, fused_epilogue_plain
  followed by core.ab_epilogue, in every class of alpha and beta and both
  output dtypes, on a padded stack with a ragged C block and on K-chunked
  residue sums; outside C's block C reads as 0.
- gemm through the route on a stand-in for the card (core._on_card: the
  operands padded to 128 as there), ragged and K-chunked, bit-equal to the
  CPU's own call, which tests/test_torch_gemm_ops.py pins to the JAX
  package.
- Which calls take the route, by K2's launch counts: unstriped real INT8
  calls that apply alpha or read C do; alpha = 1 with beta = 0, FP8,
  complex, striped, the "f64" epilogue and k = 0 do not.
- The card branch of the wrapper on meta tensors, its launches recorded:
  the kind, C's pitch and vector loads, alpha and beta in the output's
  precision, both counters; and its refusals.
"""
import numpy as np
import pytest
import torch

import gemmul8_tpu_torch as gt
from gemmul8_tpu_torch import core, kernels, tables

NU = {torch.float32: 8, torch.float64: 16}
DTYPES = [torch.float32, torch.float64]
ALPHAS = [1.0, -1.25]            # trivial, general
BETAS = [0.0, 1.0, 0.75]         # zero, one, general


def _stack(rng, nu, m, n, chunked):
    """(nu, m, n) int32: K-chunked sums of [0, p) residues (3 chunks), or
    any int32 value."""
    if chunked:
        mods = tables.moduli("INT8")[:nu]
        chi = np.stack([rng.integers(0, 3 * p, (m, n)) for p in mods])
    else:
        chi = rng.integers(-2 ** 31, 2 ** 31, (nu, m, n))
    return torch.from_numpy(chi.astype(np.int32))


def _shifts(rng, m, n):
    return (torch.from_numpy(rng.integers(-40, 90, m).astype(np.int32)),
            torch.from_numpy(rng.integers(-40, 90, n).astype(np.int32)))


def _same_bits(x, y):
    return x.dtype == y.dtype and torch.equal(
        x.contiguous().view(torch.uint8), y.contiguous().view(torch.uint8))


def _alpha_beta(c, alpha, beta):
    trivial_alpha, beta_kind = core.scalar_kinds(alpha, beta)
    return kernels.AlphaBeta(None if beta_kind == "zero" else c, alpha, beta,
                             trivial_alpha, beta_kind)


@pytest.mark.parametrize("case", ["padded", "chunked"])
@pytest.mark.parametrize("beta", BETAS)
@pytest.mark.parametrize("alpha", ALPHAS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_fold_equals_epilogue_then_ab_epilogue(dtype, alpha, beta, case):
    """C is y times a normal draw, so that alpha * y and beta * C meet at
    like magnitudes and each rounding shows; the ragged block (200, 300)
    lies in a stack padded to (256, 384), as gemm pads on the card."""
    rng = np.random.default_rng(27 + 10 * len(case) + int(4 * beta))
    nu = NU[dtype]
    m, n, mc, nc = ((256, 384, 200, 300) if case == "padded"
                    else (136, 200, 136, 200))
    chi = _stack(rng, nu, m, n, case == "chunked")
    sa, sb = _shifts(rng, m, n)
    y = kernels.fused_epilogue_plain(chi, sa, sb, nu, "INT8", dtype)
    c = y[:mc, :nc] * torch.from_numpy(rng.standard_normal((mc, nc))).to(dtype)
    ab = _alpha_beta(c, alpha, beta)
    got = kernels.fused_epilogue(chi, sa, sb, nu, "INT8", dtype, ab=ab)
    trivial_alpha, beta_kind = core.scalar_kinds(alpha, beta)
    c_full = torch.zeros_like(y)
    c_full[:mc, :nc] = c
    ref = core.ab_epilogue(y, c_full, alpha, beta, has_c=True, epilogue="ff",
                           trivial_alpha=trivial_alpha, beta_kind=beta_kind)
    assert got.shape == (m, n) and _same_bits(got, ref)
    block = core.ab_epilogue(y[:mc, :nc], c, alpha, beta, has_c=True,
                             epilogue="ff", trivial_alpha=trivial_alpha,
                             beta_kind=beta_kind)
    assert _same_bits(got[:mc, :nc], block)


def _stand_in_card(mp):
    """core on the CPU as on the card (operands padded to 128, the alpha/
    beta route open), K2's launches counted as the card counts them."""
    orig = kernels.fused_epilogue

    def fused_epilogue(c_hi, *args, ab=None):
        kernels.LAUNCHES["fused_epilogue"] += 1
        if ab is not None and kernels.ab_kind(ab):
            kernels.LAUNCHES["fused_epilogue_ab"] += 1
        return orig(c_hi, *args, ab=ab)

    mp.setattr(core, "_on_card", lambda device: True)
    mp.setattr(kernels, "fused_epilogue", fused_epilogue)
    kernels.reset_launches()
    return kernels.LAUNCHES


@pytest.fixture
def fake_card(monkeypatch):
    return _stand_in_card(monkeypatch)


def _operands(seed, m, k, n, dtype=np.float64):
    rng = np.random.default_rng(seed)
    a, b, c = (rng.standard_normal(s).astype(dtype)
               for s in ((m, k), (k, n), (m, n)))
    return a, b, c


@pytest.mark.parametrize("shape", ["ragged", "chunked"])
@pytest.mark.parametrize("beta", BETAS)
@pytest.mark.parametrize("alpha", ALPHAS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_gemm_route_is_bit_equal(monkeypatch, dtype, alpha, beta, shape):
    """gemm through K2's alpha/beta store on the stand-in card against the
    CPU's call; K-chunked with K_CHUNK cut to 128 (k = 300 pads to 384 there:
    three chunks either way)."""
    m, k, n = (200, 96, 300) if shape == "ragged" else (40, 300, 72)
    a, b, c = _operands(int(100 * beta) + len(shape), m, k, n, dtype)
    if shape == "chunked":
        monkeypatch.setattr(core, "K_CHUNK", 128)
    kw = dict(num_moduli=NU[torch.float64 if dtype == np.float64
                           else torch.float32],
              alpha=alpha, beta=beta, c=c, epilogue="ff", device="cpu")
    ref = gt.gemm(a, b, **kw)
    with monkeypatch.context() as mp:
        counts = _stand_in_card(mp)
        got = gt.gemm(a, b, **kw)
        routed = counts["fused_epilogue_ab"]
    assert _same_bits(got, ref)
    assert routed == (0 if alpha == 1 and beta == 0 else 1)


@pytest.mark.parametrize("name,kw,k2,folded", [
    ("update", dict(alpha=-1.0, beta=1.0), 1, 1),
    ("alpha only", dict(alpha=2.0, beta=0.0), 1, 1),
    ("general", dict(alpha=0.5, beta=-0.75), 1, 1),
    ("no alpha, no beta", dict(alpha=1.0, beta=0.0), 1, 0),
    ("beta without C", dict(alpha=1.0, beta=1.0, c=None), 1, 0),
    ("FP8", dict(alpha=-1.0, beta=1.0, backend="FP8", num_moduli=14), 0, 0),
    ("complex", dict(alpha=-1.0, beta=1.0, complex=True), 0, 0),
    ("striped", dict(alpha=-1.0, beta=1.0, m_block=32, n_block=48), 4, 0),
    ("f64 epilogue", dict(alpha=-1.0, beta=1.0, epilogue="f64"), 0, 0),
    ("k = 0", dict(alpha=-1.0, beta=1.0, k=0), 0, 0),
])
def test_which_calls_take_the_route(fake_card, monkeypatch, name, kw, k2,
                                    folded):
    kw = dict(kw)
    k = kw.pop("k", 40)
    a, b, c = _operands(7, 64, k, 96)
    if kw.pop("complex", False):
        a, b, c = (x + 0.5j * x[::-1] for x in (a, b, c))
    kw = dict(dict(num_moduli=16, c=c, epilogue="ff"), **kw)
    got = gt.gemm(a, b, device="cpu", **kw)
    counts = dict(kernels.LAUNCHES)
    assert (counts["fused_epilogue"], counts["fused_epilogue_ab"]) \
        == (k2, folded), name
    monkeypatch.undo()
    ref = gt.gemm(a, b, device="cpu", **kw)
    assert _same_bits(got, ref)


@pytest.mark.parametrize("layout", ["row-strided", "broadcast row",
                                    "transposed"])
def test_gemm_route_takes_c_views(monkeypatch, layout):
    """K2 reads a row-strided C and a broadcast row in place (its pitch);
    a C with strided columns is copied first. Each bit-equal to the CPU."""
    a, b, _ = _operands(11, 72, 40, 100)
    wide = torch.from_numpy(_operands(12, 100, 1, 130)[2])
    c = {"row-strided": wide[:72, :100], "broadcast row": wide[:1, :100],
         "transposed": wide[:100, :72].T}[layout]
    kw = dict(num_moduli=16, alpha=-1.0, beta=0.75, c=c, epilogue="ff",
              device="cpu")
    ref = gt.gemm(a, b, **kw)
    counts = _stand_in_card(monkeypatch)
    got = gt.gemm(a, b, **kw)
    assert counts["fused_epilogue_ab"] == 1
    assert _same_bits(got, ref)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.fixture
def card_branch(monkeypatch):
    """kernels.fused_epilogue's card branch on meta tensors: the launches
    recorded, not made."""
    calls = []

    def launch(name, *args, count=None):
        calls.append((name, args))
        kernels.LAUNCHES[count or name] += 1

    def check(name, c_hi, n_planes, dtypes, sft_a, sft_b):
        assert c_hi.dtype in dtypes and c_hi.shape[0] == n_planes
        return tuple(c_hi.shape[1:])

    monkeypatch.setattr(kernels, "_check_epilogue", check)
    monkeypatch.setattr(kernels, "_launch", launch)
    monkeypatch.setattr(kernels, "_stream", lambda t: 0)
    kernels.reset_launches()
    return calls


def _k2(c_hi, dtype, ab):
    sa = _meta((c_hi.shape[1],), torch.int32)
    sb = _meta((c_hi.shape[2],), torch.int32)
    return kernels.fused_epilogue(c_hi, sa, sb, 16 if dtype == torch.float64
                                  else 8, "INT8", dtype, ab=ab)


@pytest.mark.parametrize("dtype", DTYPES)
def test_card_launch_arguments(card_branch, dtype):
    chi = _meta((NU[dtype], 256, 384), torch.int32)
    f64 = int(dtype == torch.float64)
    size = 8 if f64 else 4
    # the update: C a (200, 300) block, rows 300 apart
    out = _k2(chi, dtype, _alpha_beta(_meta((200, 300), dtype), -1.0, 1.0))
    assert out.shape == (256, 384) and out.dtype == dtype
    (name, args), = card_branch
    assert name == "fused_epilogue_ab"
    # out, c, ldc, mc, nc, cvec, kind, alpha, beta, out_f64, m, n
    assert args[5:15] == (300, 200, 300, int(300 * size % 16 == 0), 3, -1.0,
                          1.0, f64, 256, 384)
    # a row-strided view (pitch 301: one element at a time) and general
    # scalars, rounded as the output's precision holds them
    card_branch.clear()
    c = _meta((200, 301), dtype)[:, :300]
    _k2(chi, dtype, _alpha_beta(c, 0.1, 0.3))
    (_, args), = card_branch
    r = (lambda v: float(np.float32(v))) if not f64 else float
    assert args[5:12] == (301, 200, 300, 0, 5, r(0.1), r(0.3))
    # broadcast rows: pitch 0; alpha alone reads no C
    card_branch.clear()
    _k2(chi, dtype, _alpha_beta(_meta((1, 384), dtype).expand(256, 384),
                                1.0, 0.75))
    _k2(chi, dtype, _alpha_beta(None, 2.0, 0.0))
    (_, bc), (_, al) = card_branch
    assert bc[5:11] == (0, 256, 384, 1, 4, 1.0)
    assert al[4:11] == (0, 0, 0, 0, 0, 1, 2.0)
    # nothing to apply: today's kernel
    card_branch.clear()
    _k2(chi, dtype, _alpha_beta(None, 1.0, 0.0))
    assert [name for name, _ in card_branch] == ["fused_epilogue"]
    assert (kernels.LAUNCHES["fused_epilogue"],
            kernels.LAUNCHES["fused_epilogue_ab"]) == (5, 4)


@pytest.mark.parametrize("what,chi,c,match", [
    ("int8 stack", (16, 256, 384, torch.int8), (200, 300, torch.float64),
     "int32 c_hi"),
    ("ragged n", (16, 256, 382, torch.int32), (200, 300, torch.float64),
     "multiple of 4"),
    ("C too tall", (16, 256, 384, torch.int32), (257, 300, torch.float64),
     "block"),
    ("C's dtype", (16, 256, 384, torch.int32), (200, 300, torch.float32),
     "block"),
    ("C's columns strided", (16, 256, 384, torch.int32),
     (200, 600, torch.float64), "unit column stride"),
])
def test_card_refusals(card_branch, what, chi, c, match):
    c_t = _meta(c[:2], c[2])
    if what == "C's columns strided":
        c_t = c_t[:, ::2]
    with pytest.raises(ValueError, match=match):
        _k2(_meta(chi[:3], chi[3]), torch.float64,
            _alpha_beta(c_t, -1.0, 1.0))
    assert not card_branch


def test_cpu_counts_no_launch():
    kernels.reset_launches()
    rng = np.random.default_rng(3)
    chi = _stack(rng, 8, 8, 8, False)
    sa, sb = _shifts(rng, 8, 8)
    y = kernels.fused_epilogue(chi, sa, sb, 8, "INT8", torch.float32,
                               ab=_alpha_beta(torch.ones(8, 8), -1.0, 1.0))
    assert y.shape == (8, 8) and not any(kernels.LAUNCHES.values())
