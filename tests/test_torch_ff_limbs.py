"""gemmul8_tpu_torch.ff's cross-check pieces against gemmul8_tpu.ff: the
error-free product two_prod_const, the 20-bit limb plan _crt_plan and the
piece-wise CRT crt_limbs (limbs bit-equal to JAX's), with the exact
reconstruction test of tests/test_ff.py ported: residues of a known integer
v come back as v within P * 2^-78, exactly where that bound is below 1/2,
beside the production crt_limbs_matrix.

The inputs avoid subnormal intermediates: XLA:CPU flushes them, the port
does not (a known CPU difference)."""
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemmul8_tpu import ff as jff
from gemmul8_tpu import tables as jtables
from gemmul8_tpu_torch import ff as tff

BACKENDS = ["INT8", "FP8"]
NUS = [2, 5, 8, 13, 17, 20]
CONSTANTS = [np.pi, 1.0 / 3.0, 2.0 ** -20, 1e10, -7.0, 4097.0]


def _f32_values(seed=15):
    """10^4 f32 values over 2^-60 .. 2^60, both signs, with edge values:
    zeros of both signs, ones, 2^24 - 1 (a split's widest mantissa),
    powers of two, f32's largest value (its split overflows: inf or NaN
    in both packages) and the infinities and NaN."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(10_000)
         * 2.0 ** rng.integers(-60, 61, 10_000)).astype(np.float32)
    f32max = np.finfo(np.float32).max
    edges = np.array([0.0, -0.0, 1.0, -1.0, 2.0 ** 24 - 1, -(2.0 ** 24 - 1),
                      2.0 ** -60, 2.0 ** 60, 3.0, f32max, -f32max, np.inf,
                      -np.inf, np.nan], np.float32)
    x[:edges.size] = edges
    return x


def _same(got, ref, what):
    """Bit equality, NaN held as NaN (the payload is each runtime's)."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape, what
    nan = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(got), nan, err_msg=what)
    np.testing.assert_array_equal(got[~nan].view(np.uint32),
                                  ref[~nan].view(np.uint32), err_msg=what)


def test_constants():
    assert tff.LIMB_BITS == jff.LIMB_BITS == 20
    assert tff._LIMB == jff._LIMB
    assert tff._SPLIT.dtype == jff._SPLIT.dtype and tff._SPLIT == jff._SPLIT


@pytest.mark.parametrize("c", CONSTANTS)
def test_split12_const_bit_equal(c):
    got, ref = tff._split12_const(c), jff._split12_const(c)
    for g, r in zip(got, ref):
        assert type(g) is type(r) and np.float32(g).view(np.uint32) == \
            np.float32(r).view(np.uint32)
    hi, lo = got
    assert np.float64(hi) + np.float64(lo) == np.float64(np.float32(c))


@pytest.mark.parametrize("c", CONSTANTS)
def test_two_prod_const_bit_equal(c):
    x = _f32_values()
    p, e = tff.two_prod_const(c, torch.from_numpy(x))
    jp, je = jff.two_prod_const(c, jnp.asarray(x))
    _same(p.numpy(), jp, f"p c={c}")
    _same(e.numpy(), je, f"e c={c}")
    # error-free where finite: p + e is the exact product
    fin = np.isfinite(p.numpy()) & np.isfinite(e.numpy())
    exact = np.float64(np.float32(c)) * x[fin].astype(np.float64)
    np.testing.assert_array_equal(
        p.numpy()[fin].astype(np.float64) + e.numpy()[fin].astype(np.float64),
        exact)


@pytest.mark.parametrize("value", [0.0, 1.0, -1.0, 4095.0, 4096.0, -4097.0,
                                   2.0 ** 70 + 2.0 ** 47, -3.0 * 2.0 ** -90,
                                   float(np.float32(np.pi)) * 2.0 ** 100])
def test_int_pieces_equal(value):
    assert tff._int_pieces(value) == jff._int_pieces(value)


@pytest.mark.parametrize("out_bits", [24, 53])
@pytest.mark.parametrize("nu", NUS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_crt_plan_equals_jax(backend, nu, out_bits):
    got = tff._crt_plan(nu, backend, out_bits)
    ref = jff._crt_plan(nu, backend, out_bits)
    base, L, terms, invp_top, p_terms = got
    assert (base, L, terms, p_terms) == (ref[0], ref[1], ref[2], ref[4])
    assert type(invp_top) is type(ref[3]) and \
        invp_top.view(np.uint32) == ref[3].view(np.uint32)
    # every piece lands inside the limbs at a 20-bit offset, |m| < 2^12
    for *_, m_int, li, off in terms + p_terms:
        assert 0 <= li < L and 0 <= off < tff.LIMB_BITS and abs(m_int) < 4096


def _mid_dtype(backend):
    return np.int8 if backend == "INT8" else np.int16


def _residues_of(v, mods, backend):
    """The wrapped residues of the integers v, (nu, len(v))."""
    return np.stack([
        (np.vectorize(lambda t, p=p: ((t % p) - p if 2 * (t % p) >= p
                                      else t % p))(v)) for p in mods]
    ).astype(_mid_dtype(backend))


def _value(limbs, base, width):
    return sum(np.asarray(l, np.float64)[:, 0] * 2.0 ** (base + width * i)
               for i, l in enumerate(limbs))


@pytest.mark.parametrize("nu", NUS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_crt_limbs_reconstructs_exactly(nu, backend):
    """tests/test_ff.py's exact-reconstruction test on the port, with the
    limbs also held bit for bit against JAX's crt_limbs."""
    rng = np.random.default_rng(321 + nu)
    mods = [int(p) for p in jtables.moduli(backend)[:nu]]
    P = 1
    for p in mods:
        P *= p
    lim = min(2 ** 50, P // 2 - 1)
    v = rng.integers(-lim, lim, (64,))
    res = _residues_of(v, mods, backend)[:, :, None]
    limbs, base = tff.crt_limbs(torch.from_numpy(res), nu, backend, 53)
    jlimbs, jbase = jff.crt_limbs(jnp.asarray(res), nu, backend, 53)
    assert base == jbase and len(limbs) == len(jlimbs)
    for i, (g, r) in enumerate(zip(limbs, jlimbs)):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                      err_msg=f"limb {i}")
    got = _value(limbs, base, tff.LIMB_BITS)
    limbs_m, base_m = tff.crt_limbs_matrix(torch.from_numpy(res), nu,
                                           backend, 53)
    got_m = _value(limbs_m, base_m, 16)
    bound = float(P) * 2.0 ** -78
    for g in (got, got_m):
        err = np.abs(g - v.astype(np.float64))
        if bound < 0.5:
            np.testing.assert_array_equal(g, v.astype(np.float64))
        else:
            assert err.max() <= bound


@pytest.mark.parametrize("out_bits", [24, 53])
@pytest.mark.parametrize("nu", NUS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_crt_limbs_bit_equal_random_residues(backend, nu, out_bits):
    """Any wrapped residues (|t| up to P/2, the quotient fold busy): the
    limbs bit-equal to JAX's, balanced below the top limb, and the value
    within P * 2^-78 of crt_limbs_matrix's modulo P for 53-bit outputs
    (compared exactly, as rationals)."""
    rng = np.random.default_rng(1000 * nu + out_bits)
    mods = [int(p) for p in jtables.moduli(backend)[:nu]]
    res = np.stack([rng.integers(-(p // 2), p - p // 2, (33, 47))
                    for p in mods]).astype(_mid_dtype(backend))
    limbs, base = tff.crt_limbs(torch.from_numpy(res), nu, backend, out_bits)
    jlimbs, jbase = jff.crt_limbs(jnp.asarray(res), nu, backend, out_bits)
    assert base == jbase
    for i, (g, r) in enumerate(zip(limbs, jlimbs)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                      err_msg=f"limb {i}")
    half = 1 << (tff.LIMB_BITS - 1)
    for g in limbs[:-1]:
        assert int(g.min()) >= -half and int(g.max()) < half
    limbs_m, base_m = tff.crt_limbs_matrix(torch.from_numpy(res), nu,
                                           backend, out_bits)
    P = 1
    for p in mods:
        P *= p

    def exact(ls, b, w):
        # each element's t as an exact rational
        flat = [l.reshape(-1).tolist() for l in ls]
        return [sum(Fraction(x[j]) * Fraction(2) ** (b + w * i)
                    for i, x in enumerate(flat)) for j in range(len(flat[0]))]

    # the sub-base cutoffs sit lo_bits (95 for 53-bit outputs, 56 for
    # 24-bit ones) under P's top bit: P * 2^-78, the JAX test's bound, for
    # 53 bits, and 39 bits under P's top for 24
    bound = Fraction(P, 2 ** (78 if out_bits == 53 else 39))
    # the wrap quotient is an f32 estimate, so a t within about 2^-10 P of
    # +-P/2 may come back as either representative: the two agree modulo P
    for t20, t16 in zip(exact(limbs, base, tff.LIMB_BITS),
                        exact(limbs_m, base_m, 16)):
        assert min(abs(t20 - t16 - q * P) for q in (-1, 0, 1)) <= bound
        assert abs(t20) <= Fraction(P, 2) * (1 + Fraction(1, 2 ** 9))


@pytest.mark.parametrize("off", range(0, 20))
def test_add_to_limbs_floor_split(off):
    """The split of a product into limbs li/li+1 is a floor (arithmetic
    shift on int32), pinned with negative products; bit-equal to JAX's."""
    rng = np.random.default_rng(off)
    prod = rng.integers(-(1 << 26) + 1, 1 << 26, 4096).astype(np.int32)
    prod[:4] = [-1, -(1 << 25), (1 << 25) - 1, 0]
    got = [torch.zeros(4096, dtype=torch.int32) for _ in range(3)]
    ref = [jnp.zeros(4096, jnp.int32) for _ in range(3)]
    tff._add_to_limbs(got, torch.from_numpy(prod), 1, off)
    jff._add_to_limbs(ref, jnp.asarray(prod), 1, off)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    # the limbs hold the product exactly, the low part non-negative
    val = (got[1].numpy().astype(np.int64)
           + (got[2].numpy().astype(np.int64) << tff.LIMB_BITS))
    np.testing.assert_array_equal(val, prod.astype(np.int64) << off)
    if off:
        assert got[1].numpy().min() >= 0


def test_quotient_rounds_half_to_even():
    """The quotient estimate's rint: torch.round is round-half-even, as
    jnp.rint, on the halves an f32 t_top * invp_top can land on."""
    x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 8191.5, -8192.5,
                  np.float32(2.5) + np.float32(2.0 ** -22)], np.float32)
    np.testing.assert_array_equal(torch.round(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnp.rint(jnp.asarray(x))))
