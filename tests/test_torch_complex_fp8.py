"""Complex FP8 (ROADMAP queue 8) of gemmul8_tpu_torch against gemmul8_tpu on
the CPU under x64, bit for bit (tolerance 0 everywhere): the three lanes'
e4m3 split stacks (the lane encoder's plain version), the int16 3M
recombine, the reassembly and its K-chunk sums, gemm on complex64 and
complex128 in fast, robust and accurate mode with ops N/T/C and alpha/beta
at nu 2, 6, 7, 14 and 18 through both epilogues, gemm_planar, gemm_batched
and gemm_batched_planar; accurate mode past k = 252, where the FP8 estimate
differs from JAX's on purpose (upper bounds within the inflation, equal
shifts); and the FP8 difference lane of accurate mode
(gemmul8_tpu/complex_gemm.py:107). The gemm cases share one shape: XLA:CPU
compiles dominate their time."""
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gemmul8_tpu as g8
import gemmul8_tpu_torch as gt
from gemmul8_tpu import complex_gemm as jcg, fp8 as jfp8, quantize as jq
from gemmul8_tpu_torch import complex_gemm as tcg, fp8 as tfp8, kernels
from gemmul8_tpu_torch import quantize as tq, tables

M, K, N = 20, 50, 12                       # ragged
C128, C64 = np.complex128, np.complex64


def _bits_equal(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got.view(np.uint8), ref.view(np.uint8))


def _cplx(rng, m, n, dtype):
    z = rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n))
    return (z * np.exp(rng.standard_normal((m, n)))).astype(dtype)


def _planes(x):
    return (np.ascontiguousarray(x.real), np.ascontiguousarray(x.imag))


@pytest.mark.parametrize("dtype,nu", [
    (np.float64, 2), (np.float64, 6), (np.float64, 7), (np.float64, 18),
    (np.float32, 2), (np.float32, 6), (np.float32, 7), (np.float32, 13)])
def test_lane_stacks_bit_equal(dtype, nu):
    """The lane encoder's plain version gives the JAX lanes' values, each
    lane stacked in the side's slot order, for both sides and conj."""
    rng = np.random.default_rng(nu)
    re, im = (rng.standard_normal((9, 14)).astype(dtype) * 50.0
              for _ in range(2))
    re[2], im[3] = 0.0, -(2.0 ** 60)
    tre, tim = torch.from_numpy(re), torch.from_numpy(im)
    for axis in (0, 1):
        sft = tcg._shift_complex_fast(tre, tim, nu, "FP8", 1 - axis)
        side = "lhs" if axis == 0 else "rhs"
        for conj in (False, True):
            ref = jcg._quantize_complex(jnp.asarray(re), jnp.asarray(im),
                                        jnp.asarray(sft.numpy()), axis, nu,
                                        "FP8", conj)
            got = kernels.encode_lanes_fp8(tre, tim, sft, axis, nu, conj)
            assert got.shape == (3, 3 * nu, *re.shape)
            assert got.dtype == torch.float8_e4m3fn
            for lane in range(3):
                want = np.asarray(jfp8._gemm_stack(ref[lane], nu, side),
                                  np.float32)
                _bits_equal(got[lane].to(torch.float32), want)


def test_conj_negates_the_value_before_the_encode():
    """conj negates Im before it is quantized, not the residue after: the
    encode floors, so -floor(y) differs from floor(-y) off the integers."""
    re = np.full((2, 4), 3.0)
    im = np.array([[0.25, -0.75, 1.5, 7.0], [0.5, 2.25, -3.5, 0.0]])
    tre, tim = torch.from_numpy(re), torch.from_numpy(im)
    sft = torch.zeros(2, dtype=torch.int32)
    got = kernels.encode_lanes_fp8(tre, tim, sft, 0, 7, conj=True)
    neg = kernels.encode_lanes_fp8(tre, -tim, sft, 0, 7)
    assert torch.equal(got.view(torch.uint8), neg.view(torch.uint8))
    res_neg = tq.residues_wrapped(-tim, sft, 0, 7, "FP8")
    res_pos = tq.residues_wrapped(tim, sft, 0, 7, "FP8")
    assert not torch.equal(res_neg, -res_pos)


def test_recombine_3m_fp8_keeps_int16():
    rng = np.random.default_rng(5)
    nu = 20
    mods = tables.moduli("FP8")[:nu]
    mids = np.stack([np.stack([rng.integers(-(p // 2), p - p // 2, (9, 11))
                               for p in mods]) for _ in range(3)])
    mids = mids.astype(np.int16)
    ref_r, ref_i = jcg._recombine_3m(jnp.asarray(mids), nu, "FP8")
    got_r, got_i = tcg._recombine_3m(torch.from_numpy(mids), nu, "FP8")
    assert got_r.dtype == torch.int16
    _bits_equal(got_r, ref_r)
    _bits_equal(got_i, ref_i)
    assert int(np.abs(np.asarray(ref_r)).max()) > 127      # past int8
    # the recombine kernel's plain version writes them as int32
    chi = torch.from_numpy(mids.astype(np.int32).reshape(3 * nu, 9, 11))
    k5 = kernels.fused_recombine_3m(chi, nu, "FP8")
    assert k5[0].dtype == torch.int32
    _bits_equal(k5[0], np.asarray(ref_r).astype(np.int32))


def test_reassembly_and_its_chunk_sums():
    """reassemble_fp8 is fp8._reassemble; accumulate sums the chunks'
    residues, and the complex path's K-chunked lanes equal the chunked
    accumulator's sums, lane by lane."""
    rng = np.random.default_rng(6)
    nu, m, n = 7, 3, 4
    c3 = rng.integers(-2 ** 24, 2 ** 24 + 1, (2, 3 * nu, m, n))
    c3 = torch.from_numpy(c3.astype(np.float32))
    ref = [np.asarray(jfp8._reassemble(jnp.asarray(c.numpy()).astype(
        jnp.int32), nu)) for c in c3]
    out = kernels.reassemble_fp8(c3[0], nu, out=torch.zeros(
        (nu, m, n), dtype=torch.int32))
    _bits_equal(out, ref[0])
    _bits_equal(kernels.reassemble_fp8(c3[1], nu, out=out, accumulate=True),
                ref[0] + ref[1])
    with pytest.raises(ValueError, match="accumulate"):
        kernels.reassemble_fp8(c3[0], nu, accumulate=True)
    # k = 2^16 + 16: two chunks a lane (two moduli, 2 x 2 outputs: the
    # chunk loop is what is tested)
    nu, k = 2, tfp8.K_CHUNK_FP8 + 16
    a = [torch.from_numpy(rng.standard_normal((2, k))) for _ in range(2)]
    b = [torch.from_numpy(rng.standard_normal((k, 2))) for _ in range(2)]
    sa, sb = tcg.shifts(a, b, nu, True, "FP8")
    pa = tcg._quantize_complex(*a, sa, 0, nu, "FP8", False)
    pb = tcg._quantize_complex(*b, sb, 1, nu, "FP8", True)
    res = tcg._fp8_lane_residues(pa, pb, nu)
    for lane in range(3):
        _bits_equal(res[lane * nu:(lane + 1) * nu], np.asarray(
            jfp8._chunked_residue_acc(*(jnp.asarray(x[lane].to(
                torch.float32).numpy()) for x in (pa, pb)), nu)))


GEMM_CASES = [
    # dtype, nu, epilogue, fastmode, op_a, op_b, alpha, beta
    (C128, 18, "ff", True, "N", "C", 1.0, 0.7 - 0.3j),     # the nu > 16 split
    (C128, 6, "f64", "robust", "C", "T", -1.5 + 0.25j, 1.0),
    (C64, 7, "ff", False, "T", "N", -1.5 + 0.25j, 0.7 - 0.3j),
    (C128, 2, "ff", True, "N", "N", 1.0, 0.0),
    (C128, 14, "ff", False, "C", "C", 2.0, 0.5),
]


@pytest.mark.parametrize("dtype,nu,epilogue,fastmode,op_a,op_b,alpha,beta",
                         GEMM_CASES)
def test_gemm_complex_fp8_bit_equal(dtype, nu, epilogue, fastmode, op_a,
                                    op_b, alpha, beta):
    rng = np.random.default_rng(nu)
    a = _cplx(rng, *((M, K) if op_a == "N" else (K, M)), dtype)
    b = _cplx(rng, *((K, N) if op_b == "N" else (N, K)), dtype)
    c = _cplx(rng, M, N, dtype)
    kw = dict(num_moduli=nu, backend="FP8", epilogue=epilogue,
              fastmode=fastmode, trans_a=op_a, trans_b=op_b, alpha=alpha,
              beta=beta)
    ref = g8.gemm(jnp.asarray(a), jnp.asarray(b), c=jnp.asarray(c), **kw)
    got = gt.gemm(a, b, c=c, device="cpu", **kw)
    _bits_equal(got, ref)
    exact = alpha * (np.conj(a.T) if op_a == "C" else a.T if op_a == "T"
                     else a).astype(C128) @ (
        np.conj(b.T) if op_b == "C" else b.T if op_b == "T" else b
    ).astype(C128) + beta * c
    if nu < 6:
        return     # two moduli hold too few bits for this data in fast mode
    # the emulation's own accuracy: about log2P bits, down to the dtype's
    tol = max(2.0 ** (6 - tables.log2P(nu, "FP8")),
              1e-5 if dtype == C64 else 1e-12)
    assert np.abs(got.numpy() - exact).max() < tol * np.abs(exact).max()


def test_gemm_planar_fp8_bit_equal():
    rng = np.random.default_rng(30)
    a = _cplx(rng, K, M, C128)
    b = _cplx(rng, K, N, C128)
    kw = dict(num_moduli=7, backend="FP8", trans_a="C", trans_b="N",
              epilogue="ff")
    ref_r, ref_i = g8.gemm_planar(*(jnp.asarray(x) for x in
                                    _planes(a) + _planes(b)), **kw)
    got_r, got_i = gt.gemm_planar(*_planes(a), *_planes(b), device="cpu",
                                  **kw)
    _bits_equal(got_r, ref_r)
    _bits_equal(got_i, ref_i)
    # the planar entry equals gemm on complex tensors
    whole = gt.gemm(a, b, device="cpu", **kw)
    assert torch.equal(torch.complex(got_r, got_i), whole)


def test_gemm_batched_fp8_bit_equal():
    """gemm_batched on complex64 and gemm_batched_planar on its planes, both
    bit-equal to the JAX package's complex gemm_batched (a vmap)."""
    rng = np.random.default_rng(31)
    a = np.stack([_cplx(rng, 9, 16, C64) for _ in range(3)])
    b = np.stack([_cplx(rng, 16, 5, C64) for _ in range(3)])
    kw = dict(num_moduli=7, backend="FP8", fastmode="robust")
    ref = np.asarray(g8.gemm_batched(jnp.asarray(a), jnp.asarray(b), **kw))
    _bits_equal(gt.gemm_batched(a, b, device="cpu", **kw), ref)
    got_r, got_i = gt.gemm_batched_planar(*_planes(a), *_planes(b),
                                          device="cpu", **kw)
    _bits_equal(got_r, np.ascontiguousarray(ref.real))
    _bits_equal(got_i, np.ascontiguousarray(ref.imag))


def test_accurate_complex_fp8_past_k_252():
    """Past k = 252 the FP8 estimate is a deliberate difference (ROADMAP
    section 3): in all three 3M lanes the port's estimates are upper bounds
    of the exact lane products within the inflation of JAX's, and the
    shifts are JAX's."""
    rng = np.random.default_rng(253)
    k = 253
    a = _cplx(rng, 6, k, C128)
    b = _cplx(rng, k, 5, C128)
    a[0, :] *= 1e3                         # bounds up to 258 in every lane
    ta, tb = (_planes(x) for x in (a, b))
    ext = tcg.accurate_extract([torch.from_numpy(x) for x in ta],
                               [torch.from_numpy(x) for x in tb], "FP8")
    got = tcg.accurate_estimate(ext, "FP8")
    lhs = [ext[0][2], ext[0][0], ext[0][1]]
    rhs = [ext[1][2], ext[1][1], ext[1][0]]
    for d, x, y in zip(got, lhs, rhs):
        exact = (x.to(torch.float64) @ y.to(torch.float64)).numpy()
        ref = np.asarray(jq.estimate_gemm(
            jnp.asarray(x.to(torch.float32).numpy()).astype(jnp.bfloat16),
            jnp.asarray(y.to(torch.float32).numpy()).astype(jnp.bfloat16),
            "FP8"))
        d = d.numpy()
        # the difference lane is signed: its estimate bounds it in magnitude
        assert np.all(np.sign(d) == np.sign(exact))
        assert np.all(np.abs(d) >= np.abs(exact))
        np.testing.assert_allclose(d, ref, rtol=(k + 1) * 2.0 ** -23)
    ref_a, ref_b = jcg._shift_complex_accu(
        *(jnp.asarray(x) for x in ta + tb), 14, "FP8")
    got_a, got_b = tcg.shifts([torch.from_numpy(x) for x in ta],
                              [torch.from_numpy(x) for x in tb], 14, False,
                              "FP8")
    _bits_equal(got_a, ref_a)
    _bits_equal(got_b, ref_b)


def test_complex_gemm_107_fp8_difference_lane():
    """gemmul8_tpu/complex_gemm.py:107 takes ub|Re| - ub|Im| in bf16, where
    FP8 bounds reach 258: 258 - 1 = 257 rounds to 256. The port keeps those
    bits. The 3M bound still bounds the exact |Re| and |Im| of the product at
    the scale the shifts assume: a bound of 258 stands for a value in
    (255, 256), and that slack covers the lost unit in every term."""
    t = 2.0 ** -40
    big, small = 255.5 + t, 0.3            # bounds 258 and 1
    a = np.array([[big + 1j * small, small + 1j * big, 17 + 3j, -big - 1j * small],
                  [big + 1j * small, -big + 1j * small, 0.5j, 2.0],
                  [small - 1j * big, big + 1j * small, big - 1j * small, 1j]])
    b = np.array([[big + 1j * small, small - 1j * big],
                  [-big - 1j * small, big + 1j * small],
                  [small + 1j * big, -3.0 + 1j * big],
                  [big + 1j * small, big - 1j * small]])
    ta, tb = (tuple(torch.from_numpy(x) for x in _planes(z)) for z in (a, b))
    ext = tcg.accurate_extract(ta, tb, "FP8")
    ja = jcg._extract_ub_lanes(*(jnp.asarray(x) for x in _planes(a)), 0, "FP8")
    jb = jcg._extract_ub_lanes(*(jnp.asarray(x) for x in _planes(b)), 1, "FP8")
    for got, ref in zip(ext[0] + ext[1], ja + jb):
        _bits_equal(got.to(torch.float32) if got.dtype == torch.bfloat16
                    else got, np.asarray(ref).astype(np.float32)
                    if ref.dtype == jnp.bfloat16 else ref)
    ua_r, ua_i, ua_ri, pre_a = ext[0]
    assert float(ua_r[0, 0]) == 258 and float(ua_i[0, 0]) == 1
    assert float(ua_ri[0, 0]) == 256                 # not 257
    assert float(ua_ri[0, 1]) == -256
    d = tcg.accurate_estimate(ext, "FP8")
    bound = tcg._combine_3m_bound(d).numpy()
    exact_diff = ((ua_r.double() - ua_i.double())
                  @ (ext[1][0].double() - ext[1][1].double())).numpy()
    assert np.any(d[0].numpy() < exact_diff)        # the lost unit shows
    pre_b = ext[1][3]
    for i in range(a.shape[0]):
        for j in range(b.shape[1]):
            re = sum(Fraction(a[i, q].real) * Fraction(b[q, j].real)
                     - Fraction(a[i, q].imag) * Fraction(b[q, j].imag)
                     for q in range(a.shape[1]))
            im = sum(Fraction(a[i, q].real) * Fraction(b[q, j].imag)
                     + Fraction(a[i, q].imag) * Fraction(b[q, j].real)
                     for q in range(a.shape[1]))
            scale = Fraction(2) ** int(pre_a[i] + pre_b[j])
            assert Fraction(float(bound[i, j])) >= max(abs(re), abs(im)) * scale
    # the accurate product on these operands is right to f64 precision
    got = gt.gemm(a, b, num_moduli=14, backend="FP8", fastmode=False,
                  device="cpu").numpy()
    exact = a @ b
    assert np.abs(got - exact).max() < 1e-12 * np.abs(exact).max()


def test_herk_fp8_still_refused():
    a = np.ones((4, 8), C128)
    for fn in (lambda: gt.herk(a, backend="FP8", device="cpu"),
               lambda: gt.herk_planar(a.real, a.imag, backend="FP8",
                                      device="cpu")):
        with pytest.raises(NotImplementedError, match="use gemm"):
            fn()
