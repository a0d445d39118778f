"""The encoders' division-free reduction (csrc/encode.cuh, reduce_biased and
limb_residue; csrc/encode.cu's byte packing) mirrored in numpy with the
plan's constants from kernels._encode_plan, held against np.mod and against
quantize.residues_wrapped's wrap (the JAX package's too), for every INT8 and
FP8 modulus the plans of nu = 2 .. 20 carry.

The device step, for the limb dot acc of one element and modulus p:
    u = (acc + bias) mod 2^32        (unsigned sums; true value in [0, 2^32))
    q = (u * magic) >> 32            (umulhi)
    r = u - q * p                    (in [0, 2p))
    r = min(r, (r - p) mod 2^32)     (in [0, p))
    residue = r - floor(p / 2)
"""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest

from gemmul8_tpu import tables as jt
from gemmul8_tpu_torch import kernels, quantize as tq, tables

BACKENDS = ("INT8", "FP8")
# the bound the limb dot stays within (csrc/encode.cuh): 6 limbs of at most
# 2^19 times weights of at most 545 in magnitude
ACC_BOUND = 6 * 2 ** 19 * 545
M32 = np.uint64(0xFFFFFFFF)


def device_reduce(acc, p, magic, bias):
    """reduce_biased + limb_residue's wrap in uint64 arithmetic, 32-bit
    wraps made explicit."""
    acc = np.asarray(acc, np.int64)
    if p & (p - 1) == 0:                      # the mask of a power-of-two p
        return ((acc + p // 2) & (p - 1)) - p // 2
    u = acc + np.int64(bias)
    assert u.min() >= 0 and u.max() < 2 ** 32, "biased sum leaves [0, 2^32)"
    u = u.astype(np.uint64)
    q = (u * np.uint64(magic)) >> np.uint64(32)
    r = (u - q * np.uint64(p)) & M32
    assert r.max() < 2 * p
    r = np.minimum(r, (r - np.uint64(p)) & M32)
    return r.astype(np.int64) - p // 2


def wrap_ref(acc, p):
    """quantize.residues_wrapped's wrap: remainder, then [-p/2, p/2)."""
    r = np.mod(np.asarray(acc, np.int64), p)
    return np.where(2 * r >= p, r - p, r)


def _moduli_of_plans():
    """(backend, nu, modulus index, p, magic, bias) from each plan."""
    out = []
    for backend in BACKENDS:
        for nu in range(2, 21):
            plan = kernels._encode_plan(nu, backend)
            for i in range(nu):
                out.append((backend, nu, i, plan.p[i], plan.magic[i],
                            plan.bias[i]))
    return out


PLAN_MODULI = _moduli_of_plans()


def _edge_values(p):
    """The extremes +-ACC_BOUND and +-REDUCE_RANGE and their neighbours, and
    each multiple of p and its neighbours near 0 and near the bound."""
    vals = []
    for b in (ACC_BOUND, kernels.REDUCE_RANGE):
        vals += [s * b + d for s in (-1, 1) for d in (-2, -1, 0)]
    for centre in (0, ACC_BOUND - 64 * p, -ACC_BOUND + 64 * p,
                   kernels.REDUCE_RANGE - 64 * p):
        base = centre - centre % p
        for j in range(-64, 64):
            vals += [base + j * p - 1, base + j * p, base + j * p + 1]
    v = np.asarray(vals, np.int64)
    return v[np.abs(v) <= kernels.REDUCE_RANGE]


@pytest.mark.parametrize("backend", BACKENDS)
def test_reduce_edges_every_plan_modulus(backend):
    seen = set()
    for b, _, _, p, magic, bias in PLAN_MODULI:
        if b != backend or p in seen:
            continue
        seen.add(p)
        acc = _edge_values(p)
        np.testing.assert_array_equal(device_reduce(acc, p, magic, bias),
                                      wrap_ref(acc, p), err_msg=f"p={p}")
    assert seen == set(tables.moduli(backend))


@pytest.mark.parametrize("backend", BACKENDS)
def test_reduce_random_sample(backend):
    rng = np.random.default_rng(20261017)
    acc = rng.integers(-ACC_BOUND, ACC_BOUND + 1, 10 ** 5)
    for p in tables.moduli(backend):
        magic, bias = kernels.reduce_constants(p)
        got = device_reduce(acc, p, magic, bias)
        np.testing.assert_array_equal(got, wrap_ref(acc, p), err_msg=f"p={p}")
        # the JAX package's wrap of the same residues
        jr = np.asarray(jnp.remainder(jnp.asarray(acc, jnp.int64), p))
        np.testing.assert_array_equal(got, np.where(2 * jr >= p, jr - p, jr))


def test_plan_constants_match_every_plan():
    """Each plan carries its moduli's constants, and the JAX package's
    moduli are the port's."""
    for backend, nu, i, p, magic, bias in PLAN_MODULI:
        assert p == tables.moduli(backend)[i] == jt.moduli(backend)[i]
        assert (magic, bias) == kernels.reduce_constants(p)
        if p & (p - 1):
            assert magic == 2 ** 32 // p and (bias - p // 2) % p == 0
            assert kernels.REDUCE_RANGE <= bias - p // 2 < \
                kernels.REDUCE_RANGE + p
            assert 2 * kernels.REDUCE_RANGE + p + p // 2 <= 2 ** 32


def test_limb_dot_stays_in_the_exact_range():
    """The largest |acc| the limbs can give (balanced limbs below 2^19, the
    plan's weights) is inside the range the reduction is exact on."""
    for backend in BACKENDS:
        for nu in range(2, 21):
            nl = tq.n_limbs(nu, backend)
            for ws in tq.limb_weights(nu, backend):
                worst = 2 ** 19 * (1 + sum(abs(w) for w in ws[1:]))
                assert worst <= ACC_BOUND <= kernels.REDUCE_RANGE
                assert len(ws) == nl <= kernels._MAX_NL


def test_plan_structures_fit_common_cuh():
    """kernels._EncodePlan mirrors csrc/common.cuh's EncodePlan: 3 ints,
    p[20], w[20][6], magic[20], bias[20]; the FP8 plan embeds it."""
    assert ctypes.sizeof(kernels._EncodePlan) == 4 * (3 + 20 + 20 * 6 + 20
                                                      + 20)
    assert kernels._EncodePlan.magic.offset == 4 * (3 + 20 + 20 * 6)
    assert kernels._EncodePlan.bias.offset == kernels._EncodePlan.magic.offset \
        + 4 * 20
    assert ctypes.sizeof(kernels._EncodePlanFp8) == (
        ctypes.sizeof(kernels._EncodePlan) + 4 * (20 + 20 + 60))
    plan = kernels._encode_plan(20, "FP8")
    assert all(0 <= plan.magic[i] < 2 ** 32 and 0 <= plan.bias[i] < 2 ** 32
               for i in range(20))
    text = open(kernels._CSRC + "/common.cuh").read()
    assert f"#define G8_REDUCE_RANGE {kernels.REDUCE_RANGE}u" in text


def test_byte_packing_mirror():
    """encode.cu's residue_word: four reduced r = (acc + bias) mod p =
    (acc + floor(p/2)) mod p in [0, p) as bytes, floor(p/2)
    taken off each byte by one wrap-around SIMD subtraction, read back as
    int8, equal the wrapped residues; for p = 256 the low byte of limb 0 as
    it stands (every other limb weight is 0 mod 256)."""
    rng = np.random.default_rng(5)
    for p in tables.moduli("INT8"):
        acc = rng.integers(-ACC_BOUND, ACC_BOUND + 1, (1000, 4))
        if p == 256:
            word = (acc & 0xFF) << (8 * np.arange(4))
        else:
            r = np.mod(acc + p // 2, p)
            word = r << (8 * np.arange(4))
        word = word.sum(1).astype(np.uint32)
        if p != 256:
            h4 = np.uint32((p >> 1) * 0x01010101)
            lanes = [((word >> (8 * e)) - (h4 >> (8 * e))) & 0xFF
                     for e in range(4)]
            word = sum(np.uint32(v) << np.uint32(8 * e)
                       for e, v in enumerate(lanes)).astype(np.uint32)
        got = word.view(np.int8).reshape(-1, 4)
        np.testing.assert_array_equal(got, wrap_ref(acc, p), err_msg=f"p={p}")


@pytest.mark.parametrize("width", [1, 3, 4, 5, 8, 130])
def test_encode_vec_needs_aligned_whole_words(width):
    """csrc/encode.cu stores words only where the planes' contiguous axis is
    a multiple of 4 and the pointers are 16-byte aligned."""
    import torch
    for axis in (0, 1):
        shape = (width, 7) if axis == 1 else (7, width)
        x = torch.zeros(shape, dtype=torch.float64)
        out = torch.zeros((2, *shape), dtype=torch.int8)
        assert kernels._encode_vec(x, out, axis) == (width % 4 == 0)
        shifted = torch.zeros(out.numel() + 1, dtype=torch.int8)[1:]
        assert not kernels._encode_vec(x, shifted.view(out.shape), axis)


@pytest.mark.parametrize("width", [3, 4, 8])
def test_encode_vec_reads_im_aligned(width):
    """The lane encoders (K1l, K6c) read A's Im with 16-byte loads as they
    read Re: words only where im is aligned too; B reads both by element."""
    import torch
    for axis in (0, 1):
        shape = (width, 8) if axis == 1 else (8, width)
        x = torch.zeros(shape, dtype=torch.float64)
        out = torch.zeros((3, 2, *shape), dtype=torch.int8)
        im = torch.zeros(shape, dtype=torch.float64)
        moved = torch.zeros(x.numel() + 1, dtype=x.dtype)[1:].view(shape)
        assert kernels._encode_vec(x, out, axis, im) == (width % 4 == 0)
        assert kernels._encode_vec(x, out, axis, moved) == (
            width % 4 == 0 and axis == 1)
