"""On-card smoke test of gemmul8_tpu_torch: builds the CUDA kernels, holds each
against its plain PyTorch version bit for bit, drives the main paths at 8192^3
-- real DGEMM/SGEMM and complex ZGEMM/CGEMM and herk (fast mode, INT8), real
DGEMM/SGEMM on the FP8 backend, and accurate mode (fastmode=False) on real
INT8 and FP8 DGEMM, SGEMM, ZGEMM, herk and syrk, with syrk's default robust
mode and gemm_batched (8 x 2048^3) -- and the entry points built on them
at the same width: precomputed operands (precompute, gemm_quantized), the
striped path on a 32768 x 32768 x 8192 DGEMM that does not fit
unstriped, gemm_with_phases, the compat layer on column-major CUDA
buffers, and the interposer (a @ b, ZGEMM, an MLP's forward and backward,
a worker thread), complex FP8 (ZGEMM nu=14 and 18, CGEMM nu=7, accurate
ZGEMM nu=14: the lane encoder, the FP8 products a lane at a time, the
reassembly and the complex epilogues on the FP8 plan), compare's
Ozaki-I baseline at 4096^3, and the dense solvers over those kernels
(getrf, solve with iterative refinement, potrf, posv, inv, trsm, trmm,
geqrf, qr at 8192^2, lstsq at 16384 x 8192, eigh and svd at 2048^2, complex
solve and qr at 4096^2: their products against the block loops, their
accuracy beside cuSOLVER's, the 300^2 calls against the CPU path within a
tolerance) -- checks their launch counts, their accuracy
against an extended-precision oracle and their bits against gemm's and the
package's own CPU path (blas3 and compare included), checks that the FP8
tensor-core products are exact, and times the kernels, the int8 and FP8
products and the whole calls. It also
holds the probe tools' kernels (the hand-written int8 product, both
schedules, and the tensor-core CRT epilogue) against their plain versions and
the DGEMM path's own products and epilogue, and runs the probes' tables
(gemmul8_tpu_torch.probes). Last in phase 4 it runs the ten examples
(gemmul8_tpu_torch.examples) and the four benchmark probes (accuracy,
flops, big_flops and power, the last sampling the draw through
nvidia-smi), each with its launches, and phase 5 holds their results
against the CPU path. Then the device stress sweep (probes.device_stress:
40 random real trials and 8 planar ones at shapes 8-399, each within the
tool's tolerance and bit-equal to the CPU path, and the hand-written int8
products at every trial's shape on both routes) and the rank-2k probe
(probes.blas3_perf: syr2k and her2k against two gemm calls at 4096, nu=16);
phase 5 ends with ff.crt_limbs, the piece-wise CRT cross-check, on the
8192^2 paths' own residues, bit-equal to the CPU path and within P * 2^-78
of crt_limbs_matrix.

    python3 chip_smoke.py            # needs one CUDA card and nvcc

The last line of standard output is {"ok": true, "device": {...}}; the line
before it is the per-kernel JSON summary. Any failed check raises, so the run
exits non-zero. Without CUDA it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from torch.utils._python_dispatch import TorchDispatchMode

from gemmul8_tpu_torch.probes import budget_query
from gemmul8_tpu_torch.probes.timing import cuda_ms, cuda_times, in_turns

SEED = 20261016
FULL = 8192
# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W): the int8
# tensor-core rate, HBM3 bandwidth, 32-bit operations outside the tensor cores
# (67 TFLOP/s of f32 counting an FMA as two: 128 lanes x 132 SMs x 1.98 GHz,
# which is also each SM's issue limit of four 32-lane instructions per clock,
# so no mix of int32 and f32 instructions runs faster) and f64 operations
# outside the tensor cores (34 TFLOP/s, FMA as two)
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
PEAK_OPS32 = 67e12 / 2
PEAK_OPS64 = 34e12 / 2
PATHS = ((torch.float64, 16), (torch.float32, 8))     # main path: dtype, nu
# the FP8 backend's main paths: log2P 64.33 at nu=14 (>= INT8 nu=16's 62.19)
# and 33.02 at nu=7 (>= INT8 nu=8's 31.29)
FP8_PATHS = ((torch.float64, 14), (torch.float32, 7))
TAG = {torch.float64: "f64", torch.float32: "f32",
       torch.complex128: "c128", torch.complex64: "c64"}
# complex main paths: name, dtype, nu, entry, and the launches of one call
# (encode kernel, int8 products, complex epilogue, recombine, real epilogue)
CPATHS = (("zgemm16", torch.complex128, 16, "gemm", (4, 48, 1, 0, 0)),
          ("cgemm8", torch.complex64, 8, "gemm", (4, 24, 1, 0, 0)),
          ("zgemm20", torch.complex128, 20, "gemm", (4, 60, 0, 1, 2)),
          ("herk16", torch.complex128, 16, "herk", (2, 48, 1, 0, 0)))
COUNT_KEYS = ("encode_planes", "_int_mm", "fused_epilogue_complex",
              "fused_recombine_3m", "fused_epilogue")
# an FP8 path's launches: FP8 encodes, FP8 products, FP8 epilogue, and none
# of the INT8 path's (encode, int8 products, real epilogue)
FP8_COUNT_KEYS = ("encode_planes_fp8", "_scaled_mm", "fused_epilogue_fp8",
                  "encode_planes", "_int_mm", "fused_epilogue")
# the probe tools' int8 products: kernels entry, probes module and function,
# the kernel's schedule and K stage depth, and the Pallas function replaced.
# The functions take the wgmma kernel wherever TMA can address the operands
# (kernels._product_route), as at the probes' own sizes; it stages 128 bytes
# of K whatever the depth, so there mm_flat_kloop and mm_flat_kloop_multidot
# make the same launch (their entries say so: same_launch_as).
PROBE_PRODUCTS = (
    ("matmul_i8[seq]", "fused", "matmul_i8_seq", "kloop", 64,
     "tools/probe_fused.py:24"),
    ("matmul_i8[astat]", "fused", "matmul_i8_astat", "astat", 64,
     "tools/probe_fused.py:98"),
    ("mm_flat[kloop]", "matmul3", "mm_flat_kloop", "kloop", 64,
     "tools/probe_matmul3.py:31"),
    ("mm_flat[fullk]", "matmul3", "mm_flat_fullk", "astat", 64,
     "tools/probe_matmul3.py:67"),
    ("mm_flat[kloop_multidot]", "matmul3", "mm_flat_kloop_multidot", "kloop",
     128, "tools/probe_matmul3.py:90"),
)
# each entry's rows in its probe's table: the name prefix, and the row timed
# for the entry (the tool's own layout, B n-contiguous)
PROBE_ROWS = {"matmul_i8[seq]": ("seq", "seq B n-contiguous"),
              "matmul_i8[astat]": ("astat", "astat B n-contiguous"),
              "mm_flat[kloop]": ("flat-kloop", "flat-kloop"),
              "mm_flat[fullk]": ("flat-fullk", "flat-fullk"),
              "mm_flat[kloop_multidot]": ("flat-multidot", "flat-multidot")}
# the mma.sync product kernel (csrc/matmul_i8.cu), reached by kernel=
# "mma_sync" and by the shapes TMA cannot address: entry, schedule, K depth,
# its rows in the probe tables ((probe, name prefix), ...) and the row timed
MMA_SYNC = (
    ("matmul_i8_mma_sync[kloop bk64]", "kloop", 64,
     (("fused", "mma.sync seq bk64"), ("matmul3", "mma.sync flat-kloop")),
     "mma.sync seq bk64 B n-contiguous"),
    ("matmul_i8_mma_sync[kloop bk128]", "kloop", 128,
     (("fused", "mma.sync seq bk128"), ("matmul3", "mma.sync flat-multidot")),
     "mma.sync seq bk128 B n-contiguous"),
    ("matmul_i8_mma_sync[astat bk64]", "astat", 64,
     (("fused", "mma.sync astat"), ("matmul3", "mma.sync flat-fullk")),
     "mma.sync astat B n-contiguous"),
)
TRANSPOSE_KEY = "transpose_i8[4096^2 nu=16]"
PRODUCT_COUNTS = ("matmul_i8_kloop", "matmul_i8_astat", "matmul_i8_wgmma_kloop",
                  "matmul_i8_wgmma_astat", "transpose_i8")
MXU_KEY = "fused_epilogue_mxu[pair nu=16]"
# the sources of the kernels redesigned last (K6, K8, K3) and of the complex
# FP8 kernels (K6c, K3r): phase 2 sums up their registers and spills
REDESIGNED = ("encode_fp8.cu", "epilogue_mxu.cu", "epilogue_fp8.cu")
COMPLEX_FP8_SOURCES = ("encode_lanes_fp8.cu", "reassemble_fp8.cu")
PROBE_NU, PROBE_M = 16, 4096          # the product probes' own size
T0 = time.perf_counter()


def log(*a):
    print(*a, flush=True)


def log_phase(name):
    log(f"-- {name} done at {time.perf_counter() - T0:.1f}s")


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def phi_matrix(rng, m, n, phi, dtype=np.float64):
    """(U-0.5) * exp(N * phi): the reference's difficulty-controlled input."""
    u = rng.random((m, n))
    z = rng.standard_normal((m, n))
    return ((u - 0.5) * np.exp(z * phi)).astype(dtype)


def edge_corpus(dtype):
    """Zero rows, 2^-120, -2^100 and pi in alternate columns."""
    x = np.zeros((32, 128))
    x[1] = 2.0 ** -120
    x[2] = -(2.0 ** 100)
    x[3, ::2] = np.pi
    return x.astype(dtype)


def max_median_relerr(c, ref):
    """Max and median elementwise relative error (reference metric,
    testing/eval.hpp:452-532)."""
    c = np.asarray(c, np.longdouble)
    ref = np.asarray(ref, np.longdouble)
    denom = np.abs(ref)
    denom = np.where(denom == 0, np.longdouble(1), denom)
    err = np.abs(c - ref) / denom
    return float(np.max(err)), float(np.median(err))


def first_diff(got, ref):
    bad = (got != ref).nonzero()
    idx = tuple(int(v) for v in bad[0])
    return idx, got[idx].item(), ref[idx].item(), int(bad.shape[0])


# per kernel entry ("encode_planes[f64]": the encode of an f64 operand,
# "fused_epilogue[f32]": the epilogue with f32 output, ...): the cases held
# against the plain version in phases 3-4, and the largest |kernel - plain|
# over finite elements (non-finite ones are held by the bit-equality check)
CASES: dict[str, int] = {}
MAX_ABS_ERR: dict[str, float] = {}


def _flat(x):
    """A kernel output as a 2-D real tensor (a complex one as its real and
    imaginary parts side by side)."""
    if x.is_complex():
        x = torch.view_as_real(x).flatten(-2)
    return x.reshape(-1, x.shape[-1])


def max_abs_err(got, ref):
    """The largest |got - ref| over the elements finite in both."""
    err = 0.0
    # in row blocks, so that the f64 copies of full-size planes stay small
    for g, r in zip(_flat(got).split(2048), _flat(ref.to(got.device))
                    .split(2048)):
        g, r = g.double(), r.double()
        fin = torch.isfinite(g) & torch.isfinite(r)
        if bool(fin.any()):
            err = max(err, float((g - r).abs()[fin].max()))
    return err


def compare(key, got, ref, what, count=True):
    """Hold a kernel's output (a tensor or a tuple of them) against its plain
    version, bit for bit; MAX_ABS_ERR[key] keeps the largest |kernel -
    plain| over finite elements, 0 where the bits are equal (a difference
    raises with its size)."""
    torch.cuda.synchronize()
    pairs = list(zip(got, ref)) if isinstance(got, tuple) else [(got, ref)]
    for g0, r0 in pairs:
        if not bits_equal(g0, r0, what):
            assert_bits_equal(g0, r0, what,
                              f" (max abs error {max_abs_err(g0, r0)!r})")
    MAX_ABS_ERR.setdefault(key, 0.0)
    if count:
        CASES[key] = CASES.get(key, 0) + 1


def bits_equal(got, ref, what):
    """Whether got and ref (of one shape and dtype) hold the same bits,
    compared on got's device."""
    check(got.shape == ref.shape and got.dtype == ref.dtype,
          f"{what}: {got.shape}/{got.dtype} vs {ref.shape}/{ref.dtype}")
    ref = ref.to(got.device)
    if got.is_complex():
        got, ref = torch.view_as_real(got), torch.view_as_real(ref)
    if got.is_floating_point():
        return torch.equal(got.contiguous().view(torch.uint8),
                           ref.contiguous().view(torch.uint8))
    return torch.equal(got, ref)


def assert_bits_equal(got, ref, what, extra=""):
    if not bits_equal(got, ref, what):
        got, ref = got.cpu(), ref.cpu()
        if got.is_complex():
            got, ref = torch.view_as_real(got), torch.view_as_real(ref)
        if got.dtype == torch.float8_e4m3fn:          # compare the bytes
            got, ref = got.view(torch.uint8), ref.view(torch.uint8)
        idx, g, r, n = first_diff(got, ref)
        raise AssertionError(f"{what}: {n} elements differ, first at {idx}: "
                             f"{g!r} vs {r!r}{extra}")


def run_counted(fn):
    """fn() with every launch count set to 0 just before and read just
    after; torch._int_mm and torch._scaled_mm calls (the library products)
    are counted by wrappers around them, the _int_mm calls made inside
    accurate mode's estimation products apart as "estimate_int_mm", and the
    fast shifts' calls (quantize.shift_fast, plain torch) as "shift_fast"."""
    from gemmul8_tpu_torch import kernels, quantize
    names = ("_int_mm", "_scaled_mm")
    orig = {name: getattr(torch, name) for name in names}
    orig_estimate = quantize.estimate_gemm
    orig_shift = quantize.shift_fast
    calls = dict.fromkeys(names + ("estimate_int_mm", "shift_fast"), 0)

    def counted(name):
        def call(*a, **k):
            calls[name] += 1
            return orig[name](*a, **k)
        return call

    def estimate(*a, **k):
        before = calls["_int_mm"]
        out = orig_estimate(*a, **k)
        calls["estimate_int_mm"] += calls["_int_mm"] - before
        return out

    def shift(*a, **k):
        calls["shift_fast"] += 1
        return orig_shift(*a, **k)

    kernels.reset_launches()
    for name in names:
        setattr(torch, name, counted(name))
    quantize.estimate_gemm = estimate
    quantize.shift_fast = shift
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        for name in names:
            setattr(torch, name, orig[name])
        quantize.estimate_gemm = orig_estimate
        quantize.shift_fast = orig_shift
    counts = dict(kernels.LAUNCHES)
    counts.update(calls)
    return out, counts


def log_build_report(kernels):
    """Each source's kernels with their registers and spills (nvcc -Xptxas
    -v, kernels.BUILD_LOG); fails if a source has no report or the wgmma
    product's setmaxnreg was ignored (ptxas warning C7508)."""
    import os
    sources = sorted(n for n in os.listdir(kernels._CSRC) if n.endswith(".cu"))
    for name in sources:
        check(name in kernels.BUILD_LOG, f"{name}: no ptxas report")
        text = kernels.BUILD_LOG[name]
        rows = kernels.ptxas_report(text)
        check(rows, f"{name}: no kernel in its ptxas report")
        log(f"ptxas {name}: " + "; ".join(
            f"{k} {r} registers, spills {st}/{ld} bytes"
            for k, r, st, ld in rows))
    check("C7508" not in kernels.BUILD_LOG["matmul_i8_wgmma.cu"],
          "matmul_i8_wgmma.cu: setmaxnreg ignored (C7508)")
    for name in REDESIGNED + COMPLEX_FP8_SOURCES:
        rows = kernels.ptxas_report(kernels.BUILD_LOG[name])
        log(f"ptxas {name} ("
            f"{'redesigned' if name in REDESIGNED else 'complex FP8'}): "
            f"{len(rows)} kernels, registers "
            f"{min(r for _, r, _, _ in rows)}-{max(r for _, r, _, _ in rows)}, "
            f"spill bytes stored/loaded {sum(st for *_, st, _ in rows)}/"
            f"{sum(ld for *_, ld in rows)}")
    # K4 and K5 on the FP8 plan: the same instantiations as on the INT8 one
    # (K4 per limb count: the FP8 plan takes L 3-7 for f64 out, 3-5 for f32
    # out; K5 per output type, int32 new for FP8)
    for k, r, st, ld in kernels.ptxas_report(kernels.BUILD_LOG["complex.cu"]):
        log(f"ptxas complex.cu on the FP8 plan: {k} {r} registers, spills "
            f"{st}/{ld} bytes")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def encode_cases(rng, erng):
    """K1 against its plain version: f64 and f32, both sides, on random
    operands and the edge corpus (from rng); and, from erng, for every nu
    (2-20 for f64, 2-13 for f32), operands whose plane widths are not
    multiples of the kernel's 4-element words and whose row counts are odd
    (x 129 x 263, so both sides take the byte-store tail), and one of
    aligned widths (132 x 260)."""
    from gemmul8_tpu_torch import kernels, quantize

    def case(x_np, nu):
        x = torch.from_numpy(x_np).cuda()
        for axis in (0, 1):
            sft = quantize.shift_fast(x, nu, "INT8", 1 - axis)
            compare(f"encode_planes[{TAG[x.dtype]}]",
                    kernels.encode_planes(x, sft, axis, nu, "INT8"),
                    kernels.encode_planes_plain(x, sft, axis, nu, "INT8"),
                    f"encode {x.dtype} {tuple(x.shape)} nu={nu} axis={axis}")

    for dt, nus in ((np.float64, (8, 16, 20)), (np.float32, (8, 13))):
        for nu in nus:
            for x_np in (phi_matrix(rng, 200, 392, 0.5, dt),
                         phi_matrix(rng, 77, 130, 4.0, dt), edge_corpus(dt)):
                case(x_np, nu)
    for dt, top in ((np.float64, 20), (np.float32, 13)):
        for nu in range(2, top + 1):
            case(phi_matrix(erng, 129, 263, 2.0, dt), nu)
            case(phi_matrix(erng, 132, 260, 0.5, dt), nu)


def epilogue_cases(rng):
    from gemmul8_tpu_torch import kernels, tables
    for nu in (8, 16, 20):
        mods = tables.moduli("INT8")[:nu]
        for chunked in (False, True):
            m, k = (136, 200)
            if chunked:   # K-chunked sums of [0, p) residues, 3 chunks
                chi = np.stack([rng.integers(0, 3 * p, (m, k)) for p in mods])
            else:         # any int32 value
                chi = rng.integers(-2 ** 31, 2 ** 31, (nu, m, k))
            chi = torch.from_numpy(chi.astype(np.int32)).cuda()
            sa = torch.from_numpy(rng.integers(-40, 90, m).astype(np.int32)).cuda()
            sb = torch.from_numpy(rng.integers(-40, 90, k).astype(np.int32)).cuda()
            for out in (torch.float32, torch.float64):
                compare(f"fused_epilogue[{TAG[out]}]",
                        kernels.fused_epilogue(chi, sa, sb, nu, "INT8", out),
                        kernels.fused_epilogue_plain(chi, sa, sb, nu, "INT8",
                                                     out),
                        f"epilogue nu={nu} chunked={chunked} out={out}")


# ragged shapes of K2, K3 and K4: m*n odd, one row, one column, n not a
# multiple of the columns a thread takes (4 in K2 and K3, 2 in K4), and whole
# ones
RAGGED = ((129, 263), (1, 263), (129, 1), (33, 20), (31, 9), (17, 264),
          (64, 256))


def on_card(x, misalign=False):
    """A numpy array on the card; misaligned: a contiguous view one element
    into a larger buffer (off 16-byte alignment)."""
    t = torch.from_numpy(x).cuda()
    if not misalign:
        return t
    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    return buf[1:1 + t.numel()].view(t.shape).copy_(t)


def ragged_epilogue_cases(rng, krng):
    """K2 (int32 input: f32 and f64 out; int8 input: f32 and f64), K3 (f32
    and f64 out, nu 2, 7, 14 and 20, on integer lane products spanning
    [-2^24, 2^24], drawn from krng) and K4 (planar f32 and f64, interleaved
    c64 and c128) against their plain versions on RAGGED, once on a stack
    that starts off 16-byte alignment, and twice with shifts up to +-600,
    whose sums take some elements' limb exponents outside the one-multiply
    f64 range (crt.cuh: emit_f64_direct). Checks that each kernel took both
    its routes: whole vectors and one column at a time
    (kernels._epilogue_vec)."""
    from gemmul8_tpu_torch import kernels
    routes = {}
    tensor = on_card

    def route(key, n, cols, chi):
        routes.setdefault(key, set()).add(kernels._epilogue_vec(n, cols, chi))

    cases = [(m, n, False, False) for m, n in RAGGED] + [
        (17, 264, True, False), (129, 263, False, True), (64, 256, False, True)]
    for m, n, misalign, wide in cases:
        lo, hi = (-600, 600) if wide else (-40, 90)
        sa = torch.from_numpy(rng.integers(lo, hi, m).astype(np.int32)).cuda()
        sb = torch.from_numpy(rng.integers(lo, hi, n).astype(np.int32)).cuda()
        shape = (f"{m}x{n}{' misaligned' if misalign else ''}"
                 f"{' wide shifts' if wide else ''}")
        for nu in (8, 16, 20):
            chi = tensor(rng.integers(-2 ** 31, 2 ** 31, (nu, m, n))
                         .astype(np.int32), misalign)
            route("K2 int32", n, kernels.EPILOGUE_COLS["fused_epilogue"], chi)
            for out in (torch.float32, torch.float64):
                compare(f"fused_epilogue[{TAG[out]}]",
                        kernels.fused_epilogue(chi, sa, sb, nu, "INT8", out),
                        kernels.fused_epilogue_plain(chi, sa, sb, nu, "INT8",
                                                     out),
                        f"epilogue {shape} nu={nu} out={out}")
        for nu in (16, 20):
            mid = tensor(rng.integers(-128, 128, (nu, m, n)).astype(np.int8),
                         misalign)
            route("K2 int8", n, kernels.EPILOGUE_COLS["fused_epilogue"], mid)
            for out in (torch.float32, torch.float64):
                compare("fused_epilogue[c128 nu=20 split]",
                        kernels.fused_epilogue(mid, sa, sb, nu, "INT8", out),
                        kernels.fused_epilogue_plain(mid, sa, sb, nu, "INT8",
                                                     out),
                        f"epilogue int8 {shape} nu={nu} out={out}")
        for nu in (2, 7, 14, 20):
            c3 = tensor(krng.integers(-2 ** 24, 2 ** 24 + 1, (3 * nu, m, n))
                        .astype(np.float32), misalign)
            route("K3", n, kernels.EPILOGUE_COLS["fused_epilogue_fp8"], c3)
            for out in (torch.float32, torch.float64):
                compare(f"fused_epilogue_fp8[{TAG[out]}]",
                        kernels.fused_epilogue_fp8(c3, sa, sb, nu, out),
                        kernels.fused_epilogue_fp8_plain(c3, sa, sb, nu, out),
                        f"fp8 epilogue {shape} nu={nu} out={out}")
        for nu in (8, 13, 16):
            chi = tensor(rng.integers(-2 ** 31, 2 ** 31, (3 * nu, m, n))
                         .astype(np.int32), misalign)
            route("K4", n, kernels.EPILOGUE_COLS["fused_epilogue_complex"], chi)
            for out in (torch.complex128, torch.float64, torch.complex64,
                        torch.float32):
                if nu > 13 and out in (torch.complex64, torch.float32):
                    continue
                key = "fused_epilogue_complex[" + (
                    "c64]" if out in (torch.complex64, torch.float32)
                    else "c128]")
                compare(key, kernels.fused_epilogue_complex(
                            chi, sa, sb, nu, "INT8", out),
                        kernels.fused_epilogue_complex_plain(
                            chi, sa, sb, nu, "INT8", out),
                        f"complex epilogue {shape} nu={nu} out={out}")
    for key, seen in routes.items():
        check(seen == {True, False}, f"{key}: routes taken {seen}")
    check(len(routes) == 4, f"ragged cases: routes of {sorted(routes)} only")
    log(f"ragged K2/K3/K4 cases: both routes taken by {sorted(routes)}")


def lane_products(rng, nu, m, n, chunked):
    """Random (3nu, m, n) int32 lane products: any int32 value, or K-chunked
    sums of three per-chunk residues in [0, p)."""
    from gemmul8_tpu_torch import tables
    if chunked:
        mods = tables.moduli("INT8")[:nu]
        chi = np.concatenate([np.stack([rng.integers(0, 3 * p, (m, n))
                                        for p in mods]) for _ in range(3)])
    else:
        chi = rng.integers(-2 ** 31, 2 ** 31, (3 * nu, m, n))
    return torch.from_numpy(chi.astype(np.int32)).cuda()


def edge_lane_products(nu, dt):
    """The lane products of the edge corpus as a complex product: A has the
    corpus as its real part and the corpus upside down as its imaginary part,
    B is A's transpose; their shifts span the corpus' extremes."""
    from gemmul8_tpu_torch import complex_gemm as cg, core
    e = torch.from_numpy(edge_corpus(np.float64)).to(dt).cuda()
    ar, ai = e, e.flip(0).contiguous()
    br, bi = ar.T.contiguous(), ai.T.contiguous()
    sa = cg._shift_complex_fast(ar, ai, nu, "INT8", 1)
    sb = cg._shift_complex_fast(br, bi, nu, "INT8", 0)
    pa = cg._quantize_complex(ar, ai, sa, 0, nu, "INT8", False)
    pb = cg._quantize_complex(br, bi, sb, 1, nu, "INT8", True)
    return core.residue_matmul(pa.reshape(3 * nu, *pa.shape[2:]),
                               pb.reshape(3 * nu, *pb.shape[2:])), sa, sb


def complex_cases(rng):
    """The complex epilogue (K4), the recombine (K5) and the real epilogue on
    K5's int8 output against their plain versions at small shapes: random and
    K-chunked lane products and the edge corpus' own; K5 + 2 x K2 equals K4 at
    nu <= 16; K2 on int8 residues equals K2 on the same values in int32."""
    from gemmul8_tpu_torch import kernels
    m, n = 136, 200
    for nu in (2, 8, 13, 16, 17, 20):
        for source in ("random", "chunked", "edge"):
            if source == "edge":
                chi, sa, sb = edge_lane_products(nu, torch.float64)
            else:
                chi = lane_products(rng, nu, m, n, source == "chunked")
                sa = torch.from_numpy(
                    rng.integers(-40, 90, m).astype(np.int32)).cuda()
                sb = torch.from_numpy(
                    rng.integers(-40, 90, n).astype(np.int32)).cuda()
            what = f"nu={nu} {source}"
            mids = kernels.fused_recombine_3m(chi, nu, "INT8")
            compare("fused_recombine_3m[c128 nu=20]", mids,
                    kernels.fused_recombine_3m_plain(chi, nu, "INT8"),
                    f"recombine {what}")
            for cdt in (torch.complex64, torch.complex128):
                real_dt = torch.float32 if cdt == torch.complex64 else \
                    torch.float64
                split = tuple(kernels.fused_epilogue(x, sa, sb, nu, "INT8",
                                                     real_dt) for x in mids)
                compare("fused_epilogue[c128 nu=20 split]", split,
                        tuple(kernels.fused_epilogue_plain(
                            x, sa, sb, nu, "INT8", real_dt) for x in mids),
                        f"split epilogue {what} out={real_dt}")
                compare("fused_epilogue[c128 nu=20 split]", split,
                        tuple(kernels.fused_epilogue(
                            x.to(torch.int32), sa, sb, nu, "INT8", real_dt)
                            for x in mids),
                        f"epilogue int8 vs int32 input {what}", count=False)
                if nu > 16 or (nu > 13 and cdt == torch.complex64):
                    continue
                key = f"fused_epilogue_complex[{TAG[cdt]}]"
                got = kernels.fused_epilogue_complex(chi, sa, sb, nu, "INT8",
                                                     cdt)
                compare(key, got, kernels.fused_epilogue_complex_plain(
                    chi, sa, sb, nu, "INT8", cdt), f"complex epilogue {what}")
                compare(key, got, torch.complex(*split),
                        f"K5 + 2 x K2 vs K4 {what} out={cdt}", count=False)
                compare(key, kernels.fused_epilogue_complex(
                            chi, sa, sb, nu, "INT8", real_dt),
                        (got.real, got.imag),
                        f"planar vs complex output {what}", count=False)


def fp8_encode_cases(rng):
    """The FP8 encoder (K6) against its plain version: f32 and f64, both
    sides, nu from the square moduli only (2) to mixed (6, 7, 13, 20), on
    random operands and the edge corpus."""
    from gemmul8_tpu_torch import kernels, quantize
    for dt, nus in ((np.float64, (2, 6, 7, 13, 20)), (np.float32, (2, 7, 13))):
        for nu in nus:
            for x_np in (phi_matrix(rng, 200, 392, 0.5, dt),
                         phi_matrix(rng, 77, 130, 4.0, dt), edge_corpus(dt)):
                x = torch.from_numpy(x_np).cuda()
                for axis in (0, 1):
                    sft = quantize.shift_fast(x, nu, "FP8", 1 - axis)
                    compare(f"encode_planes_fp8[{TAG[x.dtype]}]",
                            kernels.encode_planes_fp8(x, sft, axis, nu),
                            kernels.encode_planes_fp8_plain(x, sft, axis, nu),
                            f"fp8 encode {x.dtype} {tuple(x.shape)} nu={nu} "
                            f"axis={axis}")


def fp8_chunk_sums(rng, nu, m, n):
    """(nu, m, n) int32 K-chunked FP8 residue sums: three per-chunk wrapped
    residues each."""
    from gemmul8_tpu_torch import tables
    return torch.from_numpy(np.stack([
        rng.integers(-(p // 2), p - p // 2, (3, m, n)).sum(0)
        for p in tables.moduli("FP8")[:nu]]).astype(np.int32)).cuda()


def fp8_epilogue_cases(rng):
    """The FP8 epilogue (K3) against its plain version, f32 and f64 out, on
    the lane products of random FP8 operands and on any integers of
    |C| <= 2^24 (the K-chunk bound); the real epilogue (K2) on the FP8 plan
    against its plain version on K-chunked FP8 residue sums."""
    from gemmul8_tpu_torch import fp8, kernels, quantize
    m, n = 144, 208     # multiples of 16, as the FP8 products need
    for nu in (2, 7, 14, 20):
        a = torch.from_numpy(phi_matrix(rng, m, 320, 0.5)).cuda()
        b = torch.from_numpy(phi_matrix(rng, 320, n, 0.5)).cuda()
        sa = quantize.shift_fast(a, nu, "FP8", 1)
        sb = quantize.shift_fast(b, nu, "FP8", 0)
        lanes = fp8.residue_matmul_fp8(
            kernels.encode_planes_fp8(a, sa, 0, nu),
            kernels.encode_planes_fp8(b, sb, 1, nu))
        extreme = torch.from_numpy(rng.integers(
            -(1 << 24), (1 << 24) + 1, (3 * nu, m, n)).astype(np.float32)).cuda()
        acc = fp8_chunk_sums(rng, nu, m, n)
        for out in (torch.float32, torch.float64):
            for source, c3 in (("products", lanes), ("extreme", extreme)):
                compare(f"fused_epilogue_fp8[{TAG[out]}]",
                        kernels.fused_epilogue_fp8(c3, sa, sb, nu, out),
                        kernels.fused_epilogue_fp8_plain(c3, sa, sb, nu, out),
                        f"fp8 epilogue nu={nu} {source} out={out}")
            compare("fused_epilogue[fp8 chunked]",
                    kernels.fused_epilogue(acc, sa, sb, nu, "FP8", out),
                    kernels.fused_epilogue_plain(acc, sa, sb, nu, "FP8", out),
                    f"epilogue on FP8 chunk sums nu={nu} out={out}")


def full_size_cases(a64, b64):
    """Each kernel on the inputs each main path gives it at 8192^2: the
    encodes of A (row shifts) and B (column shifts) and the epilogue on
    their C_hi, for DGEMM nu=16 and SGEMM nu=8."""
    from gemmul8_tpu_torch import core, kernels, quantize
    for dt, nu in PATHS:
        a, b = a64.to(dt), b64.to(dt)
        sa = quantize.shift_fast(a, nu, "INT8", 1)
        sb = quantize.shift_fast(b, nu, "INT8", 0)
        planes = []
        for x, s, axis in ((a, sa, 0), (b, sb, 1)):
            got = kernels.encode_planes(x, s, axis, nu, "INT8")
            compare(f"encode_planes[{TAG[dt]}]", got,
                    kernels.encode_planes_plain(x, s, axis, nu, "INT8"),
                    f"encode full-size {dt} nu={nu} axis={axis}")
            planes.append(got)
        c_hi = core.residue_matmul(*planes)
        del planes
        for out in (torch.float32, torch.float64):
            compare(f"fused_epilogue[{TAG[out]}]",
                    kernels.fused_epilogue(c_hi, sa, sb, nu, "INT8", out),
                    kernels.fused_epilogue_plain(c_hi, sa, sb, nu, "INT8",
                                                 out),
                    f"epilogue full-size {dt} nu={nu} out={out}")
        del c_hi
        torch.cuda.empty_cache()


def full_size_fp8_cases(a64, b64):
    """Each FP8 kernel on the inputs each FP8 main path gives it at 8192^2:
    K6 on A (row shifts) and B (column shifts), K3 on their lane products
    (f32 and f64 out), and K2 on the FP8 plan on those products' wrapped
    residues (a one-chunk residue sum); the epilogues held in row blocks."""
    from gemmul8_tpu_torch import fp8, kernels, quantize
    for dt, nu in FP8_PATHS:
        a, b = a64.to(dt), b64.to(dt)
        sa = quantize.shift_fast(a, nu, "FP8", 1)
        sb = quantize.shift_fast(b, nu, "FP8", 0)
        stacks = []
        for x, s, axis in ((a, sa, 0), (b, sb, 1)):
            got = kernels.encode_planes_fp8(x, s, axis, nu)
            compare(f"encode_planes_fp8[{TAG[dt]}]", got,
                    kernels.encode_planes_fp8_plain(x, s, axis, nu),
                    f"fp8 encode full-size {dt} nu={nu} axis={axis}")
            stacks.append(got)
            torch.cuda.empty_cache()
        c3 = fp8.residue_matmul_fp8(*stacks)
        del stacks
        blk = lambda r0, r1: c3[:, r0:r1].contiguous()  # noqa: E731
        for out in (torch.float32, torch.float64):
            compare_rows(f"fused_epilogue_fp8[{TAG[out]}]",
                         kernels.fused_epilogue_fp8(c3, sa, sb, nu, out),
                         lambda r0, r1: kernels.fused_epilogue_fp8_plain(
                             blk(r0, r1), sa[r0:r1], sb, nu, out),
                         f"fp8 epilogue full-size {dt} nu={nu} out={out}")
        acc = torch.cat([fp8._reassemble(blk(r0, r0 + 1024).to(torch.int32),
                                         nu) for r0 in range(0, FULL, 1024)],
                        dim=1)
        del c3, blk
        torch.cuda.empty_cache()
        compare_rows("fused_epilogue[fp8 chunked]",
                     kernels.fused_epilogue(acc, sa, sb, nu, "FP8", dt),
                     lambda r0, r1: kernels.fused_epilogue_plain(
                         acc[:, r0:r1], sa[r0:r1], sb, nu, "FP8", dt),
                     f"epilogue on FP8 residues full-size {dt} nu={nu}")
        del acc
        torch.cuda.empty_cache()


def assert_equal_device(got, ref, what):
    """Bit-equality of two large tensors on the card (no host copy)."""
    torch.cuda.synchronize()
    check(got.shape == ref.shape and got.dtype == ref.dtype,
          f"{what}: {got.shape}/{got.dtype} vs {ref.shape}/{ref.dtype}")
    if got.is_floating_point():
        got, ref = (x.contiguous().view(torch.uint8) for x in (got, ref))
    if not torch.equal(got, ref):
        idx, g, r, n = first_diff(got, ref)
        raise AssertionError(f"{what}: {n} elements differ, first at {idx}: "
                             f"{g!r} vs {r!r}")


def full_size_probe_cases(a64, b64):
    """The probe kernels on the DGEMM 8192^3 nu=16 path's own inputs: the
    int8 products (the wgmma kernel's two schedules, the mma.sync kernel's
    three instantiations) on the path's planes (A from encode_planes, B
    k-contiguous) against core.residue_matmul (16 x torch._int_mm); K2 on the
    wgmma kernel's C_hi against gt.gemm's bits; K8 on the
    path's C_hi and shifts against its plain version and K2's plain pair (in
    row blocks), and at 24 bits hi + lo against K2's f32 output."""
    import gemmul8_tpu_torch as gt
    from gemmul8_tpu_torch import core, kernels, quantize
    from gemmul8_tpu_torch.probes.epilogue import k2_pair_plain
    nu = 16
    sa = quantize.shift_fast(a64, nu, "INT8", 1)
    sb = quantize.shift_fast(b64, nu, "INT8", 0)
    ap = kernels.encode_planes(a64, sa, 0, nu, "INT8")
    bp = kernels.encode_planes(b64, sb, 1, nu, "INT8")
    c_hi = core.residue_matmul(ap, bp)
    check(kernels._product_route(ap, bp) == "wgmma",
          "the DGEMM planes do not take the wgmma route")
    for schedule in ("kloop", "astat"):           # the wgmma kernel
        c = kernels.matmul_i8(ap, bp, schedule)
        assert_equal_device(c, c_hi, f"int8 product wgmma {schedule} vs "
                            "core.residue_matmul at 8192^3 nu=16")
        for p in PROBE_PRODUCTS:
            if p[3] == schedule:
                CASES[p[0]] = CASES.get(p[0], 0) + 1
        del c
    for entry, schedule, bk, *_ in MMA_SYNC:
        c = kernels.matmul_i8(ap, bp, schedule, bk, "mma_sync")
        assert_equal_device(c, c_hi, f"int8 product {entry} vs "
                            "core.residue_matmul at 8192^3 nu=16")
        CASES[entry] = CASES.get(entry, 0) + 1
        del c
    c = kernels.matmul_i8(ap, bp, "kloop")
    del ap, bp
    torch.cuda.empty_cache()
    out = kernels.fused_epilogue(c, sa, sb, nu, "INT8", torch.float64)
    del c
    assert_equal_device(out, gt.gemm(a64, b64, num_moduli=nu, epilogue="ff"),
                        "K2 on the int8 kernel's C_hi vs gt.gemm 8192^3 nu=16")
    del out
    torch.cuda.empty_cache()
    blk = lambda r0, r1: c_hi[:, r0:r1].contiguous()  # noqa: E731
    for out_bits in (53, 24):
        got = kernels.fused_epilogue_mxu(c_hi, sa, sb, nu, "INT8", out_bits)
        what = f"mxu epilogue full-size nu={nu} out_bits {out_bits}"
        compare_rows(MXU_KEY, got, lambda r0, r1: kernels.
                     fused_epilogue_mxu_plain(blk(r0, r1), sa[r0:r1], sb, nu,
                                              "INT8", out_bits), what)
        compare_rows(MXU_KEY, got, lambda r0, r1: k2_pair_plain(
            blk(r0, r1), sa[r0:r1], sb, nu, out_bits), f"{what} vs K2 pair")
        if out_bits == 24:
            assert_equal_device(got[0] + got[1], kernels.fused_epilogue(
                c_hi, sa, sb, nu, "INT8", torch.float32),
                f"{what}: hi + lo vs K2 f32")
        del got
    del c_hi, blk
    torch.cuda.empty_cache()


def fp8_product_cases(k=1 << 16, m=128, n=128):
    """The inputs of the FP8 exactness check: (name, A, B) with A (m, k) and
    B (k, n) int8 on the card, every value an e4m3-exact integer in
    [-16, 16], B stored column-major as both products read it:
      all16         every product 256, every sum exactly 2^24 at k = 2^16;
      swing         runs of +-256 products of lengths 2^15 .. 2^4 that swing
                    the partial sums out to +-2^23 and back;
      big_then_ones 2^15 products of 256 (2^23), then 2^15 of +1 or +-1, so
                    that a lost alignment bit shows;
      ones_then_big the same in the other order;
      random        uniform in [-16, 16]."""
    rng = np.random.default_rng(SEED + 2)
    h = k // 2
    kk = np.arange(k)
    pm1 = lambda shape: rng.choice(np.array([-1, 1]), shape)  # noqa: E731
    cases = []
    a = np.full((m, k), 16)
    b = np.full((k, n), 16)
    cases.append(("all16", a, b))
    runs = 1 << (15 - np.arange(n) % 12)
    b = 16 * np.where((kk[:, None] // runs[None, :]) % 2 == 0, 1, -1)
    a = 16 * np.where(np.arange(m) % 2 == 0, 1, -1)[:, None] * np.ones(k, int)
    cases.append(("swing", a, b))
    big_a, big_b = np.full((m, h), 16), np.full((h, n), 16)
    ones_a = np.where(np.arange(m)[:, None] < m // 2, 1, pm1((m, h)))
    ones_b = np.where(np.arange(n)[None, :] < n // 2, 1, pm1((h, n)))
    cases.append(("big_then_ones", np.concatenate([big_a, ones_a], 1),
                  np.concatenate([big_b, ones_b], 0)))
    cases.append(("ones_then_big", np.concatenate([ones_a, big_a], 1),
                  np.concatenate([ones_b, big_b], 0)))
    cases.append(("random", rng.integers(-16, 17, (m, k)),
                  rng.integers(-16, 17, (k, n))))
    return [(name, torch.from_numpy(a.astype(np.int8)).cuda(),
             torch.from_numpy(np.ascontiguousarray(b.T).astype(np.int8))
             .cuda().T) for name, a, b in cases]


def scaled_mm_chunked(a8, b8, chunk):
    """A @ B from FP8 products over K slices of `chunk`, each slice's f32
    output converted to int32 and summed there."""
    one = torch.ones((), dtype=torch.float32, device=a8.device)
    acc = None
    for lo in range(0, a8.shape[1], chunk):
        part = torch._scaled_mm(a8[:, lo:lo + chunk], b8[lo:lo + chunk], one,
                                one, out_dtype=torch.float32,
                                use_fast_accum=False).to(torch.int32)
        acc = part if acc is None else acc + part
    return acc


def fp8_exactness_cases():
    """The FP8 tensor-core products against torch._int_mm on the same
    values, bit for bit, on each case of fp8_product_cases: through the
    port's own product call (fp8.residue_matmul_fp8, K up to K_CHUNK_FP8 =
    2^16 in one product), and at every smaller power-of-two K chunk down to
    2^5 (each chunk's f32 output summed in int32). Returns, per case, the
    chunks that were exact; fails unless all were."""
    from gemmul8_tpu_torch import fp8
    exact = {}
    for name, a, b in fp8_product_cases(k=fp8.K_CHUNK_FP8):
        ref = torch._int_mm(a, b)
        a8 = a.to(torch.float32).to(torch.float8_e4m3fn)
        b8 = b.T.to(torch.float32).to(torch.float8_e4m3fn).T
        check(torch.equal(a8.to(torch.float32), a.to(torch.float32))
              and b8.stride() == (1, b8.shape[0]), f"{name}: e4m3 planes")
        got = fp8.residue_matmul_fp8(a8[None], b8[None])[0]
        assert_bits_equal(got.to(torch.int32), ref,
                          f"fp8 products {name} k={a.shape[1]}")
        exact[name] = [a.shape[1]]
        for e in range(15, 4, -1):
            got = scaled_mm_chunked(a8, b8, 1 << e)
            assert_bits_equal(got, ref, f"fp8 products {name} chunk 2^{e}")
            exact[name].append(1 << e)
        log(f"fp8 products exact: {name} (max |sum| "
            f"{int(ref.abs().max())}) at chunks {exact[name]}")
    return exact


def product_call(entry, a, b, b_kcontig):
    """One call of a probe product on (nu, m, k) x (nu, k, n) planes: the
    3-D functions take B as given; the flat ones take the flat views of
    n-contiguous B, and for k-contiguous B (which has no flat view) the
    kernel runs with the function's schedule. Checks that the call launched
    the kernel its route names (kernels._product_route)."""
    from gemmul8_tpu_torch import kernels
    from gemmul8_tpu_torch.probes import fused, matmul3
    _, module, fn, schedule, bk, _ = next(p for p in PROBE_PRODUCTS
                                          if p[0] == entry)
    route = kernels._product_route(a, b)
    key = (f"matmul_i8_wgmma_{schedule}" if route == "wgmma"
           else f"matmul_i8_{schedule}")
    n0 = kernels.LAUNCHES[key]
    nu, m, k = a.shape
    n = b.shape[2]
    if module == "fused":
        c = getattr(fused, fn)(a, b)
    elif b_kcontig:
        c = kernels.matmul_i8(a, b, schedule, bk)
    else:
        c = getattr(matmul3, fn)(a.view(nu * m, k), b.view(nu * k, n), nu=nu,
                                 m=m, k=k, n=n).view(nu, m, n)
    check(kernels.LAUNCHES[key] == n0 + 1, f"{entry}: no {key} launch")
    return c


def product_cases(rng, rng2):
    """The int8 product kernels against their plain version, B n- and
    k-contiguous: through every probe function (the wgmma kernel where TMA
    can address the operands, else the mma.sync one), and through the
    mma.sync kernel by name on every case. From rng: random planes, odd
    shapes (byte-loaded tiles, ragged edges, k = 97 and 33 on the mma.sync
    route), K past one staged tile, and the +-127 extremes at k = 2^17 (sums
    of +-2,114,060,288). From rng2, the wgmma route's edges: ragged m and n
    (2 x 130 x 320 x 200, 1 x 17 x 48 x 5), k = 16 and k = 336 (multiples
    of 16, not of the 128-byte stage), and m = 200 (a row block that would
    straddle two planes in the flat view); and transpose_i8 (n-contiguous B
    into the k-contiguous scratch) against a plain copy."""
    from gemmul8_tpu_torch import kernels
    from gemmul8_tpu_torch.probes.timing import k_contiguous
    k17 = 1 << 17

    def planes(g, nu, m, k, n):
        return tuple(torch.from_numpy(g.integers(-128, 128, shape).astype(
            np.int8)).cuda() for shape in ((nu, m, k), (nu, k, n)))

    cases = []
    for nu, m, k, n in ((2, 256, 512, 256), (3, 130, 97, 200),
                        (2, 200, 320, 136), (1, 64, 1000, 72), (2, 17, 33, 5)):
        cases.append((f"random {nu}x{m}x{k}x{n}", *planes(rng, nu, m, k, n)))
    for va, vb in ((127, 127), (-127, 127)):
        cases.append((f"{va} x {vb} at k=2^17",
                      torch.full((1, 20, k17), va, dtype=torch.int8,
                                 device="cuda"),
                      torch.full((1, k17, 24), vb, dtype=torch.int8,
                                 device="cuda")))
    for nu, m, k, n in ((2, 130, 320, 200), (1, 17, 48, 5), (2, 64, 16, 72),
                        (3, 100, 336, 264), (2, 200, 128, 300)):
        cases.append((f"random {nu}x{m}x{k}x{n}", *planes(rng2, nu, m, k, n)))
    routes = {"wgmma": 0, "mma_sync": 0}
    for what, a, b in cases:
        ref = kernels.matmul_i8_plain(a, b)
        k = a.shape[2]
        want = "wgmma" if k > 0 and k % 16 == 0 else "mma_sync"
        for b_kcontig, bb in ((False, b), (True, k_contiguous(b))):
            layout = f"B {'k' if b_kcontig else 'n'}-contiguous"
            route = kernels._product_route(a, bb)
            check(route == want, f"{what} {layout}: route {route}, want {want}")
            routes[route] += 1
            for entry, *_ in PROBE_PRODUCTS:
                compare(entry, product_call(entry, a, bb, b_kcontig), ref,
                        f"{entry} {what} {layout}")
            for entry, schedule, bk, *_ in MMA_SYNC:
                compare(entry, kernels.matmul_i8(a, bb, schedule, bk,
                                                 "mma_sync"), ref,
                        f"{entry} {what} {layout}")
            if route == "wgmma" and not b_kcontig:
                compare(TRANSPOSE_KEY, kernels.transpose_i8(bb), k_contiguous(bb),
                        f"transpose_i8 {what}")
    log(f"product cases by route: {routes}")
    check(all(routes.values()), f"a product route went untested: {routes}")


def mxu_epilogue_cases(rng):
    """The tensor-core CRT epilogue (K8) against its plain version, nu 8, 16
    and 20, out_bits 53 and 24, on any int32 C_hi with zero shifts, shifts
    in the f32 pair's range, and shifts from -40 to 300 (past 252, where the
    probe's half split fails); against K2's plain pair too, and at 24 bits
    its hi + lo against K2's f32 output."""
    from gemmul8_tpu_torch import kernels
    from gemmul8_tpu_torch.probes.epilogue import k2_pair_plain
    m, n = 136, 200
    for nu, in_range in ((8, (30, 60)), (16, (30, 60)), (20, (60, 90))):
        for lo, hi in ((0, 1), in_range, (-40, 300)):
            chi = torch.from_numpy(rng.integers(
                -2 ** 31, 2 ** 31, (nu, m, n)).astype(np.int32)).cuda()
            sa, sb = (torch.from_numpy(rng.integers(lo, hi, size).astype(
                np.int32)).cuda() for size in (m, n))
            for out_bits in (53, 24):
                what = f"mxu epilogue nu={nu} shifts [{lo}, {hi}) {out_bits}"
                got = kernels.fused_epilogue_mxu(chi, sa, sb, nu, "INT8",
                                                 out_bits)
                compare(MXU_KEY, got, kernels.fused_epilogue_mxu_plain(
                    chi, sa, sb, nu, "INT8", out_bits), what)
                compare(MXU_KEY, got, k2_pair_plain(chi, sa, sb, nu,
                                                    out_bits),
                        f"{what} vs K2's plain pair", count=False)
                if out_bits == 24:
                    compare(MXU_KEY, got[0] + got[1], kernels.fused_epilogue(
                        chi, sa, sb, nu, "INT8", torch.float32),
                        f"{what} hi + lo vs K2 f32", count=False)


# K6's ragged operands: (rows, cols) of A and of B, widths of the planes'
# contiguous axis (A's cols, B's rows) off the 4-element word (1, 3, 5, 130,
# 263) with odd counts across, and whole words (132, 256)
FP8_RAGGED = {0: ((33, 1), (17, 3), (9, 5), (31, 130), (129, 263), (33, 132),
                  (64, 256)),
              1: ((1, 33), (3, 17), (5, 9), (130, 31), (263, 129), (132, 33),
                  (256, 64))}


def fp8_out_buffer(nu, rows, cols, axis):
    """An empty e4m3 stack in encode_planes_fp8's layout that starts one
    byte into a larger buffer (off 16-byte alignment)."""
    numel = 3 * nu * rows * cols
    buf = torch.empty(numel + 16, dtype=torch.float8_e4m3fn, device="cuda")
    base = buf[1:1 + numel]
    if axis == 0:
        return base.view(3 * nu, rows, cols)
    return base.view(3 * nu, cols, rows).transpose(-1, -2)


def fp8_ragged_cases(rng):
    """K6 against its plain version on FP8_RAGGED for both sides, f64 at nu
    2, 6, 7, 13, 20 and f32 at nu 2, 7, 13, and on the edge corpus; once more
    on the odd-width shapes with x and with out off 16-byte alignment.
    Checks that each side took both its routes: whole words, and bytes
    (kernels._encode_vec)."""
    from gemmul8_tpu_torch import kernels, quantize
    routes = {}
    for dt, nus in ((np.float64, (2, 6, 7, 13, 20)), (np.float32, (2, 7, 13))):
        for nu in nus:
            for axis in (0, 1):
                cases = [(shape, False, False) for shape in FP8_RAGGED[axis]]
                cases += [(FP8_RAGGED[axis][4], True, False),
                          (FP8_RAGGED[axis][5], False, True),
                          (FP8_RAGGED[axis][6], True, True)]
                xs = [(phi_matrix(rng, *shape, 2.0, dt), mx, mo)
                      for shape, mx, mo in cases]
                xs.append((edge_corpus(dt), False, False))
                for x_np, mx, mo in xs:
                    x = on_card(x_np, mx)
                    sft = quantize.shift_fast(x, nu, "FP8", 1 - axis)
                    out = (fp8_out_buffer(nu, *x.shape, axis) if mo else
                           kernels.plane_buffer((3 * nu,), *x.shape, axis,
                                                "cuda", torch.float8_e4m3fn))
                    routes.setdefault(axis, set()).add(
                        kernels._encode_vec(x, out, axis))
                    compare(f"encode_planes_fp8[{TAG[x.dtype]}]",
                            kernels.encode_planes_fp8(x, sft, axis, nu, out),
                            kernels.encode_planes_fp8_plain(x, sft, axis, nu),
                            f"fp8 encode {x.dtype} {tuple(x.shape)} nu={nu} "
                            f"axis={axis} x misaligned={mx} out misaligned={mo}")
    for axis, seen in routes.items():
        check(seen == {True, False}, f"K6 axis {axis}: routes taken {seen}")
    log(f"ragged K6 cases: both routes taken on sides {sorted(routes)}")


def mxu_ragged_cases(rng):
    """K8 against its plain version and K2's plain pair on RAGGED and on a
    stack that starts off 16-byte alignment, nu 8, 16 and 20, out_bits 53
    and 24, shifts in [-300, 300]. Checks that K8 took both its routes:
    16-byte loads and one column at a time (kernels._epilogue_vec)."""
    from gemmul8_tpu_torch import kernels
    from gemmul8_tpu_torch.probes.epilogue import k2_pair_plain
    routes = set()
    for m, n, misalign in [(m, n, False) for m, n in RAGGED] + [
            (64, 256, True)]:
        sa, sb = (on_card(rng.integers(-300, 301, size).astype(np.int32))
                  for size in (m, n))
        for nu in (8, 16, 20):
            chi = on_card(rng.integers(-2 ** 31, 2 ** 31, (nu, m, n))
                          .astype(np.int32), misalign)
            routes.add(kernels._epilogue_vec(n, kernels.MXU_GROUP, chi))
            for out_bits in (53, 24):
                what = (f"mxu epilogue {m}x{n}{' misaligned' if misalign else ''}"
                        f" nu={nu} {out_bits}")
                got = kernels.fused_epilogue_mxu(chi, sa, sb, nu, "INT8",
                                                 out_bits)
                compare(MXU_KEY, got, kernels.fused_epilogue_mxu_plain(
                    chi, sa, sb, nu, "INT8", out_bits), what)
                compare(MXU_KEY, got, k2_pair_plain(chi, sa, sb, nu, out_bits),
                        f"{what} vs K2's plain pair", count=False)
    check(routes == {True, False}, f"K8: routes taken {routes}")
    log("ragged K8 cases: both routes taken")


# ---------------------------------------------------------------------------
# complex FP8: the lane encoder (K6c), the reassembly (K3r), and K4, K5 and
# K2 on the FP8 plan
# ---------------------------------------------------------------------------

# the complex FP8 kernel entries' keys: K6c per input dtype, K3r, K4 per
# output, K5 and K2 on K5's int32 output (the nu > 16 split)
LANES_KEY = {torch.float64: "encode_lanes_fp8[c128]",
             torch.float32: "encode_lanes_fp8[c64]"}
REASSEMBLE_KEY = "reassemble_fp8"
K4_FP8_KEY = {torch.complex128: "fused_epilogue_complex[c128 FP8]",
              torch.complex64: "fused_epilogue_complex[c64 FP8]"}
K5_FP8_KEY = "fused_recombine_3m[c128 FP8 nu=18]"
K2_FP8_SPLIT_KEY = "fused_epilogue[c128 FP8 nu=18 split]"


def lanes_out_buffer(nu, rows, cols, axis):
    """An empty (3, 3nu, rows, cols) e4m3 buffer in encode_lanes_fp8's layout
    that starts one byte into a larger buffer (off 16-byte alignment)."""
    numel = 9 * nu * rows * cols
    buf = torch.empty(numel + 16, dtype=torch.float8_e4m3fn, device="cuda")
    base = buf[1:1 + numel]
    if axis == 0:
        return base.view(3, 3 * nu, rows, cols)
    return base.view(3, 3 * nu, cols, rows).transpose(-1, -2)


def fp8_lane_residues(rng, nu, m, n, k, dt=np.float64):
    """The (3nu, m, n) int32 lane residues of a random complex FP8 product,
    as the complex path makes them (K6c, the 3nu products a lane, K3r),
    with its shifts."""
    from gemmul8_tpu_torch import complex_gemm as cg
    a = [torch.from_numpy(phi_matrix(rng, m, k, 0.5, dt)).cuda()
         for _ in range(2)]
    b = [torch.from_numpy(phi_matrix(rng, k, n, 0.5, dt)).cuda()
         for _ in range(2)]
    sa, sb = cg.shifts(a, b, nu, True, "FP8")
    pa = cg._quantize_complex(*a, sa, 0, nu, "FP8", False)
    pb = cg._quantize_complex(*b, sb, 1, nu, "FP8", True)
    return cg._fp8_lane_residues(pa, pb, nu), sa, sb


def fp8_lane_chunk_sums(rng, nu, m, n):
    """(3nu, m, n) int32 K-chunked FP8 lane residues: three per-chunk
    wrapped residues summed, each lane."""
    return torch.cat([fp8_chunk_sums(rng, nu, m, n) for _ in range(3)])


def complex_fp8_cases(rng):
    """The complex FP8 kernels against their plain versions at small shapes:
    K6c on FP8_RAGGED for both sides, f64 at nu 2, 6, 7, 14, 20 and f32 at
    nu 2, 6, 7, 13, conj on and off, on random operands and the edge corpus
    (once more with Re and Im, and with out, off 16-byte alignment), taking
    both its routes; K3r storing and accumulating at nu 2, 7, 14, 20 on
    RAGGED (and misaligned) stacks of any integers |C| <= 2^24, and on the
    lane products of random complex operands; K4 (nu <= 16) and K5 + 2 x K2
    on the FP8 plan (K5 writing int32 residues) on any int32, on K-chunked
    lane residues and on the lane residues of random operands, at nu 2, 6,
    7, 13, 14, 16, 17, 18, 20; K5 + 2 x K2 equals K4 where both run."""
    from gemmul8_tpu_torch import complex_gemm as cg, fp8, kernels
    routes = {}
    for dt, nus in ((np.float64, (2, 6, 7, 14, 20)),
                    (np.float32, (2, 6, 7, 13))):
        for nu in nus:
            for axis in (0, 1):
                shapes = FP8_RAGGED[axis]
                cases = [(shape, False, False) for shape in shapes] + [
                    (shapes[4], True, False), (shapes[5], False, True),
                    (shapes[6], True, True)]
                xs = [(phi_matrix(rng, *shape, 2.0, dt),
                       phi_matrix(rng, *shape, 0.5, dt), mx, mo)
                      for shape, mx, mo in cases]
                e = edge_corpus(dt)
                xs.append((e, e[::-1].copy(), False, False))
                for re_np, im_np, mx, mo in xs:
                    re, im = on_card(re_np, mx), on_card(im_np, mx)
                    sft = cg._shift_complex_fast(re, im, nu, "FP8", 1 - axis)
                    for conj in (False, True):
                        out = (lanes_out_buffer(nu, *re.shape, axis) if mo
                               else None)
                        got = kernels.encode_lanes_fp8(re, im, sft, axis, nu,
                                                       conj, out)
                        routes.setdefault(f"K6c axis {axis}", set()).add(
                            kernels._encode_vec(re, got, axis)
                            and (axis == 1 or im.data_ptr() % 16 == 0))
                        compare(LANES_KEY[re.dtype], got,
                                kernels.encode_lanes_fp8_plain(
                                    re, im, sft, axis, nu, conj),
                                f"fp8 lanes {re.dtype} {tuple(re.shape)} "
                                f"nu={nu} axis={axis} conj={conj} x "
                                f"misaligned={mx} out misaligned={mo}")
    for nu in (2, 7, 14, 20):
        for m, n, misalign in [(m, n, False) for m, n in RAGGED] + [
                (17, 264, True)]:
            c3, c3b = (on_card(rng.integers(-2 ** 24, 2 ** 24 + 1,
                                            (3 * nu, m, n))
                               .astype(np.float32), misalign)
                       for _ in range(2))
            out = on_card(np.zeros((nu, m, n), np.int32), misalign)
            routes.setdefault("K3r", set()).add(kernels._epilogue_vec(
                n, kernels.EPILOGUE_COLS["reassemble_fp8"], c3, out))
            what = f"fp8 reassembly {m}x{n} nu={nu} misaligned={misalign}"
            first = kernels.reassemble_fp8_plain(c3, nu)
            compare(REASSEMBLE_KEY, kernels.reassemble_fp8(c3, nu, out=out),
                    first, f"{what} store")
            compare(REASSEMBLE_KEY, kernels.reassemble_fp8(
                        c3b, nu, out=out, accumulate=True),
                    first + kernels.reassemble_fp8_plain(c3b, nu),
                    f"{what} accumulate")
    m, n, k = 144, 208, 320             # multiples of 16: the FP8 products
    for nu in (2, 7, 14, 20):
        a = [torch.from_numpy(phi_matrix(rng, m, k, 0.5)).cuda()
             for _ in range(2)]
        b = [torch.from_numpy(phi_matrix(rng, k, n, 0.5)).cuda()
             for _ in range(2)]
        sa, sb = cg.shifts(a, b, nu, True, "FP8")
        pa = cg._quantize_complex(*a, sa, 0, nu, "FP8", False)
        pb = cg._quantize_complex(*b, sb, 1, nu, "FP8", False)
        for lane in range(3):
            c3 = fp8.residue_matmul_fp8(pa[lane], pb[lane])
            compare(REASSEMBLE_KEY, kernels.reassemble_fp8(c3, nu),
                    kernels.reassemble_fp8_plain(c3, nu),
                    f"fp8 reassembly of lane {lane} products nu={nu}")
    for nu in (2, 6, 7, 13, 14, 16, 17, 18, 20):
        for source in ("random", "chunked", "lanes"):
            if source == "lanes":
                chi, sa, sb = fp8_lane_residues(rng, nu, m, n, k)
            else:
                chi = (fp8_lane_chunk_sums(rng, nu, m, n) if source ==
                       "chunked" else on_card(rng.integers(
                           -2 ** 31, 2 ** 31, (3 * nu, m, n)).astype(np.int32)))
                sa, sb = (on_card(rng.integers(-40, 90, size).astype(np.int32))
                          for size in (m, n))
            what = f"FP8 nu={nu} {source}"
            mids = kernels.fused_recombine_3m(chi, nu, "FP8")
            check(mids[0].dtype == torch.int32, f"K5 FP8 output {mids[0].dtype}")
            compare(K5_FP8_KEY, mids,
                    kernels.fused_recombine_3m_plain(chi, nu, "FP8"),
                    f"recombine {what}")
            for cdt in (torch.complex64, torch.complex128):
                real_dt = kernels.REAL_DTYPE[cdt]
                split = tuple(kernels.fused_epilogue(x, sa, sb, nu, "FP8",
                                                     real_dt) for x in mids)
                compare(K2_FP8_SPLIT_KEY, split,
                        tuple(kernels.fused_epilogue_plain(
                            x, sa, sb, nu, "FP8", real_dt) for x in mids),
                        f"split epilogue {what} out={real_dt}")
                if nu > 16 or (nu > 13 and cdt == torch.complex64):
                    continue
                got = kernels.fused_epilogue_complex(chi, sa, sb, nu, "FP8",
                                                     cdt)
                compare(K4_FP8_KEY[cdt], got,
                        kernels.fused_epilogue_complex_plain(
                            chi, sa, sb, nu, "FP8", cdt),
                        f"complex epilogue {what}")
                compare(K4_FP8_KEY[cdt], got, torch.complex(*split),
                        f"K5 + 2 x K2 vs K4 {what} out={cdt}", count=False)
                compare(K4_FP8_KEY[cdt], kernels.fused_epilogue_complex(
                            chi, sa, sb, nu, "FP8", real_dt),
                        (got.real, got.imag),
                        f"planar vs complex output {what}", count=False)
    for key, seen in routes.items():
        check(seen == {True, False}, f"{key}: routes taken {seen}")
    log(f"complex FP8 kernel cases: both routes taken by {sorted(routes)}")


# rows 0-7 of A @ B per dtype of the real paths: (longdouble oracle, |A||B|,
# torch.matmul's max and median relative error)
ORACLES: dict = {}


def real_main_path(a, b, nu, backend):
    """One real gemm through the entry point a user calls, with its launch
    counts set to 0 just before and read just after; the output's shape,
    dtype and finiteness; accuracy on rows 0-7 against a longdouble oracle
    beside torch.matmul's (cuBLAS DGEMM/SGEMM). Returns the counts."""
    import gemmul8_tpu_torch as gt
    dt = a.dtype
    c, counts = run_counted(lambda: gt.gemm(a, b, num_moduli=nu,
                                            backend=backend))
    keys, want = ((COUNT_KEYS, (2, nu, 0, 0, 1)) if backend == "INT8" else
                  (FP8_COUNT_KEYS, (2, 3 * nu, 1, 0, 0, 0)))
    check(tuple(counts[k] for k in keys) == want,
          f"{backend} main path {dt} nu={nu} launches {counts}, want "
          f"{dict(zip(keys, want))}")
    check(c.shape == (FULL, FULL) and c.dtype == dt
          and bool(torch.isfinite(c).all()), f"main path {dt} output")
    if dt not in ORACLES:
        a8 = a[:8].cpu().numpy()
        b_np = b.cpu().numpy()
        ref = a8.astype(np.longdouble) @ b_np.astype(np.longdouble)
        # error against the componentwise scale |A||B| (cancellation makes
        # the max relative error of any GEMM grow with k: cuBLAS's own is
        # ~5e-11 here)
        scale = np.abs(a8).astype(np.float64) @ np.abs(b_np).astype(np.float64)
        native = torch.matmul(a, b)[:8].cpu().numpy()
        ORACLES[dt] = (ref, scale, max_median_relerr(native, ref))
    ref, scale, (nerr, nmed) = ORACLES[dt]
    got = c[:8].cpu().numpy()
    err, med = max_median_relerr(got, ref)
    cw = float(np.max(np.abs(np.asarray(got, np.longdouble) - ref) / scale))
    log(f"accuracy {backend} {dt} nu={nu} rows 0-7: emulated max {err:.3e} "
        f"median {med:.3e} max/|A||B| {cw:.3e}; torch.matmul max {nerr:.3e} "
        f"median {nmed:.3e}")
    if dt == torch.float64:
        check(err <= 2 * nerr and cw < 1e-13,
              f"f64 error {err} (|A||B|-relative {cw}) vs cuBLAS {nerr}")
    else:
        check(err < nerr, f"f32 error {err} vs cuBLAS f32 {nerr}")
    log(f"main path {backend} {dt} nu={nu} launches: {counts}")
    return counts


def small_accuracy_case(rng):
    """tests/test_gemm_real.py's DGEMM bound at its own size, on the card:
    48x256x40 phi=0.5, nu=16, max relative error <= 2x cuBLAS and < 1e-13."""
    import gemmul8_tpu_torch as gt
    a = phi_matrix(rng, 48, 256, 0.5)
    b = phi_matrix(rng, 256, 40, 0.5)
    ref = a.astype(np.longdouble) @ b.astype(np.longdouble)
    err, _ = max_median_relerr(gt.gemm(a, b, num_moduli=16).cpu().numpy(), ref)
    native = (torch.from_numpy(a).cuda() @ torch.from_numpy(b).cuda()).cpu()
    nerr, _ = max_median_relerr(native.numpy(), ref)
    log(f"accuracy f64 48x256x40 nu=16: emulated max {err:.3e}, "
        f"torch.matmul max {nerr:.3e}")
    check(err <= 2 * nerr and err < 1e-13, f"f64 48x256x40 error {err}")


# ---------------------------------------------------------------------------
# phase 4, complex: the kernels at the complex paths' 8192^2 inputs, the
# paths with their launch counts and their accuracy
# ---------------------------------------------------------------------------

def complex_stages(nu, entry, a, b, fastmode=None):
    """The complex path's stages up to the lane products, as the entry runs
    them in the given mode (by default the entry's own: gemm's fast shifts,
    herk's robust ones): (shifts, lanes of A and of B, C_hi3)."""
    from gemmul8_tpu_torch import complex_gemm as cg, core
    if fastmode is None:
        fastmode = "robust" if entry == "herk" else True
    ar, ai = a.real.contiguous(), a.imag.contiguous()
    if entry == "herk":          # one shift and one encode serve both sides
        sa, sb = cg.shifts((ar, ai), None, nu, fastmode, "INT8")
        pa = cg._quantize_complex(ar, ai, sa, 0, nu, "INT8", False)
        pb = cg._herk_rhs_lanes(pa, nu, "INT8")
    else:
        br, bi = b.real.contiguous(), b.imag.contiguous()
        sa, sb = cg.shifts((ar, ai), (br, bi), nu, fastmode, "INT8")
        pa = cg._quantize_complex(ar, ai, sa, 0, nu, "INT8", False)
        pb = cg._quantize_complex(br, bi, sb, 1, nu, "INT8", False)
    c_hi3 = core.residue_matmul(pa.reshape(3 * nu, *pa.shape[2:]),
                                pb.reshape(3 * nu, *pb.shape[2:]))
    return (sa, sb), (pa, pb), c_hi3


def compare_rows(key, got, plain, what, rows=1024):
    """Hold a full-size kernel output against its plain version computed on
    row blocks (the plain version of a whole 8192^2 epilogue holds several
    copies of C_hi3). `got` is a tensor or tuple whose dim -2 is the row;
    plain(r0, r1) gives the same for rows r0:r1."""
    m = (got[0] if isinstance(got, tuple) else got).shape[-2]
    for r0 in range(0, m, rows):
        r1 = min(r0 + rows, m)
        g = tuple(x[..., r0:r1, :] for x in got) if isinstance(got, tuple) \
            else got[..., r0:r1, :]
        compare(key, g, plain(r0, r1), f"{what} rows {r0}:{r1}", count=False)
        torch.cuda.empty_cache()
    CASES[key] = CASES.get(key, 0) + 1


def full_size_complex_cases(A, B, paths=None):
    """Each kernel on the inputs each complex path gives it at 8192^2: the
    encodes of the Re and Im lanes of A (and B), then the complex epilogue
    (nu <= 16), or the recombine and the real epilogue on its int8 output
    (nu = 20), on the path's own lane products. paths: (name, dtype, nu,
    entry, fastmode), by default CPATHS in their entries' own modes."""
    from gemmul8_tpu_torch import kernels
    if paths is None:
        paths = [(name, dt, nu, entry, None)
                 for name, dt, nu, entry, _ in CPATHS]
    for name, dt, nu, entry, fastmode in paths:
        a = A.to(dt)
        b = B.to(dt) if entry == "gemm" else None
        (sa, sb), (pa, pb), c_hi3 = complex_stages(nu, entry, a, b, fastmode)
        real = a.real.contiguous()
        compare(f"encode_planes[{TAG[real.dtype]}]", pa[0],
                kernels.encode_planes_plain(real, sa, 0, nu, "INT8"),
                f"encode full-size {name} Re(A)")
        if fastmode is False:
            compare(f"encode_planes[{TAG[real.dtype]}]", pa[1],
                    kernels.encode_planes_plain(a.imag.contiguous(), sa, 0,
                                                nu, "INT8"),
                    f"encode full-size {name} Im(A)")
        if entry == "gemm":
            imag = b.imag.contiguous()
            compare(f"encode_planes[{TAG[real.dtype]}]", pb[1],
                    kernels.encode_planes_plain(imag, sb, 1, nu, "INT8"),
                    f"encode full-size {name} Im(B)")
        del pa, pb
        blk = lambda r0, r1: c_hi3[:, r0:r1].contiguous()  # noqa: E731
        if nu <= 16:
            compare_rows(f"fused_epilogue_complex[{TAG[dt]}]",
                         kernels.fused_epilogue_complex(c_hi3, sa, sb, nu,
                                                        "INT8", dt),
                         lambda r0, r1: kernels.fused_epilogue_complex_plain(
                             blk(r0, r1), sa[r0:r1], sb, nu, "INT8", dt),
                         f"complex epilogue full-size {name}")
        else:
            mids = kernels.fused_recombine_3m(c_hi3, nu, "INT8")
            compare_rows("fused_recombine_3m[c128 nu=20]", mids,
                         lambda r0, r1: kernels.fused_recombine_3m_plain(
                             blk(r0, r1), nu, "INT8"),
                         f"recombine full-size {name}")
            del c_hi3
            real_dt = a.real.dtype
            for part, mid in zip(("Re", "Im"), mids):
                compare_rows("fused_epilogue[c128 nu=20 split]",
                             kernels.fused_epilogue(mid, sa, sb, nu, "INT8",
                                                    real_dt),
                             lambda r0, r1: kernels.fused_epilogue_plain(
                                 mid[:, r0:r1], sa[r0:r1], sb, nu, "INT8",
                                 real_dt),
                             f"split epilogue full-size {name} {part}")
        del blk
        torch.cuda.empty_cache()


def _ld_matmul(x, y):
    """x @ y in numpy longdouble, in column blocks on 8 threads (numpy's
    longdouble matmul has no BLAS; it releases the GIL)."""
    x, y = np.asarray(x, np.longdouble), np.asarray(y, np.longdouble)
    blocks = range(0, y.shape[1], 512)
    with ThreadPoolExecutor(8) as ex:
        return np.concatenate(list(ex.map(
            lambda j: x @ y[:, j:j + 512], blocks)), axis=1)


def _ld_product_rows(ar, ai, br, bi):
    """(ar + i ai) @ (br + i bi) in numpy longdouble from the four real
    products."""
    prod = _ld_matmul
    return (prod(ar, br) - prod(ai, bi)) + 1j * (prod(ar, bi) + prod(ai, br))


def complex_relerr(c, ref):
    """Max and median of |c - ref| / |ref| (the complex modulus)."""
    err = np.abs(np.asarray(c, np.clongdouble) - ref)
    den = np.abs(ref)
    err = err / np.where(den == 0, np.longdouble(1), den)
    return float(np.max(err)), float(np.median(err))


# rows 0-7 of each complex product, (entry, dtype) -> longdouble oracle
COMPLEX_ORACLES: dict = {}


def complex_main_paths(A, B):
    """The four complex paths through the entry points a user calls, each
    with its launch counts set to 0 just before and read just after; the
    output's shape, dtype and finiteness; accuracy on rows 0-7 against a
    longdouble oracle beside torch.matmul's (cuBLAS ZGEMM/CGEMM)."""
    import gemmul8_tpu_torch as gt
    launches, oracles = {}, COMPLEX_ORACLES
    for name, dt, nu, entry, want in CPATHS:
        a = A.to(dt)
        b = B.to(dt) if entry == "gemm" else a.mH
        if entry == "gemm":
            c, counts = run_counted(lambda: gt.gemm(a, b, num_moduli=nu))
        else:
            c, counts = run_counted(lambda: gt.herk(a, num_moduli=nu))
        got = tuple(counts[k] for k in COUNT_KEYS)
        check(got == want, f"{name} launches {counts}, want "
              f"{dict(zip(COUNT_KEYS, want))}")
        launches[name] = counts
        check(c.shape == (FULL, FULL) and c.dtype == dt
              and bool(torch.isfinite(torch.view_as_real(c)).all()),
              f"{name} output {c.shape} {c.dtype}")
        okey = (entry, dt)
        if okey not in oracles:
            a8 = a[:8].cpu().numpy()
            b_np = b.resolve_conj().cpu().numpy()
            oracles[okey] = _ld_product_rows(a8.real, a8.imag, b_np.real,
                                             b_np.imag)
        ref = oracles[okey]
        err, med = complex_relerr(c[:8].cpu().numpy(), ref)
        native = torch.matmul(a, b)[:8].cpu().numpy()
        nerr, nmed = complex_relerr(native, ref)
        log(f"accuracy {name} rows 0-7: emulated max {err:.3e} median "
            f"{med:.3e}; torch.matmul max {nerr:.3e} median {nmed:.3e}")
        if name == "cgemm8":
            check(err < nerr, f"{name} error {err} vs cuBLAS {nerr}")
        elif name == "herk16":    # tests/test_herk.py's bound
            check(err <= 16 * nerr, f"{name} error {err} vs cuBLAS {nerr}")
        else:
            check(err <= 2 * nerr, f"{name} error {err} vs cuBLAS {nerr}")
        log(f"main path {name} launches: {counts}")
        del c, native
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# accurate mode (fastmode=False), syrk and gemm_batched at full width: the
# paths with their launch counts, accuracy, shift gain and times
# ---------------------------------------------------------------------------

# the launches one call makes: K1, _int_mm (products and estimates), K2, K6,
# _scaled_mm, K3, K4, K5, and apart the _int_mm calls of the estimates
ACCURATE_KEYS = ("encode_planes", "_int_mm", "fused_epilogue",
                 "encode_planes_fp8", "_scaled_mm", "fused_epilogue_fp8",
                 "fused_epilogue_complex", "fused_recombine_3m",
                 "estimate_int_mm")
BATCH = 8          # gemm_batched: 8 x (FULL/4)^3 = 8 x 2048^3
# name, dtype, nu, backend, entry, fastmode, launches of one call
APATHS = (
    ("dgemm16 accurate", torch.float64, 16, "INT8", "gemm", False,
     (2, 17, 1, 0, 0, 0, 0, 0, 1)),
    ("sgemm8 accurate", torch.float32, 8, "INT8", "gemm", False,
     (2, 9, 1, 0, 0, 0, 0, 0, 1)),
    ("fp8 dgemm14 accurate", torch.float64, 14, "FP8", "gemm", False,
     (0, 4, 0, 2, 42, 1, 0, 0, 4)),
    ("zgemm16 accurate", torch.complex128, 16, "INT8", "gemm", False,
     (4, 51, 0, 0, 0, 0, 1, 0, 3)),
    ("herk16 accurate", torch.complex128, 16, "INT8", "herk", False,
     (2, 51, 0, 0, 0, 0, 1, 0, 3)),
    ("syrk16 robust", torch.float64, 16, "INT8", "syrk", "robust",
     (1, 16, 1, 0, 0, 0, 0, 0, 0)),
    ("syrk16 accurate", torch.float64, 16, "INT8", "syrk", False,
     (1, 17, 1, 0, 0, 0, 0, 0, 1)),
    ("fp8 syrk14 accurate", torch.float64, 14, "FP8", "syrk", False,
     (0, 4, 0, 1, 42, 1, 0, 0, 4)),
    ("batched 8x2048^3 nu=16 accurate", torch.float64, 16, "INT8", "batched",
     False, (2 * BATCH, 17 * BATCH, BATCH, 0, 0, 0, 0, 0, BATCH)),
)


def accurate_operands(entry, dt, a64, b64, A, B):
    """The operands of one accurate path: the phase-4 ones (complex: A and
    B; herk and syrk: A alone; batched: the first 8 of their 2048^2 blocks)."""
    if dt.is_complex:
        return A.to(dt), (B.to(dt) if entry == "gemm" else None)
    if entry == "batched":
        n = FULL // 4
        return (a64.reshape(-1, n, n)[:BATCH], b64.reshape(-1, n, n)[:BATCH])
    return a64.to(dt), (b64.to(dt) if entry == "gemm" else None)


def accurate_call(entry, a, b, nu, backend, fastmode):
    import gemmul8_tpu_torch as gt
    kw = dict(num_moduli=nu, fastmode=fastmode)
    if entry == "gemm":
        return lambda: gt.gemm(a, b, backend=backend, **kw)
    if entry == "herk":
        return lambda: gt.herk(a, **kw)
    if entry == "syrk":
        return lambda: gt.syrk(a, backend=backend, **kw)
    return lambda: gt.gemm_batched(a, b, backend=backend, **kw)


def library_call(entry, a, b):
    """The one PyTorch call that computes the same product."""
    rhs = {"herk": lambda: a.mH, "syrk": lambda: a.T}.get(entry, lambda: b)()
    return lambda: torch.matmul(a, rhs)


def accurate_stages(a, b, nu, backend):
    """The shift function the entry calls (core's or, on complex operands,
    complex_gemm's, given the mode) and the three stages of its accurate
    shifts: extract(), estimate(extracted), combine(estimated, extracted).
    b=None for syrk and herk, as the entries pass it."""
    from gemmul8_tpu_torch import complex_gemm as cg, core
    mod = core
    if a.is_complex():
        mod = cg
        a = (a.real.contiguous(), a.imag.contiguous())
        b = None if b is None else (b.real.contiguous(), b.imag.contiguous())
    return (lambda mode: mod.shifts(a, b, nu, mode, backend),
            lambda: mod.accurate_extract(a, b, backend),
            lambda ext: mod.accurate_estimate(ext, backend),
            lambda est, ext: mod.accurate_combine(est, ext, nu, backend))


def fast_mode(entry):
    """The mode the entry takes by default: syrk and herk the robust one."""
    return "robust" if entry in ("syrk", "herk") else True


def element_pairs(entry, a, b):
    """The (a, b) pairs one call's shifts are taken on: each batch element
    for gemm_batched."""
    return list(zip(a, b)) if entry == "batched" else [(a, b)]


def shift_gain(entry, a, b, nu, backend):
    """The mean of sft_accu - sft_fast over rows and columns (over every
    batch element for gemm_batched): the bits accurate mode buys here."""
    diffs = []
    for x, y in element_pairs(entry, a, b):
        shifts = accurate_stages(x, y, nu, backend)[0]
        diffs += [(s1 - s0).double() for s1, s0 in
                  zip(shifts(False), shifts(fast_mode(entry)))]
    return float(torch.cat(diffs).mean())


def full_size_accurate_cases(a64, b64, A, B):
    """Each kernel on the inputs each path of APATHS gives it, with the
    shifts from the entry's own shift function on the phase-4 operands: K1
    or K6 on A and B against their plain versions, then K2 or K3 on the
    path's own products (syrk's from the transposed view of A's planes, on
    FP8 in the rhs slot order; gemm_batched's first element, at 2048^2) in
    row blocks; the complex paths through full_size_complex_cases."""
    from gemmul8_tpu_torch import core, fp8, kernels
    full_size_complex_cases(A, B, [
        (name, dt, nu, entry, fastmode)
        for name, dt, nu, _, entry, fastmode, _ in APATHS if dt.is_complex])
    for name, dt, nu, backend, entry, fastmode, _ in APATHS:
        if dt.is_complex:
            continue
        a, b = accurate_operands(entry, dt, a64, b64, A, B)
        if entry == "batched":
            a, b = a[0], b[0]
        sa, sb = accurate_stages(a, b, nu, backend)[0](fastmode)
        sides = [(a, sa, 0)] + ([] if b is None else [(b, sb, 1)])
        planes = []
        for x, s, axis in sides:
            if backend == "FP8":
                got = kernels.encode_planes_fp8(x, s, axis, nu)
                plain = kernels.encode_planes_fp8_plain(x, s, axis, nu)
            else:
                got = kernels.encode_planes(x, s, axis, nu, backend)
                plain = kernels.encode_planes_plain(x, s, axis, nu, backend)
            compare(f"encode_planes{'_fp8' if backend == 'FP8' else ''}"
                    f"[{TAG[dt]}]", got, plain,
                    f"encode full-size {name} axis={axis}")
            planes.append(got)
            del plain
            torch.cuda.empty_cache()
        if b is None:            # syrk: the rhs planes are a transposed view
            pa = planes[0]
            planes.append((fp8.lhs_to_rhs_stack(pa, nu) if backend == "FP8"
                           else pa).transpose(-1, -2))
        if backend == "FP8":
            c3 = fp8.residue_matmul_fp8(*planes)
            del planes
            compare_rows(f"fused_epilogue_fp8[{TAG[dt]}]",
                         kernels.fused_epilogue_fp8(c3, sa, sb, nu, dt),
                         lambda r0, r1: kernels.fused_epilogue_fp8_plain(
                             c3[:, r0:r1].contiguous(), sa[r0:r1], sb, nu,
                             dt),
                         f"fp8 epilogue full-size {name}")
            del c3
        else:
            c_hi = core.residue_matmul(*planes)
            del planes
            compare_rows(f"fused_epilogue[{TAG[dt]}]",
                         kernels.fused_epilogue(c_hi, sa, sb, nu, backend,
                                                dt),
                         lambda r0, r1: kernels.fused_epilogue_plain(
                             c_hi[:, r0:r1], sa[r0:r1], sb, nu, backend, dt),
                         f"epilogue full-size {name}")
            del c_hi
        torch.cuda.empty_cache()


def accurate_oracle(name, entry, dt, a, b):
    """Rows 0-7 of the product against a longdouble oracle: (oracle, |A||B|
    or None, the native product's rows). Shares the real and complex
    oracles of phase 4 where the product is the same."""
    if dt.is_complex:
        rhs = b if entry == "gemm" else a.mH
        ref = COMPLEX_ORACLES[(entry, dt)]
        return ref, None, torch.matmul(a, rhs)[:8]
    if entry == "gemm":
        ref, scale, _ = ORACLES[dt]
        return ref, scale, torch.matmul(a, b)[:8]
    if entry == "syrk":
        a8, a_np = a[:8].cpu().numpy(), a.cpu().numpy()
        ref = _ld_matmul(a8, a_np.T)
        scale = np.abs(a8) @ np.abs(a_np.T)
        return ref, scale, torch.matmul(a, a.T)[:8]
    a8, b_np = a[:, :8].cpu().numpy(), b.cpu().numpy()
    ref = np.stack([_ld_matmul(x, y) for x, y in zip(a8, b_np)])
    scale = np.abs(a8) @ np.abs(b_np)
    return ref, scale, torch.matmul(a, b)[:, :8]


def accurate_paths(a64, b64, A, B):
    """Each accurate path (and syrk's default robust mode) at full width
    through the entry point a user calls, with its launch counts set to 0
    just before and read just after; the output's shape, dtype and
    finiteness; accuracy on rows 0-7 against a longdouble oracle under the
    fast path's limits; the mean shift gain over the entry's fast shifts.
    Returns {name: (counts, gain)}."""
    out = {}
    for name, dt, nu, backend, entry, fastmode, want in APATHS:
        a, b = accurate_operands(entry, dt, a64, b64, A, B)
        c, counts = run_counted(accurate_call(entry, a, b, nu, backend,
                                              fastmode))
        got = tuple(counts[k] for k in ACCURATE_KEYS)
        check(got == want, f"{name} launches {counts}, want "
              f"{dict(zip(ACCURATE_KEYS, want))}")
        shape = (BATCH, FULL // 4, FULL // 4) if entry == "batched" else \
            (FULL, FULL)
        fin = torch.view_as_real(c) if c.is_complex() else c
        check(c.shape == shape and c.dtype == dt
              and bool(torch.isfinite(fin).all()), f"{name} output")
        ref, scale, native = accurate_oracle(name, entry, dt, a, b)
        rows = c[:, :8] if entry == "batched" else c[:8]
        rows, native = rows.cpu().numpy(), native.cpu().numpy()
        if dt.is_complex:
            (err, med), (nerr, _) = (complex_relerr(rows, ref),
                                     complex_relerr(native, ref))
            limit = 16 if entry == "herk" else 2
            log(f"accuracy {name} rows 0-7: emulated max {err:.3e} median "
                f"{med:.3e}; torch.matmul max {nerr:.3e}")
            check(err <= limit * nerr, f"{name} error {err} vs cuBLAS {nerr}")
        else:
            (err, med), (nerr, _) = (max_median_relerr(rows, ref),
                                     max_median_relerr(native, ref))
            cw = float(np.max(np.abs(np.asarray(rows, np.longdouble) - ref)
                              / scale))
            log(f"accuracy {name} rows 0-7: emulated max {err:.3e} median "
                f"{med:.3e} max/|A||B| {cw:.3e}; torch.matmul max "
                f"{nerr:.3e}")
            if dt == torch.float64:
                check(err <= 2 * nerr and cw < 1e-13,
                      f"{name} error {err} (|A||B|-relative {cw}) vs cuBLAS "
                      f"{nerr}")
            else:
                check(err < nerr, f"{name} error {err} vs cuBLAS {nerr}")
        gain = (shift_gain(entry, a, b, nu, backend) if fastmode is False
                else None)
        log(f"main path {name} launches: {counts}; shift gain over the fast "
            f"shifts (mean sft_accu - sft_fast): {gain}")
        out[name] = (counts, gain)
        del c
        torch.cuda.empty_cache()
    return out


def accurate_times(a64, b64, A, B, card):
    """Phase 6 for each accurate path: the whole call, the entry's fast call
    and torch.matmul (10 runs each, median; the call's quartiles), and the
    accurate shifts' stages (extract, estimation products, combine; median
    of 5); the rest of the call is the whole call less those."""
    timing = {}
    for name, dt, nu, backend, entry, fastmode, _ in APATHS:
        a, b = accurate_operands(entry, dt, a64, b64, A, B)
        runs = cuda_times(accurate_call(entry, a, b, nu, backend, fastmode),
                          reps=10)
        q1, q2, q3 = statistics.quantiles(runs, n=4)
        t = dict(gemm_ms=q2, gemm_ms_q1=q1, gemm_ms_q3=q3)
        if fastmode is False:
            t["fast_ms"] = statistics.median(cuda_times(accurate_call(
                entry, a, b, nu, backend, fast_mode(entry)), reps=10))
            stages = [accurate_stages(x, y, nu, backend)
                      for x, y in element_pairs(entry, a, b)]
            ex = [s[1]() for s in stages]
            est = [s[2](e) for s, e in zip(stages, ex)]
            t["extract_ms"] = cuda_ms(lambda: [s[1]() for s in stages])
            t["estimate_ms"] = cuda_ms(lambda: [s[2](e) for s, e in
                                                zip(stages, ex)])
            t["combine_ms"] = cuda_ms(lambda: [s[3](d, e) for s, d, e in
                                               zip(stages, est, ex)])
            t["fast_shifts_ms"] = cuda_ms(lambda: [s[0](fast_mode(entry))
                                                   for s in stages])
            t["rest_ms"] = t["gemm_ms"] - t["extract_ms"] - t["estimate_ms"] \
                - t["combine_ms"]
            del ex, est
        t["library_ms"] = cuda_ms(library_call(entry, a, b))
        flops = (8.0 if dt.is_complex else 2.0) * (
            BATCH * (FULL // 4) ** 3 if entry == "batched" else FULL ** 3)
        t["emulated_tflops"] = flops / (t["gemm_ms"] * 1e-3) / 1e12
        timing[name] = t
        log(f"times {card} | {name}: " + ", ".join(
            f"{k_} {v:.4f}" for k_, v in t.items()))
        torch.cuda.empty_cache()
    return timing


def accurate_card_vs_cpu(rng):
    """Accurate mode, syrk (its three modes) and gemm_batched on the card
    against the package's CPU path, bit for bit, at small shapes: real INT8
    and FP8 (k = 520, past the 252 where the JAX package's FP8 estimate is
    exact), complex nu = 16 and 20, gemm_planar, herk, syrk on INT8 and
    FP8, the batched real, complex and planar entries; and an INT8
    estimation product past its int32 range (64 x 600000 x 64)."""
    import gemmul8_tpu_torch as gt
    from gemmul8_tpu_torch import quantize
    f64, f32, c128, c64 = np.float64, np.float32, np.complex128, np.complex64
    ab = dict(alpha=-1.25, beta=0.75)
    acc = dict(fastmode=False, epilogue="ff")
    cases = [   # (entry, m, k, n, dtype, keywords)
        ("gemm", 300, 520, 200, f64, dict(acc, num_moduli=16)),
        ("gemm", 300, 520, 200, f64, dict(acc, num_moduli=16, epilogue="f64",
                                          trans_a="T", **ab)),
        ("gemm", 300, 520, 200, f32, dict(acc, num_moduli=8)),
        ("gemm", 300, 520, 200, f64, dict(acc, num_moduli=14, backend="FP8")),
        ("gemm", 300, 520, 200, f32, dict(acc, num_moduli=7, backend="FP8",
                                          epilogue="f64", trans_b="T", **ab)),
        ("gemm", 300, 520, 200, c128, dict(acc, num_moduli=16)),
        ("gemm", 300, 520, 200, c128, dict(acc, num_moduli=20, trans_b="C")),
        ("gemm", 300, 520, 200, c64, dict(acc, num_moduli=8, epilogue="f64",
                                          alpha=-1.25 + 0.5j, beta=0.75)),
        ("planar", 300, 520, 200, c128, dict(acc, num_moduli=16,
                                             trans_a="C")),
        ("herk", 300, 520, 300, c128, dict(acc, num_moduli=16, alpha=-0.5,
                                           beta=2.0)),
        ("herk", 520, 300, 520, c64, dict(acc, num_moduli=8, trans=True)),
    ]
    for backend, nu in (("INT8", 16), ("FP8", 14)):
        for mode in (True, "robust", False):
            cases.append(("syrk", 300, 520, 300, f64, dict(
                num_moduli=nu, backend=backend, fastmode=mode, epilogue="ff",
                **(ab if mode is False else {}))))
    cases.append(("syrk", 520, 300, 520, f32, dict(num_moduli=8, trans=True,
                                                   fastmode=False)))
    cases += [("batched", 130, 260, 70, f64, dict(acc, num_moduli=16)),
              ("batched", 130, 260, 70, c128, dict(num_moduli=16,
                                                   epilogue="ff")),
              ("batched_planar", 130, 260, 70, c128, dict(acc,
                                                          num_moduli=16))]
    n = 0
    for entry, m, k, n_, dt, kw in cases:
        kw = dict({"epilogue": "ff"}, **kw)
        cplx = np.dtype(dt).kind == "c"
        mk = (lambda *s: cphi(rng, *s, dt)) if cplx else \
            (lambda *s: phi_matrix(rng, *s, 0.5, dt))
        if entry in ("herk", "syrk"):
            a = mk(m, k)
            mdim = k if kw.get("trans") else m
            if "beta" in kw:
                kw = dict(kw, c=mk(mdim, mdim))
            fn = (lambda d: gt.herk(a, device=d, **kw)) if entry == "herk" \
                else (lambda d: gt.syrk(a, device=d, **kw))
        elif entry.startswith("batched"):
            a = np.stack([mk(m, k) for _ in range(3)])
            b = np.stack([mk(k, n_) for _ in range(3)])
            if entry == "batched":
                fn = lambda d: gt.gemm_batched(  # noqa: E731
                    a, b, device=d, **kw)
            else:
                planes = [np.ascontiguousarray(x)
                          for x in (a.real, a.imag, b.real, b.imag)]
                fn = lambda d: torch.complex(  # noqa: E731
                    *gt.gemm_batched_planar(*planes, device=d, **kw))
        else:
            ta, tb = kw.get("trans_a", "N"), kw.get("trans_b", "N")
            a = mk(*((m, k) if ta == "N" else (k, m)))
            b = mk(*((k, n_) if tb == "N" else (n_, k)))
            if "beta" in kw:
                kw = dict(kw, c=mk(m, n_))
            if entry == "gemm":
                fn = lambda d: gt.gemm(a, b, device=d, **kw)  # noqa: E731
            else:
                planes = [np.ascontiguousarray(x)
                          for x in (a.real, a.imag, b.real, b.imag)]
                fn = lambda d: torch.complex(  # noqa: E731
                    *gt.gemm_planar(*planes, device=d, **kw))
        t0 = time.perf_counter()
        got = fn("cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ref = fn("cpu")
        t2 = time.perf_counter()
        label = (f"card vs cpu {entry} {np.dtype(dt).name} {m}x{k}x{n_} "
                 f"{ {x: y for x, y in kw.items() if x != 'c'} }")
        assert_bits_equal(got, ref, label)
        log(f"  ok  {label}  card {t1 - t0:.2f}s cpu {t2 - t1:.2f}s")
        n += 1
    # the INT8 estimation product past K_SAFE_INT8: f64 sums of 2^18-chunk
    # int32 products, worst-case planes in the first row and column
    k = 600_000
    ua = rng.integers(0, 66, (64, k)).astype(np.int8)
    ub = rng.integers(-65, 66, (k, 64)).astype(np.int8)
    ua[0], ub[:, 0] = 65, 65
    got = quantize.estimate_gemm(torch.from_numpy(ua).cuda(),
                                 torch.from_numpy(ub).cuda(), "INT8")
    ref = quantize.estimate_gemm(torch.from_numpy(ua), torch.from_numpy(ub),
                                 "INT8")
    assert_bits_equal(got, ref, "card vs cpu estimate_gemm INT8 64x600000x64")
    check(float(got[0, 0]) == 65 * 65 * k, "estimate past K_SAFE_INT8")
    log(f"  ok  card vs cpu estimate_gemm INT8 64x{k}x64 (f64, "
        f"C[0,0] = 65^2 k = {float(got[0, 0]):.0f})")
    return n + 1


# ---------------------------------------------------------------------------
# phase 4, the entry points over the main path's kernels: precomputed
# operands, the striped path, phase timing, the compat layer and the
# interposer, each through the call a user makes, with its launch counts
# ---------------------------------------------------------------------------

# each entry-point run's dtype tag and launch counts, for the kernels line
ENTRY_RUNS: dict = {}
# the launches that tell the entry-point paths apart: shifts (the fast
# shifts' calls, counted by run_counted), K1, K6, the products, K2, K3, K4
ENTRY_KEYS = ("shift_fast", "encode_planes", "encode_planes_fp8", "_int_mm",
              "_scaled_mm", "fused_epilogue", "fused_epilogue_fp8",
              "fused_epilogue_complex")
LD = FULL + 64                        # the compat buffers' leading dimension


def entry_counted(name, tag, fn, want):
    """fn() through run_counted; its ENTRY_KEYS counts must equal want (a
    dict, missing keys 0). Records the run for the kernels line."""
    out, counts = run_counted(fn)
    got = {k: counts.get(k, 0) for k in ENTRY_KEYS}
    exp = {k: want.get(k, 0) for k in ENTRY_KEYS}
    check(got == exp, f"{name} launches {got}, want {exp}")
    ENTRY_RUNS[name] = (tag, counts)
    log(f"entry path {name} launches: "
        f"{ {k: v for k, v in got.items() if v} }")
    return out


def int8_call(nu, sides=2, tiles=1):
    """The launches of one INT8 product from `sides` raw operands."""
    return {"shift_fast": sides, "encode_planes": sides,
            "_int_mm": nu * tiles, "fused_epilogue": tiles}


def precomputed_paths(a64, b64, card):
    """(a) precompute + gemm_quantized at 8192^3, INT8 nu=16 and FP8 nu=14:
    two-sided and one-sided reuse bit-equal to gt.gemm on the same operands;
    the two-sided call runs no shift and no encode. Times beside gemm's."""
    import gemmul8_tpu_torch as gt
    for backend, nu in (("INT8", 16), ("FP8", 14)):
        fp8 = backend == "FP8"
        enc = "encode_planes_fp8" if fp8 else "encode_planes"
        product = ({"_scaled_mm": 3 * nu, "fused_epilogue_fp8": 1} if fp8
                   else {"_int_mm": nu, "fused_epilogue": 1})
        ref = gt.gemm(a64, b64, num_moduli=nu, backend=backend)
        pre = {"shift_fast": 1, enc: 1}
        qa = entry_counted(f"precompute A {backend} nu={nu}", "f64",
                           lambda: gt.precompute(a64, "A", num_moduli=nu,
                                                 backend=backend), pre)
        qb = entry_counted(f"precompute B {backend} nu={nu}", "f64",
                           lambda: gt.precompute(b64, "B", num_moduli=nu,
                                                 backend=backend), pre)
        both = entry_counted(f"gemm_quantized both {backend} nu={nu}", "f64",
                             lambda: gt.gemm_quantized(qa, qb), product)
        assert_bits_equal(both, ref, f"gemm_quantized both {backend}")
        one = entry_counted(f"gemm_quantized one {backend} nu={nu}", "f64",
                            lambda: gt.gemm_quantized(qa, b64),
                            dict(product, **pre))
        assert_bits_equal(one, ref, f"gemm_quantized A precomputed {backend}")
        assert_bits_equal(gt.gemm_quantized(a64, qb), ref,
                          f"gemm_quantized B precomputed {backend}")
        del both, one
        t = dict(
            precompute_a_ms=cuda_ms(lambda: gt.precompute(
                a64, "A", num_moduli=nu, backend=backend)),
            precompute_b_ms=cuda_ms(lambda: gt.precompute(
                b64, "B", num_moduli=nu, backend=backend)),
            both_ms=cuda_ms(lambda: gt.gemm_quantized(qa, qb), reps=10),
            one_ms=cuda_ms(lambda: gt.gemm_quantized(qa, b64), reps=10),
            gemm_ms=cuda_ms(lambda: gt.gemm(a64, b64, num_moduli=nu,
                                            backend=backend), reps=10))
        log(f"times {card} | precomputed f64 8192^3 {backend} nu={nu}: "
            + ", ".join(f"{k} {v:.3f}" for k, v in t.items()))
        del qa, qb, ref
        torch.cuda.empty_cache()


def _device_phi(gen, m, n):
    """(U - 0.5) * exp(0.5 N) made on the card from a seeded generator."""
    u = torch.rand((m, n), generator=gen, dtype=torch.float64, device="cuda")
    z = torch.randn((m, n), generator=gen, dtype=torch.float64, device="cuda")
    return (u - 0.5) * torch.exp(0.5 * z)


def blocked_paths(a64, b64, card):
    """(b) The budget query's host time, and headline DGEMM calls with and
    without it, in rotated turns (probes.budget_query). f64 32768 x 32768 x
    8192 nu=16 through gt.gemm with no block arguments: pick_blocking's
    stripes, work_bytes per stripe, the peak memory; the first and the last
    stripe each bit-equal to the unstriped call on its columns, rows 0-7 of
    the first 8192 columns within the DGEMM limits of a longdouble oracle;
    timed beside torch.matmul. Then accurate mode forced into 4096 x 4096
    tiles at 8192^3, bit-equal to the unstriped call."""
    import gemmul8_tpu_torch as gt
    from gemmul8_tpu_torch import core
    nu, m, n, k = 16, 4 * FULL, 4 * FULL, FULL
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    a, b = _device_phi(gen, m, k), _device_phi(gen, k, n)
    budget = core.device_budget_bytes(a.device)
    # the host time of the budget query every real gemm on the card makes
    # and of the free-memory rule it replaced; headline DGEMM calls under
    # each and under a constant budget, in rotated turns
    q = budget_query.compare(a64, b64, nu, rounds=10)
    log(f"budget query {card}: device_budget_bytes {q['query_us']:.1f} us "
        f"a call, the free-memory rule {q['free_rule_us']:.1f} us; gemm f64 "
        f"8192^3 nu={nu} (median, q1, q3 of 10 rotated rounds): " + "; ".join(
            f"{name} " + ", ".join(f"{v:.3f}" for v in q[name]) + " ms"
            for name in ("query", "constant", "free_rule")))
    mb, nb = core.pick_blocking(m, n, k, nu, torch.float64, device="cuda")
    check(nb is not None, f"32768^2 x 8192 did not stripe (budget {budget})")
    tiles = -(-n // nb) * (1 if mb is None else -(-m // mb))
    stripe = core.work_bytes(mb or m, nb, k, nu)
    log(f"blocked f64 {m}x{n}x{k} nu={nu}: work_bytes "
        f"{core.work_bytes(m, n, k, nu)} > budget {budget}; stripes m_block "
        f"{mb} n_block {nb} ({tiles} tiles), work_bytes per stripe {stripe}")
    torch.cuda.reset_peak_memory_stats()
    c = entry_counted(f"gemm striped f64 {m}x{n}x{k} nu={nu}", "f64",
                      lambda: gt.gemm(a, b, num_moduli=nu),
                      {"shift_fast": 1 + tiles, "encode_planes": 1 + tiles,
                       "_int_mm": nu * tiles, "fused_epilogue": tiles})
    peak = torch.cuda.max_memory_allocated()
    check(c.shape == (m, n) and bool(torch.isfinite(c).all()),
          "striped output")
    log(f"blocked {card}: max_memory_allocated {peak} bytes "
        f"({peak / 2 ** 30:.2f} GiB) in the call, operands and output "
        f"included")
    check(core.pick_blocking(m, nb, k, nu, torch.float64,
                             device="cuda") == (None, None),
          "the first stripe's columns would stripe again")
    first = gt.gemm(a, b[:, :nb], num_moduli=nu)
    assert_bits_equal(c[:, :nb], first, "first stripe vs unstriped")
    del first
    lo = (n - 1) // nb * nb
    last = gt.gemm(a, b[:, lo:], num_moduli=nu)
    assert_bits_equal(c[:, lo:], last, "last stripe vs unstriped")
    del last
    a8 = a[:8].cpu().numpy()
    b_np = b[:, :FULL].cpu().numpy()
    ref = a8.astype(np.longdouble) @ b_np.astype(np.longdouble)
    scale = np.abs(a8) @ np.abs(b_np)
    err, med = max_median_relerr(c[:8, :FULL].cpu().numpy(), ref)
    nerr, _ = max_median_relerr(
        torch.matmul(a[:8], b[:, :FULL]).cpu().numpy(), ref)
    cw = float(np.max(np.abs(np.asarray(c[:8, :FULL].cpu().numpy(),
                                        np.longdouble) - ref) / scale))
    log(f"accuracy striped rows 0-7, columns 0-8191: emulated max {err:.3e} "
        f"median {med:.3e} max/|A||B| {cw:.3e}; torch.matmul max {nerr:.3e}")
    check(err <= 2 * nerr and cw < 1e-13, f"striped error {err} vs {nerr}")
    del c
    torch.cuda.empty_cache()
    t = dict(striped_ms=cuda_ms(lambda: gt.gemm(a, b, num_moduli=nu), reps=3),
             library_ms=cuda_ms(lambda: torch.matmul(a, b), reps=3))
    t["emulated_tflops"] = 2.0 * m * n * k / (t["striped_ms"] * 1e-3) / 1e12
    t["library_tflops"] = 2.0 * m * n * k / (t["library_ms"] * 1e-3) / 1e12
    log(f"times {card} | striped f64 {m}x{n}x{k} nu={nu}: "
        + ", ".join(f"{k_} {v:.3f}" for k_, v in t.items()))
    del a, b
    torch.cuda.empty_cache()
    # accurate mode's two phases over a 2 x 2 tile grid at 8192^3
    want = gt.gemm(a64, b64, num_moduli=nu, fastmode=False)
    got = entry_counted(
        "gemm accurate 4096x4096 tiles f64 8192^3 nu=16", "f64",
        lambda: gt.gemm(a64, b64, num_moduli=nu, fastmode=False,
                        m_block=FULL // 2, n_block=FULL // 2),
        {"encode_planes": 2 + 4, "_int_mm": 4 + 4 * nu,
         "fused_epilogue": 4})
    assert_bits_equal(got, want, "accurate tiles vs unstriped")
    del got, want
    torch.cuda.empty_cache()


def phases_paths(a64, b64, card):
    """(c) gemm_with_phases at 8192^3: DGEMM nu=16 (K2 on the int8
    residues) and FP8 DGEMM nu=14 (K2 on the widened int16 residues, where
    gemm runs K3): C bit-equal to gemm's; the four phases and their sum
    beside the call. One warm-up and one timed run: each launch twice."""
    import gemmul8_tpu_torch as gt
    for backend, nu, want in (
            ("INT8", 16, {"shift_fast": 4, "encode_planes": 4, "_int_mm": 32,
                          "fused_epilogue": 2}),
            ("FP8", 14, {"shift_fast": 4, "encode_planes_fp8": 4,
                         "_scaled_mm": 6 * 14, "fused_epilogue": 2})):
        c, phases = entry_counted(
            f"gemm_with_phases {backend} f64 8192^3 nu={nu}", "f64",
            lambda: gt.gemm_with_phases(a64, b64, num_moduli=nu,
                                        backend=backend), want)
        assert_bits_equal(c, gt.gemm(a64, b64, num_moduli=nu,
                                     backend=backend),
                          f"gemm_with_phases {backend} vs gemm")
        check(all(v >= 0 for v in phases.values()), f"phases {phases}")
        gemm_ms = cuda_ms(lambda: gt.gemm(a64, b64, num_moduli=nu,
                                          backend=backend), reps=10)
        log(f"times {card} | gemm_with_phases f64 8192^3 {backend} nu={nu}: "
            + ", ".join(f"{k}_ms {v * 1e3:.3f}" for k, v in phases.items())
            + f", sum_ms {sum(phases.values()) * 1e3:.3f}, gemm_ms "
              f"{gemm_ms:.3f}")
        del c
        torch.cuda.empty_cache()


def colmajor(mat, ld):
    """A 1-D column-major buffer on the card with leading dimension ld
    holding mat, its padding rows set to 7777."""
    rows, cols = mat.shape
    buf = torch.full((ld * cols,), 7777.0, dtype=mat.dtype, device="cuda")
    buf.as_strided((rows, cols), (1, ld)).copy_(mat)
    return buf


def compat_paths(a64, b64, card):
    """(d) compat.gemmLt and compat.gemm at 8192^3 f64 nu=16 on 1-D
    column-major CUDA buffers with ld = 8256, ops T/N, alpha 0.7, beta
    -1.3: C bit-equal to gt.gemm on the logical matrices, its padding
    untouched; an enable_skip_scalB call then a skip_scalB call, both
    bit-equal, the second timed; gemmLt on FP8 nu=14; gemm refusing FP8."""
    import gemmul8_tpu_torch as gt
    from gemmul8_tpu_torch import compat
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    c0 = _device_phi(gen, FULL, FULL)
    abuf, bbuf = colmajor(a64.T, LD), colmajor(b64, LD)
    cbuf = colmajor(c0, LD)
    cview = cbuf.as_strided((FULL, FULL), (1, LD))
    args = ("T", "N", FULL, FULL, FULL, 0.7, abuf, LD, bbuf, LD, -1.3,
            cbuf, LD)
    for nu, backend in ((16, "INT8"), (14, "FP8")):
        want = gt.gemm(a64, b64, num_moduli=nu, backend=backend, alpha=0.7,
                       beta=-1.3, c=c0)
        entries = (("gemmLt", compat.gemmLt), ("gemm", compat.gemm))
        for name, fn in entries[:1 if backend == "FP8" else 2]:
            cview.copy_(c0)
            call = {"shift_fast": 2, "_int_mm": nu, "fused_epilogue": 1,
                    "encode_planes": 2} if backend == "INT8" else {
                "shift_fast": 2, "encode_planes_fp8": 2,
                "_scaled_mm": 3 * nu, "fused_epilogue_fp8": 1}
            entry_counted(f"compat.{name} {backend} TN f64 8192^3 nu={nu}",
                          "f64", lambda: fn(None, *args, nu, True,
                                            backend=backend), call)
            assert_bits_equal(cview, want, f"compat.{name} {backend}")
        check(bool((cbuf.view(FULL, LD)[:, FULL:] == 7777.0).all()),
              "compat wrote into C's padding")
    try:
        compat.gemm(None, *args, 16, True, backend="FP8")
    except ValueError as e:
        log(f"compat.gemm refuses FP8: {e}")
    else:
        raise AssertionError("compat.gemm took the FP8 backend")
    want = gt.gemm(a64, b64, num_moduli=16, alpha=0.7, beta=-1.3, c=c0)
    h = compat.create()
    cview.copy_(c0)
    entry_counted("compat.gemm enable_skip_scalB f64 8192^3 nu=16", "f64",
                  lambda: compat.gemm(h, *args, 16, True,
                                      enable_skip_scalB=True),
                  int8_call(16))
    assert_bits_equal(cview, want, "compat.gemm enable_skip_scalB")
    cview.copy_(c0)
    entry_counted("compat.gemm skip_scalB f64 8192^3 nu=16", "f64",
                  lambda: compat.gemm(h, *args, 16, True, skip_scalB=True),
                  dict(int8_call(16), shift_fast=1, encode_planes=1))
    assert_bits_equal(cview, want, "compat.gemm skip_scalB")
    t = dict(
        gemmLt_ms=cuda_ms(lambda: compat.gemmLt(None, *args, 16, True),
                          reps=5),
        skip_scalB_ms=cuda_ms(lambda: compat.gemm(h, *args, 16, True,
                                                  skip_scalB=True), reps=5),
        gemm_ms=cuda_ms(lambda: gt.gemm(a64, b64, num_moduli=16, alpha=0.7,
                                        beta=-1.3, c=c0), reps=5))
    log(f"times {card} | compat f64 8192^3 nu=16 TN ld={LD}: "
        + ", ".join(f"{k} {v:.3f}" for k, v in t.items()))
    compat.destroy(h)
    del abuf, bbuf, cbuf, cview, c0, want
    torch.cuda.empty_cache()


class NativeMatmuls(TorchDispatchMode):
    """Counts the native matrix products that reach ATen (forward, and the
    backward's on autograd's threads, which carry the dispatch mode)."""
    OPS = ("mm", "addmm", "bmm", "baddbmm", "matmul", "dot", "mv")

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in self.OPS:
            self.count += 1
        return func(*args, **(kwargs or {}))


def interposer_paths(a64, b64, A, B, card):
    """(e) the interposer: `a @ b` under gt.emulate on the 8192^2 f64
    operands, bits and launches equal to gt.gemm's; ZGEMM nu=16 through the
    hook bit-equal to gt.gemm; an f32 MLP (8192-8192-8192, batch 8192)
    forward and backward under install(num_moduli=8), every GEMM emulated
    and no native product, logits and grads bit-identical over two runs;
    one matmul on a worker thread emulated."""
    import threading
    import gemmul8_tpu_torch as gt
    from gemmul8_tpu_torch import hook
    from gemmul8_tpu_torch.models import mlp
    ref = gt.gemm(a64, b64, num_moduli=16)
    with gt.emulate(num_moduli=16) as mode:
        c = entry_counted("hook a @ b f64 8192^3 nu=16", "f64",
                          lambda: a64 @ b64, int8_call(16))
    check(mode.intercepted == 1, f"hook intercepted {mode.intercepted}")
    assert_bits_equal(c, ref, "hook a @ b vs gt.gemm")
    del c

    def hooked():
        with gt.emulate(num_moduli=16):
            return a64 @ b64
    t = in_turns({"gemm": lambda: gt.gemm(a64, b64, num_moduli=16),
                  "hook": hooked}, reps=5)
    log(f"times {card} | hook a @ b f64 8192^3 nu=16: gemm_ms "
        f"{t['gemm'][0]:.3f} (passes {t['gemm'][1]:.3f}, {t['gemm'][2]:.3f})"
        f", hook_ms {t['hook'][0]:.3f} (passes {t['hook'][1]:.3f}, "
        f"{t['hook'][2]:.3f}), hook - gemm {t['hook'][0] - t['gemm'][0]:.3f}")
    zref = gt.gemm(A, B, num_moduli=16)
    with gt.emulate(num_moduli=16):
        z = entry_counted("hook A @ B c128 8192^3 nu=16", "c128",
                          lambda: A @ B,
                          {"shift_fast": 2, "encode_planes": 4,
                           "_int_mm": 48, "fused_epilogue_complex": 1})
    assert_bits_equal(z, zref, "hook ZGEMM vs gt.gemm")
    del z, zref, ref
    torch.cuda.empty_cache()

    model = mlp.MLP([FULL, FULL, FULL], seed=SEED, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    x = torch.randn((FULL, FULL), generator=gen, device="cuda")

    def step():
        model.zero_grad()
        with NativeMatmuls() as native:
            logits = model(x)
            logits.square().mean().backward()
            torch.cuda.synchronize()
        return native.count, logits.detach(), [p.grad.clone()
                                               for p in model.parameters()]

    # the native step shows what the counter sees: 2 forward products, and
    # the backward's 3 where the dispatch mode reaches autograd's threads
    n_native, _, _ = step()
    check(n_native in (2, 5), f"native MLP step: {n_native} native "
          "products counted, want 2 forward (+ 3 backward)")
    gt.install(num_moduli=8)
    try:
        before = hook.COUNTS["emulated"]
        n1, l1, g1 = entry_counted(
            "hook MLP f32 8192-8192-8192 batch 8192 nu=8 forward+backward",
            "f32", step, int8_call(8, tiles=5) | {"shift_fast": 10,
                                                  "encode_planes": 10})
        emulated = hook.COUNTS["emulated"] - before
        n2, l2, g2 = step()
        t_step = cuda_ms(step, reps=3)
        res = {}
        a32, b32 = a64.float(), b64.float()
        worker = threading.Thread(target=lambda: res.update(c=a32 @ b32))
        before_t = hook.COUNTS["emulated"]
        worker.start()
        worker.join(timeout=600)
        check(not worker.is_alive(), "worker thread did not finish")
        on_thread = hook.COUNTS["emulated"] - before_t
    finally:
        gt.uninstall()
    check(emulated == 5 and n1 == 0 and n2 == 0,
          f"MLP step: {emulated} emulated GEMMs (want 5), native products "
          f"{n1}, {n2} (want 0)")
    assert_bits_equal(l1, l2, "MLP logits rerun")
    for p, q in zip(g1, g2):
        assert_bits_equal(p, q, "MLP grads rerun")
    check(on_thread == 1, f"worker thread: {on_thread} emulated")
    assert_bits_equal(res["c"], gt.gemm(a32, b32, num_moduli=8),
                      "worker-thread matmul vs gt.gemm")
    log(f"hook MLP: {emulated} GEMMs emulated (2 forward, 3 backward), 0 "
        f"native products (native step: {n_native}); logits and 4 grads "
        f"bit-identical over two runs; worker-thread matmul emulated")
    log(f"times {card} | hook MLP f32 8192-8192-8192 batch 8192 nu=8 "
        f"forward+backward: step_ms {t_step:.3f}")
    del model, x, l1, l2, g1, g2, res
    torch.cuda.empty_cache()


@contextlib.contextmanager
def cpu_epilogue_ff():
    """Inside the block "auto" resolves to "ff" on the CPU as on the card,
    so that a CPU call of an entry with no epilogue argument (compat, the
    interposer) takes the card's route, the one its bits are held to."""
    from gemmul8_tpu_torch import core
    orig = core.resolve_epilogue
    core.resolve_epilogue = lambda epilogue="auto", device="cpu": orig(
        "ff" if epilogue == "auto" else epilogue, device)
    try:
        yield
    finally:
        core.resolve_epilogue = orig


def entry_card_vs_cpu(rng):
    """Each new entry on the card against the package's CPU path, bit for
    bit, at small shapes: precomputed operands (INT8 and FP8, one- and
    two-sided), striped gemm (fast, robust, accurate, alpha/beta, trans,
    FP8), gemm_with_phases' C, compat (ld-strided, ops, alpha/beta, skip),
    the interposer's outputs and gradients (real, complex, batched, two
    nn.Linear layers)."""
    import gemmul8_tpu_torch as gt
    from gemmul8_tpu_torch import compat, core
    from gemmul8_tpu_torch.models import mlp
    f32 = np.float32
    m, k, n_ = 300, 520, 200
    a, b = phi_matrix(rng, m, k, 0.5), phi_matrix(rng, k, n_, 0.5)
    c = phi_matrix(rng, m, n_, 0.5)
    a32, b32 = a.astype(f32), b.astype(f32)
    ca = a + 1j * phi_matrix(rng, m, k, 0.5)
    cb = b + 1j * phi_matrix(rng, k, n_, 0.5)
    g = phi_matrix(rng, m, n_, 0.5)
    cg = g + 1j * phi_matrix(rng, m, n_, 0.5)

    def quantized(d, backend, nu, sides, x=a, y=b, **kw):
        qa = gt.precompute(x, "A", num_moduli=nu, backend=backend, device=d)
        qb = gt.precompute(y, "B", num_moduli=nu, backend=backend, device=d)
        yt = torch.from_numpy(y).to(d)
        return gt.gemm_quantized(qa, qb if sides == 2 else yt, **kw)

    def from_numpy(d):
        qs = [gt.precompute(x, side, num_moduli=16, device="cpu")
              for x, side in ((a, "A"), (b, "B"))]
        return gt.gemm_quantized(*(core.quantized_from_numpy(
            q.planes.numpy(), q.sft.numpy(), q.side, 16, "INT8", q.dims,
            device=d) for q in qs))

    def compat_call(d, skip):
        cbuf = np.full(LD * n_, 7777.0)
        np.copyto(cbuf.reshape(n_, LD).T[:m], c)
        abuf = torch.from_numpy(a.T.copy()).to(d)      # op T: stored k x m
        h = compat.create()
        for flags in ((dict(enable_skip_scalB=True), dict(skip_scalB=True))
                      if skip else ({},)):
            out = cbuf.copy()
            compat.gemm(h, "T", "N", m, n_, k, 0.7, abuf, k, b, k, -1.3, out,
                        LD, 16, True, device=d, **flags)
        return torch.from_numpy(out)

    def hooked(d, x, y, nu, grad=None):
        tx = torch.from_numpy(x).to(d).requires_grad_(grad is not None)
        ty = torch.from_numpy(y).to(d).requires_grad_(grad is not None)
        with gt.emulate(num_moduli=nu):
            out = tx @ ty
        if grad is None:
            return out
        out.backward(torch.from_numpy(grad).to(d))
        return torch.cat([out.detach().flatten(), tx.grad.flatten(),
                          ty.grad.flatten()])

    def linear_step(d):
        # the MLP's two nn.Linear layers without the GELU between them and
        # with a given output gradient: the GELU's tanh and the bias
        # gradients' sums round differently on the two devices
        model = mlp.MLP([96, 128, 40], seed=5, device=d)
        x = torch.from_numpy(a32[:64, :96]).to(d).requires_grad_(True)
        with gt.emulate(num_moduli=8):
            out = model.layers[1](model.layers[0](x))
            out.backward(torch.from_numpy(g[:64, :40].astype(f32)).to(d))
        return torch.cat([out.detach().flatten(), x.grad.flatten()]
                         + [layer.weight.grad.flatten()
                            for layer in model.layers])

    cases = [
        ("precompute both INT8 f64 nu=16",
         lambda d: quantized(d, "INT8", 16, 2)),
        ("precompute one INT8 f64 nu=16",
         lambda d: quantized(d, "INT8", 16, 1)),
        ("precompute both FP8 f32 nu=7",
         lambda d: quantized(d, "FP8", 7, 2, a32, b32,
                             out_dtype=torch.float32)),
        ("quantized_from_numpy INT8 f64 nu=16", from_numpy),
        ("striped fast f64 nu=16 128x96",
         lambda d: gt.gemm(a, b, num_moduli=16, m_block=128, n_block=96,
                           device=d)),
        ("striped robust f32 nu=8 alpha/beta trans_b",
         lambda d: gt.gemm(a32, b32.T.copy(), num_moduli=8, fastmode="robust",
                           trans_b="T", alpha=-1.25, beta=0.75,
                           c=c.astype(f32), n_block=64, device=d)),
        ("striped accurate f64 nu=16",
         lambda d: gt.gemm(a, b, num_moduli=16, fastmode=False, m_block=128,
                           n_block=64, device=d)),
        ("striped FP8 f64 nu=14",
         lambda d: gt.gemm(a, b, num_moduli=14, backend="FP8", n_block=64,
                           device=d)),
        ("gemm_with_phases INT8 f64 nu=16",
         lambda d: gt.gemm_with_phases(a, b, num_moduli=16, epilogue="ff",
                                       device=d)[0]),
        ("gemm_with_phases FP8 f64 nu=14",
         lambda d: gt.gemm_with_phases(a, b, num_moduli=14, backend="FP8",
                                       epilogue="ff", device=d)[0]),
        ("compat.gemm TN ld-strided alpha/beta", lambda d: compat_call(d, 0)),
        ("compat.gemm skip_scalB", lambda d: compat_call(d, 1)),
        ("hook a @ b f32 nu=8", lambda d: hooked(d, a32, b32, 8)),
        ("hook grads f64 nu=16", lambda d: hooked(d, a, b, 16, g)),
        ("hook grads c128 nu=16", lambda d: hooked(d, ca, cb, 16, cg)),
        ("hook a @ b c128 nu=20 (K5 + 2 K2)",
         lambda d: hooked(d, ca, cb, 20)),
        ("hook bmm f64 nu=16",
         lambda d: hooked(d, np.stack([a[:96], a[96:192]]),
                          np.stack([b[:, :64], b[:, 64:128]]), 16)),
        ("hook nn.Linear x2 f32 nu=8 forward+backward", linear_step),
    ]
    for label, fn in cases:
        # "auto" picks "f64" on the CPU and "ff" on the card: each CPU call
        # here runs "ff" as the card does
        t0 = time.perf_counter()
        got = fn("cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with cpu_epilogue_ff():
            ref = fn("cpu")
        t2 = time.perf_counter()
        assert_bits_equal(got, ref, f"card vs cpu {label}")
        log(f"  ok  card vs cpu {label}  card {t1 - t0:.2f}s cpu "
            f"{t2 - t1:.2f}s")
    return len(cases)


# ---------------------------------------------------------------------------
# phase 5: the card against the package's own CPU path
# ---------------------------------------------------------------------------

def card_vs_cpu(rng):
    import gemmul8_tpu_torch as gt
    from gemmul8_tpu_torch import quantize
    n = 0
    for (m, k, n_), epis, abs_ in (((1000, 2048, 600), ("ff", "f64"), True),
                                  ((256, (1 << 17) + 512, 256), ("ff", "f64"),
                                   False)):
        for dt, nu in ((np.float64, 16), (np.float32, 8)):
            a = phi_matrix(rng, m, k, 0.5, dt)
            b = phi_matrix(rng, k, n_, 0.5, dt)
            c = phi_matrix(rng, m, n_, 0.5, dt)
            runs = [dict(epilogue=e) for e in epis]
            if abs_:
                runs += [dict(epilogue=e, alpha=-1.25, beta=0.75, c=c)
                         for e in epis]
            for kw in runs:
                t0 = time.perf_counter()
                got = gt.gemm(a, b, num_moduli=nu, device="cuda", **kw)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                ref = gt.gemm(a, b, num_moduli=nu, device="cpu", **kw)
                t2 = time.perf_counter()
                label = (f"card vs cpu {dt.__name__} {m}x{k}x{n_} nu={nu} "
                         f"{ {x: y for x, y in kw.items() if x != 'c'} }")
                sg = [quantize.shift_fast(torch.from_numpy(v).to(d), nu,
                                          "INT8", ax).cpu().numpy()
                      for d in ("cuda", "cpu") for v, ax in ((a, 1), (b, 0))]
                extra = "" if (np.array_equal(sg[0], sg[2])
                               and np.array_equal(sg[1], sg[3])) else (
                    f"\n  shifts differ: sftA card {sg[0].tolist()}\n"
                    f"  sftA cpu {sg[2].tolist()}\n  sftB card {sg[1].tolist()}"
                    f"\n  sftB cpu {sg[3].tolist()}")
                assert_bits_equal(got, ref, label, extra)
                log(f"  ok  {label}  card {t1 - t0:.2f}s cpu {t2 - t1:.2f}s")
                n += 1
    return n


def fp8_card_vs_cpu(rng):
    """The FP8 backend on the card against the package's CPU path, bit for
    bit: f64 nu=14 and f32 nu=7 at 1000x2048x600 with each epilogue named,
    robust shifts, ops T with general alpha/beta, and the K-chunked
    128x(2^16+512)x128."""
    import gemmul8_tpu_torch as gt
    f64, f32 = np.float64, np.float32
    ab = dict(alpha=-1.25, beta=0.75)
    cases = [   # (m, k, n, dtype, keywords)
        (1000, 2048, 600, f64, dict(num_moduli=14, epilogue="ff")),
        (1000, 2048, 600, f64, dict(num_moduli=14, epilogue="f64")),
        (1000, 2048, 600, f32, dict(num_moduli=7, epilogue="ff")),
        (1000, 2048, 600, f32, dict(num_moduli=7, epilogue="f64")),
        (300, 520, 200, f64, dict(num_moduli=14, epilogue="ff",
                                  fastmode="robust")),
        (300, 520, 200, f32, dict(num_moduli=7, epilogue="f64",
                                  fastmode="robust")),
        (300, 520, 200, f64, dict(num_moduli=14, epilogue="ff", trans_a="T",
                                  **ab)),
        (300, 520, 200, f32, dict(num_moduli=7, epilogue="f64", trans_b="T",
                                  **ab)),
        (128, (1 << 16) + 512, 128, f64, dict(num_moduli=14, epilogue="ff")),
        (128, (1 << 16) + 512, 128, f64, dict(num_moduli=14, epilogue="f64")),
    ]
    n = 0
    for m, k, n_, dt, kw in cases:
        kw = dict(kw, backend="FP8")
        a = phi_matrix(rng, *((k, m) if kw.get("trans_a") else (m, k)), 0.5,
                       dt)
        b = phi_matrix(rng, *((n_, k) if kw.get("trans_b") else (k, n_)),
                       0.5, dt)
        if "beta" in kw:
            kw["c"] = phi_matrix(rng, m, n_, 0.5, dt)
        t0 = time.perf_counter()
        got = gt.gemm(a, b, device="cuda", **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ref = gt.gemm(a, b, device="cpu", **kw)
        t2 = time.perf_counter()
        label = (f"card vs cpu FP8 {dt.__name__} {m}x{k}x{n_} "
                 f"{ {x: y for x, y in kw.items() if x != 'c'} }")
        assert_bits_equal(got, ref, label)
        log(f"  ok  {label}  card {t1 - t0:.2f}s cpu {t2 - t1:.2f}s")
        n += 1
    return n


def cphi(rng, m, n, dt):
    return (phi_matrix(rng, m, n, 0.5) + 1j * phi_matrix(rng, m, n, 0.5)
            ).astype(dt)


def complex_card_vs_cpu(rng):
    """The complex entries on the card against the package's CPU path, bit
    for bit: ragged ZGEMM (both epilogues, nu=16; nu=20) and CGEMM, ops T and
    C, general complex alpha/beta, the K-chunked path, gemm_planar and herk
    with trans False and True."""
    import gemmul8_tpu_torch as gt
    c128, c64 = np.complex128, np.complex64
    alpha, beta = -1.25 + 0.5j, 0.75 - 0.25j
    cases = [   # (entry, m, k, n, dtype, keywords)
        ("gemm", 1000, 2048, 600, c128, dict(num_moduli=16, epilogue="ff")),
        ("gemm", 1000, 2048, 600, c128, dict(num_moduli=16, epilogue="f64")),
        ("gemm", 1000, 2048, 600, c128, dict(num_moduli=20)),
        ("gemm", 1000, 2048, 600, c64, dict(num_moduli=8)),
        ("gemm", 300, 520, 200, c128, dict(num_moduli=16, trans_a="T",
                                           trans_b="C")),
        ("gemm", 300, 520, 200, c64, dict(num_moduli=8, trans_a="C",
                                          trans_b="N", epilogue="f64")),
        ("gemm", 300, 520, 200, c128, dict(num_moduli=16, alpha=alpha,
                                           beta=beta)),
        ("gemm", 300, 520, 200, c128, dict(num_moduli=16, alpha=alpha,
                                           beta=beta, epilogue="f64")),
        ("gemm", 300, 520, 200, c64, dict(num_moduli=8, alpha=alpha,
                                          beta=beta)),
        ("gemm", 128, (1 << 17) + 512, 128, c128, dict(num_moduli=16)),
        ("planar", 300, 520, 200, c128, dict(num_moduli=16, trans_a="C")),
        ("herk", 300, 520, 300, c128, dict(num_moduli=16, alpha=-0.5,
                                           beta=2.0)),
        ("herk", 520, 300, 520, c128, dict(num_moduli=16, trans=True,
                                           alpha=1.5, beta=1.0)),
    ]
    n = 0
    for entry, m, k, n_, dt, kw in cases:
        # "auto" would pick "f64" on the CPU and "ff" on the card
        kw = dict({"epilogue": "ff"}, **kw)
        if entry == "herk":
            a = cphi(rng, m, k, dt)
            mdim = k if kw.get("trans") else m
            kw = dict(kw, c=cphi(rng, mdim, mdim, dt))
            fn = lambda d: gt.herk(a, device=d, **kw)  # noqa: E731
        else:
            ta, tb = kw.get("trans_a", "N"), kw.get("trans_b", "N")
            a = cphi(rng, *((m, k) if ta == "N" else (k, m)), dt)
            b = cphi(rng, *((k, n_) if tb == "N" else (n_, k)), dt)
            if "beta" in kw:
                kw = dict(kw, c=cphi(rng, m, n_, dt))
            if entry == "gemm":
                fn = lambda d: gt.gemm(a, b, device=d, **kw)  # noqa: E731
            else:
                planes = [np.ascontiguousarray(x)
                          for x in (a.real, a.imag, b.real, b.imag)]
                fn = lambda d: torch.complex(  # noqa: E731
                    *gt.gemm_planar(*planes, device=d, **kw))
        t0 = time.perf_counter()
        got = fn("cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ref = fn("cpu")
        t2 = time.perf_counter()
        label = (f"card vs cpu {entry} {np.dtype(dt).name} {m}x{k}x{n_} "
                 f"{ {x: y for x, y in kw.items() if x != 'c'} }")
        assert_bits_equal(got, ref, label)
        log(f"  ok  {label}  card {t1 - t0:.2f}s cpu {t2 - t1:.2f}s")
        n += 1
    return n


# ---------------------------------------------------------------------------
# complex FP8 at full width, compare and blas3: the kernels at the paths'
# own inputs, the paths with their launch counts and accuracy, the card
# against the CPU, and the times
# ---------------------------------------------------------------------------

# the complex FP8 paths at 8192^3: name, dtype, nu, fastmode, and the
# launches of one gt.gemm call in CFP8_COUNT_KEYS' order (nu=14 and nu=7:
# log2P 64.33 and 33.02, the FP8 counts matched to INT8 nu=16 and 8, as for
# the real paths; nu=18 the K5 + 2 x K2 split; accurate mode's estimates,
# 4 int8 products a lane, counted apart)
CFP8_COUNT_KEYS = ("encode_lanes_fp8", "_scaled_mm", "reassemble_fp8",
                   "fused_epilogue_complex", "fused_recombine_3m",
                   "fused_epilogue", "encode_planes", "encode_planes_fp8",
                   "fused_epilogue_fp8", "_int_mm", "estimate_int_mm")
CFP8_PATHS = (
    ("zgemm_fp8_14", torch.complex128, 14, True,
     (2, 126, 3, 1, 0, 0, 0, 0, 0, 0, 0)),
    ("cgemm_fp8_7", torch.complex64, 7, True,
     (2, 63, 3, 1, 0, 0, 0, 0, 0, 0, 0)),
    ("zgemm_fp8_18", torch.complex128, 18, True,
     (2, 162, 3, 0, 1, 2, 0, 0, 0, 0, 0)),
    ("zgemm_fp8_14_accurate", torch.complex128, 14, False,
     (2, 126, 3, 1, 0, 0, 0, 0, 0, 12, 12)),
)
CFP8_RUNS: dict = {}          # name -> that path's counts


def complex_fp8_stages(nu, a, b, fastmode):
    """The complex FP8 path's shifts and lanes as gt.gemm runs them:
    ((Ar, Ai), (Br, Bi)), (sa, sb), (pa, pb)."""
    from gemmul8_tpu_torch import complex_gemm as cg
    pa_, pb_ = ((x.real.contiguous(), x.imag.contiguous()) for x in (a, b))
    sa, sb = cg.shifts(pa_, pb_, nu, fastmode, "FP8")
    pa = cg._quantize_complex(*pa_, sa, 0, nu, "FP8", False)
    pb = cg._quantize_complex(*pb_, sb, 1, nu, "FP8", False)
    return (pa_, pb_), (sa, sb), (pa, pb)


def full_size_complex_fp8_cases(A, B):
    """Each complex FP8 kernel on the inputs its full-width path gives it:
    K6c on A's and B's Re and Im (their plain versions on row blocks of the
    operands), K3r on each lane's FP8 products, and K4 (nu <= 16) or K5 and
    K2 on K5's int32 output (nu = 18) on the path's own lane residues, for
    each of CFP8_PATHS."""
    from gemmul8_tpu_torch import fp8, kernels
    for name, dt, nu, fastmode, _ in CFP8_PATHS:
        a, b = A.to(dt), B.to(dt)
        ((ar, ai), (br, bi)), (sa, sb), (pa, pb) = complex_fp8_stages(
            nu, a, b, fastmode)
        key = LANES_KEY[ar.dtype]
        compare_rows(key, pa, lambda r0, r1: kernels.encode_lanes_fp8_plain(
            ar[r0:r1], ai[r0:r1], sa[r0:r1], 0, nu), f"lanes of A {name}")
        compare_rows(key, pb, lambda r0, r1: kernels.encode_lanes_fp8_plain(
            br[r0:r1], bi[r0:r1], sb, 1, nu), f"lanes of B {name}")
        res = torch.empty((3 * nu, FULL, FULL), dtype=torch.int32,
                          device="cuda")
        for lane in range(3):
            c3 = fp8.residue_matmul_fp8(pa[lane], pb[lane])
            got = kernels.reassemble_fp8(c3, nu,
                                         out=res[lane * nu:(lane + 1) * nu])
            compare_rows(REASSEMBLE_KEY, got,
                         lambda r0, r1: kernels.reassemble_fp8_plain(
                             c3[:, r0:r1].contiguous(), nu),
                         f"reassembly of lane {lane} {name}")
            del c3, got
            torch.cuda.empty_cache()
        del pa, pb
        blk = lambda r0, r1: res[:, r0:r1].contiguous()  # noqa: E731
        if nu <= 16:
            compare_rows(K4_FP8_KEY[dt], kernels.fused_epilogue_complex(
                             res, sa, sb, nu, "FP8", dt),
                         lambda r0, r1: kernels.fused_epilogue_complex_plain(
                             blk(r0, r1), sa[r0:r1], sb, nu, "FP8", dt),
                         f"complex FP8 epilogue {name}")
        else:
            mids = kernels.fused_recombine_3m(res, nu, "FP8")
            compare_rows(K5_FP8_KEY, mids,
                         lambda r0, r1: kernels.fused_recombine_3m_plain(
                             blk(r0, r1), nu, "FP8"),
                         f"FP8 recombine {name}")
            del res
            for part, mid in zip(("Re", "Im"), mids):
                compare_rows(K2_FP8_SPLIT_KEY, kernels.fused_epilogue(
                                 mid, sa, sb, nu, "FP8", ar.dtype),
                             lambda r0, r1: kernels.fused_epilogue_plain(
                                 mid[:, r0:r1], sa[r0:r1], sb, nu, "FP8",
                                 ar.dtype),
                             f"FP8 split epilogue {name} {part}")
            del mids
        del blk
        torch.cuda.empty_cache()


def complex_fp8_main_paths(A, B):
    """The complex FP8 paths through gt.gemm, each with its launch counts
    set to 0 just before and read just after; the output's shape, dtype and
    finiteness; rows 0-7 against the longdouble oracle of the INT8 complex
    paths (the same operands), within the ZGEMM limit (<= 2x cuBLAS ZGEMM's
    error) or the CGEMM one (below cuBLAS CGEMM's); and the peak memory."""
    import gemmul8_tpu_torch as gt
    for name, dt, nu, fastmode, want in CFP8_PATHS:
        a, b = A.to(dt), B.to(dt)
        torch.cuda.reset_peak_memory_stats()
        c, counts = run_counted(lambda: gt.gemm(
            a, b, num_moduli=nu, backend="FP8", fastmode=fastmode))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        got = tuple(counts[k] for k in CFP8_COUNT_KEYS)
        check(got == want, f"{name} launches {counts}, want "
              f"{dict(zip(CFP8_COUNT_KEYS, want))}")
        CFP8_RUNS[name] = counts
        check(c.shape == (FULL, FULL) and c.dtype == dt
              and bool(torch.isfinite(torch.view_as_real(c)).all()),
              f"{name} output {c.shape} {c.dtype}")
        ref = COMPLEX_ORACLES[("gemm", dt)]
        err, med = complex_relerr(c[:8].cpu().numpy(), ref)
        nerr, nmed = complex_relerr(torch.matmul(a, b)[:8].cpu().numpy(), ref)
        log(f"accuracy {name} rows 0-7: emulated max {err:.3e} median "
            f"{med:.3e}; torch.matmul max {nerr:.3e} median {nmed:.3e}")
        if dt == torch.complex64:
            check(err < nerr, f"{name} error {err} vs cuBLAS {nerr}")
        else:
            check(err <= 2 * nerr, f"{name} error {err} vs cuBLAS {nerr}")
        log(f"main path {name} launches: "
            f"{ {k: counts[k] for k in CFP8_COUNT_KEYS if counts[k]} }, "
            f"peak memory {peak:.2f} GiB")
        del c
        torch.cuda.empty_cache()


def os1_path(a64, b64, card):
    """compare.matmul_os1_int8 (d = 8) at 4096^3 on the DGEMM operands'
    corner, beside gt.gemm nu=16 on the same operands: launches (36 int8
    products), max relative error on rows 0-7 against a longdouble oracle,
    and times."""
    import gemmul8_tpu_torch as gt
    n = FULL // 2
    a, b = a64[:n, :n].contiguous(), b64[:n, :n].contiguous()
    c, counts = run_counted(lambda: gt.compare.matmul_os1_int8(a, b))
    check(counts["_int_mm"] == 36, f"os1 int8 products {counts['_int_mm']}")
    check(c.shape == (n, n) and c.dtype == torch.float64
          and bool(torch.isfinite(c).all()), "os1 output")
    a8, b_np = a[:8].cpu().numpy(), b.cpu().numpy()
    ref = a8.astype(np.longdouble) @ b_np.astype(np.longdouble)
    err, _ = max_median_relerr(c[:8].cpu().numpy(), ref)
    emu = gt.gemm(a, b, num_moduli=16)
    eerr, _ = max_median_relerr(emu[:8].cpu().numpy(), ref)
    nerr, _ = max_median_relerr(torch.matmul(a, b)[:8].cpu().numpy(), ref)
    t = in_turns({"os1": lambda: gt.compare.matmul_os1_int8(a, b),
                  "gemm": lambda: gt.gemm(a, b, num_moduli=16),
                  "matmul": lambda: torch.matmul(a, b)}, reps=3)
    log(f"os1 int8 4096^3 d=8 rows 0-7: max relative error {err:.3e} "
        f"(emulated DGEMM nu=16 {eerr:.3e}, torch.matmul {nerr:.3e}); "
        f"launches {counts['_int_mm']} _int_mm")
    log(f"times {card} | 4096^3: os1_int8_ms {t['os1'][0]:.3f}, gemm nu=16 "
        f"{t['gemm'][0]:.3f}, torch.matmul {t['matmul'][0]:.3f}")
    check(err < 1e-9, f"os1 error {err}")
    del c, emu
    torch.cuda.empty_cache()


def complex_fp8_card_vs_cpu(rng):
    """Complex FP8 on the card against the package's CPU path, bit for bit:
    c128 and c64, ops N/T/C, general alpha/beta, fast, robust and accurate
    mode at nu 7, 14 and 18, gemm_planar, gemm_batched, gemm_batched_planar,
    compat.gemmLt and the interposer (their "auto" epilogue as the card
    resolves it), a K-chunked shape past k = 2^16; every blas3 function on
    INT8 and FP8; matmul_os1_int8 bit for bit and matmul_bf16x9 within its
    stated tolerance."""
    import gemmul8_tpu_torch as gt
    from gemmul8_tpu_torch import compat
    c128, c64 = np.complex128, np.complex64
    alpha, beta = -1.25 + 0.5j, 0.75 - 0.25j
    fp8 = dict(backend="FP8", epilogue="ff")
    cases = [   # (entry, m, k, n, dtype, keywords)
        ("gemm", 300, 520, 200, c128, dict(num_moduli=14, **fp8)),
        ("gemm", 300, 520, 200, c128, dict(num_moduli=14, backend="FP8",
                                           epilogue="f64", trans_a="T",
                                           trans_b="C")),
        ("gemm", 300, 520, 200, c64, dict(num_moduli=7, fastmode="robust",
                                          trans_a="C", alpha=alpha,
                                          beta=beta, **fp8)),
        ("gemm", 300, 520, 200, c128, dict(num_moduli=18, trans_b="T",
                                           alpha=alpha, beta=beta, **fp8)),
        ("gemm", 300, 520, 200, c128, dict(num_moduli=14, fastmode=False,
                                           trans_a="C", trans_b="C", **fp8)),
        ("gemm", 300, 520, 200, c64, dict(num_moduli=7, fastmode=False,
                                          alpha=alpha, **fp8)),
        ("gemm", 300, 520, 200, c128, dict(num_moduli=18, fastmode=False,
                                           beta=beta, **fp8)),
        ("gemm", 32, (1 << 16) + 512, 48, c128, dict(num_moduli=14, **fp8)),
        ("planar", 300, 520, 200, c128, dict(num_moduli=14, trans_a="C",
                                             **fp8)),
        ("batched", 100, 260, 80, c64, dict(num_moduli=7, **fp8)),
        ("batched_planar", 100, 260, 80, c128, dict(num_moduli=18,
                                                    fastmode="robust", **fp8)),
        ("gemmLt", 300, 520, 200, c128, dict(num_moduli=14, trans_a="C")),
        ("hook", 300, 520, 200, c128, dict(num_moduli=14)),
    ]
    n = 0

    def run(label, fn):
        nonlocal n
        t0 = time.perf_counter()
        got = fn("cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with cpu_epilogue_ff():
            ref = fn("cpu")
        t2 = time.perf_counter()
        for g, r in zip(got, ref) if isinstance(got, tuple) else [(got, ref)]:
            assert_bits_equal(g, r, label)
        log(f"  ok  {label}  card {t1 - t0:.2f}s cpu {t2 - t1:.2f}s")
        n += 1

    for entry, m, k, n_, dt, kw in cases:
        ta, tb = kw.get("trans_a", "N"), kw.get("trans_b", "N")
        if entry.startswith("batched"):
            a = np.stack([cphi(rng, m, k, dt) for _ in range(3)])
            b = np.stack([cphi(rng, k, n_, dt) for _ in range(3)])
        else:
            a = cphi(rng, *((m, k) if ta == "N" else (k, m)), dt)
            b = cphi(rng, *((k, n_) if tb == "N" else (n_, k)), dt)
        if "beta" in kw:
            kw = dict(kw, c=cphi(rng, m, n_, dt))
        planes = [np.ascontiguousarray(x)
                  for x in (a.real, a.imag, b.real, b.imag)]
        if entry == "gemm":
            fn = lambda d: gt.gemm(a, b, device=d, **kw)  # noqa: E731
        elif entry == "planar":
            fn = lambda d: gt.gemm_planar(*planes, device=d, **kw)  # noqa
        elif entry == "batched":
            fn = lambda d: gt.gemm_batched(a, b, device=d, **kw)  # noqa
        elif entry == "batched_planar":
            fn = lambda d: gt.gemm_batched_planar(  # noqa: E731
                *planes, device=d, **kw)
        elif entry == "gemmLt":                    # 2-D buffers, in place
            def fn(d, a=a, b=b, kw=kw):
                c = np.zeros((m, n_), dt)
                compat.gemmLt(None, ta, tb, m, n_, k, alpha, a, a.shape[0],
                              b, b.shape[0], 0.0, c, m,
                              num_moduli=kw["num_moduli"], fastmode=True,
                              backend="FP8", device=d)
                return torch.from_numpy(c)
        else:                                       # the interposer
            def fn(d, a=a, b=b, kw=kw):
                x, y = (torch.from_numpy(v).to(d) for v in (a, b))
                with gt.emulate(num_moduli=kw["num_moduli"], backend="FP8"):
                    return x @ y
        run(f"card vs cpu complex FP8 {entry} {np.dtype(dt).name} "
            f"{m}x{k}x{n_} { {x: y for x, y in kw.items() if x != 'c'} }", fn)
    # blas3 on INT8 and FP8
    for backend in ("INT8", "FP8"):
        kw = dict(num_moduli=14, backend=backend)
        a, b = phi_matrix(rng, 200, 300, 0.5), phi_matrix(rng, 200, 300, 0.5)
        ca, cb = cphi(rng, 200, 300, c128), cphi(rng, 200, 300, c128)
        sq, csq = phi_matrix(rng, 200, 200, 0.5), cphi(rng, 200, 200, c128)
        c, cc = phi_matrix(rng, 200, 200, 0.5), cphi(rng, 200, 300, c128)
        c300 = cphi(rng, 300, 300, c128)
        cplanes = [np.ascontiguousarray(x) for x in (csq.real, csq.imag,
                                                     ca.real, ca.imag)]
        for label, fn in (
                ("syr2k", lambda d: gt.syr2k(a, b, alpha=-0.5, beta=2.0,
                                             c=c, device=d, **kw)),
                ("her2k", lambda d: gt.her2k(ca, cb, trans=True, alpha=alpha,
                                             beta=0.5, c=c300, device=d,
                                             **kw)),
                ("symm", lambda d: gt.symm(sq, a, lower=False, alpha=1.5,
                                           beta=-1.0, c=a.copy(), device=d,
                                           **kw)),
                ("hemm", lambda d: gt.hemm(csq, ca, alpha=alpha, beta=beta,
                                           c=cc, device=d, **kw)),
                ("her2k_planar", lambda d: gt.her2k_planar(
                    *cplanes[2:], *cplanes[2:], alpha=alpha, device=d,
                    **kw)),
                ("symm_planar", lambda d: gt.symm_planar(
                    *cplanes, device=d, **kw)),
                ("hemm_planar", lambda d: gt.hemm_planar(
                    *cplanes, lower=False, device=d, **kw))):
            run(f"card vs cpu blas3 {label} {backend}", fn)
    # compare: os1 bit for bit; bf16x9 within 2 k 2^-24 |A||B|
    a, b = phi_matrix(rng, 300, 520, 0.5), phi_matrix(rng, 520, 200, 0.5)
    run("card vs cpu compare.matmul_os1_int8 300x520x200 d=8",
        lambda d: gt.compare.matmul_os1_int8(a, b, device=d))
    got = gt.compare.matmul_bf16x9(a, b).cpu().double().numpy()
    ref = gt.compare.matmul_bf16x9(a, b, device="cpu").double().numpy()
    a32, b32 = (np.abs(x.astype(np.float32)).astype(np.float64)
                for x in (a, b))
    tol = 2 * 520 * 2.0 ** -24 * (a32 @ b32)
    worst = float(np.max(np.abs(got - ref) / tol))
    check(worst <= 1.0, f"bf16x9 card vs cpu: {worst} of its tolerance")
    log(f"  ok  card vs cpu compare.matmul_bf16x9 300x520x200 within "
        f"2 k 2^-24 |A||B| (largest share of it {worst:.3e})")
    return n + 1


def lane_encode_bound(m, k, nu, itemsize):
    """Least time of one FP8 lane encode (K6c) of an (m, k) complex operand,
    in fp8_encode_bound's convention. Bytes: Re and Im read once, the shifts,
    9nu e4m3 planes written once. 32-bit operations per element: two of
    fp8_encode_bound's preambles and per-modulus reductions, the wrapped sum
    of the two residues (an add and two conditional corrections: 5), and
    three splits (FP8_SPLIT_OPS each). f64 operations: twice encode_bound's."""
    from gemmul8_tpu_torch import quantize
    nl = quantize.n_limbs(nu, "FP8")
    f64 = itemsize == 8
    ops32 = (2 * (2 + (0 if f64 else 3) + (3 if f64 else 1) * 20 + 2
                  + 4 * (nl - 1) + _moduli_ops(nu, nl - 1 + 6, 3, "FP8"))
             + 5 * nu + 3 * FP8_SPLIT_OPS * nu)
    ops64 = 20 if f64 else 0
    bytes_ = m * k * (2 * itemsize + 9 * nu) + 4 * m
    return bound(m * k * ops32, m * k * ops64, bytes_)


def reassemble_bound(m, n, nu):
    """Least time of one FP8 reassembly (K3r) storing at (m, n). Bytes: 3nu
    f32 planes read once, nu int32 planes written once. 32-bit operations per
    element: 3nu loads, nu stores, the reassembly (_fp8_reassemble_ops) and
    the residue taken from its f32 bits (1 a modulus)."""
    ops32 = 4 * nu + _fp8_reassemble_ops(nu) + nu
    return bound(m * n * ops32, 0, m * n * 16 * nu)


def complex_fp8_times(name, dt, nu, A, B, card):
    """Phase 6 for one complex FP8 path: the whole call (10 runs, median and
    quartiles), torch.matmul on the same complex operands, and each stage:
    the shifts, K6c on A and on B, the 9nu FP8 products (a lane at a time),
    K3r (one launch; three a call), K4 (or K5 and K2 on the split), with the
    kernels' plain versions (K6c on row blocks of the operands, summed) and
    bounds."""
    import gemmul8_tpu_torch as gt
    from gemmul8_tpu_torch import complex_gemm as cg, fp8, kernels
    a, b = A.to(dt), B.to(dt)
    runs = cuda_times(lambda: gt.gemm(a, b, num_moduli=nu, backend="FP8"),
                      reps=10)
    q1, q2, q3 = statistics.quantiles(runs, n=4)
    t = dict(gemm_ms=q2, gemm_ms_q1=q1, gemm_ms_q3=q3,
             library_ms=cuda_ms(lambda: torch.matmul(a, b)))
    ((ar, ai), (br, bi)), (sa, sb), (pa, pb) = complex_fp8_stages(
        nu, a, b, True)
    t["shifts_ms"] = cuda_ms(lambda: cg.shifts((ar, ai), (br, bi), nu, True,
                                               "FP8"))
    t["k6c_ms"] = cuda_ms(lambda: kernels.encode_lanes_fp8(ar, ai, sa, 0,
                                                             nu))
    t["k6c_b_ms"] = cuda_ms(lambda: kernels.encode_lanes_fp8(br, bi, sb, 1,
                                                             nu))
    t["k6c_plain_ms"] = sum(cuda_ms(lambda: kernels.encode_lanes_fp8_plain(
        ar[r0:r0 + 2048], ai[r0:r0 + 2048], sa[r0:r0 + 2048], 0, nu), reps=1)
        for r0 in range(0, FULL, 2048))

    def products():
        for lane in range(3):
            fp8.residue_matmul_fp8(pa[lane], pb[lane])
    t["products_ms"] = cuda_ms(products, reps=3)
    c3 = fp8.residue_matmul_fp8(pa[0], pb[0])
    res = cg._fp8_lane_residues(pa, pb, nu)
    del pa, pb
    torch.cuda.empty_cache()
    out = torch.empty((nu, FULL, FULL), dtype=torch.int32, device="cuda")
    t["k3r_ms"] = cuda_ms(lambda: kernels.reassemble_fp8(c3, nu, out=out))
    t["k3r_plain_ms"] = cuda_ms(lambda: kernels.reassemble_fp8_plain(c3, nu),
                                reps=1)
    del c3, out
    torch.cuda.empty_cache()
    real_dt = ar.dtype
    out_bits = 53 if real_dt == torch.float64 else 24
    if nu <= 16:
        t["k4_ms"] = cuda_ms(lambda: kernels.fused_epilogue_complex(
            res, sa, sb, nu, "FP8", dt))
        t["k4_plain_ms"] = cuda_ms(
            lambda: kernels.fused_epilogue_complex_plain(
                res, sa, sb, nu, "FP8", dt), reps=1)
        t["k4_bound"] = complex_epilogue_bound(FULL, FULL, nu, out_bits,
                                               "FP8")
    else:
        t["k5_ms"] = cuda_ms(lambda: kernels.fused_recombine_3m(res, nu,
                                                                "FP8"))
        t["k5_plain_ms"] = cuda_ms(lambda: kernels.fused_recombine_3m_plain(
            res, nu, "FP8"), reps=1)
        t["k5_bound"] = recombine_bound(FULL, FULL, nu, "FP8")
        mid_r, _ = kernels.fused_recombine_3m(res, nu, "FP8")
        del res
        t["k2_ms"] = cuda_ms(lambda: kernels.fused_epilogue(
            mid_r, sa, sb, nu, "FP8", real_dt))
        t["k2_plain_ms"] = cuda_ms(lambda: kernels.fused_epilogue_plain(
            mid_r, sa, sb, nu, "FP8", real_dt), reps=1)
        t["k2_bound"] = epilogue_bound(FULL, FULL, nu, out_bits, 4, "FP8")
        del mid_r
    t["k6c_bound"] = lane_encode_bound(FULL, FULL, nu, ar.element_size())
    t["k3r_bound"] = reassemble_bound(FULL, FULL, nu)
    flops = 8.0 * FULL ** 3
    t["emulated_tflops"] = flops / (t["gemm_ms"] * 1e-3) / 1e12
    t["library_tflops"] = flops / (t["library_ms"] * 1e-3) / 1e12
    t["products_tops"] = 9 * nu * 2.0 * FULL ** 3 / (t["products_ms"]
                                                     * 1e-3) / 1e12
    t["products_bound_ms"] = 9 * nu * 2.0 * FULL ** 3 / PEAK_INT8_OPS * 1e3
    check(t["products_tops"] * 1e12 <= PEAK_INT8_OPS,
          f"{name} FP8 products at {t['products_tops']:.0f} TOPS exceed peak")
    for k_ in ("k6c", "k3r", "k4", "k5", "k2"):
        if f"{k_}_ms" in t and f"{k_}_bound" in t:
            t[f"{k_}_share"] = t[f"{k_}_bound"][0] / t[f"{k_}_ms"]
            check(t[f"{k_}_share"] <= 1.0, f"{name} {k_} faster than bound")
    log(f"times {card} | {name} 8192^3 nu={nu}: " + ", ".join(
        f"{k_} {v:.4f}" if isinstance(v, float) else f"{k_} {v}"
        for k_, v in t.items()))
    torch.cuda.empty_cache()
    return t


# ---------------------------------------------------------------------------
# bounds
# ---------------------------------------------------------------------------

# The operation counts below are what each function needs per element, not
# what the kernels happen to issue: a modulus is a compile-time constant, so a
# reduction by it is a multiply-high, a shift, a multiply-add and a floor
# correction (4), and work that depends only on a row's or a column's shift is
# done once per row or column (negligible at 8192^2, left out).

def _moduli_ops(nu, per_modulus, per_pow2, backend="INT8"):
    """The sum over the first nu moduli of per_modulus, or per_pow2 for a
    power-of-two modulus (256; 1024 among the FP8 moduli)."""
    from gemmul8_tpu_torch import tables
    return sum(per_pow2 if p & (p - 1) == 0 else per_modulus
               for p in tables.moduli(backend)[:nu])


def encode_bound(m, k, nu, itemsize):
    """Least time of one encode of an (m, k) operand. Bytes: x read once,
    the shifts, nu int8 planes written once. 32-bit operations per element:
    two loads; for f32 the scale (3 multiplies); per f32 component 20 (sign,
    exponent and mantissa fields, the clamped bit position, limb index and
    offset by the constant 20, the mantissa's two limb parts, the fraction
    into the joint carry, two limb adds); the carry's floor (2); a balanced
    carry pass (4 per limb boundary); per modulus the limb dot (nl - 1
    multiply-adds), the reduction (4), the wrap (2) and the store (1), or for
    p = 256 a mask (3) and the store. f64 operations per element (f64 input):
    the scale (3 multiplies) and the split into three f32 components (3
    conversions down, 2 up, 2 subtractions)."""
    from gemmul8_tpu_torch import quantize
    nl = quantize.n_limbs(nu, "INT8")
    f64 = itemsize == 8
    ops32 = (2 + (0 if f64 else 3) + (3 if f64 else 1) * 20 + 2
             + 4 * (nl - 1) + _moduli_ops(nu, nl - 1 + 7, 4))
    ops64 = 10 if f64 else 0
    bytes_ = m * k * (itemsize + nu) + 4 * m
    return bound(m * k * ops32, m * k * ops64, bytes_)


def _crt_ops(nu, L, f64):
    """32-bit operations per element of one CRT pipeline from wrapped
    residues to the output value: L multiply-adds per modulus into the
    limbs; two carry passes (4 per limb boundary); the quotient from the top
    three limbs (3 conversions, 2 multiply-adds, the multiply by 1/P, rint,
    the conversion back: 8); the fold (L multiply-adds); the emit, per limb:
    f32 out, a conversion, seven multiplies and two_sum's six operations
    (14), the final add (1); f64 out, the limb's exponent, its floor split by
    3 and by 2 and three exponent assemblies (13). (f64 out also takes 5 f64
    operations per limb: a conversion, three multiplies and an add.)"""
    return nu * L + 8 * (L - 1) + 8 + L + (13 * L if f64 else 14 * L + 1)


def epilogue_bound(m, n, nu, out_bits, in_bytes=4, backend="INT8"):
    """Least time of one epilogue at (m, n). Bytes: nu planes read once
    (int32, or int8 wrapped residues with in_bytes=1), the shifts, the output
    written once. 32-bit operations per element: nu loads, two shift loads
    and the store; on int32 input, per modulus the reduction of any int32
    (4) and the wrap (2), or a 3-op mask for p = 256 (wrapped int8 input
    needs none: the wrap is the identity there); then one CRT pipeline
    (_crt_ops). backend: the moduli's plan (FP8: p = 1024 takes the mask)."""
    from gemmul8_tpu_torch import ff
    L = ff.limb_plan(nu, backend, out_bits)[1]
    f64 = out_bits == 53
    ops32 = (nu + 3 + (_moduli_ops(nu, 6, 3, backend) if in_bytes == 4 else 0)
             + _crt_ops(nu, L, f64))
    ops64 = 5 * L if f64 else 0
    bytes_ = m * n * (in_bytes * nu + (8 if f64 else 4)) + 4 * (m + n)
    return bound(m * n * ops32, m * n * ops64, bytes_)


# per modulus, the 3M recombine from three wrapped lanes: re, a subtraction
# and two conditional corrections (compare and select, 2 each); im, two
# subtractions and the same corrections
RECOMBINE_OPS = 5 + 6


def complex_epilogue_bound(m, n, nu, out_bits, backend="INT8"):
    """Least time of one complex epilogue (K4) at (m, n). Bytes: 3nu int32
    planes read once, the shifts, Re and Im written once. 32-bit operations
    per element: 3nu loads, two shift loads, two stores; per modulus three
    reductions of any int32 with their wraps (as in epilogue_bound) and the
    recombine (RECOMBINE_OPS); then two CRT pipelines (_crt_ops). f64
    operations (f64 out): 5 per limb in each pipeline. backend: the moduli's
    plan."""
    from gemmul8_tpu_torch import ff
    L = ff.limb_plan(nu, backend, out_bits)[1]
    f64 = out_bits == 53
    ops32 = (3 * nu + 4 + 3 * _moduli_ops(nu, 6, 3, backend)
             + RECOMBINE_OPS * nu
             + 2 * _crt_ops(nu, L, f64))
    ops64 = 10 * L if f64 else 0
    bytes_ = m * n * (12 * nu + 2 * (8 if f64 else 4)) + 4 * (m + n)
    return bound(m * n * ops32, m * n * ops64, bytes_)


def recombine_bound(m, n, nu, backend="INT8"):
    """Least time of one recombine (K5) at (m, n). Bytes: 3nu int32 planes
    read once, 2nu int8 planes written once (int32 on the FP8 plan). 32-bit
    operations per element: 3nu loads, 2nu stores, per modulus three
    reductions with their wraps and the recombine."""
    ops32 = 5 * nu + 3 * _moduli_ops(nu, 6, 3, backend) + RECOMBINE_OPS * nu
    out_bytes = 2 if backend == "INT8" else 8
    return bound(m * n * ops32, 0, m * n * (12 + out_bytes) * nu)


# per FP8 modulus and element, the encoder's split of the residue and its
# emission: for a square modulus a conversion, two multiplies, rint and a
# subtraction; for a Karatsuba one |r|, an add, a shift, a sign select (2),
# a shift and a subtraction, an add and three conversions to f32 (about 8
# either way); then three conversions to e4m3 and three stores
FP8_SPLIT_OPS = 8 + 3 + 3


def fp8_encode_bound(m, k, nu, itemsize):
    """Least time of one FP8 encode of an (m, k) operand, in encode_bound's
    convention. Bytes: x read once, the shifts, 3nu e4m3 planes written
    once. 32-bit operations per element: encode_bound's preamble (loads,
    scale, components, limbs, carry); per FP8 modulus the limb dot
    (nl - 1 multiply-adds), the reduction (4) and the wrap (2), or a 3-op
    mask for p = 1024, then FP8_SPLIT_OPS. f64 operations: as encode_bound."""
    from gemmul8_tpu_torch import quantize
    nl = quantize.n_limbs(nu, "FP8")
    f64 = itemsize == 8
    ops32 = (2 + (0 if f64 else 3) + (3 if f64 else 1) * 20 + 2
             + 4 * (nl - 1) + _moduli_ops(nu, nl - 1 + 6, 3, "FP8")
             + FP8_SPLIT_OPS * nu)
    ops64 = 10 if f64 else 0
    bytes_ = m * k * (itemsize + 3 * nu) + 4 * m
    return bound(m * k * ops32, m * k * ops64, bytes_)


def _fp8_reassemble_ops(nu):
    """32-bit operations per element of the FP8 epilogue's reassembly, in
    exact f32 steps (csrc/epilogue_fp8.cu): per modulus each of the three
    lane products brought near its wrap (a multiply-add, a subtraction, a
    multiply-add: 3); the recombine (square: an add and a multiply-add, 2;
    Karatsuba: a multiply and two multiply-adds, 3); the final wrap (the
    bias add, a multiply-add, a subtraction, a multiply-add: 4), or for
    p = 1024 the bias add and a 2-op mask (3). No conversion: the wrapped
    residue's f32 bits go into the limbs."""
    from gemmul8_tpu_torch import tables
    ops = 0
    for i, p in enumerate(tables.moduli("FP8")[:nu]):
        final = 3 if p & (p - 1) == 0 else 4
        ops += 9 + (2 if i < tables.NOT_KARATSUBA else 3) + final
    return ops


def fp8_epilogue_bound(m, n, nu, out_bits):
    """Least time of one FP8 epilogue (K3) at (m, n), in epilogue_bound's
    convention. Bytes: 3nu f32 planes read once, the shifts, the output
    written once. 32-bit operations per element: 3nu loads, two shift loads
    and the store; the reassembly (_fp8_reassemble_ops); one CRT pipeline
    on the FP8 plan (_crt_ops). f64 operations (f64 out): 5 per limb."""
    from gemmul8_tpu_torch import ff
    L = ff.limb_plan(nu, "FP8", out_bits)[1]
    f64 = out_bits == 53
    ops32 = 3 * nu + 3 + _fp8_reassemble_ops(nu) + _crt_ops(nu, L, f64)
    ops64 = 5 * L if f64 else 0
    bytes_ = m * n * (12 * nu + (8 if f64 else 4)) + 4 * (m + n)
    return bound(m * n * ops32, m * n * ops64, bytes_)


def product_bound(nu, m, n, k):
    """Least time of nu exact int8 products (m, k) x (k, n): 2 nu m n k
    tensor-core operations at the int8 rate, or nu (mk + kn) bytes read and
    4 nu m n written."""
    t_ops = 2.0 * nu * m * n * k / PEAK_INT8_OPS * 1e3
    t_bytes = nu * (m * k + k * n + 4 * m * n) / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def mxu_epilogue_bound(m, n, nu, out_bits):
    """Least time of one tensor-core CRT epilogue (K8) at (m, n). Bytes: nu
    int32 planes read once, the shifts, the f32 pair written once. 32-bit
    operations per element: nu loads, two shift loads, two stores; per
    modulus the wrap of any int32 (6, as in epilogue_bound: the probe's f32
    wrap gives the same integer) and the packing of its byte (2); the limbs
    from column pairs (2 per limb); the CRT pipeline after the multiply-adds
    (_crt_ops less its nu L). Tensor-core operations: the padded 16 x 32
    column product, 2 x 16 x 32 per element, at the int8 rate."""
    from gemmul8_tpu_torch import ff
    L = ff.limb_plan(nu, "INT8", out_bits)[1]
    ops32 = nu + 4 + 8 * nu + 2 * L + _crt_ops(nu, L, False) - nu * L
    t_ops, by = bound(m * n * ops32, 0, m * n * (4 * nu + 8) + 4 * (m + n))
    t_mma = m * n * 2 * 16 * 32 / PEAK_INT8_OPS * 1e3
    return (t_mma, "operations") if t_mma > t_ops else (t_ops, by)


def bound(ops32, ops64, bytes_):
    """The larger of the operations' and the bytes' least times (ms)."""
    t_ops = max(ops32 / PEAK_OPS32, ops64 / PEAK_OPS64) * 1e3
    t_bytes = bytes_ / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def fp8_times(dt, nu, a, b, card):
    """Phase 6 for one FP8 path: each stage (shifts, K6 on A and on B, the
    3nu FP8 products, K3), the plain versions of K6 and K3, the whole call
    (10 runs, median and quartiles), torch.matmul as the library yardstick,
    and the bounds."""
    import gemmul8_tpu_torch as gt
    from gemmul8_tpu_torch import fp8, kernels, quantize
    sa = quantize.shift_fast(a, nu, "FP8", 1)
    sb = quantize.shift_fast(b, nu, "FP8", 0)
    a3 = kernels.encode_planes_fp8(a, sa, 0, nu)
    b3 = kernels.encode_planes_fp8(b, sb, 1, nu)
    c3 = fp8.residue_matmul_fp8(a3, b3)
    out_bits = 53 if dt == torch.float64 else 24
    t = dict(
        shifts_ms=cuda_ms(lambda: (quantize.shift_fast(a, nu, "FP8", 1),
                                   quantize.shift_fast(b, nu, "FP8", 0))),
        k6_a_ms=cuda_ms(lambda: kernels.encode_planes_fp8(a, sa, 0, nu)),
        k6_b_ms=cuda_ms(lambda: kernels.encode_planes_fp8(b, sb, 1, nu)),
        products_ms=cuda_ms(lambda: fp8.residue_matmul_fp8(a3, b3)),
        k3_ms=cuda_ms(lambda: kernels.fused_epilogue_fp8(c3, sa, sb, nu, dt)),
        k6_plain_ms=cuda_ms(lambda: kernels.encode_planes_fp8_plain(
            a, sa, 0, nu), reps=3),
        k3_plain_ms=cuda_ms(lambda: kernels.fused_epilogue_fp8_plain(
            c3, sa, sb, nu, dt), reps=3),
    )
    del a3, b3, c3
    torch.cuda.empty_cache()
    runs = cuda_times(lambda: gt.gemm(a, b, num_moduli=nu, backend="FP8"),
                      reps=10)
    q1, q2, q3 = statistics.quantiles(runs, n=4)
    t["gemm_ms"], t["gemm_ms_q1"], t["gemm_ms_q3"] = q2, q1, q3
    t["library_ms"] = cuda_ms(lambda: torch.matmul(a, b))
    flops = 2.0 * FULL ** 3
    t["emulated_tflops"] = flops / (t["gemm_ms"] * 1e-3) / 1e12
    t["library_tflops"] = flops / (t["library_ms"] * 1e-3) / 1e12
    t["products_tops"] = 3 * nu * flops / (t["products_ms"] * 1e-3) / 1e12
    t["products_bound_ms"] = 3 * nu * flops / PEAK_INT8_OPS * 1e3
    k3_bytes = FULL * FULL * (12 * nu + a.element_size())
    t["k3_tbps"] = k3_bytes / (t["k3_ms"] * 1e-3) / 1e12
    check(t["products_tops"] * 1e12 <= PEAK_INT8_OPS,
          f"fp8 products at {t['products_tops']:.0f} TOPS exceed peak")
    check(t["k3_tbps"] * 1e12 <= PEAK_BYTES,
          f"fp8 epilogue at {t['k3_tbps']:.2f} TB/s exceeds peak")
    t["k6_bound"] = fp8_encode_bound(FULL, FULL, nu, a.element_size())
    # B (k, n): one shift per column
    t["k6_bound_b"] = fp8_encode_bound(b.shape[1], b.shape[0], nu,
                                       b.element_size())
    t["k3_bound"] = fp8_epilogue_bound(FULL, FULL, nu, out_bits)
    log(f"times {card} | FP8 {dt} 8192^3 nu={nu}: " + ", ".join(
        f"{k_} {v:.4f}" if isinstance(v, float) else f"{k_} {v}"
        for k_, v in t.items()))
    return t


def complex_times(name, dt, nu, entry, A, B, card):
    """Phase 6 for one complex path: the whole call (10 runs, median and
    quartiles), torch.matmul on the same complex operands (cuBLAS ZGEMM or
    CGEMM; for herk, A @ A^H) as the library yardstick, each stage, the
    plain versions of the path's epilogue kernels and their bounds."""
    import gemmul8_tpu_torch as gt
    from gemmul8_tpu_torch import complex_gemm as cg, core, kernels
    a = A.to(dt)
    b = B.to(dt) if entry == "gemm" else a.mH
    call = (lambda: gt.gemm(a, b, num_moduli=nu)) if entry == "gemm" else \
        (lambda: gt.herk(a, num_moduli=nu))
    runs = cuda_times(call, reps=10)
    q1, q2, q3 = statistics.quantiles(runs, n=4)
    t = dict(gemm_ms=q2, gemm_ms_q1=q1, gemm_ms_q3=q3,
             library_ms=cuda_ms(lambda: torch.matmul(a, b)))
    real_dt = a.real.dtype
    ar, ai = a.real.contiguous(), a.imag.contiguous()
    var = "invariant" if entry == "herk" else "reference"
    (sa, sb), (pa, pb), c_hi3 = complex_stages(nu, entry, a, b)
    if entry == "gemm":
        br, bi = b.real.contiguous(), b.imag.contiguous()
        t["shifts_ms"] = cuda_ms(lambda: (
            cg._shift_complex_fast(ar, ai, nu, "INT8", 1),
            cg._shift_complex_fast(br, bi, nu, "INT8", 0)))
        t["lanes_b_ms"] = cuda_ms(lambda: cg._quantize_complex(
            br, bi, sb, 1, nu, "INT8", False))
    else:
        t["shifts_ms"] = cuda_ms(lambda: cg._shift_complex_fast(
            ar, ai, nu, "INT8", 1, variant=var))
        t["lanes_b_ms"] = cuda_ms(lambda: cg._herk_rhs_lanes(pa, nu, "INT8"))
    # one encode kernel launch, and A's three lanes (two launches + the sum)
    t["encode_ms"] = cuda_ms(lambda: kernels.encode_planes(ar, sa, 0, nu,
                                                           "INT8"))
    t["lanes_a_ms"] = cuda_ms(lambda: cg._quantize_complex(
        ar, ai, sa, 0, nu, "INT8", False))
    t["products_ms"] = cuda_ms(lambda: core.residue_matmul(
        pa.reshape(3 * nu, *pa.shape[2:]), pb.reshape(3 * nu, *pb.shape[2:])))
    del pa, pb
    out_bits = 53 if real_dt == torch.float64 else 24
    if nu <= 16:
        t["k4_ms"] = cuda_ms(lambda: kernels.fused_epilogue_complex(
            c_hi3, sa, sb, nu, "INT8", dt))
        t["k4_plain_ms"] = cuda_ms(lambda: kernels.fused_epilogue_complex_plain(
            c_hi3, sa, sb, nu, "INT8", dt), reps=3)
        t["k4_bound"] = complex_epilogue_bound(FULL, FULL, nu, out_bits)
        t["k4_tbps"] = (FULL * FULL * (12 * nu + 2 * a.real.element_size())
                        / (t["k4_ms"] * 1e-3) / 1e12)
        check(t["k4_tbps"] * 1e12 <= PEAK_BYTES,
              f"{name} complex epilogue at {t['k4_tbps']:.2f} TB/s exceeds peak")
    else:
        t["k5_ms"] = cuda_ms(lambda: kernels.fused_recombine_3m(c_hi3, nu,
                                                                "INT8"))
        t["k5_plain_ms"] = cuda_ms(lambda: kernels.fused_recombine_3m_plain(
            c_hi3, nu, "INT8"), reps=3)
        t["k5_bound"] = recombine_bound(FULL, FULL, nu)
        mid_r, _ = kernels.fused_recombine_3m(c_hi3, nu, "INT8")
        del c_hi3
        t["k2_ms"] = cuda_ms(lambda: kernels.fused_epilogue(
            mid_r, sa, sb, nu, "INT8", real_dt))
        t["k2_plain_ms"] = cuda_ms(lambda: kernels.fused_epilogue_plain(
            mid_r, sa, sb, nu, "INT8", real_dt), reps=3)
        t["k2_bound"] = epilogue_bound(FULL, FULL, nu, out_bits, in_bytes=1)
    flops = 8.0 * FULL ** 3
    t["emulated_tflops"] = flops / (t["gemm_ms"] * 1e-3) / 1e12
    t["library_tflops"] = flops / (t["library_ms"] * 1e-3) / 1e12
    t["products_tops"] = 3 * nu * 2.0 * FULL ** 3 / (t["products_ms"] * 1e-3) \
        / 1e12
    check(t["products_tops"] * 1e12 <= PEAK_INT8_OPS,
          f"{name} int8 products at {t['products_tops']:.0f} TOPS exceed peak")
    log(f"times {card} | {name} 8192^3 nu={nu}: " + ", ".join(
        f"{k_} {v:.4f}" if isinstance(v, float) else f"{k_} {v}"
        for k_, v in t.items()))
    torch.cuda.empty_cache()
    return t


def probe_paths():
    """The probe tools' counterparts through their entry points
    (probes.fused.main, probes.matmul3.main, probes.epilogue.main), each with
    its launch counts set to 0 just before and read just after; every row
    must be bit-ok, the rows' launches must add up to the run's, and each
    probe function (on the wgmma kernel), each mma.sync instantiation and the
    transposing pass must have launched. Returns {probe: (rows, counts)}."""
    from gemmul8_tpu_torch.probes import epilogue, fused, matmul3
    runs = {}
    for name, main, keys in (
            ("fused", fused.main, PRODUCT_COUNTS),
            ("matmul3", matmul3.main, PRODUCT_COUNTS),
            ("epilogue", epilogue.main, ("fused_epilogue_mxu",
                                         "fused_epilogue"))):
        rows, counts = run_counted(main)
        check(all(r["ok"] for r in rows), f"probes.{name}: a row is not ok")
        check(sum(r["launches"] for r in rows) == sum(counts[k] for k in keys),
              f"probes.{name}: rows' launches {rows} vs counts {counts}")
        log(f"probe {name} launches: {counts}")
        runs[name] = rows, counts
        torch.cuda.empty_cache()
    for entry, *_ in PROBE_PRODUCTS + MMA_SYNC:
        check(probe_launches(runs, entry) > 0, f"{entry}: no launch")
    for entry, probe, _, schedule, *_ in PROBE_PRODUCTS:
        check(runs[probe][1][f"matmul_i8_wgmma_{schedule}"] > 0,
              f"{entry}: the wgmma kernel was not launched")
    check(probe_launches(runs, TRANSPOSE_KEY) > 0, "transpose_i8: no launch")
    check(probe_launches(runs, MXU_KEY) > 0, f"{MXU_KEY}: no launch")
    return runs


def probe_launches(runs, entry):
    """An entry's launches in its probe's run: the sum over its rows (the
    transposing pass: its count over both product probes)."""
    if entry == TRANSPOSE_KEY:
        return sum(runs[p][1]["transpose_i8"] for p in ("fused", "matmul3"))
    if entry == MXU_KEY:
        pairs = (("epilogue", "B mxu"),)
    elif entry in PROBE_ROWS:
        probe = next(p[1] for p in PROBE_PRODUCTS if p[0] == entry)
        pairs = ((probe, PROBE_ROWS[entry][0]),)
    else:
        pairs = next(p[3] for p in MMA_SYNC if p[0] == entry)
    return sum(r["launches"] for probe, prefix in pairs
               for r in runs[probe][0] if r["name"].startswith(prefix))


def probe_row(rows, name):
    return next(r for r in rows if r["name"] == name)


def probe_times(a64, b64, card):
    """Phase 6 for the probe kernels: the plain product and the transposing
    pass (beside its plain version, torch's copy of the transposed view) at
    the probes' size (the same planes the probe tables draw); on the DGEMM
    8192^3 nu=16 path's planes the product kernels in turns
    (probes.fused.product_rows: torch._int_mm x 16, the wgmma kernel's
    rasters, the mma.sync kernel's three instantiations); K8 (out_bits 53) on the path's C_hi and shifts against
    K2 (f64 out), and K8's plain version."""
    from gemmul8_tpu_torch import core, kernels, quantize
    from gemmul8_tpu_torch.probes.fused import product_rows, random_planes
    from gemmul8_tpu_torch.probes.timing import k_contiguous
    a, b = random_planes(PROBE_NU, PROBE_M, PROBE_M, PROBE_M, 0)
    t = dict(product_plain_ms=cuda_ms(lambda: kernels.matmul_i8_plain(a, b),
                                      reps=3),
             transpose_ms=cuda_ms(lambda: kernels.transpose_i8(b)),
             transpose_plain_ms=cuda_ms(lambda: k_contiguous(b)))
    t["transpose_bound"] = (2.0 * b.numel() / PEAK_BYTES * 1e3, "bytes")
    del a, b
    torch.cuda.empty_cache()
    nu = 16
    sa = quantize.shift_fast(a64, nu, "INT8", 1)
    sb = quantize.shift_fast(b64, nu, "INT8", 0)
    ap = kernels.encode_planes(a64, sa, 0, nu, "INT8")
    bp = kernels.encode_planes(b64, sb, 1, nu, "INT8")
    rows = {r["name"]: r for r in product_rows(ap, bp)}
    check(all(r["ok"] for r in rows.values()),
          "a product differs from torch._int_mm on the DGEMM planes")
    t["main_rows"] = rows
    t["main_int_mm_ms"] = rows["torch._int_mm x nu"]["ms"]
    for schedule in ("kloop", "astat"):
        t[f"main_wgmma_{schedule}_ms"] = rows[f"wgmma {schedule}"]["ms"]
    for entry, schedule, bk, *_ in MMA_SYNC:
        t[f"main_{entry}_ms"] = rows[f"mma.sync {schedule} bk{bk}"]["ms"]
    t["main_products_bound"] = product_bound(nu, FULL, FULL, FULL)
    c_hi = core.residue_matmul(ap, bp)
    del ap, bp
    torch.cuda.empty_cache()
    t["main_mxu_ms"] = cuda_ms(lambda: kernels.fused_epilogue_mxu(
        c_hi, sa, sb, nu, "INT8", 53))
    t["main_k2_f64_ms"] = cuda_ms(lambda: kernels.fused_epilogue(
        c_hi, sa, sb, nu, "INT8", torch.float64))
    t["mxu_plain_ms"] = cuda_ms(lambda: kernels.fused_epilogue_mxu_plain(
        c_hi, sa, sb, nu, "INT8", 53), reps=3)
    t["mxu_bound"] = mxu_epilogue_bound(FULL, FULL, nu, 53)
    t["probe_products_bound"] = product_bound(PROBE_NU, PROBE_M, PROBE_M,
                                              PROBE_M)
    del c_hi
    torch.cuda.empty_cache()
    check(max(r["tops"] for r in rows.values()) * 1e12 <= PEAK_INT8_OPS,
          "int8 products exceed the peak")
    best = min(t["main_wgmma_kloop_ms"], t["main_wgmma_astat_ms"])
    log(f"product on the DGEMM 8192^3 nu=16 planes {card}: wgmma {best:.3f} "
        f"ms, torch._int_mm x 16 {t['main_int_mm_ms']:.3f} ms, mma.sync "
        f"{min(t[f'main_{e[0]}_ms'] for e in MMA_SYNC):.3f} ms, bound "
        f"{t['main_products_bound'][0]:.3f} ms: the wgmma kernel "
        f"{'beats' if best < t['main_int_mm_ms'] else 'does not beat'} "
        "torch._int_mm")
    log(f"times {card} | probe kernels: " + ", ".join(
        f"{k_} {v:.4f}" if isinstance(v, float) else f"{k_} {v}"
        for k_, v in t.items() if k_ != "main_rows"))
    return t


def probe_entries(runs, t):
    """The kernels-line entries of the probe functions: times from their
    probe's run (the tool's own size and B layout; on the wgmma route the
    transposing pass included), with the same run's torch._int_mm x nu as
    library_ms; the products on the DGEMM path's planes and K8 on its C_hi
    beside them; the mma.sync instantiations and the transposing pass. On
    the wgmma route the two K-loop entries of matmul3 time one launch, and
    the second names the first (same_launch_as)."""
    entries = []
    common = dict(route="cuda", plain_ms=t["product_plain_ms"],
                  bound_ms=t["probe_products_bound"][0],
                  bound_by=t["probe_products_bound"][1],
                  main_path_library_ms=t["main_int_mm_ms"],
                  main_path_bound_ms=t["main_products_bound"][0],
                  main_path_shape="DGEMM 8192^3 nu=16 planes, B k-contiguous")
    for entry, probe, fn, schedule, bk, replaces in PROBE_PRODUCTS:
        rows = runs[probe][0]
        if probe == "fused":
            kc = probe_row(rows, f"{schedule if schedule == 'astat' else 'seq'}"
                           " B k-contiguous")["ms"]
            mma = (f"mma.sync seq bk{bk} B n-contiguous" if schedule == "kloop"
                   else "mma.sync astat B n-contiguous")
        else:
            kc, mma = None, "mma.sync " + PROBE_ROWS[entry][1]
        entries.append(dict(
            common, name=entry,
            source="gemmul8_tpu_torch/csrc/matmul_i8_wgmma.cu",
            replaces=replaces, launches=probe_launches(runs, entry),
            max_abs_err=MAX_ABS_ERR[entry], cases=CASES[entry],
            ms=probe_row(rows, PROBE_ROWS[entry][1])["ms"],
            ms_b_kcontig=kc, mma_sync_ms=probe_row(rows, mma)["ms"],
            library_ms=probe_row(rows, "torch._int_mm x nu")["ms"],
            path=f"probes.{probe}.main, {fn}",
            shape=f"{PROBE_NU} x ({PROBE_M}^3) int8, B n-contiguous "
                  f"(transposed into a scratch first), schedule {schedule}",
            main_path_ms=t[f"main_wgmma_{schedule}_ms"],
            **({"same_launch_as": "mm_flat[kloop]"}
               if entry == "mm_flat[kloop_multidot]" else {})))
    fused_rows = runs["fused"][0]
    for entry, schedule, bk, _, row in MMA_SYNC:
        entries.append(dict(
            common, name=entry, source="gemmul8_tpu_torch/csrc/matmul_i8.cu",
            replaces={("kloop", 64): "tools/probe_fused.py:24",
                      ("kloop", 128): "tools/probe_matmul3.py:90",
                      ("astat", 64): "tools/probe_fused.py:98"}[schedule, bk],
            launches=probe_launches(runs, entry),
            max_abs_err=MAX_ABS_ERR[entry], cases=CASES[entry],
            ms=probe_row(fused_rows, row)["ms"],
            library_ms=probe_row(fused_rows, "torch._int_mm x nu")["ms"],
            path="probes.fused.main and probes.matmul3.main, kernel=mma_sync",
            shape=f"{PROBE_NU} x ({PROBE_M}^3) int8, B n-contiguous, "
                  f"schedule {schedule} bk{bk}",
            main_path_ms=t[f"main_{entry}_ms"]))
    entries.append(dict(
        name=TRANSPOSE_KEY, route="cuda",
        source="gemmul8_tpu_torch/csrc/matmul_i8_wgmma.cu",
        replaces="tools/probe_fused.py:24",
        launches=probe_launches(runs, TRANSPOSE_KEY),
        max_abs_err=MAX_ABS_ERR[TRANSPOSE_KEY], cases=CASES[TRANSPOSE_KEY],
        ms=t["transpose_ms"], plain_ms=t["transpose_plain_ms"],
        bound_ms=t["transpose_bound"][0], bound_by=t["transpose_bound"][1],
        library_ms=t["transpose_plain_ms"],
        path="probes.fused.main and probes.matmul3.main, n-contiguous B on "
             "the wgmma route",
        shape=f"{PROBE_NU} x {PROBE_M} x {PROBE_M} int8 (nu, k, n) -> "
              "(nu, n, k)"))
    rows = runs["epilogue"][0]
    entries.append(dict(
        name=MXU_KEY, route="cuda",
        source="gemmul8_tpu_torch/csrc/epilogue_mxu.cu",
        replaces="tools/probe_epilogue.py:103",
        launches=probe_launches(runs, MXU_KEY),
        max_abs_err=MAX_ABS_ERR[MXU_KEY], cases=CASES[MXU_KEY],
        ms=probe_row(rows, "B mxu out_bits 53")["ms"],
        plain_ms=t["mxu_plain_ms"], bound_ms=t["mxu_bound"][0],
        bound_by=t["mxu_bound"][1], library_ms=None,
        k2_f32_ms=probe_row(rows, "A K2 f32")["ms"],
        k2_f64_ms=probe_row(rows, "A K2 f64")["ms"],
        path="probes.epilogue.main, fused_epilogue_mxu",
        shape="C_hi 16x8192x8192 int32, zero shifts -> (hi, lo) f32",
        main_path_ms=t["main_mxu_ms"], main_path_k2_f64_ms=t["main_k2_f64_ms"],
        main_path_shape="DGEMM 8192^3 nu=16 C_hi and shifts"))
    return entries


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def complex_fp8_entries(cftiming):
    """The kernels line's entries of the complex FP8 kernels: K6c and K4 on
    the ZGEMM nu=14 and CGEMM nu=7 paths, K3r on ZGEMM nu=14, K5 and K2 on
    the nu=18 split; launches are each path's own call's (and, under
    path_launches, every complex FP8 path's of that dtype that runs the
    kernel)."""
    from gemmul8_tpu_torch import kernels
    entries = []

    def entry(name, key, count, source, replaces, path, t, stage, shape,
              **extra):
        _, dt, nu, _, _ = next(p for p in CFP8_PATHS if p[0] == path)
        return dict(
            name=name, route="cuda", source=f"gemmul8_tpu_torch/csrc/{source}",
            replaces=replaces, launches=CFP8_RUNS[path][count],
            max_abs_err=MAX_ABS_ERR[key], cases=CASES[key],
            ms=t[f"{stage}_ms"], plain_ms=t[f"{stage}_plain_ms"],
            bound_ms=t[f"{stage}_bound"][0], bound_by=t[f"{stage}_bound"][1],
            library_ms=None, path=f"gemm {TAG[dt]} 8192^3 nu={nu} backend=FP8",
            shape=shape, path_launches={
                p[0]: CFP8_RUNS[p[0]][count] for p in CFP8_PATHS
                if p[1] == dt and CFP8_RUNS[p[0]][count]},
            **extra)

    for path, dt in (("zgemm_fp8_14", torch.complex128),
                     ("cgemm_fp8_7", torch.complex64)):
        t, tag = cftiming[path], TAG[dt]
        nu = next(p[2] for p in CFP8_PATHS if p[0] == path)
        real_dt = kernels.REAL_DTYPE[dt]
        entries += [
            entry(f"encode_lanes_fp8[{tag}]", LANES_KEY[real_dt],
                  "encode_lanes_fp8", "encode_lanes_fp8.cu",
                  "gemmul8_tpu/complex_gemm.py:53 (jnp; no Pallas kernel)",
                  path, t, "k6c", f"Re, Im 8192x8192 {TAG[real_dt]} -> 3 x "
                  f"{3 * nu}x8192x8192 e4m3", ms_b=t["k6c_b_ms"]),
            entry(K4_FP8_KEY[dt], K4_FP8_KEY[dt], "fused_epilogue_complex",
                  "complex.cu", "gemmul8_tpu/pallas_kernels.py:595", path, t,
                  "k4", f"{3 * nu}x8192x8192 int32 residues -> {tag}"),
        ]
    t = cftiming["zgemm_fp8_14"]
    entries.append(entry(
        "reassemble_fp8[c128 nu=14]", REASSEMBLE_KEY, "reassemble_fp8",
        "reassemble_fp8.cu", "gemmul8_tpu/fp8.py:128 (jnp; no Pallas kernel)",
        "zgemm_fp8_14", t, "k3r", "42x8192x8192 f32 -> 14x8192x8192 int32"))
    t = cftiming["zgemm_fp8_18"]
    entries += [
        entry(K5_FP8_KEY, K5_FP8_KEY, "fused_recombine_3m", "complex.cu",
              "gemmul8_tpu/pallas_kernels.py:655", "zgemm_fp8_18", t, "k5",
              "54x8192x8192 int32 -> 2 x 18x8192x8192 int32"),
        entry(K2_FP8_SPLIT_KEY, K2_FP8_SPLIT_KEY, "fused_epilogue",
              "epilogue.cu", "gemmul8_tpu/pallas_kernels.py:399",
              "zgemm_fp8_18", t, "k2", "18x8192x8192 int32 -> f64"),
    ]
    return entries


# ---------------------------------------------------------------------------
# the dense solvers, QR and the Jacobi eigensolvers (gemmul8_tpu_torch
# .solvers, .qr, .eig) over the ported GEMM: phase 4 at full size (launches
# against the block loops, accuracy beside cuSOLVER, K1, K2 and K4 at the
# paths' own products), phase 5 against the CPU path, phase 6 times
# ---------------------------------------------------------------------------

SOLVER_NU = 14        # benchmarks/solver_flops.py's default
SOLVE_NU = 6          # solve: a cheap factorization, then 2 refinement steps
# eigh and svd at 2048^2: at 4096^2 one eigh took 60.5 s (12 sweeps of 31
# rounds), too long for its repeats in this run's time
EIG_N = FULL // 4
COMPLEX_N = FULL // 2  # the complex solve and qr at 4096^2
SOLVER_KEYS = ("encode_planes", "_int_mm", "fused_epilogue",
               "fused_epilogue_complex")
# the JAX tests' bounds: reconstruction (tests/test_solvers.py:148-161),
# residuals (:162-178), eigenvalues and singular values relative to ||A||
# (tests/test_eig.py:75-86), the Jacobi vectors (tests/test_eig.py:23-33),
# lstsq against the native solution (tests/test_qr.py:87-97)
JAX_BOUND = {"reconstruction": 1e-12, "orthogonality": 1e-12,
             "residual": 1e-11, "values": 1e-12, "jacobi vectors": 1e-11,
             "against native": 1e-11}
SOLVER_RUNS: dict = {}      # call -> (dtype tag, launch counts)
SOLVER_CALLS: dict = {}     # call -> (fn, outputs, phase-4 seconds)
SOLVER_ACCURACY: list = []  # (call, metric, ours, cuSOLVER's, bound, rule)
SOLVER_SWEEPS: dict = {}    # Jacobi call -> sweeps


def solver_modules():
    from gemmul8_tpu_torch import eig, solvers
    return solvers, importlib.import_module("gemmul8_tpu_torch.qr"), eig


@contextlib.contextmanager
def patched(targets):
    """Each (module, name, make) sets module.name = make(module.name) for
    the block."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in targets]
    for mod, name, make in targets:
        setattr(mod, name, make(getattr(mod, name)))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def product_log(calls):
    """Patch targets that log each emulated product the solver layers make
    as (kind, num_moduli, complex, products): gemm, syrk, herk, and each
    element of a gemm_batched."""
    solvers, qr, eig = solver_modules()

    def logged(kind):
        def make(fn):
            def call(*args, **kw):
                x = args[0]
                calls.append((kind, kw["num_moduli"], x.is_complex(),
                              x.shape[0] if kind == "batched" else 1))
                return fn(*args, **kw)
            return call
        return make
    return [(solvers, "gemm", logged("gemm")), (qr, "gemm", logged("gemm")),
            (qr, "syrk", logged("syrk")), (qr, "herk", logged("herk")),
            (eig, "gemm_batched", logged("batched"))]


def product_launches(calls):
    """The launches the logged products imply: a real INT8 product 2 K1 +
    nu _int_mm + 1 K2 (syrk: 1 K1); a complex one (nu <= 16) 4 K1 + 3nu
    _int_mm + 1 K4 (herk: 2 K1); a batch's per element."""
    want = dict.fromkeys(SOLVER_KEYS, 0)
    for kind, nu, cplx, count in calls:
        one_side = kind in ("syrk", "herk")
        if cplx:
            check(nu <= 16, f"complex nu={nu} takes the K5 split")
            want["encode_planes"] += count * (2 if one_side else 4)
            want["_int_mm"] += count * 3 * nu
            want["fused_epilogue_complex"] += count
        else:
            want["encode_planes"] += count * (1 if one_side else 2)
            want["_int_mm"] += count * nu
            want["fused_epilogue"] += count
    return want


def solver_counted(name, tag, fn, want_products, extra=()):
    """fn() through run_counted (every launch count 0 just before, read just
    after) with its emulated products logged. The products must be those
    the block loop implies (want_products: {(kind, nu): count}, or a
    function of nothing giving it after the run), and the launches those
    the products imply, K1, the products and the epilogue each non-zero.
    Records the run for the kernels line and the repeats."""
    calls = []
    t0 = time.perf_counter()
    with patched(product_log(calls) + list(extra)):
        out, counts = run_counted(fn)
    seconds = time.perf_counter() - t0
    got = {}
    for kind, nu, _, count in calls:
        got[(kind, nu)] = got.get((kind, nu), 0) + count
    want = want_products() if callable(want_products) else want_products
    check(got == want, f"{name}: emulated products {got}, the block loop "
          f"implies {want}")
    launches = {k: counts.get(k, 0) for k in SOLVER_KEYS}
    check(launches == product_launches(calls),
          f"{name} launches {launches}, its products imply "
          f"{product_launches(calls)}")
    check(launches["encode_planes"] > 0 and launches["_int_mm"] > 0
          and launches["fused_epilogue"] + launches[
              "fused_epilogue_complex"] > 0, f"{name}: a kernel not launched")
    SOLVER_RUNS[name] = (tag, counts)
    SOLVER_CALLS[name] = (fn, out if isinstance(out, tuple) else (out,),
                          seconds)
    log(f"solver {name}: {seconds:.3f}s, products "
        f"{ {f'{k}[nu={nu}]': c for (k, nu), c in got.items()} }, launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    return out


def held(name, metric, ours, native, bound_key):
    """ours within 4x cuSOLVER's value of the same metric, or under the JAX
    tests' bound for it, whichever is looser; records which rule held."""
    bound = JAX_BOUND[bound_key]
    limit = bound if native is None else max(4 * native, bound)
    check(ours <= limit, f"{name}: {metric} {ours!r} above {limit!r} "
          f"(cuSOLVER {native!r}, JAX bound {bound!r})")
    rule = ("4x cuSOLVER" if native is not None and ours <= 4 * native
            else "JAX bound")
    SOLVER_ACCURACY.append((name, metric, ours, native, bound, rule))
    log(f"accuracy {name}: {metric} {ours!r}, cuSOLVER {native!r}, JAX "
        f"bound {bound!r}: passes by {rule}")


def inf_norm(x):
    """The infinity norm (max row sum of |x|; max |x| of a vector)."""
    return float(x.abs().sum(dim=-1).max()) if x.dim() == 2 else float(
        x.abs().max())


def backward_residual(a, x, b):
    """||a x - b|| / (||a|| ||x||), infinity norms, f64 on the card."""
    return inf_norm(a @ x - b) / (inf_norm(a) * inf_norm(x))


def max_rel(x, scale):
    return float(x.abs().max()) / float(scale)


def perm_of(lu_piv):
    """torch.linalg.lu_factor's pivots as an absolute row order."""
    from gemmul8_tpu_torch import solvers
    perm = solvers._pivots_to_perm(lu_piv.cpu().numpy() - 1, lu_piv.shape[0])
    return torch.from_numpy(perm).to(lu_piv.device)


def lu_error(a, lu, perm):
    """max |PA - LU| / max |A|."""
    n = a.shape[0]
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    el = torch.tril(lu, -1) + eye
    return max_rel(a[perm.long()] - el @ torch.triu(lu), a.abs().max())


def qr_errors(a, q, r):
    """(max |A - QR| / max |A|, max |Q^H Q - I|)."""
    eye = torch.eye(q.shape[1], dtype=q.dtype, device=q.device)
    return (max_rel(a - q @ r, a.abs().max()),
            float((q.mH @ q - eye).abs().max()))


def solver_operands():
    """The phase-4 operands, made on the card from SEED + 17 (real) and
    SEED + 18 (complex): A ~ N(0, 1) 8192^2, A + n I (solve), the SPD
    X X^T / n + I and its Cholesky factor (trsm, trmm), 8192 right-hand
    sides, a vector, a 16384 x 8192 least-squares problem, a symmetric and
    a general 2048^2 (eigh, svd), and a c128 4096^2 Z (qr) with Z + n I
    (solve)."""
    f64, dev = torch.float64, "cuda"
    g = torch.Generator(device=dev).manual_seed(SEED + 17)
    n = FULL

    def randn(*shape, dtype=f64, gen=g):
        return torch.randn(shape, dtype=dtype, device=dev, generator=gen)
    x = dict(a=randn(n, n))
    eye = torch.eye(n, dtype=f64, device=dev)
    x["ad"] = x["a"] + n * eye
    w = randn(n, n)
    spd = w @ w.T / n + eye
    x["spd"] = (spd + spd.T) / 2
    del w, spd
    x["tri"] = torch.linalg.cholesky(x["spd"])
    x["b"] = randn(n, n)
    x["vec"] = randn(n)
    x["tall"] = randn(2 * n, n)
    x["tall_b"] = randn(2 * n)
    r = randn(EIG_N, EIG_N)
    x["sym"] = (r + r.T) / 2
    x["gen"] = randn(EIG_N, EIG_N)
    gz = torch.Generator(device=dev).manual_seed(SEED + 18)
    x["z"] = randn(COMPLEX_N, COMPLEX_N, dtype=torch.complex128, gen=gz)
    x["zd"] = x["z"] + COMPLEX_N * torch.eye(
        COMPLEX_N, dtype=torch.complex128, device=dev)
    x["zvec"] = randn(COMPLEX_N, dtype=torch.complex128, gen=gz)
    del r, eye
    torch.cuda.empty_cache()
    return x


def capturing(store, key=lambda args: "first"):
    """A patch maker (see `patched`): the wrapped function keeps, for the
    first call of each key(args) (None: keep none), clones of its tensor
    arguments, its keywords and a clone of its output in store[key]."""
    def clone(x):
        return x.clone() if isinstance(x, torch.Tensor) else x

    def make(fn):
        def call(*args, **kw):
            k = key(args)
            kept = None if k is None or k in store else tuple(
                clone(x) for x in args)
            out = fn(*args, **kw)
            if kept is not None:
                store[k] = (kept, kw, clone(out))
            return out
        return call
    return make


def hold_product(what, a, b, nu, fastmode):
    """One emulated product of a solver path, a @ b (b=None: syrk's
    a @ a^T), replayed as the card runs it (operands zero-padded to
    multiples of 128, the path's shifts): K1 on each side (on complex, the
    Re and Im lanes) and K2, or K4 on complex, on the path's own int32
    products, each bit for bit against its plain version; the replay's
    output bit-equal to the product function the path calls. Returns it."""
    from gemmul8_tpu_torch import complex_gemm as cg, core, kernels
    m, n = a.shape[0], (a.shape[0] if b is None else b.shape[1])
    ap = core._pad128(a, (0, 1)).contiguous()
    bp = None if b is None else core._pad128(b, (0, 1)).contiguous()
    if a.is_complex():
        (sa, sb), (pa, pb), c_hi = complex_stages(nu, "gemm", ap, bp,
                                                  fastmode)
        for planes, x, s, axis in ((pa, ap, sa, 0), (pb, bp, sb, 1)):
            for lane, part in enumerate((x.real, x.imag)):
                compare(f"encode_planes[{TAG[part.dtype]}]", planes[lane],
                        kernels.encode_planes_plain(part.contiguous(), s,
                                                    axis, nu, "INT8"),
                        f"encode at {what} axis={axis} lane={lane}")
        del pa, pb
        key, epi, plain = ("fused_epilogue_complex[c128]",
                           kernels.fused_epilogue_complex,
                           kernels.fused_epilogue_complex_plain)
        ref = cg.emulate_matmul_complex(a, b, num_moduli=nu,
                                        fastmode=fastmode)
    else:
        sa, sb = core.shifts(ap, bp, nu, fastmode, "INT8")
        planes = []
        for x, s, axis in [(ap, sa, 0)] + ([] if b is None else
                                           [(bp, sb, 1)]):
            got = kernels.encode_planes(x, s, axis, nu, "INT8")
            compare("encode_planes[f64]", got,
                    kernels.encode_planes_plain(x, s, axis, nu, "INT8"),
                    f"encode at {what} axis={axis}")
            planes.append(got)
        if b is None:            # syrk: the rhs planes are a transposed view
            planes.append(planes[0].transpose(-1, -2))
        c_hi = core.residue_matmul(*planes)
        del planes
        key, epi, plain = ("fused_epilogue[f64]", kernels.fused_epilogue,
                           kernels.fused_epilogue_plain)
        ref = (core.syrk(a, num_moduli=nu, fastmode=fastmode,
                         device=a.device) if b is None
               else core.emulate_matmul(a, b, num_moduli=nu,
                                        fastmode=fastmode))
    ab = epi(c_hi, sa, sb, nu, "INT8", a.dtype)
    compare_rows(key, ab, lambda r0, r1: plain(
        c_hi[:, r0:r1].contiguous(), sa[r0:r1], sb, nu, "INT8", a.dtype),
        f"epilogue at {what}")
    shape = tuple(c_hi.shape)
    del c_hi
    ab = ab[:m, :n]
    assert_bits_equal(ab, ref, f"{what}: the replay vs the path's product")
    log(f"K1, {key.split('[')[0]} bit-equal to their plain versions at "
        f"{what}: A {tuple(a.shape)}, int32 products {shape}")
    torch.cuda.empty_cache()
    return ab


def solver_kernel_cases(caps, nu):
    """The kernels at the solver paths' own inputs, each against its plain
    version bit for bit (hold_product), and each replay tied to the
    output the path made: getrf's first trailing update (L21 7680 x 512,
    U12 512 x 7680: K1, K2, then gemm's alpha=-1, beta=1 epilogue); the
    complex solve's first Schur update (3584 x 512 x 3584) and its first
    one-column substitution update (512 x 512 x 1): K1 on the Re and Im
    lanes, K4, and the complex alpha/beta epilogue; geqrf's first Gram
    V^T V (syrk on 8192 x 512); and element 0 of eigh's first
    gemm_batched (2048 x 256 x 256)."""
    from gemmul8_tpu_torch import complex_gemm as cg
    for name, what in (("getrf", "getrf's first trailing update"),
                       ("zsolve", "the complex solve's first Schur update"),
                       ("zsolve rhs", "the complex solve's first one-column "
                                      "update")):
        (a, b, c), kw, out = caps[name]
        ab = hold_product(what, a, b, nu, kw["fastmode"])
        if c.is_complex():
            want = c + cg._cmul(cg._scalar(-1 + 0j, c.dtype, ab), ab)
        else:
            want = torch.addcmul(c, torch.tensor(-1.0, dtype=c.dtype,
                                                 device=c.device), ab)
        assert_bits_equal(out, want, f"{what} vs the replay + gemm's "
                          f"alpha=-1, beta=1 epilogue")
    (v,), kw, out = caps["geqrf"]
    check(kw["trans"], "geqrf's Gram is V^T V")
    assert_bits_equal(out, hold_product("geqrf's first Gram V^T V", v.T,
                                        None, nu, kw["fastmode"]),
                      "geqrf's first Gram vs the replay")
    (x, j), kw, out = caps["eigh"]
    assert_bits_equal(out[0], hold_product(
        "element 0 of eigh's first gemm_batched", x[0], j[0],
        kw["num_moduli"], kw["fastmode"]),
        "eigh's first gemm_batched element 0 vs the replay")


def solver_paths(x):
    """Phase 4: each call at full size through solver_counted, then its
    contract beside the native cuSOLVER/cuBLAS f64 routine's on the same
    matrix; then the kernels at the products captured on the way
    (solver_kernel_cases). Returns those captures."""
    import gemmul8_tpu_torch as gt
    solvers, qr, eig = solver_modules()
    nu, n, p = SOLVER_NU, FULL, FULL // 512      # 16 blocks of 512
    kw = dict(num_moduli=nu)
    gemms = lambda k, nu_=nu: {("gemm", nu_): k}             # noqa: E731
    eye = torch.eye(n, dtype=torch.float64, device="cuda")

    # getrf: one Schur update per panel but the last, the U12 solves within
    # one diagonal block (no update); the first update captured, as are the
    # first products of the complex solve, geqrf and eigh below, for
    # solver_kernel_cases
    caps = {}
    a = x["a"]
    lu, perm = solver_counted(
        "getrf", "f64", lambda: gt.getrf(a, **kw), gemms(p - 1),
        [(solvers, "_schur_update", capturing(caps, lambda _: "getrf"))])
    lu_n, piv_n, _ = torch.linalg.lu_factor_ex(a)
    native = lu_error(a, lu_n, perm_of(piv_n))
    del lu_n, piv_n
    # at nu=14 the robust shifts leave about 48 bits an operand, and the
    # reconstruction error grows with n (a CPU run of the port: 3.0e-13 at
    # 2048, 6.0e-13 at 4096, 1.36e-12 at 8192, ten times LAPACK's): above
    # both the 96^2 test's 1e-12 and 4x cuSOLVER's at 8192. So nu=14's is
    # reported, and the contract held at choose_moduli's f64 setting
    SOLVER_ACCURACY.append(("getrf", "max|PA - LU|/max|A| (reported)",
                            lu_error(a, lu, perm), native, None,
                            "none: nu=14; held at the f64 setting"))
    log(f"accuracy getrf nu={nu}: max|PA - LU|/max|A| "
        f"{SOLVER_ACCURACY[-1][2]!r}, cuSOLVER {native!r}: reported")
    del lu, perm
    f64_nu = gt.choose_moduli(dtype=torch.float64).num_moduli
    lu, perm = solver_counted(
        f"getrf nu={f64_nu}", "f64",
        lambda: gt.getrf(a, num_moduli=f64_nu), gemms(p - 1, f64_nu))
    held(f"getrf nu={f64_nu}", "max|PA - LU|/max|A|", lu_error(a, lu, perm),
         native, "reconstruction")
    del lu, perm

    # solve at nu=6, refined twice at choose_moduli's nu=17: getrf, two
    # triangular solves, and per step a residual and two more solves
    ad, vec = x["ad"], x["vec"]
    res_nu = gt.choose_moduli(dtype=torch.float64).num_moduli
    out = solver_counted(
        "solve", "f64", lambda: gt.solve(ad, vec, num_moduli=SOLVE_NU,
                                         refine_steps=2),
        {("gemm", SOLVE_NU): 7 * (p - 1), ("gemm", res_nu): 2})
    held("solve", "||Ax - b||/(||A|| ||x||)", backward_residual(ad, out, vec),
         backward_residual(ad, torch.linalg.solve(ad, vec), vec), "residual")

    spd, tri, b = x["spd"], x["tri"], x["b"]
    chol = solver_counted("potrf", "f64", lambda: gt.potrf(spd, **kw),
                          gemms(p - 1))
    held("potrf", "max|A - LL^T|/max|A|",
         max_rel(spd - chol @ chol.T, spd.abs().max()),
         max_rel(spd - tri @ tri.T, spd.abs().max()), "reconstruction")
    del chol
    out = solver_counted("posv", "f64", lambda: gt.posv(spd, vec, **kw),
                         gemms(3 * (p - 1)))
    held("posv", "||Ax - b||/(||A|| ||x||)", backward_residual(spd, out, vec),
         backward_residual(spd, torch.cholesky_solve(vec[:, None], tri)[:, 0],
                           vec), "residual")
    out = solver_counted("inv", "f64", lambda: gt.inv(a, **kw),
                         gemms(3 * (p - 1)))
    held("inv", "||AX - I||/(||A|| ||X||)", backward_residual(a, out, eye),
         backward_residual(a, torch.linalg.inv(a), eye), "residual")
    del out
    out = solver_counted("trsm", "f64", lambda: gt.trsm(tri, b, **kw),
                         gemms(p - 1))
    held("trsm", "||TX - B||/(||T|| ||X||)", backward_residual(tri, out, b),
         backward_residual(tri, torch.linalg.solve_triangular(
             tri, b, upper=False), b), "residual")
    out = solver_counted("trmm", "f64", lambda: gt.trmm(tri, b, **kw),
                         gemms(p - 1))
    # the last 8 rows (a lower triangle's full rows) against a longdouble
    # oracle
    rows = slice(n - 8, n)
    ref = _ld_matmul(tri[rows].cpu().numpy(), b.cpu().numpy())
    scale = np.max(np.abs(ref))
    held("trmm", "max|TB - oracle|/max|TB|, last 8 rows",
         float(np.max(np.abs(out[rows].cpu().numpy() - ref)) / scale),
         float(np.max(np.abs((tri[rows] @ b).cpu().numpy() - ref)) / scale),
         "reconstruction")
    del out, ref

    # geqrf: per block but the last, a Gram syrk and two update gemms; qr
    # adds ormqr on I: two gemms a block, one syrk for the last block's T
    syrks = lambda k: {("syrk", nu): k}                     # noqa: E731
    packed, taus = solver_counted(
        "geqrf", "f64", lambda: gt.geqrf(a, **kw),
        {**syrks(p - 1), **gemms(2 * (p - 1))},
        [(qr, "syrk", capturing(caps, lambda _: "geqrf"))])
    packed_n, taus_n = torch.geqrf(a)
    for (what, ours, nat) in zip(
            ("max|A - QR|/max|A|", "max|Q^T Q - I|"),
            qr_errors(a, torch.linalg.householder_product(packed, taus),
                      torch.triu(packed)),
            qr_errors(a, torch.linalg.householder_product(packed_n, taus_n),
                      torch.triu(packed_n))):
        held("geqrf", what, ours, nat, "reconstruction"
             if "QR" in what else "orthogonality")
    del packed, taus, packed_n, taus_n
    q, r = solver_counted("qr", "f64", lambda: gt.qr(a, **kw),
                          {**syrks(p), **gemms(2 * (p - 1) + 2 * p)})
    for what, ours, nat in zip(
            ("max|A - QR|/max|A|", "max|Q^T Q - I|"), qr_errors(a, q, r),
            qr_errors(a, *torch.linalg.qr(a))):
        held("qr", what, ours, nat, "reconstruction"
             if "QR" in what else "orthogonality")
    del q, r
    tall, tall_b = x["tall"], x["tall_b"]
    out = solver_counted("lstsq", "f64", lambda: gt.lstsq(tall, tall_b, **kw),
                         {**syrks(p), **gemms(2 * (p - 1) + 2 * p + p - 1)})
    nat = torch.linalg.lstsq(tall, tall_b[:, None]).solution[:, 0]

    def normal_residual(xs):
        """||A^T (b - Ax)|| / (||A^T|| ||A|| ||x||), infinity norms."""
        return inf_norm(tall.T @ (tall_b - tall @ xs)) / (
            inf_norm(tall.T) * inf_norm(tall) * inf_norm(xs))
    held("lstsq", "||A^T(b - Ax)||/(||A^T|| ||A|| ||x||)",
         normal_residual(out), normal_residual(nat), "residual")
    held("lstsq", "max|x - x_native|/max|x_native|",
         max_rel(out - nat, nat.abs().max()), None, "against native")
    torch.cuda.empty_cache()

    # eigh and svd: per round one native batched eigh and three batched
    # products of one element per pair; sweeps end where the iteration says
    for name, mat in (("eigh", x["sym"]), ("svd", x["gen"])):
        rounds = []
        count_rounds = (eig, "_eigh_small", lambda fn: lambda g: (
            rounds.append(g.shape[0]), fn(g))[1])
        keep = [(eig, "gemm_batched", capturing(caps, lambda _: "eigh"))]
        out = solver_counted(
            name, "f64", lambda name=name, mat=mat: getattr(gt, name)(mat),
            lambda: {("batched", 14): 3 * sum(rounds)},
            [count_rounds] + (keep if name == "eigh" else []))
        per_sweep = len(eig._round_robin(EIG_N // eig._pick_block(
            EIG_N, None)))
        check(len(rounds) % per_sweep == 0 and rounds,
              f"{name}: {len(rounds)} rounds, not whole sweeps of "
              f"{per_sweep}")
        SOLVER_SWEEPS[name] = len(rounds) // per_sweep
        log(f"solver {name}: {SOLVER_SWEEPS[name]} sweeps of {per_sweep} "
            f"rounds, {rounds[0]} pairs a round")
        if name == "eigh":
            w, v = out
            w_n, v_n = torch.linalg.eigh(mat)
            scale = w_n.abs().max()
            ident = torch.eye(EIG_N, dtype=torch.float64, device="cuda")
            held("eigh", "max|w - w_native|/max|w|",
                 max_rel(w - w_n, scale), None, "values")
            held("eigh", "max|AV - VW|/max|w|",
                 max_rel(mat @ v - v * w, scale),
                 max_rel(mat @ v_n - v_n * w_n, scale), "values")
            held("eigh", "max|V^T V - I|", float((v.T @ v - ident).abs().max()),
                 float((v_n.T @ v_n - ident).abs().max()), "orthogonality")
            del w_n, v_n
        else:
            u, s, vt = out
            ident = torch.eye(EIG_N, dtype=torch.float64, device="cuda")
            s_n = torch.linalg.svdvals(mat)
            u_n, _, vt_n = torch.linalg.svd(mat, full_matrices=False)
            held("svd", "max|s - svdvals|/max s", max_rel(s - s_n, s_n[0]),
                 None, "values")
            held("svd", "max|A - U S V^T|/max|A|",
                 max_rel(mat - (u * s) @ vt, mat.abs().max()),
                 max_rel(mat - (u_n * s_n) @ vt_n, mat.abs().max()),
                 "jacobi vectors")
            held("svd", "max|V V^T - I|",
                 float((vt @ vt.T - ident).abs().max()),
                 float((vt_n @ vt_n.T - ident).abs().max()),
                 "jacobi vectors")
            # U = W / sigma column by column: its orthogonality degrades
            # with sigma_max / sigma_min (the JAX package's algorithm, the
            # same bits); reported, held by no bound (ROADMAP section 3)
            SOLVER_ACCURACY.append((
                "svd", "max|U^T U - I| (reported)",
                float((u.T @ u - ident).abs().max()),
                float((u_n.T @ u_n - ident).abs().max()), None,
                f"none: sigma_max/sigma_min {float(s_n[0] / s_n[-1]):.4g}"))
            log(f"accuracy svd: max|U^T U - I| "
                f"{SOLVER_ACCURACY[-1][2]!r}, cuSOLVER "
                f"{SOLVER_ACCURACY[-1][3]!r}, "
                f"{SOLVER_ACCURACY[-1][5]}")
            del u_n, vt_n
        torch.cuda.empty_cache()

    # complex: solve (getrf + two solves) and qr (herk in the Gram), 4096^2
    pz = COMPLEX_N // 512
    z, zd, zvec = x["z"], x["zd"], x["zvec"]
    out = solver_counted(
        "zsolve", "c128", lambda: gt.solve(zd, zvec, **kw),
        gemms(3 * (pz - 1)),
        [(solvers, "_schur_update", capturing(caps, lambda args: (
            "zsolve rhs" if args[1].shape[-1] == 1 else "zsolve")))])
    held("zsolve", "||Ax - b||/(||A|| ||x||)",
         backward_residual(zd, out, zvec),
         backward_residual(zd, torch.linalg.solve(zd, zvec), zvec),
         "residual")
    q, r = solver_counted("zqr", "c128", lambda: gt.qr(z, **kw),
                          {("herk", nu): pz,
                           **gemms(2 * (pz - 1) + 2 * pz)})
    for what, ours, nat in zip(
            ("max|A - QR|/max|A|", "max|Q^H Q - I|"), qr_errors(z, q, r),
            qr_errors(z, *torch.linalg.qr(z))):
        held("zqr", what, ours, nat, "reconstruction"
             if "QR" in what else "orthogonality")
    del q, r
    torch.cuda.empty_cache()
    solver_kernel_cases(caps, nu)
    return caps


def _normalize_qr(q, r):
    """Q D and D^H R with D = the phases of diag(R): the QR free of the
    Householder sign choice."""
    d = torch.diagonal(r)
    d = d / d.abs() if d.is_complex() else torch.sign(d)
    return q * d, d.conj()[:, None] * r


def solver_card_vs_cpu(rng, caps):
    """Phase 5: (a) each function at 300 x 300 (block 64, nu=14, f64, and
    complex solve and qr) on the card within a stated tolerance of
    device="cpu": cuSOLVER and LAPACK differ in their last bits, so the
    results cannot be bit-equal; (b) the emulated stage alone,
    _schur_update on getrf's captured first-update operands cut to 300^2,
    card against CPU bit for bit. The CPU side resolves "auto" to the
    card's "ff" epilogue."""
    import gemmul8_tpu_torch as gt
    solvers = solver_modules()[0]
    n, kw = 300, dict(num_moduli=14, block=64)
    a = rng.standard_normal((n, n))
    w = rng.standard_normal((n, n))
    spd = w @ w.T / n + np.eye(n)
    tri = np.linalg.cholesky(spd)
    b, vec = rng.standard_normal((n, 40)), rng.standard_normal(n)
    tall, tall_b = rng.standard_normal((2 * n, n)), rng.standard_normal(2 * n)
    r = rng.standard_normal((n, n))
    sym, gen = (r + r.T) / 2, rng.standard_normal((n, 200))
    z = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    zvec = rng.standard_normal(n) + 1j * rng.standard_normal(n)

    def lu_pair(dev):
        return gt.getrf(a, device=dev, **kw)

    def geqrf_qr(dev):
        packed, taus = gt.geqrf(a, device=dev, **kw)
        return _normalize_qr(torch.linalg.householder_product(packed, taus),
                             torch.triu(packed))

    def ormqr_q(dev):
        packed, taus = gt.geqrf(a, device=dev, **kw)
        return _normalize_qr(gt.ormqr(packed, taus, np.eye(n), device=dev,
                                      **kw), torch.triu(packed))

    cases = [   # name, fn(device) -> tensor or tuple of them
        ("trsm", lambda d: gt.trsm(tri, b, device=d, **kw)),
        ("trmm", lambda d: gt.trmm(tri, b, device=d, **kw)),
        ("getrf", lu_pair),
        ("lu_solve", lambda d: gt.lu_solve(*lu_pair(d), b, device=d, **kw)),
        ("solve", lambda d: gt.solve(a + n * np.eye(n), vec, num_moduli=6,
                                     block=64, refine_steps=2, device=d)),
        ("inv", lambda d: gt.inv(a, device=d, **kw)),
        ("trtri", lambda d: gt.trtri(tri, device=d, **kw)),
        ("potrf", lambda d: gt.potrf(spd, device=d, **kw)),
        ("potrs", lambda d: gt.potrs(tri, b, device=d, **kw)),
        ("posv", lambda d: gt.posv(spd, vec, refine_steps=1, device=d,
                                   **kw)),
        ("geqrf", geqrf_qr),
        ("ormqr", ormqr_q),
        ("qr", lambda d: _normalize_qr(*gt.qr(a, device=d, **kw))),
        ("lstsq", lambda d: gt.lstsq(tall, tall_b, device=d, **kw)),
        ("eigh", lambda d: gt.eigh(sym, device=d)[0]),
        ("svd", lambda d: gt.svd(gen, compute_uv=False, device=d)),
        ("zsolve", lambda d: gt.solve(z + n * np.eye(n), zvec, device=d,
                                      **kw)),
        ("zqr", lambda d: _normalize_qr(*gt.qr(z, device=d, **kw))),
    ]
    worst = {}
    for name, fn in cases:
        got = fn("cuda")
        with cpu_epilogue_ff():
            ref = fn("cpu")
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        for g, r_ in zip(got, ref):
            g = g.cpu()
            if not r_.is_floating_point() and not r_.is_complex():
                check(torch.equal(g, r_), f"{name}: pivots card vs cpu")
                continue
            err = float((g - r_).abs().max() / r_.abs().max())
            tol = 1e-12 if name in ("eigh", "svd") else 1e-11
            check(err <= tol, f"{name} card vs cpu: {err!r} > {tol!r}")
            worst[name] = max(worst.get(name, 0.0), err)
    log(f"solvers card vs cpu at 300^2 (relative to max|cpu|; eigenvalues "
        f"and singular values within 1e-12, the rest within 1e-11): "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))
    # (b) the emulated stage alone, bit for bit
    parts = [t[:300, :300].contiguous() for t in caps["getrf"][0]]
    got = solvers._schur_update(*parts, num_moduli=14, fastmode="robust",
                                backend="INT8")
    with cpu_epilogue_ff():
        ref = solvers._schur_update(*(t.cpu() for t in parts),
                                    num_moduli=14, fastmode="robust",
                                    backend="INT8")
    assert_bits_equal(got, ref, "_schur_update at getrf's captured operands "
                      "cut to 300^2, card vs cpu")
    log("solvers: _schur_update at 300^2 card vs cpu bit-equal")
    return len(cases) + 1


def same_bits(name, out, ref):
    out = out if isinstance(out, tuple) else (out,)
    for o, r in zip(out, ref):
        assert_bits_equal(o, r, f"{name}: repeat vs phase 4")


def solver_natives(x):
    """Each call's native cuSOLVER/cuBLAS f64 counterpart on the same
    operands (trmm: a dense product with the triangle, torch has no trmm);
    getrf's, potrf's and geqrf's are solver_flops.native's."""
    from gemmul8_tpu_torch.probes import solver_flops
    a, ad, spd, tri, b, vec = (x[k] for k in ("a", "ad", "spd", "tri", "b",
                                               "vec"))
    return {
        **{op: solver_flops.native(op, a, spd) for op in solver_flops.OPS},
        "solve": lambda: torch.linalg.solve(ad, vec),
        "posv": lambda: torch.cholesky_solve(
            vec[:, None], torch.linalg.cholesky_ex(spd).L),
        "inv": lambda: torch.linalg.inv(a),
        "trsm": lambda: torch.linalg.solve_triangular(tri, b, upper=False),
        "trmm": lambda: tri @ b,
        "qr": lambda: torch.linalg.qr(a),
        "lstsq": lambda: torch.linalg.lstsq(x["tall"], x["tall_b"][:, None]),
        "eigh": lambda: torch.linalg.eigh(x["sym"]),
        "svd": lambda: torch.linalg.svd(x["gen"], full_matrices=False),
        "zsolve": lambda: torch.linalg.solve(x["zd"], x["zvec"]),
        "zqr": lambda: torch.linalg.qr(x["z"]),
    }


def split_run(name, native_targets, update_targets):
    """The call once more with each native piece and each emulated update
    bracketed by CUDA events: ({updates, native, instrumented: the whole
    instrumented call} ms, the pieces' counts); the output bit-equal to
    phase 4's."""
    fn, ref, _ = SOLVER_CALLS[name]
    spans = {"updates": [], "native": []}

    def bracket(kind):
        def make(f):
            def call(*args, **kw):
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                out = f(*args, **kw)
                e.record()
                spans[kind].append((s, e))
                return out
            return call
        return make
    whole = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with patched([(m, n, bracket("native")) for m, n in native_targets]
                 + [(m, n, bracket("updates")) for m, n in update_targets]):
        whole[0].record()
        out = fn()
        whole[1].record()
    torch.cuda.synchronize()
    same_bits(name, out, ref)
    ms = {k: sum(s.elapsed_time(e) for s, e in v) for k, v in spans.items()}
    ms["instrumented"] = whole[0].elapsed_time(whole[1])
    return ms, {k: len(v) for k, v in spans.items()}


def solver_times(x, card):
    """Phase 6: each phase-4 call again, timed by CUDA events: the median
    of 3 after phase 4's run as the warm-up (1 where that run took over
    10 s), each repeat bit-equal to phase 4's output (the reproducibility
    promise), beside the native routine (median of 3 after a warm-up; 1
    after one for eigh and svd), TF/s by solver_flops' counts; then getrf,
    geqrf and eigh instrumented: the emulated updates, the native pieces
    and the rest (copies, permutations, host time) of the whole call."""
    from gemmul8_tpu_torch.probes import solver_flops
    solvers, qr, eig = solver_modules()
    natives = solver_natives(x)
    out = {}
    for name, (fn, ref, seconds) in SOLVER_CALLS.items():
        reps = 1 if seconds > 10 else 3
        times = []
        for _ in range(reps):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            res = fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
            same_bits(name, res, ref)
            del res
        base = name.split()[0]              # "getrf nu=17": getrf's
        slow = base in ("eigh", "svd")
        t = dict(ms=statistics.median(times), reps=reps,
                 native_ms=solver_flops.time_ms(natives[base],
                                                1 if slow else 3))
        op = base if base in solver_flops.OPS else None
        if op:
            t["tflops"] = solver_flops.flops_of(op, FULL) / t["ms"] / 1e9
            t["native_tflops"] = solver_flops.flops_of(op, FULL) / t[
                "native_ms"] / 1e9
        if name in SOLVER_SWEEPS:
            t["sweeps"] = SOLVER_SWEEPS[name]
        out[name] = t
        torch.cuda.empty_cache()
    splits = {
        "getrf": ([(solvers, "_panel_lu"), (solvers, "_tri_solve_native")],
                  [(solvers, "_schur_update")]),
        "geqrf": ([(qr, "_panel_qr"), (qr, "_tri_inv_upper"),
                   (solvers, "_small_matmul")],
                  [(qr, "_dist_gemm"), (qr, "_schur_update"), (qr, "syrk")]),
        "eigh": ([(eig, "_eigh_small")], [(eig, "gemm_batched")]),
    }
    for name, (native_t, update_t) in splits.items():
        ms, counts = split_run(name, native_t, update_t)
        t = out[name]
        # the rest from the instrumented run itself: its pieces' events
        # also hold the card's idle time while the host enqueues them, so
        # against the uninstrumented median it can come out negative
        t.update(updates_ms=ms["updates"], native_pieces_ms=ms["native"],
                 instrumented_ms=ms["instrumented"],
                 rest_ms=ms["instrumented"] - ms["updates"] - ms["native"],
                 updates=counts["updates"], native_pieces=counts["native"])
    # the probe as a user runs it, on its own operands (A + n I) and its
    # default block (1024 at 8192)
    for r in solver_flops.main(["--sizes", str(FULL)]):
        check(all(math.isfinite(r[k]) and r[k] > 0 for k in
                  ("ms", "native_ms")), f"solver_flops row {r}")
        log(f"times {card} | solver_flops: " + ", ".join(
            f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in r.items()))
    for name, t in out.items():
        tag, counts = SOLVER_RUNS[name]
        launches = {k: counts[k] for k in SOLVER_KEYS if counts.get(k)}
        log(f"times {card} | solver {name} ({tag}): " + ", ".join(
            f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in t.items()) + f", launches {launches}")
    return out


# ---------------------------------------------------------------------------
# SUMMA over a device mesh (gemmul8_tpu_torch.parallel): a 1x1 NCCL mesh (a
# world of one) at full width, a 2x2 mesh of four processes sharing the
# card over gloo, the card against the CPU path, and times
# ---------------------------------------------------------------------------

SUMMA_KEYS = ("encode_planes", "_int_mm", "fused_epilogue",
              "encode_planes_fp8", "_scaled_mm", "fused_epilogue_fp8",
              "reassemble_fp8", "fused_epilogue_complex", "estimate_int_mm")
SUMMA_PANEL = 2048                     # k_panel of the 8192^3 streams: 4 steps
SUMMA_RUNS: dict = {}                  # case -> (dtype tag, launch counts)
SUMMA_MESHES: dict = {}                # device type -> its 1x1 mesh
# the 8192^3 cases on the 1x1 NCCL mesh: name, dtype, summa keywords, and
# the launches one call makes (SUMMA_KEYS order)
SUMMA_PATHS = (
    ("dgemm16 gather", torch.float64, dict(num_moduli=16),
     (2, 16, 1, 0, 0, 0, 0, 0, 0)),
    ("dgemm16 stream ring", torch.float64,
     dict(num_moduli=16, k_panel=SUMMA_PANEL), (2, 64, 1, 0, 0, 0, 0, 0, 0)),
    ("dgemm16 stream psum", torch.float64,
     dict(num_moduli=16, k_panel=SUMMA_PANEL, bcast="psum"),
     (2, 64, 1, 0, 0, 0, 0, 0, 0)),
    ("dgemm16 robust", torch.float64, dict(num_moduli=16, fastmode="robust"),
     (2, 16, 1, 0, 0, 0, 0, 0, 0)),
    ("dgemm16 accurate", torch.float64, dict(num_moduli=16, fastmode=False),
     (2, 17, 1, 0, 0, 0, 0, 0, 1)),
    ("sgemm8 gather", torch.float32, dict(num_moduli=8),
     (2, 8, 1, 0, 0, 0, 0, 0, 0)),
    ("fp8 dgemm14 gather", torch.float64, dict(num_moduli=14, backend="FP8"),
     (0, 0, 0, 2, 42, 1, 0, 0, 0)),
    ("fp8 dgemm14 stream", torch.float64,
     dict(num_moduli=14, backend="FP8", k_panel=SUMMA_PANEL),
     (0, 0, 1, 2, 168, 0, 4, 0, 0)),
    ("zgemm16 planar gather", torch.complex128, dict(num_moduli=16),
     (4, 48, 0, 0, 0, 0, 0, 1, 0)),
    ("zgemm16 planar stream", torch.complex128,
     dict(num_moduli=16, k_panel=SUMMA_PANEL), (4, 192, 0, 0, 0, 0, 0, 1, 0)),
)
SUMMA_HOLD_ROWS = 1024


def summa_mesh(device_type):
    """The 1x1 mesh on `device_type` over the world of one make_mesh starts
    (gloo for host tensors, NCCL for CUDA ones), made once."""
    from gemmul8_tpu_torch.parallel import summa
    if device_type not in SUMMA_MESHES:
        SUMMA_MESHES[device_type] = summa.make_mesh((1, 1),
                                                    device_type=device_type)
    return SUMMA_MESHES[device_type]


def summa_call(mesh, a, b, kw):
    """summa_gemm (complex operands: summa_gemm_planar on their parts) on
    the mesh: the local block of C, complex for complex operands."""
    from gemmul8_tpu_torch.parallel import summa
    if a.is_complex():
        cr, ci = summa.summa_gemm_planar(a.real, a.imag, b.real, b.imag,
                                         mesh=mesh, **kw)
        return torch.complex(cr.to_local(), ci.to_local())
    return summa.summa_gemm(a, b, mesh=mesh, **kw).to_local()


def summa_captures(store):
    """Patch targets keeping the inputs of the kernels SUMMA's streams end
    in: the real epilogue's accumulator (K2, whole), the second FP8 panel's
    reassembly in accumulate mode (K3r) and the complex epilogue's lane
    accumulator (K4), these two on rows 0-1023."""
    from gemmul8_tpu_torch import kernels
    from gemmul8_tpu_torch.parallel import summa
    rows = SUMMA_HOLD_ROWS

    def real_epilogue(fn):
        def call(acc, sa, sb, nu, backend, dt, epilogue):
            if acc.dtype == torch.int32 and "k2" not in store:
                store["k2"] = (acc.clone(), sa, sb, nu, backend, dt)
            return fn(acc, sa, sb, nu, backend, dt, epilogue)
        return call

    def reassemble(fn):
        def call(c3, nu, out=None, accumulate=False):
            if accumulate and "k3r" not in store:
                store["k3r"] = (c3[:, :rows].clone(), nu,
                                out[:, :rows].clone())
            return fn(c3, nu, out=out, accumulate=accumulate)
        return call

    def lanes_epilogue(fn):
        def call(acc3, sa, sb, nu, backend, dt, epilogue):
            if "k4" not in store:
                store["k4"] = (acc3[:, :rows].clone(), sa[:rows].clone(), sb,
                               nu, backend, dt)
            return fn(acc3, sa, sb, nu, backend, dt, epilogue)
        return call
    return [(summa, "_real_epilogue", real_epilogue),
            (kernels, "reassemble_fp8", reassemble),
            (summa, "_lanes_epilogue", lanes_epilogue)]


def summa_accuracy(name, dt, got8, a, b):
    """Rows 0-7 against the gemm paths' longdouble oracles, PERF.md §2's
    limits: f64 max relative error <= 2x cuBLAS DGEMM's and max
    error/(|A||B|) < 1e-13; f32 below cuBLAS SGEMM's; ZGEMM <= 2x cuBLAS
    ZGEMM's."""
    if dt == torch.complex128:
        ref = COMPLEX_ORACLES[("gemm", dt)]
        err, med = complex_relerr(got8, ref)
        nerr, _ = complex_relerr(torch.matmul(a[:8], b).cpu().numpy(), ref)
        check(err <= 2 * nerr, f"summa {name} error {err} vs cuBLAS {nerr}")
        log(f"accuracy summa {name} rows 0-7: max {err:.3e} median "
            f"{med:.3e}; torch.matmul max {nerr:.3e}")
        return
    ref, scale, (nerr, _) = ORACLES[dt]
    err, med = max_median_relerr(got8, ref)
    cw = float(np.max(np.abs(np.asarray(got8, np.longdouble) - ref) / scale))
    if dt == torch.float64:
        check(err <= 2 * nerr and cw < 1e-13,
              f"summa {name} error {err} (|A||B|-relative {cw}) vs cuBLAS "
              f"{nerr}")
    else:
        check(err < nerr, f"summa {name} error {err} vs cuBLAS f32 {nerr}")
    log(f"accuracy summa {name} rows 0-7: max {err:.3e} median {med:.3e} "
        f"max/|A||B| {cw:.3e}; torch.matmul max {nerr:.3e}")


def summa_paths(a64, b64, A, B):
    """Phase 4: SUMMA through summa_gemm / summa_gemm_planar on a 1x1 NCCL
    mesh at 8192^3, each case with its launch counts set to 0 just before
    and read just after; the output's shape, dtype and finiteness; rows 0-7
    within PERF.md §2's limits; the streams bit-equal to the gather path.
    K2 on the streamed accumulator, K3r in accumulate mode and K4 on the
    complex stream's accumulator are held against their plain versions at
    these shapes."""
    import torch.distributed as dist
    from gemmul8_tpu_torch import kernels
    mesh = summa_mesh("cuda")
    backend = dist.get_backend_config(mesh.get_group("x"))
    check("cuda:nccl" in backend, f"the card's mesh runs on {backend}")
    ops = {torch.float64: (a64, b64),
           torch.float32: (a64.float(), b64.float()),
           torch.complex128: (A, B)}
    outs, store = {}, {}
    for name, dt, kw, want in SUMMA_PATHS:
        a, b = ops[dt]
        with patched(summa_captures(store)):
            c, counts = run_counted(lambda: summa_call(mesh, a, b, kw))
        got = tuple(counts.get(k, 0) for k in SUMMA_KEYS)
        check(got == want, f"summa {name} launches "
              f"{dict(zip(SUMMA_KEYS, got))}, want "
              f"{dict(zip(SUMMA_KEYS, want))}")
        SUMMA_RUNS[name] = (TAG[dt], counts)
        check(c.shape == (FULL, FULL) and c.dtype == dt and bool(
            torch.isfinite(torch.view_as_real(c) if c.is_complex() else c)
            .all()), f"summa {name} output {c.shape} {c.dtype}")
        summa_accuracy(name, dt, c[:8].cpu().numpy(), a, b)
        outs[name] = c
        log(f"summa {name}: launches "
            f"{ {k: v for k, v in zip(SUMMA_KEYS, got) if v} }")
    del ops
    for stream, gather in (("dgemm16 stream ring", "dgemm16 gather"),
                           ("dgemm16 stream psum", "dgemm16 gather"),
                           ("fp8 dgemm14 stream", "fp8 dgemm14 gather"),
                           ("zgemm16 planar stream",
                            "zgemm16 planar gather")):
        assert_bits_equal(outs[stream], outs[gather],
                          f"summa {stream} vs {gather}")
    del outs
    torch.cuda.empty_cache()
    acc, sa, sb, nu, backend, dt = store.pop("k2")
    compare_rows("fused_epilogue[f64]",
                 kernels.fused_epilogue(acc, sa, sb, nu, backend, dt),
                 lambda r0, r1: kernels.fused_epilogue_plain(
                     acc[:, r0:r1], sa[r0:r1], sb, nu, backend, dt),
                 "K2 on SUMMA's streamed accumulator")
    del acc
    c3, nu, out = store.pop("k3r")
    compare(REASSEMBLE_KEY, kernels.reassemble_fp8(
        c3, nu, out=out.clone(), accumulate=True),
        out + kernels.reassemble_fp8_plain(c3, nu),
        "K3r accumulating SUMMA's second FP8 panel")
    acc3, sa, sb, nu, backend, dt = store.pop("k4")
    compare("fused_epilogue_complex[c128]", kernels.fused_epilogue_complex(
        acc3, sa, sb, nu, backend, dt), kernels.fused_epilogue_complex_plain(
        acc3, sa, sb, nu, backend, dt), "K4 on SUMMA's streamed lanes")
    del store, c3, out, acc3
    torch.cuda.empty_cache()
    log(f"kernels vs plain at SUMMA's shapes, bit-equal: {CASES}")


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _block(x, coord, shape):
    (i, j), (X, Y) = coord, shape
    r, c = x.shape[0] // X, x.shape[1] // Y
    return x[i * r:(i + 1) * r, j * c:(j + 1) * c]


SUMMA_2X2: dict = {}          # case -> per-rank (ms, plane bytes)


def summa_mesh_2x2(card, deadline_s=420):
    """Phase 4: the 2x2 mesh, four processes sharing the card over gloo
    (NCCL refuses two ranks on one device), started with the spawn method
    after the kernel library is built; each loads it from _build/. Every
    rank's C block (the solvers' whole results) must equal the 1x1 NCCL
    run of the same cases bit for bit (compared by digest), each rank's
    plane bytes must equal summa_bytes_moved's model (FP8: half, e4m3 for
    bf16), rank 0 holds K1 and K2 at its block shapes against their plain
    versions, and no rank imports JAX or the JAX package."""
    import queue as queue_mod
    import torch.multiprocessing as mp
    from gemmul8_tpu_torch.parallel import summa
    from gemmul8_tpu_torch.probes import summa_mesh as sm
    shape, world = (2, 2), 4
    coords = [(i, j) for i in range(2) for j in range(2)]
    mesh = summa_mesh("cuda")
    x = sm.inputs(torch.device("cuda"))
    ref = {}
    t0 = time.perf_counter()
    for name in sm.case_names():
        outs = sm.run_case(mesh, x, name)
        ref[name] = ({c: [sm.digest(_block(o, c, shape)) for o in outs]
                      for c in coords} if name in sm.GEMM_CASES
                     else [sm.digest(o) for o in outs])
        del outs
    del x
    torch.cuda.empty_cache()
    log(f"summa 2x2: the 1x1 NCCL reference in "
        f"{time.perf_counter() - t0:.1f}s")
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    t0 = time.perf_counter()
    linalg = str(torch.backends.cuda.preferred_linalg_library()).rpartition(
        ".")[2].lower()
    procs = mp.spawn(sm.worker, args=(world, shape, _free_port(), q, linalg),
                     nprocs=world, join=False)
    got = []
    try:
        while len(got) < world:
            check(time.perf_counter() - t0 < deadline_s,
                  f"summa 2x2: {len(got)} of {world} ranks in {deadline_s}s")
            try:
                got.append(q.get(timeout=5))
            except queue_mod.Empty:
                procs.join(timeout=0.1)       # raises if a rank failed
        while not procs.join(timeout=5):
            check(time.perf_counter() - t0 < deadline_s, "summa 2x2: a rank "
                  "did not end")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.terminate()
    log(f"summa 2x2: four ranks in {time.perf_counter() - t0:.1f}s")
    for rank, coord, res, holds, imported in sorted(got):
        check(imported == [], f"rank {rank} imported {imported}")
        for name, r in res.items():
            want = ref[name][coord] if name in sm.GEMM_CASES else ref[name]
            check(r["digests"] == want, f"summa 2x2 {name}: rank {rank} "
                  f"{coord} differs from the 1x1 run")
            if name in sm.GEMM_CASES:
                planes = summa.plane_bytes(r["bytes"])
                keys, kw = sm.GEMM_CASES[name]
                n = sm.N_GEMM if len(keys) == 2 else sm.N_CPLX
                model = summa.summa_bytes_moved(
                    n, n, n, shape, kw["num_moduli"],
                    k_panel=kw.get("k_panel"), bcast=kw.get("bcast", "ring"),
                    backend=kw.get("backend", "INT8"),
                    fastmode=kw.get("fastmode", True),
                    complex_lanes=len(keys) == 4)
                if kw.get("backend") == "FP8":
                    model /= 2
                check(planes == model, f"summa 2x2 {name}: rank {rank} sent "
                      f"{planes} plane bytes, the model says {model}")
                SUMMA_2X2.setdefault(name, []).append((r["ms"], planes))
            else:
                SUMMA_2X2.setdefault(name, []).append((r["ms"], None))
        for kname, (equal, shape_) in holds.items():
            key = f"{kname}[f64]"
            check(equal, f"rank 0's {kname} at {shape_} differs from its "
                  f"plain version")
            MAX_ABS_ERR.setdefault(key, 0.0)
            CASES[key] = CASES.get(key, 0) + 1
    for name, runs in SUMMA_2X2.items():
        log(f"summa 2x2 {card} (four ranks time-sharing one card over "
            f"gloo, not scaling): {name} ms by rank "
            f"{[round(ms, 3) for ms, _ in runs]}, plane bytes a rank "
            f"{[b for _, b in runs]}")
    return SUMMA_2X2


def summa_runs_of(key, tag, kern):
    """The launches of kernel `key` in each SUMMA call of phase 4 that the
    entry tagged `tag` stands for: the entry of the call's dtype, else of
    its real parts' (a planar ZGEMM's K1 encodes f64 planes), else every
    entry of the kernel (K3r's one entry stands for it on any dtype)."""
    tags = {e["name"].partition("[")[2].rstrip("]") for e in kern
            if e["name"].partition("[")[0] == key}
    runs = {}
    for name, (dtag, counts) in SUMMA_RUNS.items():
        if not counts.get(key):
            continue
        want = next((t for t in (dtag, {"c128": "f64", "c64": "f32"}.get(
            dtag)) if t in tags), None)
        if want is None or want == tag:
            runs[name] = counts[key]
    return runs


def summa_card_vs_cpu(rng):
    """Phase 5: the 1x1 NCCL mesh against the port's CPU path on a gloo CPU
    mesh of one in this process, bit for bit, at small ragged shapes (the
    card pads to 128; k_panel 96 pads each panel), in every mode, the "ff"
    epilogue on both."""
    cuda, cpu = summa_mesh("cuda"), summa_mesh("cpu")
    m, k, n = 200, 384, 136
    a = phi_matrix(rng, m, k, 1.0)
    b = phi_matrix(rng, k, n, 1.0)
    za = a + 1j * phi_matrix(rng, m, k, 1.0)
    zb = b + 1j * phi_matrix(rng, k, n, 1.0)
    cases = [
        (a, b, dict(num_moduli=16)),
        (a, b, dict(num_moduli=16, fastmode="robust")),
        (a, b, dict(num_moduli=16, fastmode=False)),
        (a, b, dict(num_moduli=16, k_panel=128)),
        (a, b, dict(num_moduli=16, k_panel=96, bcast="psum")),
        (a, b, dict(num_moduli=16, k_panel=96, fastmode=False)),
        (a.astype(np.float32), b.astype(np.float32), dict(num_moduli=8)),
        (a, b, dict(num_moduli=14, backend="FP8")),
        (a, b, dict(num_moduli=14, backend="FP8", fastmode=False)),
        (a, b, dict(num_moduli=14, backend="FP8", k_panel=96)),
        (za, zb, dict(num_moduli=16)),
        (za, zb, dict(num_moduli=18)),
        (za, zb, dict(num_moduli=16, k_panel=128)),
        (za, zb, dict(num_moduli=12, fastmode=False, k_panel=96)),
        (za.astype(np.complex64), zb.astype(np.complex64),
         dict(num_moduli=9, backend="FP8")),
    ]
    for x, y, kw in cases:
        kw = dict(kw, epilogue="ff")
        tx, ty = torch.from_numpy(x), torch.from_numpy(y)
        got = summa_call(cuda, tx.cuda(), ty.cuda(), kw)
        ref = summa_call(cpu, tx, ty, kw)
        assert_bits_equal(got, ref, f"summa card vs cpu {x.dtype} {kw}")
    return len(cases)


def summa_times(a64, b64, card):
    """Phase 6: SUMMA on the 1x1 NCCL mesh, gather and stream (k_panel
    2048, ring), beside gemm and torch.matmul at DGEMM 8192^3 nu=16, in
    turns (CUDA events, median of 10 after a warm-up), and each stage apart
    (median of 5): the distributed shifts, the encodes, the collectives,
    the products, the stream's accumulation and the epilogue."""
    import gemmul8_tpu_torch as gt
    from gemmul8_tpu_torch import core, kernels
    from gemmul8_tpu_torch.parallel import summa
    mesh = summa_mesh("cuda")
    nu = 16
    calls = {
        "gemm": lambda: gt.gemm(a64, b64, num_moduli=nu),
        "summa gather": lambda: summa.summa_gemm(a64, b64, mesh=mesh,
                                                 num_moduli=nu),
        "summa stream": lambda: summa.summa_gemm(
            a64, b64, mesh=mesh, num_moduli=nu, k_panel=SUMMA_PANEL),
        "torch.matmul": lambda: torch.matmul(a64, b64),
    }
    t = {name: v[0] for name, v in in_turns(calls, reps=5).items()}
    summa.reset_bytes()
    calls["summa gather"]()
    # a 1x1 mesh sends no plane: each team is one rank (the 2x2 run's bytes
    # are phase 4's)
    t["plane_bytes_a_rank"] = summa.plane_bytes(summa.BYTES_SENT)
    check(t["plane_bytes_a_rank"] == 0, "a 1x1 mesh sent plane bytes")
    comm = summa.Comm(mesh)
    sa, sb = summa._dist_shifts(a64, b64, nu, True, "INT8", comm)
    pa = core.encode_side(a64, sa, 0, nu, "INT8")
    pb = core.encode_side(b64, sb, 1, nu, "INT8")
    ag = comm.gather_k(pa, "y", -1)
    bg = comm.gather_k(pb, "x", -2)
    c_hi = core.residue_matmul(ag, bg)
    w = SUMMA_PANEL
    ap, bp = (comm.bcast(pa, "y", 0, 0, w, -1)(),
              comm.bcast(pb, "x", 0, 0, w, -2)())
    part = core.residue_matmul(ap, bp)
    raw = part.clone()
    stages = dict(
        shifts_ms=cuda_ms(lambda: summa._dist_shifts(a64, b64, nu, True,
                                                     "INT8", comm)),
        encodes_ms=cuda_ms(lambda: (core.encode_side(a64, sa, 0, nu, "INT8"),
                                    core.encode_side(b64, sb, 1, nu,
                                                     "INT8"))),
        gather_ms=cuda_ms(lambda: (comm.gather_k(pa, "y", -1),
                                   comm.gather_k(pb, "x", -2))),
        products_ms=cuda_ms(lambda: core.residue_matmul(ag, bg)),
        epilogue_ms=cuda_ms(lambda: kernels.fused_epilogue(
            c_hi, sa, sb, nu, "INT8", torch.float64)),
        panel_bcast_ms=cuda_ms(lambda: (
            comm.bcast(pa, "y", 0, 0, w, -1)(),
            comm.bcast(pb, "x", 0, 0, w, -2)())),
        panel_products_ms=cuda_ms(lambda: core.residue_matmul(ap, bp,
                                                              out=part)),
        panel_accumulate_ms=cuda_ms(lambda: raw.add_(part)),
    )
    del ag, bg, c_hi, pa, pb, ap, bp, part, raw
    torch.cuda.empty_cache()
    t.update(stages)
    flops = 2.0 * FULL ** 3
    for name in calls:
        t[f"{name} TF/s"] = flops / (t[name] * 1e-3) / 1e12
    log(f"summa times {card} | DGEMM 8192^3 nu=16 1x1 NCCL mesh: " + ", ".join(
        f"{k} {v:.4f}" for k, v in t.items()))
    return t


# ---------------------------------------------------------------------------
# the examples and the benchmark probes (queue 14)
# ---------------------------------------------------------------------------

# each example (gemmul8_tpu_torch/examples) and the launches its run must
# show: its main path's kernels and library products
EXAMPLES = (
    ("dgemm_int8", ("encode_planes", "_int_mm", "fused_epilogue")),
    ("fp8_backend", ("encode_planes_fp8", "_scaled_mm", "fused_epilogue_fp8")),
    ("planar_complex", ("encode_planes", "_int_mm",
                        "fused_epilogue_complex")),
    ("compat_gemmlt", ("encode_planes", "_int_mm", "fused_epilogue",
                       "encode_planes_fp8", "_scaled_mm",
                       "fused_epilogue_fp8")),
    ("blas3_tour", ("encode_planes", "_int_mm", "fused_epilogue",
                    "fused_epilogue_complex")),
    ("iterative_refinement", ("encode_planes", "_int_mm", "fused_epilogue")),
    ("lu_solver", ("encode_planes", "_int_mm", "fused_epilogue")),
    ("dense_linalg", ("encode_planes", "_int_mm", "fused_epilogue")),
    ("hook_training", ("encode_planes", "_int_mm", "fused_epilogue")),
    ("distributed_summa", ("encode_planes", "_int_mm", "fused_epilogue",
                           "estimate_int_mm")),
)
EXAMPLE_RUNS: dict = {}       # example -> (launch counts, seconds)
EXAMPLE_OUT: dict = {}        # example -> what its main returned on the card
BENCH_RUNS: dict = {}         # probe -> launch counts
# the accuracy sweep of the benchmarks part, cut in sweep length only
ACC_SWEEP = dict(dtype="f64", ks=(1024, 4096), phis=(0.5, 4.0), nus=(9, 16))
BIG_SIZE, BIG_NU, BIG_BUDGET_GB = 16384, 16, 8.0


def example_paths():
    """Phase 4: each example's main on the card, through run_counted: an
    assert that fails in an example fails the run, and each must launch
    its main path's kernels and products."""
    for name, want in EXAMPLES:
        mod = importlib.import_module(f"gemmul8_tpu_torch.examples.{name}")
        log(f"example {name}:")
        t0 = time.perf_counter()
        out, counts = run_counted(lambda: mod.main(device="cuda"))
        secs = time.perf_counter() - t0
        launched = {k: v for k, v in counts.items() if v}
        for key in want:
            check(launched.get(key, 0) > 0,
                  f"example {name}: no {key} launch ({launched})")
        EXAMPLE_RUNS[name] = (launched, secs)
        EXAMPLE_OUT[name] = out
        log(f"example {name}: {secs:.3f} s, launches {launched}")


def power_limit_w(card):
    """The power limit in watts from nvidia-smi's "name, 700.00 W"."""
    return float(card.rsplit(",", 1)[1].split()[0])


def benchmark_paths(card):
    """Phase 4: the four benchmark probes at full protocol width, cut only
    in sweep length: accuracy (f64 INT8, k 1024 and 4096, phi 0.5 and 4, nu
    9 and 16, with the os1 and robust rows), flops (4096^3 nu=16, f64 with
    the phases and the syrk row, and c128), big_flops (16384^3 nu=16 under
    an 8 GiB budget, which must stripe) and power (10 s of 4096^3 nu=16
    gemm calls, sampled by one streaming nvidia-smi)."""
    from gemmul8_tpu_torch import core
    from gemmul8_tpu_torch.probes import accuracy, big_flops, flops, power
    out = {}
    rows, BENCH_RUNS["accuracy"] = run_counted(
        lambda: accuracy.sweep(**ACC_SWEEP, device="cuda", log=sys.stdout))
    for r in rows:
        check(all(math.isfinite(x) for x in r[4:6]), f"accuracy row {r}")
    for k in ACC_SWEEP["ks"]:
        for phi in ACC_SWEEP["phis"]:
            med = {r[3]: r[5] for r in rows
                   if r[:3] == [k, phi, "oz2-robust"]}
            check(med[16] < med[9], f"accuracy k={k} phi={phi}: nu=16 not "
                  f"more accurate than nu=9 ({med})")
    log(f"benchmark accuracy {card}: " + json.dumps(rows))
    out["accuracy"] = rows
    t0 = time.perf_counter()
    frows = []
    for dtype in ("f64", "c128"):
        got, BENCH_RUNS[f"flops {dtype}"] = run_counted(
            lambda: flops.sweep(dtype, (4096,), (16,), iters=8,
                                phases=dtype == "f64", device="cuda",
                                log=sys.stdout))
        frows += [[dtype, *r] for r in got]
    for dtype, size, method, nu, sec, tflops, *ph in frows:
        check(sec > 0 and 0 < tflops < math.inf, f"flops row {method}")
        if method.startswith("oz2"):
            # the emulated call runs nu int8 products (3nu complex)
            lanes = 3 if dtype == "c128" else 1
            fac = 8.0 if dtype == "c128" else 2.0
            check(lanes * nu * 2.0 / fac * tflops * 1e12 <= PEAK_INT8_OPS,
                  f"flops {dtype} {method}: {tflops} TF/s above the int8 peak")
        if dtype == "f64" and method == "oz2-fast":
            check(all(isinstance(p, float) and p > 0 for p in ph),
                  f"flops phases {ph}")
    check({r[2] for r in frows} == {"native", "os1-int8", "oz2-fast",
                                    "oz2-syrk"}, f"flops methods {frows}")
    log(f"benchmark flops {card} ({time.perf_counter() - t0:.1f} s): "
        + json.dumps(frows))
    out["flops"] = frows
    brows, BENCH_RUNS["big_flops"] = run_counted(
        lambda: big_flops.rows((BIG_SIZE,), (BIG_NU,), BIG_BUDGET_GB, 3,
                               log=sys.stdout))
    size, method, nu, sec, tflops, mb, nb, peak, own, finite = brows[0]
    # the probe's own peak (operands, output, workspace; the memory this
    # script holds excluded) against the unstriped call's
    unstriped = core.work_bytes(size, size, size, nu) + 3 * size * size * 8
    check(nb < size and finite, f"big_flops: n_block {nb}, finite {finite}")
    check(own < unstriped, f"big_flops: peak {own} not below the "
          f"unstriped call's {unstriped}")
    log(f"benchmark big_flops {card}: {size}^3 nu={nu} m_block={mb!r} "
        f"n_block={nb} {sec * 1e3:.3f} ms = {tflops:.3f} TF/s, peak "
        f"{peak} bytes, its own {own} ({own / (1 << 30):.3f} GiB; "
        f"unstriped would need {unstriped / (1 << 30):.3f} GiB)")
    out["big_flops"] = brows
    res, BENCH_RUNS["power"] = run_counted(
        lambda: power.measure(4096, 16, 10.0, 0.1, "cuda"))
    limit = power_limit_w(card)
    check(res["power_source"] == "nvidia-smi",
          f"power: source {res['power_source']}, not nvidia-smi")
    check(res["watts"] is not None and 0 < res["watts"] <= limit,
          f"power: mean {res['watts']} W outside (0, {limit}]")
    check(res["samples"] >= 50 and res["gflops_per_watt"] > 0,
          f"power: {res}")
    log(f"benchmark power {card}: " + json.dumps(res))
    out["power"] = res
    for name, counts in BENCH_RUNS.items():
        # the INT8 main path's kernels and product (ZGEMM: K4, not K2)
        epilogue = ("fused_epilogue_complex" if name == "flops c128"
                    else "fused_epilogue")
        check(all(counts.get(key, 0) > 0
                  for key in ("encode_planes", "_int_mm", epilogue)),
              f"benchmark {name}: launches {counts}")
    return out


def _arrays(out, path=""):
    """(path, value) of every array and number in an example's result."""
    if isinstance(out, dict):
        for k, v in out.items():
            yield from _arrays(v, f"{path}.{k}" if path else str(k))
    elif isinstance(out, (list, tuple)):
        for i, v in enumerate(out):
            yield from _arrays(v, f"{path}[{i}]")
    elif isinstance(out, (np.ndarray, float, int, bool)):
        yield path, out


def _sign_fixed(v):
    """v's columns with the sign that makes each one's largest-magnitude
    entry positive (eigen and singular vectors are defined up to sign)."""
    idx = np.argmax(np.abs(v), axis=0)
    return v * np.sign(v[idx, np.arange(v.shape[1])])


# examples whose results hold the CPU path's bits on the card; blas3_tour's
# trtri runs cuBLAS's triangular solves on its diagonal blocks (held within
# the solvers' 1e-11)
BIT_EXAMPLES = ("dgemm_int8", "fp8_backend", "planar_complex",
                "compat_gemmlt", "blas3_tour", "iterative_refinement",
                "distributed_summa")


def example_card_vs_cpu(bench):
    """Phase 5: each example's card results against its main(device="cpu")
    with "auto" resolved to the card's "ff" epilogue: bit for bit where the
    example runs only emulated products and host numpy, within a relative
    1e-11 for lu_solver and dense_linalg (their native pieces are cuSOLVER
    and LAPACK; dense_linalg's vectors compared up to sign, its nu=8
    singular values within 1e-7, the dial's nu=8 accuracy, since the
    native pieces' last bits steer those sweeps apart), hook_training
    within 1e-5 (the MLP fixture's tolerance); and the accuracy sweep's
    oz2-* and os1-int8 rows on the CPU path, equal."""
    import io
    from gemmul8_tpu_torch.probes import accuracy
    n, worst = 0, {}
    for name, _ in EXAMPLES:
        mod = importlib.import_module(f"gemmul8_tpu_torch.examples.{name}")
        with cpu_epilogue_ff(), contextlib.redirect_stdout(io.StringIO()):
            ref = dict(_arrays(mod.main(device="cpu")))
        got = dict(_arrays(EXAMPLE_OUT[name]))
        check(got.keys() == ref.keys(), f"example {name}: {got.keys()}")
        for path, g in got.items():
            r = ref[path]
            what = f"example {name} {path} card vs cpu"
            if not isinstance(g, np.ndarray):
                if name in BIT_EXAMPLES and path != "trtri":
                    check(g == r, f"{what}: {g!r} vs {r!r}")
                continue
            if name in BIT_EXAMPLES and path != "trtri":
                assert_bits_equal(torch.from_numpy(np.ascontiguousarray(g)),
                                  torch.from_numpy(np.ascontiguousarray(r)),
                                  what)
                continue
            if name == "dense_linalg" and path in ("u", "v"):
                g, r = _sign_fixed(g), _sign_fixed(r)
            elif name == "dense_linalg" and path == "vt":
                g, r = _sign_fixed(g.T), _sign_fixed(r.T)
            elif name == "dense_linalg" and path in ("q", "r"):
                d = np.sign(np.diagonal(ref["r"]) * np.diagonal(
                    got["r"]))              # the Householder sign choice
                g = g * d if path == "q" else d[:, None] * g
            tol = (1e-5 if name == "hook_training"
                   else 1e-7 if path == "s8" else 1e-11)
            err = float(np.max(np.abs(g - r)) / np.max(np.abs(r)))
            check(err <= tol, f"{what}: {err!r} > {tol!r}")
            worst[f"{name}.{path}"] = err
        n += 1
    log("examples card vs cpu: " + ", ".join(BIT_EXAMPLES)
        + " bit-equal (blas3_tour's trtri within 1e-11); within "
        "tolerance: " + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))
    with cpu_epilogue_ff():
        cpu_rows = accuracy.sweep(**ACC_SWEEP, device="cpu",
                                  log=io.StringIO())
    emulated = [(g, r) for g, r in zip(bench["accuracy"], cpu_rows)
                if g[2].startswith("oz2") or g[2] == "os1-int8"]
    check(len(emulated) == len(ACC_SWEEP["ks"]) * len(ACC_SWEEP["phis"])
          * (1 + 2 * len(ACC_SWEEP["nus"])), f"accuracy rows {emulated}")
    for g, r in emulated:
        check(g == r, f"accuracy row card vs cpu: {g} vs {r}")
    log(f"accuracy sweep card vs cpu: {len(emulated)} oz2/os1 rows equal")
    return n + 1


# ---------------------------------------------------------------------------
# the stress sweep, the rank-2k probe and the piece-wise CRT
# ---------------------------------------------------------------------------

STRESS_TRIALS = 40            # tools/device_stress.py's default
STRESS_RUNS: dict = {}        # run -> launch counts
# the sweep's launches: the INT8 real trials' (K1, products, K2), the FP8
# ones' (K6, FP8 products, K3) and the planar trials' (K4)
STRESS_WANT = ("encode_planes", "_int_mm", "fused_epilogue",
               "encode_planes_fp8", "_scaled_mm", "fused_epilogue_fp8",
               "fused_epilogue_complex")
# the product kernels at each trial's shape: (kernel, schedule, bk, B
# k-contiguous)
STRESS_PRODUCTS = (("auto", "kloop", 64, False), ("auto", "astat", 64, True),
                   ("mma_sync", "kloop", 64, False),
                   ("mma_sync", "kloop", 128, True),
                   ("mma_sync", "astat", 64, False))
BLAS3_N, BLAS3_NU = 4096, 16  # tools/probe_blas3_perf.py's defaults
CRT_PATHS = (("INT8", 16), ("FP8", 14))   # DGEMM nu=16, FP8 DGEMM nu=14
CRT_ROWS = 64                 # the CPU reruns' row blocks: cache-sized,
                              # 3x faster than 2048-row ones on the H100
                              # host's 8 cores
GAP_ROWS = 2048               # crt_value_gap's row blocks on the card


def stress_paths(card):
    """Phase 4: the device stress sweep (probes.device_stress) at SEED: 40
    real trials across dtype, backend, nu, mode, ops, alpha/beta and phi at
    shapes 8-399, and 8 planar-complex ones, each within the tool's
    tolerance of the host f64 product. First on the card alone through
    run_counted (the launches), then with --against-cpu: each trial rerun
    on the CPU path and held bit for bit. Then the hand-written int8
    products (kernels.matmul_i8, both routes, both schedules, both B
    layouts) at every trial's (m, k, n) from SEED + 20, against their plain
    version: the random check of _product_route's TMA -> mma.sync fallback
    (gemm's own products are torch._int_mm on operands padded to 128, so
    the sweep does not reach it)."""
    from gemmul8_tpu_torch import kernels
    from gemmul8_tpu_torch.probes import device_stress
    t0 = time.perf_counter()
    recs, STRESS_RUNS["device_stress"] = run_counted(
        lambda: device_stress.run(STRESS_TRIALS, SEED, "cuda",
                                  log=sys.stdout))
    bad = [r["label"] for r in recs if not r["ok"]]
    check(not bad, f"stress trials {bad} outside the tool's tolerance")
    check(len(recs) == STRESS_TRIALS + max(STRESS_TRIALS // 5, 3),
          f"stress: {len(recs)} trials")
    counts = STRESS_RUNS["device_stress"]
    for key in STRESS_WANT:
        check(counts.get(key, 0) > 0, f"stress: no {key} launch ({counts})")
    log(f"stress sweep {card}: {len(recs)} trials within tolerance in "
        f"{time.perf_counter() - t0:.1f} s, worst err/tol "
        f"{max(r['err'] / r['tol'] for r in recs):.3g}, launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    t0 = time.perf_counter()
    recs = device_stress.run(STRESS_TRIALS, SEED, "cuda", against_cpu=True,
                             log=sys.stdout)
    bad = [r["label"] for r in recs if not (r["ok"] and r["cpu_equal"])]
    check(not bad, f"stress trials {bad} failed or differ from the CPU path")
    log(f"stress sweep card vs cpu: {len(recs)} trials bit-equal in "
        f"{time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(SEED)
    shapes = [(t["m"], t["k"], t["n"]) for t in
              device_stress.real_trials(STRESS_TRIALS, rng)]
    shapes += [(t["m"], t["k"], t["n"]) for t in
               device_stress.planar_trials(STRESS_TRIALS, rng)]
    prng = np.random.default_rng(SEED + 20)
    cases, routes = [], {}
    for m, k, n in shapes:
        a = torch.from_numpy(prng.integers(-128, 128, (2, m, k),
                                           dtype=np.int8)).cuda()
        b = torch.from_numpy(prng.integers(-128, 128, (2, k, n),
                                           dtype=np.int8)).cuda()
        for kernel, schedule, bk, kcontig in STRESS_PRODUCTS:
            bb = b.transpose(1, 2).contiguous().transpose(1, 2) if kcontig \
                else b
            route = kernels._product_route(a, bb, kernel)
            routes[route] = routes.get(route, 0) + 1
            cases.append((a, bb, kernel, schedule, bk, (m, k, n), route))

    def launch_all():
        return [kernels.matmul_i8(a, bb, schedule, bk, kernel)
                for a, bb, kernel, schedule, bk, _, _ in cases]

    outs, STRESS_RUNS["product_routes"] = run_counted(launch_all)
    for got, (a, bb, kernel, schedule, bk, shape, route) in zip(outs, cases):
        assert_bits_equal(got, kernels.matmul_i8_plain(a, bb),
                          f"matmul_i8 {kernel} {schedule} bk{bk} {shape} "
                          f"route {route}")
    counts = {k: v for k, v in STRESS_RUNS["product_routes"].items() if v}
    check(routes.get("wgmma", 0) > 0 and routes.get("mma_sync", 0) > 0,
          f"stress products: routes {routes}")
    check(sum(counts.get(k, 0) for k in PRODUCT_COUNTS[:4]) == len(cases),
          f"stress products: launches {counts} for {len(cases)} products")
    log(f"stress products: {len(cases)} matmul_i8 calls at the {len(shapes)} "
        f"trial shapes bit-equal to their plain version, routes {routes}, "
        f"launches {counts}")


def blas3_path(card):
    """Phase 4: probes.blas3_perf at 4096, nu=16: syr2k against the naive
    two-GEMM form, exactly 0 apart at 256 rows (the probe raises
    otherwise), then one gemm, syr2k, the naive form, her2k and the naive
    two-ZGEMM form timed in rotated turns, with their launches."""
    from gemmul8_tpu_torch.probes import blas3_perf
    t0 = time.perf_counter()
    res, BENCH_RUNS["blas3_perf"] = run_counted(
        lambda: blas3_perf.measure(BLAS3_N, BLAS3_N, BLAS3_NU, reps=4,
                                   device="cuda", log=sys.stdout))
    check(res["diff"] == 0.0, f"blas3_perf: syr2k - naive {res['diff']!r}")
    check(len(res["rows"]) == 5, f"blas3_perf rows {res['rows']}")
    for name, n, k, nu, ms, tflops in res["rows"]:
        # products at the rank-2k convention's flops: nu int8 products per
        # real product, 3nu per complex one (2 n^2 k each, as 8 n^2 k / 4)
        lanes = 3 if "Z" in name or "her2k" in name else 1
        fac = 8.0 if lanes == 3 else 2.0
        check(ms > 0 and lanes * nu * 2.0 / fac * tflops * 1e12
              <= PEAK_INT8_OPS, f"blas3_perf {name}: {ms} ms, {tflops} TF/s")
    t = {r[0]: r[4] for r in res["rows"]}
    log(f"blas3_perf {card} ({time.perf_counter() - t0:.1f} s): "
        + json.dumps(res["rows"])
        + f"; syr2k / naive {t['syr2k (G + G^T)'] / t['naive 2-GEMM']:.3f}, "
        f"her2k / naive {t['her2k (G + G^H)'] / t['naive 2-ZGEMM']:.3f}, "
        f"launches {json.dumps(BENCH_RUNS['blas3_perf'])}")
    return res


def crt_value_gap(limbs20, base20, limbs16, base16, P):
    """max over the elements of |t20 - t16 (mod P)| / P, exactly: t20 =
    sum limbs20[i] 2^(base20 + 20 i) (ff.crt_limbs), t16 likewise on the
    16-bit grid (ff.crt_limbs_matrix). The two may pick different
    representatives near +-P/2 (the wrap quotient is an f32 estimate), so q
    = round((t20 - t16) / P) comes from f64 sums; then t20 - t16 - q P is
    formed exactly in 32-bit words of int64 (balanced carries) in units of
    2^g, g = min(base20, base16, 0), and its words summed highest first."""
    g = min(base20, base16, 0)
    dev = limbs20[0].device
    top = max(base20 + 20 * len(limbs20), base16 + 16 * len(limbs16))
    n_words = (top - g) // 32 + 3

    def approx(limbs, base, width):
        out = torch.zeros(limbs[0].shape, dtype=torch.float64, device=dev)
        for i in range(len(limbs) - 1, -1, -1):
            out += limbs[i].double() * 2.0 ** (base + width * i)
        return out

    def carry(words):
        for w in range(n_words - 1):
            c = (words[w] + (1 << 31)) >> 32
            words[w] = words[w] - c * (1 << 32)
            words[w + 1] = words[w + 1] + c
        return words

    def words_of(limbs, base, width, sign):
        words = [torch.zeros(limbs[0].shape, dtype=torch.int64, device=dev)
                 for _ in range(n_words)]
        for i, limb in enumerate(limbs):
            w, off = divmod(base + width * i - g, 32)
            words[w] += limb.to(torch.int64) * (sign * (1 << off))
        return carry(words)

    q = torch.round((approx(limbs20, base20, 20) - approx(limbs16, base16, 16))
                    / float(P)).to(torch.int64)
    check(bool((q.abs() <= 1).all()), "crt_limbs: values more than P apart")
    d = [x + y for x, y in zip(words_of(limbs20, base20, 20, 1),
                               words_of(limbs16, base16, 16, -1))]
    pw = P << -g
    for w in range(n_words):
        d[w] = d[w] - q * ((pw >> (32 * w)) & 0xFFFFFFFF)
    d = carry(d)
    val = torch.zeros_like(d[0], dtype=torch.float64)
    for w in range(n_words - 1, -1, -1):
        val = val * 2.0 ** 32 + d[w].double()
    return float(val.abs().max()) * 2.0 ** g / float(P)


def crt_residues(a64, b64, backend, nu):
    """The wrapped residues C_mid (nu, 8192, 8192) of the 8192^3 path's own
    products: K1's planes through torch._int_mm, mod-reduced (the INT8
    DGEMM), or K6's stacks through the FP8 products, reassembled (the FP8
    DGEMM), in row blocks."""
    from gemmul8_tpu_torch import core, fp8, kernels, quantize
    sa = quantize.shift_fast(a64, nu, backend, 1)
    sb = quantize.shift_fast(b64, nu, backend, 0)
    if backend == "INT8":
        c_hi = core.residue_matmul(
            kernels.encode_planes(a64, sa, 0, nu, backend),
            kernels.encode_planes(b64, sb, 1, nu, backend))
        return core.mod_reduce(c_hi, nu, backend)
    c3 = fp8.residue_matmul_fp8(kernels.encode_planes_fp8(a64, sa, 0, nu),
                                kernels.encode_planes_fp8(b64, sb, 1, nu))
    return torch.cat([fp8._reassemble(c3[:, r0:r0 + 1024].to(torch.int32), nu)
                      for r0 in range(0, FULL, 1024)], dim=1).to(torch.int16)


def crt_limbs_card_vs_cpu(a64, b64, card):
    """Phase 5: ff.crt_limbs, the piece-wise 20-bit CRT that cross-checks
    the production crt_limbs_matrix (on no production route), on the card
    over the DGEMM nu=16 and FP8 DGEMM nu=14 paths' own wrapped residues at
    8192^2: every limb bit for bit against the CPU path (in 64-row blocks),
    the limbs balanced below the top one, and the value within P * 2^-78
    of crt_limbs_matrix's, modulo P (crt_value_gap), as tests/test_ff.py
    holds them."""
    from gemmul8_tpu_torch import ff, tables
    for backend, nu in CRT_PATHS:
        t0 = time.perf_counter()
        c_mid = crt_residues(a64, b64, backend, nu)
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        limbs, base = ff.crt_limbs(c_mid, nu, backend, 53)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t1
        half = 1 << (ff.LIMB_BITS - 1)
        for i, limb in enumerate(limbs[:-1]):
            check(int(limb.min()) >= -half and int(limb.max()) < half,
                  f"crt_limbs {backend} nu={nu}: limb {i} not balanced")
        cpu_mid = c_mid.cpu()
        t1 = time.perf_counter()
        for r0 in range(0, FULL, CRT_ROWS):
            ref, ref_base = ff.crt_limbs(cpu_mid[:, r0:r0 + CRT_ROWS], nu,
                                         backend, 53)
            check(ref_base == base, f"crt_limbs base {ref_base} vs {base}")
            for i, (g, r) in enumerate(zip(limbs, ref)):
                assert_bits_equal(g[r0:r0 + CRT_ROWS], r,
                                  f"crt_limbs {backend} nu={nu} limb {i} "
                                  f"rows {r0}: card vs cpu")
        t_cpu = time.perf_counter() - t1
        del cpu_mid
        limbs16, base16 = ff.crt_limbs_matrix(c_mid, nu, backend, 53)
        P = 1
        for p in tables.moduli(backend)[:nu]:
            P *= int(p)
        gap = 0.0
        for r0 in range(0, FULL, GAP_ROWS):
            rows = slice(r0, r0 + GAP_ROWS)
            gap = max(gap, crt_value_gap([x[rows] for x in limbs], base,
                                         [x[rows] for x in limbs16], base16,
                                         P))
        check(gap <= 2.0 ** -78, f"crt_limbs {backend} nu={nu}: "
              f"{gap!r} P from crt_limbs_matrix's value")
        log(f"crt_limbs {card} {backend} nu={nu} {FULL}^2: {len(limbs)} limbs "
            f"bit-equal card vs cpu (card {t_card * 1e3:.1f} ms, cpu "
            f"{t_cpu:.1f} s), value within {gap:.3g} P of crt_limbs_matrix's "
            f"(bound 2^-78 = {2.0 ** -78:.3g}), {time.perf_counter() - t0:.1f}"
            " s in all")
        del c_mid, limbs, limbs16
        torch.cuda.empty_cache()
    return len(CRT_PATHS)


def stress_key(name):
    """The launch-count key of a kernels-line entry (the product entries
    count by route and schedule)."""
    for entry, _, _, schedule, _, _ in PROBE_PRODUCTS:
        if name == entry:
            return f"matmul_i8_wgmma_{schedule}"
    for entry, schedule, *_ in MMA_SYNC:
        if name == entry:
            return f"matmul_i8_{schedule}"
    if name == TRANSPOSE_KEY:
        return "transpose_i8"
    return name.partition("[")[0]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="build and check the kernels at small shapes only")
    args = ap.parse_args()

    # phase 1: device
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    import gemmul8_tpu_torch as gt
    from gemmul8_tpu_torch import core, kernels, quantize
    torch.backends.cuda.matmul.allow_tf32 = False
    # the solvers' native pieces and the routines they are held against on
    # cuSOLVER (torch otherwise takes MAGMA's for some shapes)
    torch.backends.cuda.preferred_linalg_library("cusolver")
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        f"{torch.cuda.get_device_name(0)}, power limit not read"
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # phase 2: build
    t0 = time.perf_counter()
    lib = kernels.build()
    log(f"build: {time.perf_counter() - t0:.1f}s {lib}")
    log_build_report(kernels)
    log_phase("phase 2 (build)")

    # phase 3: kernels against their plain versions, bit for bit
    rng = np.random.default_rng(SEED)
    # the complex phases draw from a stream of their own, so that the real
    # paths' inputs stay those of the real-only script
    crng = np.random.default_rng(SEED + 1)
    # and the FP8 phases from a third
    frng = np.random.default_rng(SEED + 3)
    # the encode cases added with the redesigned K1 draw from a stream of
    # their own, so that the real paths' inputs stay as they were
    encode_cases(rng, np.random.default_rng(SEED + 5))
    epilogue_cases(rng)
    complex_cases(crng)
    # the ragged K2 and K4 cases added with their redesign, on a stream of
    # their own, and K3's added with its redesign on another
    ragged_epilogue_cases(np.random.default_rng(SEED + 7),
                          np.random.default_rng(SEED + 10))
    fp8_encode_cases(frng)
    fp8_epilogue_cases(frng)
    fp8_exact = fp8_exactness_cases()
    # and the probe kernels from a fourth
    prng = np.random.default_rng(SEED + 4)
    product_cases(prng, np.random.default_rng(SEED + 6))
    mxu_epilogue_cases(prng)
    # the ragged K6 and K8 cases added with their redesign, on a stream of
    # their own
    rrng = np.random.default_rng(SEED + 8)
    fp8_ragged_cases(rrng)
    mxu_ragged_cases(rrng)
    # the complex FP8 kernels, on a stream of their own
    complex_fp8_cases(np.random.default_rng(SEED + 15))
    log(f"kernels vs plain, small shapes, all bit-equal: {CASES}")
    log_phase("phase 3 (kernels vs plain, FP8 product exactness)")
    if args.quick:
        log(json.dumps({"quick": True, "cases": CASES}))
        return

    # phase 4: each kernel at the main paths' full-size inputs, then the main
    # paths, each with its launch counts set to 0 just before and read just
    # after
    a64 = torch.from_numpy(phi_matrix(rng, FULL, FULL, 0.5)).cuda()
    b64 = torch.from_numpy(phi_matrix(rng, FULL, FULL, 0.5)).cuda()
    full_size_cases(a64, b64)
    log(f"kernels vs plain, all bit-equal, full size included: {CASES}")
    main_launches = {dt: real_main_path(a64.to(dt), b64.to(dt), nu, "INT8")
                     for dt, nu in PATHS}
    log_phase("phase 4 (INT8 real paths)")
    full_size_probe_cases(a64, b64)
    log(f"probe kernels bit-equal at the DGEMM path's inputs: {CASES}")
    log_phase("phase 4 (probe kernels at the DGEMM path's inputs)")
    full_size_fp8_cases(a64, b64)
    log(f"kernels vs plain, all bit-equal, FP8 full size included: {CASES}")
    fp8_launches = {dt: real_main_path(a64.to(dt), b64.to(dt), nu, "FP8")
                    for dt, nu in FP8_PATHS}
    log_phase("phase 4 (FP8 real paths)")
    small_accuracy_case(rng)
    # the complex paths: A and B with the real operands as their real parts
    A = torch.complex(a64, torch.from_numpy(
        phi_matrix(crng, FULL, FULL, 0.5)).cuda())
    B = torch.complex(b64, torch.from_numpy(
        phi_matrix(crng, FULL, FULL, 0.5)).cuda())
    full_size_complex_cases(A, B)
    log(f"kernels vs plain, all bit-equal, complex full size included: {CASES}")
    complex_launches = complex_main_paths(A, B)
    log_phase("phase 4 (complex paths)")
    # complex FP8 on the same operands: each kernel at its paths' inputs,
    # then the paths; and compare's Ozaki-I baseline
    full_size_complex_fp8_cases(A, B)
    log(f"kernels vs plain, all bit-equal, complex FP8 full size included: "
        f"{CASES}")
    complex_fp8_main_paths(A, B)
    log_phase("phase 4 (complex FP8 paths)")
    os1_path(a64, b64, card)
    log_phase("phase 4 (compare.matmul_os1_int8)")
    # accurate mode, syrk and gemm_batched on the same operands: each kernel
    # at their inputs, then the paths
    full_size_accurate_cases(a64, b64, A, B)
    log(f"kernels vs plain, all bit-equal, accurate full size included: "
        f"{CASES}")
    accurate_runs = accurate_paths(a64, b64, A, B)
    log_phase("phase 4 (accurate paths, syrk, gemm_batched)")
    # the entry points over those kernels, each through the call a user makes
    precomputed_paths(a64, b64, card)
    log_phase("phase 4 (precomputed operands)")
    blocked_paths(a64, b64, card)
    log_phase("phase 4 (striped path)")
    phases_paths(a64, b64, card)
    log_phase("phase 4 (gemm_with_phases)")
    compat_paths(a64, b64, card)
    log_phase("phase 4 (compat)")
    interposer_paths(a64, b64, A, B, card)
    log_phase("phase 4 (interposer)")
    # the solvers, qr and eig over those kernels, at full size
    sx = solver_operands()
    caps = solver_paths(sx)
    log_phase("phase 4 (solvers, qr, eig)")
    # SUMMA over a device mesh: a 1x1 NCCL mesh at full width, then a 2x2
    # mesh of four processes sharing the card over gloo
    torch.cuda.empty_cache()
    summa_paths(a64, b64, A, B)
    log_phase("phase 4 (SUMMA, 1x1 NCCL mesh)")
    summa_mesh_2x2(card)
    log_phase("phase 4 (SUMMA, 2x2 mesh of four processes)")
    # the examples and the benchmark probes, each through the calls a user
    # makes (distributed_summa on the world of one the SUMMA parts started)
    torch.cuda.empty_cache()
    example_paths()
    log_phase("phase 4 (examples)")
    bench = benchmark_paths(card)
    torch.cuda.empty_cache()
    log_phase("phase 4 (benchmarks)")
    # the device stress sweep and the rank-2k probe, each through the calls
    # a user makes
    stress_paths(card)
    log_phase("phase 4 (device stress sweep)")
    blas3_path(card)
    torch.cuda.empty_cache()
    log_phase("phase 4 (blas3_perf)")

    # phase 5: the card against the CPU path, bit for bit
    n_cpu = card_vs_cpu(rng)
    n_cpu += complex_card_vs_cpu(crng)
    n_cpu += fp8_card_vs_cpu(frng)
    # the accurate-mode cases added with it, on a stream of their own
    n_cpu += accurate_card_vs_cpu(np.random.default_rng(SEED + 9))
    # and the entry points', on another (SEED + 10 seeds K3's ragged cases)
    n_cpu += entry_card_vs_cpu(np.random.default_rng(SEED + 11))
    # and complex FP8, blas3 and compare, on another (SEED + 15 seeds the
    # complex FP8 kernel cases)
    n_cpu += complex_fp8_card_vs_cpu(np.random.default_rng(SEED + 16))
    log(f"card vs cpu: {n_cpu} cases bit-equal")
    log_phase("phase 5 (card vs cpu, the product paths)")
    # and the solvers' (within a tolerance, their emulated stage bit for
    # bit), on another
    n_solver = solver_card_vs_cpu(np.random.default_rng(SEED + 17), caps)
    log(f"solvers card vs cpu: {n_solver} cases")
    del caps
    # and SUMMA's, on another (SEED + 18 seeds the solver operands)
    n_summa = summa_card_vs_cpu(np.random.default_rng(SEED + 19))
    log(f"summa card vs cpu: {n_summa} cases bit-equal")
    log_phase("phase 5 (card vs cpu)")
    # and the examples' and the accuracy sweep's (their own seeds)
    n_examples = example_card_vs_cpu(bench)
    log(f"examples and accuracy sweep card vs cpu: {n_examples} cases")
    log_phase("phase 5 (examples and benchmarks card vs cpu)")
    # and the piece-wise CRT's, on the 8192^3 paths' own residues
    n_crt = crt_limbs_card_vs_cpu(a64, b64, card)
    log(f"crt_limbs card vs cpu: {n_crt} cases bit-equal")
    log_phase("phase 5 (crt_limbs card vs cpu)")

    # phase 6: times; the solvers' first, so that their operands and
    # outputs are freed before the big products run
    solver_times(sx, card)
    log_phase("phase 6 (solver times)")
    del sx
    SOLVER_CALLS.clear()
    torch.cuda.empty_cache()
    summa_times(a64, b64, card)
    log_phase("phase 6 (SUMMA times)")
    timing = {}
    for dt, nu in PATHS:
        a, b = a64.to(dt), b64.to(dt)
        sa = quantize.shift_fast(a, nu, "INT8", 1)
        sb = quantize.shift_fast(b, nu, "INT8", 0)
        ap = kernels.encode_planes(a, sa, 0, nu, "INT8")
        bp = kernels.encode_planes(b, sb, 1, nu, "INT8")
        c_hi = core.residue_matmul(ap, bp)
        out_bits = 53 if dt == torch.float64 else 24
        t = dict(
            shifts_ms=cuda_ms(lambda: (quantize.shift_fast(a, nu, "INT8", 1),
                                       quantize.shift_fast(b, nu, "INT8", 0))),
            encode_a_ms=cuda_ms(lambda: kernels.encode_planes(a, sa, 0, nu,
                                                              "INT8")),
            encode_b_ms=cuda_ms(lambda: kernels.encode_planes(b, sb, 1, nu,
                                                              "INT8")),
            products_ms=cuda_ms(lambda: core.residue_matmul(ap, bp)),
            epilogue_ms=cuda_ms(lambda: kernels.fused_epilogue(
                c_hi, sa, sb, nu, "INT8", dt)),
            library_ms=cuda_ms(lambda: torch.matmul(a, b)),
            encode_plain_ms=cuda_ms(lambda: kernels.encode_planes_plain(
                a, sa, 0, nu, "INT8"), reps=3),
            epilogue_plain_ms=cuda_ms(lambda: kernels.fused_epilogue_plain(
                c_hi, sa, sb, nu, "INT8", dt), reps=3),
        )
        # the whole call: 10 runs, median and quartiles (run-to-run spread)
        runs = cuda_times(lambda: gt.gemm(a, b, num_moduli=nu), reps=10)
        q1, q2, q3 = statistics.quantiles(runs, n=4)
        t["gemm_ms"], t["gemm_ms_q1"], t["gemm_ms_q3"] = q2, q1, q3
        flops = 2.0 * FULL ** 3
        t["emulated_tflops"] = flops / (t["gemm_ms"] * 1e-3) / 1e12
        t["library_tflops"] = flops / (t["library_ms"] * 1e-3) / 1e12
        t["products_tops"] = nu * flops / (t["products_ms"] * 1e-3) / 1e12
        epi_bytes = FULL * FULL * (4 * nu + a.element_size())
        t["epilogue_tbps"] = epi_bytes / (t["epilogue_ms"] * 1e-3) / 1e12
        check(t["products_tops"] * 1e12 <= PEAK_INT8_OPS,
              f"int8 products at {t['products_tops']:.0f} TOPS exceed peak")
        check(t["epilogue_tbps"] * 1e12 <= PEAK_BYTES,
              f"epilogue at {t['epilogue_tbps']:.2f} TB/s exceeds peak")
        t["products_bound_ms"] = nu * flops / PEAK_INT8_OPS * 1e3
        t["encode_bound"] = encode_bound(FULL, FULL, nu, a.element_size())
        t["epilogue_bound"] = epilogue_bound(FULL, FULL, nu, out_bits)
        timing[dt] = t
        log(f"times {card} | {dt} 8192^3 nu={nu}: " + ", ".join(
            f"{k_} {v:.4f}" if isinstance(v, float) else f"{k_} {v}"
            for k_, v in t.items()))
        del ap, bp, c_hi
    ftiming = {dt: fp8_times(dt, nu, a64.to(dt), b64.to(dt), card)
               for dt, nu in FP8_PATHS}
    ctiming = {p[0]: complex_times(*p[:4], A, B, card) for p in CPATHS}
    cftiming = {name: complex_fp8_times(name, dt, nu, A, B, card)
                for name, dt, nu, fastmode, _ in CFP8_PATHS if fastmode}
    accu = CFP8_PATHS[3]
    za, zb = A.to(accu[1]), B.to(accu[1])
    cftiming[accu[0]] = dict(gemm_ms=statistics.median(cuda_times(
        lambda: gt.gemm(za, zb, num_moduli=accu[2], backend="FP8",
                        fastmode=False), reps=10)))
    del za, zb
    atiming = accurate_times(a64, b64, A, B, card)
    for name, *_, fastmode, _ in APATHS:
        t, gain = atiming[name], accurate_runs[name][1]
        log(f"headline {card}: {name} {t['gemm_ms']:.3f} ms "
            f"({t['emulated_tflops']:.3f} TF/s)"
            + (f", fast call {t['fast_ms']:.3f} ms, shifts: extract "
               f"{t['extract_ms']:.3f} + estimate {t['estimate_ms']:.3f} + "
               f"combine {t['combine_ms']:.3f} ms against the fast shifts' "
               f"{t['fast_shifts_ms']:.3f}, shift gain {gain:.3f} bits"
               if fastmode is False else "")
            + f", torch.matmul {t['library_ms']:.3f} ms")
    for name, *_ in CPATHS:
        t = ctiming[name]
        log(f"headline {card}: {name} 8192^3 {t['emulated_tflops']:.3f} TF/s "
            f"({t['gemm_ms']:.3f} ms), torch.matmul "
            f"{t['library_tflops']:.3f} TF/s ({t['library_ms']:.3f} ms)")
    for name, _, nu, _, _ in CFP8_PATHS[:3]:
        t = cftiming[name]
        log(f"headline {card}: {name} 8192^3 {t['emulated_tflops']:.3f} TF/s "
            f"({t['gemm_ms']:.3f} ms; q1 {t['gemm_ms_q1']:.3f}, q3 "
            f"{t['gemm_ms_q3']:.3f}), {9 * nu} FP8 products "
            f"{t['products_ms']:.3f} ms, torch.matmul "
            f"{t['library_tflops']:.3f} TF/s ({t['library_ms']:.3f} ms)")
    log(f"headline {card}: {accu[0]} 8192^3 "
        f"{cftiming[accu[0]]['gemm_ms']:.3f} ms (fast call "
        f"{cftiming['zgemm_fp8_14']['gemm_ms']:.3f} ms)")
    t64 = timing[torch.float64]
    log(f"headline {card}: emulated DGEMM 8192^3 nu=16 "
        f"{t64['emulated_tflops']:.3f} TF/s ({t64['gemm_ms']:.3f} ms), "
        f"torch.matmul f64 {t64['library_tflops']:.3f} TF/s "
        f"({t64['library_ms']:.3f} ms); emulated SGEMM 8192^3 nu=8 "
        f"{timing[torch.float32]['emulated_tflops']:.3f} TF/s")
    for dt, nu in FP8_PATHS:
        t = ftiming[dt]
        log(f"headline {card}: FP8 {TAG[dt]} 8192^3 nu={nu} "
            f"{t['emulated_tflops']:.3f} TF/s ({t['gemm_ms']:.3f} ms), "
            f"{3 * nu} FP8 products {t['products_ms']:.3f} ms "
            f"({t['products_tops']:.1f} TOPS), torch.matmul "
            f"{t['library_tflops']:.3f} TF/s")
    log(json.dumps({"fp8_products_exact_chunks": fp8_exact}))
    probe_runs = probe_paths()
    ptiming = probe_times(a64, b64, card)
    log_phase("phase 6 (times)")

    # one entry per kernel and main path: launches are that path's own gemm
    # call's, times and bounds are at that path's shapes
    kern = []
    for dt, nu in PATHS:
        t, tag = timing[dt], TAG[dt]
        kern += [
            dict(name=f"encode_planes[{tag}]", route="cuda",
                 source="gemmul8_tpu_torch/csrc/encode.cu",
                 replaces="gemmul8_tpu/pallas_kernels.py:141",
                 launches=main_launches[dt]["encode_planes"],
                 max_abs_err=MAX_ABS_ERR[f"encode_planes[{tag}]"],
                 cases=CASES[f"encode_planes[{tag}]"], ms=t["encode_a_ms"],
                 plain_ms=t["encode_plain_ms"], bound_ms=t["encode_bound"][0],
                 bound_by=t["encode_bound"][1], library_ms=None,
                 path=f"gemm {tag} 8192^3 nu={nu}",
                 shape=f"A 8192x8192 {tag}, nu={nu}"),
            dict(name=f"fused_epilogue[{tag}]", route="cuda",
                 source="gemmul8_tpu_torch/csrc/epilogue.cu",
                 replaces="gemmul8_tpu/pallas_kernels.py:399",
                 launches=main_launches[dt]["fused_epilogue"],
                 max_abs_err=MAX_ABS_ERR[f"fused_epilogue[{tag}]"],
                 cases=CASES[f"fused_epilogue[{tag}]"], ms=t["epilogue_ms"],
                 plain_ms=t["epilogue_plain_ms"],
                 bound_ms=t["epilogue_bound"][0],
                 bound_by=t["epilogue_bound"][1], library_ms=None,
                 path=f"gemm {tag} 8192^3 nu={nu}",
                 shape=f"C_hi {nu}x8192x8192 int32 -> {tag}"),
        ]
    for dt, nu in FP8_PATHS:
        t, tag = ftiming[dt], TAG[dt]
        fp8_entry = dict(route="cuda", library_ms=None,
                         path=f"gemm {tag} 8192^3 nu={nu} backend=FP8")
        kern += [
            dict(fp8_entry, name=f"encode_planes_fp8[{tag}]",
                 source="gemmul8_tpu_torch/csrc/encode_fp8.cu",
                 replaces="gemmul8_tpu/pallas_kernels.py:749",
                 launches=fp8_launches[dt]["encode_planes_fp8"],
                 max_abs_err=MAX_ABS_ERR[f"encode_planes_fp8[{tag}]"],
                 cases=CASES[f"encode_planes_fp8[{tag}]"], ms=t["k6_a_ms"],
                 plain_ms=t["k6_plain_ms"], bound_ms=t["k6_bound"][0],
                 bound_by=t["k6_bound"][1], ms_b=t["k6_b_ms"],
                 bound_b_ms=t["k6_bound_b"][0],
                 shape=f"A 8192x8192 {tag} -> {3 * nu}x8192x8192 e4m3"),
            dict(fp8_entry, name=f"fused_epilogue_fp8[{tag}]",
                 source="gemmul8_tpu_torch/csrc/epilogue_fp8.cu",
                 replaces="gemmul8_tpu/pallas_kernels.py:494",
                 launches=fp8_launches[dt]["fused_epilogue_fp8"],
                 max_abs_err=MAX_ABS_ERR[f"fused_epilogue_fp8[{tag}]"],
                 cases=CASES[f"fused_epilogue_fp8[{tag}]"], ms=t["k3_ms"],
                 plain_ms=t["k3_plain_ms"], bound_ms=t["k3_bound"][0],
                 bound_by=t["k3_bound"][1],
                 shape=f"C3 {3 * nu}x8192x8192 f32 -> {tag}"),
        ]
    complex_entry = dict(route="cuda", library_ms=None)
    for name, dt, nu, *_ in CPATHS[:2]:           # the two K4 paths
        t, tag = ctiming[name], TAG[dt]
        key = f"fused_epilogue_complex[{tag}]"
        kern.append(dict(
            complex_entry, name=key, source="gemmul8_tpu_torch/csrc/complex.cu",
            replaces="gemmul8_tpu/pallas_kernels.py:595",
            launches=complex_launches[name]["fused_epilogue_complex"],
            max_abs_err=MAX_ABS_ERR[key], cases=CASES[key], ms=t["k4_ms"],
            plain_ms=t["k4_plain_ms"], bound_ms=t["k4_bound"][0],
            bound_by=t["k4_bound"][1], path=f"gemm {tag} 8192^3 nu={nu}",
            shape=f"C_hi3 {3 * nu}x8192x8192 int32 -> {tag}"))
    t = ctiming["zgemm20"]
    kern += [
        dict(complex_entry, name="fused_recombine_3m[c128 nu=20]",
             source="gemmul8_tpu_torch/csrc/complex.cu",
             replaces="gemmul8_tpu/pallas_kernels.py:655",
             launches=complex_launches["zgemm20"]["fused_recombine_3m"],
             max_abs_err=MAX_ABS_ERR["fused_recombine_3m[c128 nu=20]"],
             cases=CASES["fused_recombine_3m[c128 nu=20]"], ms=t["k5_ms"],
             plain_ms=t["k5_plain_ms"], bound_ms=t["k5_bound"][0],
             bound_by=t["k5_bound"][1], path="gemm c128 8192^3 nu=20",
             shape="C_hi3 60x8192x8192 int32 -> 2 x 20x8192x8192 int8"),
        dict(complex_entry, name="fused_epilogue[c128 nu=20 split]",
             source="gemmul8_tpu_torch/csrc/epilogue.cu",
             replaces="gemmul8_tpu/pallas_kernels.py:399",
             launches=complex_launches["zgemm20"]["fused_epilogue"],
             max_abs_err=MAX_ABS_ERR["fused_epilogue[c128 nu=20 split]"],
             cases=CASES["fused_epilogue[c128 nu=20 split]"], ms=t["k2_ms"],
             plain_ms=t["k2_plain_ms"], bound_ms=t["k2_bound"][0],
             bound_by=t["k2_bound"][1], path="gemm c128 8192^3 nu=20",
             shape="20x8192x8192 int8 -> f64"),
    ]
    kern += complex_fp8_entries(cftiming)
    kern += probe_entries(probe_runs, ptiming)
    # each kernel entry's launches in the accurate paths (and syrk's robust
    # one) of its dtype that run it
    first_entry, first_stress = set(), set()
    for entry in kern:
        key, _, tag = entry["name"].partition("[")
        runs = {name: accurate_runs[name][0][key]
                for name, dt, *_ in APATHS
                if TAG[dt] == tag.rstrip("]")
                and accurate_runs[name][0].get(key)}
        if runs:
            entry["accurate_launches"] = runs
        # and in the entry-point paths of its dtype that run it
        runs = {name: counts[key] for name, (dtag, counts) in
                ENTRY_RUNS.items() if dtag == tag.rstrip("]")
                and counts.get(key)}
        if runs:
            entry["entry_point_launches"] = runs
        # and in the solver calls of its dtype that run it
        runs = {name: counts[key] for name, (dtag, counts) in
                SOLVER_RUNS.items() if dtag == tag.rstrip("]")
                and counts.get(key)}
        if runs:
            entry["solver_launches"] = runs
        # and in the SUMMA calls of phase 4 (1x1 NCCL mesh) that run it
        runs = summa_runs_of(key, tag.rstrip("]"), kern)
        if runs:
            entry["summa_launches"] = runs
        # and in the examples and the benchmark probes of phase 4: each
        # run's launches of the kernel, on the kernel's first entry only
        # (a run mixes dtypes)
        if key not in first_entry:
            first_entry.add(key)
            for field, table in (("example_launches", {
                    n: c for n, (c, _) in EXAMPLE_RUNS.items()}),
                    ("benchmark_launches", BENCH_RUNS)):
                runs = {n: c[key] for n, c in table.items() if c.get(key)}
                if runs:
                    entry[field] = runs
        # and in the stress sweep and the product-route check at its
        # shapes, on the first entry of each launch count
        skey = stress_key(entry["name"])
        if skey not in first_stress:
            first_stress.add(skey)
            runs = {n: c[skey] for n, c in STRESS_RUNS.items() if c.get(skey)}
            if runs:
                entry["stress_launches"] = runs
    log(card)
    log(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
