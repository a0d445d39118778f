"""On-card smoke test of gemmul8_tpu_torch: builds the CUDA kernels, holds each
against its plain PyTorch version bit for bit, drives the main path (real
DGEMM/SGEMM, fast mode, INT8) at 8192^3, checks its accuracy against an
extended-precision oracle and its bits against the package's own CPU path,
and times the kernels, the int8 products and the whole call.

    python3 chip_smoke.py            # needs one CUDA card and nvcc

The last line of standard output is {"ok": true, "device": {...}}; the line
before it is the per-kernel JSON summary. Any failed check raises, so the run
exits non-zero. Without CUDA it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

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
TAG = {torch.float64: "f64", torch.float32: "f32"}


def log(*a):
    print(*a, flush=True)


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


def cuda_ms(fn, reps=5, warmup=1):
    """Median of `reps` CUDA-event timings of fn(), after `warmup` calls."""
    return statistics.median(cuda_times(fn, reps, warmup))


def cuda_times(fn, reps, warmup=1):
    """`reps` CUDA-event timings of fn() in ms, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return times


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


def compare(key, got, ref, what):
    """Hold a kernel's output against its plain version, bit for bit."""
    torch.cuda.synchronize()
    err = 0.0
    # in row blocks, so that the f64 copies of full-size planes stay small
    for g, r in zip(got.reshape(-1, got.shape[-1]).split(2048),
                    ref.reshape(-1, ref.shape[-1]).split(2048)):
        g, r = g.double(), r.double()
        fin = torch.isfinite(g) & torch.isfinite(r)
        if bool(fin.any()):
            err = max(err, float((g - r).abs()[fin].max()))
    MAX_ABS_ERR[key] = max(MAX_ABS_ERR.get(key, 0.0), err)
    CASES[key] = CASES.get(key, 0) + 1
    assert_bits_equal(got, ref, what)


def assert_bits_equal(got, ref, what, extra=""):
    got, ref = got.cpu(), ref.cpu()
    check(got.shape == ref.shape and got.dtype == ref.dtype,
          f"{what}: {got.shape}/{got.dtype} vs {ref.shape}/{ref.dtype}")
    if got.is_floating_point():
        eq = torch.equal(got.view(torch.uint8), ref.view(torch.uint8))
    else:
        eq = torch.equal(got, ref)
    if not eq:
        idx, g, r, n = first_diff(got, ref)
        raise AssertionError(f"{what}: {n} elements differ, first at {idx}: "
                             f"{g!r} vs {r!r}{extra}")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def encode_cases(rng):
    from gemmul8_tpu_torch import kernels, quantize
    for dt, nus in ((np.float64, (8, 16, 20)), (np.float32, (8, 13))):
        for nu in nus:
            for x_np in (phi_matrix(rng, 200, 392, 0.5, dt),
                         phi_matrix(rng, 77, 130, 4.0, dt), edge_corpus(dt)):
                x = torch.from_numpy(x_np).cuda()
                for axis in (0, 1):
                    sft = quantize.shift_fast(x, nu, "INT8", 1 - axis)
                    compare(f"encode_planes[{TAG[x.dtype]}]",
                            kernels.encode_planes(x, sft, axis, nu, "INT8"),
                            kernels.encode_planes_plain(x, sft, axis, nu,
                                                        "INT8"),
                            f"encode {x.dtype} {tuple(x.shape)} nu={nu} "
                            f"axis={axis}")


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


# ---------------------------------------------------------------------------
# bounds
# ---------------------------------------------------------------------------

# The operation counts below are what each function needs per element, not
# what the kernels happen to issue: a modulus is a compile-time constant, so a
# reduction by it is a multiply-high, a shift, a multiply-add and a floor
# correction (4), and work that depends only on a row's or a column's shift is
# done once per row or column (negligible at 8192^2, left out).

def _moduli_ops(nu, per_modulus, per_pow2):
    from gemmul8_tpu_torch import tables
    return sum(per_pow2 if p == 256 else per_modulus
               for p in tables.moduli("INT8")[:nu])


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


def epilogue_bound(m, n, nu, out_bits):
    """Least time of one epilogue at (m, n). Bytes: nu int32 planes read
    once, the shifts, the output written once. 32-bit operations per
    element: nu loads, two shift loads and the store; per modulus the
    reduction of any int32 (4) and the wrap (2), or a 3-op mask for p = 256,
    and L multiply-adds into the limbs; two carry passes (4 per limb
    boundary); the quotient from the top three limbs (3 conversions, 2
    multiply-adds, the multiply by 1/P, rint, the conversion back: 8); the
    fold (L multiply-adds); the emit, per limb: f32 out, a conversion, seven
    multiplies and two_sum's six operations (14), the final add (1); f64 out,
    the limb's exponent, its floor split by 3 and by 2 and three exponent
    assemblies (13). f64 operations per element (f64 out): per limb a
    conversion, three multiplies and an add (5)."""
    from gemmul8_tpu_torch import ff
    L = ff.limb_plan(nu, "INT8", out_bits)[1]
    f64 = out_bits == 53
    ops32 = (nu + 3 + _moduli_ops(nu, 6, 3) + nu * L + 8 * (L - 1) + 8 + L
             + (13 * L if f64 else 14 * L + 1))
    ops64 = 5 * L if f64 else 0
    bytes_ = m * n * (4 * nu + (8 if f64 else 4)) + 4 * (m + n)
    return bound(m * n * ops32, m * n * ops64, bytes_)


def bound(ops32, ops64, bytes_):
    """The larger of the operations' and the bytes' least times (ms)."""
    t_ops = max(ops32 / PEAK_OPS32, ops64 / PEAK_OPS64) * 1e3
    t_bytes = bytes_ / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

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

    # phase 3: kernels against their plain versions, bit for bit
    rng = np.random.default_rng(SEED)
    encode_cases(rng)
    epilogue_cases(rng)
    log(f"kernels vs plain, small shapes, all bit-equal: {CASES}")
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
    main_launches = {}
    for dt, nu in PATHS:
        a, b = a64.to(dt), b64.to(dt)
        kernels.reset_launches()
        c = gt.gemm(a, b, num_moduli=nu)
        torch.cuda.synchronize()
        counts = dict(kernels.LAUNCHES)
        check(counts == {"encode_planes": 2, "fused_epilogue": 1},
              f"main path {dt} launches {counts}, want 2 encodes, 1 epilogue")
        main_launches[dt] = counts
        check(c.shape == (FULL, FULL) and c.dtype == dt
              and bool(torch.isfinite(c).all()), f"main path {dt} output")
        a8 = a[:8].cpu().numpy()
        b_np = b.cpu().numpy()
        ref = a8.astype(np.longdouble) @ b_np.astype(np.longdouble)
        err, med = max_median_relerr(c[:8].cpu().numpy(), ref)
        native = torch.matmul(a, b)[:8].cpu().numpy()
        nerr, nmed = max_median_relerr(native, ref)
        # error against the componentwise scale |A||B| (cancellation makes
        # the max relative error of any GEMM grow with k: cuBLAS's own is
        # ~5e-11 here)
        scale = np.abs(a8).astype(np.float64) @ np.abs(b_np).astype(np.float64)
        cw = float(np.max(np.abs(np.asarray(c[:8].cpu().numpy(), np.longdouble)
                                 - ref) / scale))
        log(f"accuracy {dt} nu={nu} rows 0-7: emulated max {err:.3e} median "
            f"{med:.3e} max/|A||B| {cw:.3e}; torch.matmul max {nerr:.3e} "
            f"median {nmed:.3e}")
        if dt == torch.float64:
            check(err <= 2 * nerr and cw < 1e-13,
                  f"f64 error {err} (|A||B|-relative {cw}) vs cuBLAS {nerr}")
        else:
            check(err < nerr, f"f32 error {err} vs cuBLAS f32 {nerr}")
        del c, native
        log(f"main path {dt} nu={nu} launches: {counts}")
    small_accuracy_case(rng)

    # phase 5: the card against the CPU path, bit for bit
    n_cpu = card_vs_cpu(rng)
    log(f"card vs cpu: {n_cpu} cases bit-equal")

    # phase 6: times
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
    t64 = timing[torch.float64]
    log(f"headline {card}: emulated DGEMM 8192^3 nu=16 "
        f"{t64['emulated_tflops']:.3f} TF/s ({t64['gemm_ms']:.3f} ms), "
        f"torch.matmul f64 {t64['library_tflops']:.3f} TF/s "
        f"({t64['library_ms']:.3f} ms); emulated SGEMM 8192^3 nu=8 "
        f"{timing[torch.float32]['emulated_tflops']:.3f} TF/s")

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
    log(card)
    log(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
