"""The design choices of the redesigned kernels on the card, each undone in
turn: K2 (csrc/epilogue.cu), K3 (csrc/epilogue_fp8.cu) and K4
(csrc/complex.cu), K6 (csrc/encode_fp8.cu), K8 (csrc/epilogue_mxu.cu) and
K1l (the INT8 lane encoder, csrc/encode.cu).

Each variant rebuilds, from a copy of csrc/ with one edit (VARIANTS), the
sources of SOURCES that the edit reaches (a header reaches every source that
includes it): more warps a block, fewer or more columns a thread (K4),
another number of planes loaded at a time, K4 without its register cap or
K2 with one, the plan's limb count read at run time (K2, K3, K4, K8), the
three-factor f64 descale; K3 with one column a thread, one modulus loaded
at a time, one loop over the moduli with per-modulus selects of their
kind, the int32 reassembly (conversions and wrap_any); K6 with byte
stores, with B staged, with a run-time select per plane, with scalar
conversions; K8 with the probe's f32 wrap, with the descale triples built
per element; K1l with B read directly, as K6c reads it (32 columns a block,
nothing staged).
Every case (CASES: a kernel at m x m on random inputs) is timed with the
shipped build and, in turns, with each variant that rebuilt its source, and
each output is held bit for bit against the shipped kernel's. Also printed:
each variant's registers and spills for the kernels timed, and the shipped
kernels' static instruction mix (cuobjdump -sass).

    python -m gemmul8_tpu_torch.probes.epilogue_tiles
"""
from __future__ import annotations

import collections
import ctypes
import os
import re
import shutil
import subprocess
import tempfile
from typing import NamedTuple

import torch

from .. import kernels, quantize
from .timing import in_turns, require_cuda

# variant: [(source, shipped text, variant text)]
VARIANTS = {
    "shipped": [],
    "8 warps a block": [("crt.cuh", "#define G8_TILE_ROWS 4",
                         "#define G8_TILE_ROWS 8")],
    "K2 8 planes a batch": [("epilogue.cu", "constexpr int kPlanes = 4;",
                             "constexpr int kPlanes = 8;")],
    "K2 capped at 64 registers": [
        ("epilogue.cu", "__launch_bounds__(32 * G8_TILE_ROWS)\n",
         "__launch_bounds__(32 * G8_TILE_ROWS, 8)\n")],
    "K4 1 column": [("complex.cu", "constexpr int kCols = 2;",
                     "constexpr int kCols = 1;")],
    "K4 4 columns": [("complex.cu", "constexpr int kCols = 2;",
                      "constexpr int kCols = 4;")],
    "K4 2 moduli a batch": [("complex.cu", "constexpr int kMods = 4;",
                             "constexpr int kMods = 2;")],
    "K4 no register cap": [("complex.cu",
                            "constexpr int kMinBlocks = 28 / G8_TILE_ROWS;",
                            "constexpr int kMinBlocks = 1;")],
    "run-time limb count": [
        (src, "constexpr LimbCount<L> nl{};", "const int nl = plan.L;")
        for src in ("epilogue.cu", "complex.cu")] + [
        (src, "constexpr LimbCount<L> nl{};", "const int nl = plan.crt.L;")
        for src in ("epilogue_fp8.cu", "epilogue_mxu.cu")],
    "K3 1 column": [("epilogue_fp8.cu", "constexpr int kCols = 4;",
                     "constexpr int kCols = 1;")],
    "K3 1 modulus a batch": [("epilogue_fp8.cu", "constexpr int kMods = 2;",
                              "constexpr int kMods = 1;")],
    "K3 one loop, per-modulus selects": [
        ("epilogue_fp8.cu", "constexpr bool kTwoLoops = true;",
         "constexpr bool kTwoLoops = false;")],
    "K3 int32 reassembly": [("epilogue_fp8.cu",
                             "constexpr bool kF32Wrap = true;",
                             "constexpr bool kF32Wrap = false;")],
    "three-factor f64 descale": [
        ("crt.cuh", "    if (plan.base - ss < G8_DIRECT_LO",
         "    if (true || plan.base - ss < G8_DIRECT_LO")],
    "K6 byte stores": [("encode_fp8.cu", "if (word && valid == 4) {",
                        "if (false) {")],
    "K6 B staged through shared memory": [
        ("encode_fp8.cu", "static constexpr bool kStageB = false;",
         "static constexpr bool kStageB = true;")],
    "K6 run-time plane selects": [("encode_fp8.cu",
                                   "constexpr bool kPlaneMap = true;",
                                   "constexpr bool kPlaneMap = false;")],
    "K6 scalar conversions": [("encode_fp8.cu",
                               "constexpr bool kPackedCvt = true;",
                               "constexpr bool kPackedCvt = false;")],
    "K8 f32 wrap": [("epilogue_mxu.cu", "constexpr bool kExactWrap = true;",
                     "constexpr bool kExactWrap = false;")],
    "K8 no register cap": [("epilogue_mxu.cu",
                            "constexpr int kMinBlocks = 6;",
                            "constexpr int kMinBlocks = 1;")],
    "K8 capped at 64 registers": [("epilogue_mxu.cu",
                                   "constexpr int kMinBlocks = 6;",
                                   "constexpr int kMinBlocks = 8;")],
    "K8 descale triples per element": [
        ("epilogue_mxu.cu", "constexpr bool kHoistDescale = true;",
         "constexpr bool kHoistDescale = false;")],
    "K1l B read directly": [
        ("encode.cu", "    static constexpr bool kStageB = true;\n"
                      "    static constexpr int kInputs = 2;",
         "    static constexpr bool kStageB = false;\n"
         "    static constexpr int kInputs = 2;")],
}


class Case(NamedTuple):
    """A kernel timed at m x m: its wrapper in kernels (K1l: its C entry
    point's name), nu, the input dtype, `arg` (the output dtype of K2, K3
    and K4, the side's scale axis of K6 and K1l, the out_bits of K8) and a
    regular expression of its mangled name in the build log: [input type,]
    f64 out, vec, [stride,] limb count."""
    kernel: str
    nu: int
    dtype: torch.dtype
    arg: object
    part: str


CASES = {
    "K2 int32 -> f64, nu=16": Case("fused_epilogue", 16, torch.int32,
                                   torch.float64,
                                   "epilogue_kernelIiLb1ELb1ELi7E"),
    "K2 int32 -> f32, nu=8": Case("fused_epilogue", 8, torch.int32,
                                  torch.float32,
                                  "epilogue_kernelIiLb0ELb1ELi5E"),
    "K2 int8 -> f64, nu=20": Case("fused_epilogue", 20, torch.int8,
                                  torch.float64,
                                  "epilogue_kernelIaLb1ELb1ELi7E"),
    "K3 f64 nu=14": Case("fused_epilogue_fp8", 14, torch.float32,
                         torch.float64, "epilogue_fp8_kernelILb1ELb1ELi7E"),
    "K3 f32 nu=7": Case("fused_epilogue_fp8", 7, torch.float32, torch.float32,
                        "epilogue_fp8_kernelILb0ELb1ELi5E"),
    "K4 -> c128, nu=16": Case("fused_epilogue_complex", 16, torch.int32,
                              torch.complex128,
                              "complex_kernelILb1ELb1ELi2ELi7E"),
    "K4 -> c64, nu=8": Case("fused_epilogue_complex", 8, torch.int32,
                            torch.complex64,
                            "complex_kernelILb0ELb1ELi2ELi5E"),
    "K6 f64 nu=14, A": Case("encode_planes_fp8", 14, torch.float64, 0,
                            "encode_rows_kernel.*Fp8PlanesEdLi5E"),
    "K6 f64 nu=14, B": Case("encode_planes_fp8", 14, torch.float64, 1,
                            "encode_cols_kernel.*Fp8PlanesEdLi5E"),
    "K6 f32 nu=7, A": Case("encode_planes_fp8", 7, torch.float32, 0,
                           "encode_rows_kernel.*Fp8PlanesEfLi3E"),
    "K6 f32 nu=7, B": Case("encode_planes_fp8", 7, torch.float32, 1,
                           "encode_cols_kernel.*Fp8PlanesEfLi3E"),
    "K8 nu=16, out_bits 53": Case("fused_epilogue_mxu", 16, torch.int32, 53,
                                  "epilogue_mxu_kernelILb1ELi7E"),
    "K1l f64 nu=16, A": Case("encode_lanes", 16, torch.float64, 0,
                             "encode_rows_kernel.*Int8LanesEdLi5E"),
    "K1l f64 nu=16, B": Case("encode_lanes", 16, torch.float64, 1,
                             "encode_cols_kernel.*Int8LanesEdLi5E"),
    "K1l f32 nu=8, B": Case("encode_lanes", 8, torch.float32, 1,
                            "encode_cols_kernel.*Int8LanesEfLi3E"),
}
# each kernel's source
SOURCE_OF = {"fused_epilogue": "epilogue.cu",
             "fused_epilogue_fp8": "epilogue_fp8.cu",
             "fused_epilogue_complex": "complex.cu",
             "encode_planes_fp8": "encode_fp8.cu",
             "fused_epilogue_mxu": "epilogue_mxu.cu",
             "encode_lanes": "encode.cu"}
SOURCES = tuple(SOURCE_OF.values())


def variant_sources(edits: list, dst: str) -> None:
    """csrc/ copied to dst with the edits applied; each shipped text must
    occur exactly once in its source."""
    shutil.copytree(kernels._CSRC, dst)
    for name, old, new in edits:
        path = os.path.join(dst, name)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise ValueError(f"{name}: {old!r} occurs {text.count(old)} times")
        with open(path, "w") as f:
            f.write(text.replace(old, new))


def _includes(name: str) -> set:
    """The files of csrc/ that name includes, itself and transitively."""
    seen, todo = set(), [name]
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.add(f)
        with open(os.path.join(kernels._CSRC, f)) as fh:
            todo += re.findall(r'#include "([^"]+)"', fh.read())
    return seen


def variant_builds(edits: list) -> tuple:
    """The sources of SOURCES a variant rebuilds: all for the shipped
    build, else those that include an edited file."""
    edited = {name for name, _, _ in edits}
    return tuple(s for s in SOURCES if not edits or edited & _includes(s))


def _build(root: str) -> dict:
    """Each variant's library of the sources it rebuilds, all nvcc started
    together; returns {variant: (ctypes library, ptxas report, sources)}."""
    nvcc = kernels._nvcc()
    procs = {}
    for name, edits in VARIANTS.items():
        d = os.path.join(root, str(len(procs)))
        variant_sources(edits, d)
        srcs = variant_builds(edits)
        procs[name] = (d, srcs, subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, *kernels.PTXAS_FLAGS, "-shared", "-o",
             os.path.join(d, "lib.so"), *(os.path.join(d, s) for s in srcs)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (d, srcs, p) in procs.items():
        err = p.communicate()[1]
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc failed:\n{err}")
        lib = ctypes.CDLL(os.path.join(d, "lib.so"))
        for kernel, src in SOURCE_OF.items():
            if src in srcs:
                fn = getattr(lib, "g8_" + kernel)
                fn.argtypes = kernels._ARGTYPES[kernel]
                fn.restype = ctypes.c_int
        libs[name] = (lib, kernels.ptxas_report(err), srcs)
    return libs


def _inputs(case: Case, m: int, g: torch.Generator):
    """The case's random inputs at m x m: (x, sft) for K6, (stack, sft_a,
    sft_b) for the epilogues; K3's stack holds integer lane products of
    |C| <= 2^24 in f32."""
    if case.kernel == "encode_planes_fp8":
        x = torch.randn((m, m), dtype=case.dtype, device="cuda", generator=g)
        return x, quantize.shift_fast(x, case.nu, "FP8", 1 - case.arg)
    if case.kernel == "encode_lanes":
        re, im = (torch.randn((m, m), dtype=case.dtype, device="cuda",
                              generator=g) for _ in range(2))
        return re, im, quantize.shift_fast(re, case.nu, "INT8", 1 - case.arg,
                                           im=im)
    sa, sb = (torch.randint(-40, 90, (m,), dtype=torch.int32, device="cuda",
                            generator=g) for _ in range(2))
    if case.kernel == "fused_epilogue_fp8":
        x = torch.randint(-2 ** 24, 2 ** 24 + 1, (3 * case.nu, m, m),
                          dtype=torch.float32, device="cuda", generator=g)
        return x, sa, sb
    planes = 3 * case.nu if case.kernel == "fused_epilogue_complex" \
        else case.nu
    lo, hi = (-128, 128) if case.dtype == torch.int8 else (-2**31, 2**31)
    x = torch.randint(lo, hi, (planes, m, m), dtype=case.dtype, device="cuda",
                      generator=g)
    return x, sa, sb


def _shipped(case: Case, inputs):
    """The case's output from the shipped wrapper."""
    if case.kernel == "encode_lanes":
        re, im, sft = inputs
        return kernels.encode_planes(re, sft, case.arg, case.nu, "INT8", im=im)
    wrapper = getattr(kernels, case.kernel)
    if case.kernel == "encode_planes_fp8":
        return wrapper(*inputs, case.arg, case.nu)
    if case.kernel == "fused_epilogue_fp8":
        return wrapper(*inputs, case.nu, case.arg)
    return wrapper(*inputs, case.nu, "INT8", case.arg)


def _launcher(lib, case: Case, inputs):
    """fn() launching the case's kernel from lib into a fresh output, as the
    wrapper does on whole-vector operands."""
    kernel, nu = case.kernel, case.nu
    c = inputs[0]
    stream = kernels._stream(c)
    if kernel == "encode_planes_fp8":
        x, sft = inputs
        axis = case.arg
        plan = kernels._encode_plan_fp8(nu, "lhs" if axis == 0 else "rhs")

        def fn():
            out = kernels.plane_buffer((3 * nu,), *x.shape, axis, x.device,
                                       torch.float8_e4m3fn)
            return out, lib.g8_encode_planes_fp8(
                x.data_ptr(), sft.data_ptr(), out.data_ptr(),
                ctypes.addressof(plan), int(x.dtype == torch.float64), axis,
                *x.shape, 1, stream)
    elif kernel == "encode_lanes":
        re, im, sft = inputs
        axis = case.arg
        plan = kernels._encode_plan(nu, "INT8")

        def fn():
            out = kernels.plane_buffer((3, nu), *re.shape, axis, re.device)
            return out, lib.g8_encode_lanes(
                re.data_ptr(), im.data_ptr(), sft.data_ptr(), out.data_ptr(),
                ctypes.addressof(plan), int(re.dtype == torch.float64), axis,
                *re.shape, 1, 0, stream)
    elif kernel == "fused_epilogue_mxu":
        _, sa, sb = inputs
        m, n = c.shape[1:]
        plan = kernels._epilogue_plan_mxu(nu, "INT8", case.arg)

        def fn():
            hi = torch.empty((m, n), dtype=torch.float32, device=c.device)
            lo = torch.empty_like(hi)
            return (hi, lo), lib.g8_fused_epilogue_mxu(
                c.data_ptr(), sa.data_ptr(), sb.data_ptr(), hi.data_ptr(),
                lo.data_ptr(), m, n, 1, ctypes.addressof(plan), stream)
    elif kernel == "fused_epilogue_fp8":
        _, sa, sb = inputs
        m, n = c.shape[1:]
        out_dtype = case.arg
        f64 = out_dtype == torch.float64
        plan = kernels._epilogue_plan_fp8(nu, 53 if f64 else 24)

        def fn():
            out = torch.empty((m, n), dtype=out_dtype, device=c.device)
            return out, lib.g8_fused_epilogue_fp8(
                c.data_ptr(), sa.data_ptr(), sb.data_ptr(), out.data_ptr(),
                int(f64), m, n, 1, ctypes.addressof(plan), stream)
    else:
        _, sa, sb = inputs
        m, n = c.shape[1:]
        out_dtype = case.arg
        f64 = kernels.REAL_DTYPE[out_dtype] == torch.float64
        plan = kernels._epilogue_plan(nu, "INT8", 53 if f64 else 24)

        def fn():
            out = torch.empty((m, n), dtype=out_dtype, device=c.device)
            if kernel == "fused_epilogue":
                return out, lib.g8_fused_epilogue(
                    c.data_ptr(), sa.data_ptr(), sb.data_ptr(),
                    out.data_ptr(), int(c.dtype == torch.int8), int(f64), m,
                    n, 1, ctypes.addressof(plan), stream)
            parts = torch.view_as_real(out)
            return out, lib.g8_fused_epilogue_complex(
                c.data_ptr(), sa.data_ptr(), sb.data_ptr(),
                parts[..., 0].data_ptr(), parts[..., 1].data_ptr(), 2,
                int(f64), m, n, 1, ctypes.addressof(plan), stream)

    def launch():
        out, err = fn()
        if err:
            raise RuntimeError(f"{kernel}: CUDA launch failed with error {err}")
        return out
    return launch


def _bits(x):
    """The raw bits of an output (a tensor, or K8's (hi, lo) pair)."""
    if isinstance(x, tuple):
        return torch.stack([_bits(t) for t in x])
    x = torch.view_as_real(x) if x.is_complex() else x
    return x.view({8: torch.int64, 4: torch.int32,
                   1: torch.uint8}[x.element_size()])


def instruction_mix(lib_path: str, names: list) -> dict:
    """{name pattern: Counter of opcodes} of the kernels whose mangled names
    match a pattern, from cuobjdump -sass (static counts)."""
    tool = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    mix = {}
    for fun in re.split(r"\n\s+Function : ", sass)[1:]:
        for part in names:
            if re.search(part, fun.split("\n", 1)[0]):
                mix[part] = collections.Counter(
                    m.group(1).split(".")[0] for m in re.finditer(
                        r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                        fun))
    return mix


def main(m=8192, seed=0, reps=5):
    """Every case with the shipped build and each variant that rebuilt its
    source; returns the rows (case, variant, ms, ok)."""
    require_cuda("probes.epilogue_tiles")
    print("device:", torch.cuda.get_device_name(0), flush=True)
    os.makedirs(kernels._BUILD, exist_ok=True)
    rows = []
    with tempfile.TemporaryDirectory(dir=kernels._BUILD) as root:
        libs = _build(root)
        for name, (_, report, srcs) in libs.items():
            regs = {c: next((r, st, ld) for k, r, st, ld in report
                            if re.search(case.part, k))
                    for c, case in CASES.items()
                    if SOURCE_OF[case.kernel] in srcs}
            print(f"{name}: registers, spill bytes stored/loaded: " + "; ".join(
                f"{c} {r} {st}/{ld}" for c, (r, st, ld) in regs.items()),
                flush=True)
        mix = instruction_mix(os.path.join(root, "0", "lib.so"),
                              [case.part for case in CASES.values()])
        for c, case in CASES.items():
            ops = mix[case.part]
            print(f"shipped {c}: {sum(ops.values())} instructions, "
                  + ", ".join(f"{k} {v}" for k, v in ops.most_common(12)),
                  flush=True)
        g = torch.Generator(device="cuda").manual_seed(seed)
        for c, case in CASES.items():
            inputs = _inputs(case, m, g)
            ref = _bits(_shipped(case, inputs))
            fns = {name: _launcher(lib, case, inputs)
                   for name, (lib, _, srcs) in libs.items()
                   if SOURCE_OF[case.kernel] in srcs}
            times = in_turns(fns, reps=reps)
            for name, fn in fns.items():
                ok = bool(torch.equal(_bits(fn()), ref))
                ms, ms1, ms2 = times[name]
                rows.append(dict(case=c, variant=name, ms=ms, ok=ok))
                print(f"{c:24s} {name:32s} {ms:8.3f} ms (passes {ms1:.3f}, "
                      f"{ms2:.3f})  bit-ok={ok}", flush=True)
            del inputs, ref
            torch.cuda.empty_cache()
    if not all(r["ok"] for r in rows):
        raise AssertionError("probes.epilogue_tiles: a variant differs")
    return rows


if __name__ == "__main__":
    main()
