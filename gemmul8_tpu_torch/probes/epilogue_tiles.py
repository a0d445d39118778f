"""The design choices of K2 (csrc/epilogue.cu) and K4 (csrc/complex.cu) on
the card, each undone in turn.

Each variant rebuilds the two sources from a copy of csrc/ with one edit
(VARIANTS): more warps a block, fewer or more columns a thread (K4),
another number of planes loaded at a time, K4 without its register cap or
K2 with one, the plan's limb count read at run time, the three-factor f64
descale.
Every variant is timed at m x m on random stacks (CASES) in turns with the
shipped build, and each output is held bit for bit against the shipped
kernel's. Also printed: each variant's registers and spills for the kernels
timed, and the shipped kernels' static instruction mix (cuobjdump -sass).

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

import torch

from .. import kernels
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
        for src in ("epilogue.cu", "complex.cu")],
    "three-factor f64 descale": [
        ("crt.cuh", "    if (plan.base - ss < G8_DIRECT_LO",
         "    if (true || plan.base - ss < G8_DIRECT_LO")],
}
# case: (kernel, nu, input dtype, output dtype, the kernel's mangled name
# part in the build log: input type, f64 out, vec, [stride,] limb count)
CASES = {
    "K2 int32 -> f64, nu=16": ("fused_epilogue", 16, torch.int32,
                               torch.float64, "epilogue_kernelIiLb1ELb1ELi7E"),
    "K2 int32 -> f32, nu=8": ("fused_epilogue", 8, torch.int32, torch.float32,
                              "epilogue_kernelIiLb0ELb1ELi5E"),
    "K2 int8 -> f64, nu=20": ("fused_epilogue", 20, torch.int8, torch.float64,
                              "epilogue_kernelIaLb1ELb1ELi7E"),
    "K4 -> c128, nu=16": ("fused_epilogue_complex", 16, torch.int32,
                          torch.complex128,
                          "complex_kernelILb1ELb1ELi2ELi7E"),
    "K4 -> c64, nu=8": ("fused_epilogue_complex", 8, torch.int32,
                        torch.complex64, "complex_kernelILb0ELb1ELi2ELi5E"),
}
SOURCES = ("epilogue.cu", "complex.cu")


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


def _build(root: str) -> dict:
    """Each variant's library (K2 and K4 only), all nvcc started together;
    returns {variant: (ctypes library, ptxas report)}."""
    nvcc = kernels._nvcc()
    procs = {}
    for name, edits in VARIANTS.items():
        d = os.path.join(root, str(len(procs)))
        variant_sources(edits, d)
        procs[name] = (d, subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, *kernels.PTXAS_FLAGS, "-shared", "-o",
             os.path.join(d, "lib.so"), *(os.path.join(d, s) for s in SOURCES)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (d, p) in procs.items():
        err = p.communicate()[1]
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc failed:\n{err}")
        lib = ctypes.CDLL(os.path.join(d, "lib.so"))
        for fn in ("fused_epilogue", "fused_epilogue_complex"):
            getattr(lib, "g8_" + fn).argtypes = kernels._ARGTYPES[fn]
            getattr(lib, "g8_" + fn).restype = ctypes.c_int
        libs[name] = (lib, kernels.ptxas_report(err))
    return libs


def _launcher(lib, case, c, sa, sb):
    """fn() launching the case's kernel from lib into a fresh output, as the
    wrapper does on whole-vector operands."""
    kernel, nu, _, out_dtype, _ = case
    m, n = c.shape[1:]
    real = kernels.REAL_DTYPE[out_dtype]
    f64 = real == torch.float64
    plan = kernels._epilogue_plan(nu, "INT8", 53 if f64 else 24)
    stream = kernels._stream(c)

    def fn():
        out = torch.empty((m, n), dtype=out_dtype, device=c.device)
        if kernel == "fused_epilogue":
            err = lib.g8_fused_epilogue(
                c.data_ptr(), sa.data_ptr(), sb.data_ptr(), out.data_ptr(),
                int(c.dtype == torch.int8), int(f64), m, n, 1,
                ctypes.addressof(plan), stream)
        else:
            parts = torch.view_as_real(out)
            err = lib.g8_fused_epilogue_complex(
                c.data_ptr(), sa.data_ptr(), sb.data_ptr(),
                parts[..., 0].data_ptr(), parts[..., 1].data_ptr(), 2,
                int(f64), m, n, 1, ctypes.addressof(plan), stream)
        if err:
            raise RuntimeError(f"{kernel}: CUDA launch failed with error {err}")
        return out
    return fn


def _bits(x):
    x = torch.view_as_real(x) if x.is_complex() else x
    return x.view(torch.int64 if x.dtype == torch.float64 else torch.int32)


def instruction_mix(lib_path: str, names: list) -> dict:
    """{name part: Counter of opcodes} of the kernels whose mangled names
    hold a name part, from cuobjdump -sass (static counts)."""
    tool = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    mix = {}
    for fun in re.split(r"\n\s+Function : ", sass)[1:]:
        for part in names:
            if part in fun.split("\n", 1)[0]:
                mix[part] = collections.Counter(
                    m.group(1).split(".")[0] for m in re.finditer(
                        r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                        fun))
    return mix


def main(m=8192, seed=0, reps=5):
    """Every variant on every case; returns the rows (case, variant, ms,
    ok)."""
    require_cuda("probes.epilogue_tiles")
    print("device:", torch.cuda.get_device_name(0), flush=True)
    os.makedirs(kernels._BUILD, exist_ok=True)
    rows = []
    with tempfile.TemporaryDirectory(dir=kernels._BUILD) as root:
        libs = _build(root)
        for name, (_, report) in libs.items():
            regs = {part: next((r, st, ld) for k, r, st, ld in report
                               if part in k) for *_, part in CASES.values()}
            print(f"{name}: registers, spill bytes stored/loaded: " + "; ".join(
                f"{c.split(',')[0]} {regs[case[4]][0]} "
                f"{regs[case[4]][1]}/{regs[case[4]][2]}"
                for c, case in CASES.items()), flush=True)
        mix = instruction_mix(os.path.join(root, "0", "lib.so"),
                              [case[4] for case in CASES.values()])
        for c, case in CASES.items():
            ops = mix[case[4]]
            print(f"shipped {c}: {sum(ops.values())} instructions, "
                  + ", ".join(f"{k} {v}" for k, v in ops.most_common(12)),
                  flush=True)
        g = torch.Generator(device="cuda").manual_seed(seed)
        sa = torch.randint(-40, 90, (m,), dtype=torch.int32, device="cuda",
                           generator=g)
        sb = torch.randint(-40, 90, (m,), dtype=torch.int32, device="cuda",
                           generator=g)
        for c, case in CASES.items():
            kernel, nu, in_dtype, out_dtype, _ = case
            planes = nu if kernel == "fused_epilogue" else 3 * nu
            lo, hi = (-128, 128) if in_dtype == torch.int8 else (-2**31, 2**31)
            x = torch.randint(lo, hi, (planes, m, m), dtype=in_dtype,
                              device="cuda", generator=g)
            wrapper = getattr(kernels, kernel)
            ref = _bits(wrapper(x, sa, sb, nu, "INT8", out_dtype))
            fns = {name: _launcher(lib, case, x, sa, sb)
                   for name, (lib, _) in libs.items()}
            times = in_turns(fns, reps=reps)
            for name, fn in fns.items():
                ok = bool(torch.equal(_bits(fn()), ref))
                ms = times[name][0]
                rows.append(dict(case=c, variant=name, ms=ms, ok=ok))
                print(f"{c:24s} {name:28s} {ms:8.3f} ms  bit-ok={ok}",
                      flush=True)
            del x, ref
            torch.cuda.empty_cache()
    if not all(r["ok"] for r in rows):
        raise AssertionError("probes.epilogue_tiles: a variant differs")
    return rows


if __name__ == "__main__":
    main()
