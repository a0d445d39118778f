"""Hand-written CUDA kernels of the main paths, their wrappers and plain versions.

The counterpart of gemmul8_tpu/pallas_kernels.py:

  shift_fast              csrc/shift.cu         (no Pallas counterpart: the
                          JAX package computes the fast shifts in jnp,
                          gemmul8_tpu/quantize.py; K10, added to take their
                          plain-torch passes and host synchronises off the
                          card's path)
  extract_ub              csrc/extract.cu       (no Pallas counterpart: the
                          JAX package extracts accurate mode's bound
                          planes in jnp, gemmul8_tpu/quantize.py; K11, on
                          K10's frames, its column route after K10's
                          column maxima)
  encode_planes           csrc/encode.cu        replaces encode_planes_tiles;
                          with im=, the lanes of a complex operand (no
                          Pallas counterpart: the JAX package builds the
                          (Re+Im) lane in jnp)
  encode_planes_fp8       csrc/encode_fp8.cu    replaces encode_planes_fp8_tiles
  encode_lanes_fp8        csrc/encode_lanes_fp8.cu  (no Pallas counterpart: the
                          JAX package builds complex FP8 lanes in jnp)
  fused_epilogue          csrc/epilogue.cu      replaces fused_epilogue;
                          with ab=, alpha and beta in its store (no
                          Pallas counterpart: the JAX package applies
                          them in jnp)
  fused_epilogue_fp8      csrc/epilogue_fp8.cu  replaces fused_epilogue_fp8
  fused_epilogue_complex  csrc/complex.cu       replaces fused_epilogue_complex
  fused_recombine_3m      csrc/complex.cu       replaces fused_recombine_3m
  reassemble_fp8          csrc/reassemble_fp8.cu  (no Pallas counterpart:
                          fp8._reassemble, which the JAX package runs in jnp)

and of the int8 product and CRT-epilogue kernels of the probe tools
(tools/probe_fused.py, tools/probe_matmul3.py, tools/probe_epilogue.py;
run by gemmul8_tpu_torch/probes/):

  matmul_i8               csrc/matmul_i8_wgmma.cu (wgmma + TMA); replaces
                          pallas_matmul_i8_seq, pallas_matmul_i8_astat,
                          mm_flat_kloop, mm_flat_fullk,
                          mm_flat_kloop_multidot (and is the main path's
                          int8 product)
  fused_epilogue_mxu      csrc/epilogue_mxu.cu  replaces fused_epilogue_mxu

(the encoders share csrc/encode.cuh's steps, the epilogues csrc/crt.cuh's).

Each wrapper checks its operands, allocates the output with torch.empty,
launches on the current stream, raises if the launch failed and adds one to
LAUNCHES[name]. Beside each wrapper is its plain PyTorch version; the wrapper
takes it only for tensors on the CPU. A CUDA tensor launches the kernel or
raises.

The kernels are built at first use (sm_90a, -fmad=false so that no
multiply-add is contracted; one nvcc per source, all started together, then
one link) into one shared library under gemmul8_tpu_torch/_build/, named by a
hash of the sources and flags, and are bound with ctypes through a plain C
interface.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import json
import os
import re
import shutil
import subprocess
import tempfile
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import ff, fp8, quantize, tables
from .spans import span

# fused_epilogue_ab counts the launches of K2's alpha/beta route, which
# fused_epilogue counts too
LAUNCHES = {"shift_fast": 0, "extract_ub": 0, "encode_planes": 0, "encode_lanes": 0,
            "encode_planes_fp8": 0, "encode_lanes_fp8": 0, "fused_epilogue": 0,
            "fused_epilogue_ab": 0, "fused_epilogue_fp8": 0, "reassemble_fp8": 0,
            "fused_epilogue_complex": 0,
            "fused_recombine_3m": 0, "matmul_i8_wgmma_kloop": 0,
            "matmul_i8_wgmma_astat": 0, "transpose_i8": 0,
            "fused_epilogue_mxu": 0}
_INT8, _FP8 = tables.Backend.INT8, tables.Backend.FP8

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_BUILD = os.path.join(_HERE, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC"]
# every source is compiled with -Xptxas -v: its registers, shared memory and
# spills per kernel go into BUILD_LOG[source] (ptxas_report reads them)
PTXAS_FLAGS = ["-Xptxas", "-v"]
BUILD_LOG: dict[str, str] = {}
_LIB: ctypes.CDLL | None = None
_P, _I = ctypes.c_void_p, ctypes.c_int
_L, _F, _D = ctypes.c_longlong, ctypes.c_float, ctypes.c_double
# the C entry points' signatures (csrc/*.cu)
_ARGTYPES = {
    # x0, x1, out, is_f64, rows, cols, ld, lanes, threads, vec, log2p,
    # invariant, stream
    "shift_rows": [_P, _P, _P, _I, _I, _I, _L, _I, _I, _I, _F, _I, _P],
    # x0, x1, scratch, is_f64, rows, cols, ld, lanes, slice_len, slices, vec,
    # stream
    "shift_cols_max": [_P, _P, _P, _I, _I, _I, _L, _I, _I, _I, _I, _P],
    # x0, x1, scratch, out, is_f64, rows, cols, ld, lanes, slice_len, slices,
    # vec, log2p, invariant, stream
    "shift_cols_sum": [_P, _P, _P, _P, _I, _I, _I, _L, _I, _I, _I, _I, _F,
                       _I, _P],
    # x, plane, pre, is_f64, fp8, rows, cols, ld, threads, vec, max_ufp,
    # stream
    "extract_rows": [_P, _P, _P, _I, _I, _I, _I, _L, _I, _I, _I, _P],
    # x, scratch, plane, pre, is_f64, fp8, rows, cols, ld, slice_len, slices,
    # vec, max_ufp, stream
    "extract_cols": [_P, _P, _P, _P, _I, _I, _I, _I, _L, _I, _I, _I, _I,
                     _P],
    # x, sft, out, plan, is_f64, scale_axis, rows, cols, vec, stream
    "encode_planes": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # re, im, sft, out, plan, is_f64, scale_axis, rows, cols, vec, conj,
    # stream
    "encode_lanes": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # x, sft, out, plan, is_f64, scale_axis, rows, cols, vec, stream
    "encode_planes_fp8": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # re, im, sft, out, plan, is_f64, scale_axis, rows, cols, vec, conj,
    # stream
    "encode_lanes_fp8": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # c_hi, sft_a, sft_b, out, in_i8, out_f64, m, n, vec, plan, stream
    "fused_epilogue": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    # c_hi, sft_a, sft_b, out, c, ldc, mc, nc, cvec, kind, alpha, beta,
    # out_f64, m, n, plan, stream
    "fused_epilogue_ab": [_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _D, _D,
                          _I, _I, _I, _P, _P],
    # c3, sft_a, sft_b, out, out_f64, m, n, vec, plan, stream
    "fused_epilogue_fp8": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    # c3, out, m, n, vec, accumulate, plan, stream
    "reassemble_fp8": [_P, _P, _I, _I, _I, _I, _P, _P],
    # c_hi3, sft_a, sft_b, out_re, out_im, stride, out_f64, m, n, vec, plan,
    # stream
    "fused_epilogue_complex": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
                               _P],
    # c_hi3, out_re, out_im, out_i32, m, n, plan, stream
    "fused_recombine_3m": [_P, _P, _P, _I, _I, _I, _P, _P],
    # a, b (k-contiguous), c, nu, m, n, k, a_row, a_plane, b_row, b_plane
    # (bytes), astat, stream
    "matmul_i8_wgmma": [_P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _L, _I, _P],
    # src (nu, k, n), dst (nu, n, k), nu, k, n, stream
    "transpose_i8": [_P, _P, _I, _I, _I, _P],
    # c_hi, sft_a, sft_b, hi, lo, m, n, vec, plan, stream
    "fused_epilogue_mxu": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P],
}

_MAX_NU = 20        # csrc/common.cuh: G8_MAX_NU
_MAX_NL = 6         # G8_MAX_NL: 20-bit encode limbs
_MAX_L = 7          # G8_MAX_L: 16-bit epilogue limbs
REDUCE_RANGE = 2 ** 31 - 2 ** 11   # G8_REDUCE_RANGE: encode's exact |acc|
# K2's, K3's and K4's tiling (csrc/crt.cuh: Tile): a block of _TILE_ROWS
# warps, a warp on one row, each thread on EPILOGUE_COLS[kernel] consecutive
# columns (csrc/epilogue.cu, csrc/epilogue_fp8.cu and csrc/complex.cu: kCols)
_TILE_ROWS = 4      # G8_TILE_ROWS
EPILOGUE_COLS = {"fused_epilogue": 4, "fused_epilogue_fp8": 4,
                 "fused_epilogue_complex": 2, "reassemble_fp8": 4}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build() -> str:
    """Compile csrc/*.cu into one library unless it is built already (the
    name holds a hash of the sources and flags): one nvcc per source, all
    started together, then one link. Each source's ptxas report is kept
    beside the library (same name, .ptxas.json) and loaded into BUILD_LOG,
    whether this call built it or found it. Returns its path."""
    sources = sorted(n for n in os.listdir(_CSRC) if n.endswith((".cu", ".cuh")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS + PTXAS_FLAGS).encode())
    for name in sources:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    out = os.path.join(_BUILD, f"libgemmul8_kernels_{h.hexdigest()[:16]}.so")
    log = out[:-len(".so")] + ".ptxas.json"
    if os.path.exists(out) and os.path.exists(log):
        with open(log) as f:
            BUILD_LOG.update(json.load(f))
        return out
    os.makedirs(_BUILD, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=_BUILD) as tmp:
        objs, procs = [], []
        for name in sources:
            if name.endswith(".cu"):
                objs.append(os.path.join(tmp, name + ".o"))
                procs.append((name, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, *PTXAS_FLAGS, "-c", "-o", objs[-1],
                     os.path.join(_CSRC, name)],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        reports = {name: p.communicate()[1] for name, p in procs}
        BUILD_LOG.update(reports)
        if any(p.returncode for _, p in procs):
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{name}: {reports[name]}" for name, p in procs
                if p.returncode))
        lib = os.path.join(tmp, "lib.so")
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{proc.stderr}")
        tmp_log = os.path.join(tmp, "ptxas.json")
        with open(tmp_log, "w") as f:
            json.dump(reports, f)
        os.replace(tmp_log, log)      # before the library, which marks a build
        os.replace(lib, out)          # atomic: a half-written .so never loads
    return out


def ptxas_report(text: str) -> list[tuple[str, int, int, int]]:
    """(kernel, registers, spill store bytes, spill load bytes) of each
    entry function in an `nvcc -Xptxas -v` report, in its order."""
    out, name, spills = [], None, (0, 0)
    for line in text.splitlines():
        mo = re.search(r"Compiling entry function '([^']+)'", line)
        if mo:
            name, spills = mo.group(1), (0, 0)
            continue
        mo = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                       line)
        if mo:
            spills = (int(mo.group(1)), int(mo.group(2)))
            continue
        mo = re.search(r"Used (\d+) registers", line)
        if mo and name is not None:
            out.append((name, int(mo.group(1)), *spills))
            name = None
    return out


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, "g8_" + name)
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
        _LIB = lib
    return _LIB


def _launch(name: str, *args, count: str | None = None) -> None:
    """Call the C entry point g8_<name>, raise on its CUDA error, and add one
    to LAUNCHES[count or name]."""
    err = getattr(_lib(), "g8_" + name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    LAUNCHES[count or name] += 1


# ---------------------------------------------------------------------------
# fast-mode shifts (K10): per row or column, one pass over the operand
# ---------------------------------------------------------------------------

SHIFT_VPT = 8            # csrc/shift.cu: kVPT, 16-byte vectors a thread holds
SHIFT_COL_WARPS = 8      # kColWarps: a column block's warps, on every 8th row
_SHIFT_THREADS = (32, 1024)   # a row block's least and most threads
_SHIFT_BLOCKS = 512      # the column route's aim: about four blocks an SM
_SHIFT_SLICE_MIN = 64    # and at least 8 rows a warp in each slice


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def shift_width(dtype: torch.dtype) -> int:
    """Elements in one of K10's 16-byte vectors."""
    return 2 if dtype == torch.float64 else 4


def shift_row_threads(length: int, width: int) -> int:
    """The row route's block size for rows of `length` elements: the power
    of two (32 to 1024) of threads that holds the row in SHIFT_VPT vectors
    each, where one can. It fixes the order of the row's sum."""
    per = _cdiv(_cdiv(length, width), SHIFT_VPT)
    lo, hi = _SHIFT_THREADS
    return min(hi, max(lo, 1 << (per - 1).bit_length()))


def shift_col_slices(length: int, cols: int, width: int) -> tuple[int, int]:
    """The column route's (slice_len, slices): columns of `length` elements
    cut into slices of slice_len rows (a multiple of SHIFT_COL_WARPS), enough
    for about _SHIFT_BLOCKS blocks over the strips of 32 vectors of columns.
    It fixes the order of each column's sum."""
    slices = max(1, min(_cdiv(_SHIFT_BLOCKS, _cdiv(cols, 32 * width)),
                        _cdiv(length, _SHIFT_SLICE_MIN)))
    slice_len = _cdiv(_cdiv(length, slices), SHIFT_COL_WARPS) * SHIFT_COL_WARPS
    return slice_len, _cdiv(length, slice_len)


def shift_scratch_bytes(cols: int, slices: int, width: int) -> int:
    """The column route's scratch (csrc/shift.cu, ColScratch): each slice's
    column maxima (8 bytes) and partial sums (4), and a counter a strip."""
    return slices * cols * 12 + 4 * _cdiv(cols, 32 * width)


def shift_fast_plain(x, num_moduli, backend, reduce_axis,
                     variant="reference", im=None):
    """Plain version of K10: quantize.shift_fast's formula in torch
    operators, in the JAX twin's order of operations (with im, on
    torch.cat([x, im], dim=reduce_axis))."""
    if im is not None:
        x = torch.cat([x, im], dim=reduce_axis)
    z, amax0, E = shift_terms(x, reduce_axis)
    return shift_from_sum(torch.sum(z * z, dim=reduce_axis), amax0, E,
                          num_moduli, backend, variant)


def shift_terms(x, reduce_axis):
    """The first steps of the plain shifts: (z, amax0, E), z the operand
    scaled so that each row's (column's) largest |z| is below 2, whose
    squares the shift sums, amax0 the largest |f32 of the pre-scaled row|
    and E its exponent."""
    q = quantize
    if x.dtype == torch.float64:
        # IEEE f64: |x| may exceed f32's max. Pre-scale only the overflowing
        # rows by an exact power of two and fold the exponent back in after.
        amax_nat = torch.amax(torch.abs(x), dim=reduce_axis)
        E0 = torch.where(amax_nat > 2.0 ** 126,
                         q.ilogb(torch.where(amax_nat > 0, amax_nat,
                                             torch.ones_like(amax_nat))),
                         torch.zeros_like(amax_nat, dtype=torch.int32))
        x = q.pow2_scale(x, -E0.unsqueeze(reduce_axis))
        c0 = torch.abs(x.to(torch.float32))
    else:
        E0 = None
        c0 = torch.abs(x)
    amax0 = torch.amax(c0, dim=reduce_axis)
    safe = torch.where(amax0 > 0, amax0, torch.ones_like(amax0))
    # inflation keeps E an upper bound when the |c1| tail pushes |x| across a
    # power of two (a larger E only shrinks sft: the safe side)
    E_loc = q.ilogb(safe * q._f32(1.0 + 2.0 ** -22, safe))
    E = E_loc + E0 if E0 is not None else E_loc
    # overflow-safe norm: scale the row to ~[0,1] first
    return q.pow2_scale(c0, -E_loc.unsqueeze(reduce_axis)), amax0, E


def shift_from_sum(s2, amax0, E, num_moduli, backend, variant):
    """The last steps of the plain shifts: the shift of each row (column)
    from its f32 sum of squares s2 and shift_terms' amax0 and E."""
    q = quantize

    def f32(v):
        return q._f32(v, s2)

    log2vsum = ((torch.log2(torch.maximum(s2, f32(2.0 ** -120)))
                 + f32(2.0) * E.to(torch.float32))
                + f32(2.0 ** -18))
    log2vnrm = f32(q.LOG2_HALF_RU) * log2vsum
    log2p = f32(tables.log2P(num_moduli, backend))
    if variant == "invariant":
        exp1 = ((log2p - f32(1.5)) - log2vnrm) - f32(q.SFT_MARGIN)
        sft = torch.floor(exp1).to(torch.int32)
    else:
        exp1 = (((log2p - f32(1.5))
                 - torch.maximum(f32(1.0), log2vnrm))
                - f32(q.SFT_MARGIN))
        sft = torch.floor(exp1).to(torch.int32) - E
    return torch.where(amax0 > 0, sft, torch.zeros_like(sft))


def _rows_contiguous(t: torch.Tensor) -> bool:
    return t.stride(1) == 1 or t.shape[1] <= 1


def shift_operands(x, im, reduce_axis):
    """(x, im, reduce_axis) laid out as K10 reads them, each row contiguous
    and im strided as x: a transposed view is read as its transpose along
    the other axis, any other layout is copied."""
    if x.dim() != 2 or (im is not None and im.shape != x.shape):
        return x, im, reduce_axis       # shift_fast refuses them
    pair = (x,) if im is None else (x, im)
    for ts, axis in ((pair, reduce_axis),
                     (tuple(t.T for t in pair), 1 - reduce_axis)):
        if (all(_rows_contiguous(t) for t in ts)
                and all(t.stride() == ts[0].stride() for t in ts)):
            return ts[0], ts[1] if im is not None else None, axis
    return x.contiguous(), None if im is None else im.contiguous(), reduce_axis


def _check_shift(x, im, reduce_axis, variant):
    """The checks K10's wrapper makes, the device last (so that tensors on
    the meta device show each refusal)."""
    if x.dim() != 2 or x.dtype not in (torch.float32, torch.float64):
        raise ValueError("shift_fast: x must be a 2-D f32 or f64 tensor")
    if reduce_axis not in (0, 1):
        raise ValueError("shift_fast: reduce_axis must be 0 or 1")
    if variant not in ("reference", "invariant"):
        raise ValueError("shift_fast: variant must be 'reference' or "
                         f"'invariant', got {variant!r}")
    if im is not None and (im.shape != x.shape or im.dtype != x.dtype
                           or im.device != x.device):
        raise ValueError("shift_fast: im must have x's shape, dtype and "
                         "device")
    if x.shape[reduce_axis] == 0:
        raise ValueError("shift_fast: the reduce axis is empty")
    if x.device.type != "cuda":
        raise ValueError(f"shift_fast: unsupported device {x.device}")


def shift_fast(x: torch.Tensor, num_moduli: int, backend: str,
               reduce_axis: int, variant: str = "reference",
               im: torch.Tensor | None = None) -> torch.Tensor:
    """Fast mode's int32 shift of each row (reduce_axis=1) or column
    (reduce_axis=0) of x, f32 or f64, in either variant; with im, of each
    row (column) of x and im together, as of torch.cat([x, im],
    dim=reduce_axis) (complex_gemm._shift_complex_fast).

    On the card the operands are first laid out as K10 reads them
    (shift_operands). Rows take one launch of K10, columns two; the device
    is never synchronised."""
    if x.device.type == "cpu":
        return shift_fast_plain(x, num_moduli, backend, reduce_axis, variant,
                                im)
    x, im, reduce_axis = shift_operands(x, im, reduce_axis)
    _check_shift(x, im, reduce_axis, variant)
    rows, cols = x.shape
    lanes = 1 if im is None else 2
    n_out, length = ((rows, cols * lanes) if reduce_axis == 1
                     else (cols, rows * lanes))
    out = torch.empty(n_out, dtype=torch.int32, device=x.device)
    if n_out == 0:
        return out
    width = shift_width(x.dtype)
    ld = x.stride(0) if rows > 1 else cols
    x1 = x.data_ptr() if im is None else im.data_ptr()
    vec = (cols % width == 0 and ld % width == 0
           and x.data_ptr() % 16 == 0 and x1 % 16 == 0)
    log2p = float(np.float32(tables.log2P(num_moduli, backend)))
    head = (x.data_ptr(), x1)
    shape = (int(x.dtype == torch.float64), rows, cols, ld, lanes)
    tail = (log2p, int(variant == "invariant"), _stream(x))
    if reduce_axis == 1:
        _launch("shift_rows", *head, out.data_ptr(), *shape,
                shift_row_threads(length, width), int(vec), *tail,
                count="shift_fast")
        return out
    slice_len, slices = shift_col_slices(length, cols, width)
    scratch = torch.empty(shift_scratch_bytes(cols, slices, width),
                          dtype=torch.uint8, device=x.device)
    _launch("shift_cols_max", *head, scratch.data_ptr(), *shape, slice_len,
            slices, int(vec), _stream(x), count="shift_fast")
    _launch("shift_cols_sum", *head, scratch.data_ptr(), out.data_ptr(),
            *shape, slice_len, slices, int(vec), *tail, count="shift_fast")
    return out


# ---------------------------------------------------------------------------
# accurate mode's upper-bound extraction (K11): K10's frames, a bound plane
# ---------------------------------------------------------------------------

def extract_ub_plain(x, backend, scale_axis):
    """Plain version of K11: quantize.extract_ub_plane's torch operators, in
    the JAX twin's order of operations."""
    q = quantize
    reduce_axis = 1 - scale_axis
    ax = torch.abs(x)
    amax = torch.amax(ax, dim=reduce_axis)
    E = q.ilogb(torch.where(amax > 0, amax, torch.ones_like(amax)))
    sft_pre = q.MAX_UFP[backend] - E
    return q.extract_ub_with_pre(ax, sft_pre, reduce_axis, backend), sft_pre


def _check_extract(x, backend, reduce_axis):
    """The checks K11's wrapper makes, the device last (so that tensors on
    the meta device show each refusal)."""
    if x.dim() != 2 or x.dtype not in (torch.float32, torch.float64):
        raise ValueError("extract_ub: x must be a 2-D f32 or f64 tensor")
    if backend not in quantize.MAX_UFP:
        raise ValueError(f"extract_ub: backend must be INT8 or FP8, got "
                         f"{backend!r}")
    if x.shape[reduce_axis] == 0:
        raise ValueError("extract_ub: the reduce axis is empty")
    if x.device.type != "cuda":
        raise ValueError(f"extract_ub: unsupported device {x.device}")


def extract_ub(x: torch.Tensor, backend: str, scale_axis: int):
    """Accurate mode's (bound plane, int32 pre-shift) of each row
    (scale_axis=0) or column (scale_axis=1) of x, f32 or f64: the plane int8
    for INT8, bf16 for FP8 (quantize.extract_ub_plane).

    On the card the operand is first laid out as K10 reads it
    (shift_operands). Rows take one launch of K11, columns two (K10's
    column maxima, then K11's plane); the device is never synchronised.
    The plane is contiguous along the reduce axis: row-major (m, k) for A,
    a (k, n) view of (n, k) storage for B, the layouts the estimation
    product reads."""
    if x.device.type == "cpu":
        return extract_ub_plain(x, backend, scale_axis)
    if scale_axis not in (0, 1):
        raise ValueError("extract_ub: scale_axis must be 0 or 1")
    x, _, reduce_axis = shift_operands(x, None, 1 - scale_axis)
    _check_extract(x, backend, reduce_axis)
    rows, cols = x.shape
    fp8_plane = backend == _FP8
    plane = plane_buffer((), rows, cols, 1 - reduce_axis, x.device,
                         torch.bfloat16 if fp8_plane else torch.int8)
    pre = torch.empty(rows if reduce_axis == 1 else cols, dtype=torch.int32,
                      device=x.device)
    if pre.numel():
        width = shift_width(x.dtype)
        ld = x.stride(0) if rows > 1 else cols
        vec = cols % width == 0 and ld % width == 0 and x.data_ptr() % 16 == 0
        shape = (int(x.dtype == torch.float64), int(fp8_plane), rows, cols,
                 ld)
        tail = (int(vec), quantize.MAX_UFP[backend], _stream(x))
        if reduce_axis == 1:
            _launch("extract_rows", x.data_ptr(), plane.data_ptr(),
                    pre.data_ptr(), *shape, shift_row_threads(cols, width),
                    *tail, count="extract_ub")
        else:
            slice_len, slices = shift_col_slices(rows, cols, width)
            scratch = torch.empty(shift_scratch_bytes(cols, slices, width),
                                  dtype=torch.uint8, device=x.device)
            _launch("shift_cols_max", x.data_ptr(), x.data_ptr(),
                    scratch.data_ptr(), shape[0], rows, cols, ld, 1,
                    slice_len, slices, int(vec), _stream(x),
                    count="extract_ub")
            _launch("extract_cols", x.data_ptr(), scratch.data_ptr(),
                    plane.data_ptr(), pre.data_ptr(), *shape, slice_len,
                    slices, *tail, count="extract_ub")
    if reduce_axis != 1 - scale_axis:       # laid out as its transpose
        plane = plane.T
    return plane, pre


# ---------------------------------------------------------------------------
# encode: quantize + residue planes
# ---------------------------------------------------------------------------

class _EncodePlan(ctypes.Structure):          # csrc/common.cuh: EncodePlan
    _fields_ = [("nu", ctypes.c_int), ("nl", ctypes.c_int),
                ("max_exp", ctypes.c_int),
                ("p", ctypes.c_int * _MAX_NU),
                ("w", (ctypes.c_int * _MAX_NL) * _MAX_NU),
                ("magic", ctypes.c_uint * _MAX_NU),
                ("bias", ctypes.c_uint * _MAX_NU)]


def reduce_constants(p: int) -> tuple[int, int]:
    """The encoders' division-free reduction constants of modulus p
    (csrc/encode.cuh, reduce_biased): magic = floor(2^32 / p) and bias = the
    least multiple of p >= REDUCE_RANGE, plus floor(p / 2); both 0 for a
    power-of-two p, which the kernels reduce by a mask."""
    if p & (p - 1) == 0:
        return 0, 0
    return 2 ** 32 // p, -(-REDUCE_RANGE // p) * p + p // 2


def _encode_plan(num_moduli: int, backend: str) -> _EncodePlan:
    plan = _EncodePlan()
    plan.nu = num_moduli
    plan.nl = quantize.n_limbs(num_moduli, backend)
    if plan.nl > _MAX_NL:
        raise ValueError(f"encode: {plan.nl} limbs exceed the kernel's {_MAX_NL}")
    plan.max_exp = tables.MAX_EXP
    for i, (p, ws) in enumerate(zip(tables.moduli(backend),
                                    quantize.limb_weights(num_moduli, backend))):
        plan.p[i] = p
        plan.magic[i], plan.bias[i] = reduce_constants(p)
        for lv, w in enumerate(ws):
            plan.w[i][lv] = w
    return plan


def plane_buffer(lead: tuple, rows: int, cols: int, scale_axis: int,
                 device, dtype=torch.int8) -> torch.Tensor:
    """An empty (*lead, rows, cols) plane stack in the layout the tensor-core
    products read: row-major for A (scale_axis=0), a view of (*lead, cols,
    rows) storage for B (scale_axis=1), so that each B plane is k-contiguous
    (column-major)."""
    if scale_axis == 0:
        return torch.empty((*lead, rows, cols), dtype=dtype, device=device)
    return torch.empty((*lead, cols, rows), dtype=dtype,
                       device=device).transpose(-1, -2)


def encode_planes_plain(x, sft, scale_axis, num_moduli, backend, im=None,
                        conj=False):
    """Plain version of the encode kernel: (nu, *x.shape) int8 planes. With
    im, of the lane encoder, in the order of gemmul8_tpu/complex_gemm.py's
    _quantize_complex: the wrapped residues of x (Re) and of im (negated
    first for conj), then their wrapped sum; the (3, nu, *x.shape) lanes Re,
    Im, (Re+Im)."""
    if im is None:
        return quantize.residues_wrapped(x, sft, scale_axis, num_moduli,
                                         backend).to(torch.int8)
    if conj:
        im = -im
    rr, ri = (quantize.residues_wrapped(v, sft, scale_axis, num_moduli,
                                        backend) for v in (x, im))
    s = torch.stack([quantize._wrap(rr[i] + ri[i], p) for i, p in
                     enumerate(tables.moduli(backend)[:num_moduli])])
    return torch.stack([rr, ri, s]).to(torch.int8)


@span("encode")
def encode_planes(x: torch.Tensor, sft: torch.Tensor, scale_axis: int,
                  num_moduli: int, backend: str,
                  out: torch.Tensor | None = None,
                  im: torch.Tensor | None = None,
                  conj: bool = False) -> torch.Tensor:
    """Residue planes wrap(floor(x * 2^sft) mod p_i) as int8, (nu, *x.shape).

    With im, the three 3M lanes of the complex operand x + i im from one
    read of each, (3, nu, *x.shape): Re's planes, Im's (negated before it is
    quantized for conj, the 'C' op) and those of (Re + Im) mod p.

    On the card, scale_axis=1 (the B operand, (k, n)) returns (nu, k, n)
    views of (nu, n, k) storage (with im, a (3, nu, k, n) view of (3, nu,
    n, k)): k-contiguous, as the int8 product reads B. `out`, if given, is
    written and returned instead: an int8 tensor of that shape in that same
    layout (plane_buffer).
    """
    if x.device.type == "cpu":
        planes = encode_planes_plain(x, sft, scale_axis, num_moduli, backend,
                                     im, conj)
        return planes if out is None else out.copy_(planes)
    if backend != _INT8:
        raise ValueError(f"encode_planes: backend must be INT8, got {backend!r}")
    lead = (num_moduli,) if im is None else (3, num_moduli)
    _check_im_out(x, im, out, scale_axis, lead)
    rows, cols = _check_encode("encode_planes", x, sft, scale_axis, num_moduli)
    if out is None:
        out = plane_buffer(lead, rows, cols, scale_axis, x.device)
    if x.numel():
        plan = _encode_plan(num_moduli, backend)
        args = (sft.data_ptr(), out.data_ptr(), ctypes.addressof(plan),
                int(x.dtype == torch.float64), scale_axis, rows, cols,
                int(_encode_vec(x, out, scale_axis, im)))
        if im is None:
            _launch("encode_planes", x.data_ptr(), *args, _stream(x))
        else:
            _launch("encode_lanes", x.data_ptr(), im.data_ptr(), *args,
                    int(bool(conj)), _stream(x))
    return out


def _check_im_out(x, im, out, scale_axis, lead):
    """The checks encode_planes makes of im and out on a CUDA input, before
    those of x and the device (so that tensors on the meta device show each
    refusal)."""
    if im is not None and (im.device != x.device or im.dtype != x.dtype
                           or im.shape != x.shape or not im.is_contiguous()):
        raise ValueError("encode_planes: im must be a contiguous tensor of "
                         "x's shape, dtype and device")
    if out is None or x.dim() != 2:
        return
    if (out.dtype != torch.int8 or out.device != x.device
            or out.shape != (*lead, *x.shape)
            or out.stride() != plane_buffer(lead, *x.shape, scale_axis,
                                            "meta").stride()):
        raise ValueError(f"encode_planes: out must be an int8 "
                         f"{(*lead, *x.shape)} tensor in the layout "
                         "encode_planes returns")


def _encode_vec(x: torch.Tensor, out: torch.Tensor, scale_axis: int,
                im: torch.Tensor | None = None) -> bool:
    """Whether the encoders may store a word per plane and 4 elements (and,
    for A, read x, and the lane encoders' im, with 16-byte loads): the
    planes' contiguous axis (x's cols for A, its rows for B) a multiple of
    4, out (and, for A, x and im) 16-byte aligned."""
    width = x.shape[1 - scale_axis]
    return (width % 4 == 0 and out.data_ptr() % 16 == 0
            and (scale_axis == 1 or all(t.data_ptr() % 16 == 0 for t in
                                        (x, im) if t is not None)))


def _check_encode(name, x, sft, scale_axis, num_moduli):
    """The checks both encode wrappers make on a CUDA input. Returns x's
    (rows, cols)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dim() != 2 or x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name}: x must be a 2-D f32 or f64 tensor")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    if scale_axis not in (0, 1):
        raise ValueError(f"{name}: scale_axis must be 0 or 1")
    _check_nu(name, num_moduli)
    if (sft.device != x.device or sft.dtype != torch.int32
            or sft.shape != (x.shape[scale_axis],) or not sft.is_contiguous()):
        raise ValueError(f"{name}: sft must be a contiguous int32 "
                         f"vector of length {x.shape[scale_axis]} on {x.device}")
    return x.shape


class _EncodePlanFp8(ctypes.Structure):       # csrc/common.cuh: EncodePlanFp8
    _fields_ = [("enc", _EncodePlan),
                ("sq", ctypes.c_int * _MAX_NU),
                ("inv_sq", ctypes.c_float * _MAX_NU),
                ("plane", (ctypes.c_int * 3) * _MAX_NU)]


def fp8_plane_map(num_moduli: int, side: str) -> list[tuple[int, int, int]]:
    """Per modulus i, the planes of this side's (3nu, ...) stack that take
    its split values, from fp8.slot_order: x's plane, y's plane, and z's
    plane (Karatsuba moduli) or y's second plane (square moduli, whose z is
    not stacked): csrc/common.cuh, EncodePlanFp8.plane."""
    planes = {}
    for j, (i, s) in enumerate(fp8.slot_order(num_moduli, side)):
        planes.setdefault(i, {}).setdefault(s, []).append(j)
    out = []
    for i in range(num_moduli):
        x, y = planes[i][0], planes[i][1]
        out.append((x[0], y[0], planes[i][2][0] if 2 in planes[i] else y[1]))
    return out


@functools.lru_cache(maxsize=None)
def _encode_plan_fp8(num_moduli: int, side: str) -> _EncodePlanFp8:
    """K6's plan, built once per (nu, side) and only read after that."""
    plan = _EncodePlanFp8()
    plan.enc = _encode_plan(num_moduli, _FP8)
    for i, q in enumerate(fp8._sqrt_moduli()[:num_moduli]):
        plan.sq[i] = q
        plan.inv_sq[i] = float(np.float32(1.0 / q))
    for i, planes in enumerate(fp8_plane_map(num_moduli, side)):
        plan.plane[i][:] = planes
    return plan


def encode_planes_fp8_plain(x, sft, scale_axis, num_moduli):
    """Plain version of the FP8 encode kernel: the (3nu, *x.shape) e4m3
    stack of this side (scale_axis 0: lhs, 1: rhs)."""
    res = quantize.residues_wrapped(x, sft, scale_axis, num_moduli, _FP8)
    return fp8._gemm_stack(fp8.split_planes(res, num_moduli), num_moduli,
                           "lhs" if scale_axis == 0 else "rhs")


@span("encode")
def encode_planes_fp8(x: torch.Tensor, sft: torch.Tensor, scale_axis: int,
                      num_moduli: int,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """The FP8 backend's GEMM-ready (3nu, *x.shape) float8_e4m3fn plane stack
    of one operand, in its side's slot order (scale_axis 0: A, per-row
    shifts; 1: B, per-column shifts).

    On the card, B's stack is a (3nu, k, n) view of (3nu, n, k) storage: each
    plane is the column-major operand torch._scaled_mm reads. `out`, if
    given, is written and returned instead: a float8_e4m3fn (3nu, *x.shape)
    tensor in that same layout."""
    if x.device.type == "cpu":
        planes = encode_planes_fp8_plain(x, sft, scale_axis, num_moduli)
        return planes if out is None else out.copy_(planes)
    rows, cols = _check_encode("encode_planes_fp8", x, sft, scale_axis,
                               num_moduli)
    shape = (3 * num_moduli,)
    if out is None:
        out = plane_buffer(shape, rows, cols, scale_axis, x.device,
                           torch.float8_e4m3fn)
    elif (out.dtype != torch.float8_e4m3fn or out.device != x.device
          or out.shape != (*shape, rows, cols)
          or out.stride() != plane_buffer(shape, rows, cols, scale_axis,
                                          "meta").stride()):
        raise ValueError("encode_planes_fp8: out must be a float8_e4m3fn "
                         f"({shape[0]}, {rows}, {cols}) tensor in the layout "
                         "encode_planes_fp8 returns")
    if x.numel():
        plan = _encode_plan_fp8(num_moduli, "lhs" if scale_axis == 0 else "rhs")
        _launch("encode_planes_fp8", x.data_ptr(), sft.data_ptr(),
                out.data_ptr(), ctypes.addressof(plan),
                int(x.dtype == torch.float64), scale_axis, rows, cols,
                int(_encode_vec(x, out, scale_axis)), _stream(x))
    return out


def encode_lanes_fp8_plain(re, im, sft, scale_axis, num_moduli, conj=False):
    """Plain version of the FP8 lane encoder, the order of operations of
    gemmul8_tpu/complex_gemm.py:50-61: the wrapped residues of Re and of Im
    (Im negated first for conj), their wrapped sum, each lane split as
    fp8.split_planes splits it and stacked in the side's slot order: the
    (3, 3nu, *re.shape) e4m3 lanes Re, Im, (Re+Im)."""
    if conj:
        im = -im
    rr, ri = (quantize.residues_wrapped(x, sft, scale_axis, num_moduli, _FP8)
              for x in (re, im))
    s = torch.stack([quantize._wrap(rr[i] + ri[i], p) for i, p in
                     enumerate(tables.moduli(_FP8)[:num_moduli])])
    side = "lhs" if scale_axis == 0 else "rhs"
    return torch.stack([fp8._gemm_stack(fp8.split_planes(x, num_moduli),
                                        num_moduli, side)
                        for x in (rr, ri, s)])


@span("encode")
def encode_lanes_fp8(re: torch.Tensor, im: torch.Tensor, sft: torch.Tensor,
                     scale_axis: int, num_moduli: int, conj: bool = False,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """The three 3M lanes of one complex operand on the FP8 backend, from
    one read of Re and Im: the (3, 3nu, *re.shape) float8_e4m3fn stacks of
    Re, Im and (Re+Im) mod p, each in its side's slot order (scale_axis 0:
    A, per-row shifts; 1: B, per-column shifts). conj negates Im before it
    is quantized (the 'C' op).

    On the card, B's lanes are (3, 3nu, k, n) views of (3, 3nu, n, k)
    storage, each plane the column-major operand torch._scaled_mm reads
    (plane_buffer). `out`, if given, is written and returned instead: a
    float8_e4m3fn tensor in that same layout."""
    if re.device.type == "cpu":
        lanes = encode_lanes_fp8_plain(re, im, sft, scale_axis, num_moduli,
                                       conj)
        return lanes if out is None else out.copy_(lanes)
    rows, cols = _check_encode("encode_lanes_fp8", re, sft, scale_axis,
                               num_moduli)
    if (im.device != re.device or im.dtype != re.dtype
            or im.shape != re.shape or not im.is_contiguous()):
        raise ValueError("encode_lanes_fp8: im must be a contiguous tensor "
                         "of re's shape, dtype and device")
    lead = (3, 3 * num_moduli)
    if out is None:
        out = plane_buffer(lead, rows, cols, scale_axis, re.device,
                           torch.float8_e4m3fn)
    elif (out.dtype != torch.float8_e4m3fn or out.device != re.device
          or out.shape != (*lead, rows, cols)
          or out.stride() != plane_buffer(lead, rows, cols, scale_axis,
                                          "meta").stride()):
        raise ValueError("encode_lanes_fp8: out must be a float8_e4m3fn "
                         f"(3, {lead[1]}, {rows}, {cols}) tensor in the "
                         "layout encode_lanes_fp8 returns")
    if re.numel():
        plan = _encode_plan_fp8(num_moduli, "lhs" if scale_axis == 0 else "rhs")
        _launch("encode_lanes_fp8", re.data_ptr(), im.data_ptr(),
                sft.data_ptr(), out.data_ptr(), ctypes.addressof(plan),
                int(re.dtype == torch.float64), scale_axis, rows, cols,
                int(_encode_vec(re, out, scale_axis, im)), int(bool(conj)),
                _stream(re))
    return out


# ---------------------------------------------------------------------------
# fused epilogue: wrap mod p + CRT limbs + descale, one pass over C_hi
# ---------------------------------------------------------------------------

class _EpiloguePlan(ctypes.Structure):        # csrc/common.cuh: EpiloguePlan
    _fields_ = [("nu", ctypes.c_int), ("L", ctypes.c_int),
                ("base", ctypes.c_int), ("invp_top", ctypes.c_float),
                ("p", ctypes.c_int * _MAX_NU),
                ("w16", (ctypes.c_int * _MAX_L) * _MAX_NU),
                ("p16", ctypes.c_int * _MAX_L),
                ("s1", ctypes.c_float * _MAX_L),
                ("s2", ctypes.c_float * _MAX_L),
                ("magic", ctypes.c_uint * _MAX_NU),
                ("wrap_off", ctypes.c_uint * _MAX_NU)]


def wrap_constants(p: int) -> tuple[int, int]:
    """The epilogues' division-free wrap constants of modulus p (csrc/crt.cuh,
    wrap_any): magic = floor(2^32 / p) and wrap_off = (floor(p / 2) - 2^31)
    mod p. (A power-of-two p is wrapped by a mask; its constants are exact
    all the same.)"""
    return 2 ** 32 // p, (p // 2 - 2 ** 31) % p


def _epilogue_plan(num_moduli: int, backend: str, out_bits: int):
    """The static plan of pallas_kernels._epilogue_plan, from ff.limb_plan,
    with each modulus' wrap constants (wrap_constants)."""
    base, L, w16, p16, invp_top = ff.limb_plan(num_moduli, backend, out_bits)
    if L > _MAX_L:
        raise ValueError(f"epilogue: {L} limbs exceed the kernel's {_MAX_L}")
    plan = _EpiloguePlan()
    plan.nu, plan.L, plan.base, plan.invp_top = num_moduli, L, base, invp_top
    for i, p in enumerate(tables.moduli(backend)[:num_moduli]):
        plan.p[i] = p
        plan.magic[i], plan.wrap_off[i] = wrap_constants(p)
        for li in range(L):
            plan.w16[i][li] = w16[i][li]
    for li in range(L):
        e = base + 16 * li
        plan.p16[li] = p16[li]
        plan.s1[li] = 2.0 ** (e // 2)
        plan.s2[li] = 2.0 ** (e - e // 2)
    return plan


def _check_epilogue(name, c_hi, n_planes, dtypes, sft_a, sft_b):
    """The checks every epilogue wrapper makes on a CUDA input: c_hi a
    contiguous (n_planes, m, n) stack of one of `dtypes`, int32 shift vectors
    on its device. Returns (m, n)."""
    if c_hi.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {c_hi.device}")
    if (c_hi.dim() != 3 or c_hi.dtype not in dtypes
            or c_hi.shape[0] != n_planes or not c_hi.is_contiguous()):
        raise ValueError(f"{name}: c_hi must be a contiguous ({n_planes}, m, n) "
                         f"tensor of {' or '.join(map(str, dtypes))}")
    _, m, n = c_hi.shape
    for sname, s, size in (("sft_a", sft_a, m), ("sft_b", sft_b, n)):
        if s is None:
            continue
        if (s.device != c_hi.device or s.dtype != torch.int32
                or s.shape != (size,) or not s.is_contiguous()):
            raise ValueError(f"{name}: {sname} must be a contiguous int32 "
                             f"vector of length {size} on {c_hi.device}")
    return m, n


def _epilogue_vec(n: int, cols: int, *tensors: torch.Tensor) -> bool:
    """Whether K2, K3 or K4 may load and store whole vectors of `cols` columns
    (csrc/crt.cuh: load_cols): every row's columns whole vectors (n a
    multiple of cols) and the tensors 16-byte aligned; else each thread
    takes its columns one by one."""
    return n % cols == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


def _check_nu(name, num_moduli):
    if not 1 <= num_moduli <= _MAX_NU:
        raise ValueError(f"{name}: num_moduli={num_moduli} out of range")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_backend(name, backend, allowed):
    if backend not in allowed:
        raise ValueError(f"{name}: backend must be {' or '.join(allowed)}, "
                         f"got {backend!r}")


def fused_epilogue_plain(c_hi, sft_a, sft_b, num_moduli, backend, out_dtype):
    """Plain version of the epilogue kernel: mod_reduce (int8 residues for
    the INT8 moduli, int16 for the FP8 ones) -> reconstruct_scale_ff."""
    return ff.reconstruct_scale_ff(quantize.mod_reduce(c_hi, num_moduli,
                                                       backend),
                                   sft_a, sft_b, num_moduli, backend, out_dtype)


class AlphaBeta(NamedTuple):
    """alpha * y + beta * c, applied to an emulated product y in the classes
    of core.ab_epilogue (core.scalar_kinds): with beta_kind "zero", or c
    None, no C is read. In fused_epilogue, c is the top-left block of the
    (m, n) output, whose rest the caller slices away."""
    c: Optional[torch.Tensor]
    alpha: float
    beta: float
    trivial_alpha: bool
    beta_kind: str


def ab_kind(ab: AlphaBeta) -> int:
    """K2's alpha/beta kind (csrc/epilogue.cu: AbKind): 0 applies nothing;
    1 alpha * y; 2-3 y + c, alpha 1 or not; 4-5 general beta."""
    if ab.c is None or ab.beta_kind == "zero":
        return 0 if ab.trivial_alpha else 1
    return (2 if ab.beta_kind == "one" else 4) + (not ab.trivial_alpha)


def alpha_beta_plain(y: torch.Tensor, ab: AlphaBeta) -> torch.Tensor:
    """alpha * y + beta * c as the JAX package's jitted _gemm_real computes
    it (core.py:330-350) after the "ff" epilogue: the plain version of the
    alpha/beta store of K2, and core.ab_epilogue's arithmetic. alpha == 1
    and beta in {0, 1} keep the common paths free of extra multiplies."""
    out_dtype = y.dtype
    scalar = lambda v: torch.tensor(v, dtype=torch.float64,  # noqa: E731
                                    device=y.device).to(out_dtype)
    c = ab.c
    if c is None or ab.beta_kind == "zero":
        return y if ab.trivial_alpha else scalar(ab.alpha) * y
    if ab.beta_kind == "one":
        return (y + c if ab.trivial_alpha
                else torch.addcmul(c, scalar(ab.alpha), y))
    # Where XLA:CPU contracts alpha*y + beta*c (pinned by
    # tests/test_torch_gemm_ops.py): a general alpha fuses alpha*y into the
    # sum for f64 outputs and beta*c for f32 outputs
    beta_t = scalar(ab.beta)
    if ab.trivial_alpha:
        return torch.addcmul(y, beta_t, c)
    if out_dtype == torch.float64:
        return torch.addcmul(beta_t * c, scalar(ab.alpha), y)
    return torch.addcmul(scalar(ab.alpha) * y, beta_t, c)


def _check_ab(ab: AlphaBeta, c_hi: torch.Tensor, out: torch.Tensor):
    """The card's checks of fused_epilogue's alpha/beta route: int32 C_hi
    in whole vectors, and C an (mc, nc) block of the output's shape, dtype
    and device with unit column stride. Returns (c, ldc, cvec): C's rows
    ldc elements apart (0 for one row), cvec whether C loads as whole
    16-byte vectors."""
    m, n = out.shape
    if c_hi.dtype != torch.int32 or not _epilogue_vec(
            n, EPILOGUE_COLS["fused_epilogue"], c_hi, out):
        raise ValueError("fused_epilogue: alpha/beta need an int32 c_hi with "
                         "n a multiple of 4 and 16-byte aligned")
    c = ab.c if ab_kind(ab) >= 2 else None
    if c is None:
        return None, 0, 0
    if (c.device != out.device or c.dtype != out.dtype or c.dim() != 2
            or not (1 <= c.shape[0] <= m and 1 <= c.shape[1] <= n)
            or (c.shape[1] > 1 and c.stride(1) != 1)):
        raise ValueError(f"fused_epilogue: c must be an (mc, nc) block of the "
                         f"({m}, n) {out.dtype} output on {out.device}, with "
                         f"unit column stride")
    ldc = c.stride(0) if c.shape[0] > 1 else 0
    cvec = c.data_ptr() % 16 == 0 and ldc * c.element_size() % 16 == 0
    return c, ldc, cvec


def _ab_scalar(v: float, out_dtype) -> float:
    """A scalar as the output's precision holds it (f32: rounded to
    nearest, as core.ab_epilogue's .to(out_dtype) rounds)."""
    return float(np.float32(v)) if out_dtype == torch.float32 else float(v)


@span("epilogue")
def fused_epilogue(c_hi: torch.Tensor, sft_a: torch.Tensor,
                   sft_b: torch.Tensor, num_moduli: int, backend: str,
                   out_dtype: torch.dtype,
                   ab: Optional[AlphaBeta] = None) -> torch.Tensor:
    """(nu, m, n) int32 C_hi (or K-chunked residue sums, any int32), or int8
    wrapped residues (fused_recombine_3m's output) -> (m, n) emulated product
    in out_dtype (f32 or f64). The FP8 backend takes int32 only (its K-chunked
    residue sums): its residues do not fit int8. With ab, alpha * y + beta *
    C in the store (int32 C_hi in whole vectors on the card; counted in
    LAUNCHES["fused_epilogue_ab"] too); outside C's block C reads as 0."""
    if c_hi.device.type == "cpu":
        out = fused_epilogue_plain(c_hi, sft_a, sft_b, num_moduli, backend,
                                   out_dtype)
        if ab is None:
            return out
        if ab.c is not None and ab.c.shape != out.shape:
            pad = (0, out.shape[1] - ab.c.shape[1],
                   0, out.shape[0] - ab.c.shape[0])
            ab = ab._replace(c=torch.nn.functional.pad(ab.c, pad))
        return alpha_beta_plain(out, ab)
    _check_nu("fused_epilogue", num_moduli)
    _check_backend("fused_epilogue", backend, (_INT8, _FP8))
    m, n = _check_epilogue("fused_epilogue", c_hi, num_moduli,
                           (torch.int32,) if backend == _FP8
                           else (torch.int32, torch.int8), sft_a, sft_b)
    if out_dtype not in (torch.float32, torch.float64):
        raise ValueError("fused_epilogue: out_dtype must be f32 or f64")
    out = torch.empty((m, n), dtype=out_dtype, device=c_hi.device)
    if out.numel():
        out_bits = 53 if out_dtype == torch.float64 else 24
        plan = _epilogue_plan(num_moduli, backend, out_bits)
        kind = 0 if ab is None else ab_kind(ab)
        if kind:
            c, ldc, cvec = _check_ab(ab, c_hi, out)
            _launch("fused_epilogue_ab", c_hi.data_ptr(), sft_a.data_ptr(),
                    sft_b.data_ptr(), out.data_ptr(),
                    0 if c is None else c.data_ptr(), ldc,
                    *((0, 0) if c is None else c.shape), int(cvec), kind,
                    _ab_scalar(ab.alpha, out_dtype),
                    _ab_scalar(ab.beta, out_dtype), int(out_bits == 53), m,
                    n, ctypes.addressof(plan), _stream(c_hi),
                    count="fused_epilogue")
            LAUNCHES["fused_epilogue_ab"] += 1
            return out
        vec = _epilogue_vec(n, EPILOGUE_COLS["fused_epilogue"], c_hi, out)
        _launch("fused_epilogue", c_hi.data_ptr(), sft_a.data_ptr(),
                sft_b.data_ptr(), out.data_ptr(), int(c_hi.dtype == torch.int8),
                int(out_bits == 53), m, n, int(vec), ctypes.addressof(plan),
                _stream(c_hi))
    return out


# ---------------------------------------------------------------------------
# FP8 fused epilogue: reassemble each modulus from its three split products,
# then the CRT limbs and descale
# ---------------------------------------------------------------------------

class _EpiloguePlanFp8(ctypes.Structure):     # csrc/common.cuh: EpiloguePlanFp8
    _fields_ = [("crt", _EpiloguePlan), ("sq", ctypes.c_int * _MAX_NU),
                ("p_f", ctypes.c_float * _MAX_NU),
                ("inv_p", ctypes.c_float * _MAX_NU),
                ("sq_f", ctypes.c_float * _MAX_NU),
                ("lim0", ctypes.c_uint * _MAX_L)]


# what each FP8 modulus' residue r carries into K3's limbs (csrc/
# epilogue_fp8.cu): r + 0x4B400000, the f32 bits of 1.5 * 2^23 + r, or r + 512
# for p = 1024, wrapped by its mask
FP8_MAGIC_BITS = 0x4B400000
FP8_MASK_OFFSET = 512


def fp8_residue_offset(p: int) -> int:
    """The offset of modulus p's residue in K3's limbs."""
    return FP8_MASK_OFFSET if p == 1024 else FP8_MAGIC_BITS


@functools.lru_cache(maxsize=None)
def _epilogue_plan_fp8(num_moduli: int, out_bits: int) -> _EpiloguePlanFp8:
    """K3's plan: the CRT plan of the FP8 moduli, each modulus' split (q, or
    0 for a Karatsuba one), p and q in f32 and 1/p rounded to f32, and the
    limbs' start, which takes every residue's offset out of the limb sums
    modulo 2^32. The kernel wraps modulus 1 by the mask of 1024 and every
    other modulus in f32 steps that need it odd (tests/
    test_torch_fp8_epilogue_redesign.py pins both). Built once for each
    (num_moduli, out_bits) and shared: callers only read it."""
    mods = tables.moduli(_FP8)[:num_moduli]
    plan = _EpiloguePlanFp8()
    plan.crt = _epilogue_plan(num_moduli, _FP8, out_bits)
    for i, q in enumerate(fp8._sqrt_moduli()[:num_moduli]):
        plan.sq[i] = q
        plan.sq_f[i] = q
    for i, p in enumerate(mods):
        plan.p_f[i] = p
        plan.inv_p[i] = float(np.float32(1.0 / p))
    for li in range(plan.crt.L):
        plan.lim0[li] = -sum(fp8_residue_offset(p) * plan.crt.w16[i][li]
                             for i, p in enumerate(mods)) % 2 ** 32
    return plan


def fused_epilogue_fp8_plain(c3, sft_a, sft_b, num_moduli, out_dtype):
    """Plain version of the FP8 epilogue kernel: fp8._reassemble -> int16 ->
    reconstruct_scale_ff."""
    c_mid = fp8._reassemble(c3.to(torch.int32), num_moduli).to(torch.int16)
    return ff.reconstruct_scale_ff(c_mid, sft_a, sft_b, num_moduli, _FP8,
                                   out_dtype)


@span("epilogue")
def fused_epilogue_fp8(c3: torch.Tensor, sft_a: torch.Tensor,
                       sft_b: torch.Tensor, num_moduli: int,
                       out_dtype: torch.dtype) -> torch.Tensor:
    """(3nu, m, n) f32 exact lane products of the FP8 split planes
    (fp8.residue_matmul_fp8, k <= K_CHUNK_FP8) -> (m, n) emulated product in
    out_dtype (f32 or f64)."""
    if c3.device.type == "cpu":
        return fused_epilogue_fp8_plain(c3, sft_a, sft_b, num_moduli,
                                        out_dtype)
    _check_nu("fused_epilogue_fp8", num_moduli)
    m, n = _check_epilogue("fused_epilogue_fp8", c3, 3 * num_moduli,
                           (torch.float32,), sft_a, sft_b)
    if out_dtype not in (torch.float32, torch.float64):
        raise ValueError("fused_epilogue_fp8: out_dtype must be f32 or f64")
    out = torch.empty((m, n), dtype=out_dtype, device=c3.device)
    if out.numel():
        out_bits = 53 if out_dtype == torch.float64 else 24
        plan = _epilogue_plan_fp8(num_moduli, out_bits)
        vec = _epilogue_vec(n, EPILOGUE_COLS["fused_epilogue_fp8"], c3, out)
        _launch("fused_epilogue_fp8", c3.data_ptr(), sft_a.data_ptr(),
                sft_b.data_ptr(), out.data_ptr(), int(out_bits == 53), m, n,
                int(vec), ctypes.addressof(plan), _stream(c3))
    return out


def reassemble_fp8_plain(c3, num_moduli):
    """Plain version of the FP8 reassembly kernel: fp8._reassemble, the
    (nu, m, n) int32 wrapped residues of each modulus' product."""
    return fp8._reassemble(c3.to(torch.int32), num_moduli)


@span("epilogue")
def reassemble_fp8(c3: torch.Tensor, num_moduli: int,
                   out: torch.Tensor | None = None,
                   accumulate: bool = False) -> torch.Tensor:
    """(3nu, m, n) f32 exact lane products of the FP8 split planes
    (fp8.residue_matmul_fp8, k <= K_CHUNK_FP8) -> (nu, m, n) int32 wrapped
    residues of each modulus' product, K3's reassembly with no CRT. Written
    into `out` (a contiguous int32 (nu, m, n) tensor, e.g. one lane's slot
    of the complex path's (3nu, m, n) stack) if given; accumulate=True adds
    them to out instead: out then holds K-chunked residue sums, as
    fp8._chunked_residue_acc sums them."""
    if accumulate and out is None:
        raise ValueError("reassemble_fp8: accumulate needs out")
    if c3.device.type == "cpu":
        part = reassemble_fp8_plain(c3, num_moduli)
        if out is None:
            return part
        return out.add_(part) if accumulate else out.copy_(part)
    _check_nu("reassemble_fp8", num_moduli)
    m, n = _check_epilogue("reassemble_fp8", c3, 3 * num_moduli,
                           (torch.float32,), None, None)
    if out is None:
        out = torch.empty((num_moduli, m, n), dtype=torch.int32,
                          device=c3.device)
    elif (out.dtype != torch.int32 or out.device != c3.device
          or out.shape != (num_moduli, m, n) or not out.is_contiguous()):
        raise ValueError("reassemble_fp8: out must be a contiguous int32 "
                         f"({num_moduli}, {m}, {n}) tensor on {c3.device}")
    if out.numel():
        plan = _epilogue_plan_fp8(num_moduli, 53)
        vec = _epilogue_vec(n, EPILOGUE_COLS["reassemble_fp8"], c3, out)
        _launch("reassemble_fp8", c3.data_ptr(), out.data_ptr(), m, n,
                int(vec), int(bool(accumulate)), ctypes.addressof(plan),
                _stream(c3))
    return out


# ---------------------------------------------------------------------------
# complex (3M) epilogues: wrap the three lane products + recombine mod p
# ---------------------------------------------------------------------------

# the real dtype of each output dtype the epilogues emit
REAL_DTYPE = {torch.complex64: torch.float32, torch.complex128: torch.float64,
              torch.float32: torch.float32, torch.float64: torch.float64}


def _lane_mids(c_hi3, num_moduli, backend):
    """(3nu, m, n) lane products -> (3, nu, m, n) wrapped residues: int8 for
    the INT8 moduli, int16 for the FP8 ones (quantize.mod_reduce)."""
    nu = num_moduli
    return torch.stack([quantize.mod_reduce(c_hi3[lane * nu:(lane + 1) * nu],
                                            nu, backend) for lane in range(3)])


# the residue type of the recombine kernel's output: int8 holds every INT8
# residue, the FP8 ones (p up to 1089) take int32, which the real epilogue
# reads as it reads the FP8 K-chunk sums
RECOMBINE_DTYPE = {_INT8: torch.int8, _FP8: torch.int32}


def fused_recombine_3m_plain(c_hi3, num_moduli, backend):
    """Plain version of the recombine kernel: mod_reduce per lane ->
    quantize._recombine_3m, in RECOMBINE_DTYPE[backend]."""
    re, im = quantize._recombine_3m(_lane_mids(c_hi3, num_moduli, backend),
                                    num_moduli, backend)
    return re.to(RECOMBINE_DTYPE[backend]), im.to(RECOMBINE_DTYPE[backend])


@span("epilogue")
def fused_recombine_3m(c_hi3: torch.Tensor, num_moduli: int, backend: str):
    """(3nu, m, n) int32 lane products Crr | Cii | Crii (or their K-chunked
    residue sums, or any int32) -> (re, im), each (nu, m, n) wrapped
    residues of Re = Crr - Cii and Im = Crii - Crr - Cii: int8 on the INT8
    backend, int32 on the FP8 one (RECOMBINE_DTYPE)."""
    if c_hi3.device.type == "cpu":
        return fused_recombine_3m_plain(c_hi3, num_moduli, backend)
    _check_nu("fused_recombine_3m", num_moduli)
    _check_backend("fused_recombine_3m", backend, (_INT8, _FP8))
    m, n = _check_epilogue("fused_recombine_3m", c_hi3, 3 * num_moduli,
                           (torch.int32,), None, None)
    re = torch.empty((num_moduli, m, n), dtype=RECOMBINE_DTYPE[backend],
                     device=c_hi3.device)
    im = torch.empty_like(re)
    if re.numel():
        plan = _epilogue_plan(num_moduli, backend, 53)
        _launch("fused_recombine_3m", c_hi3.data_ptr(), re.data_ptr(),
                im.data_ptr(), int(backend == _FP8), m, n,
                ctypes.addressof(plan), _stream(c_hi3))
    return re, im


def fused_epilogue_complex_plain(c_hi3, sft_a, sft_b, num_moduli, backend,
                                 out_dtype):
    """Plain version of the complex epilogue kernel: mod_reduce per lane ->
    _recombine_3m -> 2 x reconstruct_scale_ff."""
    re, im = fused_recombine_3m_plain(c_hi3, num_moduli, backend)
    real_dt = REAL_DTYPE[out_dtype]
    re, im = (ff.reconstruct_scale_ff(x, sft_a, sft_b, num_moduli, backend,
                                      real_dt) for x in (re, im))
    return torch.complex(re, im) if out_dtype.is_complex else (re, im)


@span("epilogue")
def fused_epilogue_complex(c_hi3: torch.Tensor, sft_a: torch.Tensor,
                           sft_b: torch.Tensor, num_moduli: int, backend: str,
                           out_dtype: torch.dtype):
    """(3nu, m, n) int32 lane products Crr | Cii | Crii (or their K-chunked
    residue sums; on the FP8 backend the lanes' wrapped residues from
    reassemble_fp8, or their K-chunk sums) -> the (m, n) complex product:
    one complex64/complex128 tensor for a complex out_dtype, written in
    place of a separate torch.complex pass, or a (re, im) pair for
    f32/f64."""
    if c_hi3.device.type == "cpu":
        return fused_epilogue_complex_plain(c_hi3, sft_a, sft_b, num_moduli,
                                            backend, out_dtype)
    _check_nu("fused_epilogue_complex", num_moduli)
    _check_backend("fused_epilogue_complex", backend, (_INT8, _FP8))
    m, n = _check_epilogue("fused_epilogue_complex", c_hi3, 3 * num_moduli,
                           (torch.int32,), sft_a, sft_b)
    if out_dtype not in REAL_DTYPE:
        raise ValueError("fused_epilogue_complex: out_dtype must be c64, c128, "
                         "f32 or f64")
    real_dt = REAL_DTYPE[out_dtype]
    if out_dtype.is_complex:
        out = torch.empty((m, n), dtype=out_dtype, device=c_hi3.device)
        parts = torch.view_as_real(out)
        re, im, stride = parts[..., 0], parts[..., 1], 2
    else:
        re = torch.empty((m, n), dtype=real_dt, device=c_hi3.device)
        im = torch.empty_like(re)
        out, stride = (re, im), 1
    if re.numel():
        out_bits = 53 if real_dt == torch.float64 else 24
        plan = _epilogue_plan(num_moduli, backend, out_bits)
        vec = _epilogue_vec(n, EPILOGUE_COLS["fused_epilogue_complex"], c_hi3,
                            *((re,) if stride == 2 else (re, im)))
        _launch("fused_epilogue_complex", c_hi3.data_ptr(), sft_a.data_ptr(),
                sft_b.data_ptr(), re.data_ptr(), im.data_ptr(), stride,
                int(out_bits == 53), m, n, int(vec), ctypes.addressof(plan),
                _stream(c_hi3))
    return out


# ---------------------------------------------------------------------------
# exact int8 products on the tensor cores (the main path's products, and the
# probe tools' Pallas products)
# ---------------------------------------------------------------------------

def matmul_i8_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of the product kernels: the exact batched product as
    int32. On the CPU in int64, whose cast wraps as the kernels' int32 sums
    do; on the card in f64, exact while every |sum| < 2^31."""
    wide = torch.int64 if a.device.type == "cpu" else torch.float64
    return torch.matmul(a.to(wide), b.to(wide)).to(torch.int32)


def _b_layout(b: torch.Tensor) -> bool:
    """True if B's planes are k-contiguous (unit stride along k: the (nu, n,
    k) storage that plane_buffer and encode_planes give B, or a K slice of
    it), False if n-contiguous ((nu, k, n) row-major, the probe tools'
    layout); raises on any other layout."""
    if b.is_contiguous():
        return False
    if b.stride(-2) == 1:
        return True
    raise ValueError("matmul_i8: b must be (nu, k, n) row-major or a "
                     "transposed view of (nu, n, k) storage with k "
                     "contiguous")


def _tma_pitches(x: torch.Tensor) -> tuple[int, int] | None:
    """The row and plane strides in bytes of a (nu, rows, k) int8 view whose
    k axis is contiguous, if TMA can address it (both multiples of 16, the
    base 16-byte aligned), else None. A stride of a dimension of size 1 is
    never followed and is taken as the dense one."""
    nu, rows, k = x.shape
    if x.data_ptr() % 16 or (k > 1 and x.stride(2) != 1):
        return None
    row = x.stride(1) if rows > 1 else k
    plane = x.stride(0) if nu > 1 else rows * row
    if row % 16 or plane % 16 or not (0 < row and 0 < plane):
        return None
    return row, plane


def tma_addressable(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether the product kernel's TMA maps can address the operands: k a
    multiple of 16, k > 0, A's and (if B is k-contiguous) B's row and plane
    strides multiples of 16 bytes and their bases 16-byte aligned, as
    in-place K slices of such stacks are; contiguous n-major B goes through
    a transposed scratch that is aligned."""
    k = a.shape[-1]
    if k <= 0 or k % 16 or _tma_pitches(a) is None:
        return False
    if b.is_contiguous():
        return True
    return b.stride(-2) == 1 and _tma_pitches(b.transpose(-1, -2)) is not None


def transpose_i8(b: torch.Tensor) -> torch.Tensor:
    """(nu, k, n) row-major int8 -> a (nu, k, n) view of (nu, n, k) storage
    holding the same values (k-contiguous planes), by csrc/matmul_i8_wgmma.cu's
    byte-transposing pass on the card."""
    if b.device.type == "cpu":
        return b.transpose(-1, -2).contiguous().transpose(-1, -2)
    nu, k, n = b.shape
    out = torch.empty((nu, n, k), dtype=torch.int8, device=b.device)
    if out.numel():
        _launch("transpose_i8", b.data_ptr(), out.data_ptr(), nu, k, n,
                _stream(b))
    return out.transpose(-1, -2)


def matmul_i8(a: torch.Tensor, b: torch.Tensor, schedule: str = "kloop",
              out: torch.Tensor | None = None) -> torch.Tensor:
    """(nu, m, k) int8 @ (nu, k, n) int8 -> (nu, m, n) int32, exact while no
    sum leaves int32 (past that it wraps, as torch._int_mm's does), by the
    wgmma + TMA kernel.

    schedule "kloop": K innermost, tiles in a grouped raster (the probes'
    K-sequential and flat K-loop products); "astat": every column tile of a
    row block in turn, so that its rows of A are re-read from L2 (the
    A-stationary and full-K ones). A has k contiguous; B is n-contiguous or
    k-contiguous (_b_layout), the latter as the main path's planes come. The
    kernel reads A and k-contiguous B in place, K slices of wider stacks
    included, and n-contiguous B through transpose_i8's scratch. Off the
    CPU the operands must be TMA-addressable (tma_addressable), else
    ValueError; the CPU takes matmul_i8_plain on any operands. `out`, if
    given, is a contiguous int32 (nu, m, n) tensor on a's device that is
    written and returned."""
    if schedule not in ("kloop", "astat"):
        raise ValueError(f"matmul_i8: no {schedule!r} schedule; the kernel "
                         "has 'kloop' and 'astat'")
    if (a.dtype != torch.int8 or b.dtype != torch.int8 or a.dim() != 3
            or b.dim() != 3 or b.device != a.device):
        raise ValueError("matmul_i8: a and b must be 3-D int8 tensors on one "
                         "device")
    nu, m, k = a.shape
    if b.shape[0] != nu or b.shape[1] != k:
        raise ValueError(f"matmul_i8: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} do not chain")
    n = b.shape[2]
    if out is not None and (out.shape != (nu, m, n) or out.dtype != torch.int32
                            or out.device != a.device
                            or not out.is_contiguous()):
        raise ValueError(f"matmul_i8: out must be a contiguous int32 "
                         f"({nu}, {m}, {n}) tensor on {a.device}")
    if a.device.type == "cpu":
        c = matmul_i8_plain(a, b)
        return c if out is None else out.copy_(c)
    if not tma_addressable(a, b):
        raise ValueError(
            "matmul_i8: the planes must be TMA-addressable (k a multiple of "
            "16, 16-byte aligned bases and row and plane strides, B "
            "row-major or k-contiguous), as the entries' planes padded to "
            f"128 are; got A {tuple(a.shape)} strides {a.stride()}, B "
            f"{tuple(b.shape)} strides {b.stride()}")
    if a.device.type != "cuda":
        raise ValueError(f"matmul_i8: unsupported device {a.device}")
    c = out if out is not None else torch.empty(
        (nu, m, n), dtype=torch.int32, device=a.device)
    if not c.numel():
        return c
    bt = b if _b_layout(b) else transpose_i8(b)
    a_row, a_plane = _tma_pitches(a)
    b_row, b_plane = _tma_pitches(bt.transpose(-1, -2))
    _launch("matmul_i8_wgmma", a.data_ptr(), bt.data_ptr(), c.data_ptr(),
            nu, m, n, k, a_row, a_plane, b_row, b_plane,
            int(schedule == "astat"), _stream(a),
            count=f"matmul_i8_wgmma_{schedule}")
    return c


# ---------------------------------------------------------------------------
# tensor-core CRT epilogue: the CRT sum as a product against 8-bit columns
# ---------------------------------------------------------------------------

_MXU_COLS, _MXU_K = 16, 32     # csrc/common.cuh: G8_MXU_COLS, G8_MXU_K


class _EpiloguePlanMxu(ctypes.Structure):  # csrc/common.cuh: EpiloguePlanMxu
    _fields_ = [("crt", _EpiloguePlan), ("n_cols", ctypes.c_int),
                ("w2", ctypes.c_int * _MAX_NU),
                ("inv_p", ctypes.c_float * _MAX_NU),
                ("c8", (ctypes.c_ubyte * _MXU_K) * _MXU_COLS)]


def _mxu_constants(num_moduli: int, backend: str):
    """Per modulus the f32 wrap's constants: wrap(2^16 mod p) and the f32 of
    the double 1/p (as tools/probe_epilogue.py takes them)."""
    mods = [int(p) for p in tables.moduli(backend)[:num_moduli]]
    w2 = []
    for p in mods:
        w = pow(2, 16, int(p))
        w2.append(w - p if 2 * w >= p else w)
    return mods, w2, [float(np.float32(1.0 / p)) for p in mods]


def fused_epilogue_mxu_plain(c_hi, sft_a, sft_b, num_moduli, backend,
                             out_bits):
    """Plain version of the tensor-core CRT epilogue: per modulus the f32
    wrap t = hi16 * wrap(2^16) + lo16, r = t - rint(t / p) * p with two
    balanced corrections; the 8-bit columns of the CRT sum as an f32
    torch.matmul (exact: every partial sum is an integer below 2^24, with
    TF32 off as PyTorch has it by default); column pairs as 16-bit limbs;
    ff.fold_quotient; ff.descale_pair. Returns the (hi, lo) f32 pair."""
    _check_backend("fused_epilogue_mxu", backend, (_INT8,))
    base, n_cols, C, _, _ = ff._crt_matrix_plan(num_moduli, backend, out_bits)
    _, L, _, p16, invp_top = ff.limb_plan(num_moduli, backend, out_bits)
    mods, w2, inv_p = _mxu_constants(num_moduli, backend)
    rs = []
    for i, p in enumerate(mods):
        acc = c_hi[i].to(torch.int32)
        acc_hi = acc >> 16
        acc_lo = acc - (acc_hi << 16)
        t = acc_hi.to(torch.float32) * float(w2[i]) + acc_lo.to(torch.float32)
        r = t - torch.round(t * inv_p[i]) * float(p)
        r = torch.where(2.0 * r >= p, r - p, r)
        rs.append(torch.where(2.0 * r < -p, r + p, r))
    m, n = c_hi.shape[1:]
    c8t = torch.from_numpy(np.ascontiguousarray(C.T)).to(c_hi.device)
    cols = torch.matmul(c8t, torch.stack(rs).reshape(num_moduli, m * n))
    cols = cols.to(torch.int32).reshape(n_cols, m, n)
    limbs = []
    for li in range(L):
        v = cols[2 * li]
        if 2 * li + 1 < n_cols:
            v = v + (cols[2 * li + 1] << 8)
        limbs.append(v)
    return ff.descale_pair(ff.fold_quotient(limbs, p16, invp_top), base, 16,
                           sft_a, sft_b)


# K8's vector loads: 4 columns of a plane (csrc/epilogue_mxu.cu: kGroup)
MXU_GROUP = 4


def mxu_depth(i: int) -> int:
    """The depth of the column product at which K8 puts modulus i (lane t of
    a quad holds moduli t + 4u): 4t + u for i = t + 4u < 16, 16 + 4t for
    i = 16 + t (csrc/common.cuh, EpiloguePlanMxu.c8)."""
    return 4 * (i % 4) + i // 4 if i < 16 else 16 + 4 * (i - 16)


@functools.lru_cache(maxsize=None)
def _epilogue_plan_mxu(num_moduli: int, backend: str, out_bits: int):
    """K8's plan, built once per (nu, backend, out_bits) and only read after
    that."""
    base, n_cols, C, _, _ = ff._crt_matrix_plan(num_moduli, backend, out_bits)
    if n_cols > _MXU_COLS or num_moduli > _MAX_NU:
        raise ValueError(f"fused_epilogue_mxu: {n_cols} columns of "
                         f"{num_moduli} moduli exceed the kernel's tile")
    plan = _EpiloguePlanMxu()
    plan.crt = _epilogue_plan(num_moduli, backend, out_bits)
    plan.n_cols = n_cols
    _, w2, inv_p = _mxu_constants(num_moduli, backend)
    for i in range(num_moduli):
        plan.w2[i], plan.inv_p[i] = w2[i], inv_p[i]
        for j in range(n_cols):
            plan.c8[j][mxu_depth(i)] = int(C[i, j])
    return plan


def fused_epilogue_mxu(c_hi: torch.Tensor, sft_a: torch.Tensor,
                       sft_b: torch.Tensor, num_moduli: int, backend: str,
                       out_bits: int):
    """(nu, m, n) int32 C_hi -> the (hi, lo) f32 pair of K2's f32 route
    (hi + lo is the emulated product), with the CRT sum over the moduli done
    as a u8 x s8 tensor-core product against the 8-bit columns of qPi.
    INT8 only: the FP8 moduli's residues (up to +-544) do not fit the s8
    operand. out_bits: 53 or 24, the plan's precision."""
    _check_backend("fused_epilogue_mxu", backend, (_INT8,))
    if out_bits not in (24, 53):
        raise ValueError("fused_epilogue_mxu: out_bits must be 24 or 53")
    if c_hi.device.type == "cpu":
        return fused_epilogue_mxu_plain(c_hi, sft_a, sft_b, num_moduli,
                                        backend, out_bits)
    _check_nu("fused_epilogue_mxu", num_moduli)
    m, n = _check_epilogue("fused_epilogue_mxu", c_hi, num_moduli,
                           (torch.int32,), sft_a, sft_b)
    hi = torch.empty((m, n), dtype=torch.float32, device=c_hi.device)
    lo = torch.empty_like(hi)
    if hi.numel():
        plan = _epilogue_plan_mxu(num_moduli, backend, out_bits)
        _launch("fused_epilogue_mxu", c_hi.data_ptr(), sft_a.data_ptr(),
                sft_b.data_ptr(), hi.data_ptr(), lo.data_ptr(), m, n,
                int(_epilogue_vec(n, MXU_GROUP, c_hi)),
                ctypes.addressof(plan), _stream(c_hi))
    return hi, lo
