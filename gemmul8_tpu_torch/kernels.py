"""Hand-written CUDA kernels of the main paths, their wrappers and plain versions.

The counterpart of gemmul8_tpu/pallas_kernels.py:

  encode_planes           csrc/encode.cu        replaces encode_planes_tiles
  encode_planes_fp8       csrc/encode_fp8.cu    replaces encode_planes_fp8_tiles
  fused_epilogue          csrc/epilogue.cu      replaces fused_epilogue
  fused_epilogue_fp8      csrc/epilogue_fp8.cu  replaces fused_epilogue_fp8
  fused_epilogue_complex  csrc/complex.cu       replaces fused_epilogue_complex
  fused_recombine_3m      csrc/complex.cu       replaces fused_recombine_3m

(the encoders share csrc/encode.cuh's steps, the epilogues csrc/crt.cuh's).

Each wrapper checks its operands, allocates the output with torch.empty,
launches on the current stream, raises if the launch failed and adds one to
LAUNCHES[name]. Beside each wrapper is its plain PyTorch version; the wrapper
takes it only for tensors on the CPU. A CUDA tensor launches the kernel or
raises.

The kernels are built at first use by one nvcc call (sm_90a, -fmad=false so
that no multiply-add is contracted) into one shared library under
gemmul8_tpu_torch/_build/, named by a hash of the sources and flags, and are
bound with ctypes through a plain C interface.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import numpy as np
import torch

from . import ff, fp8, quantize, tables

LAUNCHES = {"encode_planes": 0, "encode_planes_fp8": 0, "fused_epilogue": 0,
            "fused_epilogue_fp8": 0, "fused_epilogue_complex": 0,
            "fused_recombine_3m": 0}
_INT8, _FP8 = tables.Backend.INT8, tables.Backend.FP8

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_BUILD = os.path.join(_HERE, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]
_LIB: ctypes.CDLL | None = None
_P, _I = ctypes.c_void_p, ctypes.c_int
# the C entry points' signatures (csrc/*.cu)
_ARGTYPES = {
    # x, sft, out, plan, is_f64, scale_axis, rows, cols, stream
    "encode_planes": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "encode_planes_fp8": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # c_hi, sft_a, sft_b, out, in_i8, out_f64, m, n, plan, stream
    "fused_epilogue": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    # c3, sft_a, sft_b, out, out_f64, m, n, plan, stream
    "fused_epilogue_fp8": [_P, _P, _P, _P, _I, _I, _I, _P, _P],
    # c_hi3, sft_a, sft_b, out_re, out_im, stride, out_f64, m, n, plan, stream
    "fused_epilogue_complex": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    # c_hi3, out_re, out_im, m, n, plan, stream
    "fused_recombine_3m": [_P, _P, _P, _I, _I, _P, _P],
}

_MAX_NU = 20        # csrc/common.cuh: G8_MAX_NU
_MAX_NL = 6         # G8_MAX_NL: 20-bit encode limbs
_MAX_L = 7          # G8_MAX_L: 16-bit epilogue limbs


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
    name holds a hash of the sources and flags). Returns its path."""
    sources = sorted(n for n in os.listdir(_CSRC) if n.endswith((".cu", ".cuh")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sources:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    out = os.path.join(_BUILD, f"libgemmul8_kernels_{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(_BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *(os.path.join(_CSRC, n) for n in sources if n.endswith(".cu"))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
    os.replace(tmp, out)              # atomic: a half-written .so never loads
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


def _launch(name: str, *args) -> None:
    err = getattr(_lib(), "g8_" + name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    LAUNCHES[name] += 1


# ---------------------------------------------------------------------------
# encode: quantize + residue planes
# ---------------------------------------------------------------------------

class _EncodePlan(ctypes.Structure):          # csrc/common.cuh: EncodePlan
    _fields_ = [("nu", ctypes.c_int), ("nl", ctypes.c_int),
                ("max_exp", ctypes.c_int),
                ("p", ctypes.c_int * _MAX_NU),
                ("w", (ctypes.c_int * _MAX_NL) * _MAX_NU)]


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


def encode_planes_plain(x, sft, scale_axis, num_moduli, backend):
    """Plain version of the encode kernel: (nu, *x.shape) int8 planes."""
    return quantize.residues_wrapped(x, sft, scale_axis, num_moduli,
                                     backend).to(torch.int8)


def encode_planes(x: torch.Tensor, sft: torch.Tensor, scale_axis: int,
                  num_moduli: int, backend: str,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """Residue planes wrap(floor(x * 2^sft) mod p_i) as int8, (nu, *x.shape).

    On the card, scale_axis=1 (the B operand, (k, n)) returns a (nu, k, n)
    view of (nu, n, k) storage: k-contiguous, as the int8 product reads B.
    `out`, if given, is written and returned instead: an int8 (nu, *x.shape)
    tensor in that same layout (complex_gemm stacks its lanes this way).
    """
    if x.device.type == "cpu":
        planes = encode_planes_plain(x, sft, scale_axis, num_moduli, backend)
        return planes if out is None else out.copy_(planes)
    if backend != _INT8:
        raise ValueError(f"encode_planes: backend must be INT8, got {backend!r}")
    rows, cols = _check_encode("encode_planes", x, sft, scale_axis, num_moduli)
    if out is None:
        out = plane_buffer((num_moduli,), rows, cols, scale_axis, x.device)
    elif (out.dtype != torch.int8 or out.device != x.device
          or out.shape != (num_moduli, rows, cols)
          or out.stride() != plane_buffer((num_moduli,), rows, cols,
                                          scale_axis, "meta").stride()):
        raise ValueError("encode_planes: out must be an int8 "
                         f"({num_moduli}, {rows}, {cols}) tensor in the "
                         "layout encode_planes returns")
    if x.numel():
        plan = _encode_plan(num_moduli, backend)
        _launch("encode_planes", x.data_ptr(), sft.data_ptr(), out.data_ptr(),
                ctypes.addressof(plan), int(x.dtype == torch.float64),
                scale_axis, rows, cols, _stream(x))
    return out


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
                ("slot", ctypes.c_int * (3 * _MAX_NU))]


def _encode_plan_fp8(num_moduli: int, side: str) -> _EncodePlanFp8:
    plan = _EncodePlanFp8()
    plan.enc = _encode_plan(num_moduli, _FP8)
    for i, q in enumerate(fp8._sqrt_moduli()[:num_moduli]):
        plan.sq[i] = q
        plan.inv_sq[i] = float(np.float32(1.0 / q))
    for j, (_, s) in enumerate(fp8.slot_order(num_moduli, side)):
        plan.slot[j] = s
    return plan


def encode_planes_fp8_plain(x, sft, scale_axis, num_moduli):
    """Plain version of the FP8 encode kernel: the (3nu, *x.shape) e4m3
    stack of this side (scale_axis 0: lhs, 1: rhs)."""
    res = quantize.residues_wrapped(x, sft, scale_axis, num_moduli, _FP8)
    return fp8._gemm_stack(fp8.split_planes(res, num_moduli), num_moduli,
                           "lhs" if scale_axis == 0 else "rhs")


def encode_planes_fp8(x: torch.Tensor, sft: torch.Tensor, scale_axis: int,
                      num_moduli: int) -> torch.Tensor:
    """The FP8 backend's GEMM-ready (3nu, *x.shape) float8_e4m3fn plane stack
    of one operand, in its side's slot order (scale_axis 0: A, per-row
    shifts; 1: B, per-column shifts).

    On the card, B's stack is a (3nu, k, n) view of (3nu, n, k) storage: each
    plane is the column-major operand torch._scaled_mm reads."""
    if x.device.type == "cpu":
        return encode_planes_fp8_plain(x, sft, scale_axis, num_moduli)
    rows, cols = _check_encode("encode_planes_fp8", x, sft, scale_axis,
                               num_moduli)
    out = plane_buffer((3 * num_moduli,), rows, cols, scale_axis, x.device,
                       torch.float8_e4m3fn)
    if x.numel():
        plan = _encode_plan_fp8(num_moduli, "lhs" if scale_axis == 0 else "rhs")
        _launch("encode_planes_fp8", x.data_ptr(), sft.data_ptr(),
                out.data_ptr(), ctypes.addressof(plan),
                int(x.dtype == torch.float64), scale_axis, rows, cols,
                _stream(x))
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
                ("s2", ctypes.c_float * _MAX_L)]


def _epilogue_plan(num_moduli: int, backend: str, out_bits: int):
    """The static plan of pallas_kernels._epilogue_plan, from ff.limb_plan."""
    base, L, w16, p16, invp_top = ff.limb_plan(num_moduli, backend, out_bits)
    if L > _MAX_L:
        raise ValueError(f"epilogue: {L} limbs exceed the kernel's {_MAX_L}")
    plan = _EpiloguePlan()
    plan.nu, plan.L, plan.base, plan.invp_top = num_moduli, L, base, invp_top
    for i, p in enumerate(tables.moduli(backend)[:num_moduli]):
        plan.p[i] = p
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
    from .core import mod_reduce
    return ff.reconstruct_scale_ff(mod_reduce(c_hi, num_moduli, backend),
                                   sft_a, sft_b, num_moduli, backend, out_dtype)


def fused_epilogue(c_hi: torch.Tensor, sft_a: torch.Tensor,
                   sft_b: torch.Tensor, num_moduli: int, backend: str,
                   out_dtype: torch.dtype) -> torch.Tensor:
    """(nu, m, n) int32 C_hi (or K-chunked residue sums, any int32), or int8
    wrapped residues (fused_recombine_3m's output) -> (m, n) emulated product
    in out_dtype (f32 or f64). The FP8 backend takes int32 only (its K-chunked
    residue sums): its residues do not fit int8."""
    if c_hi.device.type == "cpu":
        return fused_epilogue_plain(c_hi, sft_a, sft_b, num_moduli, backend,
                                    out_dtype)
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
        _launch("fused_epilogue", c_hi.data_ptr(), sft_a.data_ptr(),
                sft_b.data_ptr(), out.data_ptr(), int(c_hi.dtype == torch.int8),
                int(out_bits == 53), m, n, ctypes.addressof(plan),
                _stream(c_hi))
    return out


# ---------------------------------------------------------------------------
# FP8 fused epilogue: reassemble each modulus from its three split products,
# then the CRT limbs and descale
# ---------------------------------------------------------------------------

class _EpiloguePlanFp8(ctypes.Structure):     # csrc/common.cuh: EpiloguePlanFp8
    _fields_ = [("crt", _EpiloguePlan), ("sq", ctypes.c_int * _MAX_NU)]


def fused_epilogue_fp8_plain(c3, sft_a, sft_b, num_moduli, out_dtype):
    """Plain version of the FP8 epilogue kernel: fp8._reassemble -> int16 ->
    reconstruct_scale_ff."""
    c_mid = fp8._reassemble(c3.to(torch.int32), num_moduli).to(torch.int16)
    return ff.reconstruct_scale_ff(c_mid, sft_a, sft_b, num_moduli, _FP8,
                                   out_dtype)


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
        plan = _EpiloguePlanFp8()
        plan.crt = _epilogue_plan(num_moduli, _FP8, out_bits)
        for i, q in enumerate(fp8._sqrt_moduli()[:num_moduli]):
            plan.sq[i] = q
        _launch("fused_epilogue_fp8", c3.data_ptr(), sft_a.data_ptr(),
                sft_b.data_ptr(), out.data_ptr(), int(out_bits == 53), m, n,
                ctypes.addressof(plan), _stream(c3))
    return out


# ---------------------------------------------------------------------------
# complex (3M) epilogues: wrap the three lane products + recombine mod p
# ---------------------------------------------------------------------------

# the real dtype of each output dtype the epilogues emit
REAL_DTYPE = {torch.complex64: torch.float32, torch.complex128: torch.float64,
              torch.float32: torch.float32, torch.float64: torch.float64}


def _lane_mids(c_hi3, num_moduli, backend):
    """(3nu, m, n) lane products -> (3, nu, m, n) wrapped int8 residues."""
    from .core import mod_reduce
    nu = num_moduli
    return torch.stack([mod_reduce(c_hi3[lane * nu:(lane + 1) * nu], nu,
                                   backend) for lane in range(3)])


def fused_recombine_3m_plain(c_hi3, num_moduli, backend):
    """Plain version of the recombine kernel: mod_reduce per lane ->
    complex_gemm._recombine_3m."""
    from .complex_gemm import _recombine_3m
    return _recombine_3m(_lane_mids(c_hi3, num_moduli, backend), num_moduli,
                         backend)


def fused_recombine_3m(c_hi3: torch.Tensor, num_moduli: int, backend: str):
    """(3nu, m, n) int32 lane products Crr | Cii | Crii (or their K-chunked
    residue sums) -> (re, im), each (nu, m, n) int8 wrapped residues of
    Re = Crr - Cii and Im = Crii - Crr - Cii."""
    if c_hi3.device.type == "cpu":
        return fused_recombine_3m_plain(c_hi3, num_moduli, backend)
    _check_nu("fused_recombine_3m", num_moduli)
    _check_backend("fused_recombine_3m", backend, (_INT8,))
    m, n = _check_epilogue("fused_recombine_3m", c_hi3, 3 * num_moduli,
                           (torch.int32,), None, None)
    re = torch.empty((num_moduli, m, n), dtype=torch.int8, device=c_hi3.device)
    im = torch.empty_like(re)
    if re.numel():
        plan = _epilogue_plan(num_moduli, backend, 53)
        _launch("fused_recombine_3m", c_hi3.data_ptr(), re.data_ptr(),
                im.data_ptr(), m, n, ctypes.addressof(plan), _stream(c_hi3))
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


def fused_epilogue_complex(c_hi3: torch.Tensor, sft_a: torch.Tensor,
                           sft_b: torch.Tensor, num_moduli: int, backend: str,
                           out_dtype: torch.dtype):
    """(3nu, m, n) int32 lane products Crr | Cii | Crii (or their K-chunked
    residue sums) -> the (m, n) complex product: one complex64/complex128
    tensor for a complex out_dtype, written in place of a separate
    torch.complex pass, or a (re, im) pair for f32/f64."""
    if c_hi3.device.type == "cpu":
        return fused_epilogue_complex_plain(c_hi3, sft_a, sft_b, num_moduli,
                                            backend, out_dtype)
    _check_nu("fused_epilogue_complex", num_moduli)
    _check_backend("fused_epilogue_complex", backend, (_INT8,))
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
        _launch("fused_epilogue_complex", c_hi3.data_ptr(), sft_a.data_ptr(),
                sft_b.data_ptr(), re.data_ptr(), im.data_ptr(), stride,
                int(out_bits == 53), m, n, ctypes.addressof(plan),
                _stream(c_hi3))
    return out
