"""Reference-signature compatibility layer: ``workSize``, ``gemm`` and
``gemmLt`` with the reference's arguments (include/gemmul8.hpp:19-94,
src/gemmul8.cu:95-157), the counterpart of gemmul8_tpu/compat.py.

cuBLAS semantics: column-major buffers with leading dimensions lda/ldb/ldc,
ops "N"/"T"/"C" ("C" = conjugate transpose, equal to "T" for real dtypes),
C updated in place, and the returned 4-entry phase-time vector [scaling,
low-precision GEMM, conv_hi2mid, inverse scaling] in seconds
(gemmul8_real.hpp:67-68): zeros unless with_timing=True, which runs
core.gemm_with_phases' separately timed stages.

Buffers are torch tensors, on the card or the CPU, or numpy arrays. A 1-D
buffer holds a column-major matrix with element (i, j) at buf[j*ld + i] and
is read and written through a strided view; a 2-D buffer is the stored
matrix. C's dtype is the call's dtype. A torch C is computed on its own
device; a numpy C on `device`, "cuda" unless the caller passes "cpu", and
written back. ``gemm`` rejects the FP8 backend as the reference's
plain-cuBLAS entry does (gemmul8.cu:136-139); ``gemmLt`` takes it.

A Handle holds the skip-scal plane cache (the reference's Info_t,
hook.cu:87-107): enable_skip_scalA/B stores a side's planes, skip_scalA/B
reuses them for the same buffer, shape, ld, op and config. As in the
reference, skip_scal is the caller's promise that the buffer is unchanged.

Where this differs from the JAX package:

  * CUDA buffers: torch tensors on the card are read and written in place;
  * a complex alpha or beta with a real C raises ValueError (compat.py:157
    drops the imaginary part);
  * the skip cache holds a weak reference to each buffer and drops the entry
    when the buffer is collected, so a new buffer that reuses a dead one's
    id() is never served its planes (compat.py:169);
  * planes are reused only in fast mode proper (fastmode is True): robust
    and accurate calls take the normal path (compat.py:260 sends them
    through the fast shifts);
  * alpha and beta go through gemm's own epilogue on every route, so the
    skip flags never change the bits (compat.py:263);
  * with_timing works for every real call (ops, alpha and beta included);
  * complex operands take the FP8 backend through gemmLt, as real ones do.
"""
from __future__ import annotations

import weakref

import numpy as np
import torch

from . import core, tables

OP_N, OP_T, OP_C = "N", "T", "C"
Backend = tables.Backend

_DTYPES = {torch.float32: "float32", torch.float64: "float64",
           torch.complex64: "complex64", torch.complex128: "complex128"}


class Handle:
    """The cuBLAS handle's analog: owns the skip-scal plane cache, keyed on
    (id(buffer), stored shape, ld, op, side, num_moduli, backend, device);
    each entry holds a weak reference to its buffer and is dropped when the
    buffer is collected."""

    def __init__(self):
        self._cache = {}

    def clear(self):
        self._cache.clear()


_DEFAULT_HANDLE = Handle()


def create() -> Handle:
    """cublasCreate analog: a fresh handle with an empty skip-scal cache."""
    return Handle()


def destroy(handle: Handle) -> None:
    """cublasDestroy analog: drop the handle's cached planes."""
    if handle is not None:
        handle.clear()


def workSize(m: int, n: int, k: int, num_moduli: int,
             enable_skip_scalA: bool = False,
             enable_skip_scalB: bool = False, *,
             is_complex: bool = False,
             backend: str = Backend.INT8,
             return_split: bool = False):
    """Workspace planning estimate in bytes (gemmul8::workSize,
    include/gemmul8.hpp:25-35), the JAX package's numbers: core.work_bytes,
    plus one plane set per skip-enabled side (gemmul8_real.hpp:28-29).
    Returns an int, or (total, sizeA, sizeB) with return_split=True."""
    if min(m, n, k) <= 0:
        raise ValueError(f"m, n, k must be positive, got {(m, n, k)}")
    name = "complex128" if is_complex else "float64"
    lo, hi = tables.VALID_RANGE[name]
    if not lo <= num_moduli <= hi:
        raise ValueError(f"num_moduli={num_moduli} out of [{lo},{hi}]")
    a_planes = core.plane_bytes(m, k, num_moduli, name, backend) + 4 * m
    b_planes = core.plane_bytes(k, n, num_moduli, name, backend) + 4 * n
    total = core.work_bytes(m, n, k, num_moduli, dtype=name, backend=backend)
    total += (a_planes if enable_skip_scalA else 0)
    total += (b_planes if enable_skip_scalB else 0)
    if return_split:
        return total, a_planes, b_planes
    return total


def _stored(buf, ld: int, rows: int, cols: int, name: str):
    """The stored (rows, cols) matrix of a buffer, as a view: a 1-D
    column-major ld-strided buffer (element (i, j) at buf[j*ld + i]), or a
    2-D buffer holding the matrix."""
    x = buf if isinstance(buf, torch.Tensor) else np.asarray(buf)
    if x.ndim == 2:
        if tuple(x.shape) != (rows, cols):
            raise ValueError(f"{name}: 2-D buffer must be the stored "
                             f"({rows}, {cols}) matrix, got {tuple(x.shape)}")
        return x
    if x.ndim != 1:
        raise ValueError(f"{name}: expected a 1-D ld-strided or 2-D buffer, "
                         f"got ndim={x.ndim}")
    if ld < rows:
        raise ValueError(f"{name}: ld={ld} < number of stored rows {rows}")
    need = (cols - 1) * ld + rows if rows and cols else 0
    if x.shape[0] < need:
        raise ValueError(f"{name}: buffer holds {x.shape[0]} elements, "
                         f"{cols} columns of ld={ld} need {need}")
    if isinstance(x, torch.Tensor):
        return x.as_strided((rows, cols), (x.stride(0), ld * x.stride(0)),
                            x.storage_offset())
    s = x.strides[0]
    return np.lib.stride_tricks.as_strided(x, (rows, cols), (s, ld * s))


def _scalar(x, is_cplx: bool, name: str):
    v = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
    if v.size != 1:
        raise ValueError(f"{name} must be a scalar, got shape {v.shape}")
    v = v.reshape(())
    if is_cplx:
        return complex(v)
    if np.iscomplexobj(v) and v.imag != 0:
        raise ValueError(f"{name}={complex(v)} is complex but C is real")
    return float(v.real)


def _cached_quantized(handle, buf, stored, key, op, side, num_moduli,
                      backend, device, dtype, enable_skip, skip):
    """Skip-scal semantics: skip=True reuses the planes cached for this
    buffer; enable=True (or skip=True on a miss) stores them."""
    hit = handle._cache.get(key) if skip else None
    if hit is not None and hit[0]() is buf:
        return hit[1]
    mat = core._as_tensor(stored, device).to(dtype)
    q = core.precompute(mat if op == OP_N else mat.T, side,
                        num_moduli=num_moduli, backend=backend, device=device)
    if enable_skip or skip:
        try:
            ref = weakref.ref(buf)
        except TypeError:           # not weakref-able: never cached
            return q
        handle._cache[key] = (ref, q)
        weakref.finalize(buf, handle._cache.pop, key, None)
    return q


def gemm(handle, op_A: str, op_B: str, m: int, n: int, k: int,
         alpha, A, lda: int, B, ldb: int, beta, C, ldc: int,
         num_moduli: int, fastmode,
         work=None, workA=None, workB=None,
         enable_skip_scalA: bool = False, enable_skip_scalB: bool = False,
         skip_scalA: bool = False, skip_scalB: bool = False, *,
         backend: str = Backend.INT8, with_timing: bool = False,
         device=None):
    """gemmul8::gemm (include/gemmul8.hpp:41-67): C = alpha * op(A) @ op(B)
    + beta * C, C updated in place. work/workA/workB are accepted and
    unused (PyTorch's allocator owns memory). Returns the 4-phase time
    vector in seconds (zeros unless with_timing=True)."""
    if backend == Backend.FP8:
        raise ValueError("gemm does not support the FP8 backend (the "
                         "reference's plain-cuBLAS entry cannot drive FP8 "
                         "tensor cores); use gemmLt(..., backend='FP8')")
    return _gemm_impl(handle, op_A, op_B, m, n, k, alpha, A, lda, B, ldb,
                      beta, C, ldc, num_moduli, fastmode, backend,
                      enable_skip_scalA, enable_skip_scalB, skip_scalA,
                      skip_scalB, with_timing, device)


def gemmLt(handle, op_A: str, op_B: str, m: int, n: int, k: int,
           alpha, A, lda: int, B, ldb: int, beta, C, ldc: int,
           num_moduli: int, fastmode,
           work=None, workA=None, workB=None,
           enable_skip_scalA: bool = False, enable_skip_scalB: bool = False,
           skip_scalA: bool = False, skip_scalB: bool = False,
           stream=None, *, backend: str = Backend.INT8,
           with_timing: bool = False, device=None):
    """gemmul8::gemmLt (include/gemmul8.hpp:69-94): gemm() that also takes
    the FP8 backend, as the cuBLASLt entry does. `stream` is accepted and
    unused: work runs on the current CUDA stream."""
    return _gemm_impl(handle, op_A, op_B, m, n, k, alpha, A, lda, B, ldb,
                      beta, C, ldc, num_moduli, fastmode, backend,
                      enable_skip_scalA, enable_skip_scalB, skip_scalA,
                      skip_scalB, with_timing, device)


def _call_device(C, device) -> torch.device:
    if not isinstance(C, torch.Tensor):
        return core._device("cuda" if device is None else device)
    if device is not None and torch.device(device).type != C.device.type:
        raise ValueError(f"device={device!r}, but C lies on {C.device}: a "
                         "torch C is computed on its own device")
    return C.device


def _gemm_impl(handle, op_A, op_B, m, n, k, alpha, A, lda, B, ldb, beta,
               C, ldc, num_moduli, fastmode, backend,
               enable_skip_scalA, enable_skip_scalB, skip_scalA, skip_scalB,
               with_timing, device):
    handle = _DEFAULT_HANDLE if handle is None else handle
    op_A, op_B = str(op_A).upper(), str(op_B).upper()
    if op_A not in (OP_N, OP_T, OP_C) or op_B not in (OP_N, OP_T, OP_C):
        raise ValueError(f"ops must be 'N'/'T'/'C', got {op_A!r}, {op_B!r}")
    if not (isinstance(C, torch.Tensor)
            or (isinstance(C, np.ndarray) and C.flags.writeable)):
        raise TypeError("C must be a torch tensor or a writable numpy "
                        "buffer (the reference updates C in place)")
    dev = _call_device(C, device)
    dtype = (C.dtype if isinstance(C, torch.Tensor)
             else torch.from_numpy(np.empty(0, C.dtype)).dtype)
    if dtype not in _DTYPES:
        raise TypeError(f"C must be float32/float64/complex64/complex128, "
                        f"got {dtype}")
    is_cplx = dtype.is_complex
    lo, hi = tables.VALID_RANGE[_DTYPES[dtype]]
    if not lo <= num_moduli <= hi:
        raise ValueError(
            f"num_moduli={num_moduli} out of [{lo},{hi}] for {dtype}")

    # stored shapes, column-major (cuBLAS convention)
    a_rows, a_cols = (m, k) if op_A == OP_N else (k, m)
    b_rows, b_cols = (k, n) if op_B == OP_N else (n, k)
    a_st = _stored(A, lda, a_rows, a_cols, "A")
    b_st = _stored(B, ldb, b_rows, b_cols, "B")
    c_view = _stored(C, ldc, m, n, "C")
    alpha_s = _scalar(alpha, is_cplx, "alpha")
    beta_s = _scalar(beta, is_cplx, "beta")
    c_in = None if beta_s == 0 else core._as_tensor(c_view, dev).to(dtype)

    times = [0.0, 0.0, 0.0, 0.0]
    skip = (enable_skip_scalA or enable_skip_scalB or skip_scalA
            or skip_scalB)
    if with_timing:
        if is_cplx:
            raise ValueError("with_timing=True times the real path "
                             "(core.gemm_with_phases)")
        a_op, b_op = (core._as_tensor(x, dev).to(dtype) for x in (a_st, b_st))
        ab, phases = core.gemm_with_phases(
            a_op if op_A == OP_N else a_op.T, b_op if op_B == OP_N else b_op.T,
            num_moduli=num_moduli, fastmode=fastmode, backend=backend,
            device=dev)
        times = [float(phases[p]) for p in core.PHASES]
        out = _epilogue(ab, c_in, alpha_s, beta_s)
    elif skip and fastmode is True and not is_cplx:
        quantized = []
        for buf, st, op, side, ld, enable, use in (
                (A, a_st, op_A, "A", lda, enable_skip_scalA, skip_scalA),
                (B, b_st, op_B, "B", ldb, enable_skip_scalB, skip_scalB)):
            key = (id(buf), tuple(st.shape), ld, op, side, num_moduli,
                   backend, str(dev))
            quantized.append(_cached_quantized(
                handle, buf, st, key, op, side, num_moduli, backend, dev,
                dtype, enable, use))
        ab = core.gemm_quantized(*quantized, out_dtype=dtype)
        out = _epilogue(ab, c_in, alpha_s, beta_s)
    else:
        a_t, b_t = (core._as_tensor(x, dev).to(dtype) for x in (a_st, b_st))
        out = core.gemm(a_t, b_t, num_moduli=num_moduli, fastmode=fastmode,
                        backend=backend, alpha=alpha_s, beta=beta_s, c=c_in,
                        trans_a=op_A, trans_b=op_B, device=dev)
    if isinstance(c_view, torch.Tensor):
        c_view.copy_(out)
    else:
        np.copyto(c_view, out.cpu().numpy())
    return times


def _epilogue(ab, c, alpha, beta):
    """alpha * ab + beta * c through gemm's own epilogue (real dtypes)."""
    trivial_alpha, beta_kind = core.scalar_kinds(alpha, beta)
    return core.ab_epilogue(ab, c, alpha, beta, has_c=c is not None,
                            epilogue="auto", trivial_alpha=trivial_alpha,
                            beta_kind=beta_kind)
