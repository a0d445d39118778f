"""Complex GEMM (CGEMM/ZGEMM), herk and batched complex GEMM via the 3M scheme
in residue space, fast, robust and accurate mode, INT8 and FP8, in PyTorch.

The counterpart of gemmul8_tpu/complex_gemm.py:

  * each operand emits three residue plane sets per modulus -- Re, Im and
    (Re+Im) mod p -- with one shift per row/column computed from Re and Im
    together, from one lane encoder launch a side that reads Re and Im once
    and writes the three lanes: INT8 residue planes, FP8 their e4m3 split
    stacks;
  * the lane products Crr = Ar.Br, Cii = Ai.Bi, Crii = (Ar+Ai).(Br+Bi):
    3nu exact int8 products (core.residue_matmul: on the card one launch
    of the wgmma kernel for the 3nu planes), or on FP8 three 3nu-plane
    stacks of e4m3 products (torch._scaled_mm), one lane at a time, each
    lane's f32 products reassembled into its wrapped int32 residues by a
    kernel before the next lane's are made;
  * with the "ff" epilogue the lane products (or residues) go into one
    kernel that wraps, recombines Re = Crr - Cii and Im = Crii - Crr - Cii
    mod p and runs both CRT + descale pipelines (nu <= 16), or into a
    recombine kernel and two passes of the real epilogue kernel (nu > 16).
    On the CPU the wrappers run their plain versions. The "f64" epilogue
    runs the unfused chain;
  * conjugation ('C' op) negates the imaginary lane before the encode;
  * accurate mode bounds both parts of the product with three estimation
    products of the lanes' upper-bound planes, combined through the 3M
    identity in f32 with fixed inflations.

Results are bit-equal to the JAX package on the CPU. XLA:CPU computes a
complex product x*y under jit as re = fma(xr, yr, -(xi*yi)) and
im = fma(xi, yr, xr*yi); the alpha/beta epilogue here does the same with
torch.addcmul (pinned by tests/test_torch_complex_gemm.py).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import core, fp8, kernels, quantize, tables
# complex_gemm's name too: parallel.summa and the tests read _recombine_3m
# here
from .quantize import _recombine_3m, _wrap
from .spans import span

_COMPLEX_NAME = {torch.float32: "complex64", torch.float64: "complex128",
                 torch.complex64: "complex64", torch.complex128: "complex128"}


def _check_backend(backend) -> None:
    if backend not in (tables.Backend.INT8, tables.Backend.FP8):
        raise ValueError(f"backend must be 'INT8' or 'FP8', got {backend!r}")


def _check_nu(dtype, num_moduli) -> None:
    name = _COMPLEX_NAME[dtype]
    lo, hi = tables.VALID_RANGE[name]
    if not lo <= num_moduli <= hi:
        raise ValueError(
            f"num_moduli={num_moduli} out of range [{lo},{hi}] for {name}")


def _pack(re, im, out_dtype):
    return torch.complex(re, im) if out_dtype.is_complex else (re, im)


def _crop(out, m, n):
    if isinstance(out, tuple):
        return tuple(_crop(x, m, n) for x in out)
    return out if out.shape == (m, n) else out[:m, :n]


# ---------------------------------------------------------------------------
# shifts, lanes, recombine
# ---------------------------------------------------------------------------

@span("shifts")
def _shift_complex_fast(re, im, num_moduli, backend, reduce_axis,
                        variant="reference"):
    """One shift per row/column from Re and Im concatenated along the reduce
    axis: amax = max(|re|, |im|), norm^2 = sum(re^2 + im^2). On the card K10
    reads Re and Im in place, as one row (column) of twice the length."""
    return quantize.shift_fast(re, num_moduli, backend, reduce_axis,
                               variant=variant, im=im)


@span("extract")
def _extract_ub_lanes(re, im, scale_axis, backend):
    """Upper-bound planes of the three 3M estimation lanes with one pre-shift
    per row/column from max(|Re|, |Im|): ub|Re|, ub|Im| and their signed
    difference (scaling_accu_complex.hpp:6-50, 100-126), so that the 3M
    identity holds exactly on the extracted integers."""
    reduce_axis = 1 - scale_axis
    ar_, ai_ = torch.abs(re), torch.abs(im)
    amax = torch.amax(torch.maximum(ar_, ai_), dim=reduce_axis)
    E = quantize.ilogb(torch.where(amax > 0, amax, torch.ones_like(amax)))
    pre = quantize.MAX_UFP[backend] - E
    ub_r = quantize.extract_ub_with_pre(ar_, pre, reduce_axis, backend)
    ub_i = quantize.extract_ub_with_pre(ai_, pre, reduce_axis, backend)
    # INT8: |ub_r - ub_i| <= 65, exact in int8. FP8: bounds reach 258 and
    # the bf16 difference rounds |257| (258 - 1) to 256, as the JAX package
    # does (gemmul8_tpu/complex_gemm.py:107). The 3M bound stays an upper
    # bound all the same: a bound of 258 stands for a value below 256, and
    # that slack covers the lost unit in every term of the estimate
    # (tests/test_torch_complex_fp8.py::test_complex_gemm_107_fp8_difference_lane)
    return ub_r, ub_i, ub_r - ub_i, pre


def _combine_3m_bound(d):
    """max(|Re|, |Im|) product bound from the three estimation products
    d = (C0, uAr@uBi, uAi@uBr): C0 + C1 bounds |Re|, C1 = d[1] + d[2] bounds
    |Im|. In f32 with inflations that keep it an upper bound for any k (the
    lane sums exceed int32 from k ~ 2.5e5, hence each lane in f32 first).
    Plain f32 adds and multiplies: XLA contracts none of them here."""
    one_ulp = quantize._f32(1.0 + 2.0 ** -22, d[0])
    c0 = d[0].to(torch.float32)
    c1 = (d[1].to(torch.float32) + d[2].to(torch.float32)) * one_ulp
    return (torch.maximum(c0 + c1, c1)
            * quantize._f32(1.0 + 2.0 ** -20, d[0]))


# Accurate mode's shifts in core's three stages, on the 3M lanes. Each side's
# entry is (ub|Re|, ub|Im|, their difference, pre); b=None stands for A^H, as
# in herk: its bound planes are A's transposed and one shift serves both
# sides.

def accurate_extract(a, b, backend):
    """The bound lanes of A's rows and B's columns, a and b (Re, Im) pairs;
    (A's, None) for b=None."""
    ext_a = _extract_ub_lanes(*a, 0, backend)
    return ext_a, None if b is None else _extract_ub_lanes(*b, 1, backend)


def accurate_estimate(ext, backend):
    """The three estimation products of the lanes (uAr-uAi, uAr, uAi) x
    (uBr-uBi, uBi, uBr)."""
    ua_r, ua_i, ua_ri, _ = ext[0]
    ub_r, ub_i, ub_ri = ((ua_r.T, ua_i.T, ua_ri.T) if ext[1] is None
                         else ext[1][:3])
    return [quantize.estimate_gemm(x, y, backend)
            for x, y in zip((ua_ri, ua_r, ua_i), (ub_ri, ub_i, ub_r))]


def accurate_combine(d, ext, num_moduli, backend):
    """The shifts from the 3M bound of the products d
    (scaling_accu_complex.hpp:128-226, find_max.hpp:99-251)."""
    return core.accurate_combine(_combine_3m_bound(d), ext, num_moduli,
                                 backend)


@span("shifts")
def shifts(a, b, num_moduli, fastmode, backend):
    """(sft_a, sft_b) of A's rows and B's columns from the (Re, Im) pairs a
    and b, in the given mode as core.shifts; b=None stands for A^H."""
    if not fastmode:
        ext = accurate_extract(a, b, backend)
        return accurate_combine(accurate_estimate(ext, backend), ext,
                                num_moduli, backend)
    var = "invariant" if fastmode == "robust" else "reference"
    sft_a = _shift_complex_fast(*a, num_moduli, backend, 1, variant=var)
    if b is None:
        return sft_a, sft_a
    return sft_a, _shift_complex_fast(*b, num_moduli, backend, 0,
                                      variant=var)


@span("lanes")
def _quantize_complex(re, im, sft, scale_axis, num_moduli, backend, conj):
    """The three lane plane sets (Re, Im, (Re+Im) mod p) of one operand:
    INT8 the (3, nu, r, c) int8 lanes of kernels.encode_planes (one launch,
    B's planes k-contiguous, as the int8 product reads them); FP8 the
    (3, 3nu, r, c) e4m3 split stacks of kernels.encode_lanes_fp8, in the
    side's slot order (B's planes column-major, as torch._scaled_mm reads
    them)."""
    if backend == tables.Backend.FP8:
        return kernels.encode_lanes_fp8(re, im, sft, scale_axis, num_moduli,
                                        conj)
    lanes = kernels.plane_buffer((3, num_moduli), *re.shape, scale_axis,
                                 re.device)
    return kernels.encode_planes(re, sft, scale_axis, num_moduli, backend,
                                 out=lanes, im=im, conj=conj)


def _fp8_lane_residues(pa, pb, num_moduli):
    """(3nu, m, n) int32 wrapped residues of the three FP8 lane products
    (lane-major, as the complex epilogues read them): each lane's 3nu
    e4m3 products (fp8.residue_matmul_fp8), K-chunked past K_CHUNK_FP8, go
    through the reassembly kernel into the lane's slot, each chunk's
    residues added to the last (fp8._chunked_residue_acc). One lane's f32
    products are alive at a time."""
    nu = num_moduli
    m, k, n = pa.shape[-2], pa.shape[-1], pb.shape[-1]
    res = torch.empty((3 * nu, m, n), dtype=torch.int32, device=pa.device)
    for lane in range(3):
        for lo in range(0, k, fp8.K_CHUNK_FP8):
            sl = slice(lo, lo + fp8.K_CHUNK_FP8)
            c3 = fp8.residue_matmul_fp8(pa[lane][:, :, sl],
                                        pb[lane][:, sl, :])
            kernels.reassemble_fp8(c3, nu, out=res[lane * nu:(lane + 1) * nu],
                                   accumulate=lo > 0)
            del c3
    return res


def lanes_epilogue_ff(c_hi3, sft_a, sft_b, num_moduli, backend, out_dtype):
    """The "ff" epilogue of (3nu, m, n) int32 lane products (or any int32
    congruent to them, as residue sums are): one complex epilogue kernel for
    nu <= 16; above it the recombine kernel into int8 (FP8: int32) residues,
    then the real epilogue twice. Returns a complex tensor for a complex
    out_dtype, else the (re, im) pair."""
    if num_moduli <= 16:
        return kernels.fused_epilogue_complex(c_hi3, sft_a, sft_b, num_moduli,
                                              backend, out_dtype)
    mid_r, mid_i = kernels.fused_recombine_3m(c_hi3, num_moduli, backend)
    del c_hi3
    real_dt = kernels.REAL_DTYPE[out_dtype]
    re, im = (kernels.fused_epilogue(x, sft_a, sft_b, num_moduli, backend,
                                     real_dt) for x in (mid_r, mid_i))
    return _pack(re, im, out_dtype)


def _complex_product(pa, pb, sft_a, sft_b, num_moduli, backend, out_dtype,
                     epilogue):
    """Lane-product residue GEMMs + 3M recombine + dual CRT from the encoded
    (3, nu, ...) lane plane sets. Returns a complex tensor for a complex
    out_dtype, else the (re, im) pair."""
    nu = num_moduli
    real_dt = kernels.REAL_DTYPE[out_dtype]
    is_fp8 = backend == tables.Backend.FP8
    if core.resolve_epilogue(epilogue, pa.device) == "ff":
        if is_fp8:
            c_hi3 = _fp8_lane_residues(pa, pb, nu)
        elif pa.shape[-1] <= core.K_CHUNK:
            c_hi3 = core.residue_matmul(pa.reshape(3 * nu, *pa.shape[2:]),
                                        pb.reshape(3 * nu, *pb.shape[2:]))
        else:
            c_hi3 = torch.cat([core._chunked_residue_acc(pa[lane], pb[lane],
                                                         nu, backend)
                               for lane in range(3)])
        return lanes_epilogue_ff(c_hi3, sft_a, sft_b, nu, backend, out_dtype)
    if is_fp8:
        mids = torch.stack([fp8.residue_gemm_fp8(pa[lane], pb[lane], nu)
                            for lane in range(3)])
    else:
        mids = torch.stack([core.residue_gemm(pa[lane], pb[lane], nu, backend)
                            for lane in range(3)])
    mid_r, mid_i = _recombine_3m(mids, nu, backend)
    re, im = (core.reconstruct_scale(x, sft_a, sft_b, nu, backend, real_dt,
                                     epilogue) for x in (mid_r, mid_i))
    return _pack(re, im, out_dtype)


# ---------------------------------------------------------------------------
# op(A) @ op(B)
# ---------------------------------------------------------------------------

@span("entry")
def _emulate(ar, ai, br, bi, num_moduli, fastmode, backend, conj_a, conj_b,
             epilogue, out_dtype):
    _check_backend(backend)
    m, n = ar.shape[0], br.shape[1]
    if ar.shape[1] == 0:
        # BLAS k=0 semantics: the product is zero
        zero = torch.zeros((m, n), dtype=kernels.REAL_DTYPE[out_dtype],
                           device=ar.device)
        return _pack(zero, zero.clone(), out_dtype)
    if ar.device.type != "cpu":
        ar, ai, br, bi = (core._pad128(x, (0, 1)) for x in (ar, ai, br, bi))
    ar, ai, br, bi = (x.contiguous() for x in (ar, ai, br, bi))
    sft_a, sft_b = shifts((ar, ai), (br, bi), num_moduli, fastmode, backend)
    pa = _quantize_complex(ar, ai, sft_a, 0, num_moduli, backend, conj_a)
    pb = _quantize_complex(br, bi, sft_b, 1, num_moduli, backend, conj_b)
    out = _complex_product(pa, pb, sft_a, sft_b, num_moduli, backend,
                           out_dtype, epilogue)
    return _crop(out, m, n)


def emulate_matmul_complex_planar(ar, ai, br, bi, *, num_moduli: int,
                                  fastmode=True,
                                  backend: str = tables.Backend.INT8,
                                  conj_a: bool = False, conj_b: bool = False,
                                  epilogue: str = "auto"):
    """Emulated op(A) @ op(B) on planar operands: (Ar, Ai) x (Br, Bi) ->
    (Cr, Ci) on ar's device. On the card, operands are zero-padded to
    multiples of 128 and the result is sliced back."""
    return _emulate(ar, ai, br, bi, num_moduli, fastmode, backend, conj_a,
                    conj_b, epilogue, ar.dtype)


@span("entry")
def emulate_matmul_complex(a, b, *, num_moduli: int, fastmode=True,
                           backend: str = tables.Backend.INT8,
                           conj_a: bool = False, conj_b: bool = False,
                           epilogue: str = "auto") -> torch.Tensor:
    """Emulated op(A) @ op(B) for complex tensors (no alpha/beta)."""
    return _emulate(a.real, a.imag, b.real, b.imag, num_moduli, fastmode,
                    backend, conj_a, conj_b, epilogue, a.dtype)


def _scalar(v: complex, dtype, like: torch.Tensor) -> torch.Tensor:
    """v as a 0-d tensor of `dtype`, rounded from complex128 as
    `jnp.asarray(v).astype(dtype)` rounds."""
    return torch.tensor(v, dtype=torch.complex128,
                        device=like.device).to(dtype)


def _cmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x * y as XLA:CPU computes a complex product:
    re = fma(xr, yr, -(xi*yi)), im = fma(xi, yr, xr*yi)."""
    xr, xi, yr, yi = x.real, x.imag, y.real, y.imag
    return torch.complex(torch.addcmul(-(xi * yi), xr, yr),
                         torch.addcmul(xr * yi, xi, yr))


@span("alpha_beta")
def _gemm_cplx(a, b, c, alpha, beta, *, num_moduli, fastmode, backend,
               op_a, op_b, has_c, epilogue, trivial_alpha, beta_kind):
    if op_a in ("T", "C"):
        a = a.T
    if op_b in ("T", "C"):
        b = b.T
    out_dtype = a.dtype
    out = emulate_matmul_complex(a, b, num_moduli=num_moduli,
                                 fastmode=fastmode, backend=backend,
                                 conj_a=(op_a == "C"), conj_b=(op_b == "C"),
                                 epilogue=epilogue)
    if not trivial_alpha:
        out = _cmul(_scalar(alpha, out_dtype, out), out)
    # beta_kind == "zero" never touches C
    if has_c and beta_kind != "zero":
        out = out + (c if beta_kind == "one"
                     else _cmul(_scalar(beta, out_dtype, out), c))
    return out


def _norm_op(t) -> str:
    """BLAS op flag -> 'N'/'T'/'C'; accepts python/numpy bools ('C' stays
    distinct from 'T': conjugate transpose)."""
    if isinstance(t, (bool, np.bool_)):
        return "T" if t else "N"
    if t is None:
        return "N"
    t = str(t).upper()
    if t not in ("N", "T", "C"):
        raise ValueError(f"bad op {t!r}")
    return t


def _complex_scalar(v) -> complex:
    return complex(np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v))


def _operand(x, device) -> torch.Tensor:
    # a conjugate or negative view is materialized first, so that .real and
    # .imag read the values it stands for
    return core._as_tensor(x, device).resolve_conj().resolve_neg()


@span("entry")
def gemm_complex(a, b, *, num_moduli: int = 8, fastmode=True,
                 backend: str = tables.Backend.INT8, alpha=1.0, beta=0.0,
                 c=None, trans_a="N", trans_b="N", epilogue: str = "auto",
                 device="cuda") -> torch.Tensor:
    """Emulated complex GEMM: C = alpha * op(A) @ op(B) + beta * C with op in
    {N, T, C} (C = conjugate transpose), on complex64 or complex128 operands
    placed on `device`. Bit-equal to gemmul8_tpu's complex gemm on the CPU."""
    op_a, op_b = _norm_op(trans_a), _norm_op(trans_b)
    device = core._device(device)
    a, b = _operand(a, device), _operand(b, device)
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(
            f"gemm expects 2-D operands, got A.ndim={a.dim()}, B.ndim={b.dim()}")
    if a.dtype != b.dtype:
        raise TypeError(f"dtype mismatch: {a.dtype} vs {b.dtype}")
    if a.dtype not in (torch.complex64, torch.complex128):
        raise TypeError(f"gemm_complex expects complex64 or complex128, "
                        f"got {a.dtype}")
    _check_nu(a.dtype, num_moduli)
    has_c = c is not None
    trivial_alpha = isinstance(alpha, (int, complex, float)) and alpha == 1
    beta_kind = ("zero" if isinstance(beta, (int, complex, float)) and beta == 0
                 else "one" if isinstance(beta, (int, complex, float))
                 and beta == 1 else "general")
    if has_c and beta_kind != "zero":
        c = _operand(c, device)
        if c.dtype != a.dtype:
            raise TypeError(f"dtype mismatch: C is {c.dtype}, A is {a.dtype}")
    return _gemm_cplx(a, b, c, _complex_scalar(alpha), _complex_scalar(beta),
                      num_moduli=num_moduli, fastmode=fastmode,
                      backend=backend, op_a=op_a, op_b=op_b, has_c=has_c,
                      epilogue=epilogue, trivial_alpha=trivial_alpha,
                      beta_kind=beta_kind)


def gemm_planar(ar, ai, br, bi, *, num_moduli: int = 8, fastmode=True,
                backend: str = tables.Backend.INT8, trans_a="N", trans_b="N",
                epilogue: str = "auto", device="cuda"):
    """Emulated complex GEMM on planar operands: (Ar, Ai) x (Br, Bi) ->
    (Cr, Ci), with op in {N, T, C}; bit-equal to gemm() on complex tensors."""
    op_a, op_b = _norm_op(trans_a), _norm_op(trans_b)
    device = core._device(device)
    ar, ai, br, bi = (core._as_tensor(x, device) for x in (ar, ai, br, bi))
    if ar.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"gemm_planar expects float32 or float64 planes, "
                        f"got {ar.dtype}")
    if any(x.dtype != ar.dtype for x in (ai, br, bi)):
        raise TypeError("gemm_planar: all four planes must share one dtype")
    _check_nu(ar.dtype, num_moduli)
    if op_a in ("T", "C"):
        ar, ai = ar.T, ai.T
    if op_b in ("T", "C"):
        br, bi = br.T, bi.T
    return emulate_matmul_complex_planar(
        ar, ai, br, bi, num_moduli=num_moduli, fastmode=fastmode,
        backend=backend, conj_a=(op_a == "C"), conj_b=(op_b == "C"),
        epilogue=epilogue)


# ---------------------------------------------------------------------------
# herk: C = alpha * A @ A^H + beta * C
# ---------------------------------------------------------------------------

def _herk_rhs_lanes(pa, num_moduli, backend):
    """A^H's rhs lane plane sets from A's lhs lanes: (rr, -ri, rr-ri), each
    rewrapped in int16 (-(-128) overflows int8 for p = 256), then transposed.
    The transposed planes are k-contiguous, as the int8 product reads B."""
    neg_i, diff = [], []
    for i, p in enumerate(tables.moduli(backend)[:num_moduli]):
        rr = pa[0, i].to(torch.int16)
        ri = pa[1, i].to(torch.int16)
        neg_i.append(_wrap(-ri, p).to(torch.int8))
        diff.append(_wrap(rr - ri, p).to(torch.int8))
    lanes = torch.stack([pa[0], torch.stack(neg_i), torch.stack(diff)])
    return lanes.transpose(-1, -2)


@span("entry")
def _herk(ar, ai, *, num_moduli, fastmode, backend, trans, epilogue,
          out_dtype):
    _check_backend(backend)
    if trans:
        # A^H @ A = B @ B^H with B = A^H = conj(A).T
        ar, ai = ar.T, -ai.T
    mdim = ar.shape[0]
    if ar.device.type != "cpu":
        ar, ai = core._pad128(ar, (0, 1)), core._pad128(ai, (0, 1))
    ar, ai = ar.contiguous(), ai.contiguous()
    # one shift serves both sides: rows of A and columns of A^H carry the
    # same (|Re|, |Im|) populations
    sft, _ = shifts((ar, ai), None, num_moduli, fastmode, backend)
    pa = _quantize_complex(ar, ai, sft, 0, num_moduli, backend, conj=False)
    pb = _herk_rhs_lanes(pa, num_moduli, backend)
    out = _complex_product(pa, pb, sft, sft, num_moduli, backend, out_dtype,
                           epilogue)
    return _crop(out, mdim, mdim)


def _check_herk_backend(backend) -> None:
    if backend != tables.Backend.INT8:
        raise NotImplementedError(
            "herk supports the INT8 backend (FP8 split planes cannot derive "
            "the 3M difference lane); use gemm for FP8 Hermitian products, "
            "as in the JAX package")


def herk(a, *, trans: bool = False, num_moduli: int = 8, fastmode="robust",
         backend: str = tables.Backend.INT8, alpha=1.0, beta=0.0, c=None,
         epilogue: str = "auto", device="cuda") -> torch.Tensor:
    """Emulated Hermitian rank-k update: C = alpha * A @ A^H + beta * C
    (trans=True: alpha * A^H @ A + beta * C), alpha and beta real as in BLAS
    zherk. A^H's lane planes are transposed views plus two rewraps of A's,
    so A is encoded once. fastmode defaults to "robust"."""
    device = core._device(device)
    a = _operand(a, device)
    if a.dim() != 2:
        raise ValueError(f"herk expects a 2-D operand, got ndim={a.dim()}")
    if not a.dtype.is_complex:
        raise TypeError("herk is complex-only")
    _check_herk_backend(backend)
    _check_nu(a.dtype, num_moduli)
    out = _herk(a.real, a.imag, num_moduli=num_moduli, fastmode=fastmode,
                backend=backend, trans=bool(trans), epilogue=epilogue,
                out_dtype=a.dtype)
    # alpha and beta: their real parts, rounded to the real dtype, then
    # promoted to complex and multiplied, as jnp multiplies a real scalar by a
    # complex array
    def real(v):
        return torch.tensor(_complex_scalar(v).real, dtype=torch.float64,
                            device=out.device).to(kernels.REAL_DTYPE[a.dtype]
                                                  ).to(a.dtype)

    if not (isinstance(alpha, (int, float)) and alpha == 1):
        out = _cmul(real(alpha), out)
    if c is not None and not (isinstance(beta, (int, float)) and beta == 0):
        c = _operand(c, device)
        out = out + (c if isinstance(beta, (int, float)) and beta == 1
                     else _cmul(real(beta), c))
    return out


def herk_planar(ar, ai, *, trans: bool = False, num_moduli: int = 8,
                fastmode="robust", backend: str = tables.Backend.INT8,
                epilogue: str = "auto", device="cuda"):
    """Planar herk: (Ar, Ai) -> (Cr, Ci) = A @ A^H on separate real planes;
    bit-equal to herk() on complex views of the same data."""
    device = core._device(device)
    ar, ai = core._as_tensor(ar, device), core._as_tensor(ai, device)
    if ar.dtype not in (torch.float32, torch.float64) or ai.dtype != ar.dtype:
        raise TypeError("herk_planar expects two float32 or float64 planes")
    _check_nu(ar.dtype, num_moduli)
    _check_herk_backend(backend)
    return _herk(ar, ai, num_moduli=num_moduli, fastmode=fastmode,
                 backend=backend, trans=bool(trans), epilogue=epilogue,
                 out_dtype=ar.dtype)


# ---------------------------------------------------------------------------
# batched: (B, m, k) @ (B, k, n)
# ---------------------------------------------------------------------------

def gemm_batched_complex(a, b, *, num_moduli: int = 8, fastmode=True,
                         backend: str = tables.Backend.INT8,
                         epilogue: str = "auto"):
    """Emulated batched complex GEMM: (B, m, k) @ (B, k, n) -> (B, m, n) on
    complex64 or complex128 tensors; each batch element runs the 3M
    pipeline. The complex branch of core.gemm_batched, which places the
    operands and checks their shapes. Bit-equal to gemmul8_tpu's (a vmap)
    on the CPU."""
    if a.dtype not in (torch.complex64, torch.complex128):
        raise TypeError(f"gemm_batched_complex expects complex64 or "
                        f"complex128, got {a.dtype}")
    _check_nu(a.dtype, num_moduli)
    _check_backend(backend)
    if a.shape[0] == 0:
        return core.empty_batch(a, b)
    # a conjugate or negative view is materialized first, as in _operand
    a, b = (x.resolve_conj().resolve_neg() for x in (a, b))
    return core.batched(functools.partial(
        emulate_matmul_complex, num_moduli=num_moduli, fastmode=fastmode,
        backend=backend, epilogue=epilogue), a, b)


def gemm_batched_planar(ar, ai, br, bi, *, num_moduli: int = 8,
                        fastmode=True, backend: str = tables.Backend.INT8,
                        epilogue: str = "auto", device="cuda"):
    """Batched planar complex GEMM: (B,m,k) + (B,m,k) x (B,k,n) + (B,k,n) ->
    ((B,m,n), (B,m,n)); bit-equal to gemm_batched on complex views of the
    same data."""
    device = core._device(device)
    ar, ai, br, bi = (core._as_tensor(x, device) for x in (ar, ai, br, bi))
    if ar.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"gemm_batched_planar expects float32 or float64 "
                        f"planes, got {ar.dtype}")
    if any(x.dtype != ar.dtype for x in (ai, br, bi)):
        raise TypeError("gemm_batched_planar: all four planes must share "
                        "one dtype")
    if (ar.dim() != 3 or ai.shape != ar.shape or bi.shape != br.shape
            or br.dim() != 3 or br.shape[0] != ar.shape[0]
            or br.shape[1] != ar.shape[2]):
        raise ValueError(
            f"gemm_batched_planar expects (B, m, k) and (B, k, n) planes; got "
            f"{tuple(ar.shape)} and {tuple(br.shape)}")
    _check_nu(ar.dtype, num_moduli)
    _check_backend(backend)
    if ar.shape[0] == 0:
        return core.empty_batch(ar, br), core.empty_batch(ai, bi)
    return core.batched(functools.partial(
        emulate_matmul_complex_planar, num_moduli=num_moduli,
        fastmode=fastmode, backend=backend, epilogue=epilogue),
        ar, ai, br, bi)
