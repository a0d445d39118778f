"""Ozaki-scheme-II GEMM emulation in PyTorch: shifts (fast, robust or
accurate mode) -> residue planes -> exact low-precision products -> mod + CRT
+ descale -> alpha/beta epilogue; with syrk (one encode serves both sides),
gemm_batched, precomputed operands (precompute, gemm_quantized), the
memory-bounded striped path behind gemm, and gemm_with_phases. Complex
operands go to complex_gemm (the 3M scheme).

The counterpart of gemmul8_tpu/core.py. INT8 backend: one int8 plane and one
exact int8 product per modulus. FP8 backend (fp8.py): three e4m3 planes per
modulus and side and three FP8 products, reassembled mod p. On the card the
planes come from the encode kernels, the INT8 products from one launch of
the wgmma + TMA product kernel (csrc/matmul_i8_wgmma.cu), the FP8 products
from
torch._scaled_mm (the vendor product, as the JAX package leaves its dots to
XLA) and the "ff" epilogue from one fused kernel; on the CPU the same code
runs each kernel's plain version (torch._int_mm for the INT8 products).
Results are bit-equal to the JAX package on the CPU.

Each `x + y*z` that XLA:CPU contracts to an FMA under jit is written as
torch.addcmul, which computes the fused result, so the "f64" epilogue and the
alpha/beta epilogue match JAX bit for bit. XLA fuses the first product of
`p + q` when both are products, which _dot_fma and ab_epilogue follow.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from . import ff, fp8, kernels, quantize, tables
# core's names too: parallel.summa, probes.epilogue and the tests read
# mod_reduce here
from .quantize import _wrap, mod_reduce  # noqa: F401
from .spans import span

# int32 accumulation of int8 residue products is exact up to this K
# (|r| <= 128 -> product <= 2^14; 2^14 * 2^17 = 2^31)
K_CHUNK = 1 << 17

_DTYPE_NAMES = {torch.float32: "float32", torch.float64: "float64"}


@span("products")
def residue_matmul(a_planes: torch.Tensor, b_planes: torch.Tensor,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(nu, m, k) int8 @ (nu, k, n) int8 -> (nu, m, n) int32, exact, into a
    preallocated C_hi (`out` if given: contiguous). On the card one launch
    of the wgmma kernel for the whole stack (kernels.matmul_i8, which
    refuses planes TMA cannot address; the entries pad theirs to 128). On
    the CPU one torch._int_mm per modulus (int_mm_stack). Both are exact
    int32 sums: the bits are the same."""
    if a_planes.device.type == "cpu":
        return int_mm_stack(a_planes, b_planes, out)
    return kernels.matmul_i8(a_planes, b_planes, out=out)


def int_mm_stack(a_planes: torch.Tensor, b_planes: torch.Tensor,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The library's product of a plane stack: one torch._int_mm per modulus
    into a preallocated (nu, m, n) int32 C_hi (`out` if given); the CPU's
    products, and the reference the card's are held to."""
    nu, m, _ = a_planes.shape
    n = b_planes.shape[2]
    c_hi = out if out is not None else torch.empty(
        (nu, m, n), dtype=torch.int32, device=a_planes.device)
    for i in range(nu):
        quantize.int_mm(a_planes[i], b_planes[i], out=c_hi[i])
    return c_hi


@span("products")
def _chunked_residue_acc(a_planes, b_planes, num_moduli, backend):
    """K-chunked int32 residue accumulator: the sum of per-chunk [0, p)
    partial residues (exact; <= n_chunks * p < 2^31)."""
    mods = tables.moduli(backend)[:num_moduli]
    k = a_planes.shape[2]
    acc = None
    for lo in range(0, k, K_CHUNK):
        sl = slice(lo, min(lo + K_CHUNK, k))
        c_hi = residue_matmul(a_planes[:, :, sl], b_planes[:, sl, :])
        part = torch.stack([torch.remainder(c_hi[i], p)
                            for i, p in enumerate(mods)])
        acc = part if acc is None else acc + part
    return acc


def residue_gemm(a_planes: torch.Tensor, b_planes: torch.Tensor,
                 num_moduli: int, backend: str) -> torch.Tensor:
    """Full-K exact residue GEMM -> wrapped int8 C_mid (nu, m, n); K beyond
    K_CHUNK is summed in residue space."""
    if a_planes.shape[2] <= K_CHUNK:
        return mod_reduce(residue_matmul(a_planes, b_planes), num_moduli,
                          backend)
    acc = _chunked_residue_acc(a_planes, b_planes, num_moduli, backend)
    return mod_reduce(acc, num_moduli, backend)


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float64, device=like.device)


def _dot_fma(coefs, planes):
    """sum_i coefs[i] * planes[i] in order, contracted as XLA:CPU contracts
    `c0*p0 + c1*p1 + ...`: fma(c0, p0, c1*p1), then fma(c_i, p_i, acc)."""
    if len(planes) == 1:
        return coefs[0] * planes[0]
    acc = torch.addcmul(coefs[1] * planes[1], coefs[0], planes[0])
    for i in range(2, len(planes)):
        acc = torch.addcmul(acc, coefs[i], planes[i])
    return acc


def crt_reconstruct(c_mid: torch.Tensor, num_moduli: int, backend: str,
                    out_dtype) -> torch.Tensor:
    """Fixed-order CRT accumulation + wrap in f64 (reference:
    inverse_scaling_real.hpp:8-89): f64 values of the reconstructed integers
    t, |t| < P/2, before inverse scaling. Double-double accumulation when P
    exceeds f64 and the output is 64-bit."""
    use_dd = out_dtype == torch.float64 and num_moduli > tables.p_is_double(backend)
    invp = _scalar(tables.invP(num_moduli, backend), c_mid)
    pa, pb, pc = (_scalar(v, c_mid) for v in tables.P_q26(num_moduli, backend))
    planes = [c_mid[i].to(torch.float64) for i in range(num_moduli)]

    if not use_dd:
        qp = [_scalar(v, c_mid) for v in tables.qPi_f64(num_moduli, backend)]
        acc = _dot_fma(qp, planes)
        quot = torch.round(invp * acc)
        # t = P*quot + acc with Pa*quot exact (26-bit chunk x small int)
        return torch.addcmul(torch.addcmul(torch.addcmul(acc, pa, quot),
                                           pb, quot), pc, quot)

    qp = tables.qPi_dd(num_moduli, backend)
    # the hi parts sit on a common grid: their products are error-free
    hi = _dot_fma([_scalar(v, c_mid) for v in qp[:, 0]], planes)
    lo = _dot_fma([_scalar(v, c_mid) for v in qp[:, 1]], planes)
    quot = torch.round(invp * hi)
    return (torch.addcmul(torch.addcmul(hi, pa, quot), pb, quot)
            + torch.addcmul(lo, pc, quot))


def inverse_scale(t: torch.Tensor, sft_a: torch.Tensor, sft_b: torch.Tensor,
                  out_dtype) -> torch.Tensor:
    """C = t * 2^-(sftA[i]+sftB[j]), computed in the output dtype."""
    sft_sum = sft_a[:, None] + sft_b[None, :]
    return quantize.pow2_scale(t.to(out_dtype), -sft_sum)


# ---------------------------------------------------------------------------
# the gemm pipeline
# ---------------------------------------------------------------------------

# Accurate mode's shifts (scaling_accu_real.hpp) come in three stages, each
# a function of its own so that they can be timed apart: the upper-bound
# planes, their estimation product, and the shifts from its maxima. Each
# side's entry from accurate_extract holds its planes first and its pre-shift
# last (complex_gemm's lanes keep that layout). b=None stands for A.T, as in
# syrk: its planes are A's transposed and one shift serves both sides.

def accurate_extract(a, b, backend):
    """((ub_a, pre_a), (ub_b, pre_b)): the bound planes and pre-shifts of A's
    rows and B's columns; ((ub_a, pre_a), None) for b=None."""
    ext_a = quantize.extract_ub_plane(a, backend, scale_axis=0)
    if b is None:
        return ext_a, None
    return ext_a, quantize.extract_ub_plane(b, backend, scale_axis=1)


def accurate_estimate(ext, backend):
    """The estimation product of the bound planes: it bounds |A||B| per
    element."""
    ub_a = ext[0][0]
    ub_b = ub_a.T if ext[1] is None else ext[1][0]
    return quantize.estimate_gemm(ub_a, ub_b, backend)


def accurate_combine(bound, ext, num_moduli, backend):
    """Each row's (column's) maximum of the bound sets A's (B's) shift; for
    b=None the bound is symmetric and its row maxima serve both sides."""
    sft_a = quantize.shift_accu_from_chi(torch.amax(bound, dim=1), ext[0][-1],
                                         num_moduli, backend)
    if ext[1] is None:
        return sft_a, sft_a
    return sft_a, quantize.shift_accu_from_chi(torch.amax(bound, dim=0),
                                               ext[1][-1], num_moduli, backend)


def fast_shift(x, num_moduli, fastmode, backend, reduce_axis):
    """Fast mode's shifts of x's rows (reduce_axis=1) or columns (0):
    norm-based (scaling_fast_real.hpp), or scale-invariant for
    fastmode="robust"."""
    var = "invariant" if fastmode == "robust" else "reference"
    return quantize.shift_fast(x, num_moduli, backend,
                               reduce_axis=reduce_axis, variant=var)


@span("shifts")
def shifts(a, b, num_moduli, fastmode, backend):
    """(sft_a, sft_b) of A's rows and B's columns. Fast mode: independent
    norm-based shifts (scaling_fast_real.hpp); fastmode="robust" takes the
    scale-invariant shift; accurate mode (fastmode=False) the estimation
    product's. b=None stands for A.T: one shift serves both sides."""
    if not fastmode:
        ext = accurate_extract(a, b, backend)
        return accurate_combine(accurate_estimate(ext, backend), ext,
                                num_moduli, backend)
    sft_a = fast_shift(a, num_moduli, fastmode, backend, 1)
    if b is None:
        return sft_a, sft_a
    return sft_a, fast_shift(b, num_moduli, fastmode, backend, 0)


def encode_side(x, sft, scale_axis, num_moduli, backend):
    """One operand's planes: K1's int8 planes, or K6's (3nu, ...) e4m3 stack
    in the side's slot order. On the card B's (scale_axis=1) come back as a
    (planes, k, n) view of k-contiguous storage, the layout the tensor-core
    products read."""
    if backend == tables.Backend.FP8:
        return kernels.encode_planes_fp8(x, sft, scale_axis, num_moduli)
    return kernels.encode_planes(x, sft, scale_axis, num_moduli, backend)


def _quantize_operands(a, b, num_moduli, fastmode, backend):
    sft_a, sft_b = shifts(a, b, num_moduli, fastmode, backend)
    return (encode_side(a, sft_a, 0, num_moduli, backend), sft_a,
            encode_side(b, sft_b, 1, num_moduli, backend), sft_b)


def _norm_trans(t, name: str) -> bool:
    """BLAS trans flag -> bool ("C" == "T" for reals). Accepts python and
    numpy bools/ints plus the strings N/T/C (any case); anything else raises."""
    if isinstance(t, (bool, np.bool_, int, np.integer)):
        return bool(t)
    if t is None:
        return False
    s = str(t).upper()
    if s not in ("N", "T", "C"):
        raise ValueError(
            f"{name} must be a bool or one of 'N'/'T'/'C', got {t!r}")
    return s in ("T", "C")


def resolve_epilogue(epilogue: str = "auto", device="cpu") -> str:
    """Pick the CRT reconstruction arithmetic: "f64" (double/double-double,
    like the reference) or "ff" (exact int32 limbs; one fused kernel on the
    card). "auto" is "f64" on the CPU and "ff" on the card, as in the JAX
    package."""
    if epilogue != "auto":
        if epilogue not in ("ff", "f64"):
            raise ValueError(
                f"epilogue must be 'auto', 'ff' or 'f64', got {epilogue!r}")
        return epilogue
    return "f64" if torch.device(device).type == "cpu" else "ff"


def reconstruct_scale(c_mid, sft_a, sft_b, num_moduli, backend, out_dtype,
                      epilogue: str):
    if resolve_epilogue(epilogue, c_mid.device) == "ff":
        return ff.reconstruct_scale_ff(c_mid, sft_a, sft_b, num_moduli,
                                       backend, out_dtype)
    t = crt_reconstruct(c_mid, num_moduli, backend, out_dtype)
    return inverse_scale(t, sft_a, sft_b, out_dtype)


def _emulated_product(a_planes, sft_a, b_planes, sft_b, num_moduli, backend,
                      out_dtype, epilogue, fold=None):
    """Residue GEMM + epilogue from encoded planes. With "ff" the int32
    products (or their K-chunked residue sums) go straight into the fused
    epilogue kernel, which emits the output dtype (with `fold`, a
    kernels.AlphaBeta that folds_alpha_beta admitted, alpha * ab + beta * C);
    on the FP8 backend the f32 lane products go into the FP8 epilogue kernel,
    and K-chunked residue sums into the real one."""
    ff_epilogue = resolve_epilogue(epilogue, a_planes.device) == "ff"
    if backend == tables.Backend.FP8:
        if not ff_epilogue:
            c_mid = fp8.residue_gemm_fp8(a_planes, b_planes, num_moduli)
            return reconstruct_scale(c_mid, sft_a, sft_b, num_moduli, backend,
                                     out_dtype, epilogue)
        if a_planes.shape[2] <= fp8.K_CHUNK_FP8:
            c3 = fp8.residue_matmul_fp8(a_planes, b_planes)
            return kernels.fused_epilogue_fp8(c3, sft_a, sft_b, num_moduli,
                                              out_dtype)
        acc = fp8._chunked_residue_acc(a_planes, b_planes, num_moduli)
        return kernels.fused_epilogue(acc, sft_a, sft_b, num_moduli, backend,
                                      out_dtype)
    if ff_epilogue:
        if a_planes.shape[2] <= K_CHUNK:
            c_hi = residue_matmul(a_planes, b_planes)
        else:
            c_hi = _chunked_residue_acc(a_planes, b_planes, num_moduli,
                                        backend)
        return kernels.fused_epilogue(c_hi, sft_a, sft_b, num_moduli,
                                      backend, out_dtype, ab=fold)
    c_mid = residue_gemm(a_planes, b_planes, num_moduli, backend)
    return reconstruct_scale(c_mid, sft_a, sft_b, num_moduli, backend,
                             out_dtype, epilogue)


@span("entry")
def _pad128(x: torch.Tensor, axes) -> torch.Tensor:
    """Zero-pad the given axes up to multiples of 128 (exactness-preserving:
    zero rows/cols give zero planes, zero products and sft=0)."""
    pad = [0, 0] * x.dim()
    for ax in axes:
        # F.pad lists (before, after) pairs from the last axis backwards
        pad[2 * (x.dim() - 1 - ax) + 1] = (-x.shape[ax]) % 128
    return torch.nn.functional.pad(x, pad) if any(pad) else x


def _on_card(device) -> bool:
    return torch.device(device).type != "cpu"


@span("entry")
def emulate_matmul(a: torch.Tensor, b: torch.Tensor, *, num_moduli: int,
                   fastmode=True, backend: str = tables.Backend.INT8,
                   epilogue: str = "auto", fold=None) -> torch.Tensor:
    """Emulated a @ b on a's device (alpha * a @ b + beta * C with `fold`,
    gemm's route through K2: folds_alpha_beta). On the card, operands are
    zero-padded to multiples of 128 (the products' shape rules) and the
    output is sliced back -- bit-identical to the unpadded math."""
    out_dtype = a.dtype
    m, n = a.shape[0], b.shape[1]
    if a.shape[1] == 0:
        # BLAS k=0 semantics: the product is zero
        return torch.zeros((m, n), dtype=out_dtype, device=a.device)
    if _on_card(a.device):
        a = _pad128(a, (0, 1))
        b = _pad128(b, (0, 1))
    a_planes, sft_a, b_planes, sft_b = _quantize_operands(
        a.contiguous(), b.contiguous(), num_moduli, fastmode, backend)
    out = _emulated_product(a_planes, sft_a, b_planes, sft_b, num_moduli,
                            backend, out_dtype, epilogue, fold)
    if out.shape != (m, n):
        out = out[:m, :n]
    return out


@span("alpha_beta")
def ab_epilogue(ab, c, alpha, beta, *, has_c, epilogue, trivial_alpha,
                beta_kind):
    """alpha * ab + beta * c as the JAX package's jitted _gemm_real computes
    it (core.py:330-350), for every real entry with an emulated product ab
    that does not fold alpha and beta into K2 (folds_alpha_beta): the CPU,
    FP8, striped calls, compat's reuse of precomputed operands; so that no
    route changes the bits. The arithmetic is kernels.alpha_beta_plain,
    K2's, but for one case of the "f64" epilogue."""
    # Where XLA:CPU contracts ab + beta*c depends on what produced ab
    # (pinned by tests/test_torch_gemm_ops.py): with the f64 epilogue's f64
    # output, ab ends in an exact power-of-two multiply, so it stays two
    # roundings
    if (has_c and beta_kind == "general" and trivial_alpha
            and ab.dtype == torch.float64
            and resolve_epilogue(epilogue, ab.device) == "f64"):
        return ab + torch.tensor(beta, dtype=torch.float64,
                                 device=ab.device) * c
    return kernels.alpha_beta_plain(ab, kernels.AlphaBeta(
        c if has_c else None, alpha, beta, trivial_alpha, beta_kind))


def folds_alpha_beta(device, backend, epilogue, *, trivial_alpha, beta_kind,
                     has_c) -> bool:
    """Whether an unstriped real call applies alpha and beta in K2's store
    (kernels.AlphaBeta) in place of ab_epilogue's pass over the output and
    its blocking copy of alpha: on the card, on the INT8 backend with the
    "ff" epilogue, unless alpha is 1 and no C is read."""
    return (_on_card(device) and backend == tables.Backend.INT8
            and resolve_epilogue(epilogue, device) == "ff"
            and not (trivial_alpha and (beta_kind == "zero" or not has_c)))


def scalar_kinds(alpha, beta) -> tuple[bool, str]:
    """(trivial_alpha, beta_kind): python-number alpha == 1 and beta in
    {0, 1} take the special cases of ab_epilogue; beta == 0 never reads C."""
    trivial_alpha = isinstance(alpha, (int, float)) and alpha == 1
    beta_kind = ("zero" if isinstance(beta, (int, float)) and beta == 0
                 else "one" if isinstance(beta, (int, float)) and beta == 1
                 else "general")
    return trivial_alpha, beta_kind


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but CUDA is not available; pass "
                           "device='cpu' to compute on the CPU")
    return device


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


def _real_scalar(v) -> float:
    return float(np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v))


def _check_nu(dtype, num_moduli) -> None:
    lo, hi = tables.VALID_RANGE[_DTYPE_NAMES[dtype]]
    if not lo <= num_moduli <= hi:
        raise ValueError(
            f"num_moduli={num_moduli} out of range [{lo},{hi}] for {dtype}")


@span("entry")
def gemm(a, b, *, num_moduli: int = 8, fastmode=True,
         backend: str = tables.Backend.INT8, alpha=1.0, beta=0.0, c=None,
         trans_a=False, trans_b=False, epilogue: str = "auto",
         m_block: Optional[int] = None, n_block: Optional[int] = None,
         device="cuda") -> torch.Tensor:
    """Emulated high-precision GEMM: C = alpha * op(A) @ op(B) + beta * C.

    a, b (and c): torch tensors or numpy arrays, placed on `device` ("cuda"
    by default; "cpu" runs every kernel's plain version). `num_moduli` dials
    accuracy vs speed (2..13 for f32/complex64, 2..20 for f64/complex128).
    backend="INT8" (int8 tensor cores) or "FP8" (e4m3 split planes on the FP8
    tensor cores, three products per modulus; real operands only).
    Complex operands take ops "N"/"T"/"C" and complex alpha/beta
    (complex_gemm.gemm_complex). Bit-equal to gemmul8_tpu.gemm on the CPU.

    Real shapes whose workspace (work_bytes) exceeds the card's budget are
    striped over N (and M) by pick_blocking, bit-equal to the unstriped
    call; m_block/n_block force stripe widths (on the CPU too).
    """
    device = _device(device)
    a = _as_tensor(a, device)
    b = _as_tensor(b, device)
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(
            f"gemm expects 2-D operands, got A.ndim={a.dim()}, B.ndim={b.dim()}")
    if a.dtype != b.dtype:
        raise TypeError(f"dtype mismatch: {a.dtype} vs {b.dtype}")
    if backend not in (tables.Backend.INT8, tables.Backend.FP8):
        raise ValueError(f"backend must be 'INT8' or 'FP8', got {backend!r}")
    if a.dtype.is_complex:
        # as in the JAX package, m_block/n_block are not passed on
        from . import complex_gemm
        return complex_gemm.gemm_complex(
            a, b, num_moduli=num_moduli, fastmode=fastmode, backend=backend,
            alpha=alpha, beta=beta, c=c, trans_a=trans_a, trans_b=trans_b,
            epilogue=epilogue, device=device)
    if a.dtype not in _DTYPE_NAMES:
        raise TypeError(f"gemm supports float32 and float64, got {a.dtype}")
    _check_nu(a.dtype, num_moduli)
    trans_a = _norm_trans(trans_a, "trans_a")
    trans_b = _norm_trans(trans_b, "trans_b")
    has_c = c is not None
    trivial_alpha, beta_kind = scalar_kinds(alpha, beta)
    if has_c and beta_kind != "zero":
        c = _as_tensor(c, device)
        if c.dtype != a.dtype:
            raise TypeError(f"dtype mismatch: C is {c.dtype}, A is {a.dtype}")
    # memory-gated M/N striping (pick_blocking on the card; explicit
    # m_block/n_block force it)
    at = a.T if trans_a else a
    bt = b.T if trans_b else b
    (m_eff, k_eff), n_eff = at.shape, bt.shape[1]
    if m_block is None and n_block is None and k_eff > 0:
        m_block, n_block = pick_blocking(m_eff, n_eff, k_eff, num_moduli,
                                         a.dtype, backend, device=device)
    mode = dict(num_moduli=num_moduli, fastmode=fastmode, backend=backend,
                epilogue=epilogue)
    alpha, beta = _real_scalar(alpha), _real_scalar(beta)
    if (m_block is not None or n_block is not None) and k_eff > 0:
        ab = emulate_matmul_blocked(at, bt, n_block=n_block or n_eff,
                                    m_block=m_block, **mode)
    elif k_eff > 0 and folds_alpha_beta(device, backend, epilogue,
                                        trivial_alpha=trivial_alpha,
                                        beta_kind=beta_kind, has_c=has_c):
        reads_c = has_c and beta_kind != "zero"
        if reads_c:
            # K2 reads C in place: row-strided views and broadcast rows too;
            # any other layout becomes an exact contiguous copy
            c = c.expand(m_eff, n_eff)
            if n_eff > 1 and c.stride(1) != 1:
                c = c.contiguous()
        return emulate_matmul(at, bt, fold=kernels.AlphaBeta(
            c if reads_c else None, alpha, beta, trivial_alpha, beta_kind),
            **mode)
    else:
        ab = emulate_matmul(at, bt, **mode)
    return ab_epilogue(ab, c, alpha, beta, has_c=has_c, epilogue=epilogue,
                       trivial_alpha=trivial_alpha, beta_kind=beta_kind)


def matmul(a, b, **kw) -> torch.Tensor:
    """NumPy-style convenience wrapper around :func:`gemm`."""
    return gemm(a, b, **kw)


def batched(fn, *xs):
    """fn(x0[i], x1[i], ...) stacked over a batch of one element or more; fn
    returns a tensor or a tuple of them."""
    outs = [fn(*item) for item in zip(*xs)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(x) for x in zip(*outs))
    return torch.stack(outs)


def empty_batch(a, b):
    """The (0, m, n) result of an empty batch of (0, m, k) @ (0, k, n)."""
    return torch.empty((0, a.shape[1], b.shape[2]), dtype=a.dtype,
                       device=a.device)


def gemm_batched(a, b, *, num_moduli: int = 8, fastmode=True,
                 backend: str = tables.Backend.INT8, epilogue: str = "auto",
                 device="cuda") -> torch.Tensor:
    """Emulated batched GEMM: (B, m, k) @ (B, k, n) -> (B, m, n), real or
    complex, on `device`. Each batch element runs the full pipeline of
    :func:`gemm` (no alpha/beta); bit-equal to gemmul8_tpu.gemm_batched (a
    vmap of its emulate_matmul) on the CPU."""
    device = _device(device)
    a = _as_tensor(a, device)
    b = _as_tensor(b, device)
    if (a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0]
            or a.shape[2] != b.shape[1]):
        raise ValueError(
            f"gemm_batched expects (B, m, k) and (B, k, n); got "
            f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != b.dtype:
        raise TypeError(f"dtype mismatch: {a.dtype} vs {b.dtype}")
    if backend not in (tables.Backend.INT8, tables.Backend.FP8):
        raise ValueError(f"backend must be 'INT8' or 'FP8', got {backend!r}")
    if a.dtype.is_complex:
        from . import complex_gemm
        return complex_gemm.gemm_batched_complex(
            a, b, num_moduli=num_moduli, fastmode=fastmode, backend=backend,
            epilogue=epilogue)
    if a.dtype not in _DTYPE_NAMES:
        raise TypeError(f"gemm_batched supports float32 and float64, got "
                        f"{a.dtype}")
    _check_nu(a.dtype, num_moduli)
    if a.shape[0] == 0:
        return empty_batch(a, b)
    return batched(functools.partial(
        emulate_matmul, num_moduli=num_moduli, fastmode=fastmode,
        backend=backend, epilogue=epilogue), a, b)


@span("entry")
def _syrk(a, *, num_moduli, fastmode, backend, trans, epilogue):
    if trans:
        a = a.T
    out_dtype = a.dtype
    mdim = a.shape[0]
    if a.shape[1] == 0:
        return torch.zeros((mdim, mdim), dtype=out_dtype, device=a.device)
    if a.device.type != "cpu":
        a = _pad128(a, (0, 1))
    a = a.contiguous()
    # one encode serves both sides: rows of A and columns of A.T carry the
    # same shifts and the same quantized integers, so the rhs planes are a
    # transposed view of the lhs planes (k-contiguous, as the products read B)
    sft, _ = shifts(a, None, num_moduli, fastmode, backend)
    pa = encode_side(a, sft, 0, num_moduli, backend)
    if backend == tables.Backend.FP8:
        # the rhs takes the cross-slot order for the square moduli
        pb = fp8.lhs_to_rhs_stack(pa, num_moduli).transpose(-1, -2)
    else:
        pb = pa.transpose(-1, -2)
    out = _emulated_product(pa, sft, pb, sft, num_moduli, backend, out_dtype,
                            epilogue)
    return out if out.shape == (mdim, mdim) else out[:mdim, :mdim]


def syrk(a, *, trans: bool = False, num_moduli: int = 8, fastmode="robust",
         backend: str = tables.Backend.INT8, alpha=1.0, beta=0.0, c=None,
         epilogue: str = "auto", device="cuda") -> torch.Tensor:
    """Emulated symmetric rank-k update: C = alpha * A @ A.T + beta * C
    (trans=True: alpha * A.T @ A + beta * C) on `device`. A is encoded once:
    the rhs planes are a transposed view of the lhs planes. fastmode
    defaults to "robust" (a Gram product's diagonal meets the
    Cauchy-Schwarz bound with equality). Bit-equal to gemmul8_tpu.syrk on
    the CPU."""
    device = _device(device)
    a = _as_tensor(a, device)
    if a.dim() != 2:
        raise ValueError(f"syrk expects a 2-D operand, got ndim={a.dim()}")
    if a.dtype.is_complex:
        raise NotImplementedError(
            "syrk is real-only; use herk (A @ A^H) or gemm for complex")
    if a.dtype not in _DTYPE_NAMES:
        raise TypeError(f"syrk supports float32 and float64, got {a.dtype}")
    if backend not in (tables.Backend.INT8, tables.Backend.FP8):
        raise ValueError(f"backend must be 'INT8' or 'FP8', got {backend!r}")
    _check_nu(a.dtype, num_moduli)
    out = _syrk(a, num_moduli=num_moduli, fastmode=fastmode, backend=backend,
                trans=bool(trans), epilogue=epilogue)
    def scalar(v):
        return torch.tensor(_real_scalar(v), dtype=torch.float64,
                            device=device).to(out.dtype)

    # alpha and beta as the JAX twin applies them, outside its jit: two
    # roundings, no fused multiply-add
    if not (isinstance(alpha, (int, float)) and alpha == 1):
        out = scalar(alpha) * out
    if c is not None and not (isinstance(beta, (int, float)) and beta == 0):
        c = _as_tensor(c, device)
        if c.dtype != out.dtype:
            raise TypeError(
                f"dtype mismatch: C is {c.dtype}, A is {out.dtype}")
        out = out + (c if isinstance(beta, (int, float)) and beta == 1
                     else scalar(beta) * c)
    return out


# ---------------------------------------------------------------------------
# memory-bounded M/N-striped path (big single-card shapes)
# ---------------------------------------------------------------------------

def _is_complex(dtype) -> bool:
    if isinstance(dtype, torch.dtype):
        return dtype.is_complex
    return np.dtype(dtype).kind == "c"


def plane_bytes(rows: int, cols: int, num_moduli: int, dtype=torch.float64,
                backend: str = tables.Backend.INT8) -> int:
    """work_bytes' count of one operand's residue planes: num_moduli planes
    (times the 3M lanes on complex) of rows x cols, one byte an element on
    INT8 and six on FP8."""
    lanes = 3 if _is_complex(dtype) else 1
    plane_b = 6 if backend == tables.Backend.FP8 else 1
    return num_moduli * lanes * rows * cols * plane_b


def work_bytes(m: int, n: int, k: int, num_moduli: int,
               dtype=torch.float64, backend: str = tables.Backend.INT8) -> int:
    """Planning estimate of one emulated GEMM's peak temporary memory in
    bytes, the JAX package's formula (the analog of gemmul8::workSize,
    gemmul8_real.hpp:8-47): A and B residue planes + C_hi + C_mid + shift
    vectors. FP8 counts 3 two-byte planes and 3 f32 products a modulus, as
    the JAX package's bf16 planes take (the port's e4m3 stack takes half
    the plane bytes); complex counts the 3M lanes. `dtype`: a torch dtype,
    numpy dtype or name."""
    lanes = 3 if _is_complex(dtype) else 1
    prod = 3 if backend == tables.Backend.FP8 else 1
    mid_b = 2 if backend == tables.Backend.FP8 else 1
    planes_a = plane_bytes(m, k, num_moduli, dtype, backend)
    planes_b = plane_bytes(k, n, num_moduli, dtype, backend)
    c_hi = num_moduli * lanes * prod * m * n * 4
    c_mid = num_moduli * (2 if lanes == 3 else 1) * m * n * mid_b
    return planes_a + planes_b + c_hi + c_mid + 4 * (m + n)


@functools.lru_cache(maxsize=None)
def _total_memory(index: int) -> int:
    return torch.cuda.get_device_properties(index).total_memory


def device_budget_bytes(device) -> int:
    """The bytes one call on a CUDA device may plan for: three quarters of
    the device's total memory less what PyTorch's allocator has allocated.
    Blocks the caching allocator holds reserved but unallocated count as
    available, since the next allocation reuses them (the free bytes of
    torch.cuda.mem_get_info count them as used); memory held by other
    processes on the same device is not seen. The quarter left covers what
    work_bytes does not count: the output, the operands' padded copies, the
    shifts' temporaries and the CUDA context. One allocator query a call
    (the total is read once per device)."""
    device = torch.device(device)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    stats = torch.cuda.memory_stats_as_nested_dict(index)
    allocated = stats["allocated_bytes"]["all"]["current"] if stats else 0
    return (_total_memory(index) - allocated) * 3 // 4


def pick_blocking(m: int, n: int, k: int, num_moduli: int, dtype,
                  backend: str = tables.Backend.INT8,
                  budget_bytes: Optional[int] = None, *, device="cuda"):
    """(m_block, n_block), or (None, None) for no striping: the reference's
    stripe widths (8192 halving to 1024; matmult.hpp:68-75) so that one
    stripe's work_bytes fits the budget. The budget: budget_bytes, else
    GEMMUL8_HBM_BUDGET_GB (GiB), else device_budget_bytes on a CUDA device;
    on the CPU, unbounded."""
    import os
    if budget_bytes is None:
        env = os.environ.get("GEMMUL8_HBM_BUDGET_GB")
        if env is not None:
            budget_bytes = int(float(env) * (1 << 30))
        elif torch.device(device).type == "cpu":
            return None, None
        else:
            budget_bytes = device_budget_bytes(torch.device(device))
    if work_bytes(m, n, k, num_moduli, dtype, backend) <= budget_bytes:
        return None, None
    for m_blk in (m, 8192, 4096, 2048, 1024):
        if m_blk > m:
            continue
        for n_blk in (8192, 4096, 2048, 1024):
            if n_blk > n:
                continue
            if work_bytes(min(m, m_blk), min(n, n_blk), k, num_moduli,
                          dtype, backend) <= budget_bytes:
                return (None if m_blk == m else m_blk), n_blk
    return 1024, 1024


def _stripe_operand(x, sft, scale_axis, num_moduli, backend):
    """One stripe's planes and shifts, padded to multiples of 128 on the card
    as emulate_matmul pads (zero rows or columns take shift 0)."""
    if x.device.type != "cpu":
        x = _pad128(x, (0, 1))
        sft = torch.nn.functional.pad(sft, (0, x.shape[scale_axis]
                                            - sft.shape[0]))
    x = x.contiguous()
    return encode_side(x, sft, scale_axis, num_moduli, backend), sft


@span("entry")
def emulate_matmul_blocked(a: torch.Tensor, b: torch.Tensor, *,
                           num_moduli: int, fastmode=True,
                           backend: str = tables.Backend.INT8,
                           epilogue: str = "auto", n_block: int = 8192,
                           m_block: Optional[int] = None) -> torch.Tensor:
    """Emulated a @ b in stripes of n_block columns (and m_block rows), each
    written into one preallocated output: peak temporary memory is about
    work_bytes(m_block, n_block, k) instead of work_bytes(m, n, k), the
    reference's bounded-workspace N blocking (matmult.hpp:68-75, 129-175).

    Bit-equal to emulate_matmul: a row's shift and planes depend on that row
    of A only, a column's on that column of B; in accurate mode the
    estimation product's row and column maxima are taken exactly across the
    whole tile grid before any encode. Real operands only."""
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if k == 0:
        return out.zero_()
    m_block = m if m_block is None else m_block
    m_starts = range(0, m, m_block)
    n_starts = range(0, n, n_block)

    if fastmode:
        # each stripe's shifts once; with M striped too, a B stripe's
        # encode is redone for each M stripe (its planes are not kept)
        sft_bs = [fast_shift(b[:, ni:ni + n_block], num_moduli, fastmode,
                             backend, 0) for ni in n_starts]
        for mi in m_starts:
            a_s = a[mi:mi + m_block]
            sft_a = fast_shift(a_s, num_moduli, fastmode, backend, 1)
            pa, sft_a = _stripe_operand(a_s, sft_a, 0, num_moduli, backend)
            for ni, sft_b in zip(n_starts, sft_bs):
                pb, sft_b = _stripe_operand(b[:, ni:ni + n_block], sft_b, 1,
                                            num_moduli, backend)
                o = out[mi:mi + m_block, ni:ni + n_block]
                o.copy_(_emulated_product(pa, sft_a, pb, sft_b, num_moduli,
                                          backend, a.dtype, epilogue)
                        [:o.shape[0], :o.shape[1]])
        return out

    # accurate mode, phase 1: the estimation product over the whole tile
    # grid, exact row and column maxima (a row's spans every N stripe, a
    # column's every M stripe: scaling_accu_real.hpp:142-226 at blocked
    # scale); each stripe's extraction once, then every stripe's shifts
    with span("shifts"):
        ext_a = [quantize.extract_ub_plane(a[mi:mi + m_block], backend,
                                           scale_axis=0) for mi in m_starts]
        row_max = [None] * len(m_starts)
        col_max = [None] * len(n_starts)
        pre_b = [None] * len(n_starts)
        for j, ni in enumerate(n_starts):
            ub_b, pre_b[j] = quantize.extract_ub_plane(
                b[:, ni:ni + n_block], backend, scale_axis=1)
            for i in range(len(m_starts)):
                est = quantize.estimate_gemm(ext_a[i][0], ub_b, backend)
                rm, cm = torch.amax(est, dim=1), torch.amax(est, dim=0)
                row_max[i] = rm if row_max[i] is None else torch.maximum(
                    row_max[i], rm)
                col_max[j] = cm if col_max[j] is None else torch.maximum(
                    col_max[j], cm)
        sft_as = [quantize.shift_accu_from_chi(rm, ext[1], num_moduli,
                                               backend)
                  for rm, ext in zip(row_max, ext_a)]
        sft_bs = [quantize.shift_accu_from_chi(cm, pre, num_moduli, backend)
                  for cm, pre in zip(col_max, pre_b)]
    # phase 2: encode and the product of each tile
    for mi, sft_a in zip(m_starts, sft_as):
        pa, sft_a = _stripe_operand(a[mi:mi + m_block], sft_a, 0, num_moduli,
                                    backend)
        for ni, sft_b in zip(n_starts, sft_bs):
            pb, sft_b = _stripe_operand(b[:, ni:ni + n_block], sft_b, 1,
                                        num_moduli, backend)
            o = out[mi:mi + m_block, ni:ni + n_block]
            o.copy_(_emulated_product(pa, sft_a, pb, sft_b, num_moduli,
                                      backend, a.dtype, epilogue)
                    [:o.shape[0], :o.shape[1]])
    return out


# ---------------------------------------------------------------------------
# phase timing: the unfused stages, each timed
# ---------------------------------------------------------------------------

PHASES = ("quantize", "matmul", "mod_reduce", "crt_inverse")


class _Clock:
    """Marks between stages: CUDA events on the device's current stream on
    the card (device time, no synchronization between stages),
    time.perf_counter on the CPU."""

    def __init__(self, device: torch.device):
        self.device = device
        self.marks = []

    def mark(self) -> None:
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self.device))
            self.marks.append(ev)
        else:
            import time
            self.marks.append(time.perf_counter())

    def seconds(self) -> list[float]:
        if self.device.type == "cuda":
            self.marks[-1].synchronize()
            return [a.elapsed_time(b) * 1e-3
                    for a, b in zip(self.marks, self.marks[1:])]
        return [b - a for a, b in zip(self.marks, self.marks[1:])]


def gemm_with_phases(a, b, *, num_moduli: int = 8, fastmode=True,
                     backend: str = tables.Backend.INT8, iters: int = 1,
                     epilogue: str = "auto", device="cuda"):
    """Emulated a @ b in four separately timed stages; returns (C, {phase:
    seconds}) with the phases of PHASES, averaged over `iters` runs after a
    warm-up: the reference's timer vector {scaling, low-precision GEMM,
    conv_hi2mid, inverse scaling} (gemmul8_real.hpp:67-68, 122-204).

    The stages are the unfused ones: quantize = shifts + encode (K1, or K6
    on FP8); matmul = the residue products (K-chunked residue sums past the
    exact bound); mod_reduce = core.mod_reduce (FP8: the reassembly of each
    modulus' three products), plain torch; crt_inverse = with the "ff"
    epilogue (the card's default) the fused epilogue kernel K2 on the
    reduced residues (int8, or on FP8 the int16 residues widened to int32,
    since K2 takes no int16 and K3 reads the unreduced products), else
    reconstruct_scale. C equals gemm's bits. Times come from CUDA events on
    the card, time.perf_counter on the CPU; gemm itself never syncs."""
    device = _device(device)
    a = _as_tensor(a, device)
    b = _as_tensor(b, device)
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"gemm_with_phases expects (m, k) and (k, n) "
                         f"operands, got {tuple(a.shape)}, {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _DTYPE_NAMES:
        raise TypeError(f"gemm_with_phases supports float32 and float64 "
                        f"operands of one dtype, got {a.dtype}, {b.dtype}")
    if backend not in (tables.Backend.INT8, tables.Backend.FP8):
        raise ValueError(f"backend must be 'INT8' or 'FP8', got {backend!r}")
    _check_nu(a.dtype, num_moduli)
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    out_dtype, (m, k), n = a.dtype, a.shape, b.shape[1]
    if device.type != "cpu":
        a = _pad128(a, (0, 1))
        b = _pad128(b, (0, 1))
    a, b = a.contiguous(), b.contiguous()
    is_fp8 = backend == tables.Backend.FP8
    chunked = k > (fp8.K_CHUNK_FP8 if is_fp8 else K_CHUNK)
    ff_epilogue = resolve_epilogue(epilogue, device) == "ff"

    def products(pa, pb):
        if is_fp8:
            return (fp8._chunked_residue_acc(pa, pb, num_moduli) if chunked
                    else fp8.residue_matmul_fp8(pa, pb))
        return (_chunked_residue_acc(pa, pb, num_moduli, backend) if chunked
                else residue_matmul(pa, pb))

    def reduce(c_hi):
        if is_fp8 and not chunked:
            return fp8._reassemble(c_hi.to(torch.int32),
                                   num_moduli).to(torch.int16)
        return mod_reduce(c_hi, num_moduli, backend)

    def crt_inverse(c_mid, sft_a, sft_b):
        if ff_epilogue:
            return kernels.fused_epilogue(
                c_mid.to(torch.int32) if is_fp8 else c_mid, sft_a, sft_b,
                num_moduli, backend, out_dtype)
        return reconstruct_scale(c_mid, sft_a, sft_b, num_moduli, backend,
                                 out_dtype, epilogue)

    totals = dict.fromkeys(PHASES, 0.0)
    for it in range(iters + 1):                 # run 0 warms up
        clock = _Clock(device)
        clock.mark()
        pa, sft_a, pb, sft_b = _quantize_operands(a, b, num_moduli, fastmode,
                                                  backend)
        clock.mark()
        c_hi = products(pa, pb)
        clock.mark()
        c_mid = reduce(c_hi)
        clock.mark()
        out = crt_inverse(c_mid, sft_a, sft_b)
        clock.mark()
        if it:
            for name, t in zip(PHASES, clock.seconds()):
                totals[name] += t
        del pa, pb, c_hi, c_mid
    return out[:m, :n], {p: t / iters for p, t in totals.items()}


# ---------------------------------------------------------------------------
# precomputed operands: the skip-scal analog
# ---------------------------------------------------------------------------

_SIDES = {"A": 0, "B": 1}


class QuantizedOperand:
    """One operand's residue planes and shifts, computed once (fast-mode
    shifts) and reused across GEMMs with the other side varying: the
    reference's enable_skip_scal / workA/workB reuse (README.md:216-256,
    hook.cu:87-107).

    planes: A's (nu, m, k) or B's (nu, k, n) int8 planes, or on FP8 the
    (3nu, ...) e4m3 stack (on the card B's a view of k-contiguous storage),
    padded to multiples of 128 on the card; sft: int32 shifts; side: "A"
    (row-scaled) or "B" (column-scaled); dims: the operand's shape before
    padding."""

    def __init__(self, planes, sft, side, num_moduli, fastmode, backend,
                 dims):
        self.planes = planes
        self.sft = sft
        self.side = side
        self.num_moduli = num_moduli
        self.fastmode = fastmode
        self.backend = backend
        self.dims = tuple(dims)


def precompute(x, side: str, *, num_moduli: int = 8,
               backend: str = tables.Backend.INT8,
               device="cuda") -> QuantizedOperand:
    """Quantize one operand once (fast-mode shifts, the JAX package's
    "reference" variant) for reuse: side="A" scales the rows of an (m, k)
    operand, side="B" the columns of a (k, n) one. On the card the operand
    is zero-padded to multiples of 128 as emulate_matmul pads it (zero rows
    and columns encode to zero planes with shift 0), and gemm_quantized
    cuts the output back to size."""
    if side not in _SIDES:
        raise ValueError(f"side must be 'A' or 'B', got {side!r}")
    if backend not in (tables.Backend.INT8, tables.Backend.FP8):
        raise ValueError(f"backend must be 'INT8' or 'FP8', got {backend!r}")
    device = _device(device)
    x = _as_tensor(x, device)
    if x.dim() != 2:
        raise ValueError(f"precompute expects a 2-D operand, got "
                         f"ndim={x.dim()}")
    if x.dtype not in _DTYPE_NAMES:
        raise TypeError(f"precompute supports float32 and float64, got "
                        f"{x.dtype}")
    _check_nu(x.dtype, num_moduli)
    axis = _SIDES[side]
    if x.shape[1 - axis] == 0:
        raise ValueError("precompute needs k > 0 (the shifts reduce over k)")
    dims = tuple(x.shape)
    if device.type != "cpu":
        x = _pad128(x, (0, 1))
    x = x.contiguous()
    sft = fast_shift(x, num_moduli, True, backend, 1 - axis)
    planes = encode_side(x, sft, axis, num_moduli, backend)
    return QuantizedOperand(planes, sft, side, num_moduli, True, backend,
                            dims)


def quantized_from_numpy(planes, sft, side: str, num_moduli: int,
                         backend: str, dims, device="cuda") -> QuantizedOperand:
    """A QuantizedOperand from a JAX one's arrays (np.asarray of its planes
    and sft), INT8 only: JAX's (nu, m, k) or (nu, k, n) int8 planes go to
    `device`, zero-padded to multiples of 128 on the card with B's planes
    k-contiguous, the layout precompute gives."""
    if backend != tables.Backend.INT8:
        raise ValueError("quantized_from_numpy takes INT8 planes; the FP8 "
                         "planes' layouts differ (the JAX package's CPU "
                         "planes are (nu, 3, m, k) bf16)")
    if side not in _SIDES:
        raise ValueError(f"side must be 'A' or 'B', got {side!r}")
    device = _device(device)
    planes = torch.from_numpy(np.array(planes, np.int8))
    sft = torch.from_numpy(np.array(sft, np.int32))
    if planes.shape != (num_moduli, *dims):
        raise ValueError(f"planes of shape {tuple(planes.shape)} do not "
                         f"hold {num_moduli} planes of {tuple(dims)}")
    if device.type != "cpu":
        axis = _SIDES[side]
        planes = _pad128(planes, (1, 2))
        sft = torch.nn.functional.pad(sft, (0, planes.shape[1 + axis]
                                            - sft.shape[0]))
        buf = kernels.plane_buffer((num_moduli,), *planes.shape[1:], axis,
                                   device)
        planes = buf.copy_(planes)
    return QuantizedOperand(planes.to(device), sft.to(device), side,
                            num_moduli, True, backend, dims)


def gemm_quantized(qa, qb, out_dtype=torch.float64,
                   epilogue: str = "auto") -> torch.Tensor:
    """GEMM from precomputed operands on their device. Either side may
    instead be a raw operand, quantized on the fly with the other side's
    num_moduli and backend: the reference's one-sided skip_scalA /
    skip_scalB reuse (gemmul8_real.hpp:123-139). A raw operand on both
    sides raises TypeError: call gemm."""
    if (not isinstance(qa, QuantizedOperand)
            and not isinstance(qb, QuantizedOperand)):
        raise TypeError("at least one side must be a precomputed "
                        "QuantizedOperand; use gemm() otherwise")
    ref = qa if isinstance(qa, QuantizedOperand) else qb
    kw = dict(num_moduli=ref.num_moduli, backend=ref.backend,
              device=ref.planes.device)
    if not isinstance(qa, QuantizedOperand):
        qa = precompute(qa, "A", **kw)
    if not isinstance(qb, QuantizedOperand):
        qb = precompute(qb, "B", **kw)
    if qa.side != "A" or qb.side != "B":
        raise ValueError(f"gemm_quantized takes side A then side B, got "
                         f"{qa.side} and {qb.side}")
    if (qa.num_moduli, qa.backend) != (qb.num_moduli, qb.backend):
        raise ValueError(
            f"operands precomputed with different settings: "
            f"{(qa.num_moduli, qa.backend)} and {(qb.num_moduli, qb.backend)}")
    if qa.dims[1] != qb.dims[0] or qa.planes.device != qb.planes.device:
        raise ValueError(f"cannot multiply {qa.dims} on {qa.planes.device} "
                         f"by {qb.dims} on {qb.planes.device}")
    m, n = qa.dims[0], qb.dims[1]
    out = _emulated_product(qa.planes, qa.sft, qb.planes, qb.sft,
                            qa.num_moduli, qa.backend, out_dtype, epilogue)
    return out if out.shape == (m, n) else out[:m, :n]
