"""Counterpart of tools/probe_epilogue.py on the card: the fused epilogue at
8192^2 nu=16 on a C_hi resident in device memory, two ways.

  A  K2 (csrc/epilogue.cu): int32 multiply-adds into 16-bit limbs; its f32
     route (the (hi, lo) pair summed, plan of 24 bits) and its f64 route.
  B  the tensor-core CRT epilogue (csrc/epilogue_mxu.cu): per modulus an f32
     wrap, the CRT sum as a u8 x s8 product against 8-bit columns of qPi,
     then K2's limbs, fold and descale, to the (hi, lo) pair; at out_bits 53
     (the tool's) and 24.

    python -m gemmul8_tpu_torch.probes.epilogue

bit-ok: A's outputs equal K2's plain version on rows 0-255; B at 24 bits
gives hi + lo equal to A's f32 output; B at 53 bits gives the (hi, lo) pair
of K2's plain steps (core.mod_reduce, ff.crt_limbs_matrix, ff.descale_pair)
on rows 0-255.
"""
from __future__ import annotations

import torch

from .. import core, ff, kernels
from .timing import cuda_ms, launches, require_cuda

_INT8 = "INT8"


def k2_pair_plain(c_hi, sft_a, sft_b, num_moduli, out_bits):
    """The (hi, lo) pair of K2's f32 route by its plain steps."""
    limbs, base = ff.crt_limbs_matrix(core.mod_reduce(c_hi, num_moduli, _INT8),
                                      num_moduli, _INT8, out_bits)
    return ff.descale_pair(limbs, base, 16, sft_a, sft_b)


def _bits(x):
    """The raw bits of an f32 or f64 tensor, as integers."""
    return x.contiguous().view(torch.int32 if x.dtype == torch.float32
                               else torch.int64)


def main(nu=16, m=8192, seed=0, reps=5, rows=256):
    """Both variants at nu planes of m x m, zero shifts; returns the rows
    (name, ms, ok, launches)."""
    require_cuda("probes.epilogue")
    print("device:", torch.cuda.get_device_name(0), flush=True)
    g = torch.Generator(device="cuda").manual_seed(seed)
    c_hi = torch.randint(-2 ** 30, 2 ** 30, (nu, m, m), dtype=torch.int32,
                         device="cuda", generator=g)
    sft = torch.zeros((m,), dtype=torch.int32, device="cuda")
    out = []

    def row(name, fn, check):
        """Time fn() after holding its first output with check; returns
        that output."""
        n0 = launches()
        y = fn()
        ok = check(y)
        ms = cuda_ms(fn, reps=reps)
        out.append(dict(name=name, ms=ms, ok=ok, launches=launches() - n0))
        print(f"{name}: {ms:8.3f} ms  bit-ok={ok}", flush=True)
        return y

    top, sft_top = c_hi[:, :rows].contiguous(), sft[:rows]

    def plain_k2(out_dtype):
        ref = kernels.fused_epilogue_plain(top, sft_top, sft, nu, _INT8,
                                           out_dtype)
        return lambda y: bool(torch.equal(_bits(y[:rows]), _bits(ref)))

    k2_f32 = row("A K2 f32", lambda: kernels.fused_epilogue(
        c_hi, sft, sft, nu, _INT8, torch.float32), plain_k2(torch.float32))
    row("A K2 f64", lambda: kernels.fused_epilogue(
        c_hi, sft, sft, nu, _INT8, torch.float64), plain_k2(torch.float64))
    ref_hi, ref_lo = k2_pair_plain(top, sft_top, sft, nu, 53)
    for out_bits in (53, 24):
        if out_bits == 53:
            check = lambda p: bool(  # noqa: E731
                torch.equal(_bits(p[0][:rows]), _bits(ref_hi))
                and torch.equal(_bits(p[1][:rows]), _bits(ref_lo)))
        else:
            check = lambda p: bool(  # noqa: E731
                torch.equal(_bits(p[0] + p[1]), _bits(k2_f32)))
        row(f"B mxu out_bits {out_bits}",
            lambda ob=out_bits: kernels.fused_epilogue_mxu(
                c_hi, sft, sft, nu, _INT8, ob), check)
    if not all(r["ok"] for r in out):
        raise AssertionError("probes.epilogue: the variants differ")
    return out


if __name__ == "__main__":
    main()
