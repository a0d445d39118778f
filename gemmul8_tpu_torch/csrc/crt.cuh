// The CRT epilogue's per-element steps, shared by the real fused epilogue
// (epilogue.cu) and the complex ones (complex.cu), so that they run the same
// code: the wrap of any int32 into [-p/2, p/2), the 3M lane recombine, the
// multiply-add into 16-bit int32 limbs, the balanced carry, the fold of
// P * rint(t / P) and the two descales. Limb arrays stay in registers: every
// loop over limbs is unrolled to G8_MAX_L with a guard on the plan's L.
//
// Each helper follows its plain PyTorch twin op for op (core.mod_reduce,
// complex_gemm._recombine_3m, ff.crt_limbs_matrix, ff.fold_quotient,
// ff.reconstruct_scale_ff, ff.descale_pair). The tensor-core CRT epilogue
// (epilogue_mxu.cu) shares the fold and the descale.
#pragma once

#include "common.cuh"

// the unique representative in [-p/2, p/2) of any int32 value (a mask for
// p = 256)
__device__ __forceinline__ int wrap_any(int v, int p) {
    return (p & (p - 1)) == 0
        ? (int)(((unsigned)v + (unsigned)(p / 2)) & (unsigned)(p - 1)) - p / 2
        : wrap_mod(v, p);
}

// 3M recombine of one modulus' three lane products (raw int32 sums):
// Re = Crr - Cii, Im = Crii - Crr - Cii, each wrapped into [-p/2, p/2).
// The wrapped lanes put re in (-p, p) and im in (-3p/2, 3p/2), so one
// correction each way lands both.
__device__ __forceinline__ void lane_recombine_3m(int crr, int cii, int cri,
                                                  int p, int& re, int& im) {
    crr = wrap_any(crr, p);
    cii = wrap_any(cii, p);
    cri = wrap_any(cri, p);
    re = crr - cii;
    if (2 * re >= p) re -= p;
    if (2 * re < -p) re += p;
    im = cri - crr - cii;
    if (2 * im >= p) im -= p;
    if (2 * im < -p) im += p;
}

__device__ __forceinline__ void limbs_zero(int* lim) {
#pragma unroll
    for (int li = 0; li < G8_MAX_L; ++li) lim[li] = 0;
}

// lim += r * (16-bit slices of qP_q >> base); |r * w16| < 2^26, nu-term
// sums < 2^31
__device__ __forceinline__ void limbs_mac(int* lim, int r,
                                          const EpiloguePlan& plan, int q) {
#pragma unroll
    for (int li = 0; li < G8_MAX_L; ++li)
        if (li < plan.L) lim[li] += r * plan.w16[q][li];
}

// balanced carry pass: every limb but the top into [-2^15, 2^15)
__device__ __forceinline__ void carry16(int* lim, int L) {
#pragma unroll
    for (int li = 0; li < G8_MAX_L - 1; ++li) {
        if (li < L - 1) {
            const int c = (lim[li] + (1 << 15)) >> 16;
            lim[li] -= c * (1 << 16);
            lim[li + 1] += c;
        }
    }
}

// carry, quotient rint(t / P) from the top (up to three) balanced limbs in
// f32, fold -quot * P, carry again: the limbs then sum to t, |t| < P/2
__device__ __forceinline__ void fold_quotient(int* lim,
                                              const EpiloguePlan& plan) {
    const int L = plan.L;
    carry16(lim, L);
    float t_top = 0.0f;
    bool first = true;
#pragma unroll
    for (int li = G8_MAX_L - 1; li >= 0; --li) {
        if (li < L && li >= L - 3) {
            t_top = first ? (float)lim[li] : t_top * 65536.0f + (float)lim[li];
            first = false;
        }
    }
    const int quot = (int)rintf(t_top * plan.invp_top);
#pragma unroll
    for (int li = 0; li < G8_MAX_L; ++li)
        if (li < L) lim[li] -= quot * plan.p16[li];
    carry16(lim, L);
}

// f64 out: each limb scaled by 2^(base + 16*li - ss) in f64 over the full
// exponent range (pow2_scale's floor split), summed highest first
__device__ __forceinline__ double emit_f64(const int* lim,
                                           const EpiloguePlan& plan, int ss) {
    double acc = 0.0;
    bool first = true;
#pragma unroll
    for (int li = G8_MAX_L - 1; li >= 0; --li) {
        if (li < plan.L) {
            const double term = pow2_scale_d((double)lim[li],
                                             plan.base + 16 * li - ss);
            acc = first ? term : acc + term;
            first = false;
        }
    }
    return acc;
}

// 2^-sft as three f32 powers of two, split by multiply-shift so that each
// stays normal for |sft| up to ~378 (ff._descale_factors)
struct Pow2x3 {
    float f1, f2, f3;
};

__device__ __forceinline__ Pow2x3 descale_factors(int sft) {
    const int t = -sft;
    const int h1 = (t * 21846) >> 16;                 // ~t/3
    const int r = t - h1;
    const int h2 = r >> 1;
    return {pow2f(h1), pow2f(h2), pow2f(r - h2)};
}

// the rank-1 descale with the static per-limb pow2 pair and the row and
// column factor triples, merged smallest first with two_sum: the (hi, lo)
// f32 pair (ff.descale_pair)
__device__ __forceinline__ void emit_pair(const int* lim,
                                          const EpiloguePlan& plan,
                                          const Pow2x3& fa, const Pow2x3& fb,
                                          float& hi, float& lo) {
    hi = 0.0f;
    lo = 0.0f;
#pragma unroll
    for (int li = 0; li < G8_MAX_L; ++li) {
        if (li < plan.L) {
            float term = (float)lim[li] * plan.s1[li];
            term = ((term * fa.f1) * fb.f1) * plan.s2[li];
            term = (term * fa.f2) * fb.f2;
            term = (term * fa.f3) * fb.f3;
            if (li == 0) {
                hi = term;
            } else {                                      // two_sum (Knuth)
                const float s = hi + term;
                const float t = s - hi;
                const float err = (hi - (s - t)) + (term - t);
                hi = s;
                lo = lo + err;
            }
        }
    }
}

// f32 out: the pair's sum (ff.descale_accel)
__device__ __forceinline__ float emit_f32(const int* lim,
                                          const EpiloguePlan& plan,
                                          const Pow2x3& fa, const Pow2x3& fb) {
    float hi, lo;
    emit_pair(lim, plan, fa, fb, hi, lo);
    return hi + lo;
}
