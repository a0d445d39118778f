// Fused epilogue: per output element, wrap each of the nu int32 residue
// products mod p_i, accumulate the CRT sum in 16-bit int32 limbs, carry, fold
// P * rint(t / P), carry again, undo the power-of-two scaling and emit the
// output dtype directly.
//
// Replaces: gemmul8_tpu/pallas_kernels.py, fused_epilogue (its body
// _wrap_full, _crt_limbs_from_res, _descale_factors, _descale_emit,
// _epilogue_kernel and the plan _epilogue_plan). Its plain version is
// core.mod_reduce -> ff.reconstruct_scale_ff, which it equals bit for bit:
//   f32 out: the rank-1 descale with the multiply-shift split of -sft and the
//            smallest-first two_sum merge, op for op (ff.descale_accel);
//   f64 out: each limb scaled in f64 by pow2_scale's floor split over the full
//            exponent range and summed highest first (the Pallas kernel's f32
//            pair cannot hold values outside f32's exponent range).
//
// Bound on the H100: device memory. Each element reads nu * 4 bytes of C_hi
// (4.3 GB at 8192^2, nu=16: 1.44 ms at 3.35 TB/s) and writes 4 or 8 bytes.
// The operations the function needs (per modulus a reduction by the constant
// p and L multiply-adds, two carry passes, the quotient, the descale: about
// 380 32-bit operations per element, chip_smoke.epilogue_bound) take about
// half the bytes' time. This kernel reduces with `%` by a modulus read from
// the plan at run time, a full integer division, so it issues more.
//
// Design: one thread per element along n, so every modulus plane is read
// coalesced; limbs stay in registers (loops unrolled to G8_MAX_L with a guard
// on the plan's L); the static plan travels by value as a kernel parameter.
// Nothing but the output is written.
#include "common.cuh"

namespace {

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

template <bool F64>
__global__ void epilogue_kernel(const int* __restrict__ chi,
                                const int* __restrict__ sfta,
                                const int* __restrict__ sftb,
                                void* __restrict__ out, int m, int n,
                                EpiloguePlan plan) {
    const size_t mn = (size_t)m * n;
    const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= mn) return;
    const int i = (int)(idx / n);
    const int j = (int)(idx - (size_t)i * n);
    const int L = plan.L;

    int lim[G8_MAX_L];
#pragma unroll
    for (int li = 0; li < G8_MAX_L; ++li) lim[li] = 0;
    for (int q = 0; q < plan.nu; ++q) {
        const int p = plan.p[q];
        const int v = chi[q * mn + idx];
        // the unique representative in [-p/2, p/2) of any int32 value
        const int r = (p & (p - 1)) == 0
            ? (int)(((unsigned)v + (unsigned)(p / 2)) & (unsigned)(p - 1)) - p / 2
            : wrap_mod(v, p);
#pragma unroll
        for (int li = 0; li < G8_MAX_L; ++li)
            if (li < L) lim[li] += r * plan.w16[q][li];   // < 2^31 in sum
    }
    carry16(lim, L);
    // quotient from the top (up to three) balanced limbs, in f32
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

    if (F64) {
        const int ss = sfta[i] + sftb[j];
        double acc = 0.0;
        first = true;
#pragma unroll
        for (int li = G8_MAX_L - 1; li >= 0; --li) {      // highest first
            if (li < L) {
                const double term = pow2_scale_d((double)lim[li],
                                                 plan.base + 16 * li - ss);
                acc = first ? term : acc + term;
                first = false;
            }
        }
        static_cast<double*>(out)[idx] = acc;
    } else {
        const int ta = -sfta[i];
        const int ha1 = (ta * 21846) >> 16;               // ~ta/3
        const int ra = ta - ha1;
        const int ha2 = ra >> 1;
        const float fa1 = pow2f(ha1), fa2 = pow2f(ha2), fa3 = pow2f(ra - ha2);
        const int tb = -sftb[j];
        const int hb1 = (tb * 21846) >> 16;
        const int rb = tb - hb1;
        const int hb2 = rb >> 1;
        const float fb1 = pow2f(hb1), fb2 = pow2f(hb2), fb3 = pow2f(rb - hb2);
        float hi = 0.0f, lo = 0.0f;
#pragma unroll
        for (int li = 0; li < G8_MAX_L; ++li) {           // smallest first
            if (li < L) {
                float term = (float)lim[li] * plan.s1[li];
                term = ((term * fa1) * fb1) * plan.s2[li];
                term = (term * fa2) * fb2;
                term = (term * fa3) * fb3;
                if (li == 0) {
                    hi = term;
                } else {                                  // two_sum (Knuth)
                    const float s = hi + term;
                    const float t = s - hi;
                    const float err = (hi - (s - t)) + (term - t);
                    hi = s;
                    lo = lo + err;
                }
            }
        }
        static_cast<float*>(out)[idx] = hi + lo;
    }
}

}  // namespace

// chi: (nu, m, n) contiguous int32 (C_hi or K-chunked residue sums);
// sfta: int32 (m); sftb: int32 (n); out: (m, n) f64 if out_f64 else f32.
// Returns the CUDA error of the launch (0 on success).
extern "C" int g8_fused_epilogue(const void* chi, const void* sfta,
                                 const void* sftb, void* out, int out_f64,
                                 int m, int n, const void* plan_ptr,
                                 void* stream) {
    const EpiloguePlan& plan = *static_cast<const EpiloguePlan*>(plan_ptr);
    if (plan.nu < 1 || plan.nu > G8_MAX_NU || plan.L < 1 || plan.L > G8_MAX_L)
        return (int)cudaErrorInvalidValue;
    const size_t mn = (size_t)m * n;
    const int threads = 256;
    const size_t blocks = (mn + threads - 1) / threads;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* c = static_cast<const int*>(chi);
    const int* a = static_cast<const int*>(sfta);
    const int* b = static_cast<const int*>(sftb);
    if (out_f64)
        epilogue_kernel<true><<<(unsigned)blocks, threads, 0, st>>>(
            c, a, b, out, m, n, plan);
    else
        epilogue_kernel<false><<<(unsigned)blocks, threads, 0, st>>>(
            c, a, b, out, m, n, plan);
    return (int)cudaGetLastError();
}
