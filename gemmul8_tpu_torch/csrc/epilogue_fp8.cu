// FP8 fused epilogue: per output element, reassemble each FP8 modulus'
// residue from its three split products, then the CRT in 16-bit int32 limbs,
// the fold of P * rint(t / P), the descale, and the output dtype emitted
// directly.
//
// Replaces: gemmul8_tpu/pallas_kernels.py, fused_epilogue_fp8 (its body
// _epilogue_kernel_fp8 and _wrap_bal). Its plain version is fp8._reassemble
// -> int16 -> ff.reconstruct_scale_ff, which it equals bit for bit: the
// input is the (3nu, m, n) f32 stack of exact integer lane products
// (|C| <= 2^24), and per modulus
//   square p = q^2:  r = wrap(q * wrap(C0 + C1) + wrap(C2)),
//   Karatsuba:       r = wrap(256*wrap(C0) + 16*(wrap(C2) - wrap(C0) -
//                    wrap(C1)) + wrap(C1)),
// each wrap the unique representative in [-p/2, p/2) (crt.cuh's wrap_any),
// so r is the plain version's residue whatever the order of the exact steps.
// The CRT, carry, quotient fold and both descales are crt.cuh's, shared with
// the other epilogues: f32 out in the descale_accel order, f64 out through
// the full-range f64 descale.
//
// Bound on the H100: device memory. Each element reads 3nu f32 (168 B at
// nu=14) and writes 4 or 8 bytes: 11.8 GB at 8192^2, nu=14, f64, 3.5 ms at
// 3.35 TB/s. The operations the function needs (per modulus three
// conversions, three or four reductions by the constant p and the recombine,
// then the CRT pipeline: chip_smoke.fp8_epilogue_bound) take less. The
// reductions are crt.cuh's division-free wrap, shared with K2 and K4.
//
// Design: one thread per element along n, so each of the 3nu planes is read
// coalesced; limbs in registers; the plan a __grid_constant__ parameter.
// Nothing but the output is written.
#include "crt.cuh"

namespace {

// the residue of FP8 modulus qi's product from its three lane products
__device__ __forceinline__ int reassemble_fp8(float f0, float f1, float f2,
                                              const EpiloguePlan& crt, int qi,
                                              int q) {
    const int c0 = (int)f0, c1 = (int)f1, c2 = (int)f2;   // exact integers
    int t;
    if (q != 0) {                           // |c0 + c1| <= 2^25
        t = q * wrap_any(c0 + c1, crt, qi) + wrap_any(c2, crt, qi);
    } else {
        const int r0 = wrap_any(c0, crt, qi), r1 = wrap_any(c1, crt, qi);
        t = 256 * r0 + 16 * (wrap_any(c2, crt, qi) - r0 - r1) + r1;
    }
    return wrap_any(t, crt, qi);
}

template <bool F64>
__global__ void epilogue_fp8_kernel(const float* __restrict__ c3,
                                    const int* __restrict__ sfta,
                                    const int* __restrict__ sftb,
                                    void* __restrict__ out, int m, int n,
                                    const __grid_constant__ EpiloguePlanFp8
                                        plan) {
    const size_t mn = (size_t)m * n;
    const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= mn) return;
    const int i = (int)(idx / n);
    const int j = (int)(idx - (size_t)i * n);

    const EpiloguePlan& crt = plan.crt;
    int lim[G8_MAX_L];
    limbs_zero(lim);
    for (int q = 0; q < crt.nu; ++q) {
        const float* c = c3 + (size_t)(3 * q) * mn + idx;
        limbs_mac(lim, reassemble_fp8(c[0], c[mn], c[2 * mn], crt, q,
                                      plan.sq[q]), crt, q);
    }
    fold_quotient(lim, crt);
    if (F64)
        static_cast<double*>(out)[idx] = emit_f64(lim, crt, sfta[i] + sftb[j]);
    else
        static_cast<float*>(out)[idx] = emit_f32(
            lim, crt, descale_factors(sfta[i]), descale_factors(sftb[j]));
}

}  // namespace

// c3: (3nu, m, n) contiguous f32 lane products; sfta: int32 (m); sftb: int32
// (n); out: (m, n) f64 if out_f64 else f32.
// Returns the CUDA error of the launch (0 on success).
extern "C" int g8_fused_epilogue_fp8(const void* c3, const void* sfta,
                                     const void* sftb, void* out, int out_f64,
                                     int m, int n, const void* plan_ptr,
                                     void* stream) {
    const EpiloguePlanFp8& plan =
        *static_cast<const EpiloguePlanFp8*>(plan_ptr);
    if (plan.crt.nu < 1 || plan.crt.nu > G8_MAX_NU || plan.crt.L < 1
        || plan.crt.L > G8_MAX_L)
        return (int)cudaErrorInvalidValue;
    const size_t mn = (size_t)m * n;
    const int threads = 256;
    const size_t blocks = (mn + threads - 1) / threads;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* c = static_cast<const float*>(c3);
    const int* a = static_cast<const int*>(sfta);
    const int* b = static_cast<const int*>(sftb);
    if (out_f64)
        epilogue_fp8_kernel<true><<<(unsigned)blocks, threads, 0, st>>>(
            c, a, b, out, m, n, plan);
    else
        epilogue_fp8_kernel<false><<<(unsigned)blocks, threads, 0, st>>>(
            c, a, b, out, m, n, plan);
    return (int)cudaGetLastError();
}
