// Fused epilogue: per output element, wrap each of the nu residue products
// mod p_i, accumulate the CRT sum in 16-bit int32 limbs, carry, fold
// P * rint(t / P), carry again, undo the power-of-two scaling and emit the
// output dtype directly. The input is int32 (C_hi or K-chunked residue sums)
// or int8 (the wrapped residues fused_recombine_3m emits, on which the wrap is
// the identity).
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
// The steps are crt.cuh's, shared with the complex epilogue (complex.cu).
//
// Bound on the H100: device memory. Each element reads nu * 4 bytes of C_hi
// (4.3 GB at 8192^2, nu=16: 1.44 ms at 3.35 TB/s), or nu bytes of int8
// residues, and writes 4 or 8 bytes. The operations the function needs (per
// modulus a reduction by the constant p and L multiply-adds, two carry passes,
// the quotient, the descale: about 380 32-bit operations per element,
// chip_smoke.epilogue_bound) take about half the bytes' time on int32 input.
// This kernel reduces with `%` by a modulus read from the plan at run time, a
// full integer division, so it issues more.
//
// Design: one thread per element along n, so every modulus plane is read
// coalesced; limbs stay in registers; the static plan travels as a
// __grid_constant__ kernel parameter. Nothing but the output is written.
#include "crt.cuh"

namespace {

template <typename T, bool F64>
__global__ void epilogue_kernel(const T* __restrict__ chi,
                                const int* __restrict__ sfta,
                                const int* __restrict__ sftb,
                                void* __restrict__ out, int m, int n,
                                const __grid_constant__ EpiloguePlan plan) {
    const size_t mn = (size_t)m * n;
    const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= mn) return;
    const int i = (int)(idx / n);
    const int j = (int)(idx - (size_t)i * n);

    int lim[G8_MAX_L];
    limbs_zero(lim);
    for (int q = 0; q < plan.nu; ++q)
        limbs_mac(lim, wrap_any((int)chi[q * mn + idx], plan.p[q]), plan, q);
    fold_quotient(lim, plan);
    if (F64)
        static_cast<double*>(out)[idx] = emit_f64(lim, plan, sfta[i] + sftb[j]);
    else
        static_cast<float*>(out)[idx] = emit_f32(
            lim, plan, descale_factors(sfta[i]), descale_factors(sftb[j]));
}

template <typename T>
void launch(const void* chi, const int* a, const int* b, void* out,
            int out_f64, int m, int n, const EpiloguePlan& plan,
            unsigned blocks, int threads, cudaStream_t st) {
    const T* c = static_cast<const T*>(chi);
    if (out_f64)
        epilogue_kernel<T, true><<<blocks, threads, 0, st>>>(c, a, b, out, m,
                                                             n, plan);
    else
        epilogue_kernel<T, false><<<blocks, threads, 0, st>>>(c, a, b, out, m,
                                                              n, plan);
}

}  // namespace

// chi: (nu, m, n) contiguous, int8 if in_i8 else int32 (C_hi, K-chunked
// residue sums or wrapped residues); sfta: int32 (m); sftb: int32 (n);
// out: (m, n) f64 if out_f64 else f32.
// Returns the CUDA error of the launch (0 on success).
extern "C" int g8_fused_epilogue(const void* chi, const void* sfta,
                                 const void* sftb, void* out, int in_i8,
                                 int out_f64, int m, int n,
                                 const void* plan_ptr, void* stream) {
    const EpiloguePlan& plan = *static_cast<const EpiloguePlan*>(plan_ptr);
    if (plan.nu < 1 || plan.nu > G8_MAX_NU || plan.L < 1 || plan.L > G8_MAX_L)
        return (int)cudaErrorInvalidValue;
    const size_t mn = (size_t)m * n;
    const int threads = 256;
    const size_t blocks = (mn + threads - 1) / threads;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* a = static_cast<const int*>(sfta);
    const int* b = static_cast<const int*>(sftb);
    if (in_i8)
        launch<int8_t>(chi, a, b, out, out_f64, m, n, plan, (unsigned)blocks,
                       threads, st);
    else
        launch<int>(chi, a, b, out, out_f64, m, n, plan, (unsigned)blocks,
                    threads, st);
    return (int)cudaGetLastError();
}
