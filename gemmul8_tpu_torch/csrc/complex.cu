// Complex (3M) epilogues. The input is the (3nu, m, n) int32 stack of lane
// products, Crr planes then Cii then Crii (or their K-chunked residue sums).
// Per output element and modulus, both kernels wrap the three lane values and
// recombine them in residue space, Re = Crr - Cii and Im = Crii - Crr - Cii
// (crt.cuh: lane_recombine_3m, one function for both, as their bit-identity
// contract needs).
//
// fused_epilogue_complex (nu <= 16) then runs two CRT pipelines (limbs,
// carry, quotient fold, descale) that share the row and column shift factors
// and writes Re and Im in the output dtype, planar or interleaved into a
// complex tensor.
//   Replaces: gemmul8_tpu/pallas_kernels.py, fused_epilogue_complex (body
//   _epilogue_kernel_cplx, _lane_recombine_3m). Plain version: mod_reduce per
//   lane -> complex_gemm._recombine_3m -> 2 x ff.reconstruct_scale_ff. f64 out
//   uses the full-range f64 descale, f32 out the descale_accel op order, as
//   the real epilogue does (epilogue.cu).
//   Bound on the H100: device memory. Each element reads 3nu * 4 bytes and
//   writes 2 output values: at 8192^2, nu=16, complex128 out, 192 + 16 bytes,
//   14.0 GB, 4.2 ms at 3.35 TB/s; the operations (about twice the real
//   epilogue's, chip_smoke.complex_epilogue_bound) take about half that.
//
// fused_recombine_3m (nu > 16) writes the recombined residues as two
// (nu, m, n) int8 stacks; two passes of the real epilogue on them
// (epilogue.cu, int8 input) finish the product.
//   Replaces: gemmul8_tpu/pallas_kernels.py, fused_recombine_3m (body
//   _recombine_kernel_cplx). Plain version: mod_reduce per lane ->
//   complex_gemm._recombine_3m.
//   Bound on the H100: device memory, 12nu bytes read and 2nu written per
//   element: at 8192^2, nu=20, 18.8 GB, 5.6 ms.
//
// Design: one thread per element along n, as in the real epilogue, so each of
// the 3nu planes is read coalesced; limbs stay in registers; the static plan
// travels as a __grid_constant__ kernel parameter.
#include "crt.cuh"

namespace {

template <bool F64>
__global__ void epilogue_complex_kernel(const int* __restrict__ chi,
                                        const int* __restrict__ sfta,
                                        const int* __restrict__ sftb,
                                        void* __restrict__ out_re,
                                        void* __restrict__ out_im,
                                        int stride, int m, int n,
                                        const __grid_constant__ EpiloguePlan plan) {
    const size_t mn = (size_t)m * n;
    const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= mn) return;
    const int i = (int)(idx / n);
    const int j = (int)(idx - (size_t)i * n);
    const int nu = plan.nu;

    int lre[G8_MAX_L], lim[G8_MAX_L];
    limbs_zero(lre);
    limbs_zero(lim);
    for (int q = 0; q < nu; ++q) {
        int re, im;
        lane_recombine_3m(chi[q * mn + idx], chi[(nu + q) * mn + idx],
                          chi[(2 * nu + q) * mn + idx], plan.p[q], re, im);
        limbs_mac(lre, re, plan, q);
        limbs_mac(lim, im, plan, q);
    }
    fold_quotient(lre, plan);
    fold_quotient(lim, plan);
    const size_t o = idx * (size_t)stride;
    if (F64) {
        const int ss = sfta[i] + sftb[j];
        static_cast<double*>(out_re)[o] = emit_f64(lre, plan, ss);
        static_cast<double*>(out_im)[o] = emit_f64(lim, plan, ss);
    } else {
        const Pow2x3 fa = descale_factors(sfta[i]);
        const Pow2x3 fb = descale_factors(sftb[j]);
        static_cast<float*>(out_re)[o] = emit_f32(lre, plan, fa, fb);
        static_cast<float*>(out_im)[o] = emit_f32(lim, plan, fa, fb);
    }
}

__global__ void recombine_3m_kernel(const int* __restrict__ chi,
                                    int8_t* __restrict__ out_re,
                                    int8_t* __restrict__ out_im, int m, int n,
                                    const __grid_constant__ EpiloguePlan plan) {
    const size_t mn = (size_t)m * n;
    const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= mn) return;
    const int nu = plan.nu;
    for (int q = 0; q < nu; ++q) {
        int re, im;
        lane_recombine_3m(chi[q * mn + idx], chi[(nu + q) * mn + idx],
                          chi[(2 * nu + q) * mn + idx], plan.p[q], re, im);
        out_re[q * mn + idx] = (int8_t)re;
        out_im[q * mn + idx] = (int8_t)im;
    }
}

int grid_for(int m, int n, int threads, unsigned* blocks) {
    const size_t b = ((size_t)m * n + threads - 1) / threads;
    if (b > 0x7fffffff) return (int)cudaErrorInvalidValue;
    *blocks = (unsigned)b;
    return 0;
}

}  // namespace

// chi: (3nu, m, n) contiguous int32; sfta: int32 (m); sftb: int32 (n);
// out_re, out_im: element (i, j) at [(i * n + j) * stride], f64 if out_f64
// else f32 (stride 1 for planar outputs, 2 for the two halves of a complex
// tensor). Returns the CUDA error of the launch (0 on success).
extern "C" int g8_fused_epilogue_complex(const void* chi, const void* sfta,
                                         const void* sftb, void* out_re,
                                         void* out_im, int stride, int out_f64,
                                         int m, int n, const void* plan_ptr,
                                         void* stream) {
    const EpiloguePlan& plan = *static_cast<const EpiloguePlan*>(plan_ptr);
    if (plan.nu < 1 || plan.nu > G8_MAX_NU || plan.L < 1 || plan.L > G8_MAX_L
            || stride < 1)
        return (int)cudaErrorInvalidValue;
    const int threads = 256;
    unsigned blocks;
    if (int err = grid_for(m, n, threads, &blocks)) return err;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* c = static_cast<const int*>(chi);
    const int* a = static_cast<const int*>(sfta);
    const int* b = static_cast<const int*>(sftb);
    if (out_f64)
        epilogue_complex_kernel<true><<<blocks, threads, 0, st>>>(
            c, a, b, out_re, out_im, stride, m, n, plan);
    else
        epilogue_complex_kernel<false><<<blocks, threads, 0, st>>>(
            c, a, b, out_re, out_im, stride, m, n, plan);
    return (int)cudaGetLastError();
}

// chi: (3nu, m, n) contiguous int32; out_re, out_im: (nu, m, n) contiguous
// int8. Only the plan's nu and moduli are read.
extern "C" int g8_fused_recombine_3m(const void* chi, void* out_re,
                                     void* out_im, int m, int n,
                                     const void* plan_ptr, void* stream) {
    const EpiloguePlan& plan = *static_cast<const EpiloguePlan*>(plan_ptr);
    if (plan.nu < 1 || plan.nu > G8_MAX_NU) return (int)cudaErrorInvalidValue;
    const int threads = 256;
    unsigned blocks;
    if (int err = grid_for(m, n, threads, &blocks)) return err;
    recombine_3m_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(chi), static_cast<int8_t*>(out_re),
        static_cast<int8_t*>(out_im), m, n, plan);
    return (int)cudaGetLastError();
}
