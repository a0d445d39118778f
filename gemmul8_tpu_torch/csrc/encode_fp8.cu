// FP8 residue-plane encoder: quantize one operand by per-row (A) or
// per-column (B) powers of two, reduce modulo each FP8 modulus and split each
// residue without error into e4m3-exact integers in [-16, 16], emitted as the
// (3nu, rows, cols) GEMM-ready stack of this side's slot order.
//
// Replaces: gemmul8_tpu/pallas_kernels.py, encode_planes_fp8_tiles (its body
// _encode_kernel_fp8). Semantics are those of the plain version,
// fp8._gemm_stack(fp8.split_planes(quantize.residues_wrapped(...))): the
// limbs and residues are the INT8 encoder's (encode.cuh, one code path), then
//   square moduli p = q^2:  bx = rint(r * f32(1/q)), by = r - q*bx, bz = 0
//                           (in f32, uncontracted, as split_planes);
//   the other moduli:       bx = sign(r) * ((|r| + 15) >> 4),
//                           by = r - 16*bx, bz = bx + by;
// and the three values go to the stack's slots of this modulus as e4m3 (the
// TPU kernel carries them in bf16; both hold them exactly).
//
// Bound on the H100: the bytes, about level with the 32-bit operations. Per
// element the function reads the 4- or 8-byte input and writes 3nu bytes
// (50 B at nu=14 f64: 1.0 ms at 8192^2); the operations are the INT8
// encoder's preamble plus, per modulus, the limb dot, a reduction by the
// constant p, the split and three conversions (chip_smoke.fp8_encode_bound).
// The limb steps and the division-free reduction (a multiply-high by the
// plan's magic, limb count a template parameter) are encode.cuh's, shared
// with the INT8 encoder.
//
// Design: one thread per element, limbs in registers, the plan a
// __grid_constant__ parameter, warps along the output's contiguous axis.
// A's stack is (3nu, m, k) row-major; B's is stored (3nu, n, k), so each B
// plane is the column-major operand the FP8 tensor-core product
// (torch._scaled_mm) reads.
#include <cuda_fp8.h>

#include "encode.cuh"

namespace {

__device__ __forceinline__ __nv_fp8_storage_t to_e4m3(float v) {
    return __nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3);
}

template <typename T, int AXIS, int NL>
__global__ void encode_fp8_kernel(const T* __restrict__ x,
                                  const int* __restrict__ sft,
                                  __nv_fp8_storage_t* __restrict__ out,
                                  const __grid_constant__ EncodePlanFp8 plan,
                                  int rows, int cols) {
    const EncodeIndex<AXIS> at(rows, cols);
    if (at.r >= rows || at.c >= cols) return;
    int lim[NL];
    const Pow2Split<T> scale(sft[AXIS == 0 ? at.r : at.c]);
    quantize_limbs<T, NL>(scale.apply(x[(size_t)at.r * cols + at.c]),
                          plan.enc.max_exp, lim);
    const size_t plane = (size_t)rows * cols;
    for (int i = 0; i < plan.enc.nu; ++i) {
        const int r = limb_residue<NL>(lim, plan.enc, i);
        float v0, v1, v2;
        const int q = plan.sq[i];
        if (q != 0) {                       // perfect square: r = q*bx + by
            const float rf = (float)r;
            v0 = rintf(rf * plan.inv_sq[i]);
            v1 = rf - (float)q * v0;
            v2 = 0.0f;
        } else {                            // Karatsuba: r = 16*bx + by
            const int mag = (abs(r) + 15) >> 4;
            const int bx = r < 0 ? -mag : mag;
            const int by = r - 16 * bx;
            v0 = (float)bx;
            v1 = (float)by;
            v2 = (float)(bx + by);
        }
#pragma unroll
        for (int s = 0; s < 3; ++s) {
            const int sl = plan.slot[3 * i + s];
            out[(3 * i + s) * plane + at.pos] =
                to_e4m3(sl == 0 ? v0 : (sl == 1 ? v1 : v2));
        }
    }
}

template <typename T, int AXIS>
int launch(const void* x, const void* sft, void* out,
           const EncodePlanFp8& plan, int rows, int cols, dim3 grid,
           dim3 block, cudaStream_t stream) {
    return dispatch_nl(plan.enc.nl, [&](auto nl) {
        encode_fp8_kernel<T, AXIS, decltype(nl)::value>
            <<<grid, block, 0, stream>>>(
                static_cast<const T*>(x), static_cast<const int*>(sft),
                static_cast<__nv_fp8_storage_t*>(out), plan, rows, cols);
        return (int)cudaGetLastError();
    });
}

}  // namespace

// x: (rows, cols) contiguous f32 or f64; sft: int32 per row (scale_axis 0)
// or per column (1); out: 3nu e4m3 planes as described above. Returns the
// CUDA error of the launch (0 on success).
extern "C" int g8_encode_planes_fp8(const void* x, const void* sft, void* out,
                                    const void* plan_ptr, int is_f64,
                                    int scale_axis, int rows, int cols,
                                    void* stream) {
    const EncodePlanFp8& plan = *static_cast<const EncodePlanFp8*>(plan_ptr);
    dim3 grid, block;
    if (plan.enc.nu < 1 || plan.enc.nu > G8_MAX_NU
        || !encode_grid(scale_axis, rows, cols, grid, block))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (is_f64)
        return scale_axis == 0
            ? launch<double, 0>(x, sft, out, plan, rows, cols, grid, block, st)
            : launch<double, 1>(x, sft, out, plan, rows, cols, grid, block, st);
    return scale_axis == 0
        ? launch<float, 0>(x, sft, out, plan, rows, cols, grid, block, st)
        : launch<float, 1>(x, sft, out, plan, rows, cols, grid, block, st);
}
