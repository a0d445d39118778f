// Residue-plane encoder: quantize one operand by per-row (A) or per-column (B)
// powers of two and emit wrap(v mod p_i) as int8 for each INT8 modulus.
//
// Replaces: gemmul8_tpu/pallas_kernels.py, encode_planes_tiles (its body
// _limbs_from_components and _encode_kernel). Semantics are those of
// quantize.residues_wrapped with three f32 components of an f64, which is the
// JAX package's CPU path and the plain version of this kernel: the input is
// scaled in its own dtype before the split, the scale uses the floor split of
// pow2_scale, and a component's bit position is clamped at max_exp.
//
// Bound on the H100: 32-bit operations, nearly level with the bytes. Per
// element the function needs the f64 scale, three component splits, the
// placement into up to six 20-bit limbs, a carry pass and, per modulus, a
// short dot with the static limb weights and a reduction by the constant p:
// about 250 32-bit operations at nu=16 for f64 (chip_smoke.encode_bound),
// 0.50 ms at 8192^2 against 0.48 ms for its 8 bytes read and nu written.
// This kernel reduces with `%` by a modulus read from the plan at run time,
// a full integer division, so it issues more than the function needs.
//
// Design: one thread per element, limbs in registers, the static plan (moduli
// and wrap(2^(20*lv) mod p)) passed by value as a __grid_constant__ kernel
// parameter, p = 256 by mask. The per-element steps are encode.cuh's, shared
// with the FP8 encoder (encode_fp8.cu). A block of 32x8 threads runs its 32 threads of a warp along the
// output's contiguous axis, so each warp writes 32 adjacent bytes per plane:
// A's planes are (nu, m, k) row-major, B's planes are stored (nu, n, k) --
// k-contiguous, the layout the int8 tensor-core product reads -- and B's
// strided reads are shared across the block's eight columns through L1.
#include "encode.cuh"

namespace {

template <typename T, int AXIS>
__global__ void encode_kernel(const T* __restrict__ x,
                              const int* __restrict__ sft,
                              int8_t* __restrict__ out,
                              const __grid_constant__ EncodePlan plan,
                              int rows, int cols) {
    const EncodeIndex<AXIS> at(rows, cols);
    if (at.r >= rows || at.c >= cols) return;
    int lim[G8_MAX_NL];
    quantize_limbs<T>(x[(size_t)at.r * cols + at.c],
                      sft[AXIS == 0 ? at.r : at.c], plan, lim);
    const size_t plane = (size_t)rows * cols;
    for (int i = 0; i < plan.nu; ++i)
        out[i * plane + at.pos] = (int8_t)limb_residue(lim, plan, i);
}

template <typename T, int AXIS>
void launch(const void* x, const void* sft, void* out, const EncodePlan& plan,
            int rows, int cols, dim3 grid, dim3 block, cudaStream_t stream) {
    encode_kernel<T, AXIS><<<grid, block, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const int*>(sft),
        static_cast<int8_t*>(out), plan, rows, cols);
}

}  // namespace

// x: (rows, cols) contiguous f32 or f64; sft: int32 per row (scale_axis 0)
// or per column (1); out: nu planes as described above. Returns the CUDA
// error of the launch (0 on success).
extern "C" int g8_encode_planes(const void* x, const void* sft, void* out,
                                const void* plan_ptr, int is_f64,
                                int scale_axis, int rows, int cols,
                                void* stream) {
    const EncodePlan& plan = *static_cast<const EncodePlan*>(plan_ptr);
    dim3 grid, block;
    if (plan.nu < 1 || plan.nu > G8_MAX_NU || plan.nl < 1
        || plan.nl > G8_MAX_NL
        || !encode_grid(scale_axis, rows, cols, grid, block))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (is_f64) {
        if (scale_axis == 0)
            launch<double, 0>(x, sft, out, plan, rows, cols, grid, block, st);
        else
            launch<double, 1>(x, sft, out, plan, rows, cols, grid, block, st);
    } else {
        if (scale_axis == 0)
            launch<float, 0>(x, sft, out, plan, rows, cols, grid, block, st);
        else
            launch<float, 1>(x, sft, out, plan, rows, cols, grid, block, st);
    }
    return (int)cudaGetLastError();
}
