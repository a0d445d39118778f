// Fused epilogue: per output element, wrap each of the nu residue products
// mod p_i, accumulate the CRT sum in 16-bit int32 limbs, carry, fold
// P * rint(t / P), carry again, undo the power-of-two scaling and emit the
// output dtype directly. The input is int32 (C_hi or K-chunked residue sums)
// or int8 (the wrapped residues fused_recombine_3m emits).
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
// Bound on the H100: device memory on int32 input. Each element reads
// nu * 4 bytes of C_hi (4.3 GB at 8192^2, nu=16: 1.44 ms at 3.35 TB/s), or nu
// bytes of int8 residues, and writes 4 or 8 bytes. The operations the
// function needs (per modulus a reduction by the constant p and L
// multiply-adds, two carry passes, the quotient, the descale: about 380
// 32-bit operations per element, chip_smoke.epilogue_bound) take about half
// the bytes' time on int32 input, and bound it on int8 input.
//
// Design: no division, and no instruction spent on the plan's limb count.
//   - The wrap of any int32 is crt.cuh's multiply-high (wrap_any); int8
//     input, whose values lie within one modulus of their wrap, takes one
//     correction each way (wrap_small).
//   - A 2-D grid of rows and column tiles (crt.cuh's Tile) gives each thread
//     one row and kCols = 4 consecutive columns, so the row's shift is read
//     once and no index is divided.
//   - Where every row's columns are whole vectors (n a multiple of 4, the
//     pointers 16-byte aligned: the wrapper's vec flag), each plane is one
//     16-byte (int32) or 4-byte (int8) load per thread and the output whole
//     16-byte stores; otherwise each thread loads and stores its columns one
//     by one. The planes are read kPlanes at a time, all loads issued before
//     the first is used: 64 bytes in flight per thread on int32.
//   - The kernel is built for each limb count L (2-7; 2-5 for f32 out), so
//     the limb loops carry no guard; f64 out takes crt.cuh's one-multiply
//     descale (emit_f64_direct) where it gives emit_f64's bits.
//   - Limbs stay in registers; the static plan travels as a __grid_constant__
//     kernel parameter. Nothing but the output is written.
#include <type_traits>

#include "crt.cuh"

namespace {

constexpr int kPlanes = 4;          // planes loaded before the first is used

constexpr int kCols = 4;            // columns a thread

template <typename T, bool F64, bool VEC, int L>
__global__ void __launch_bounds__(32 * G8_TILE_ROWS)
epilogue_kernel(const T* __restrict__ chi, const int* __restrict__ sfta,
                const int* __restrict__ sftb, void* __restrict__ out, int m,
                int n, const __grid_constant__ EpiloguePlan plan) {
    constexpr int V = kCols;
    constexpr LimbCount<L> nl{};
    using O = typename std::conditional<F64, double, float>::type;
    const Tile t = Tile::make<V>(n);
    if (t.nv == 0) return;
    const size_t mn = (size_t)m * n;
    const int nu = plan.nu;
    int sb[V];
#pragma unroll
    for (int v = 0; v < V; ++v) sb[v] = v < t.nv ? sftb[t.j0 + v] : 0;

    for (int i = t.i0; i < m; i += t.row_step) {
        const size_t off = (size_t)i * n + t.j0;
        int lim[V][G8_MAX_L];
#pragma unroll
        for (int v = 0; v < V; ++v) limbs_zero(lim[v]);
        for (int q0 = 0; q0 < nu; q0 += kPlanes) {
            int x[kPlanes][V];
#pragma unroll
            for (int u = 0; u < kPlanes; ++u)
                if (q0 + u < nu)
                    load_cols<V, VEC>(chi + (size_t)(q0 + u) * mn + off, t.nv,
                                      x[u]);
#pragma unroll
            for (int u = 0; u < kPlanes; ++u) {
                const int q = q0 + u;
                if (q < nu) {
#pragma unroll
                    for (int v = 0; v < V; ++v) {
                        const int r = sizeof(T) == 1
                            ? wrap_small(x[u][v], plan.p[q])
                            : wrap_any(x[u][v], plan, q);
                        limbs_mac(lim[v], r, plan, q, nl);
                    }
                }
            }
        }
        const int sa = sfta[i];
        O y[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
            fold_quotient(lim[v], plan, nl);
            if constexpr (F64)
                y[v] = emit_f64_direct(lim[v], plan, sa + sb[v], nl);
            else
                y[v] = emit_f32(lim[v], plan, descale_factors(sa),
                                descale_factors(sb[v]), nl);
        }
        store_cols<V, VEC>(static_cast<O*>(out) + off, t.nv, y);
    }
}

// the kernel for the plan's L: 2-7 for f64 out, 2-5 for f32 out (24 bits)
template <typename T, bool VEC>
int launch(const void* chi, const int* a, const int* b, void* out,
           int out_f64, int m, int n, const EpiloguePlan& plan,
           cudaStream_t st) {
    dim3 grid, block;
    tile_grid(m, n, kCols, grid, block);
    const T* c = static_cast<const T*>(chi);
    return dispatch_l(plan.L, [&](auto nl) {
        constexpr int L = decltype(nl)::value;
        if (out_f64)
            epilogue_kernel<T, true, VEC, L><<<grid, block, 0, st>>>(
                c, a, b, out, m, n, plan);
        else if constexpr (L <= 5)
            epilogue_kernel<T, false, VEC, L><<<grid, block, 0, st>>>(
                c, a, b, out, m, n, plan);
        else
            return (int)cudaErrorInvalidValue;
        return 0;
    });
}

}  // namespace

// chi: (nu, m, n) contiguous, int8 if in_i8 else int32 (C_hi, K-chunked
// residue sums or wrapped residues); sfta: int32 (m); sftb: int32 (n);
// out: (m, n) f64 if out_f64 else f32. vec: n is a multiple of kCols and chi
// and out are 16-byte aligned (kernels._epilogue_vec).
// Returns the CUDA error of the launch (0 on success).
extern "C" int g8_fused_epilogue(const void* chi, const void* sfta,
                                 const void* sftb, void* out, int in_i8,
                                 int out_f64, int m, int n, int vec,
                                 const void* plan_ptr, void* stream) {
    const EpiloguePlan& plan = *static_cast<const EpiloguePlan*>(plan_ptr);
    if (plan.nu < 1 || plan.nu > G8_MAX_NU || plan.L < 1 || plan.L > G8_MAX_L
        || m < 1 || n < 1 || n > 0x7fffffff - 32 * kCols
        || (vec && (n % kCols || ((uintptr_t)chi | (uintptr_t)out) % 16)))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* a = static_cast<const int*>(sfta);
    const int* b = static_cast<const int*>(sftb);
    int err;
    if (in_i8 && vec)
        err = launch<int8_t, true>(chi, a, b, out, out_f64, m, n, plan, st);
    else if (in_i8)
        err = launch<int8_t, false>(chi, a, b, out, out_f64, m, n, plan, st);
    else if (vec)
        err = launch<int, true>(chi, a, b, out, out_f64, m, n, plan, st);
    else
        err = launch<int, false>(chi, a, b, out, out_f64, m, n, plan, st);
    return err ? err : (int)cudaGetLastError();
}
