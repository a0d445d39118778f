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
// (nu, m, n) int8 stacks, or int32 ones on the FP8 plan (its residues reach
// 544); two passes of the real epilogue on them (epilogue.cu, int8 or int32
// input) finish the product.
//   Replaces: gemmul8_tpu/pallas_kernels.py, fused_recombine_3m (body
//   _recombine_kernel_cplx). Plain version: mod_reduce per lane ->
//   complex_gemm._recombine_3m, in the output's type.
//   Bound on the H100: device memory, 12nu bytes read and 2nu written per
//   element (8nu for int32): at 8192^2, nu=20, 18.8 GB, 5.6 ms.
//
// Both take the FP8 plan as they take the INT8 one: on the complex FP8
// path their input is each lane's wrapped residues (reassemble_fp8.cu) or
// their K-chunk sums, which are int32 values like any other; wrap_any
// wraps by each modulus' constants (p = 1024 by its mask).
//
// Design of K4: K2's (epilogue.cu), with two pipelines.
//   - crt.cuh's 2-D tiling and division-free wrap: each thread takes one row
//     and kCols = 2 consecutive columns, reads the row's shift once and
//     divides no index.
//   - Where every row's columns are whole pairs (n even, the pointers 16-byte
//     aligned: the wrapper's vec flag), each lane of a modulus is one 8-byte
//     load per thread, and kMods moduli's 3 x kMods loads (96 bytes) are
//     issued before the first is used. The output goes out as one 16-byte
//     store per element (c128), per pair of elements (c64) or per pair of Re
//     or Im values (planar f64), 8 bytes per pair for planar f32. Otherwise
//     each thread loads and stores its columns one by one.
//   - Built for each limb count L, f64 out through emit_f64_direct, as K2.
//   - Two columns, not K2's four, and registers capped so that 28 warps fit
//     an SM (72 a thread): two 7-limb pipelines of four columns and their
//     loads leave too few threads to keep the loads in flight; under the cap
//     a few bytes spill (chip_smoke.py phase 2 prints registers and spills),
//     and the kernel runs faster on the card than uncapped
//     (probes.epilogue_tiles times each choice undone).
// Design of K5: one thread per element along n, the 3nu planes read
// coalesced, and the division-free wrap.
#include <type_traits>

#include "crt.cuh"

namespace {

constexpr int kCols = 2;            // columns a thread (K4)
constexpr int kMods = 4;            // moduli loaded before the first is used
// blocks an SM: 28 warps, which caps registers at 72 a thread
constexpr int kMinBlocks = 28 / G8_TILE_ROWS;

template <bool F64, bool VEC, int STRIDE, int L>
__global__ void __launch_bounds__(32 * G8_TILE_ROWS, kMinBlocks)
epilogue_complex_kernel(const int* __restrict__ chi,
                        const int* __restrict__ sfta,
                        const int* __restrict__ sftb,
                        void* __restrict__ out_re, void* __restrict__ out_im,
                        int m, int n,
                        const __grid_constant__ EpiloguePlan plan) {
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
        int lre[V][G8_MAX_L], lim[V][G8_MAX_L];
#pragma unroll
        for (int v = 0; v < V; ++v) {
            limbs_zero(lre[v]);
            limbs_zero(lim[v]);
        }
        for (int q0 = 0; q0 < nu; q0 += kMods) {
            int x[kMods][3][V];               // Crr, Cii, Crii of each modulus
#pragma unroll
            for (int u = 0; u < kMods; ++u) {
                if (q0 + u < nu) {
#pragma unroll
                    for (int lane = 0; lane < 3; ++lane)
                        load_cols<V, VEC>(
                            chi + (size_t)(lane * nu + q0 + u) * mn + off,
                            t.nv, x[u][lane]);
                }
            }
#pragma unroll
            for (int u = 0; u < kMods; ++u) {
                const int q = q0 + u;
                if (q < nu) {
#pragma unroll
                    for (int v = 0; v < V; ++v) {
                        int re, im;
                        lane_recombine_3m(x[u][0][v], x[u][1][v], x[u][2][v],
                                          plan, q, re, im);
                        limbs_mac(lre[v], re, plan, q, nl);
                        limbs_mac(lim[v], im, plan, q, nl);
                    }
                }
            }
        }
        const int sa = sfta[i];
        O yre[V], yim[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
            fold_quotient(lre[v], plan, nl);
            fold_quotient(lim[v], plan, nl);
            if constexpr (F64) {
                yre[v] = emit_f64_direct(lre[v], plan, sa + sb[v], nl);
                yim[v] = emit_f64_direct(lim[v], plan, sa + sb[v], nl);
            } else {
                const Pow2x3 fa = descale_factors(sa);
                const Pow2x3 fb = descale_factors(sb[v]);
                yre[v] = emit_f32(lre[v], plan, fa, fb, nl);
                yim[v] = emit_f32(lim[v], plan, fa, fb, nl);
            }
        }
        O* re = static_cast<O*>(out_re) + off * STRIDE;
        O* im = static_cast<O*>(out_im) + off * STRIDE;
        if constexpr (STRIDE == 2) {                   // (re, im) pairs
            O y[2 * V];
#pragma unroll
            for (int v = 0; v < V; ++v) {
                y[2 * v] = yre[v];
                y[2 * v + 1] = yim[v];
            }
            store_cols<2 * V, VEC>(re, 2 * t.nv, y);
        } else {
            store_cols<V, VEC>(re, t.nv, yre);
            store_cols<V, VEC>(im, t.nv, yim);
        }
    }
}

// the kernel for the plan's L: 2-7 for f64 out, 2-5 for f32 out (24 bits)
template <bool F64, bool VEC>
int launch_complex(const int* c, const int* a, const int* b, void* re,
                   void* im, int stride, int m, int n,
                   const EpiloguePlan& plan, cudaStream_t st) {
    dim3 grid, block;
    tile_grid(m, n, kCols, grid, block);
    return dispatch_l(plan.L, [&](auto nl) {
        constexpr int L = decltype(nl)::value;
        if constexpr (F64 || L <= 5) {
            if (stride == 2)
                epilogue_complex_kernel<F64, VEC, 2, L><<<grid, block, 0, st>>>(
                    c, a, b, re, im, m, n, plan);
            else
                epilogue_complex_kernel<F64, VEC, 1, L><<<grid, block, 0, st>>>(
                    c, a, b, re, im, m, n, plan);
            return 0;
        } else {
            return (int)cudaErrorInvalidValue;
        }
    });
}

template <typename O>
__global__ void recombine_3m_kernel(const int* __restrict__ chi,
                                    O* __restrict__ out_re,
                                    O* __restrict__ out_im, int m, int n,
                                    const __grid_constant__ EpiloguePlan plan) {
    const size_t mn = (size_t)m * n;
    const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= mn) return;
    const int nu = plan.nu;
    for (int q = 0; q < nu; ++q) {
        int re, im;
        lane_recombine_3m(chi[q * mn + idx], chi[(nu + q) * mn + idx],
                          chi[(2 * nu + q) * mn + idx], plan, q, re, im);
        out_re[q * mn + idx] = (O)re;
        out_im[q * mn + idx] = (O)im;
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
// else f32: stride 1 for planar outputs, 2 for the two halves of a complex
// tensor (out_im one value after out_re). vec: n even and chi, out_re and
// out_im (planar) 16-byte aligned (kernels._epilogue_vec).
// Returns the CUDA error of the launch (0 on success).
extern "C" int g8_fused_epilogue_complex(const void* chi, const void* sfta,
                                         const void* sftb, void* out_re,
                                         void* out_im, int stride, int out_f64,
                                         int m, int n, int vec,
                                         const void* plan_ptr, void* stream) {
    const EpiloguePlan& plan = *static_cast<const EpiloguePlan*>(plan_ptr);
    const size_t elem = out_f64 ? 8 : 4;
    const uintptr_t ptrs = (uintptr_t)chi | (uintptr_t)out_re
        | (stride == 1 ? (uintptr_t)out_im : 0);
    if (plan.nu < 1 || plan.nu > G8_MAX_NU || plan.L < 1 || plan.L > G8_MAX_L
        || m < 1 || n < 1 || n > 0x7fffffff - 32 * kCols
        || (stride != 1 && stride != 2)
        || (stride == 2 && (char*)out_im != (char*)out_re + elem)
        || (vec && (n % kCols || ptrs % 16)))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* c = static_cast<const int*>(chi);
    const int* a = static_cast<const int*>(sfta);
    const int* b = static_cast<const int*>(sftb);
    int err;
    if (out_f64 && vec)
        err = launch_complex<true, true>(c, a, b, out_re, out_im, stride, m,
                                         n, plan, st);
    else if (out_f64)
        err = launch_complex<true, false>(c, a, b, out_re, out_im, stride, m,
                                          n, plan, st);
    else if (vec)
        err = launch_complex<false, true>(c, a, b, out_re, out_im, stride, m,
                                          n, plan, st);
    else
        err = launch_complex<false, false>(c, a, b, out_re, out_im, stride, m,
                                           n, plan, st);
    return err ? err : (int)cudaGetLastError();
}

// chi: (3nu, m, n) contiguous int32; out_re, out_im: (nu, m, n) contiguous
// int8, or int32 where out_i32 is set. Only the plan's nu, moduli and wrap
// constants are read.
extern "C" int g8_fused_recombine_3m(const void* chi, void* out_re,
                                     void* out_im, int out_i32, int m, int n,
                                     const void* plan_ptr, void* stream) {
    const EpiloguePlan& plan = *static_cast<const EpiloguePlan*>(plan_ptr);
    if (plan.nu < 1 || plan.nu > G8_MAX_NU) return (int)cudaErrorInvalidValue;
    const int threads = 256;
    unsigned blocks;
    if (int err = grid_for(m, n, threads, &blocks)) return err;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* c = static_cast<const int*>(chi);
    if (out_i32)
        recombine_3m_kernel<int><<<blocks, threads, 0, st>>>(
            c, static_cast<int*>(out_re), static_cast<int*>(out_im), m, n,
            plan);
    else
        recombine_3m_kernel<int8_t><<<blocks, threads, 0, st>>>(
            c, static_cast<int8_t*>(out_re), static_cast<int8_t*>(out_im), m,
            n, plan);
    return (int)cudaGetLastError();
}
