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
//
// alpha * y + beta * C in the store (epilogue_ab_kernel, g8_fused_epilogue_ab):
// where a real INT8 call on the card passes alpha, beta and C, the same rows
// load C's four columns (f32 out before the planes, f64 out after y) and
// fold alpha and beta into y before the store, in place of a pass over the
// output (core.ab_epilogue) that reads y and C and writes a new matrix, and
// of the blocking copy that built its alpha. The kind is a template parameter (AbKind); alpha and beta
// are kernel arguments in the output's precision. The arithmetic is
// core.ab_epilogue's on the "ff" epilogue, op for op, whose torch.addcmul(x,
// s, t) rounds once on the card as on the CPU: fma(s, t, x). The plain
// version is fused_epilogue_plain followed by ab_epilogue
// (kernels.alpha_beta_plain). C is the top-left (mc, nc) block of the
// (m, n) output, rows ldc apart (0: one row for all); the rest of the
// output, padding the caller slices away, folds with C = 0. It costs C's
// read, 8 (f64) or 4 bytes an element, against the pass's 24 or 12.
#include <type_traits>

#include "crt.cuh"

namespace {

constexpr int kPlanes = 4;          // planes loaded before the first is used

constexpr int kCols = 4;            // columns a thread

// what the store applies to the emulated product y (kernels.ab_kind), in
// core.ab_epilogue's classes: beta 0 (or no C), 1 or general, alpha 1 or not
enum AbKind : int {
    kAbNone = 0,        // y
    kAbAlpha = 1,       // alpha * y
    kAbOne = 2,         // y + c
    kAbOneAlpha = 3,    // fma(alpha, y, c)
    kAbBeta = 4,        // fma(beta, c, y)
    kAbBetaAlpha = 5,   // f64: fma(alpha, y, beta * c); f32: fma(beta, c, alpha * y)
};

template <typename O>
struct AbArgs {
    const O* c;         // C's (mc, nc) block, rows ldc elements apart
    long long ldc;
    int mc, nc;
    int cvec;           // C 16-byte aligned and ldc * sizeof(O) a multiple of 16
    O alpha, beta;
};

template <typename O>
__device__ __forceinline__ O fma_o(O a, O b, O c) {
    if constexpr (sizeof(O) == 8) return fma(a, b, c);
    else return fmaf(a, b, c);
}

template <int AB, typename O>
__device__ __forceinline__ O ab_fold(O y, O c, O alpha, O beta) {
    if constexpr (AB == kAbAlpha) return alpha * y;
    else if constexpr (AB == kAbOne) return y + c;
    else if constexpr (AB == kAbOneAlpha) return fma_o(alpha, y, c);
    else if constexpr (AB == kAbBeta) return fma_o(beta, c, y);
    else if constexpr (AB == kAbBetaAlpha && sizeof(O) == 8)
        return fma_o(alpha, y, beta * c);
    else if constexpr (AB == kAbBetaAlpha) return fma_o(beta, c, alpha * y);
    else return y;
}

// C's V values of row i from column j0, streamed past the caches: whole
// 16-byte loads where the thread's columns lie in C's block and its rows are
// aligned (cvec), else one by one; 0 outside the block
template <int V, typename O>
__device__ __forceinline__ void load_c(const AbArgs<O>& ab, int i, int j0,
                                       O* cv) {
    const int nv = i < ab.mc ? max(0, min(V, ab.nc - j0)) : 0;
    const O* src = ab.c + (long long)i * ab.ldc + j0;
    constexpr int bytes = V * (int)sizeof(O);
    static_assert(bytes % 16 == 0, "whole 16-byte loads");
    if (ab.cvec && nv == V) {
        int w[bytes / 4];
#pragma unroll
        for (int s = 0; s < bytes / 16; ++s)
            load_words<int4>(src + s * (16 / (int)sizeof(O)), w + 4 * s);
        memcpy(cv, w, bytes);
    } else {
#pragma unroll
        for (int v = 0; v < V; ++v) cv[v] = v < nv ? __ldcs(src + v) : O(0);
    }
}

template <typename T, bool F64, bool VEC, int L, int AB>
__device__ __forceinline__ void epilogue_rows(
    const T* __restrict__ chi, const int* __restrict__ sfta,
    const int* __restrict__ sftb, void* __restrict__ out, int m, int n,
    const EpiloguePlan& plan,
    const AbArgs<typename std::conditional<F64, double, float>::type>& ab) {
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
        // C's columns: f32 out loads them before the planes, under whose
        // loads their latency hides; f64 out after y, since its seven limbs
        // a column leave no registers for them during the planes
        O cv[V] = {};
        if constexpr (AB >= kAbOne && !F64) load_c<V>(ab, i, t.j0, cv);
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
        if constexpr (AB >= kAbOne && F64) load_c<V>(ab, i, t.j0, cv);
#pragma unroll
        for (int v = 0; v < V; ++v)
            y[v] = ab_fold<AB>(y[v], cv[v], ab.alpha, ab.beta);
        store_cols<V, VEC>(static_cast<O*>(out) + off, t.nv, y);
    }
}

template <typename T, bool F64, bool VEC, int L>
__global__ void __launch_bounds__(32 * G8_TILE_ROWS)
epilogue_kernel(const T* __restrict__ chi, const int* __restrict__ sfta,
                const int* __restrict__ sftb, void* __restrict__ out, int m,
                int n, const __grid_constant__ EpiloguePlan plan) {
    epilogue_rows<T, F64, VEC, L, kAbNone>(chi, sfta, sftb, out, m, n, plan,
                                           {});
}

// int32 input and whole vectors only: the entries pad the output to 128.
// Six blocks an SM, at most 80 registers as K2's f64 kernel takes: on the
// update's stack (8192^2, nu=16) on an H100, f64 out with C loaded after y
// ran 5 % faster than at 95 registers and five blocks with C loaded
// before y.
constexpr int kAbMinBlocks = 6;

template <bool F64, int L, int AB>
__global__ void __launch_bounds__(32 * G8_TILE_ROWS, kAbMinBlocks)
epilogue_ab_kernel(
    const int* __restrict__ chi, const int* __restrict__ sfta,
    const int* __restrict__ sftb, void* __restrict__ out, int m, int n,
    const __grid_constant__ EpiloguePlan plan,
    const AbArgs<typename std::conditional<F64, double, float>::type> ab) {
    epilogue_rows<int, F64, true, L, AB>(chi, sfta, sftb, out, m, n, plan,
                                         ab);
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

template <int AB>
int launch_ab(const int* chi, const int* a, const int* b, void* out,
              const void* c, long long ldc, int mc, int nc, int cvec,
              double alpha, double beta, int out_f64, int m, int n,
              const EpiloguePlan& plan, cudaStream_t st) {
    dim3 grid, block;
    tile_grid(m, n, kCols, grid, block);
    return dispatch_l(plan.L, [&](auto nl) {
        constexpr int L = decltype(nl)::value;
        if (out_f64) {
            const AbArgs<double> ab{static_cast<const double*>(c), ldc, mc, nc,
                                    cvec, alpha, beta};
            epilogue_ab_kernel<true, L, AB><<<grid, block, 0, st>>>(
                chi, a, b, out, m, n, plan, ab);
        } else if constexpr (L <= 5) {
            // the wrapper passes alpha and beta rounded to f32: exact casts
            const AbArgs<float> ab{static_cast<const float*>(c), ldc, mc, nc,
                                   cvec, (float)alpha, (float)beta};
            epilogue_ab_kernel<false, L, AB><<<grid, block, 0, st>>>(
                chi, a, b, out, m, n, plan, ab);
        } else {
            return (int)cudaErrorInvalidValue;
        }
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

// K2 with alpha * y + beta * C in its store. chi: (nu, m, n) int32,
// contiguous, n a multiple of kCols, chi and out 16-byte aligned; kind: an
// AbKind other than kAbNone; c: C's (mc, nc) block (mc <= m, nc <= n), rows
// ldc >= 0 elements apart, unit column stride, in the output's dtype; null
// for kAbAlpha. cvec: c 16-byte aligned and ldc * sizeof(out) a multiple of
// 16. alpha, beta: the scalars in the output's precision.
// Returns the CUDA error of the launch (0 on success).
extern "C" int g8_fused_epilogue_ab(const void* chi, const void* sfta,
                                    const void* sftb, void* out, const void* c,
                                    long long ldc, int mc, int nc, int cvec,
                                    int kind, double alpha, double beta,
                                    int out_f64, int m, int n,
                                    const void* plan_ptr, void* stream) {
    const EpiloguePlan& plan = *static_cast<const EpiloguePlan*>(plan_ptr);
    const int size = out_f64 ? 8 : 4;
    const bool reads_c = kind >= kAbOne;
    if (plan.nu < 1 || plan.nu > G8_MAX_NU || plan.L < 1 || plan.L > G8_MAX_L
        || m < 1 || n < 1 || n > 0x7fffffff - 32 * kCols || n % kCols
        || ((uintptr_t)chi | (uintptr_t)out) % 16 || kind < kAbAlpha
        || kind > kAbBetaAlpha
        || (reads_c && (!c || mc < 1 || mc > m || nc < 1 || nc > n || ldc < 0
                        || (cvec && ((uintptr_t)c % 16
                                     || (ldc * size) % 16)))))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* x = static_cast<const int*>(chi);
    const int* a = static_cast<const int*>(sfta);
    const int* b = static_cast<const int*>(sftb);
    int err;
    switch (kind) {
        case kAbAlpha:
            err = launch_ab<kAbAlpha>(x, a, b, out, c, ldc, mc, nc, cvec,
                                      alpha, beta, out_f64, m, n, plan, st);
            break;
        case kAbOne:
            err = launch_ab<kAbOne>(x, a, b, out, c, ldc, mc, nc, cvec, alpha,
                                    beta, out_f64, m, n, plan, st);
            break;
        case kAbOneAlpha:
            err = launch_ab<kAbOneAlpha>(x, a, b, out, c, ldc, mc, nc, cvec,
                                         alpha, beta, out_f64, m, n, plan, st);
            break;
        case kAbBeta:
            err = launch_ab<kAbBeta>(x, a, b, out, c, ldc, mc, nc, cvec,
                                     alpha, beta, out_f64, m, n, plan, st);
            break;
        default:
            err = launch_ab<kAbBetaAlpha>(x, a, b, out, c, ldc, mc, nc, cvec,
                                          alpha, beta, out_f64, m, n, plan,
                                          st);
    }
    return err ? err : (int)cudaGetLastError();
}
