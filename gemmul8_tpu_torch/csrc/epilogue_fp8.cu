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
//   square p = q^2:  r = wrap(q * (C0 + C1) + C2),
//   Karatsuba:       r = wrap(256*C0 + 16*(C2 - C0 - C1) + C1),
// r the unique representative in [-p/2, p/2), whatever the order of the
// exact steps that reach it. The CRT, carry, quotient fold and both
// descales are crt.cuh's, shared with the other epilogues: f32 out in the
// descale_accel order, f64 out through the full-range f64 descale.
//
// Bound on the H100: device memory. Each element reads 3nu f32 (168 B at
// nu=14) and writes 4 or 8 bytes: 11.8 GB at 8192^2, nu=14, f64, 3.5 ms at
// 3.35 TB/s. The operations the function needs (chip_smoke.
// fp8_epilogue_bound) take less.
//
// Design: K2's frame (epilogue.cu), with the reassembly on the FMA pipe.
//   - The reassembly in exact f32 steps, no conversion to int32: a lane
//     product c is first brought near its wrap, k = rint(c / p) as
//     fma(c, 1/p, M) - M with M = 1.5 * 2^23 and r = fma(k, -p, c), exact,
//     |r| <= p/2 + 1 for |c| <= 2^24 (1/p rounded to f32 moves c / p by at
//     most 1/p). The recombine of the three r (square: q (r0 + r1) + r2;
//     Karatsuba: 240 r0 + 16 r2 - 15 r1) is exact, |t| < 2^17, and the
//     final reduction of t by the odd p is the wrap itself: t / p lies
//     within 2^-15 of t * (1/p), and at least 1/(2p) from a half-integer.
//     fma(k, -p, t + M) gives M + r, whose f32 bits are 0x4B400000 + r: the
//     limbs take those bits as an integer, their offset taken out once by
//     the limbs' start (plan.lim0). p = 1024 (modulus 1) is wrapped by its
//     mask on the same bits, offset 512. tests/
//     test_torch_fp8_epilogue_redesign.py mirrors every step in numpy.
//   - Two loops by modulus kind: the square moduli 0-5 (G8_NOT_KARATSUBA),
//     unrolled, so that each modulus' constants and the 1024 mask are fixed
//     at its index, then the Karatsuba ones; no per-modulus branch.
//   - A 2-D grid of rows and column tiles (crt.cuh's Tile): each thread
//     takes one row and kCols = 4 consecutive columns, reads the row's shift
//     (and builds its f32 descale factors) once a row and its columns' once,
//     and divides no index.
//   - Where every row's columns are whole vectors (n a multiple of 4, the
//     stack and the output 16-byte aligned: the wrapper's vec flag), each
//     plane is one 16-byte load per thread and the output whole 16-byte
//     stores; otherwise each thread loads and stores its columns one by one.
//     kMods moduli's three lanes (96 bytes) are loaded before the first is
//     used.
//   - Built for each limb count L (2-7; 2-5 for f32 out); f64 out takes
//     crt.cuh's one-multiply descale (emit_f64_direct) where it gives
//     emit_f64's bits.
// kCols, kMods, kTwoLoops and kF32Wrap are the design's switches, which
// probes.epilogue_tiles undoes one at a time; the kF32Wrap = false route is
// the int32 reassembly through crt.cuh's wrap_any.
#include <type_traits>

#include "crt.cuh"

namespace {

constexpr int kCols = 4;            // columns a thread
constexpr int kMods = 2;            // moduli whose lanes load before use
constexpr bool kTwoLoops = true;    // square moduli, then Karatsuba ones
constexpr bool kF32Wrap = true;     // the reassembly in f32 steps

constexpr float kMagic = 12582912.0f;       // M = 1.5 * 2^23
constexpr unsigned kMagicBits = 0x4B400000u;  // the f32 bits of M
constexpr unsigned kMaskOffset = 512u;      // modulus 1 (p = 1024)

enum Kind { kSquare, kKaratsuba, kAnyKind };

// c - p * rint(c / p) give or take p: exact, |.| <= p/2 + 1 for |c| <= 2^24
__device__ __forceinline__ float near_wrap(float c, float p, float inv_p) {
    const float k = fmaf(c, inv_p, kMagic) - kMagic;
    return fmaf(k, -p, c);
}

// modulus q's residue r from its three lane products, as the unsigned
// r + offset that the limbs take: 0x4B400000 + r, or r + 512 for modulus 1
template <int KIND>
__device__ __forceinline__ unsigned reassemble(float f0, float f1, float f2,
                                               const EpiloguePlanFp8& plan,
                                               int q) {
    const bool square = KIND == kSquare
        || (KIND == kAnyKind && plan.sq[q] != 0);
    const bool mask = square && q == 1;                       // p = 1024
    if constexpr (kF32Wrap) {
        const float p = plan.p_f[q], inv_p = plan.inv_p[q];
        const float r0 = near_wrap(f0, p, inv_p);
        const float r1 = near_wrap(f1, p, inv_p);
        const float r2 = near_wrap(f2, p, inv_p);
        const float t = square
            ? fmaf(r0 + r1, plan.sq_f[q], r2)
            : fmaf(r0, 240.0f, fmaf(r2, 16.0f, r1 * -15.0f));
        if (mask)
            return (__float_as_uint(t + kMagic) + kMaskOffset) & 1023u;
        const float k = fmaf(t, inv_p, kMagic) - kMagic;
        return __float_as_uint(fmaf(k, -p, t + kMagic));
    } else {
        const EpiloguePlan& crt = plan.crt;
        const int c0 = (int)f0, c1 = (int)f1, c2 = (int)f2;
        int t;
        if (square) {                              // |c0 + c1| <= 2^25
            t = plan.sq[q] * wrap_any(c0 + c1, crt, q) + wrap_any(c2, crt, q);
        } else {
            const int r0 = wrap_any(c0, crt, q), r1 = wrap_any(c1, crt, q);
            t = 256 * r0 + 16 * (wrap_any(c2, crt, q) - r0 - r1) + r1;
        }
        return (unsigned)wrap_any(t, crt, q)
            + (mask ? kMaskOffset : kMagicBits);
    }
}

// lim += (r + offset) * (16-bit slices of qP_q >> base), modulo 2^32: the
// limbs start from -sum of offset * slices (plan.lim0), so they end at the
// exact sums, |.| < 2^31
template <typename LN>
__device__ __forceinline__ void limbs_mac_offset(int* lim, unsigned r,
                                                 const EpiloguePlan& plan,
                                                 int q, LN L) {
#pragma unroll
    for (int li = 0; li < G8_MAX_L; ++li)
        if (li < L)
            lim[li] = (int)((unsigned)lim[li] + r * (unsigned)plan.w16[q][li]);
}

// moduli q0 .. q0 + kMods - 1 (those below qend): their three lanes'
// columns loaded, then reassembled into every column's limbs
template <int KIND, bool VEC, typename LN>
__device__ __forceinline__ void mac_moduli(const int* __restrict__ c3,
                                           size_t mn, size_t off, int nv,
                                           int q0, int qend,
                                           const EpiloguePlanFp8& plan,
                                           int (*lim)[G8_MAX_L], LN nl) {
    constexpr int V = kCols;
    int x[kMods][3][V];
#pragma unroll
    for (int u = 0; u < kMods; ++u) {
        if (q0 + u < qend) {
#pragma unroll
            for (int lane = 0; lane < 3; ++lane)
                load_cols<V, VEC>(c3 + (size_t)(3 * (q0 + u) + lane) * mn
                                  + off, nv, x[u][lane]);
        }
    }
#pragma unroll
    for (int u = 0; u < kMods; ++u) {
        const int q = q0 + u;
        if (q < qend) {
#pragma unroll
            for (int v = 0; v < V; ++v)
                limbs_mac_offset(
                    lim[v], reassemble<KIND>(__int_as_float(x[u][0][v]),
                                             __int_as_float(x[u][1][v]),
                                             __int_as_float(x[u][2][v]),
                                             plan, q),
                    plan.crt, q, nl);
        }
    }
}

template <bool F64, bool VEC, int L>
__global__ void __launch_bounds__(32 * G8_TILE_ROWS)
epilogue_fp8_kernel(const int* __restrict__ c3, const int* __restrict__ sfta,
                    const int* __restrict__ sftb, void* __restrict__ out,
                    int m, int n, const __grid_constant__ EpiloguePlanFp8 plan) {
    constexpr int V = kCols;
    constexpr LimbCount<L> nl{};
    using O = typename std::conditional<F64, double, float>::type;
    const Tile t = Tile::make<V>(n);
    if (t.nv == 0) return;
    const EpiloguePlan& crt = plan.crt;
    const size_t mn = (size_t)m * n;
    const int nu = crt.nu;
    int sb[V];
    Pow2x3 fb[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
        sb[v] = v < t.nv ? sftb[t.j0 + v] : 0;
        if constexpr (!F64) fb[v] = descale_factors(sb[v]);
    }

    for (int i = t.i0; i < m; i += t.row_step) {
        const size_t off = (size_t)i * n + t.j0;
        int lim[V][G8_MAX_L];
#pragma unroll
        for (int v = 0; v < V; ++v) {
#pragma unroll
            for (int li = 0; li < G8_MAX_L; ++li)
                lim[v][li] = li < nl ? (int)plan.lim0[li] : 0;
        }
        if constexpr (kTwoLoops) {
            const int nsq = min(nu, G8_NOT_KARATSUBA);
#pragma unroll
            for (int q0 = 0; q0 < G8_NOT_KARATSUBA; q0 += kMods) {
                if (q0 >= nsq) break;
                mac_moduli<kSquare, VEC>(c3, mn, off, t.nv, q0, nsq, plan,
                                         lim, nl);
            }
            for (int q0 = G8_NOT_KARATSUBA; q0 < nu; q0 += kMods)
                mac_moduli<kKaratsuba, VEC>(c3, mn, off, t.nv, q0, nu, plan,
                                            lim, nl);
        } else {
            for (int q0 = 0; q0 < nu; q0 += kMods)
                mac_moduli<kAnyKind, VEC>(c3, mn, off, t.nv, q0, nu, plan,
                                          lim, nl);
        }
        const int sa = sfta[i];
        O y[V];
        if constexpr (F64) {
#pragma unroll
            for (int v = 0; v < V; ++v) {
                fold_quotient(lim[v], crt, nl);
                y[v] = emit_f64_direct(lim[v], crt, sa + sb[v], nl);
            }
        } else {
            const Pow2x3 fa = descale_factors(sa);
#pragma unroll
            for (int v = 0; v < V; ++v) {
                fold_quotient(lim[v], crt, nl);
                y[v] = emit_f32(lim[v], crt, fa, fb[v], nl);
            }
        }
        store_cols<V, VEC>(static_cast<O*>(out) + off, t.nv, y);
    }
}

// the kernel for the plan's L: 2-7 for f64 out, 2-5 for f32 out (24 bits)
template <bool VEC>
int launch(const int* c, const int* a, const int* b, void* out, int out_f64,
           int m, int n, const EpiloguePlanFp8& plan, cudaStream_t st) {
    dim3 grid, block;
    tile_grid(m, n, kCols, grid, block);
    return dispatch_l(plan.crt.L, [&](auto nl) {
        constexpr int L = decltype(nl)::value;
        if (out_f64)
            epilogue_fp8_kernel<true, VEC, L><<<grid, block, 0, st>>>(
                c, a, b, out, m, n, plan);
        else if constexpr (L <= 5)
            epilogue_fp8_kernel<false, VEC, L><<<grid, block, 0, st>>>(
                c, a, b, out, m, n, plan);
        else
            return (int)cudaErrorInvalidValue;
        return 0;
    });
}

}  // namespace

// c3: (3nu, m, n) contiguous f32 lane products; sfta: int32 (m); sftb: int32
// (n); out: (m, n) f64 if out_f64 else f32. vec: n is a multiple of kCols
// and c3 and out are 16-byte aligned (kernels._epilogue_vec).
// Returns the CUDA error of the launch (0 on success).
extern "C" int g8_fused_epilogue_fp8(const void* c3, const void* sfta,
                                     const void* sftb, void* out, int out_f64,
                                     int m, int n, int vec,
                                     const void* plan_ptr, void* stream) {
    const EpiloguePlanFp8& plan =
        *static_cast<const EpiloguePlanFp8*>(plan_ptr);
    if (plan.crt.nu < 1 || plan.crt.nu > G8_MAX_NU || plan.crt.L < 1
        || plan.crt.L > G8_MAX_L || m < 1 || n < 1
        || n > 0x7fffffff - 32 * kCols
        || (vec && (n % kCols || ((uintptr_t)c3 | (uintptr_t)out) % 16)))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* c = static_cast<const int*>(c3);
    const int* a = static_cast<const int*>(sfta);
    const int* b = static_cast<const int*>(sftb);
    const int err = vec ? launch<true>(c, a, b, out, out_f64, m, n, plan, st)
                        : launch<false>(c, a, b, out, out_f64, m, n, plan, st);
    return err ? err : (int)cudaGetLastError();
}
