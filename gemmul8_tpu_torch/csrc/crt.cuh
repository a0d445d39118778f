// The CRT epilogue's per-element steps, shared by the real fused epilogue
// (epilogue.cu) and the complex ones (complex.cu), so that they run the same
// code: the wrap of any int32 into [-p/2, p/2), the 3M lane recombine, the
// multiply-add into 16-bit int32 limbs, the balanced carry, the fold of
// P * rint(t / P) and the two descales. Limb arrays stay in registers: every
// loop over limbs is unrolled to G8_MAX_L with a guard on L, which each
// kernel fixes at compile time (LimbCount).
//
// Each helper follows its plain PyTorch twin op for op (core.mod_reduce,
// complex_gemm._recombine_3m, ff.crt_limbs_matrix, ff.fold_quotient,
// ff.reconstruct_scale_ff, ff.descale_pair). The tensor-core CRT epilogue
// (epilogue_mxu.cu) shares the wrap, the fold and the descale; the FP8
// epilogue (epilogue_fp8.cu) the fold, the descales, the tiling and the
// column loads (its reassembly wraps in f32 steps of its own; wrap_any only
// on its int32 route, a switch of the ablation probe).
//
// Below them, the 2-D tiling and the column loads of K2, K3 and K4 (K8
// takes the grid and the loads).
#pragma once

#include <cstring>

#include "common.cuh"

// wrap(v mod p_q) in [-p/2, p/2) of any int32 v, without a division: u =
// v + 2^31 (the sign bit flipped) lies in [0, 2^32); with magic =
// floor(2^32 / p), q = umulhi(u, magic) undershoots floor(u / p) by at most
// 1, so r = u - q p lies in [0, 2p), and one unsigned min takes it into
// [0, p). r = v + 2^31 mod p, so adding wrap_off = (floor(p/2) - 2^31) mod p
// and one more min gives (v + floor(p/2)) mod p, whose less floor(p/2) is
// the wrap. A power-of-two modulus (256; 1024 among the FP8 moduli) is
// wrapped by a mask.
// wrap_mulhi is that multiply-high wrap by a modulus given with its
// constants; it is exact for a power of two too (magic * p = 2^32, so q is
// floor(u / p) exactly), which the tensor-core epilogue uses to wrap
// different moduli in the lanes of one warp without a branch.
__device__ __forceinline__ int wrap_mulhi(int v, int p, unsigned magic,
                                          unsigned wrap_off) {
    const unsigned up = (unsigned)p;
    const unsigned u = (unsigned)v ^ 0x80000000u;
    unsigned r = u - __umulhi(u, magic) * up;
    r = min(r, r - up);
    r += wrap_off;
    r = min(r, r - up);
    return (int)r - (p >> 1);
}

__device__ __forceinline__ int wrap_any(int v, const EpiloguePlan& plan,
                                        int q) {
    const int p = plan.p[q];
    if ((p & (p - 1)) == 0)
        return (int)(((unsigned)v + (unsigned)(p >> 1)) & (unsigned)(p - 1))
            - (p >> 1);
    return wrap_mulhi(v, p, plan.magic[q], plan.wrap_off[q]);
}

// the wrap of v in [-3p/2, 3p/2): one balanced correction each way. It is
// exact on int8 input for every INT8 modulus (all above 128) and on the 3M
// recombine's re and im.
__device__ __forceinline__ int wrap_small(int v, int p) {
    if (2 * v >= p) v -= p;
    if (2 * v < -p) v += p;
    return v;
}

// 3M recombine of one modulus' three lane products (raw int32 sums):
// Re = Crr - Cii, Im = Crii - Crr - Cii, each wrapped into [-p/2, p/2).
// The wrapped lanes put re in (-p, p) and im in (-3p/2, 3p/2), so one
// correction each way lands both.
__device__ __forceinline__ void lane_recombine_3m(int crr, int cii, int cri,
                                                  const EpiloguePlan& plan,
                                                  int q, int& re, int& im) {
    crr = wrap_any(crr, plan, q);
    cii = wrap_any(cii, plan, q);
    cri = wrap_any(cri, plan, q);
    re = wrap_small(crr - cii, plan.p[q]);
    im = wrap_small(cri - crr - cii, plan.p[q]);
}

__device__ __forceinline__ void limbs_zero(int* lim) {
#pragma unroll
    for (int li = 0; li < G8_MAX_L; ++li) lim[li] = 0;
}

// The limb helpers take the limb count L last: a LimbCount for kernels built
// for one L (K2, K3, K4, K8), in which every guard on L below folds away, or
// the plan's L as an int (the ablation probe's run-time limb count).
template <int N>
struct LimbCount {
    static constexpr int value = N;
    __host__ __device__ constexpr operator int() const { return N; }
};

// lim += r * (16-bit slices of qP_q >> base); |r * w16| < 2^26, nu-term
// sums < 2^31
template <typename LN>
__device__ __forceinline__ void limbs_mac(int* lim, int r,
                                          const EpiloguePlan& plan, int q,
                                          LN L) {
#pragma unroll
    for (int li = 0; li < G8_MAX_L; ++li)
        if (li < L) lim[li] += r * plan.w16[q][li];
}

// balanced carry pass: every limb but the top into [-2^15, 2^15)
template <typename LN>
__device__ __forceinline__ void carry16(int* lim, LN L) {
#pragma unroll
    for (int li = 0; li < G8_MAX_L - 1; ++li) {
        if (li < L - 1) {
            const int c = (lim[li] + (1 << 15)) >> 16;
            lim[li] -= c * (1 << 16);
            lim[li + 1] += c;
        }
    }
}

// carry, quotient rint(t / P) from the top (up to three) balanced limbs in
// f32, fold -quot * P, carry again: the limbs then sum to t, |t| < P/2
template <typename LN>
__device__ __forceinline__ void fold_quotient(int* lim,
                                              const EpiloguePlan& plan,
                                              LN L) {
    carry16(lim, L);
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
}

// f64 out: each limb scaled by 2^(base + 16*li - ss) in f64 over the full
// exponent range (pow2_scale's floor split), summed highest first
template <typename LN>
__device__ __forceinline__ double emit_f64(const int* lim,
                                           const EpiloguePlan& plan, int ss,
                                           LN L) {
    double acc = 0.0;
    bool first = true;
#pragma unroll
    for (int li = G8_MAX_L - 1; li >= 0; --li) {
        if (li < L) {
            const double term = pow2_scale_d((double)lim[li],
                                             plan.base + 16 * li - ss);
            acc = first ? term : acc + term;
            first = false;
        }
    }
    return acc;
}

// emit_f64's value with one multiply a limb where every limb's exponent
// s = base + 16*li - ss lies in [-1022, 992] (G8_DIRECT_LO, G8_DIRECT_HI):
// a limb x is an int (0, or 1 <= |x| <= 2^31), so x * 2^s and each partial
// product of pow2_scale's floor split (exponents between 0 and s) are
// normal f64, every one of those power-of-two multiplies is exact, and
// ((x * 2^h1) * 2^h2) * 2^h3 = x * 2^s, the product with the assembled 2^s:
// the same bits, summed in the same order. Elsewhere emit_f64 itself.
#define G8_DIRECT_LO (-1022)
#define G8_DIRECT_HI 992

template <typename LN>
__device__ __forceinline__ double emit_f64_direct(const int* lim,
                                                  const EpiloguePlan& plan,
                                                  int ss, LN L) {
    if (plan.base - ss < G8_DIRECT_LO
            || plan.base + 16 * (L - 1) - ss > G8_DIRECT_HI)
        return emit_f64(lim, plan, ss, L);
    double acc = 0.0;
    bool first = true;
#pragma unroll
    for (int li = G8_MAX_L - 1; li >= 0; --li) {
        if (li < L) {
            const double term = (double)lim[li]
                * pow2d(plan.base + 16 * li - ss);
            acc = first ? term : acc + term;
            first = false;
        }
    }
    return acc;
}

// 2^-sft as three f32 powers of two, split by multiply-shift so that each
// stays normal for |sft| up to ~378 (ff._descale_factors)
struct Pow2x3 {
    float f1, f2, f3;
};

__device__ __forceinline__ Pow2x3 descale_factors(int sft) {
    const int t = -sft;
    const int h1 = (t * 21846) >> 16;                 // ~t/3
    const int r = t - h1;
    const int h2 = r >> 1;
    return {pow2f(h1), pow2f(h2), pow2f(r - h2)};
}

// the rank-1 descale with the static per-limb pow2 pair and the row and
// column factor triples, merged smallest first with two_sum: the (hi, lo)
// f32 pair (ff.descale_pair)
template <typename LN>
__device__ __forceinline__ void emit_pair(const int* lim,
                                          const EpiloguePlan& plan,
                                          const Pow2x3& fa, const Pow2x3& fb,
                                          float& hi, float& lo, LN L) {
    hi = 0.0f;
    lo = 0.0f;
#pragma unroll
    for (int li = 0; li < G8_MAX_L; ++li) {
        if (li < L) {
            float term = (float)lim[li] * plan.s1[li];
            term = ((term * fa.f1) * fb.f1) * plan.s2[li];
            term = (term * fa.f2) * fb.f2;
            term = (term * fa.f3) * fb.f3;
            if (li == 0) {
                hi = term;
            } else {                                      // two_sum (Knuth)
                const float s = hi + term;
                const float t = s - hi;
                const float err = (hi - (s - t)) + (term - t);
                hi = s;
                lo = lo + err;
            }
        }
    }
}

// f32 out: the pair's sum (ff.descale_accel)
template <typename LN>
__device__ __forceinline__ float emit_f32(const int* lim,
                                          const EpiloguePlan& plan,
                                          const Pow2x3& fa, const Pow2x3& fb,
                                          LN L) {
    float hi, lo;
    emit_pair(lim, plan, fa, fb, hi, lo, L);
    return hi + lo;
}

// F(LimbCount<L>()) for the run-time limb count L in [2, G8_MAX_L];
// returns cudaErrorInvalidValue for any other
template <typename F>
inline int dispatch_l(int L, F&& f) {
    switch (L) {
        case 2: return f(LimbCount<2>());
        case 3: return f(LimbCount<3>());
        case 4: return f(LimbCount<4>());
        case 5: return f(LimbCount<5>());
        case 6: return f(LimbCount<6>());
        case 7: return f(LimbCount<7>());
        default: return (int)cudaErrorInvalidValue;
    }
}

// The 2-D tiling of K2, K3 and K4: a block of G8_TILE_ROWS warps; warp y takes
// row blockIdx.y * G8_TILE_ROWS + y (and every gridDim.y * G8_TILE_ROWS-th
// row after it, past the grid's y limit), lane x the V consecutive columns
// from (blockIdx.x * 32 + x) * V. Each thread loads its row's shift once per
// row and its columns' shifts once, and needs no division.
#define G8_TILE_ROWS 4

struct Tile {
    int j0;     // first column
    int nv;     // columns in the matrix, <= V (0: the thread idles)
    int i0;     // first row; then i0 + k * row_step
    int row_step;
    template <int V>
    __device__ static Tile make(int n) {
        Tile t;
        t.j0 = (blockIdx.x * 32 + threadIdx.x) * V;
        t.nv = max(0, min(V, n - t.j0));
        t.i0 = blockIdx.y * G8_TILE_ROWS + threadIdx.y;
        t.row_step = gridDim.y * G8_TILE_ROWS;
        return t;
    }
};

// the launch grid of Tile for V columns a thread
inline void tile_grid(int m, int n, int V, dim3& grid, dim3& block) {
    block = dim3(32, G8_TILE_ROWS);
    const int rows = (m + G8_TILE_ROWS - 1) / G8_TILE_ROWS;
    grid = dim3((unsigned)((n + 32 * V - 1) / (32 * V)),
                (unsigned)min(rows, 65535));
}

// x[0 .. V) = V consecutive int32 or int8 values as int; VEC: one load of
// V * sizeof(T) bytes (4, 8 or 16; src aligned to it), streamed past the
// caches; else nv scalar loads, the rest 0
template <typename W>
__device__ __forceinline__ void load_words(const void* src, int* w) {
    const W t = __ldcs(static_cast<const W*>(src));
    static_assert(sizeof(W) % 4 == 0, "whole 32-bit words");
    memcpy(w, &t, sizeof(W));
}

template <int V, bool VEC, typename T>
__device__ __forceinline__ void load_cols(const T* src, int nv, int* x) {
    constexpr int bytes = V * (int)sizeof(T);
    if constexpr (VEC && bytes % 4 == 0 && bytes <= 16) {
        int w[bytes / 4];
        if constexpr (bytes == 16) load_words<int4>(src, w);
        else if constexpr (bytes == 8) load_words<int2>(src, w);
        else load_words<int>(src, w);
#pragma unroll
        for (int v = 0; v < V; ++v) {
            if constexpr (sizeof(T) == 4)
                x[v] = w[v];
            else                                      // byte v, signed
                x[v] = (signed char)((unsigned)w[v / 4] >> (8 * (v % 4)));
        }
    } else {
        static_assert(!VEC || V == 1, "no vector load of V values");
#pragma unroll
        for (int v = 0; v < V; ++v) x[v] = v < nv ? (int)src[v] : 0;
    }
}

// out[0 .. nv) = y[0 .. nv); VEC: whole 16-byte stores where V values fill
// them, one 8-byte store where they fill 8 (out aligned to it), else scalar
template <int V, bool VEC, typename O>
__device__ __forceinline__ void store_cols(O* out, int nv, const O* y) {
    constexpr int bytes = V * (int)sizeof(O);
    if constexpr (VEC && bytes % 16 == 0) {
#pragma unroll
        for (int s = 0; s < bytes / 16; ++s) {
            int4 t;
            memcpy(&t, y + s * (16 / sizeof(O)), 16);
            reinterpret_cast<int4*>(out)[s] = t;
        }
    } else if constexpr (VEC && bytes == 8) {
        int2 t;
        memcpy(&t, y, 8);
        reinterpret_cast<int2*>(out)[0] = t;
    } else {
#pragma unroll
        for (int v = 0; v < V; ++v)
            if (v < nv) out[v] = y[v];
    }
}
