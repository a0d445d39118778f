// The encoders' per-element steps, shared by the INT8 encoder and the INT8
// lane encoder of complex operands (encode.cu), the FP8 encoder
// (encode_fp8.cu) and the FP8 lane encoder (encode_lanes_fp8.cu), so that
// they run the same code: scale by the row's or column's power of two, split
// into exact f32 components, place the integer part in balanced 20-bit limbs
// with the fractions' joint carry, and reduce the limbs modulo one modulus.
// Below them, the two launch frames the encoders share (4 elements a thread;
// B staged through shared memory).
//
// Each step follows quantize.residues_wrapped op for op: the input is scaled
// in its own dtype before the split, the scale uses the floor split of
// pow2_scale, and a component's bit position is clamped at max_exp.
//
// The limb count NL is a template parameter (2 <= NL <= G8_MAX_NL), so that
// every limb loop unrolls without a guard, and the reduction by a modulus
// read at run time is a multiply-high (reduce_biased), not a division.
#pragma once

#include <type_traits>

#include "common.cuh"

template <typename T>
struct Components;

template <>
struct Components<float> {
    static constexpr int N = 1;
    __device__ static void split(float y, float* c) { c[0] = y; }
};

template <>
struct Components<double> {
    static constexpr int N = 3;
    __device__ static void split(double r, float* c) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            c[j] = (float)r;                       // round to nearest even
            if (j + 1 < 3) r = r - (double)c[j];
        }
    }
};

// lim[0 .. NL) = floor(y) in balanced 20-bit limbs, y = x * 2^s already
// scaled (Pow2Split::apply): every limb but the top in [-2^19, 2^19)
template <typename T, int NL>
__device__ __forceinline__ void quantize_limbs(T y, int max_exp, int* lim) {
    float comp[Components<T>::N];
    Components<T>::split(y, comp);
#pragma unroll
    for (int lv = 0; lv < NL; ++lv) lim[lv] = 0;
    float G = 0.0f;                  // joint carry of the fractional parts
#pragma unroll
    for (int j = 0; j < Components<T>::N; ++j) {
        const int bits = __float_as_int(comp[j]);
        const int sign = bits < 0 ? -1 : 1;
        const int expf = (bits >> 23) & 0xFF;
        const int frac = bits & 0x7FFFFF;
        const bool is_norm = expf > 0;
        const int mant = is_norm ? (frac | (1 << 23)) : frac;
        const int e = is_norm ? expf - 127 : -126;
        const int d = e - 23;                           // value = s*mant*2^d
        const int sig = min(max(-d, 0), 31);
        const int m_int = mant >> sig;
        const int dpos = min(max(d, 0), max_exp);
        const int mfrac = mant - (m_int << sig);
        float fr = (float)mfrac * pow2f(max(d, -30));
        if (-d > 30) fr = fabsf(comp[j]);               // below 2^-6
        G = G + (float)sign * fr;
        // m_int * 2^dpos across limbs li and li+1 of the 20-bit grid
        const int li = dpos / 20;
        const int off = dpos - 20 * li;
        const int sh = 20 - off;
        const int mhi = m_int >> sh;
        const int mlo = m_int - (mhi << sh);
        const int c_lo = sign * (mlo << off);           // < 2^20
        const int c_hi = sign * mhi;                    // < 2^23
#pragma unroll
        for (int lv = 0; lv < NL; ++lv) {
            if (li == lv) lim[lv] += c_lo;
            if (li == lv - 1) lim[lv] += c_hi;
        }
    }
    lim[0] += (int)floorf(G);
    // balanced carry: every limb but the top into [-2^19, 2^19)
#pragma unroll
    for (int lv = 0; lv < NL - 1; ++lv) {
        const int cr = (lim[lv] + (1 << 19)) >> 20;
        lim[lv] -= cr * (1 << 20);
        lim[lv + 1] += cr;
    }
}

// (acc + bias_i) mod p_i in [0, p_i) by Barrett's multiply-high: for
// u = acc + bias_i in [0, 2^32) and magic = floor(2^32 / p), q = umulhi(u,
// magic) undershoots floor(u / p) by at most 1, so u - q p lies in [0, 2p)
// and one unsigned min takes it into [0, p). The limb dot is summed in
// unsigned arithmetic: its true value lies in [0, 2^32), so the sum mod 2^32
// is that value. Since bias_i = (multiple of p) + floor(p/2), the result
// less floor(p/2) is wrap(acc mod p) in [-p/2, p/2).
template <int NL>
__device__ __forceinline__ unsigned reduce_biased(const int* lim,
                                                  const EncodePlan& plan,
                                                  int i) {
    unsigned u = (unsigned)lim[0] + plan.bias[i];
#pragma unroll
    for (int lv = 1; lv < NL; ++lv)
        u += (unsigned)(lim[lv] * plan.w[i][lv]);
    const unsigned p = (unsigned)plan.p[i];
    const unsigned r = u - __umulhi(u, plan.magic[i]) * p;
    return min(r, r - p);
}

// wrap(v mod p_i) in [-p/2, p/2) of the limbs' value. A power-of-two modulus
// (256; 1024 among the FP8 moduli) divides every 2^(20*lv) weight but the
// first, so its residue is limb 0's low bits, balanced by a mask. Otherwise
// the dot with the static weights wrap(2^(20*lv) mod p), reduced by
// reduce_biased: |acc| < 6 * 2^19 * 545 <= G8_REDUCE_RANGE for every modulus
// of either backend.
template <int NL>
__device__ __forceinline__ int limb_residue(const int* lim,
                                            const EncodePlan& plan, int i) {
    const int p = plan.p[i];
    if ((p & (p - 1)) == 0)
        return (int)(((unsigned)lim[0] + (unsigned)(p / 2))
                     & (unsigned)(p - 1)) - p / 2;
    return (int)reduce_biased<NL>(lim, plan, i) - (p >> 1);
}

// F(std::integral_constant<int, NL>) for the run-time limb count nl in
// [2, G8_MAX_NL]; returns cudaErrorInvalidValue for any other
template <typename F>
inline int dispatch_nl(int nl, F&& f) {
    switch (nl) {
        case 2: return f(std::integral_constant<int, 2>());
        case 3: return f(std::integral_constant<int, 3>());
        case 4: return f(std::integral_constant<int, 4>());
        case 5: return f(std::integral_constant<int, 5>());
        case 6: return f(std::integral_constant<int, 6>());
        default: return (int)cudaErrorInvalidValue;
    }
}

// The two frames of the encoders (K1 and K1l, encode.cu; K6, encode_fp8.cu;
// K6c, encode_lanes_fp8.cu): each thread quantizes 4 consecutive elements
// along the planes' contiguous axis and hands their limbs to the encoder's
// Emit policy, which reduces them and stores the planes. A policy provides
//   Plan, Out                  the kernel's plan and plane element types,
//   enc(plan)                  the limb plan (EncodePlan) inside Plan,
//   kStageB                    whether B is staged through shared memory,
//   kInputs                    how many operands of one shape and one shift
//                              it encodes together: 1 (K1, K6), or 2 (K1l,
//                              K6c: Re in x and Im in x2, Im negated before
//                              it is scaled where the frame's neg2 is set),
//   emit<NL>(out, pos, plane, valid, word, lim, plan)
//                              the planes of the 4 elements at offset pos
//                              of plane 0 (planes `plane` bytes apart), of
//                              which the first `valid` exist; `word`: the
//                              wrapper's vec flag (whole aligned words);
//                              lim: int[4][NL] for one operand, else
//                              int[kInputs][4][NL].
//
// A (axis 0, planes (planes, m, k) row-major): thread (x, y) of a 32x8 block
// takes elements c0 .. c0+3 of row r, read with 16-byte loads where vec
// allows (cols % 4 == 0, x 16-byte aligned).
// B (axis 1, planes stored (planes, n, k), k-contiguous as the tensor-core
// products read B): a kTileK (k) x kTileN (n) tile of x is staged through
// shared memory with reads along x's rows (n); warp w then takes columns w,
// w+8, w+16, w+24 and lane l elements r0+4l .. r0+4l+3 of each, so that each
// warp writes 128 consecutive k of one column per plane. The tile's k index
// is stored permuted ((k % 4) * 32 + k / 4, row pitch kTileK + 1), so both
// the staging writes and the 4-consecutive-k reads meet no bank conflict.
// A policy of two operands that stages B (K1l) stages a tile of each, of
// kTileN / 2 columns, so that both fit the 48 KB of static shared memory at
// f64 (33 KB); warp w then takes columns w and w+8 (for f32 the staging
// writes meet a two-way bank conflict, the f64 ones none). Without kStageB
// each lane reads its 4 elements from x directly (a strided read: 32 rows a
// warp).
constexpr int kTileK = 128;      // axis 1: rows of x (k) per block
constexpr int kTileN = 32;       // axis 1: columns of x (n) per block
constexpr int kPitch = kTileK + 1;

// the columns of x a B block takes: kTileN, or kTileN / kInputs where the
// policy stages its operands
template <typename Emit>
__host__ __device__ constexpr int cols_tile() {
    return Emit::kStageB ? kTileN / Emit::kInputs : kTileN;
}

// the policy's emit on the limbs of its kInputs operands
template <typename Emit, int NL, int NI>
__device__ __forceinline__ void emit_limbs(typename Emit::Out* out,
                                           size_t pos, size_t plane,
                                           int valid, bool word,
                                           const int (&lim)[NI][4][NL],
                                           const typename Emit::Plan& plan) {
    if constexpr (NI == 1)
        Emit::template emit<NL>(out, pos, plane, valid, word, lim[0], plan);
    else
        Emit::template emit<NL>(out, pos, plane, valid, word, lim, plan);
}

template <typename Emit, typename T, int NL>
__global__ void __launch_bounds__(256)
encode_rows_kernel(const T* __restrict__ x, const T* __restrict__ x2,
                   int neg2, const int* __restrict__ sft,
                   typename Emit::Out* __restrict__ out,
                   const __grid_constant__ typename Emit::Plan plan, int rows,
                   int cols, int vec) {
    constexpr int NI = Emit::kInputs;
    const int r = blockIdx.y * 8 + threadIdx.y;
    const int c0 = (blockIdx.x * 32 + threadIdx.x) * 4;
    if (r >= rows || c0 >= cols) return;
    const int valid = min(cols - c0, 4);
    const size_t pos = (size_t)r * cols + c0;
    const EncodePlan& enc = Emit::enc(plan);
    const Pow2Split<T> scale(sft[r]);
    int lim[NI][4][NL];
#pragma unroll
    for (int j = 0; j < NI; ++j) {
        const T* src = j == 0 ? x : x2;
        T v[4];
        if (vec && valid == 4) {         // 16-byte loads: cols % 4 == 0
            if (sizeof(T) == 4) {
                const float4 q = *reinterpret_cast<const float4*>(src + pos);
                v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
            } else {
                const double2 q0 =
                    *reinterpret_cast<const double2*>(src + pos);
                const double2 q1 =
                    *reinterpret_cast<const double2*>(src + pos + 2);
                v[0] = q0.x; v[1] = q0.y; v[2] = q1.x; v[3] = q1.y;
            }
        } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
                v[e] = e < valid ? src[pos + e] : T(0);
        }
        const bool neg = j == 1 && neg2;
#pragma unroll
        for (int e = 0; e < 4; ++e)
            quantize_limbs<T, NL>(scale.apply(neg ? -v[e] : v[e]),
                                  enc.max_exp, lim[j][e]);
    }
    emit_limbs<Emit, NL, NI>(out, pos, (size_t)rows * cols, valid, vec != 0,
                             lim, plan);
}

template <typename Emit, typename T, int NL>
__global__ void __launch_bounds__(256)
encode_cols_kernel(const T* __restrict__ x, const T* __restrict__ x2,
                   int neg2, const int* __restrict__ sft,
                   typename Emit::Out* __restrict__ out,
                   const __grid_constant__ typename Emit::Plan plan, int rows,
                   int cols, int vec) {
    constexpr int NI = Emit::kInputs;
    constexpr int kTN = cols_tile<Emit>();
    __shared__ T tile[Emit::kStageB ? NI * kTN * kPitch : 1];
    const int r0 = blockIdx.x * kTileK, c0 = blockIdx.y * kTN;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    if constexpr (Emit::kStageB) {
#pragma unroll
        for (int j = 0; j < NI; ++j) {
            const T* src = j == 0 ? x : x2;
            T* dst = tile + j * kTN * kPitch;
#pragma unroll 4
            for (int it = 0; it < kTileK * kTN / 256; ++it) {
                const int kr = it * (256 / kTN) + tid / kTN;
                const int nc = tid % kTN;
                const int gr = r0 + kr, gc = c0 + nc;
                dst[nc * kPitch + (kr & 3) * 32 + (kr >> 2)] =
                    gr < rows && gc < cols ? src[(size_t)gr * cols + gc]
                                           : T(0);
            }
        }
        __syncthreads();
    }
    const int valid = min(rows - (r0 + 4 * lane), 4);
    if (valid <= 0) return;
    const EncodePlan& enc = Emit::enc(plan);
    for (int jc = 0; jc < kTN / 8; ++jc) {
        const int nc = warp + 8 * jc;
        const int gc = c0 + nc;
        if (gc >= cols) break;
        const Pow2Split<T> scale(sft[gc]);
        int lim[NI][4][NL];
#pragma unroll
        for (int j = 0; j < NI; ++j) {
            const T* src = j == 0 ? x : x2;
            const bool neg = j == 1 && neg2;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                T v;
                if constexpr (Emit::kStageB)
                    v = tile[(j * kTN + nc) * kPitch + e * 32 + lane];
                else
                    v = e < valid
                        ? src[(size_t)(r0 + 4 * lane + e) * cols + gc] : T(0);
                quantize_limbs<T, NL>(scale.apply(neg ? -v : v), enc.max_exp,
                                      lim[j][e]);
            }
        }
        emit_limbs<Emit, NL, NI>(out, (size_t)gc * rows + r0 + 4 * lane,
                                 (size_t)rows * cols, valid, vec != 0, lim,
                                 plan);
    }
}

// Both frames on x (rows, cols) f32 or f64 (and x2 of the same shape for a
// policy of two operands, negated where neg2 is set), for the plan's limb
// count; returns the launch's CUDA error, or cudaErrorInvalidValue for a bad
// axis, limb count or grid.
template <typename Emit>
int launch_encode(const void* x, const void* sft, void* out,
                  const typename Emit::Plan& plan, int is_f64, int axis,
                  int rows, int cols, int vec, cudaStream_t st,
                  const void* x2 = nullptr, int neg2 = 0) {
    const EncodePlan& enc = Emit::enc(plan);
    if (enc.nu < 1 || enc.nu > G8_MAX_NU || (axis != 0 && axis != 1))
        return (int)cudaErrorInvalidValue;
    auto go = [&](auto tag, auto nl) -> int {
        using T = decltype(tag);
        constexpr int NL = decltype(nl)::value;
        const T* xp = static_cast<const T*>(x);
        const T* xp2 = static_cast<const T*>(x2);
        const int* sp = static_cast<const int*>(sft);
        auto* op = static_cast<typename Emit::Out*>(out);
        if (axis == 0) {
            const dim3 grid((cols + 127) / 128, (rows + 7) / 8);
            if (grid.y > 65535) return (int)cudaErrorInvalidValue;
            encode_rows_kernel<Emit, T, NL><<<grid, dim3(32, 8), 0, st>>>(
                xp, xp2, neg2, sp, op, plan, rows, cols, vec);
        } else {
            constexpr int kTN = cols_tile<Emit>();
            const dim3 grid((rows + kTileK - 1) / kTileK,
                            (cols + kTN - 1) / kTN);
            if (grid.y > 65535) return (int)cudaErrorInvalidValue;
            encode_cols_kernel<Emit, T, NL><<<grid, 256, 0, st>>>(
                xp, xp2, neg2, sp, op, plan, rows, cols, vec);
        }
        return (int)cudaGetLastError();
    };
    return dispatch_nl(enc.nl, [&](auto nl) {
        return is_f64 ? go(double(), nl) : go(float(), nl);
    });
}
