// The encoders' per-element steps, shared by the INT8 encoder (encode.cu)
// and the FP8 one (encode_fp8.cu), so that they run the same code: scale by
// the row's or column's power of two, split into exact f32 components, place
// the integer part in balanced 20-bit limbs with the fractions' joint carry,
// and reduce the limbs modulo one modulus.
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

// Thread (fast, slow) of a 32x8 block grid -> the element (r, c) of a
// (rows, cols) operand and its offset in a plane: AXIS 0 (A, one shift per
// row) runs the warp along cols and stores planes row-major (rows, cols);
// AXIS 1 (B, one shift per column) runs it along rows and stores planes
// (cols, rows), k-contiguous as the tensor-core products read B. (The FP8
// encoder's indexing; the INT8 encoder has its own, encode.cu.)
template <int AXIS>
struct EncodeIndex {
    int r, c;
    size_t pos;
    __device__ EncodeIndex(int rows, int cols) {
        const int fast = blockIdx.x * 32 + threadIdx.x;
        const int slow = blockIdx.y * 8 + threadIdx.y;
        r = AXIS == 0 ? slow : fast;
        c = AXIS == 0 ? fast : slow;
        pos = AXIS == 0 ? (size_t)r * cols + c : (size_t)c * rows + r;
    }
};

// the launch grid of EncodeIndex; false if it exceeds the y-dimension limit
inline bool encode_grid(int axis, int rows, int cols, dim3& grid,
                        dim3& block) {
    const int fast = axis == 0 ? cols : rows;
    const int slow = axis == 0 ? rows : cols;
    block = dim3(32, 8);
    grid = dim3((fast + 31) / 32, (slow + 7) / 8);
    return (slow + 7) / 8 <= 65535;
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
