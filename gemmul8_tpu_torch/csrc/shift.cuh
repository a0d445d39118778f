// The steps of a maximum per row or column that K10 (shift.cu, the fast
// shifts) and K11 (extract.cu, accurate mode's bound planes) share: the
// |x| bits that are maximised as unsigned integers (exact for non-negative
// values, independent of order, NaN above every number as in torch.amax),
// quantize.ilogb's two branches, a warp's maximum and the 16-byte loads of
// a row.
#pragma once

#include "common.cuh"

template <typename T> struct Word;
template <> struct Word<double> {
    using U = unsigned long long;      // the bits of |x|
    using V = double2;                 // a 16-byte vector
    static constexpr int W = 2;
    __device__ static U abs_bits(double x) {
        return (U)__double_as_longlong(x) & 0x7fffffffffffffffull;
    }
    __device__ static void split(const V& v, double (&e)[W]) {
        e[0] = v.x; e[1] = v.y;
    }
};
template <> struct Word<float> {
    using U = unsigned int;
    using V = float4;
    static constexpr int W = 4;
    __device__ static U abs_bits(float x) {
        return __float_as_uint(x) & 0x7fffffffu;
    }
    __device__ static void split(const V& v, float (&e)[W]) {
        e[0] = v.x; e[1] = v.y; e[2] = v.z; e[3] = v.w;
    }
};

// int32 arithmetic that wraps, as torch's int32 tensors do
__device__ __forceinline__ int wadd(int a, int b) {
    return (int)((unsigned)a + (unsigned)b);
}

// quantize.ilogb of an f32: the biased exponent field less 127
__device__ __forceinline__ int ilogb32(float a) {
    return (int)((__float_as_uint(a) >> 23) & 0xFFu) - 127;
}

// quantize.ilogb of an f64: the f32 field where the f32 of a is normal and
// finite, else floor(log2(max(a, tiny)) + 2^-32)
__device__ __forceinline__ int ilogb64(double a) {
    const float a32 = __double2float_rn(a);
    if (a32 >= 0x1p-126f && isfinite(a32) && a32 > 0.0f) return ilogb32(a32);
    const double m = (a != a) ? a : fmax(a, 2.2250738585072014e-308);
    return __double2int_rz(floor(log2(m) + 0x1p-32));
}

template <typename U>
__device__ __forceinline__ U warp_max(U v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const U o = __shfl_xor_sync(0xffffffffu, v, off);
        v = o > v ? o : v;
    }
    return v;
}

// the logical element j (or vector of W) of a row or column of `lanes`
// lanes of `len` each: lane 0's from p0, lane 1's from p1 (im)
template <typename T, bool VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p0,
                                         const T* __restrict__ p1, int len,
                                         int total, int j0,
                                         T (&e)[Word<T>::W]) {
    constexpr int W = Word<T>::W;
    if (VEC) {      // len % W == 0: a vector lies in one lane, whole
        if (j0 < total) {
            const T* p = j0 < len ? p0 + j0 : p1 + (j0 - len);
            Word<T>::split(
                __ldg(reinterpret_cast<const typename Word<T>::V*>(p)), e);
        } else {
#pragma unroll
            for (int s = 0; s < W; ++s) e[s] = T(0);
        }
    } else {
#pragma unroll
        for (int s = 0; s < W; ++s) {
            const int j = j0 + s;
            e[s] = j < total ? __ldg(j < len ? p0 + j : p1 + (j - len))
                             : T(0);
        }
    }
}
