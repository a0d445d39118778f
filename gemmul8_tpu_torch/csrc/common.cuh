// Shared definitions of the hand-written kernels: the static plans passed by
// value as kernel parameters (mirrored by ctypes Structures in kernels.py) and
// exact integer / power-of-two helpers.
//
// Bit-identity with the plain PyTorch versions rests on two build facts:
// -fmad=false (no multiply-add is contracted into an FMA) and no fast-math
// (denormals are kept, division and conversions round to nearest even).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define G8_MAX_NU 20   // moduli (INT8 or FP8)
#define G8_MAX_NL 6    // 20-bit limbs of the quantized integer (encode)
#define G8_MAX_L 7     // 16-bit limbs of the CRT sum (epilogue)

// magic and bias are the division-free reduction's constants (encode.cuh,
// reduce_biased): bias_i is a multiple of p_i plus floor(p_i / 2), at least
// G8_REDUCE_RANGE, so that acc + bias_i lies in [0, 2^32) for every
// |acc| <= G8_REDUCE_RANGE; magic_i = floor(2^32 / p_i). Both are 0 for a
// power-of-two modulus, which is reduced by a mask.
#define G8_REDUCE_RANGE 2147481600u  // 2^31 - 2^11 > 6 * 2^19 * 545

struct EncodePlan {
    int nu;                          // number of moduli
    int nl;                          // 20-bit limbs in use (<= G8_MAX_NL)
    int max_exp;                     // clamp of a component's bit position
    int p[G8_MAX_NU];                // moduli
    int w[G8_MAX_NU][G8_MAX_NL];     // wrap(2^(20*lv) mod p_i)
    unsigned magic[G8_MAX_NU];       // floor(2^32 / p_i)
    unsigned bias[G8_MAX_NU];        // ceil(RANGE / p_i) * p_i + p_i / 2
};

// the FP8 encoder's plan: the limb plan of the FP8 moduli, and per modulus
// its split (q = sqrt(p) and the f32 1/q for a square modulus, q = 0 for a
// Karatsuba one) and the planes of this side's stack that its values go to,
// resolved on the host from the side's slot order (fp8.slot_order):
// plane[i][0] takes x, plane[i][1] takes y, plane[i][2] takes z for a
// Karatsuba modulus and y once more for a square one (whose z is 0 and is
// not stacked). The first G8_NOT_KARATSUBA moduli are the square ones.
#define G8_NOT_KARATSUBA 6

struct EncodePlanFp8 {
    EncodePlan enc;
    int sq[G8_MAX_NU];
    float inv_sq[G8_MAX_NU];
    int plane[G8_MAX_NU][3];
};

struct EpiloguePlan {
    int nu;                          // number of moduli
    int L;                           // 16-bit limbs in use (<= G8_MAX_L)
    int base;                        // limb li has unit 2^(base + 16*li)
    float invp_top;                  // 2^(base + 16*(L-3)) / P, f32
    int p[G8_MAX_NU];                // moduli
    int w16[G8_MAX_NU][G8_MAX_L];    // 16-bit slices of qPi >> base
    int p16[G8_MAX_L];               // 16-bit slices of P >> base
    float s1[G8_MAX_L], s2[G8_MAX_L];  // static pow2 pair of limb li's unit
    unsigned magic[G8_MAX_NU];       // floor(2^32 / p_i)
    unsigned wrap_off[G8_MAX_NU];    // (floor(p_i / 2) - 2^31) mod p_i
};

// the FP8 epilogue's plan: the CRT plan of the FP8 moduli and, per modulus,
// q = sqrt(p) for a square modulus (its three products recombine as
// q*(C0 + C1) + C2) or 0 for a Karatsuba one (256*C0 + 16*(C2-C0-C1) + C1),
// p, 1/p rounded to f32 and q as f32 for the f32 reassembly, and the limbs'
// start: -sum over the moduli of offset_i * w16[i][li] modulo 2^32, where
// offset_i is what modulus i's residue carries into the limbs (0x4B400000,
// the f32 bits of 1.5 * 2^23, or 512 for p = 1024: epilogue_fp8.cu)
struct EpiloguePlanFp8 {
    EpiloguePlan crt;
    int sq[G8_MAX_NU];
    float p_f[G8_MAX_NU];
    float inv_p[G8_MAX_NU];
    float sq_f[G8_MAX_NU];
    unsigned lim0[G8_MAX_L];
};

// the tensor-core CRT epilogue's plan: the CRT plan (its L, base, p16,
// invp_top, descale pairs and wrap constants), the number of 8-bit columns,
// per modulus the probe's f32 wrap constants (wrap(2^16 mod p) and the f32
// of the double 1/p), and the 8-bit columns of qPi >> base as the u8
// operand of the column sum in the kernel's depth order: c8[j][4t + u] =
// byte j of qP_i >> base for modulus i = t + 4u (t, u < 4), c8[j][16 + 4t] =
// that of modulus 16 + t; zero past n_cols and nu and at every other depth
// (epilogue_mxu.cu: lane t of a quad holds the residues of moduli t + 4u)
#define G8_MXU_COLS 16  // n_cols <= 14, padded to two of the mma's 8 columns
#define G8_MXU_K 32     // nu <= 20, padded to the mma's depth of 32

struct EpiloguePlanMxu {
    EpiloguePlan crt;
    int n_cols;
    int w2[G8_MAX_NU];
    float inv_p[G8_MAX_NU];
    unsigned char c8[G8_MXU_COLS][G8_MXU_K];
};

// floor(a / b) for b > 0 (C's / truncates toward zero)
__device__ __forceinline__ int floordiv(int a, int b) {
    int q = a / b;
    return (q * b > a) ? q - 1 : q;
}

// exact 2^e by exponent-field assembly (the field wraps outside the range,
// bit for bit as the PyTorch and JAX versions do)
__device__ __forceinline__ float pow2f(int e) {
    return __int_as_float((int)((unsigned)(e + 127) << 23));
}

__device__ __forceinline__ double pow2d(int e) {
    return __longlong_as_double(
        (long long)((unsigned long long)(long long)(e + 1023) << 52));
}

__device__ __forceinline__ void pow2_factor(int e, float& f) { f = pow2f(e); }
__device__ __forceinline__ void pow2_factor(int e, double& f) { f = pow2d(e); }

// x * 2^s as three power-of-two multiplies with the floor split of s
// (quantize.pow2_scale): the factors are computed once per shift (a row's
// or column's) and applied to each element in pow2_scale's order
template <typename T>
struct Pow2Split {
    T f1, f2, f3;
    __device__ explicit Pow2Split(int s) {
        const int h1 = floordiv(s, 3);
        const int h2 = floordiv(s - h1, 2);
        pow2_factor(h1, f1);
        pow2_factor(h2, f2);
        pow2_factor(s - h1 - h2, f3);
    }
    __device__ T apply(T x) const { return ((x * f1) * f2) * f3; }
};

__device__ __forceinline__ double pow2_scale_d(double x, int s) {
    return Pow2Split<double>(s).apply(x);
}
