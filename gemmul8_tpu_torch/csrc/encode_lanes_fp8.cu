// FP8 lane encoder of complex operands (K6c): quantize Re and Im of one
// operand by its per-row (A) or per-column (B) powers of two, reduce each
// modulo every FP8 modulus, form the third 3M lane (Re + Im) mod p, and
// split each of the three lanes' residues without error into e4m3-exact
// integers in [-16, 16], emitted as three (3nu, rows, cols) GEMM-ready
// stacks in this side's slot order: Re's, then Im's, then (Re+Im)'s.
//
// Replaces no Pallas kernel: the JAX package builds these lanes in jnp
// (gemmul8_tpu/complex_gemm.py:50-61, _quantize_complex on FP8), and this
// kernel is the complex counterpart of K6 (encode_fp8.cu). Its plain
// version, kernels.encode_lanes_fp8_plain, follows JAX's order: the
// wrapped residues of Re and of Im (quantize.residues_wrapped; the 'C' op
// negates the Im value before it is quantized, never the residue after),
// s = wrap(r_re + r_im), then fp8.split_planes and fp8._gemm_stack on each
// lane:
//   square moduli p = q^2:  bx = rint(r * f32(1/q)), by = r - q*bx
//                           (in f32, uncontracted), bz = 0 (not stacked);
//   the other moduli:       bx = sign(r) * ((|r| + 15) >> 4),
//                           by = r - 16*bx, bz = bx + by.
//
// Bound on the H100: the bytes. Per element the function reads Re and Im
// (8 or 16 bytes) and writes 9nu e4m3 bytes: at nu=14 f64, 142 bytes, 9.5
// GB at 8192^2, 2.8 ms at 3.35 TB/s. The operations are two of K6's
// preambles and, per modulus, two limb dots and reductions, the wrapped
// sum and three splits (chip_smoke.lane_encode_bound).
//
// Design: an Emit policy of two operands on K1's and K6's frames
// (encode.cuh): each thread quantizes the same 4 consecutive elements of Re
// and of Im along the planes' contiguous axis, so that the two reads are
// the only reads and the (Re+Im) lane never exists outside registers; per
// modulus it writes one 32-bit word to each of the 9 planes the modulus
// has across the three lanes (byte stores at the ragged tail, or where the
// axis is not a multiple of 4 or a pointer is unaligned: the wrapper's vec
// flag, kernels._encode_vec). B is read directly, not staged, as K6 reads
// it. The planes of each value come from the plan's plane map
// (kernels.fp8_plane_map), the same for the three lanes. The conversions
// are plain (int to f32, rintf); e4m3 bytes come two per instruction. A
// simple kernel first: K6's full-rate conversions and two loops by modulus
// kind are left for a redesign.
#include <cuda_fp8.h>

#include "encode.cuh"

namespace {

// 4 values (integers in [-16, 16] or -0, exact in e4m3) as the e4m3 bytes
// of one word, byte e from v[e]
__device__ __forceinline__ unsigned e4m3_word(const float (&v)[4]) {
    const unsigned lo = __nv_cvt_float2_to_fp8x2(
        make_float2(v[0], v[1]), __NV_SATFINITE, __NV_E4M3);
    const unsigned hi = __nv_cvt_float2_to_fp8x2(
        make_float2(v[2], v[3]), __NV_SATFINITE, __NV_E4M3);
    return lo | (hi << 16);
}

// the three lanes' FP8 stacks (encode.cuh's Emit policy of two operands)
struct Fp8Lanes {
    using Plan = EncodePlanFp8;
    using Out = unsigned char;           // e4m3 bytes
    static constexpr bool kStageB = false;
    static constexpr int kInputs = 2;    // Re, Im
    __host__ __device__ static const EncodePlan& enc(const Plan& p) {
        return p.enc;
    }

    // one word of 4 elements' bytes at dst
    __device__ static void put(unsigned char* dst, int valid, bool word,
                               unsigned w) {
        if (word && valid == 4) {
            *reinterpret_cast<unsigned*>(dst) = w;
        } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
                if (e < valid) dst[e] = (unsigned char)(w >> (8 * e));
        }
    }

    // one lane's residues r of modulus i, split and stored into the lane's
    // planes of that modulus (a square modulus' y goes to two planes)
    __device__ static void split_store(unsigned char* lane, const Plan& plan,
                                       int i, size_t pos, size_t plane,
                                       int valid, bool word,
                                       const int (&r)[4]) {
        float bx[4], by[4], bz[4];
        if (i < G8_NOT_KARATSUBA) {              // p = q^2: r = q*bx + by
            const float q = (float)plan.sq[i], inv = plan.inv_sq[i];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float rf = (float)r[e];
                bx[e] = rintf(rf * inv);
                by[e] = rf - q * bx[e];
                bz[e] = by[e];
            }
        } else {                                 // r = 16*bx + by, bz
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int mag = (abs(r[e]) + 15) >> 4;
                const int x = r[e] < 0 ? -mag : mag;
                const int y = r[e] - 16 * x;
                bx[e] = (float)x;
                by[e] = (float)y;
                bz[e] = (float)(x + y);
            }
        }
        put(lane + plan.plane[i][0] * plane + pos, valid, word, e4m3_word(bx));
        put(lane + plan.plane[i][1] * plane + pos, valid, word, e4m3_word(by));
        put(lane + plan.plane[i][2] * plane + pos, valid, word, e4m3_word(bz));
    }

    template <int NL>
    __device__ static void emit(unsigned char* out, size_t pos, size_t plane,
                                int valid, bool word,
                                const int (&lim)[2][4][NL], const Plan& plan) {
        const int nu = plan.enc.nu;
        const size_t lane = (size_t)3 * nu * plane;   // one lane's stack
        for (int i = 0; i < nu; ++i) {
            const int p = plan.enc.p[i];
            int rr[4], ri[4], rs[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                rr[e] = limb_residue<NL>(lim[0][e], plan.enc, i);
                ri[e] = limb_residue<NL>(lim[1][e], plan.enc, i);
                int s = rr[e] + ri[e];               // in [-p, p)
                if (2 * s >= p) s -= p;
                if (2 * s < -p) s += p;
                rs[e] = s;
            }
            split_store(out, plan, i, pos, plane, valid, word, rr);
            split_store(out + lane, plan, i, pos, plane, valid, word, ri);
            split_store(out + 2 * lane, plan, i, pos, plane, valid, word, rs);
        }
    }
};

}  // namespace

// re, im: (rows, cols) contiguous f32 or f64, one dtype; sft: int32 per row
// (scale_axis 0) or per column (1); out: 3 lanes of 3nu e4m3 planes, A's
// (3, 3nu, rows, cols) row-major, B's stored (3, 3nu, cols, rows). vec: the
// planes' contiguous axis (cols for A, rows for B) is a multiple of 4 and
// out (and, for A, re and im) 16-byte aligned. conj: Im negated before it
// is quantized. Returns the CUDA error of the launch (0 on success).
extern "C" int g8_encode_lanes_fp8(const void* re, const void* im,
                                   const void* sft, void* out,
                                   const void* plan_ptr, int is_f64,
                                   int scale_axis, int rows, int cols,
                                   int vec, int conj, void* stream) {
    return launch_encode<Fp8Lanes>(
        re, sft, out, *static_cast<const EncodePlanFp8*>(plan_ptr), is_f64,
        scale_axis, rows, cols, vec, static_cast<cudaStream_t>(stream), im,
        conj);
}
