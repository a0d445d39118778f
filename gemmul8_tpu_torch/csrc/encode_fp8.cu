// FP8 residue-plane encoder: quantize one operand by per-row (A) or
// per-column (B) powers of two, reduce modulo each FP8 modulus and split each
// residue without error into e4m3-exact integers in [-16, 16], emitted as the
// (3nu, rows, cols) GEMM-ready stack of this side's slot order.
//
// Replaces: gemmul8_tpu/pallas_kernels.py, encode_planes_fp8_tiles (its body
// _encode_kernel_fp8). Semantics are those of the plain version,
// fp8._gemm_stack(fp8.split_planes(quantize.residues_wrapped(...))): the
// limbs and residues are the INT8 encoder's (encode.cuh, one code path), then
//   square moduli p = q^2:  bx = rint(r * f32(1/q)), by = r - q*bx, bz = 0
//                           (in f32, uncontracted, as split_planes);
//   the other moduli:       bx = sign(r) * ((|r| + 15) >> 4),
//                           by = r - 16*bx, bz = bx + by;
// and the values go to the stack's planes of this modulus as e4m3 (the TPU
// kernel carries them in bf16; both hold them exactly).
//
// Bound on the H100: the bytes, about level with the 32-bit operations. Per
// element the function reads the 4- or 8-byte input and writes 3nu bytes
// (50 B at nu=14 f64: 1.0 ms at 8192^2); the operations are the INT8
// encoder's preamble plus, per modulus, the limb dot, a reduction by the
// constant p, the split and the conversions (chip_smoke.fp8_encode_bound).
//
// Design (redesigned from a one-element-per-thread kernel with 3nu byte
// stores an element, strided reads of B, a run-time slot select per plane
// and scalar conversions):
//  - K1's frames (encode.cuh): each thread encodes 4 consecutive elements
//    along the planes' contiguous axis and writes one 32-bit word per plane
//    (byte stores at the ragged tail, or where the axis is not a multiple of
//    4 or a pointer is unaligned: the wrapper's vec flag,
//    kernels._encode_vec); A is read with 16-byte loads; the scale factors
//    are computed once per row or column; the limb count is a template
//    parameter and the reduction K1's multiply-high.
//  - B is read directly, not through K1's shared-memory tile: each lane
//    reads 4 rows of one column, and a block's 8 warps take 8 neighbouring
//    columns, so the cache serves the rest of each sector. Staged, f64 B
//    took 2.6 ms against 2.06 at 8192^2 nu=14 (probes.epilogue_tiles, on
//    an H100; f32 B the same either way).
//  - Two loops by modulus kind, square then Karatsuba, with no per-modulus
//    branch on the kind.
//  - The planes of each value come resolved from the host (the plan's
//    plane map, kernels._encode_plan_fp8): three word stores per modulus,
//    no select.
//  - Conversions off the conversion pipe: an int in [-2^22, 2^22] becomes
//    its f32 by two adds around 1.5 * 2^23 (int_to_f32), rintf is two adds
//    and a copysign (rint_f32), and e4m3 bytes come two per instruction
//    (cvt.rn.satfinite.e4m3x2.f32). Each gives the bits of the plain
//    version's conversion, -0 from rint included (tests/
//    test_torch_fp8_mxu_redesign.py mirrors them in numpy).
// kPackedCvt and kPlaneMap switch the last two choices off; they, the word
// stores and B's direct read are undone one at a time by
// probes.epilogue_tiles.
#include <cuda_fp8.h>

#include "encode.cuh"

namespace {

constexpr bool kPackedCvt = true;    // full-rate int->f32, rint; e4m3 x2
constexpr bool kPlaneMap = true;     // the plan's planes; else a select

constexpr float kRound = 12582912.0f;  // 1.5 * 2^23

// (float)v for |v| <= 2^22: 1.5 * 2^23 + v assembled in the bits, less
// 1.5 * 2^23, both exact; 0 gives +0 as the conversion does
__device__ __forceinline__ float int_to_f32(int v) {
    if constexpr (!kPackedCvt) return (float)v;
    return __int_as_float(0x4B400000 + v) - kRound;
}

// rintf(x) for |x| <= 2^22: x + 1.5 * 2^23 rounds x to an integer, ties to
// even, and taking 1.5 * 2^23 off again is exact; copysign gives a zero
// x's sign, as rintf does (-0 for x in [-0.5, 0))
__device__ __forceinline__ float rint_f32(float x) {
    if constexpr (!kPackedCvt) return rintf(x);
    return copysignf((x + kRound) - kRound, x);
}

// 4 values (integers in [-16, 16] or -0, exact in e4m3) as the e4m3 bytes
// of one word, byte e from v[e]
__device__ __forceinline__ unsigned e4m3_word(const float (&v)[4]) {
    if constexpr (kPackedCvt) {
        const unsigned lo = __nv_cvt_float2_to_fp8x2(
            make_float2(v[0], v[1]), __NV_SATFINITE, __NV_E4M3);
        const unsigned hi = __nv_cvt_float2_to_fp8x2(
            make_float2(v[2], v[3]), __NV_SATFINITE, __NV_E4M3);
        return lo | (hi << 16);
    }
    unsigned w = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e)
        w |= (unsigned)__nv_cvt_float_to_fp8(v[e], __NV_SATFINITE, __NV_E4M3)
            << (8 * e);
    return w;
}

// the FP8 stack (encode.cuh's Emit policy)
struct Fp8Planes {
    using Plan = EncodePlanFp8;
    using Out = unsigned char;           // e4m3 bytes
    static constexpr bool kStageB = false;   // B read directly: faster
    static constexpr int kInputs = 1;
    __host__ __device__ static const EncodePlan& enc(const Plan& p) {
        return p.enc;
    }

    // plane pl's word of the 4 elements at pos
    __device__ static void put(unsigned char* out, int pl, size_t pos,
                               size_t plane, int valid, bool word,
                               unsigned w) {
        unsigned char* dst = out + pl * plane + pos;
        if (word && valid == 4) {
            *reinterpret_cast<unsigned*>(dst) = w;
        } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
                if (e < valid) dst[e] = (unsigned char)(w >> (8 * e));
        }
    }

    // modulus i's words x, y, z into its planes (a square modulus passes y
    // as z: plane[i][2] takes y there)
    __device__ static void put3(unsigned char* out, const Plan& plan, int i,
                                size_t pos, size_t plane, int valid,
                                bool word, unsigned wx, unsigned wy,
                                unsigned wz) {
        if constexpr (kPlaneMap) {
            put(out, plan.plane[i][0], pos, plane, valid, word, wx);
            put(out, plan.plane[i][1], pos, plane, valid, word, wy);
            put(out, plan.plane[i][2], pos, plane, valid, word, wz);
        } else {                         // each plane selects its value
#pragma unroll
            for (int s = 0; s < 3; ++s) {
                const int pl = 3 * i + s;
                const unsigned w = plan.plane[i][0] == pl ? wx
                    : (plan.plane[i][1] == pl ? wy : wz);
                put(out, pl, pos, plane, valid, word, w);
            }
        }
    }

    template <int NL>
    __device__ static void emit(unsigned char* out, size_t pos, size_t plane,
                                int valid, bool word, const int (&lim)[4][NL],
                                const Plan& plan) {
        const int nu = plan.enc.nu;
        const int n_sq = min(nu, G8_NOT_KARATSUBA);
        for (int i = 0; i < n_sq; ++i) {         // p = q^2: r = q*bx + by
            const float q = (float)plan.sq[i], inv = plan.inv_sq[i];
            float bx[4], by[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float rf = int_to_f32(limb_residue<NL>(lim[e],
                                                             plan.enc, i));
                bx[e] = rint_f32(rf * inv);
                by[e] = rf - q * bx[e];
            }
            const unsigned wy = e4m3_word(by);
            put3(out, plan, i, pos, plane, valid, word, e4m3_word(bx), wy,
                 wy);
        }
        for (int i = n_sq; i < nu; ++i) {        // r = 16*bx + by, bz
            float bx[4], by[4], bz[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int r = limb_residue<NL>(lim[e], plan.enc, i);
                const int mag = (abs(r) + 15) >> 4;
                const int x = r < 0 ? -mag : mag;
                const int y = r - 16 * x;
                bx[e] = int_to_f32(x);
                by[e] = int_to_f32(y);
                bz[e] = int_to_f32(x + y);
            }
            put3(out, plan, i, pos, plane, valid, word, e4m3_word(bx),
                 e4m3_word(by), e4m3_word(bz));
        }
    }
};

}  // namespace

// x: (rows, cols) contiguous f32 or f64; sft: int32 per row (scale_axis 0)
// or per column (1); out: 3nu e4m3 planes, A's (3nu, rows, cols) row-major,
// B's stored (3nu, cols, rows). vec: the planes' contiguous axis (cols for
// A, rows for B) is a multiple of 4 and out (and, for A, x) 16-byte
// aligned, so that words and 16-byte loads may be used. Returns the CUDA
// error of the launch (0 on success).
extern "C" int g8_encode_planes_fp8(const void* x, const void* sft, void* out,
                                    const void* plan_ptr, int is_f64,
                                    int scale_axis, int rows, int cols,
                                    int vec, void* stream) {
    return launch_encode<Fp8Planes>(
        x, sft, out, *static_cast<const EncodePlanFp8*>(plan_ptr), is_f64,
        scale_axis, rows, cols, vec, static_cast<cudaStream_t>(stream));
}
