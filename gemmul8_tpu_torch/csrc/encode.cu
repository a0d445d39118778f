// Residue-plane encoder: quantize one operand by per-row (A) or per-column (B)
// powers of two and emit wrap(v mod p_i) as int8 for each INT8 modulus.
//
// Replaces: gemmul8_tpu/pallas_kernels.py, encode_planes_tiles (its body
// _limbs_from_components and _encode_kernel). Semantics are those of
// quantize.residues_wrapped with three f32 components of an f64, which is the
// JAX package's CPU path and the plain version of this kernel: the input is
// scaled in its own dtype before the split, the scale uses the floor split of
// pow2_scale, and a component's bit position is clamped at max_exp.
//
// Bound on the H100: 32-bit operations, nearly level with the bytes. Per
// element the function needs the f64 scale, three component splits, the
// placement into up to six 20-bit limbs, a carry pass and, per modulus, a
// short dot with the static limb weights and a reduction by p: about 250
// 32-bit operations at nu=16 for f64 (chip_smoke.encode_bound), 0.50 ms at
// 8192^2 against 0.48 ms for its 8 bytes read and nu written.
//
// Design (redesigned from a one-element-per-thread kernel that reduced with
// `%` by a run-time modulus, a full integer division per modulus):
//  - Division-free reduction: per modulus the limb dot is summed with a bias
//    (a multiple of p plus floor(p/2)) in unsigned arithmetic and reduced by
//    a multiply-high with floor(2^32 / p), one correction by an unsigned min
//    (encode.cuh, reduce_biased); the magics come in the plan from Python.
//  - The limb count is a template parameter: the limb loops unroll unguarded.
//  - Wide stores: each thread encodes 4 consecutive elements along the
//    plane's contiguous axis, packs their 4 residue bytes with prmt, takes
//    floor(p/2) off all four with one SIMD byte subtraction and writes one
//    32-bit word per plane (byte stores where the axis is not a multiple of
//    4 or the pointer not aligned, and at the ragged tail). The power-of-two
//    modulus 256 is limb 0's low byte as it stands.
//  - The row's or column's scale factors are computed once per thread.
//  - A (axis 0, planes (nu, m, k) row-major): a 32x8 block, each thread 4
//    consecutive elements of a row, read with 16-byte loads where aligned.
//  - B (axis 1, planes stored (nu, n, k), k-contiguous as the int8 product
//    reads B): a 128 (k) x 32 (n) tile of x is staged through shared memory
//    with reads along x's rows (n), then each warp writes 128 consecutive k
//    of one column per plane, bank-conflict free.
//  Both frames are encode.cuh's (encode_rows_kernel, encode_cols_kernel),
//  shared with the FP8 encoder; this file is their INT8 Emit policy.
#include "encode.cuh"

namespace {

// the INT8 planes (encode.cuh's Emit policy): per modulus one residue byte
// per element, one 32-bit word per plane for 4 elements where allowed
struct Int8Residues {
    using Plan = EncodePlan;
    using Out = int8_t;
    static constexpr bool kStageB = true;
    static constexpr int kInputs = 1;
    __host__ __device__ static const EncodePlan& enc(const Plan& p) {
        return p;
    }

    // the 4 residue bytes of modulus i for 4 elements, as one word (byte e
    // of element e), and that word's bytes as int8 residues in [-p/2, p/2)
    template <int NL>
    __device__ static unsigned residue_word(const int (&lim)[4][NL],
                                            const EncodePlan& plan, int i) {
        const int p = plan.p[i];
        unsigned r[4];
        if (p == 256) {                  // wrap(v mod 256) = v's low byte
#pragma unroll
            for (int e = 0; e < 4; ++e) r[e] = (unsigned)lim[e][0];
        } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
                r[e] = reduce_biased<NL>(lim[e], plan, i);
        }
        const unsigned w = __byte_perm(__byte_perm(r[0], r[1], 0x0040),
                                       __byte_perm(r[2], r[3], 0x0040),
                                       0x5410);
        // r in [0, p) with p < 256: byte(r - p/2) = byte(r) - byte(p/2)
        return p == 256 ? w : __vsub4(w, (unsigned)(p >> 1) * 0x01010101u);
    }

    template <int NL>
    __device__ static void emit(int8_t* out, size_t pos, size_t plane,
                                int valid, bool word, const int (&lim)[4][NL],
                                const EncodePlan& plan) {
        for (int i = 0; i < plan.nu; ++i) {
            const unsigned w = residue_word<NL>(lim, plan, i);
            int8_t* dst = out + i * plane + pos;
            if (word && valid == 4) {
                *reinterpret_cast<unsigned*>(dst) = w;
            } else {
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    if (e < valid) dst[e] = (int8_t)(w >> (8 * e));
            }
        }
    }
};

}  // namespace

// x: (rows, cols) contiguous f32 or f64; sft: int32 per row (scale_axis 0)
// or per column (1); out: nu planes as described above. vec: the plane's
// contiguous axis (cols for A, rows for B) is a multiple of 4 and out (and,
// for A, x) 16-byte aligned, so that words and 16-byte loads may be used.
// Returns the CUDA error of the launch (0 on success).
extern "C" int g8_encode_planes(const void* x, const void* sft, void* out,
                                const void* plan_ptr, int is_f64,
                                int scale_axis, int rows, int cols, int vec,
                                void* stream) {
    return launch_encode<Int8Residues>(
        x, sft, out, *static_cast<const EncodePlan*>(plan_ptr), is_f64,
        scale_axis, rows, cols, vec, static_cast<cudaStream_t>(stream));
}
