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
//  shared with the FP8 encoder; this file holds their INT8 Emit policies.
//
// K1l, the INT8 lane encoder of complex operands (Int8Lanes, g8_encode_lanes
// below): quantize Re and Im of one operand by its per-row (A) or per-column
// (B) powers of two and emit, per INT8 modulus, the three 3M lanes' residue
// planes: wrap(r_re), wrap(r_im) and s = wrap(r_re + r_im), in a
// (3, nu, rows, cols) stack (B's planes k-contiguous).
//
// Replaces no Pallas kernel: the JAX package builds the third lane in jnp
// (gemmul8_tpu/complex_gemm.py, _quantize_complex). Its plain version is
// kernels.encode_planes_plain's lane form, in JAX's order: the wrapped
// residues of Re and of Im (the 'C' op negates the Im value before it is
// quantized, never the residue after), then their wrapped sum.
//
// Bound on the H100: bytes and 32-bit operations nearly level. Per element
// it reads Re and Im (16 bytes for f64) and writes 3nu bytes: at nu=16,
// 4.3 GB at 8192^2, 1.28 ms at 3.35 TB/s. Its operations are two of K1's
// per-element preambles and, per modulus, two limb dots and reductions, the
// wrapped sum and three stores: about 590 32-bit operations an element at
// nu=16 for f64, 1.18 ms (chip_smoke.int8_lane_encode_bound).
//
// Design: an Emit policy of two operands on K1's frames, as K6c is on the
// FP8 side: each thread quantizes the same 4 consecutive elements of Re and
// Im, so that the two reads are the only reads and the (Re+Im) lane never
// exists outside registers; per modulus it writes one 32-bit word to each of
// the three lanes' planes (byte stores where K1 takes them). The sum lane
// comes from the two biased residues in [0, p) (reduce_biased), as
// (u_re + u_im + p - floor(p/2)) mod p by two unsigned min steps; for p = 256
// it is the byte-wise sum of the two low-byte words. B's tiles of Re and Im
// are both staged through shared memory, 16 columns a block (encode.cuh):
// on an H100 (700 W) at 8192^2, f64 nu=16, B takes 2.900 ms staged against
// 2.980 ms read directly as K6c reads it, f32 nu=8 1.340 against 1.357 (A:
// 2.936 ms; probes.epilogue_tiles, variant "K1l B read directly").
#include "encode.cuh"

namespace {

// 4 residues (byte e from r[e]'s low byte) as one word
__device__ __forceinline__ unsigned pack_bytes(const unsigned (&r)[4]) {
    return __byte_perm(__byte_perm(r[0], r[1], 0x0040),
                       __byte_perm(r[2], r[3], 0x0040), 0x5410);
}

// one word of 4 elements' bytes at dst: a 32-bit store where allowed, else
// the first `valid` bytes one by one
__device__ __forceinline__ void put_word(int8_t* dst, int valid, bool word,
                                         unsigned w) {
    if (word && valid == 4) {
        *reinterpret_cast<unsigned*>(dst) = w;
    } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
            if (e < valid) dst[e] = (int8_t)(w >> (8 * e));
    }
}

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
        const unsigned w = pack_bytes(r);
        // r in [0, p) with p < 256: byte(r - p/2) = byte(r) - byte(p/2)
        return p == 256 ? w : __vsub4(w, (unsigned)(p >> 1) * 0x01010101u);
    }

    template <int NL>
    __device__ static void emit(int8_t* out, size_t pos, size_t plane,
                                int valid, bool word, const int (&lim)[4][NL],
                                const EncodePlan& plan) {
        for (int i = 0; i < plan.nu; ++i)
            put_word(out + i * plane + pos, valid, word,
                     residue_word<NL>(lim, plan, i));
    }
};

// the three 3M lanes of a complex operand (encode.cuh's Emit policy of two
// operands): per modulus the residue words of Re and of Im, and the word of
// their wrapped sum, stored to the lanes' planes nu planes apart
struct Int8Lanes {
    using Plan = EncodePlan;
    using Out = int8_t;
    static constexpr bool kStageB = true;
    static constexpr int kInputs = 2;    // Re, Im
    __host__ __device__ static const EncodePlan& enc(const Plan& p) {
        return p;
    }

    template <int NL>
    __device__ static void emit(int8_t* out, size_t pos, size_t plane,
                                int valid, bool word,
                                const int (&lim)[2][4][NL],
                                const EncodePlan& plan) {
        const size_t lane = (size_t)plan.nu * plane;     // one lane's planes
        for (int i = 0; i < plan.nu; ++i) {
            const unsigned p = (unsigned)plan.p[i];
            unsigned wr, wi, ws;
            if (p == 256) {              // the low bytes, summed byte-wise
                unsigned r[4], q[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    r[e] = (unsigned)lim[0][e][0];
                    q[e] = (unsigned)lim[1][e][0];
                }
                wr = pack_bytes(r);
                wi = pack_bytes(q);
                ws = __vadd4(wr, wi);
            } else {
                // u = wrap(r) + floor(p/2) in [0, p), and the sum's as
                // (u_re + u_im + p - floor(p/2)) mod p: the value lies in
                // [p - p/2, 3p), so two unsigned min steps reduce it
                const unsigned h = p >> 1;
                unsigned r[4], q[4], t[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    r[e] = reduce_biased<NL>(lim[0][e], plan, i);
                    q[e] = reduce_biased<NL>(lim[1][e], plan, i);
                    unsigned s = r[e] + q[e] + (p - h);
                    s = min(s, s - p);
                    t[e] = min(s, s - p);
                }
                const unsigned off = h * 0x01010101u;
                wr = __vsub4(pack_bytes(r), off);
                wi = __vsub4(pack_bytes(q), off);
                ws = __vsub4(pack_bytes(t), off);
            }
            int8_t* dst = out + i * plane + pos;
            put_word(dst, valid, word, wr);
            put_word(dst + lane, valid, word, wi);
            put_word(dst + 2 * lane, valid, word, ws);
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

// re, im: (rows, cols) contiguous f32 or f64, one dtype; sft: int32 per row
// (scale_axis 0) or per column (1); out: the 3 lanes of nu int8 planes, A's
// (3, nu, rows, cols) row-major, B's stored (3, nu, cols, rows). vec: the
// planes' contiguous axis (cols for A, rows for B) is a multiple of 4 and
// out (and, for A, re and im) 16-byte aligned. conj: Im negated before it
// is quantized. Returns the CUDA error of the launch (0 on success).
extern "C" int g8_encode_lanes(const void* re, const void* im,
                               const void* sft, void* out,
                               const void* plan_ptr, int is_f64,
                               int scale_axis, int rows, int cols, int vec,
                               int conj, void* stream) {
    return launch_encode<Int8Lanes>(
        re, sft, out, *static_cast<const EncodePlan*>(plan_ptr), is_f64,
        scale_axis, rows, cols, vec, static_cast<cudaStream_t>(stream), im,
        conj);
}
