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
//    of one column per plane. The tile's k index is stored permuted
//    ((k % 4) * 32 + k / 4, row pitch 129), so both the staging writes and
//    the 4-consecutive-k reads meet no bank conflict.
#include "encode.cuh"

namespace {

constexpr int kTileK = 128;      // axis 1: rows of x (k) per block
constexpr int kTileN = 32;       // axis 1: columns of x (n) per block
constexpr int kPitch = kTileK + 1;

// the 4 residue bytes of modulus i for 4 elements, as one word (byte e of
// element e), and that word's bytes as int8 residues in [-p/2, p/2)
template <int NL>
__device__ __forceinline__ unsigned residue_word(const int (&lim)[4][NL],
                                                 const EncodePlan& plan,
                                                 int i) {
    const int p = plan.p[i];
    unsigned r[4];
    if (p == 256) {                      // wrap(v mod 256) = v's low byte
#pragma unroll
        for (int e = 0; e < 4; ++e) r[e] = (unsigned)lim[e][0];
    } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) r[e] = reduce_biased<NL>(lim[e], plan, i);
    }
    const unsigned w = __byte_perm(__byte_perm(r[0], r[1], 0x0040),
                                   __byte_perm(r[2], r[3], 0x0040), 0x5410);
    // r in [0, p) with p < 256: byte(r - p/2) = byte(r) - byte(p/2)
    return p == 256 ? w : __vsub4(w, (unsigned)(p >> 1) * 0x01010101u);
}

// the nu planes' words of 4 elements at offset pos of plane 0, of which the
// first `valid` exist; one 32-bit store per plane where `word` allows
template <int NL>
__device__ __forceinline__ void store_residues(int8_t* out, size_t pos,
                                               size_t plane, int valid,
                                               bool word,
                                               const int (&lim)[4][NL],
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

// A: thread (x, y) of a 32x8 block encodes elements c0 .. c0+3 of row r
template <typename T, int NL>
__global__ void __launch_bounds__(256)
encode_rows_kernel(const T* __restrict__ x, const int* __restrict__ sft,
                   int8_t* __restrict__ out,
                   const __grid_constant__ EncodePlan plan, int rows,
                   int cols, int vec) {
    const int r = blockIdx.y * 8 + threadIdx.y;
    const int c0 = (blockIdx.x * 32 + threadIdx.x) * 4;
    if (r >= rows || c0 >= cols) return;
    const int valid = min(cols - c0, 4);
    const size_t pos = (size_t)r * cols + c0;
    T v[4];
    if (vec && valid == 4) {             // 16-byte loads: cols % 4 == 0
        if (sizeof(T) == 4) {
            const float4 q = *reinterpret_cast<const float4*>(x + pos);
            v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
        } else {
            const double2 q0 = *reinterpret_cast<const double2*>(x + pos);
            const double2 q1 = *reinterpret_cast<const double2*>(x + pos + 2);
            v[0] = q0.x; v[1] = q0.y; v[2] = q1.x; v[3] = q1.y;
        }
    } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = e < valid ? x[pos + e] : T(0);
    }
    const Pow2Split<T> scale(sft[r]);
    int lim[4][NL];
#pragma unroll
    for (int e = 0; e < 4; ++e)
        quantize_limbs<T, NL>(scale.apply(v[e]), plan.max_exp, lim[e]);
    store_residues<NL>(out, pos, (size_t)rows * cols, valid, vec, lim, plan);
}

// B: a block of 256 threads encodes a kTileK x kTileN tile of x (rows r0..,
// columns c0..); warp w takes columns w, w+8, w+16, w+24, lane l elements
// r0+4l .. r0+4l+3 of each
template <typename T, int NL>
__global__ void __launch_bounds__(256)
encode_cols_kernel(const T* __restrict__ x, const int* __restrict__ sft,
                   int8_t* __restrict__ out,
                   const __grid_constant__ EncodePlan plan, int rows,
                   int cols, int vec) {
    __shared__ T tile[kTileN * kPitch];
    const int r0 = blockIdx.x * kTileK, c0 = blockIdx.y * kTileN;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
#pragma unroll 4
    for (int it = 0; it < kTileK * kTileN / 256; ++it) {
        const int kr = it * (256 / kTileN) + tid / kTileN;
        const int nc = tid % kTileN;
        const int gr = r0 + kr, gc = c0 + nc;
        tile[nc * kPitch + (kr & 3) * 32 + (kr >> 2)] =
            gr < rows && gc < cols ? x[(size_t)gr * cols + gc] : T(0);
    }
    __syncthreads();
    const int valid = min(rows - (r0 + 4 * lane), 4);
    if (valid <= 0) return;
    for (int j = 0; j < kTileN / 8; ++j) {
        const int nc = warp + 8 * j;
        const int gc = c0 + nc;
        if (gc >= cols) break;
        const Pow2Split<T> scale(sft[gc]);
        int lim[4][NL];
#pragma unroll
        for (int e = 0; e < 4; ++e)
            quantize_limbs<T, NL>(scale.apply(tile[nc * kPitch + e * 32 + lane]),
                                  plan.max_exp, lim[e]);
        store_residues<NL>(out, (size_t)gc * rows + r0 + 4 * lane,
                           (size_t)rows * cols, valid, vec, lim, plan);
    }
}

template <typename T>
int launch(const void* x, const void* sft, void* out, const EncodePlan& plan,
           int axis, int rows, int cols, int vec, cudaStream_t st) {
    return dispatch_nl(plan.nl, [&](auto nl) {
        constexpr int NL = decltype(nl)::value;
        const T* xp = static_cast<const T*>(x);
        const int* sp = static_cast<const int*>(sft);
        int8_t* op = static_cast<int8_t*>(out);
        if (axis == 0) {
            const dim3 grid((cols + 127) / 128, (rows + 7) / 8);
            if (grid.y > 65535) return (int)cudaErrorInvalidValue;
            encode_rows_kernel<T, NL><<<grid, dim3(32, 8), 0, st>>>(
                xp, sp, op, plan, rows, cols, vec);
        } else {
            const dim3 grid((rows + kTileK - 1) / kTileK,
                            (cols + kTileN - 1) / kTileN);
            if (grid.y > 65535) return (int)cudaErrorInvalidValue;
            encode_cols_kernel<T, NL><<<grid, 256, 0, st>>>(
                xp, sp, op, plan, rows, cols, vec);
        }
        return (int)cudaGetLastError();
    });
}

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
    const EncodePlan& plan = *static_cast<const EncodePlan*>(plan_ptr);
    if (plan.nu < 1 || plan.nu > G8_MAX_NU || (scale_axis != 0
                                               && scale_axis != 1))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return is_f64 ? launch<double>(x, sft, out, plan, scale_axis, rows, cols,
                                   vec, st)
                  : launch<float>(x, sft, out, plan, scale_axis, rows, cols,
                                  vec, st);
}
