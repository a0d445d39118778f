// FP8 reassembly (K3r): per output element and modulus, the wrapped residue
// of the modulus' product in [-p/2, p/2) from its three split products, as
// int32; with accumulate set, added to what the output holds (the K-chunked
// residue sums of fp8._chunked_residue_acc). It is K3's reassembly stage
// (epilogue_fp8.cu) with no CRT: the complex FP8 path runs it on each 3M
// lane's products, one lane at a time, into that lane's slot of the (3nu,
// m, n) int32 stack the complex epilogues (complex.cu) read.
//
// Replaces no Pallas kernel: the JAX package does this step in jnp
// (gemmul8_tpu/fp8.py:128-147, _reassemble, and :177-192). Plain version:
// kernels.reassemble_fp8_plain, fp8._reassemble, which it equals bit for
// bit on the (3nu, m, n) f32 stack of exact integer lane products
// (|C| <= 2^24, k <= 2^16): per modulus
//   square p = q^2:  r = wrap(q * (C0 + C1) + C2),
//   Karatsuba:       r = wrap(256*C0 + 16*(C2 - C0 - C1) + C1),
// r the unique representative in [-p/2, p/2).
//
// Bound on the H100: device memory. Each element reads 3nu f32 and writes
// nu int32 (reads them too when accumulating): at nu=14, 168 + 56 bytes,
// 15.0 GB at 8192^2, 4.5 ms at 3.35 TB/s.
//
// Design: K3's exact f32 steps on K2's frame (crt.cuh's Tile): each thread
// takes one row and kCols = 4 consecutive columns, each plane one 16-byte
// load and each output one 16-byte store where the wrapper's vec flag
// allows (n a multiple of 4, the tensors 16-byte aligned), else one column
// at a time. A lane product c is brought near its wrap by k = fma(c, 1/p,
// M) - M, M = 1.5 * 2^23, and r = fma(k, -p, c), exact, |r| <= p/2 + 1; the
// recombine (square: q (r0 + r1) + r2; Karatsuba: 240 r0 + 16 r2 - 15 r1)
// is exact, |t| < 2^17; the final wrap of t by the odd p is fma(k, -p, t +
// M), whose f32 bits are 0x4B400000 + r; p = 1024 (modulus 1) is wrapped by
// its mask. tests/test_torch_fp8_epilogue_redesign.py mirrors every step.
#include "crt.cuh"

namespace {

constexpr int kCols = 4;                       // columns a thread
constexpr float kMagic = 12582912.0f;          // M = 1.5 * 2^23
constexpr unsigned kMagicBits = 0x4B400000u;   // the f32 bits of M

// c - p * rint(c / p) give or take p: exact, |.| <= p/2 + 1 for |c| <= 2^24
__device__ __forceinline__ float near_wrap(float c, float p, float inv_p) {
    const float k = fmaf(c, inv_p, kMagic) - kMagic;
    return fmaf(k, -p, c);
}

// modulus q's wrapped residue from its three lane products
__device__ __forceinline__ int reassemble(float f0, float f1, float f2,
                                          const EpiloguePlanFp8& plan, int q) {
    const float p = plan.p_f[q], inv_p = plan.inv_p[q];
    const float r0 = near_wrap(f0, p, inv_p);
    const float r1 = near_wrap(f1, p, inv_p);
    const float r2 = near_wrap(f2, p, inv_p);
    const bool square = q < G8_NOT_KARATSUBA;
    const float t = square
        ? fmaf(r0 + r1, plan.sq_f[q], r2)
        : fmaf(r0, 240.0f, fmaf(r2, 16.0f, r1 * -15.0f));
    if (q == 1)                                         // p = 1024
        return (int)((__float_as_uint(t + kMagic) + 512u) & 1023u) - 512;
    const float k = fmaf(t, inv_p, kMagic) - kMagic;
    return (int)(__float_as_uint(fmaf(k, -p, t + kMagic)) - kMagicBits);
}

template <bool VEC>
__global__ void __launch_bounds__(32 * G8_TILE_ROWS)
reassemble_fp8_kernel(const int* __restrict__ c3, int* __restrict__ out,
                      int m, int n, int accumulate,
                      const __grid_constant__ EpiloguePlanFp8 plan) {
    constexpr int V = kCols;
    const Tile t = Tile::make<V>(n);
    if (t.nv == 0) return;
    const size_t mn = (size_t)m * n;
    const int nu = plan.crt.nu;
    for (int i = t.i0; i < m; i += t.row_step) {
        const size_t off = (size_t)i * n + t.j0;
        for (int q = 0; q < nu; ++q) {
            int x[3][V];
#pragma unroll
            for (int lane = 0; lane < 3; ++lane)
                load_cols<V, VEC>(c3 + (size_t)(3 * q + lane) * mn + off,
                                  t.nv, x[lane]);
            int* dst = out + (size_t)q * mn + off;
            int y[V];
            if (accumulate) {
                load_cols<V, VEC>(dst, t.nv, y);
            } else {
#pragma unroll
                for (int v = 0; v < V; ++v) y[v] = 0;
            }
#pragma unroll
            for (int v = 0; v < V; ++v)
                y[v] += reassemble(__int_as_float(x[0][v]),
                                   __int_as_float(x[1][v]),
                                   __int_as_float(x[2][v]), plan, q);
            store_cols<V, VEC>(dst, t.nv, y);
        }
    }
}

}  // namespace

// c3: (3nu, m, n) contiguous f32 lane products; out: (nu, m, n) contiguous
// int32, written, or added to where accumulate is set. vec: n is a multiple
// of kCols and c3 and out are 16-byte aligned (kernels._epilogue_vec). Only
// the plan's nu, p_f, inv_p and sq_f are read. Returns the CUDA error of
// the launch (0 on success).
extern "C" int g8_reassemble_fp8(const void* c3, void* out, int m, int n,
                                 int vec, int accumulate,
                                 const void* plan_ptr, void* stream) {
    const EpiloguePlanFp8& plan =
        *static_cast<const EpiloguePlanFp8*>(plan_ptr);
    if (plan.crt.nu < 1 || plan.crt.nu > G8_MAX_NU || m < 1 || n < 1
        || n > 0x7fffffff - 32 * kCols
        || (vec && (n % kCols || ((uintptr_t)c3 | (uintptr_t)out) % 16)))
        return (int)cudaErrorInvalidValue;
    dim3 grid, block;
    tile_grid(m, n, kCols, grid, block);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* c = static_cast<const int*>(c3);
    int* o = static_cast<int*>(out);
    if (vec)
        reassemble_fp8_kernel<true><<<grid, block, 0, st>>>(
            c, o, m, n, accumulate, plan);
    else
        reassemble_fp8_kernel<false><<<grid, block, 0, st>>>(
            c, o, m, n, accumulate, plan);
    return (int)cudaGetLastError();
}
