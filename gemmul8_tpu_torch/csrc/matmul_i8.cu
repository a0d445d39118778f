// Exact batched int8 product on the tensor cores:
// C[u] = A[u] @ B[u], (nu, m, k) s8 x (nu, k, n) s8 -> (nu, m, n) s32, with
// int32 sums that wrap (no saturation), as torch._int_mm's and XLA's do.
//
// Replaces the Pallas products of the probe tools, which all compute this one
// function and differ only in grid order and blocking:
//   tools/probe_fused.py    pallas_matmul_i8_seq    -> schedule kloop
//                           pallas_matmul_i8_astat  -> schedule astat
//   tools/probe_matmul3.py  mm_flat_kloop           -> kloop (flat views)
//                           mm_flat_fullk           -> astat (flat views)
//                           mm_flat_kloop_multidot  -> kloop, BK = 128
// The flat (nu*m, k) and (nu*k, n) views are the same memory as the batched
// ones, so the wrapper takes them as (nu, m, k) and (nu, k, n).
//
// Bound on the H100: operations. 2 * nu * m * n * k int8 operations at the
// dense 1,979 T/s (8.889 ms at 8192^3, nu=16), against nu * (m*k + k*n) bytes
// read and 4 * nu * m * n written (1.6 ms at 8192^3).
//
// Design (a first, simple kernel; the wgmma + TMA kernel that replaces it
// wherever TMA can address the operands is matmul_i8_wgmma.cu, and this one
// stays the route for the rest, e.g. k = 97): a 128 x 128 output tile per
// thread block of 8 warps, each warp a 64 x 32 tile of
// mma.sync.m16n8k32.s32.s8.s8.s32 fragments held in registers. K is staged
// through shared memory in BK-deep tiles (64, or 128 for the deeper K
// stage), double-buffered: the next tile's loads are in
// flight while the tensor cores work on the current one.
//  - A is row-major, and B k-contiguous ((nu, n, k) storage, the main path's
//    plane layout) is the .col operand mma wants: both are copied with 16-byte
//    cp.async where rows are aligned (k % 16 == 0), else with byte loads.
//  - B n-contiguous ((nu, k, n), the probes' layout) is transposed while it is
//    staged: each thread loads a 16 (k) x 4 (n) block of words into registers
//    before the current tile's products and stores it, byte-transposed with
//    prmt, after them.
//  - Both operands are staged as [row][k] tiles with the 16-byte chunks of a
//    row XOR-swizzled, so that the fragment loads (128-bit, one row per
//    fragment row) meet no bank conflict.
//  - Fragment loads use one permutation of K for both operands: thread t of a
//    quad loads bytes 16t..16t+15 of each 64-deep block and feeds them to two
//    k32 steps. A dot product does not depend on the order of its terms, so
//    the sums are exact either way, and each fragment costs one 128-bit load
//    instead of four 32-bit ones.
//  - Any m, n, k >= 1: tiles past the edges are zero-filled, stores guarded.
//  - Schedules: kloop, one block per (tile of C, plane) with K innermost;
//    astat, one block per (row block, plane) sweeping every column block, so
//    the block's rows of A are re-read from L2 (a 128-row A block of full K
//    does not fit shared memory, so "stationary" is the traversal order).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;          // rows of A (and of C) per block
constexpr int BN = 128;          // columns of B (and of C) per block
constexpr int kThreads = 256;    // 8 warps: 2 (m) x 4 (n), 64 x 32 each

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint4 lds128(const int8_t* p) {
    return *reinterpret_cast<const uint4*>(p);
}

// d += a (16 x 32, row) . b (32 x 8, col), int8 in, int32 sums that wrap
__device__ __forceinline__ void mma_s8(int* d, unsigned a0, unsigned a1,
                                       unsigned a2, unsigned a3, unsigned b0,
                                       unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// byte offset in a [128][BK] tile of 16-byte chunk `chunk` of row `row`,
// XOR-swizzled: the 8 rows a quarter-warp's 128-bit fragment loads touch,
// and the rows of a transposed store, land on distinct banks
template <int BK>
__device__ __forceinline__ int swz(int row, int chunk) {
    const int x = BK == 128 ? (((row & 1) << 2) | ((row >> 2) & 3))
                            : ((row >> 2) & 3);
    return row * BK + ((chunk ^ x) * 16);
}

// the [128][BK] tile (rows r0.., k0..) of a row-major (rows, k) int8 matrix
template <int BK>
__device__ __forceinline__ void stage_rows(int8_t* s, const int8_t* g,
                                           int rows, int k, int r0, int k0,
                                           bool vec) {
    constexpr int CPR = BK / 16;                 // 16-byte chunks per row
    for (int c = threadIdx.x; c < BM * CPR; c += kThreads) {
        const int row = c / CPR, ch = c % CPR;
        const int gr = r0 + row, gk = k0 + ch * 16;
        int8_t* dst = s + swz<BK>(row, ch);
        if (vec) {                               // k % 16 == 0: whole chunks
            const bool ok = gr < rows && gk < k;
            cp_async16(dst, ok ? g + (size_t)gr * k + gk : g, ok);
        } else {
            unsigned w[4] = {0u, 0u, 0u, 0u};
            if (gr < rows) {
                const int8_t* src = g + (size_t)gr * k;
#pragma unroll
                for (int e = 0; e < 16; ++e)
                    if (gk + e < k)
                        w[e >> 2] |= (unsigned)(uint8_t)src[gk + e]
                                     << (8 * (e & 3));
            }
            *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
        }
    }
}

// B n-contiguous: a 16 (k) x 4 (n) block of each thread's, loaded as words
// (4 n-values of one k) and stored transposed (16 k-values of one n)
template <int BK>
struct NContigB {
    static constexpr int kBlocks = (BK / 16) * (BN / 4);   // <= kThreads
    unsigned w[16];

    __device__ __forceinline__ void load(const int8_t* g, int k, int n,
                                         int k0, int n0, bool vec) {
        const int c = threadIdx.x;
        if (c >= kBlocks) return;
        const int gn = n0 + 4 * (c % (BN / 4));  // neighbours: neighbouring n
        const int gk0 = k0 + 16 * (c / (BN / 4));
#pragma unroll
        for (int r = 0; r < 16; ++r) {
            const int gk = gk0 + r;
            const int8_t* src = g + (size_t)gk * n + gn;
            if (vec && gk < k && gn < n) {       // n % 4 == 0: whole words
                w[r] = *reinterpret_cast<const unsigned*>(src);
            } else {
                unsigned v = 0u;
                if (gk < k)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        if (gn + e < n)
                            v |= (unsigned)(uint8_t)src[e] << (8 * e);
                w[r] = v;
            }
        }
    }

    __device__ __forceinline__ void store(int8_t* s) const {
        const int c = threadIdx.x;
        if (c >= kBlocks) return;
        const int nl = 4 * (c % (BN / 4)), kc = c / (BN / 4);
        unsigned col[4][4];                      // [n][k quad]
#pragma unroll
        for (int q = 0; q < 4; ++q) {            // the 4 x 4 byte blocks
            const unsigned t0 = __byte_perm(w[4 * q], w[4 * q + 1], 0x5140);
            const unsigned t1 = __byte_perm(w[4 * q + 2], w[4 * q + 3], 0x5140);
            const unsigned t2 = __byte_perm(w[4 * q], w[4 * q + 1], 0x7362);
            const unsigned t3 = __byte_perm(w[4 * q + 2], w[4 * q + 3], 0x7362);
            col[0][q] = __byte_perm(t0, t1, 0x5410);
            col[1][q] = __byte_perm(t0, t1, 0x7632);
            col[2][q] = __byte_perm(t2, t3, 0x5410);
            col[3][q] = __byte_perm(t2, t3, 0x7632);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
            *reinterpret_cast<uint4*>(s + swz<BK>(nl + e, kc)) =
                make_uint4(col[e][0], col[e][1], col[e][2], col[e][3]);
    }
};

// the products of one staged [128][BK] A tile and [128][BK] B tile into the
// warp's 64 x 32 block of sums: per 64-deep block, thread (g, t) loads bytes
// 16t..16t+15 of its fragment rows and feeds them to two k32 steps
template <int BK>
__device__ __forceinline__ void tile_products(const int8_t* sa,
                                              const int8_t* sb,
                                              int (&acc)[4][4][4], int wm,
                                              int wn, int g, int t) {
#pragma unroll
    for (int kb = 0; kb < BK / 64; ++kb) {
        uint4 bv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
            bv[j] = lds128(sb + swz<BK>(wn * 32 + j * 8 + g, kb * 4 + t));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int row = wm * 64 + i * 16 + g;
            const uint4 lo = lds128(sa + swz<BK>(row, kb * 4 + t));
            const uint4 hi = lds128(sa + swz<BK>(row + 8, kb * 4 + t));
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                mma_s8(acc[i][j], lo.x, hi.x, lo.y, hi.y, bv[j].x, bv[j].y);
                mma_s8(acc[i][j], lo.z, hi.z, lo.w, hi.w, bv[j].z, bv[j].w);
            }
        }
    }
}

__device__ __forceinline__ void store_pair(int* c, int m, int n, int row,
                                           int col, int v0, int v1,
                                           bool vec2) {
    if (row >= m) return;
    int* p = c + (size_t)row * n + col;
    if (vec2 && col + 1 < n) {
        *reinterpret_cast<int2*>(p) = make_int2(v0, v1);
    } else {
        if (col < n) p[0] = v0;
        if (col + 1 < n) p[1] = v1;
    }
}

template <int BK, bool ASTAT, bool BKC>
__global__ void __launch_bounds__(kThreads)
matmul_i8_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
                 int* __restrict__ C, int m, int n, int k, int a_vec,
                 int b_vec) {
    extern __shared__ __align__(16) int8_t smem[];
    constexpr int TILE = BM * BK;                // bytes of one staged tile
    const int u = blockIdx.z;
    const int8_t* ag = A + (size_t)u * m * k;
    const int8_t* bg = B + (size_t)u * k * n;
    int* cg = C + (size_t)u * m * n;
    const int m0 = blockIdx.y * BM;
    const int n_tiles = (n + BN - 1) / BN;
    const int nt_end = ASTAT ? n_tiles : blockIdx.x + 1;
    const int kt_count = (k + BK - 1) / BK;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int wm = warp >> 2, wn = warp & 3;
    const bool vec2 = (n & 1) == 0;

    for (int nt = ASTAT ? 0 : blockIdx.x; nt < nt_end; ++nt) {
        const int n0 = nt * BN;
        int acc[4][4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
        NContigB<BK> nb;
        // stage s: A at smem + 2 * s * TILE, B right after it
        auto stage = [&](int s, int k0) {
            stage_rows<BK>(smem + 2 * s * TILE, ag, m, k, m0, k0, a_vec);
            if (BKC)
                stage_rows<BK>(smem + (2 * s + 1) * TILE, bg, n, k, n0, k0,
                               b_vec);
            else
                nb.load(bg, k, n, k0, n0, b_vec);
        };
        if (kt_count > 0) {
            stage(0, 0);
            if (!BKC) nb.store(smem + TILE);
            cp_async_commit();
        }
        for (int kt = 0; kt < kt_count; ++kt) {
            const int cur = kt & 1;
            cp_async_wait_all();
            __syncthreads();          // tile kt landed; tile kt-1 is done
            const bool next = kt + 1 < kt_count;
            if (next) stage(cur ^ 1, (kt + 1) * BK);
            cp_async_commit();
            tile_products<BK>(smem + 2 * cur * TILE,
                              smem + (2 * cur + 1) * TILE, acc, wm, wn, g, t);
            if (!BKC && next) nb.store(smem + (2 * (cur ^ 1) + 1) * TILE);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int row = m0 + wm * 64 + i * 16 + g;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int col = n0 + wn * 32 + j * 8 + 2 * t;
                store_pair(cg, m, n, row, col, acc[i][j][0], acc[i][j][1],
                           vec2);
                store_pair(cg, m, n, row + 8, col, acc[i][j][2], acc[i][j][3],
                           vec2);
            }
        }
        if (ASTAT) __syncthreads();   // the next column block restages tile 0
    }
}

template <int BK, bool ASTAT, bool BKC>
int launch(const void* a, const void* b, void* c, int nu, int m, int n,
           int k, int a_vec, int b_vec, cudaStream_t st) {
    auto kern = matmul_i8_kernel<BK, ASTAT, BKC>;
    const int smem = 4 * BM * BK;                // 2 stages x (A + B)
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid(ASTAT ? 1 : (n + BN - 1) / BN, (m + BM - 1) / BM, nu);
    kern<<<grid, kThreads, smem, st>>>(
        static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
        static_cast<int*>(c), m, n, k, a_vec, b_vec);
    return (int)cudaGetLastError();
}

template <int BK, bool ASTAT>
int launch_layout(int b_kcontig, const void* a, const void* b, void* c,
                  int nu, int m, int n, int k, int a_vec, int b_vec,
                  cudaStream_t st) {
    return b_kcontig
        ? launch<BK, ASTAT, true>(a, b, c, nu, m, n, k, a_vec, b_vec, st)
        : launch<BK, ASTAT, false>(a, b, c, nu, m, n, k, a_vec, b_vec, st);
}

}  // namespace

// a: (nu, m, k) int8 row-major; b: (nu, k, n) int8, n-contiguous, or
// k-contiguous ((nu, n, k) storage) if b_kcontig; c: (nu, m, n) int32.
// astat selects the A-stationary schedule (bk 64 only), else the K-loop one
// (bk 64 or 128). a_vec / b_vec: rows of A (and of k-contiguous B) are
// 16-byte aligned (k % 16 == 0 and an aligned base), rows of n-contiguous B
// 4-byte aligned. Returns the CUDA error of the launch (0 on success).
extern "C" int g8_matmul_i8(const void* a, const void* b, void* c, int nu,
                            int m, int n, int k, int b_kcontig, int astat,
                            int bk, int a_vec, int b_vec, void* stream) {
    if (nu < 1 || nu > 65535 || m < 1 || n < 1 || k < 0
        || (m + BM - 1) / BM > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (astat && bk == 64)
        return launch_layout<64, true>(b_kcontig, a, b, c, nu, m, n, k, a_vec,
                                       b_vec, st);
    if (!astat && bk == 64)
        return launch_layout<64, false>(b_kcontig, a, b, c, nu, m, n, k,
                                        a_vec, b_vec, st);
    if (!astat && bk == 128)
        return launch_layout<128, false>(b_kcontig, a, b, c, nu, m, n, k,
                                         a_vec, b_vec, st);
    return (int)cudaErrorInvalidValue;
}
