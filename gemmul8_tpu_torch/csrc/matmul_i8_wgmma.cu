// Exact batched int8 product on Hopper's warpgroup tensor-core path:
// C[u] = A[u] @ B[u], (nu, m, k) s8 x (nu, k, n) s8 -> (nu, m, n) s32, with
// int32 sums that wrap (no .satfinite), as torch._int_mm's and XLA's do.
// The main path's int8 products (core.residue_matmul: the nu or 3nu residue
// planes of a call in one launch), and the probe tools' products.
//
// Replaces the Pallas products of the probe tools:
//   tools/probe_fused.py    pallas_matmul_i8_seq    -> raster kloop
//                           pallas_matmul_i8_astat  -> raster astat
//   tools/probe_matmul3.py  mm_flat_kloop           -> kloop (flat views)
//                           mm_flat_fullk           -> astat (flat views)
//                           mm_flat_kloop_multidot  -> kloop
// (the flat views are the same memory as the batched ones), and the JAX
// package's int8 dot of the main path (gemmul8_tpu/core.py, left to XLA).
// Shapes TMA cannot address (k off 16, misaligned bases or strides) are
// refused by the wrapper (kernels.tma_addressable).
//
// Bound on the H100: operations. 2 * nu * m * n * k int8 operations at the
// dense 1,979 T/s (8.889 ms at 8192^3, nu=16), against nu * (m*k + k*n)
// bytes read and 4 * nu * m * n written (1.6 ms at 8192^3). The tensor
// cores reach that rate only through wgmma fed from shared memory, which
// mma.sync with fragments loaded into registers cannot (an mma.sync kernel
// took 51.4-65.8 ms at 8192^3, nu=16, against 13.07 ms here). At
// short K the int32 stores bound it instead (1.28 ms of writes at 8192 x
// 512 x 8192, nu=16, against 0.56 ms of operations).
//
// Design (hopper-kernels guide, section 1):
//  - wgmma.mma_async m64n256k32 s32.s8.s8 from shared-memory descriptors.
//    For 8-bit operands both must be K-major: A row-major (nu, m, k), B
//    stored (nu, n, k) (the main path's plane layout). n-contiguous B is first
//    byte-transposed by transpose_i8_kernel below into a k-contiguous scratch
//    the wrapper allocates.
//  - TMA loads with 3-D tensor maps (k, rows, plane), so that no box straddles
//    two planes, built from the operands' row and plane strides in bytes, so
//    that a K slice of a wider stack (the K-chunked products) is read in place,
//    128-byte boxes in k with the 128-byte swizzle that the
//    descriptors' layout type names; TMA zero-fills the ragged m, n and k
//    edges and always delivers the full box's bytes, so each stage's mbarrier
//    expects a constant transaction count. The maps are encoded on the host
//    with cuTensorMapEncodeTiled through the runtime's driver entry point (no
//    link flag) and passed as __grid_constant__ parameters. TMA needs strides
//    that are multiples of 16 bytes and 16-byte-aligned bases; the wrapper
//    also asks k % 16 == 0.
//  - A 128 x 256 output tile per block, K in 128-byte stages through a ring
//    of 4 (A 16 KB + B 32 KB each, 192 KB), full/empty mbarrier pairs whose
//    parity flips once per pass around the ring.
//  - Warp-specialised: warpgroups 0 and 1 consume (64 x 256 each, 128 int32
//    accumulators a thread, setmaxnreg up to 232), warpgroup 2 produces (one
//    thread issues the TMA loads; setmaxnreg down to 40). Within a stage the
//    descriptors' start address advances 32 bytes per k32 step inside the
//    swizzled 128-byte rows (LBO 16 B, SBO 1024 B: 8 rows of 128 bytes). One
//    wgmma group stays in flight: a stage is released once the next one's
//    products are issued and the previous group has completed.
//  - One block per (plane, row block, column block) tile, in a raster over
//    the block index: "astat" takes every column block of a row block in
//    turn, "kloop" groups 16 row blocks per column sweep, so that the blocks
//    in flight share their A and B tiles in the 50 MB L2. The consumers
//    store the int32 sums with guarded stores at the m and n edges. A
//    persistent grid (one block per SM walking the tiles, the producer
//    running ahead into the next tile during the stores) was measured no
//    faster on the main path's planes (PERF.md), so the tiles are left to
//    the hardware's block scheduler.
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;                       // rows of C per tile
constexpr int BN = 256;                       // columns of C per tile
constexpr int BK = 128;                       // bytes of K per stage
constexpr int kStages = 4;
constexpr int kABytes = BM * BK;              // 16 KB
constexpr int kBBytes = BN * BK;              // 32 KB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kThreads = 384;                 // 2 consumer + 1 producer WG
constexpr int kConsumers = 256;
constexpr int kGroupRows = 16;                // kloop raster: row blocks/group
constexpr int kSmemBytes = kStages * kStageBytes + 1024 + 2 * kStages * 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}\n"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

// one box of a 3-D tensor map (k, rows, plane) into shared memory,
// completing `bytes` of the mbarrier's transaction count
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int k0, int row0,
                                         int plane) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
        ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(k0),
           "r"(row0), "r"(plane), "r"(bar)
        : "memory");
}

// shared-memory matrix descriptor of a K-major tile of 128-byte rows in the
// 128-byte swizzle (TMA's CU_TENSOR_MAP_SWIZZLE_128B): start address >> 4,
// LBO 1 (16 B; unused inside one swizzle row), SBO 64 (1024 B: the next 8
// rows), layout type 1 (128-byte swizzle). The tile is 1024-byte aligned.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16)
           | ((uint64_t)64 << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving accumulator registers across the
// asynchronous products
__device__ __forceinline__ void fence_operands(int (&d)[128]) {
#pragma unroll
    for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// d (64 x 256, s32) += A (64 x 32, s8, K-major) . B (256 x 32, s8, K-major)^T
__device__ __forceinline__ void wgmma_s8(int (&d)[128], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71,"
        "%72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87,"
        "%88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103,"
        "%104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119,"
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
          "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
          "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
          "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
          "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
          "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
          "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
          "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
          "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
          "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
          "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
          "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
          "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
          "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
          "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
          "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
          "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
          "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// tile t of the raster -> (plane, row block, column block)
template <bool ASTAT>
__device__ __forceinline__ void tile_coords(int t, int mt, int nt, int& u,
                                            int& mb, int& nb) {
    const int per_plane = mt * nt;
    u = t / per_plane;
    t -= u * per_plane;
    if (ASTAT) {                   // every column block of a row block in turn
        mb = t / nt;
        nb = t - mb * nt;
    } else {                       // groups of kGroupRows row blocks
        const int group = t / (kGroupRows * nt);
        const int first = group * kGroupRows;
        const int rows = min(mt - first, kGroupRows);
        const int in = t - group * kGroupRows * nt;
        mb = first + in % rows;
        nb = in / rows;
    }
}

template <bool ASTAT>
__global__ void __launch_bounds__(kThreads, 1)
matmul_i8_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                       const __grid_constant__ CUtensorMap map_b,
                       int* __restrict__ C, int nu, int m, int n, int k) {
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
    const uint32_t base = smem_u32(smem);
    const uint32_t full = base + kStages * kStageBytes;   // kStages x 8 B
    const uint32_t empty = full + kStages * 8;
    const int mt = (m + BM - 1) / BM, nt = (n + BN - 1) / BN;
    int u, mb, nb;
    tile_coords<ASTAT>(blockIdx.x, mt, nt, u, mb, nb);
    const int kt_count = (k + BK - 1) / BK;
    const int wg = threadIdx.x / 128;

    if (threadIdx.x == 0) {
        for (int s = 0; s < kStages; ++s) {
            mbar_init(full + 8 * s, 1);
            mbar_init(empty + 8 * s, kConsumers);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (wg == 2) {
        // ---- producer: one thread keeps the ring full ----
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
        if (threadIdx.x == 256) {
            int stage = 0;
            uint32_t phase = 0;
            for (int kt = 0; kt < kt_count; ++kt) {
                mbar_wait(empty + 8 * stage, phase ^ 1);
                const uint32_t bar = full + 8 * stage;
                mbar_expect_tx(bar, kStageBytes);
                const uint32_t sa = base + stage * kStageBytes;
                tma_load(sa, &map_a, bar, kt * BK, mb * BM, u);
                tma_load(sa + kABytes, &map_b, bar, kt * BK, nb * BN, u);
                if (++stage == kStages) {
                    stage = 0;
                    phase ^= 1;
                }
            }
        }
    } else {
        // ---- consumers: warpgroup wg computes rows 64 wg .. 64 wg + 63 ----
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
        const int wt = threadIdx.x % 128;
        const int lane = wt % 32, g = lane / 4, q = lane % 4;
        const bool vec2 = (n & 1) == 0;
        int stage = 0;
        uint32_t phase = 0;
        int acc[128];
#pragma unroll
        for (int i = 0; i < 128; ++i) acc[i] = 0;
        int prev = 0;
        for (int kt = 0; kt < kt_count; ++kt) {
            mbar_wait(full + 8 * stage, phase);
            const uint32_t sa = base + stage * kStageBytes;
            const uint64_t da = smem_desc(sa + wg * 64 * BK);
            const uint64_t db = smem_desc(sa + kABytes);
            fence_operands(acc);
            wgmma_fence();
#pragma unroll
            for (int j = 0; j < BK / 32; ++j)     // +32 bytes per k32
                wgmma_s8(acc, da + 2 * j, db + 2 * j, 1);
            wgmma_commit();
            wgmma_wait<1>();          // the previous stage's group is done
            fence_operands(acc);
            if (kt > 0) mbar_arrive(empty + 8 * prev);
            prev = stage;
            if (++stage == kStages) {
                stage = 0;
                phase ^= 1;
            }
        }
        wgmma_wait<0>();
        fence_operands(acc);
        mbar_arrive(empty + 8 * prev);
        // the fragment of thread (warp w, lane g*4+q): rows 16w+g and
        // 16w+g+8, columns 8j+2q and 8j+2q+1 for j = 0 .. 31
        const int row = mb * BM + wg * 64 + (wt / 32) * 16 + g;
        int* c0 = C + ((size_t)u * m + row) * n;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
            const int col = nb * BN + 8 * j + 2 * q;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                if (row + 8 * h >= m) continue;
                int* p = c0 + (size_t)(8 * h) * n + col;
                const int v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
                if (vec2 && col + 1 < n) {
                    *reinterpret_cast<int2*>(p) = make_int2(v0, v1);
                } else {
                    if (col < n) p[0] = v0;
                    if (col + 1 < n) p[1] = v1;
                }
            }
        }
    }
}

// (nu, k, n) -> (nu, n, k) bytes through a 64 x 64 shared-memory tile: reads
// run along n, writes along k, both coalesced
__global__ void __launch_bounds__(256)
transpose_i8_kernel(const int8_t* __restrict__ src, int8_t* __restrict__ dst,
                    int k, int n) {
    __shared__ int8_t tile[64][68];
    const size_t plane = (size_t)k * n * blockIdx.z;
    const int k0 = blockIdx.y * 64, n0 = blockIdx.x * 64;
    for (int i = threadIdx.x; i < 64 * 64; i += 256) {
        const int r = i / 64, c = i % 64;
        if (k0 + r < k && n0 + c < n)
            tile[r][c] = src[plane + (size_t)(k0 + r) * n + n0 + c];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < 64 * 64; i += 256) {
        const int r = i / 64, c = i % 64;
        if (n0 + r < n && k0 + c < k)
            dst[plane + (size_t)(n0 + r) * k + k0 + c] = tile[c][r];
    }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so that the
// library needs no -lcuda
EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t e = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t e = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// the 3-D map (k, rows, nu) of a (nu, rows, k) int8 stack whose k axis is
// contiguous, with rows `row_pitch` and planes `plane_pitch` bytes apart
// (multiples of 16: a K slice of a wider stack is read in place); boxes of
// 128 bytes of k by box_rows rows of one plane, 128-byte swizzle. TMA
// zero-fills past k, so a slice's box never reads its neighbour's bytes.
bool make_map(CUtensorMap* map, const void* ptr, int nu, int rows, int k,
              long long row_pitch, long long plane_pitch, int box_rows) {
    EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return false;
    const cuuint64_t dims[3] = {(cuuint64_t)k, (cuuint64_t)rows,
                                (cuuint64_t)nu};
    const cuuint64_t strides[2] = {(cuuint64_t)row_pitch,
                                   (cuuint64_t)plane_pitch};
    const cuuint32_t box[3] = {(cuuint32_t)BK, (cuuint32_t)box_rows, 1};
    const cuuint32_t elem[3] = {1, 1, 1};
    return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(ptr),
              dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a TMA stride: a multiple of 16 bytes below 2^40
bool pitch_ok(long long pitch) {
    return pitch >= 16 && pitch % 16 == 0 && pitch < (1LL << 40);
}

template <bool ASTAT>
int launch(const CUtensorMap& ma, const CUtensorMap& mb, int* c, int nu,
           int m, int n, int k, cudaStream_t st) {
    auto kern = matmul_i8_wgmma_kernel<ASTAT>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    const int tiles = nu * ((m + BM - 1) / BM) * ((n + BN - 1) / BN);
    kern<<<tiles, kThreads, kSmemBytes, st>>>(ma, mb, c, nu, m, n, k);
    return (int)cudaGetLastError();
}

}  // namespace

// a: (nu, m, k) int8 with k contiguous, rows a_row and planes a_plane bytes
// apart; b: (nu, n, k) int8 likewise (B's planes k-contiguous); c: (nu, m,
// n) int32, contiguous. astat selects the row-block raster, else the
// grouped one. Needs k % 16 == 0, k > 0, 16-byte-aligned a and b, and
// pitches that are multiples of 16. Returns the CUDA error (0 on success).
extern "C" int g8_matmul_i8_wgmma(const void* a, const void* b, void* c,
                                  int nu, int m, int n, int k,
                                  long long a_row, long long a_plane,
                                  long long b_row, long long b_plane,
                                  int astat, void* stream) {
    if (nu < 1 || m < 1 || n < 1 || k < 16 || k % 16 != 0
        || (uintptr_t)a % 16 != 0 || (uintptr_t)b % 16 != 0
        || !pitch_ok(a_row) || !pitch_ok(a_plane) || !pitch_ok(b_row)
        || !pitch_ok(b_plane)
        || (long long)nu * ((m + BM - 1) / BM) * ((n + BN - 1) / BN)
               > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    CUtensorMap ma, mb;
    if (!make_map(&ma, a, nu, m, k, a_row, a_plane, BM)
        || !make_map(&mb, b, nu, n, k, b_row, b_plane, BN))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    int* cp = static_cast<int*>(c);
    return astat ? launch<true>(ma, mb, cp, nu, m, n, k, st)
                 : launch<false>(ma, mb, cp, nu, m, n, k, st);
}

// src: (nu, k, n) int8 row-major -> dst: (nu, n, k) int8 row-major.
// Returns the CUDA error of the launch (0 on success).
extern "C" int g8_transpose_i8(const void* src, void* dst, int nu, int k,
                               int n, void* stream) {
    if (nu < 1 || nu > 65535 || k < 1 || n < 1 || (k + 63) / 64 > 65535)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((n + 63) / 64, (k + 63) / 64, nu);
    transpose_i8_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(src), static_cast<int8_t*>(dst), k, n);
    return (int)cudaGetLastError();
}
