// Tensor-core CRT epilogue: K2's function with the CRT sum over the moduli
// done as a matrix product. Per output element: per modulus the wrap of
// C_hi into [-p/2, p/2); the column sums cols = r . C8 against the 8-bit
// columns of qPi >> base on the tensor cores; column pairs as 16-bit limbs;
// carry, quotient fold, carry (crt.cuh's fold_quotient); the three-factor
// descale to the (hi, lo) f32 pair (crt.cuh's emit_pair).
//
// Replaces: tools/probe_epilogue.py, fused_epilogue_mxu (its body
// _epilogue_kernel_mxu). Its plain version is
// kernels.fused_epilogue_mxu_plain, which it equals bit for bit. The probe
// wraps in f32 (t = hi16 * wrap(2^16 mod p) + lo16, t - rint(t / p) * p and
// two corrections); that gives the exact wrap for every int32 and INT8
// modulus (tests/test_torch_fp8_mxu_redesign.py checks every reachable t),
// so this kernel takes crt.cuh's exact multiply-high wrap. The probe splits
// the descale's 2^-sft in two halves, whose exponents leave f32's range past
// |sft| = 252 and assemble garbage there; the library's K2
// (gemmul8_tpu/pallas_kernels.py, _descale_factors) replaced that split by
// three factors, and this kernel takes the three factors too, so its pair
// equals K2's f32 route (ff.descale_pair) for every shift.
//
// INT8 only: the residues of moduli <= 256 lie in [-128, 127], the s8
// operand; C8's entries are bytes, the u8 operand; every column sum is below
// 20 * 128 * 255 < 2^24, so the int32 sums equal the probe's f32 product.
//
// Bound on the H100: device memory. Each element reads nu * 4 bytes of C_hi
// and writes 8 (1.442 ms at 8192^2, nu=16, at 3.35 TB/s); the column sum is
// 16 x 32 x 16 multiply-adds per 16 elements on the tensor cores, far below
// their rate.
//
// Design (redesigned from a kernel of 256 consecutive elements a block that
// divided a 64-bit index per element, read the limb count at run time,
// wrapped in f32 and went through shared memory twice):
//  - K2's frame (crt.cuh's tile_grid): 4 warps a block, a warp on one row
//    at a time, each warp a strip of kStrip = 64 columns; no division.
//  - Lane (g, t) of a quad loads columns 4g .. 4g+3 and 32+4g .. 32+4g+3 of
//    the strip from the planes of its moduli q = t + 4u (u < 5): 16-byte
//    loads where kernels._epilogue_vec allows (n a multiple of 4, C_hi
//    16-byte aligned), else one column at a time; all ten issued before the
//    first is used. A quad's lanes read four planes, 128 bytes each.
//  - The wrap is crt.cuh's wrap_mulhi, branch-free for every modulus (256
//    included), with each lane's constants held in registers.
//  - The residues are the mma's s8 A operand as they lie: lane (g, t) holds
//    rows g and g+8 (columns 4g+e and 32+4g+e of mma e) at depths 4t .. 4t+3
//    (moduli t + 4u, u < 4) and 16+4t (modulus 16 + t), the depth order of
//    the plan's c8 (the u8 B operand, built once per thread). Two
//    mma.sync.m16n8k32 per 16 elements give CRT columns 0-7 and 8-15; lane
//    (g, t) gets columns 2t, 2t+1 of each: limbs t and t+4 of its rows.
//  - One pass through shared memory (640 words a warp) hands each lane all
//    limbs of strip columns `lane` and 32 + `lane`: 8-byte stores and loads,
//    element pitch kSlots = 10 words, free of bank conflicts.
//  - The kernel is built for each limb count L (dispatch_l): the limb loops
//    carry no guard. The row's descale triple is built once per row, each
//    column's once per thread; the f32 outputs are coalesced stores.
//  - Registers are capped at 80 on the vector route (kMinBlocks).
// kExactWrap and kHoistDescale switch two choices off; they and the limb
// count are undone one at a time by probes.epilogue_tiles.
#include "crt.cuh"

namespace {

constexpr bool kExactWrap = true;     // wrap_mulhi; else the probe's f32 wrap
constexpr bool kHoistDescale = true;  // triples per row / column; else each

constexpr int kStrip = 64;            // a warp's columns of one row
constexpr int kGroup = 4;             // columns a lane loads, twice a plane
constexpr int kMods = 5;              // moduli a lane wraps: t + 4u, u < 5
constexpr int kSlots = 10;            // an element's staged words (8 limbs)
// blocks an SM must hold on the vector route: at most 80 registers a
// thread, 24 warps an SM (nvcc's own choice, 92, ran 25 % slower at 8192^2
// nu=16; the one-column route, uncapped, would spill under the cap)
constexpr int kMinBlocks = 6;

// the probe's f32 wrap of acc by p (tools/probe_epilogue.py)
__device__ __forceinline__ int wrap_f32(int acc, int p, int w2, float inv_p) {
    const int acc_hi = acc >> 16;
    const int acc_lo = acc - acc_hi * 65536;
    const float pf = (float)p;
    const float t = (float)acc_hi * (float)w2 + (float)acc_lo;
    float r = t - rintf(t * inv_p) * pf;
    if (2.0f * r >= pf) r -= pf;
    if (2.0f * r < -pf) r += pf;
    return (int)r;
}

template <bool VEC, int L>
__global__ void __launch_bounds__(32 * G8_TILE_ROWS, VEC ? kMinBlocks : 1)
epilogue_mxu_kernel(const int* __restrict__ chi, const int* __restrict__ sfta,
                    const int* __restrict__ sftb, float* __restrict__ hi_out,
                    float* __restrict__ lo_out, int m, int n,
                    const __grid_constant__ EpiloguePlanMxu plan) {
    constexpr LimbCount<L> nl{};
    __shared__ __align__(8) int staged[G8_TILE_ROWS][kStrip * kSlots];
    int* st = staged[threadIdx.y];
    const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
    const int c0 = blockIdx.x * kStrip;
    const size_t mn = (size_t)m * n;
    const int nu = plan.crt.nu;

    // lane t's moduli q = t + 4u; past nu the constants of 256, which wrap
    // the zero loaded there to 0
    int pq[kMods], w2[kMods];
    unsigned mg[kMods], off[kMods];
    float ip[kMods];
#pragma unroll
    for (int u = 0; u < kMods; ++u) {
        const int q = t + 4 * u;
        const bool live = q < nu;
        pq[u] = live ? plan.crt.p[q] : 256;
        mg[u] = live ? plan.crt.magic[q] : 1u << 24;
        off[u] = live ? plan.crt.wrap_off[q] : 128u;
        w2[u] = live ? plan.w2[q] : 0;
        ip[u] = live ? plan.inv_p[q] : 1.0f / 256.0f;
    }
    // the B operand: CRT columns g (mma 0) and 8 + g (mma 1), depths 4t ..
    // 4t+3 and 16+4t .. 16+4t+3
    const unsigned* c8 = reinterpret_cast<const unsigned*>(&plan.c8[0][0]);
    unsigned b[2][2];
#pragma unroll
    for (int hc = 0; hc < 2; ++hc) {
        b[hc][0] = c8[(8 * hc + g) * (G8_MXU_K / 4) + t];
        b[hc][1] = c8[(8 * hc + g) * (G8_MXU_K / 4) + 4 + t];
    }
    // the columns this lane loads (c0 + 32h + 4g ..) and emits (c0 + 32h +
    // lane), and the latter's descale triples
    int nv[2], jo[2];
    Pow2x3 fb[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        nv[h] = max(0, min(kGroup, n - (c0 + 32 * h + 4 * g)));
        jo[h] = c0 + 32 * h + lane;
        if (kHoistDescale) fb[h] = descale_factors(jo[h] < n ? sftb[jo[h]] : 0);
    }

    for (int i = blockIdx.y * G8_TILE_ROWS + threadIdx.y; i < m;
         i += gridDim.y * G8_TILE_ROWS) {
        const int* src = chi + (size_t)i * n + c0 + 4 * g;
        int x[kMods][2][kGroup];
#pragma unroll
        for (int u = 0; u < kMods; ++u) {
            const int q = t + 4 * u;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                if (q < nu && nv[h] > 0) {
                    load_cols<kGroup, VEC>(src + q * mn + 32 * h, nv[h],
                                           x[u][h]);
                } else {
#pragma unroll
                    for (int e = 0; e < kGroup; ++e) x[u][h][e] = 0;
                }
            }
        }
        // the A operand: a[h][e] holds element (h, e)'s residues of moduli
        // t + 4u in byte u (u < 4), ah[h][e] that of 16 + t in byte 0
        unsigned a[2][kGroup], ah[2][kGroup];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int e = 0; e < kGroup; ++e) {
                unsigned w[kMods];
#pragma unroll
                for (int u = 0; u < kMods; ++u) {
                    const int r = kExactWrap
                        ? wrap_mulhi(x[u][h][e], pq[u], mg[u], off[u])
                        : wrap_f32(x[u][h][e], pq[u], w2[u], ip[u]);
                    w[u] = (unsigned)r & 0xffu;
                }
                a[h][e] = w[0] | (w[1] << 8) | (w[2] << 16) | (w[3] << 24);
                ah[h][e] = w[4];
            }
        }
        // the column sums: mma e takes rows g <- element (0, e) and g + 8 <-
        // element (1, e); lane (g, t) gets limbs t (mma hc 0) and t + 4 (hc
        // 1) of both, staged as slots 2t and 2t + 1 of each element
#pragma unroll
        for (int e = 0; e < kGroup; ++e) {
            int limb[2][2];
#pragma unroll
            for (int hc = 0; hc < 2; ++hc) {
                int d0 = 0, d1 = 0, d2 = 0, d3 = 0;
                asm volatile(
                    "mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 "
                    "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
                    "{%0, %1, %2, %3};\n"
                    : "+r"(d0), "+r"(d1), "+r"(d2), "+r"(d3)
                    : "r"(a[0][e]), "r"(a[1][e]), "r"(ah[0][e]),
                      "r"(ah[1][e]), "r"(b[hc][0]), "r"(b[hc][1]));
                limb[hc][0] = d0 + d1 * 256;
                limb[hc][1] = d2 + d3 * 256;
            }
#pragma unroll
            for (int h = 0; h < 2; ++h)
                *reinterpret_cast<int2*>(
                    st + (32 * h + 4 * g + e) * kSlots + 2 * t) =
                    make_int2(limb[0][h], limb[1][h]);
        }
        __syncwarp();
        // each lane's elements: strip columns lane and 32 + lane
        Pow2x3 fa;
        if (kHoistDescale) fa = descale_factors(sfta[i]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            int lim[G8_MAX_L];
            limbs_zero(lim);
            const int* sl = st + (32 * h + lane) * kSlots;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                if (k < L) {
                    const int2 v = *reinterpret_cast<const int2*>(sl + 2 * k);
                    lim[k] = v.x;
                    if (k + 4 < L) lim[k + 4] = v.y;
                }
            }
            fold_quotient(lim, plan.crt, nl);
            if (!kHoistDescale) {
                fa = descale_factors(sfta[i]);
                fb[h] = descale_factors(jo[h] < n ? sftb[jo[h]] : 0);
            }
            float hi, lo;
            emit_pair(lim, plan.crt, fa, fb[h], hi, lo, nl);
            if (jo[h] < n) {
                hi_out[(size_t)i * n + jo[h]] = hi;
                lo_out[(size_t)i * n + jo[h]] = lo;
            }
        }
        __syncwarp();
    }
}

}  // namespace

// chi: (nu, m, n) int32 contiguous; sfta: int32 (m); sftb: int32 (n);
// hi, lo: (m, n) f32. vec: n is a multiple of 4 and chi 16-byte aligned
// (kernels._epilogue_vec). Returns the CUDA error of the launch (0 on
// success).
extern "C" int g8_fused_epilogue_mxu(const void* chi, const void* sfta,
                                     const void* sftb, void* hi, void* lo,
                                     int m, int n, int vec,
                                     const void* plan_ptr, void* stream) {
    const EpiloguePlanMxu& plan =
        *static_cast<const EpiloguePlanMxu*>(plan_ptr);
    if (plan.crt.nu < 1 || plan.crt.nu > G8_MAX_NU || plan.n_cols < 1
        || plan.n_cols > G8_MXU_COLS || plan.n_cols > 2 * plan.crt.L
        || m < 1 || n < 1 || n > 0x7fffffff - kStrip
        || (vec && (n % kGroup || (uintptr_t)chi % 16)))
        return (int)cudaErrorInvalidValue;
    dim3 grid, block;
    tile_grid(m, n, kStrip / 32, grid, block);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* c = static_cast<const int*>(chi);
    const int* a = static_cast<const int*>(sfta);
    const int* b = static_cast<const int*>(sftb);
    float* h = static_cast<float*>(hi);
    float* l = static_cast<float*>(lo);
    const int err = dispatch_l(plan.crt.L, [&](auto nl) {
        constexpr int L = decltype(nl)::value;
        if (vec)
            epilogue_mxu_kernel<true, L><<<grid, block, 0, st>>>(
                c, a, b, h, l, m, n, plan);
        else
            epilogue_mxu_kernel<false, L><<<grid, block, 0, st>>>(
                c, a, b, h, l, m, n, plan);
        return 0;
    });
    return err ? err : (int)cudaGetLastError();
}
