// Tensor-core CRT epilogue: K2's function with the CRT sum over the moduli
// done as a matrix product. Per output element: per modulus an f32 wrap of
// C_hi into [-p/2, p/2); the column sums cols = C8^T . r against the 8-bit
// columns of qPi >> base on the tensor cores; column pairs as 16-bit limbs;
// carry, quotient fold, carry (crt.cuh's fold_quotient); the three-factor
// descale to the (hi, lo) f32 pair (crt.cuh's emit_pair).
//
// Replaces: tools/probe_epilogue.py, fused_epilogue_mxu (its body
// _epilogue_kernel_mxu). Its plain version is
// kernels.fused_epilogue_mxu_plain, which it equals bit for bit. The probe
// splits the descale's 2^-sft in two halves, whose exponents leave f32's
// range past |sft| = 252 and assemble garbage there; the library's K2
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
// 16 x 32 x 8 multiply-adds per 8 elements on the tensor cores, far below
// their rate.
//
// Design: a block of 256 threads owns 256 consecutive elements. Each thread
// wraps its element's nu values (coalesced loads, one plane at a time) and
// writes the s8 residues to shared memory; each warp then runs four
// mma.sync.m16n8k32.u8.s8 (8 elements each, C8^T as the A fragment, built
// once from the plan) and writes the column sums back to shared memory;
// each thread then reads its element's columns and runs the limbs, the fold
// and the descale in registers. Warps share nothing, so __syncwarp orders
// the steps.
#include "crt.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWords = G8_MXU_K / 4;             // s8 residues, 4 per word
constexpr int kColStride = G8_MXU_COLS + 1;      // padded: no bank conflict

__global__ void __launch_bounds__(kThreads)
epilogue_mxu_kernel(const int* __restrict__ chi, const int* __restrict__ sfta,
                    const int* __restrict__ sftb, float* __restrict__ hi_out,
                    float* __restrict__ lo_out, int m, int n,
                    const __grid_constant__ EpiloguePlanMxu plan) {
    __shared__ __align__(16) unsigned res[kThreads][kWords];
    __shared__ int cols[kThreads][kColStride];
    const size_t mn = (size_t)m * n;
    const int tid = threadIdx.x;
    const size_t idx = (size_t)blockIdx.x * kThreads + tid;
    const bool live = idx < mn;

    // 1. per modulus t = hi16 * wrap(2^16 mod p) + lo16 (exact in f32),
    //    r = t - rint(t / p) * p, two balanced corrections
    unsigned w[kWords];
#pragma unroll
    for (int q = 0; q < kWords; ++q) w[q] = 0u;
#pragma unroll
    for (int q = 0; q < G8_MAX_NU; ++q) {
        if (q < plan.crt.nu && live) {
            const int acc = chi[q * mn + idx];
            const int acc_hi = acc >> 16;
            const int acc_lo = acc - acc_hi * 65536;
            const float p = (float)plan.crt.p[q];
            const float t = (float)acc_hi * (float)plan.w2[q] + (float)acc_lo;
            float r = t - rintf(t * plan.inv_p[q]) * p;
            if (2.0f * r >= p) r -= p;
            if (2.0f * r < -p) r += p;
            w[q >> 2] |= ((unsigned)(int)r & 0xffu) << (8 * (q & 3));
        }
    }
    uint4* row = reinterpret_cast<uint4*>(res[tid]);
    row[0] = make_uint4(w[0], w[1], w[2], w[3]);
    row[1] = make_uint4(w[4], w[5], w[6], w[7]);
    __syncwarp();

    // 2. cols (16 columns x 8 elements) = C8^T (16 x 32, u8) . r (32 x 8, s8)
    //    per group of 8 elements; thread (g, t) holds C8^T rows g and g + 8,
    //    moduli 4t..4t+3 and 16+4t..16+4t+3
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const unsigned* c8 = reinterpret_cast<const unsigned*>(&plan.c8[0][0]);
    const unsigned a0 = c8[g * kWords + t], a1 = c8[(g + 8) * kWords + t];
    const unsigned a2 = c8[g * kWords + 4 + t];
    const unsigned a3 = c8[(g + 8) * kWords + 4 + t];
#pragma unroll
    for (int grp = 0; grp < 4; ++grp) {
        const int e0 = warp * 32 + grp * 8;
        const unsigned b0 = res[e0 + g][t], b1 = res[e0 + g][4 + t];
        int d0 = 0, d1 = 0, d2 = 0, d3 = 0;
        asm volatile(
            "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+r"(d0), "+r"(d1), "+r"(d2), "+r"(d3)
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
        cols[e0 + 2 * t][g] = d0;
        cols[e0 + 2 * t + 1][g] = d1;
        cols[e0 + 2 * t][g + 8] = d2;
        cols[e0 + 2 * t + 1][g + 8] = d3;
    }
    __syncwarp();
    if (!live) return;

    // 3. limbs from the column pairs, carry, fold, carry, descale
    int lim[G8_MAX_L];
#pragma unroll
    for (int li = 0; li < G8_MAX_L; ++li) {
        int v = 0;
        if (2 * li < plan.n_cols) v = cols[tid][2 * li];
        if (2 * li + 1 < plan.n_cols) v += cols[tid][2 * li + 1] * 256;
        lim[li] = v;
    }
    fold_quotient(lim, plan.crt);
    const int i = (int)(idx / n);
    const int j = (int)(idx - (size_t)i * n);
    float hi, lo;
    emit_pair(lim, plan.crt, descale_factors(sfta[i]), descale_factors(sftb[j]),
              hi, lo);
    hi_out[idx] = hi;
    lo_out[idx] = lo;
}

}  // namespace

// chi: (nu, m, n) int32 contiguous; sfta: int32 (m); sftb: int32 (n);
// hi, lo: (m, n) f32. Returns the CUDA error of the launch (0 on success).
extern "C" int g8_fused_epilogue_mxu(const void* chi, const void* sfta,
                                     const void* sftb, void* hi, void* lo,
                                     int m, int n, const void* plan_ptr,
                                     void* stream) {
    const EpiloguePlanMxu& plan =
        *static_cast<const EpiloguePlanMxu*>(plan_ptr);
    if (plan.crt.nu < 1 || plan.crt.nu > G8_MAX_NU || plan.crt.L < 1
        || plan.crt.L > G8_MAX_L || plan.n_cols < 1
        || plan.n_cols > G8_MXU_COLS || plan.n_cols > 2 * plan.crt.L)
        return (int)cudaErrorInvalidValue;
    const size_t mn = (size_t)m * n;
    const size_t blocks = (mn + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    epilogue_mxu_kernel<<<(unsigned)blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(chi), static_cast<const int*>(sfta),
        static_cast<const int*>(sftb), static_cast<float*>(hi),
        static_cast<float*>(lo), m, n, plan);
    return (int)cudaGetLastError();
}
