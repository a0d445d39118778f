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
// short dot with the static limb weights and a reduction by the constant p:
// about 250 32-bit operations at nu=16 for f64 (chip_smoke.encode_bound),
// 0.50 ms at 8192^2 against 0.48 ms for its 8 bytes read and nu written.
// This kernel reduces with `%` by a modulus read from the plan at run time,
// a full integer division, so it issues more than the function needs.
//
// Design: one thread per element, limbs in registers, the static plan (moduli
// and wrap(2^(20*lv) mod p)) passed by value as a kernel parameter, p = 256
// by mask. A block of 32x8 threads runs its 32 threads of a warp along the
// output's contiguous axis, so each warp writes 32 adjacent bytes per plane:
// A's planes are (nu, m, k) row-major, B's planes are stored (nu, n, k) --
// k-contiguous, the layout the int8 tensor-core product reads -- and B's
// strided reads are shared across the block's eight columns through L1.
#include "common.cuh"

namespace {

template <typename T>
struct Components;

template <>
struct Components<float> {
    static constexpr int N = 1;
    __device__ static void split(float x, int s, float* c) {
        c[0] = pow2_scale_f(x, s);
    }
};

template <>
struct Components<double> {
    static constexpr int N = 3;
    __device__ static void split(double x, int s, float* c) {
        double r = pow2_scale_d(x, s);
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            c[j] = (float)r;                       // round to nearest even
            if (j + 1 < 3) r = r - (double)c[j];
        }
    }
};

// AXIS 0: x is (rows=m, cols=k), one shift per row, planes (nu, m, k).
// AXIS 1: x is (rows=k, cols=n), one shift per column, planes stored
//         (nu, n, k).
template <typename T, int AXIS>
__global__ void encode_kernel(const T* __restrict__ x,
                              const int* __restrict__ sft,
                              int8_t* __restrict__ out, EncodePlan plan,
                              int rows, int cols) {
    const int fast = blockIdx.x * 32 + threadIdx.x;
    const int slow = blockIdx.y * 8 + threadIdx.y;
    const int r = AXIS == 0 ? slow : fast;
    const int c = AXIS == 0 ? fast : slow;
    if (r >= rows || c >= cols) return;

    float comp[Components<T>::N];
    Components<T>::split(x[(size_t)r * cols + c], sft[AXIS == 0 ? r : c],
                         comp);

    int lim[G8_MAX_NL];
#pragma unroll
    for (int lv = 0; lv < G8_MAX_NL; ++lv) lim[lv] = 0;
    float G = 0.0f;                  // joint carry of the fractional parts
#pragma unroll
    for (int j = 0; j < Components<T>::N; ++j) {
        const int bits = __float_as_int(comp[j]);
        const int sign = bits < 0 ? -1 : 1;
        const int expf = (bits >> 23) & 0xFF;
        const int frac = bits & 0x7FFFFF;
        const bool is_norm = expf > 0;
        const int mant = is_norm ? (frac | (1 << 23)) : frac;
        const int e = is_norm ? expf - 127 : -126;
        const int d = e - 23;                           // value = s*mant*2^d
        const int sig = min(max(-d, 0), 31);
        const int m_int = mant >> sig;
        const int dpos = min(max(d, 0), plan.max_exp);
        const int mfrac = mant - (m_int << sig);
        float fr = (float)mfrac * pow2f(max(d, -30));
        if (-d > 30) fr = fabsf(comp[j]);               // below 2^-6
        G = G + (float)sign * fr;
        // m_int * 2^dpos across limbs li and li+1 of the 20-bit grid
        const int off = dpos % 20;
        const int li = dpos / 20;
        const int sh = 20 - off;
        const int mhi = m_int >> sh;
        const int mlo = m_int - (mhi << sh);
        const int c_lo = sign * (mlo << off);           // < 2^20
        const int c_hi = sign * mhi;                    // < 2^23
#pragma unroll
        for (int lv = 0; lv < G8_MAX_NL; ++lv) {
            if (lv < plan.nl) {
                if (li == lv) lim[lv] += c_lo;
                if (li == lv - 1) lim[lv] += c_hi;
            }
        }
    }
    lim[0] += (int)floorf(G);
    // balanced carry: every limb but the top into [-2^19, 2^19)
#pragma unroll
    for (int lv = 0; lv < G8_MAX_NL - 1; ++lv) {
        if (lv < plan.nl - 1) {
            const int cr = (lim[lv] + (1 << 19)) >> 20;
            lim[lv] -= cr * (1 << 20);
            lim[lv + 1] += cr;
        }
    }

    const size_t plane = (size_t)rows * cols;
    const size_t pos = AXIS == 0 ? (size_t)r * cols + c : (size_t)c * rows + r;
    for (int i = 0; i < plan.nu; ++i) {
        const int p = plan.p[i];
        int res;
        if (p == 256) {
            // every 2^(20*lv) weight is 0 mod 256: the low byte of limb 0
            res = ((lim[0] + 128) & 255) - 128;
        } else {
            int acc = lim[0];               // |acc| < 6 * 2^19 * 128 < 2^29
#pragma unroll
            for (int lv = 1; lv < G8_MAX_NL; ++lv)
                if (lv < plan.nl) acc += lim[lv] * plan.w[i][lv];
            res = wrap_mod(acc, p);
        }
        out[i * plane + pos] = (int8_t)res;
    }
}

template <typename T, int AXIS>
void launch(const void* x, const void* sft, void* out, const EncodePlan& plan,
            int rows, int cols, cudaStream_t stream) {
    const int fast = AXIS == 0 ? cols : rows;
    const int slow = AXIS == 0 ? rows : cols;
    dim3 block(32, 8);
    dim3 grid((fast + 31) / 32, (slow + 7) / 8);
    encode_kernel<T, AXIS><<<grid, block, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const int*>(sft),
        static_cast<int8_t*>(out), plan, rows, cols);
}

}  // namespace

// x: (rows, cols) contiguous f32 or f64; sft: int32 per row (scale_axis 0)
// or per column (1); out: nu planes as described above. Returns the CUDA
// error of the launch (0 on success).
extern "C" int g8_encode_planes(const void* x, const void* sft, void* out,
                                const void* plan_ptr, int is_f64,
                                int scale_axis, int rows, int cols,
                                void* stream) {
    const EncodePlan& plan = *static_cast<const EncodePlan*>(plan_ptr);
    const int slow = scale_axis == 0 ? rows : cols;
    if (plan.nu < 1 || plan.nu > G8_MAX_NU || plan.nl < 1
        || plan.nl > G8_MAX_NL || (slow + 7) / 8 > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (is_f64) {
        if (scale_axis == 0) launch<double, 0>(x, sft, out, plan, rows, cols, st);
        else launch<double, 1>(x, sft, out, plan, rows, cols, st);
    } else {
        if (scale_axis == 0) launch<float, 0>(x, sft, out, plan, rows, cols, st);
        else launch<float, 1>(x, sft, out, plan, rows, cols, st);
    }
    return (int)cudaGetLastError();
}
