// K11, accurate mode's upper-bound extraction: per row (A, scale_axis=0) or
// per column (B (k, n), scale_axis=1) of an f32 or f64 operand, the bound
// plane and the int32 pre-shift of quantize.extract_ub_plane, for both
// backends: INT8's int8 plane and FP8's bf16 one.
//
// Replaces no Pallas kernel: the JAX package extracts the bounds in jnp
// (gemmul8_tpu/quantize.py, extract_ub_plane). Added because its
// plain-PyTorch version (kernels.extract_ub_plain) is about 50 device
// operations a side, each a full pass over the operand, and a blocking
// copy of ilogb's constant a side: 9 ms of the accurate DGEMM 8192^3 call.
//
// Semantics: those of kernels.extract_ub_plain, step for step. Per row:
//   amax = max |x|, as K10 takes it: a maximum of the |x| bit patterns as
//     unsigned integers (shift.cuh), exact and independent of order; NaN
//     propagates as in torch.amax;
//   E = ilogb(amax), amax = 1 where it is not > 0 (zero rows, NaN):
//     f32 input: the exponent field less 127;
//     f64 input: amax rounded to f32 (RNE: an amax just under a power of
//     two takes the next exponent) and its field where that f32 is normal
//     and finite, else floor(log2(max(amax, DBL_MIN)) + 2^-32) with the
//     device log2 that torch.log2 calls, converted as torch converts on the
//     card (round toward zero, saturating);
//   sft_pre = MAX_UFP[backend] - E in wrapping int32 (a kernel argument);
// then per element, with s = sft_pre of its row:
//   y = |x| * 2^s as pow2_scale's three power-of-two multiplies;
//   ub = ceil(f32(y)), plus 1 where the f64 tail y - f64(f32(y)), rounded
//     to f32, is positive (f64 input only);
//   ub = max(ub, 1) where |x| > 0 (NaN stays NaN, as torch.clamp keeps
//     it), else 0 (zeros and NaN elements);
//   INT8: the int8 conversion of ub (ub <= 65 for finite rows);
//   FP8: bf16(ub) by RNE (cvt.rn.bf16.f32, torch's conversion on sm_90),
//     its bits plus one where that value is below ub (values >= 0, so one
//     more is the next bf16 up).
// Built with -fmad=false, as every source is: each product stays rounded.
// tests/test_torch_extract_kernel.py mirrors these steps in numpy and holds
// them to the plain version; chip_smoke.py phase 3 holds the kernel to the
// plain version on the card, bit for bit.
//
// Bound on the H100: device memory. Reading each f64 operand of DGEMM
// 8192^3 once is 537 MB, 0.16 ms at 3.35 TB/s; the planes add 67 MB each.
// The plain version takes 9 ms for the pair.
//
// Design, on K10's frames (the layer is bytes-bound):
//  - Rows (A, extract_rows_kernel): a block per row, as K10's
//    shift_rows_kernel: NT threads (kernels.shift_row_threads), each kVPT
//    16-byte vectors of the row, held in registers between the maximum and
//    the plane where the row fits (8192 f64), so that A is read once. The
//    plane is row-major (m, k), already k-contiguous for the estimation
//    product and for syrk's transposed view; the pre-shift is written by
//    thread 0.
//  - Columns (B (k, n) row-major): two launches, as K10's column route.
//    The first is K10's own (g8_shift_cols_max): each k-slice's column
//    maxima into its scratch, which begins with them (shift.cu,
//    ColScratch). In the second (extract_cols_kernel) every block of a
//    strip of 32 vectors of columns combines its strip's slice maxima (a
//    maximum of non-negative bit patterns: exact, in any order), and the
//    slice's first block writes the pre-shifts. The block then reads its
//    slice again, in reverse block order so that it starts on what the
//    first launch left in L2, 128 rows a pass: each warp takes four rows
//    at a time, each lane a 16-byte vector of columns of each, and packs
//    the four bounds of each of its columns into one word of a shared
//    tile; the tile is then written k-contiguous, a warp on 32 words of
//    one column. B's plane is so stored (n, k), the layout the estimation
//    product reads (the wrapper returns its (k, n) view): no transposing
//    copy follows. B is read twice.
#include <cuda_bf16.h>

#include "shift.cuh"

namespace {

constexpr int kVPT = 8;             // 16-byte vectors a thread holds (rows)
constexpr int kRowThreadsMax = 1024;
constexpr int kColWarps = 8;        // warps of a column block
constexpr int kQuads = 32;          // groups of 4 rows a column pass takes

// INT8: the int8 bound, as its bits
struct Int8Bound {
    using Out = unsigned char;
    __device__ static Out emit(float ub) {
        return (unsigned char)(signed char)ub;
    }
};

// FP8: the bf16 bound, as its bits, rounded up past bf16's integer grid
struct Fp8Bound {
    using Out = unsigned short;
    __device__ static Out emit(float ub) {
        const __nv_bfloat16 b = __float2bfloat16(ub);
        const unsigned short bits = __bfloat16_as_ushort(b);
        return __bfloat162float(b) < ub ? (unsigned short)(bits + 1u) : bits;
    }
};

// an unsigned integer of N bytes: N / sizeof(Out) bounds stored at once
template <int N> struct UInt;
template <> struct UInt<2> { using T = unsigned short; };
template <> struct UInt<4> { using T = unsigned int; };
template <> struct UInt<8> { using T = unsigned long long; };

template <typename Out, int N>
__device__ __forceinline__ typename UInt<N * sizeof(Out)>::T pack(
        const Out (&v)[N]) {
    using P = typename UInt<N * sizeof(Out)>::T;
    P w = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) w |= (P)v[i] << (8 * sizeof(Out) * i);
    return w;
}

template <typename Out, typename P>
__device__ __forceinline__ Out unpack(P w, int i) {
    return (Out)(w >> (8 * sizeof(Out) * i));
}

// sft_pre = MAX_UFP - ilogb(amax) from the bits of max |x|
template <typename T>
__device__ __forceinline__ int pre_shift(typename Word<T>::U bits,
                                         int max_ufp) {
    int e;
    if constexpr (sizeof(T) == 8) {
        const double a = __longlong_as_double((long long)bits);
        e = ilogb64(a > 0.0 ? a : 1.0);
    } else {
        const float a = __uint_as_float(bits);
        e = ilogb32(a > 0.0f ? a : 1.0f);
    }
    return (int)((unsigned)max_ufp - (unsigned)e);
}

// the f32 bound of one element, scaled by y = ((|x| f1) f2) f3
template <typename T>
__device__ __forceinline__ float bound(T x, T f1, T f2, T f3) {
    const T ax = fabs(x);
    const T y = ((ax * f1) * f2) * f3;
    float ub;
    if constexpr (sizeof(T) == 8) {
        const float c1 = __double2float_rn(y);
        ub = ceilf(c1)
             + (__double2float_rn(y - (double)c1) > 0.0f ? 1.0f : 0.0f);
    } else {
        ub = ceilf(y);
    }
    if (!(ax > T(0))) return 0.0f;
    return ub != ub ? ub : fmaxf(ub, 1.0f);
}

// ---------------------------------------------------------------------------
// rows: a block per row
// ---------------------------------------------------------------------------

template <typename T, typename Emit, bool VEC, bool RESIDENT>
__global__ void __launch_bounds__(kRowThreadsMax)
extract_rows_kernel(const T* __restrict__ x,
                    typename Emit::Out* __restrict__ plane,
                    int* __restrict__ pre, int cols, long long ld,
                    int max_ufp) {
    using U = typename Word<T>::U;
    using Out = typename Emit::Out;
    constexpr int W = Word<T>::W;
    __shared__ U red[32];
    const int nt = blockDim.x, t = threadIdx.x;
    const int lane = t & 31, warp = t >> 5, nw = nt >> 5;
    const T* p = x + (long long)blockIdx.x * ld;
    Out* o = plane + (long long)blockIdx.x * cols;
    const int nvec = (cols + W - 1) / W;
    const int step = nt * kVPT;             // vectors of one chunk

    T e[kVPT][W];
    U m = 0;
    for (int base = 0; base < nvec; base += step) {
#pragma unroll
        for (int i = 0; i < kVPT; ++i)
            load_vec<T, VEC>(p, p, cols, cols, (base + t + i * nt) * W, e[i]);
#pragma unroll
        for (int i = 0; i < kVPT; ++i)
#pragma unroll
            for (int s = 0; s < W; ++s) {
                const U b = Word<T>::abs_bits(e[i][s]);
                m = b > m ? b : m;
            }
        if (RESIDENT) break;
    }
    m = warp_max(m);
    if (lane == 0) red[warp] = m;
    __syncthreads();
    if (warp == 0) {
        m = warp_max(lane < nw ? red[lane] : U(0));
        if (lane == 0) red[0] = m;
    }
    __syncthreads();
    const int sft = pre_shift<T>(red[0], max_ufp);
    if (t == 0) pre[blockIdx.x] = sft;
    const Pow2Split<T> sc(sft);

    for (int base = 0; base < nvec; base += step) {
        if (!RESIDENT) {
#pragma unroll
            for (int i = 0; i < kVPT; ++i)
                load_vec<T, VEC>(p, p, cols, cols, (base + t + i * nt) * W,
                                 e[i]);
        }
#pragma unroll
        for (int i = 0; i < kVPT; ++i) {
            const int j0 = (base + t + i * nt) * W;
            if (j0 >= cols) continue;
            Out v[W];
#pragma unroll
            for (int s = 0; s < W; ++s)
                v[s] = Emit::emit(bound(e[i][s], sc.f1, sc.f2, sc.f3));
            if (VEC) {      // cols % W == 0: W bounds in one aligned store
                *reinterpret_cast<typename UInt<W * sizeof(Out)>::T*>(
                    o + j0) = pack(v);
            } else {
#pragma unroll
                for (int s = 0; s < W; ++s)
                    if (j0 + s < cols) o[j0 + s] = v[s];
            }
        }
        if (RESIDENT) break;
    }
}

// ---------------------------------------------------------------------------
// columns: after K10's column maxima, blocks of (32 vectors of columns) x
// (a slice of k)
// ---------------------------------------------------------------------------

template <typename T, typename Emit, bool VEC>
__global__ void __launch_bounds__(32 * kColWarps)
extract_cols_kernel(const T* __restrict__ x,
                    const unsigned long long* __restrict__ pmax,
                    typename Emit::Out* __restrict__ plane,
                    int* __restrict__ pre, int rows, int cols, long long ld,
                    int slice_len, int max_ufp, int store_quads) {
    using U = typename Word<T>::U;
    using Out = typename Emit::Out;
    using Quad = typename UInt<4 * sizeof(Out)>::T;   // 4 rows of a column
    constexpr int W = Word<T>::W, CB = 32 * W;
    __shared__ int s_pre[CB];
    __shared__ Quad tile[CB][kQuads + 1];
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    // reverse order: the first blocks read what the max launch read last
    const int strip = gridDim.x - 1 - blockIdx.x;
    const int q = gridDim.y - 1 - blockIdx.y;
    if (t < CB) {
        const int c = strip * CB + t;
        U m = 0;
        if (c < cols)
            for (int qq = 0; qq < (int)gridDim.y; ++qq) {
                const U b = (U)pmax[(size_t)qq * cols + c];
                m = b > m ? b : m;
            }
        const int sft = pre_shift<T>(m, max_ufp);
        s_pre[t] = sft;
        if (q == 0 && c < cols) pre[c] = sft;
    }
    __syncthreads();
    T f1[W], f2[W], f3[W];
#pragma unroll
    for (int s = 0; s < W; ++s) {
        const Pow2Split<T> sc(s_pre[lane * W + s]);
        f1[s] = sc.f1; f2[s] = sc.f2; f3[s] = sc.f3;
    }

    const int kb = q * slice_len;
    const int ke = min(rows, kb + slice_len);
    const int c0 = strip * CB + lane * W;
    for (int k0 = kb; k0 < ke; k0 += 4 * kQuads) {
#pragma unroll
        for (int u = 0; u < kQuads / kColWarps; ++u) {
            const int kw = warp + kColWarps * u;
            T e[4][W];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int k = k0 + 4 * kw + r;
                if (k < ke) {
                    const T* row = x + (long long)k * ld;
                    load_vec<T, VEC>(row, row, cols, cols, c0, e[r]);
                } else {
#pragma unroll
                    for (int s = 0; s < W; ++s) e[r][s] = T(0);
                }
            }
#pragma unroll
            for (int s = 0; s < W; ++s) {
                Out v[4];
#pragma unroll
                for (int r = 0; r < 4; ++r)
                    v[r] = Emit::emit(bound(e[r][s], f1[s], f2[s], f3[s]));
                tile[lane * W + s][kw] = pack(v);
            }
        }
        __syncthreads();
        // warp w on columns w, w + 8, ...: lane l on rows 4l .. 4l+3
#pragma unroll 4
        for (int cl = warp; cl < CB; cl += kColWarps) {
            const int c = strip * CB + cl, k = k0 + 4 * lane;
            if (c >= cols || k >= ke) continue;
            Out* dst = plane + (size_t)c * rows + k;
            const Quad w = tile[cl][lane];
            if (store_quads) {      // rows % 4 == 0: whole aligned quads
                *reinterpret_cast<Quad*>(dst) = w;
            } else {
#pragma unroll
                for (int r = 0; r < 4; ++r)
                    if (k + r < ke) dst[r] = unpack<Out>(w, r);
            }
        }
        __syncthreads();
    }
}

bool shape_ok(int rows, int cols, long long ld, int vec, const void* x,
              int width) {
    if (rows < 1 || cols < 1 || (rows > 1 && ld < cols)
        || (long long)cols > 0x7fffffffLL - 64 * 1024
        || (long long)rows > 0x7fffffffLL - 4 * kQuads)
        return false;
    return !vec || (cols % width == 0 && ld % width == 0
                    && (uintptr_t)x % 16 == 0);
}

template <typename T, typename Emit>
int launch_rows(const void* x, void* plane, void* pre, int rows, int cols,
                long long ld, int threads, int vec, int max_ufp,
                cudaStream_t st) {
    const T* xp = static_cast<const T*>(x);
    auto* o = static_cast<typename Emit::Out*>(plane);
    int* s = static_cast<int*>(pre);
    const long long nvec = ((long long)cols + Word<T>::W - 1) / Word<T>::W;
    const bool resident = nvec <= (long long)threads * kVPT;
#define G8_ROWS(V, R) extract_rows_kernel<T, Emit, V, R>          \
        <<<rows, threads, 0, st>>>(xp, o, s, cols, ld, max_ufp)
    if (vec && resident) G8_ROWS(true, true);
    else if (vec) G8_ROWS(true, false);
    else if (resident) G8_ROWS(false, true);
    else G8_ROWS(false, false);
#undef G8_ROWS
    return (int)cudaGetLastError();
}

template <typename T, typename Emit>
int launch_cols(const void* x, const void* scratch, void* plane, void* pre,
                int rows, int cols, long long ld, int slice_len, int slices,
                int vec, int max_ufp, cudaStream_t st) {
    const T* xp = static_cast<const T*>(x);
    const auto* pm = static_cast<const unsigned long long*>(scratch);
    auto* o = static_cast<typename Emit::Out*>(plane);
    int* s = static_cast<int*>(pre);
    constexpr int cb = 32 * Word<T>::W;
    const int quads = rows % 4 == 0
                      && (uintptr_t)plane % (4 * sizeof(*o)) == 0;
    const dim3 grid((cols + cb - 1) / cb, slices), block(32 * kColWarps);
    if (vec)
        extract_cols_kernel<T, Emit, true><<<grid, block, 0, st>>>(
            xp, pm, o, s, rows, cols, ld, slice_len, max_ufp, quads);
    else
        extract_cols_kernel<T, Emit, false><<<grid, block, 0, st>>>(
            xp, pm, o, s, rows, cols, ld, slice_len, max_ufp, quads);
    return (int)cudaGetLastError();
}

// f(T(), Emit()) for the input's dtype and the backend's bound
template <typename F>
int dispatch(int is_f64, int fp8, F&& f) {
    if (is_f64)
        return fp8 ? f(double(), Fp8Bound()) : f(double(), Int8Bound());
    return fp8 ? f(float(), Fp8Bound()) : f(float(), Int8Bound());
}

}  // namespace

// The row route: x (rows x cols, f64 where is_f64 else f32, row r at r *
// ld); plane (rows x cols, row-major) receives each row's bounds, int8 or,
// where fp8, bf16; pre (rows,) int32 each row's pre-shift. threads: the
// block size, a multiple of 32 up to 1024 (kernels.shift_row_threads);
// vec: 16-byte loads and whole stores (cols and ld multiples of the
// vector's elements, x and plane 16-byte aligned). Returns the CUDA error of the launch (0 on success).
extern "C" int g8_extract_rows(const void* x, void* plane, void* pre,
                               int is_f64, int fp8, int rows, int cols,
                               long long ld, int threads, int vec,
                               int max_ufp, void* stream) {
    if (!shape_ok(rows, cols, ld, vec, x, is_f64 ? 2 : 4) || threads < 32
        || threads > kRowThreadsMax || threads % 32
        || (vec && (uintptr_t)plane % 16))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return dispatch(is_f64, fp8, [&](auto tag, auto emit) {
        return launch_rows<decltype(tag), decltype(emit)>(
            x, plane, pre, rows, cols, ld, threads, vec, max_ufp, st);
    });
}

// The column route's second launch, on the same stream after K10's
// g8_shift_cols_max (lanes = 1) on the same x, slice_len and slices wrote
// its scratch: plane (cols x rows storage, each column's bounds
// contiguous) and pre (cols,) int32.
extern "C" int g8_extract_cols(const void* x, const void* scratch,
                               void* plane, void* pre, int is_f64, int fp8,
                               int rows, int cols, long long ld,
                               int slice_len, int slices, int vec,
                               int max_ufp, void* stream) {
    if (!shape_ok(rows, cols, ld, vec, x, is_f64 ? 2 : 4) || slices < 1
        || slices > 65535 || slice_len < 1 || slice_len % kColWarps
        || (long long)slice_len * (slices - 1) >= rows
        || (long long)slice_len * slices < rows)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return dispatch(is_f64, fp8, [&](auto tag, auto emit) {
        return launch_cols<decltype(tag), decltype(emit)>(
            x, scratch, plane, pre, rows, cols, ld, slice_len, slices, vec,
            max_ufp, st);
    });
}
