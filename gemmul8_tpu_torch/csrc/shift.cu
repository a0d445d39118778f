// K10, the fast-mode shifts: per row (A, reduce_axis=1) or per column (B,
// reduce_axis=0) of an f32 or f64 operand, the int32 shift of
// quantize.shift_fast, both variants ("reference" and the robust
// "invariant"), and of the two-lane complex form, Re and Im read as one row
// or column of twice the length (complex_gemm._shift_complex_fast).
//
// Replaces no Pallas kernel: the JAX package computes the shifts in jnp
// (gemmul8_tpu/quantize.py, shift_fast). Added because its plain-PyTorch
// version (kernels.shift_fast_plain) is about 100 device operations an
// operand, several full passes over the f64 operand, and ten host
// synchronises behind the copies of its scalar constants: on the DGEMM
// 8192^3 call 6.5 ms of device time and most of the card's idle time.
//
// Semantics: those of kernels.shift_fast_plain, step for step. Per row:
//   amax = max |x|; E0 = ilogb64(amax) where amax > 2^126 (f64 only), else 0;
//   c0 = |f32(x * 2^-E0)| (the multiply skipped where E0 = 0: it is exact);
//   amax0 = max c0; E_loc = ilogb32(amax0 * f32(1 + 2^-22)), E = E_loc + E0;
//   s2 = sum (c0 * 2^-E_loc)^2 in f32; then the log2 terms and the floor in
//   f32 with the same constants; rows with amax0 = 0 (zero rows) give 0.
// Every multiply, conversion and log2 is the one the plain version's torch
// operators run on the card (log2f and log2 are the device functions
// torch.log2 calls; -fmad=false keeps each product rounded). Two steps are
// computed otherwise, both exactly:
//  - amax is a maximum of the |x| bit patterns as unsigned integers: exact
//    for non-negative values, independent of order, and NaN propagates as
//    in torch.amax;
//  - amax0 is computed from amax alone: f32 rounding and multiplies by
//    powers of two are monotone, so max |f32(x * 2^-E0)| = f32(amax *
//    2^-E0).
// The one difference is the order of s2's sum, which is fixed here (below)
// and is torch.sum's own on the card: the shift is floor(...) of a value
// built from s2, so a row within about an ulp of an integer could floor the
// other way (ROADMAP §3). tests/test_torch_shift_kernel.py mirrors the
// kernel's order in numpy and holds it to the plain version.
//
// Bound on the H100: device memory. The work is one max and one sum of
// squares an element; reading each f64 operand of DGEMM 8192^3 once is 537
// MB, 0.16 ms at 3.35 TB/s. The plain version takes 6.5 ms for the pair.
//
// Design (the layer is bytes-bound, so the gain is in moving fewer bytes):
//  - Rows (A, shift_rows_kernel): a block per row, NT threads (32-1024,
//    kernels.shift_row_threads), each thread kVPT 16-byte vectors of the
//    row. Where the row fits in NT * kVPT vectors (8192 f64 of one lane,
//    16384 of two) it stays in registers between the max and the sum, so
//    A is read from device memory once; longer rows are read a second time.
//  - Columns (B (k, n) row-major, shift_cols_max_kernel then
//    shift_cols_sum_kernel): a block owns 32 16-byte vectors of columns (64
//    f64, 128 f32) and a slice of k, eight warps on every eighth row, so
//    each warp reads 512 contiguous bytes of a row. The first launch writes
//    each slice's column maxima to scratch; the second combines them, reads
//    its slice again (in reverse block order, so that it starts on what the
//    first launch left in L2) and writes each slice's partial sums; the
//    last block of a strip to finish (an integer counter) sums the slices
//    in order and writes the shifts. B is read twice.
//  - Deterministic: no float atomics. The sum's order depends on the shape
//    alone: rows: thread t sums its vectors v = t, t + NT, ... in order,
//    each vector's elements in order; then a butterfly over each warp's 32
//    lanes (xor 16, 8, 4, 2, 1) and one over the warps' sums, zero-padded
//    to 32. Columns: each thread sums its rows of the slice in order, the
//    eight warps' sums are added in warp order, then the slices' in slice
//    order. kernels.shift_row_threads and shift_col_slices choose NT and
//    the slices from the shape.
//  - Complex: Re and Im through two pointers; the logical row or column is
//    Re's followed by Im's, as torch.cat([re, im], dim=reduce_axis) lays it
//    out, so no concatenated copy is made.
#include "shift.cuh"

namespace {

constexpr int kVPT = 8;             // 16-byte vectors a thread holds (rows)
constexpr int kRowThreadsMax = 1024;
constexpr int kColWarps = 8;        // warps of a column block
constexpr int kColUnroll = 4;       // rows a warp has in flight

constexpr float kInflate = 0x1.000004p0f;    // f32(1 + 2^-22)
constexpr float kS2Floor = 0x1p-120f;
constexpr float kLog2Nudge = 0x1p-18f;
constexpr float kLog2HalfRU = 0x1.000006p-1f;  // quantize.LOG2_HALF_RU
constexpr float kSftMargin = 0x1p-14f;         // quantize.SFT_MARGIN

// torch.maximum's NaN propagation
__device__ __forceinline__ float nan_max(float a, float b) {
    return (a != a) ? a : (b != b) ? b : fmaxf(a, b);
}

// what a row's (column's) maximum fixes: the pre-scale and the norm scale,
// each as pow2_scale's three factors
template <typename T>
struct RowScale {
    int E0, E_loc;
    float amax0;
    Pow2Split<double> pre;      // 2^-E0 (f64 rows above 2^126)
    Pow2Split<float> norm;      // 2^-E_loc

    __device__ RowScale(int e0, int e_loc, float a0)
        : E0(e0), E_loc(e_loc), amax0(a0), pre(-e0), norm(-e_loc) {}
    __device__ RowScale() : RowScale(0, 0, 0.0f) {}

    // the row's scalars from the bits of max |x|
    __device__ static RowScale from_amax(typename Word<T>::U bits) {
        int e0 = 0;
        float a0;
        if constexpr (sizeof(T) == 8) {
            const double a = __longlong_as_double((long long)bits);
            if (a > 0x1p126) e0 = ilogb64(a);
            a0 = fabsf(__double2float_rn(
                e0 ? Pow2Split<double>(-e0).apply(a) : a));
        } else {
            a0 = __uint_as_float(bits);
        }
        const float safe = a0 > 0.0f ? a0 : 1.0f;
        return RowScale(e0, ilogb32(safe * kInflate), a0);
    }

    // (c0 * 2^-E_loc)^2 of one element
    __device__ float square(T x) const {
        float c0;
        if constexpr (sizeof(T) == 8)
            c0 = fabsf(__double2float_rn(E0 ? pre.apply(x) : x));
        else
            c0 = fabsf(x);
        const float z = norm.apply(c0);
        return z * z;
    }

    // the shift from the sum of squares (shift_fast's last lines)
    __device__ int shift(float s2, float log2p, int invariant) const {
        if (!(amax0 > 0.0f)) return 0;
        const int E = wadd(E_loc, E0);
        const float log2vsum =
            (log2f(nan_max(s2, kS2Floor)) + 2.0f * (float)E) + kLog2Nudge;
        const float log2vnrm = kLog2HalfRU * log2vsum;
        if (invariant)
            return __float2int_rz(
                floorf(((log2p - 1.5f) - log2vnrm) - kSftMargin));
        const float exp1 =
            ((log2p - 1.5f) - nan_max(1.0f, log2vnrm)) - kSftMargin;
        return wadd(__float2int_rz(floorf(exp1)), -E);
    }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v = v + __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// ---------------------------------------------------------------------------
// rows: a block per row
// ---------------------------------------------------------------------------

template <typename T, bool VEC, bool RESIDENT>
__global__ void __launch_bounds__(kRowThreadsMax)
shift_rows_kernel(const T* __restrict__ x0, const T* __restrict__ x1,
                  int* __restrict__ out, int cols, long long ld, int lanes,
                  float log2p, int invariant) {
    using U = typename Word<T>::U;
    constexpr int W = Word<T>::W;
    __shared__ U red_max[32];
    __shared__ float red_sum[32];
    const int nt = blockDim.x, t = threadIdx.x;
    const int lane = t & 31, warp = t >> 5, nw = nt >> 5;
    const long long off = (long long)blockIdx.x * ld;
    const T* p0 = x0 + off;
    const T* p1 = lanes == 2 ? x1 + off : p0;
    const int total = cols * lanes;
    const int nvec = (total + W - 1) / W;
    const int step = nt * kVPT;             // vectors of one chunk

    T e[kVPT][W];
    U m = 0;
    for (int base = 0; base < nvec; base += step) {
#pragma unroll
        for (int i = 0; i < kVPT; ++i)
            load_vec<T, VEC>(p0, p1, cols, total, (base + t + i * nt) * W,
                             e[i]);
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
    if (lane == 0) red_max[warp] = m;
    __syncthreads();
    if (warp == 0) {
        m = warp_max(lane < nw ? red_max[lane] : U(0));
        if (lane == 0) red_max[0] = m;
    }
    __syncthreads();
    const RowScale<T> sc = RowScale<T>::from_amax(red_max[0]);

    float acc = 0.0f;
    for (int base = 0; base < nvec; base += step) {
        if (!RESIDENT) {
#pragma unroll
            for (int i = 0; i < kVPT; ++i)
                load_vec<T, VEC>(p0, p1, cols, total,
                                 (base + t + i * nt) * W, e[i]);
        }
#pragma unroll
        for (int i = 0; i < kVPT; ++i)
#pragma unroll
            for (int s = 0; s < W; ++s) acc = acc + sc.square(e[i][s]);
        if (RESIDENT) break;
    }
    acc = warp_sum(acc);
    if (lane == 0) red_sum[warp] = acc;
    __syncthreads();
    if (warp == 0) {
        acc = warp_sum(lane < nw ? red_sum[lane] : 0.0f);
        if (lane == 0) out[blockIdx.x] = sc.shift(acc, log2p, invariant);
    }
}

// ---------------------------------------------------------------------------
// columns: blocks of (32 vectors of columns) x (a slice of k), two launches
// ---------------------------------------------------------------------------

// the scratch of the column route, in this order: pmax (slices x cols u64,
// each slice's column maxima as bits), ps2 (slices x cols f32, each slice's
// partial sums), count (one u32 a strip of columns). K11's column route
// (extract.cu) runs the first launch alone and reads pmax at the start.
struct ColScratch {
    unsigned long long* pmax;
    float* ps2;
    unsigned* count;
    __host__ __device__ ColScratch(void* s, int cols, int slices)
        : pmax(static_cast<unsigned long long*>(s)),
          ps2(reinterpret_cast<float*>(pmax + (size_t)slices * cols)),
          count(reinterpret_cast<unsigned*>(ps2 + (size_t)slices * cols)) {}
};

// the rows of one thread of a column block: logical row k of the column
// (Re's rows, then Im's) at k0 = slice start + warp, every kColWarps rows
template <typename T, bool VEC>
struct ColWalk {
    const T* x0;
    const T* x1;
    long long ld;
    int rows, total, c, cols;

    __device__ void load(int k, T (&e)[Word<T>::W]) const {
        constexpr int W = Word<T>::W;
        if (k >= total) {
#pragma unroll
            for (int s = 0; s < W; ++s) e[s] = T(0);
            return;
        }
        const T* p = k < rows ? x0 + (long long)k * ld
                              : x1 + (long long)(k - rows) * ld;
        load_vec<T, VEC>(p, p, cols, cols, c, e);
    }
};

template <typename T, bool VEC>
__global__ void __launch_bounds__(32 * kColWarps)
shift_cols_max_kernel(const T* __restrict__ x0, const T* __restrict__ x1,
                      void* scratch, int rows, int cols, long long ld,
                      int lanes, int slice_len) {
    using U = typename Word<T>::U;
    constexpr int W = Word<T>::W, CB = 32 * W;
    __shared__ U red[kColWarps][CB];
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int strip = blockIdx.x, q = blockIdx.y;
    const ColScratch sc(scratch, cols, gridDim.y);
    const int total = rows * lanes;
    const int kb = q * slice_len;
    const int ke = min(total, kb + slice_len);
    const ColWalk<T, VEC> walk{x0, x1, ld, rows, total, strip * CB + lane * W,
                               cols};
    U m[W];
#pragma unroll
    for (int s = 0; s < W; ++s) m[s] = 0;
    for (int k = kb + warp; k < ke; k += kColWarps * kColUnroll) {
        T e[kColUnroll][W];
#pragma unroll
        for (int u = 0; u < kColUnroll; ++u) {
            const int kk = k + u * kColWarps;
            walk.load(kk < ke ? kk : total, e[u]);
        }
#pragma unroll
        for (int u = 0; u < kColUnroll; ++u)
#pragma unroll
            for (int s = 0; s < W; ++s) {
                const U b = Word<T>::abs_bits(e[u][s]);
                m[s] = b > m[s] ? b : m[s];
            }
    }
#pragma unroll
    for (int s = 0; s < W; ++s) red[warp][lane * W + s] = m[s];
    __syncthreads();
    if (t < CB) {
        U r = red[0][t];
#pragma unroll
        for (int w = 1; w < kColWarps; ++w) r = red[w][t] > r ? red[w][t] : r;
        const int c = strip * CB + t;
        if (c < cols) sc.pmax[(size_t)q * cols + c] = r;
    }
    if (q == 0 && t == 0) sc.count[strip] = 0u;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(32 * kColWarps)
shift_cols_sum_kernel(const T* __restrict__ x0, const T* __restrict__ x1,
                      void* scratch, int* __restrict__ out, int rows,
                      int cols, long long ld, int lanes, int slice_len,
                      float log2p, int invariant) {
    constexpr int W = Word<T>::W, CB = 32 * W;
    __shared__ int s_e0[CB], s_eloc[CB];
    __shared__ float s_amax0[CB];
    __shared__ float part[kColWarps][CB];
    __shared__ int last;
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    // reverse order: the first blocks read what the max launch read last
    const int strip = gridDim.x - 1 - blockIdx.x;
    const int q = gridDim.y - 1 - blockIdx.y;
    const int slices = gridDim.y;
    const ColScratch sc(scratch, cols, slices);
    if (t < CB) {
        const int c = strip * CB + t;
        typename Word<T>::U m = 0;
        if (c < cols)
            for (int qq = 0; qq < slices; ++qq) {
                const auto b = (typename Word<T>::U)
                    sc.pmax[(size_t)qq * cols + c];
                m = b > m ? b : m;
            }
        const RowScale<T> r = RowScale<T>::from_amax(m);
        s_e0[t] = r.E0;
        s_eloc[t] = r.E_loc;
        s_amax0[t] = r.amax0;
    }
    __syncthreads();

    const int total = rows * lanes;
    const int kb = q * slice_len;
    const int ke = min(total, kb + slice_len);
    const ColWalk<T, VEC> walk{x0, x1, ld, rows, total, strip * CB + lane * W,
                               cols};
    float acc[W];
    RowScale<T> rs[W];
#pragma unroll
    for (int s = 0; s < W; ++s) {
        const int j = lane * W + s;
        rs[s] = RowScale<T>(s_e0[j], s_eloc[j], s_amax0[j]);
        acc[s] = 0.0f;
    }
    for (int k = kb + warp; k < ke; k += kColWarps * kColUnroll) {
        T e[kColUnroll][W];
#pragma unroll
        for (int u = 0; u < kColUnroll; ++u) {
            const int kk = k + u * kColWarps;
            walk.load(kk < ke ? kk : total, e[u]);
        }
#pragma unroll
        for (int u = 0; u < kColUnroll; ++u)
#pragma unroll
            for (int s = 0; s < W; ++s) acc[s] = acc[s] + rs[s].square(e[u][s]);
    }
#pragma unroll
    for (int s = 0; s < W; ++s) part[warp][lane * W + s] = acc[s];
    __syncthreads();
    const int c = strip * CB + t;
    if (t < CB && c < cols) {
        float p = part[0][t];
#pragma unroll
        for (int w = 1; w < kColWarps; ++w) p = p + part[w][t];
        sc.ps2[(size_t)q * cols + c] = p;
    }
    __threadfence();
    __syncthreads();
    if (t == 0) last = atomicAdd(sc.count + strip, 1u) == (unsigned)slices - 1;
    __syncthreads();
    if (!last || t >= CB || c >= cols) return;
    float s2 = __ldcg(sc.ps2 + c);
    for (int qq = 1; qq < slices; ++qq)
        s2 = s2 + __ldcg(sc.ps2 + (size_t)qq * cols + c);
    out[c] = RowScale<T>(s_e0[t], s_eloc[t], s_amax0[t])
                 .shift(s2, log2p, invariant);
}

bool shape_ok(int rows, int cols, long long ld, int lanes, int vec,
              const void* x0, const void* x1, int width) {
    if (rows < 1 || cols < 1 || ld < 0 || (lanes != 1 && lanes != 2)
        || (lanes == 2 && x1 == nullptr))
        return false;
    if ((long long)rows * lanes > 0x7fffffffLL - 64
        || (long long)cols * lanes > 0x7fffffffLL - 64 * 1024)
        return false;
    if (vec && (cols % width || ld % width || (uintptr_t)x0 % 16
                || (lanes == 2 && (uintptr_t)x1 % 16)))
        return false;
    return true;
}

template <typename T>
int launch_rows(const void* x0, const void* x1, void* out, int rows,
                int cols, long long ld, int lanes, int threads, int vec,
                float log2p, int invariant, cudaStream_t st) {
    const T* a = static_cast<const T*>(x0);
    const T* b = static_cast<const T*>(x1);
    int* o = static_cast<int*>(out);
    const long long nvec = ((long long)cols * lanes + Word<T>::W - 1)
                           / Word<T>::W;
    const bool resident = nvec <= (long long)threads * kVPT;
#define G8_ROWS(V, R) shift_rows_kernel<T, V, R><<<rows, threads, 0, st>>>( \
        a, b, o, cols, ld, lanes, log2p, invariant)
    if (vec && resident) G8_ROWS(true, true);
    else if (vec) G8_ROWS(true, false);
    else if (resident) G8_ROWS(false, true);
    else G8_ROWS(false, false);
#undef G8_ROWS
    return (int)cudaGetLastError();
}

template <typename T>
int launch_cols(bool sum, const void* x0, const void* x1, void* scratch,
                void* out, int rows, int cols, long long ld, int lanes,
                int slice_len, int slices, int vec, float log2p,
                int invariant, cudaStream_t st) {
    const T* a = static_cast<const T*>(x0);
    const T* b = static_cast<const T*>(x1);
    const int cb = 32 * Word<T>::W;
    const dim3 grid((cols + cb - 1) / cb, slices), block(32 * kColWarps);
    int* o = static_cast<int*>(out);
    if (sum && vec)
        shift_cols_sum_kernel<T, true><<<grid, block, 0, st>>>(
            a, b, scratch, o, rows, cols, ld, lanes, slice_len, log2p,
            invariant);
    else if (sum)
        shift_cols_sum_kernel<T, false><<<grid, block, 0, st>>>(
            a, b, scratch, o, rows, cols, ld, lanes, slice_len, log2p,
            invariant);
    else if (vec)
        shift_cols_max_kernel<T, true><<<grid, block, 0, st>>>(
            a, b, scratch, rows, cols, ld, lanes, slice_len);
    else
        shift_cols_max_kernel<T, false><<<grid, block, 0, st>>>(
            a, b, scratch, rows, cols, ld, lanes, slice_len);
    return (int)cudaGetLastError();
}

bool cols_ok(int rows, int lanes, int slice_len, int slices) {
    const long long total = (long long)rows * lanes;
    return slices >= 1 && slices <= 65535 && slice_len >= 1
           && slice_len % kColWarps == 0
           && (long long)slice_len * (slices - 1) < total
           && (long long)slice_len * slices >= total;
}

}  // namespace

// The row route: x0 (and x1, the second lane, for lanes = 2) hold rows x
// cols elements (f64 where is_f64, else f32), row r at r * ld; out (rows,)
// int32 receives each logical row's shift (lane 0's cols elements, then
// lane 1's). threads: the block size, a multiple of 32 up to 1024
// (kernels.shift_row_threads); vec: 16-byte loads (cols and ld multiples of
// the vector's elements, x0 and x1 16-byte aligned). Returns the CUDA error
// of the launch (0 on success).
extern "C" int g8_shift_rows(const void* x0, const void* x1, void* out,
                             int is_f64, int rows, int cols, long long ld,
                             int lanes, int threads, int vec, float log2p,
                             int invariant, void* stream) {
    const int width = is_f64 ? 2 : 4;
    if (!shape_ok(rows, cols, ld, lanes, vec, x0, x1, width) || threads < 32
        || threads > kRowThreadsMax || threads % 32)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return is_f64 ? launch_rows<double>(x0, x1, out, rows, cols, ld, lanes,
                                        threads, vec, log2p, invariant, st)
                  : launch_rows<float>(x0, x1, out, rows, cols, ld, lanes,
                                       threads, vec, log2p, invariant, st);
}

// The column route, first launch: each slice's column maxima of x0 (rows x
// cols, row k at k * ld) and x1 below it (lanes = 2) into scratch (its
// layout: ColScratch; kernels.shift_scratch_bytes). The logical column is
// lanes * rows long, cut into `slices` slices of slice_len rows (a multiple
// of 8, kernels.shift_col_slices).
extern "C" int g8_shift_cols_max(const void* x0, const void* x1,
                                 void* scratch, int is_f64, int rows,
                                 int cols, long long ld, int lanes,
                                 int slice_len, int slices, int vec,
                                 void* stream) {
    const int width = is_f64 ? 2 : 4;
    if (!shape_ok(rows, cols, ld, lanes, vec, x0, x1, width)
        || !cols_ok(rows, lanes, slice_len, slices))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return is_f64 ? launch_cols<double>(false, x0, x1, scratch, nullptr,
                                        rows, cols, ld, lanes, slice_len,
                                        slices, vec, 0.0f, 0, st)
                  : launch_cols<float>(false, x0, x1, scratch, nullptr,
                                       rows, cols, ld, lanes, slice_len,
                                       slices, vec, 0.0f, 0, st);
}

// The column route, second launch, on the same stream after the first:
// the partial sums of squares and, by the last block of each strip, the
// shifts into out (cols,) int32.
extern "C" int g8_shift_cols_sum(const void* x0, const void* x1,
                                 void* scratch, void* out, int is_f64,
                                 int rows, int cols, long long ld, int lanes,
                                 int slice_len, int slices, int vec,
                                 float log2p, int invariant, void* stream) {
    const int width = is_f64 ? 2 : 4;
    if (!shape_ok(rows, cols, ld, lanes, vec, x0, x1, width)
        || !cols_ok(rows, lanes, slice_len, slices))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return is_f64 ? launch_cols<double>(true, x0, x1, scratch, out, rows,
                                        cols, ld, lanes, slice_len, slices,
                                        vec, log2p, invariant, st)
                  : launch_cols<float>(true, x0, x1, scratch, out, rows,
                                       cols, ld, lanes, slice_len, slices,
                                       vec, log2p, invariant, st);
}
