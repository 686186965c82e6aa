// Fused range filter + multi-aggregate scan in float64, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/scan_agg/scan_agg.py:
// _scan_agg_kernel (launched by scan_agg_pallas).  It computes what that
// kernel computes, in the engine's float64:
//
//   ok[r]  = valid[r] && lo[c] <= cols[c, r] <= hi[c] for every column c
//   out[p] = sum over rows with ok of cols[a_p, r] * cols[b_p, r]
//            (b_p == -1: cols[a_p, r] alone), p < P
//   out[P] = number of rows with ok
//
// What bounds it on an H100: bytes.  Every input byte is read once (C
// float64 columns plus the one-byte valid mask: 8C + 1 bytes a row) and
// the arithmetic is a few comparisons and multiply-adds per row, far below
// the card's float64 rate, so the floor is (8C + 1) n bytes over
// 3.35 TB/s.  The design streams each column once with coalesced loads (a
// warp reads 32 consecutive rows of one column) and keeps every running
// sum in registers: nothing but the per-tile partials is written back.
//
// Determinism: the same bits run to run, so the engine's results do not
// depend on the device budget.  There are no floating-point atomics: a CTA
// owns a fixed tile of rows, each thread sums its strided rows in order,
// the CTA reduces with a fixed warp-shuffle tree and a fixed cross-warp
// order, and a second kernel adds the per-tile partials in a fixed order.
// Tiles are small (512 rows, 128 CTAs for a 64Ki-row batch) so a batch
// fills the card's 132 SMs.
//
// Plain C interface (bound with ctypes): scan_agg_launch returns
// cudaGetLastError() after enqueueing both kernels on the given stream.

#include <cuda_runtime.h>
#include <stdint.h>

#define SA_THREADS 256
#define SA_WARPS (SA_THREADS / 32)
#define SA_MAX_COLS 32
#define SA_MAX_PAIRS 16

__device__ __forceinline__ double warp_sum(double v) {
    // fixed tree: lane 0 ends with ((l0+l16)+(l8+l24))+... in a set order
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
    return v;
}

__global__ void __launch_bounds__(SA_THREADS)
scan_agg_tiles(const double* __restrict__ cols, int64_t n, int C,
               const double* __restrict__ lo, const double* __restrict__ hi,
               const uint8_t* __restrict__ valid,
               const int32_t* __restrict__ pairs, int P, int64_t tile,
               double* __restrict__ partials) {
    __shared__ double s_lo[SA_MAX_COLS];
    __shared__ double s_hi[SA_MAX_COLS];
    __shared__ int s_a[SA_MAX_PAIRS];
    __shared__ int s_b[SA_MAX_PAIRS];
    __shared__ double s_red[SA_MAX_PAIRS + 1][SA_WARPS];

    const int tid = threadIdx.x;
    if (tid < C) {
        s_lo[tid] = lo[tid];
        s_hi[tid] = hi[tid];
    }
    if (tid < P) {
        s_a[tid] = pairs[2 * tid];
        s_b[tid] = pairs[2 * tid + 1];
    }
    __syncthreads();

    double acc[SA_MAX_PAIRS];
#pragma unroll
    for (int p = 0; p < SA_MAX_PAIRS; ++p) acc[p] = 0.0;
    double cnt = 0.0;

    const int64_t start = (int64_t)blockIdx.x * tile;
    const int64_t end = (start + tile < n) ? start + tile : n;
    for (int64_t r = start + tid; r < end; r += SA_THREADS) {
        bool ok = valid[r] != 0;
        for (int c = 0; c < C; ++c) {
            const double x = cols[(int64_t)c * n + r];
            ok = ok && (x >= s_lo[c]) && (x <= s_hi[c]);
        }
#pragma unroll
        for (int p = 0; p < SA_MAX_PAIRS; ++p) {
            if (p < P) {
                double v = cols[(int64_t)s_a[p] * n + r];
                if (s_b[p] >= 0) v *= cols[(int64_t)s_b[p] * n + r];
                acc[p] += ok ? v : 0.0;
            }
        }
        cnt += ok ? 1.0 : 0.0;
    }

    const int lane = tid & 31;
    const int warp = tid >> 5;
#pragma unroll
    for (int p = 0; p < SA_MAX_PAIRS; ++p) {
        if (p < P) {
            const double w = warp_sum(acc[p]);
            if (lane == 0) s_red[p][warp] = w;
        }
    }
    {
        const double w = warp_sum(cnt);
        if (lane == 0) s_red[P][warp] = w;
    }
    __syncthreads();
    if (warp == 0) {
        for (int p = 0; p <= P; ++p) {
            double v = lane < SA_WARPS ? s_red[p][lane] : 0.0;
            v = warp_sum(v);
            if (lane == 0) partials[(int64_t)blockIdx.x * (P + 1) + p] = v;
        }
    }
}

// out[k] = sum over tiles t of partials[t, k], one warp per k: lane l adds
// tiles l, l + 32, ... in order, then the fixed shuffle tree adds the lanes
__global__ void scan_agg_merge(const double* __restrict__ partials,
                               int64_t n_tiles, int K,
                               double* __restrict__ out) {
    const int k = blockIdx.x;
    double s = 0.0;
    for (int64_t t = threadIdx.x; t < n_tiles; t += 32)
        s += partials[t * K + k];
    s = warp_sum(s);
    if (threadIdx.x == 0) out[k] = s;
}

extern "C" int scan_agg_max_cols(void) { return SA_MAX_COLS; }
extern "C" int scan_agg_max_pairs(void) { return SA_MAX_PAIRS; }

// cols: (C, n) float64 row-major; lo, hi: (C,) float64 inclusive bounds;
// valid: (n,) bytes, 0 = padding row; pairs: (P, 2) int32;
// partials: (ceil(n / tile), P + 1) float64 scratch; out: (P + 1,) float64.
extern "C" int scan_agg_launch(const double* cols, int64_t n, int C,
                               const double* lo, const double* hi,
                               const uint8_t* valid, const int32_t* pairs,
                               int P, int64_t tile, double* partials,
                               double* out, void* stream) {
    if (C < 1 || C > SA_MAX_COLS || P < 0 || P > SA_MAX_PAIRS || tile < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int64_t n_tiles = (n + tile - 1) / tile;
    if (n_tiles > 0)
        scan_agg_tiles<<<(unsigned)n_tiles, SA_THREADS, 0, s>>>(
            cols, n, C, lo, hi, valid, pairs, P, tile, partials);
    scan_agg_merge<<<P + 1, 32, 0, s>>>(partials, n_tiles, P + 1, out);
    return (int)cudaGetLastError();
}
