// Dense-table join build and probe in float64, for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/radix_join/radix_join.py:
// _radix_build_kernel (launched by radix_build_call) and
// _radix_probe_kernel (launched by radix_probe_call).  Those kernels
// radix-partition the keys on their low bits so that each partition's
// dense table fits VMEM, then build and probe it as one-hot matmuls.  Here
// the whole dense table lives in device memory, so there is no
// partitioning, and both halves compute the unpartitioned function of
// src/repro/kernels/radix_join/ref.py directly:
//
//   build:  out[d, v] = sum over rows r with code[r] == d of vals[v, r]
//   probe:  out[r, v] = btab[code[r], v]  (0 where code[r] is outside)
//
// for d in [0, D).  A build row whose code lies outside [0, D) — the trash
// code the engine gives masked rows — contributes nothing; a probe row
// whose code lies outside gathers zeros, so its presence lane 0 reads 0
// (no match).  With a lane of ones in vals, lane 0 of the build counts
// each code's rows: 1 for a unique build key, more for a duplicate (the
// witness the engine's join tier checks).
//
// Determinism: no floating-point atomics.  The wrapper sorts the batch's
// codes with a stable sort (scode, perm), so equal codes form runs in row
// order.  radix_build_tiles gives each CTA a tile of RB_TILE sorted rows;
// the first thread of each run-segment inside the tile sums the segment's
// rows in order.  A segment strictly inside the tile is a whole run, and
// its thread stores the sum to out[code]: one writer per code.  The first
// and the last segment of a tile may continue a run of a neighbouring
// tile, so their sums go to a scratch array, and radix_build_edges adds
// each such run's segment sums in tile order and stores them.  The bits
// are the same run to run, and a thread walks at most RB_TILE rows or one
// segment sum per tile, however long a run is.
//
// What bounds them on an H100: bytes.  The build reads 4 bytes of code and
// 8V bytes of values a row and writes the (D, V) table, which the wrapper
// zeroes first; at the join probe's 1.5M-group partial (V = 3) the 36 MB
// table is most of the bytes.  The probe reads a code and gathers 8V bytes
// a row and writes them.
//
// Plain C interface (bound with ctypes): each *_launch returns
// cudaGetLastError() after enqueueing its kernels on the given stream.

#include <cuda_runtime.h>
#include <stdint.h>

#define RB_TILE 256        // sorted rows per CTA of the build
#define RP_THREADS 256

__global__ void __launch_bounds__(RB_TILE)
radix_build_tiles(const int32_t* __restrict__ scode,
                  const int64_t* __restrict__ perm,
                  const double* __restrict__ vals, int64_t n, int V, int D,
                  double* __restrict__ out, double* __restrict__ edge) {
    __shared__ int32_t s_code[RB_TILE];
    __shared__ int64_t s_perm[RB_TILE];
    const int64_t start = (int64_t)blockIdx.x * RB_TILE;
    const int64_t left = n - start;
    const int rows = left < RB_TILE ? (int)left : RB_TILE;
    const int i = threadIdx.x;
    if (i < rows) {
        s_code[i] = scode[start + i];
        s_perm[i] = perm[start + i];
    }
    __syncthreads();
    if (i >= rows) return;
    const int32_t c = s_code[i];
    if ((i > 0 && s_code[i - 1] == c) || c < 0 || c >= D) return;
    int e = i + 1;                       // the segment is [i, e)
    while (e < rows && s_code[e] == c) ++e;
    double* dst;
    if (i == 0)
        dst = edge + (int64_t)blockIdx.x * 2 * V;          // first segment
    else if (e == rows)
        dst = edge + ((int64_t)blockIdx.x * 2 + 1) * V;    // last segment
    else
        dst = out + (int64_t)c * V;                        // a whole run
    for (int v = 0; v < V; ++v) {
        const double* col = vals + (int64_t)v * n;
        double s = 0.0;
        for (int r = i; r < e; ++r) s += col[s_perm[r]];
        dst[v] = s;
    }
}

// Sum of the run of code c that starts with the segment whose sum is at
// edge + slot * V (slot of tile t), continuing through the first segments
// of the following tiles while the run does, in tile order; stored to
// out[c].
__device__ void radix_build_store_run(const int32_t* __restrict__ scode,
                                      const double* __restrict__ edge,
                                      int64_t n, int V, int64_t n_tiles,
                                      int64_t t, int64_t slot, int32_t c,
                                      double* __restrict__ out) {
    for (int v = 0; v < V; ++v) {
        double s = edge[slot * V + v];
        for (int64_t u = t;; ++u) {
            const int64_t end = (u + 1) * RB_TILE < n ? (u + 1) * RB_TILE : n;
            if (scode[end - 1] != c || u + 1 >= n_tiles
                    || scode[end] != c)
                break;                   // the run ends inside tile u
            s += edge[(u + 1) * 2 * V + v];
        }
        out[(int64_t)c * V + v] = s;
    }
}

// One thread per tile: store the runs that begin with the tile's first
// segment (when no earlier tile holds the run's head) or with its last.
__global__ void radix_build_edges(const int32_t* __restrict__ scode,
                                  const double* __restrict__ edge, int64_t n,
                                  int V, int D, int64_t n_tiles,
                                  double* __restrict__ out) {
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= n_tiles) return;
    const int64_t start = t * RB_TILE;
    const int64_t end = start + RB_TILE < n ? start + RB_TILE : n;
    const int32_t c0 = scode[start];
    if ((t == 0 || scode[start - 1] != c0) && c0 >= 0 && c0 < D)
        radix_build_store_run(scode, edge, n, V, n_tiles, t, 2 * t, c0,
                              out);
    const int32_t c1 = scode[end - 1];
    if (c1 != c0 && c1 >= 0 && c1 < D)
        radix_build_store_run(scode, edge, n, V, n_tiles, t, 2 * t + 1, c1,
                              out);
}

__global__ void radix_probe_rows(const int32_t* __restrict__ code,
                                 const double* __restrict__ btab, int64_t n,
                                 int V, int D, double* __restrict__ out) {
    const int64_t total = n * V;
    for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
         e < total; e += (int64_t)gridDim.x * blockDim.x) {
        const int64_t row = e / V;
        const int v = (int)(e - row * V);
        const int32_t c = code[row];
        out[e] = (c >= 0 && c < D) ? btab[(int64_t)c * V + v] : 0.0;
    }
}

extern "C" int radix_build_tile(void) { return RB_TILE; }

// scode: (n,) int32 codes sorted ascending by a stable sort; perm: (n,)
// int64, the row each sorted position came from; vals: (V, n) float64
// row-major in the original row order; edge: (2 * ceil(n / RB_TILE), V)
// float64 scratch; out: (D, V) float64, zeroed by the caller.
extern "C" int radix_build_launch(const int32_t* scode, const int64_t* perm,
                                  const double* vals, int64_t n, int V,
                                  int D, double* edge, double* out,
                                  void* stream) {
    if (V < 1 || D < 1 || n < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    cudaStream_t s = (cudaStream_t)stream;
    const int64_t n_tiles = (n + RB_TILE - 1) / RB_TILE;
    radix_build_tiles<<<(unsigned)n_tiles, RB_TILE, 0, s>>>(
        scode, perm, vals, n, V, D, out, edge);
    radix_build_edges<<<(unsigned)((n_tiles + 127) / 128), 128, 0, s>>>(
        scode, edge, n, V, D, n_tiles, out);
    return (int)cudaGetLastError();
}

// code: (n,) int32; btab: (D, V) float64; out: (n, V) float64.
extern "C" int radix_probe_launch(const int32_t* code, const double* btab,
                                  int64_t n, int V, int D, double* out,
                                  void* stream) {
    if (V < 1 || D < 1 || n < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    cudaStream_t s = (cudaStream_t)stream;
    const int64_t total = n * V;
    int64_t blocks = (total + RP_THREADS - 1) / RP_THREADS;
    if (blocks > 65535 * 16) blocks = 65535 * 16;
    radix_probe_rows<<<(unsigned)blocks, RP_THREADS, 0, s>>>(
        code, btab, n, V, D, out);
    return (int)cudaGetLastError();
}
