// Dense-domain grouped sum in float64, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/hash_group/hash_group.py:
// _hash_group_kernel (launched by hash_group_call).  That kernel turns a
// grouped sum into a one-hot matmul on the TPU's matrix unit; this one
// computes the same function directly, in the engine's float64:
//
//   out[g, v] = sum over rows r with gid[r] == g of vals[v, r]
//
// for g < G.  Rows whose gid lies outside [0, G) — the engine sends masked
// rows to the trash group G — contribute nothing.  A column of ones in
// vals gives the group counts, exactly as in the TPU kernel.
//
// What bounds it on an H100: bytes for the engine's group counts.  The
// inputs are read once (4 bytes of gid and 8V bytes of values a row), so
// the floor is (8V + 4) n bytes over 3.35 TB/s.  The design: one CTA per
// tile of rows stages the tile's gids in shared memory; thread (v, g)
// walks the tile's rows in order and adds vals[v, r] where gid[r] == g.
// Threads of a warp share v, so each value load is one broadcast address.
// The work is G * V * tile comparisons a tile, so it is cheap for the
// TPC-H Q1 domain (12 groups) and slow near the 4096-group cap; a
// counting sort of the tile by gid is the next step when large domains
// matter.
//
// Determinism: no floating-point atomics.  Each (tile, g, v) partial is a
// sum over rows in row order, and a second kernel adds the partials of
// the tiles in tile order, so the bits are the same run to run and the
// engine's results do not depend on the device budget.
//
// Plain C interface (bound with ctypes): hash_group_launch returns
// cudaGetLastError() after enqueueing both kernels on the given stream.

#include <cuda_runtime.h>
#include <stdint.h>

#define HG_THREADS 256
#define HG_MAX_TILE 8192   // 32 KiB of gids in shared memory

__global__ void __launch_bounds__(HG_THREADS)
hash_group_tiles(const int32_t* __restrict__ gid,
                 const double* __restrict__ vals, int64_t n, int V, int G,
                 int tile, double* __restrict__ partials) {
    __shared__ int32_t s_gid[HG_MAX_TILE];
    const int64_t start = (int64_t)blockIdx.x * tile;
    const int64_t left = n - start;
    const int rows = left < (int64_t)tile ? (int)left : tile;
    for (int i = threadIdx.x; i < rows; i += HG_THREADS)
        s_gid[i] = gid[start + i];
    __syncthreads();

    double* out = partials + (int64_t)blockIdx.x * G * V;
    const int gv = G * V;
    for (int idx = threadIdx.x; idx < gv; idx += HG_THREADS) {
        const int v = idx / G;
        const int g = idx - v * G;
        const double* col = vals + (int64_t)v * n + start;
        double s = 0.0;
        for (int r = 0; r < rows; ++r)
            s += (s_gid[r] == g) ? col[r] : 0.0;
        out[(int64_t)g * V + v] = s;
    }
}

// out[e] = sum over tiles t (in order) of partials[t, e], e < G * V
__global__ void hash_group_merge(const double* __restrict__ partials,
                                 int64_t n_tiles, int64_t gv,
                                 double* __restrict__ out) {
    const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= gv) return;
    double s = 0.0;
    for (int64_t t = 0; t < n_tiles; ++t) s += partials[t * gv + e];
    out[e] = s;
}

extern "C" int hash_group_max_tile(void) { return HG_MAX_TILE; }

// gid: (n,) int32; vals: (V, n) float64 row-major; partials:
// (ceil(n / tile), G, V) float64 scratch; out: (G, V) float64.
extern "C" int hash_group_launch(const int32_t* gid, const double* vals,
                                 int64_t n, int V, int G, int tile,
                                 double* partials, double* out,
                                 void* stream) {
    if (V < 1 || G < 1 || tile < 1 || tile > HG_MAX_TILE)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int64_t n_tiles = (n + tile - 1) / tile;
    const int64_t gv = (int64_t)G * V;
    if (n_tiles > 0)
        hash_group_tiles<<<(unsigned)n_tiles, HG_THREADS, 0, s>>>(
            gid, vals, n, V, G, tile, partials);
    const unsigned blocks = (unsigned)((gv + 255) / 256);
    hash_group_merge<<<blocks, 256, 0, s>>>(partials, n_tiles, gv, out);
    return (int)cudaGetLastError();
}
