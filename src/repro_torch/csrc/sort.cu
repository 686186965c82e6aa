// Bitonic sort of (float64 key, int64 index) pairs, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sort/sort.py: _bitonic_kernel
// (launched by bitonic_sort_call).  That kernel runs the whole network on
// one (1, n) float32 block in VMEM.  Here the keys are float64, because
// the engine's sort keys are (the device assembly's _device_sort_key), and
// n may exceed what one CTA's shared memory holds, so the network is cut
// in three kernels:
//
//   sort_local        sorts each chunk of SORT_CHUNK pairs in shared
//                     memory, alternating direction chunk by chunk;
//   sort_global_stage one compare-exchange stage whose partner distance j
//                     is a chunk or more, in device memory;
//   sort_merge_local  the stages of one merge whose distance is below a
//                     chunk, in shared memory.
//
// The network is the TPU kernel's: the partner of position i at distance j
// is i ^ j, and the run of length k that holds i is ascending when
// (i & k) == 0.  Pairs compare by key, then by index, so the order is
// total and the result is that of a stable ascending sort.  The caller
// pads n to N, a power of two: positions i >= n get the key +inf and the
// index i, so they sort after every real pair.  A NaN key is read as +inf
// (the reference shim's "NaN last").
//
// What bounds it on an H100: the function's floor is bytes (8 N read,
// 16 N written), but the network makes log2(N) (log2(N) + 1) / 2 passes;
// the passes of distance below a chunk stay in shared memory, the others
// cost one launch and a 16 N-byte round trip each.  At the engine's ~10^4
// groups (N = 16,384) that is ten launches, so the launches, not the
// bytes, set its time.
//
// Plain C interface (bound with ctypes): sort_launch returns
// cudaGetLastError() after enqueueing every kernel on the given stream.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#define SORT_CHUNK 2048          // pairs in one CTA's shared memory (32 KiB)
#define SORT_THREADS 1024
#define SORT_STAGE_THREADS 256

// pair a sorts after pair b (indices are distinct, so never equal)
__device__ __forceinline__ bool sort_after(double ka, int64_t ia, double kb,
                                           int64_t ib) {
    return ka > kb || (ka == kb && ia > ib);
}

__device__ __forceinline__ void sort_cswap(double* k, int64_t* ix,
                                           int64_t lo, int64_t hi,
                                           bool ascending) {
    const double ka = k[lo], kb = k[hi];
    const int64_t ia = ix[lo], ib = ix[hi];
    if (sort_after(ka, ia, kb, ib) == ascending) {
        k[lo] = kb;
        k[hi] = ka;
        ix[lo] = ib;
        ix[hi] = ia;
    }
}

// the compare-exchange stages of distance j, j/2, ..., 1 of the runs of
// length k, over the chunk at global offset base held in shared memory
__device__ void sort_chunk_stages(double* sk, int64_t* si, int chunk,
                                  int64_t base, int64_t k, int j_top) {
    for (int j = j_top; j > 0; j >>= 1) {
        for (int p = threadIdx.x; p < chunk / 2; p += blockDim.x) {
            const int lo = 2 * j * (p / j) + (p % j);
            sort_cswap(sk, si, lo, lo + j, ((base + lo) & k) == 0);
        }
        __syncthreads();
    }
}

__global__ void __launch_bounds__(SORT_THREADS)
sort_local(const double* __restrict__ keys, int64_t n, int chunk,
           double* __restrict__ kout, int64_t* __restrict__ iout) {
    __shared__ double sk[SORT_CHUNK];
    __shared__ int64_t si[SORT_CHUNK];
    const int64_t base = (int64_t)blockIdx.x * chunk;
    for (int t = threadIdx.x; t < chunk; t += blockDim.x) {
        const int64_t g = base + t;
        const double key = g < n ? keys[g] : CUDART_INF;
        sk[t] = isnan(key) ? CUDART_INF : key;
        si[t] = g;
    }
    __syncthreads();
    for (int k = 2; k <= chunk; k <<= 1)
        sort_chunk_stages(sk, si, chunk, base, k, k >> 1);
    for (int t = threadIdx.x; t < chunk; t += blockDim.x) {
        kout[base + t] = sk[t];
        iout[base + t] = si[t];
    }
}

__global__ void __launch_bounds__(SORT_THREADS)
sort_merge_local(double* __restrict__ kbuf, int64_t* __restrict__ ibuf,
                 int chunk, int64_t k) {
    __shared__ double sk[SORT_CHUNK];
    __shared__ int64_t si[SORT_CHUNK];
    const int64_t base = (int64_t)blockIdx.x * chunk;
    for (int t = threadIdx.x; t < chunk; t += blockDim.x) {
        sk[t] = kbuf[base + t];
        si[t] = ibuf[base + t];
    }
    __syncthreads();
    sort_chunk_stages(sk, si, chunk, base, k, chunk >> 1);
    for (int t = threadIdx.x; t < chunk; t += blockDim.x) {
        kbuf[base + t] = sk[t];
        ibuf[base + t] = si[t];
    }
}

__global__ void __launch_bounds__(SORT_STAGE_THREADS)
sort_global_stage(double* __restrict__ kbuf, int64_t* __restrict__ ibuf,
                  int64_t N, int64_t k, int64_t j) {
    const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= N / 2) return;
    const int64_t lo = 2 * j * (p / j) + (p % j);
    sort_cswap(kbuf, ibuf, lo, lo + j, (lo & k) == 0);
}

extern "C" int sort_chunk(void) { return SORT_CHUNK; }

// keys: (n,) float64; kbuf: (N,) float64 and ibuf: (N,) int64 outputs,
// N a power of two >= max(n, 2).  On return (in stream order) kbuf[:n]
// holds the keys ascending and ibuf[:n] the stable sort permutation.
extern "C" int sort_launch(const double* keys, int64_t n, int64_t N,
                           double* kbuf, int64_t* ibuf, void* stream) {
    if (n < 1 || N < 2 || N < n || (N & (N - 1)) != 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int chunk = N < SORT_CHUNK ? (int)N : SORT_CHUNK;
    const int threads = chunk / 2 < SORT_THREADS ? chunk / 2 : SORT_THREADS;
    const unsigned blocks = (unsigned)(N / chunk);
    sort_local<<<blocks, threads, 0, s>>>(keys, n, chunk, kbuf, ibuf);
    const unsigned stage_blocks =
        (unsigned)((N / 2 + SORT_STAGE_THREADS - 1) / SORT_STAGE_THREADS);
    for (int64_t k = 2 * (int64_t)chunk; k <= N; k <<= 1) {
        for (int64_t j = k >> 1; j >= chunk; j >>= 1)
            sort_global_stage<<<stage_blocks, SORT_STAGE_THREADS, 0, s>>>(
                kbuf, ibuf, N, k, j);
        sort_merge_local<<<blocks, threads, 0, s>>>(kbuf, ibuf, chunk, k);
    }
    return (int)cudaGetLastError();
}
