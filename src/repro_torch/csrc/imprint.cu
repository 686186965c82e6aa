// Imprint (zone map) construction in float64, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/imprint/imprint.py:
// _zone_kernel (launched by zone_maps_pallas).  That kernel works on a
// float32 copy of the column, with +-3.4e38 sentinels for empty blocks,
// and its shim widens the bounds by one ulp.  The engine's imprints are
// the float64 numpy loop of src/repro/kernels/imprint/ops.py
// (build_zone_maps), and this kernel computes exactly that, bit for bit,
// reading the column in its stored type:
//
//   f[r]  = the row's float64 value: an int32 or float column converted
//           exactly, an int64 column rounded to nearest and divided by
//           div (10**scale for DECIMAL, else 1.0) with IEEE division;
//   ok[r] = the row is not NULL: not the type's sentinel (INT32_MIN,
//           INT64_MIN) for integers, not NaN for floats;
//   for each block b of BLOCK rows:
//     mins[b], maxs[b] = min / max of f over ok rows (+inf / -inf when
//                        the block has none);
//     bitmaps[b]       = OR over ok rows of 1 << bin, with
//                        bin = trunc(clamp((f - lo) * inv, 0, BINS - 1))
//                        when inv > 0, else bin 0 (a constant or
//                        unbounded range: bitmap 1 for a non-empty block).
//
// (f - lo) * inv is one rounded subtraction and one rounded product, as
// numpy computes it (no fused multiply-add).  Clamping before the
// truncation equals numpy's truncate-then-clip for every finite product,
// and sends +-inf (a value appended outside the old range) to bins 15
// and 0.
//
// Two launches build an imprint: the first writes mins and maxs only; the
// engine reads lo = min(mins), hi = max(maxs) and inv = BINS / (hi - lo)
// as Python floats, as the reference's ops._range does; the second writes
// mins, maxs and bitmaps.  Extending an imprint over appended rows is one
// launch of the second kind with the old (lo, inv).
//
// What bounds it on an H100: bytes.  Each row is read once in its stored
// type (4 or 8 bytes) and 18 bytes are written per block; the work is a
// few float64 operations a row.  The design: one CTA of 256 threads per
// 2048-row block, coalesced strided loads, then a warp-shuffle reduction
// of min, max and the bitmap and a fixed cross-warp order.  min, max and
// OR are exact in any order, so the result is deterministic without
// atomics.
//
// Plain C interface (bound with ctypes): imprint_launch returns
// cudaGetLastError() after enqueueing the kernel on the given stream.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define IM_BLOCK 2048
#define IM_BINS 16
#define IM_THREADS 256
#define IM_WARPS (IM_THREADS / 32)

enum { IM_INT32 = 0, IM_INT64 = 1, IM_FLOAT32 = 2, IM_FLOAT64 = 3 };

// the row's float64 value; false when the row is NULL
template <int DT>
__device__ __forceinline__ bool im_value(const void* __restrict__ vals,
                                         int64_t i, double div, double* f) {
    if (DT == IM_INT32) {
        const int32_t v = ((const int32_t*)vals)[i];
        if (v == INT32_MIN) return false;
        *f = __ddiv_rn((double)v, div);
    } else if (DT == IM_INT64) {
        const long long v = ((const long long*)vals)[i];
        if (v == (long long)INT64_MIN) return false;
        *f = __ddiv_rn(__ll2double_rn(v), div);
    } else if (DT == IM_FLOAT32) {
        const float v = ((const float*)vals)[i];
        if (v != v) return false;          // NaN
        *f = __ddiv_rn((double)v, div);
    } else {
        const double v = ((const double*)vals)[i];
        if (v != v) return false;          // NaN
        *f = __ddiv_rn(v, div);
    }
    return true;
}

template <int DT>
__global__ void __launch_bounds__(IM_THREADS)
imprint_blocks(const void* __restrict__ vals, int64_t n, double div,
               double lo, double inv, int with_bitmap,
               double* __restrict__ mins, double* __restrict__ maxs,
               uint16_t* __restrict__ bitmaps) {
    __shared__ double s_min[IM_WARPS];
    __shared__ double s_max[IM_WARPS];
    __shared__ unsigned s_bm[IM_WARPS];
    const int64_t start = (int64_t)blockIdx.x * IM_BLOCK;
    const int64_t end = start + IM_BLOCK < n ? start + IM_BLOCK : n;
    double vmin = INFINITY, vmax = -INFINITY;
    unsigned bm = 0u;
    for (int64_t i = start + threadIdx.x; i < end; i += IM_THREADS) {
        double f;
        if (!im_value<DT>(vals, i, div, &f)) continue;
        vmin = fmin(vmin, f);
        vmax = fmax(vmax, f);
        if (with_bitmap) {
            int bin = 0;
            if (inv > 0.0) {
                double x = __dmul_rn(__dsub_rn(f, lo), inv);
                x = fmin(fmax(x, 0.0), (double)(IM_BINS - 1));
                bin = (int)x;              // truncation of a value in [0, 15]
            }
            bm |= 1u << bin;
        }
    }
    for (int off = 16; off > 0; off >>= 1) {
        vmin = fmin(vmin, __shfl_down_sync(0xffffffffu, vmin, off));
        vmax = fmax(vmax, __shfl_down_sync(0xffffffffu, vmax, off));
        bm |= __shfl_down_sync(0xffffffffu, bm, off);
    }
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
        s_min[warp] = vmin;
        s_max[warp] = vmax;
        s_bm[warp] = bm;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int w = 1; w < IM_WARPS; ++w) {
            vmin = fmin(vmin, s_min[w]);
            vmax = fmax(vmax, s_max[w]);
            bm |= s_bm[w];
        }
        mins[blockIdx.x] = vmin;
        maxs[blockIdx.x] = vmax;
        if (with_bitmap) bitmaps[blockIdx.x] = (uint16_t)bm;
    }
}

extern "C" int imprint_block_rows(void) { return IM_BLOCK; }
extern "C" int imprint_bins(void) { return IM_BINS; }

// vals: (n,) column in its stored type (dtype: IM_INT32 .. IM_FLOAT64);
// mins, maxs: (n_blocks,) float64; bitmaps: (n_blocks,) uint16, written
// only when with_bitmap != 0.  n_blocks = max(1, ceil(n / IM_BLOCK)).
extern "C" int imprint_launch(const void* vals, int64_t n, int dtype,
                              double div, double lo, double inv,
                              int with_bitmap, double* mins, double* maxs,
                              uint16_t* bitmaps, void* stream) {
    if (n < 0 || dtype < IM_INT32 || dtype > IM_FLOAT64 || !(div > 0.0)
            || (with_bitmap && bitmaps == 0))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    int64_t nb = (n + IM_BLOCK - 1) / IM_BLOCK;
    if (nb < 1) nb = 1;
    const unsigned grid = (unsigned)nb;
    switch (dtype) {
    case IM_INT32:
        imprint_blocks<IM_INT32><<<grid, IM_THREADS, 0, s>>>(
            vals, n, div, lo, inv, with_bitmap, mins, maxs, bitmaps);
        break;
    case IM_INT64:
        imprint_blocks<IM_INT64><<<grid, IM_THREADS, 0, s>>>(
            vals, n, div, lo, inv, with_bitmap, mins, maxs, bitmaps);
        break;
    case IM_FLOAT32:
        imprint_blocks<IM_FLOAT32><<<grid, IM_THREADS, 0, s>>>(
            vals, n, div, lo, inv, with_bitmap, mins, maxs, bitmaps);
        break;
    default:
        imprint_blocks<IM_FLOAT64><<<grid, IM_THREADS, 0, s>>>(
            vals, n, div, lo, inv, with_bitmap, mins, maxs, bitmaps);
        break;
    }
    return (int)cudaGetLastError();
}
