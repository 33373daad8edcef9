// k-means kernels for Hopper (sm_90a), batched over a leading block dim B.
//
// Replaces the TPU kernels
//   kmeans_update_pallas  src/repro/kernels/kmeans_update.py:79  (one fused Lloyd step)
//   kmeans_assign_pallas  src/repro/kernels/kmeans_assign.py:59  (assignment only)
// and computes what they compute: d2 = |x|^2 - 2 x.c + |c|^2, the argmin label
// (ties to the lowest centroid id, as jnp.argmin), max(min d2, 0) and, for the
// update, the per-cluster weighted coordinate sums and weight counts. K and D
// are run-time values with no ceiling, as in the reference's wrapper.
//
// Bound on an H100 at the LAMC atom shape (B=128, P=10240, D=5, K=16): bytes.
// One pass reads x (26 MB) and writes labels and d2 (10 MB): ~11 us at
// 3.35 TB/s, against ~6 us for the ~0.4 GFLOP at the 67 TFLOP/s fp32 rate.
// What the design does about it:
//   * one thread scores one point; a CTA stages its tile of kTile points in
//     shared memory in coalesced loads, kSliceD features at a time, and the
//     centroids kSliceK x kSliceD at a time. Each thread keeps the kSliceK
//     running dot products of a centroid slice in registers across the
//     feature slices, then folds them into a running (best, bd) with strict
//     < over ascending k, so ties still go to the lowest id. At D <= kSliceD
//     the point tile is staged once and read from device memory once; D and
//     K are never padded (the TPU wrapper pads D to 128 and K to 8, which at
//     D=5 would multiply the bytes read by 25).
//   * every dot product, |x|^2 and |c|^2 is one chain over ascending
//     features in the reference's association order (no contraction into
//     fma), whatever the slicing, so the labels and distances do not depend
//     on kSliceK or kSliceD.
//   * the update's one-hot never exists: each CTA reduces its tile into
//     per-tile partial sums/counts in a fixed point order, and a second
//     small kernel adds the tiles in a fixed tile order. CUDA blocks run in
//     no order, so the TPU kernel's sequential grid carry cannot be copied;
//     the two fixed orders make the result the same from run to run.
//   * shared memory is a fixed ~38 KB whatever K and D, under the 48 KB a
//     launch gets without an opt-in, so nothing depends on the device.
//
// Plain C interface for ctypes; every entry point returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;    // points per CTA, one per thread
constexpr int kSliceK = 16;   // centroids scored per pass (registers)
constexpr int kSliceD = 32;   // features per staged slice

// Odd row stride for the staged x slice: threads reading their own rows hit
// distinct banks.
__host__ __device__ inline int row_stride(int d) { return d | 1; }

struct Smem {
  float x[kTile * (kSliceD | 1)];   // [point][feature of the slice]
  float c[kSliceK * kSliceD];       // [centroid of the slice][feature of the slice]
  float c2[kSliceK];                // |c|^2 of the centroid slice
  float w[kTile];                   // update: the tile's weights
  int lab[kTile];                   // update: the tile's labels
};

// Stage features [d0, d0 + dn) of the tile's points (rows p0 ..) of block b.
__device__ void stage_x(const float* __restrict__ x, int P, int D, int p0, int n,
                        int d0, int dn, float* x_s) {
  const float* xb = x + ((size_t)blockIdx.y * P + p0) * D;
  const int ds = row_stride(dn);
  for (int i = threadIdx.x; i < n * dn; i += blockDim.x) {
    const int r = i / dn, f = i % dn;
    x_s[r * ds + f] = xb[(size_t)r * D + d0 + f];
  }
}

// Nearest centroid of each point of the tile. On return every thread of a
// live point holds its label and clamped distance, and x_s holds the last
// feature slice (all of x's tile when D <= kSliceD).
__device__ int assign_tile(const float* __restrict__ x, const float* __restrict__ c,
                           int P, int D, int K, int p0, int n, Smem& sm, float* dmin) {
  const int t = threadIdx.x;
  const bool live = t < n;
  const int n_d = (D + kSliceD - 1) / kSliceD;
  const float* cb = c + (size_t)blockIdx.y * K * D;
  float x2 = 0.f, bd = 0.f;
  int best = 0;
  for (int k0 = 0; k0 < K; k0 += kSliceK) {
    const int kn = min(kSliceK, K - k0);
    float acc[kSliceK];
#pragma unroll
    for (int kk = 0; kk < kSliceK; ++kk) acc[kk] = 0.f;
    float c2 = 0.f;   // thread t < kn: |c_{k0 + t}|^2 over the slices so far
    for (int d0 = 0; d0 < D; d0 += kSliceD) {
      const int dn = min(kSliceD, D - d0);
      __syncthreads();   // the previous slice is consumed
      if (n_d > 1 || k0 == 0) stage_x(x, P, D, p0, n, d0, dn, sm.x);
      for (int i = t; i < kn * dn; i += blockDim.x)
        sm.c[i] = cb[(size_t)(k0 + i / dn) * D + d0 + i % dn];
      if (t < kn) {
        const float* cr = cb + (size_t)(k0 + t) * D + d0;
        for (int f = 0; f < dn; ++f) c2 = __fadd_rn(c2, __fmul_rn(cr[f], cr[f]));
      }
      __syncthreads();
      if (live) {
        const float* xr = sm.x + t * row_stride(dn);
        for (int f = 0; f < dn; ++f) {
          const float xv = xr[f];
          if (k0 == 0) x2 = __fadd_rn(x2, __fmul_rn(xv, xv));
#pragma unroll
          for (int kk = 0; kk < kSliceK; ++kk)
            if (kk < kn) acc[kk] = __fadd_rn(acc[kk], __fmul_rn(xv, sm.c[kk * dn + f]));
        }
      }
    }
    if (t < kn) sm.c2[t] = c2;
    __syncthreads();
    if (live) {
#pragma unroll
      for (int kk = 0; kk < kSliceK; ++kk) {
        if (kk >= kn) break;
        const float d2 = __fadd_rn(__fsub_rn(x2, __fmul_rn(2.f, acc[kk])), sm.c2[kk]);
        if (k0 + kk == 0 || d2 < bd) {
          bd = d2;
          best = k0 + kk;
        }
      }
    }
  }
  *dmin = fmaxf(bd, 0.f);
  return best;
}

__global__ void __launch_bounds__(kTile)
kmeans_assign_kernel(const float* __restrict__ x, const float* __restrict__ c, int P,
                     int D, int K, int* __restrict__ labels, float* __restrict__ d2) {
  __shared__ Smem sm;
  const int p0 = blockIdx.x * kTile;
  const int n = min(kTile, P - p0);
  float dm;
  const int lab = assign_tile(x, c, P, D, K, p0, n, sm, &dm);
  if ((int)threadIdx.x < n) {
    const size_t o = (size_t)blockIdx.y * P + p0 + threadIdx.x;
    labels[o] = lab;
    d2[o] = dm;
  }
}

// Assign the tile, then write its partial statistics, each summed over the
// tile's points in ascending order: psums[tile, b, k, j] and pcounts[tile,
// b, k].
__global__ void __launch_bounds__(kTile)
kmeans_update_kernel(const float* __restrict__ x, const float* __restrict__ c,
                     const float* __restrict__ w, int P, int D, int K,
                     int* __restrict__ labels, float* __restrict__ d2,
                     float* __restrict__ psums, float* __restrict__ pcounts) {
  __shared__ Smem sm;
  const int t = threadIdx.x;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kTile;
  const int n = min(kTile, P - p0);
  float dm;
  const int best = assign_tile(x, c, P, D, K, p0, n, sm, &dm);
  int lab = -1;
  float wt = 0.f;
  if (t < n) {
    const size_t o = (size_t)b * P + p0 + t;
    labels[o] = best;
    d2[o] = dm;
    lab = best;
    wt = w ? w[o] : 1.f;
  }
  sm.lab[t] = lab;
  sm.w[t] = wt;
  const size_t part = (size_t)blockIdx.x * gridDim.y + b;  // (tile, block) slot
  const int n_d = (D + kSliceD - 1) / kSliceD;
  for (int d0 = 0; d0 < D; d0 += kSliceD) {
    const int dn = min(kSliceD, D - d0);
    __syncthreads();   // labels published; the previous slice consumed
    if (n_d > 1) {     // at one slice the tile is still staged
      stage_x(x, P, D, p0, n, d0, dn, sm.x);
      __syncthreads();
    }
    const int ds = row_stride(dn);
    for (int e = t; e < K * dn; e += kTile) {
      const int k = e / dn, f = e % dn;
      float s = 0.f;
      for (int i = 0; i < n; ++i)
        s = __fadd_rn(s, sm.lab[i] == k ? __fmul_rn(sm.w[i], sm.x[i * ds + f]) : 0.f);
      psums[(part * K + k) * D + d0 + f] = s;
    }
  }
  for (int k = t; k < K; k += kTile) {
    float s = 0.f;
    for (int i = 0; i < n; ++i) s = __fadd_rn(s, sm.lab[i] == k ? sm.w[i] : 0.f);
    pcounts[part * K + k] = s;
  }
}

// sums[b] / counts[b] = the tile partials of block b added in tile order.
__global__ void kmeans_reduce_kernel(const float* __restrict__ psums,
                                     const float* __restrict__ pcounts,
                                     int tiles, int B, int D, int K,
                                     float* __restrict__ sums,
                                     float* __restrict__ counts) {
  const int b = blockIdx.x;
  for (int e = threadIdx.x; e < K * (D + 1); e += blockDim.x) {
    const int k = e / (D + 1);
    const int j = e % (D + 1);
    float s = 0.f;
    for (int t = 0; t < tiles; ++t) {
      const size_t part = (size_t)t * B + b;
      s = __fadd_rn(s, j < D ? psums[(part * K + k) * D + j] : pcounts[part * K + k]);
    }
    if (j < D)
      sums[((size_t)b * K + k) * D + j] = s;
    else
      counts[(size_t)b * K + k] = s;
  }
}

}  // namespace

extern "C" {

// Points per CTA; the wrapper sizes the partial-statistics scratch of
// kmeans_update_f32 from it.
int kmeans_tile(void) { return kTile; }

const char* kmeans_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (B,P,D), c (B,K,D) -> labels (B,P) int32, d2 (B,P).
int kmeans_assign_f32(const float* x, const float* c, int B, int P, int D, int K,
                      int* labels, float* d2, void* stream) {
  if (B < 1 || P < 1 || D < 1 || K < 1 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((P + kTile - 1) / kTile, B);
  kmeans_assign_kernel<<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      x, c, P, D, K, labels, d2);
  return static_cast<int>(cudaGetLastError());
}

// x (B,P,D), c (B,K,D), w (B,P) or null -> labels, d2, sums (B,K,D),
// counts (B,K). psums (tiles,B,K,D) / pcounts (tiles,B,K) are scratch with
// tiles = ceil(P / kmeans_tile()).
int kmeans_update_f32(const float* x, const float* c, const float* w, int B,
                      int P, int D, int K, int* labels, float* d2, float* psums,
                      float* pcounts, float* sums, float* counts, void* stream) {
  if (B < 1 || P < 1 || D < 1 || K < 1 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (P + kTile - 1) / kTile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kmeans_update_kernel<<<dim3(tiles, B), kTile, 0, s>>>(x, c, w, P, D, K, labels,
                                                        d2, psums, pcounts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kmeans_reduce_kernel<<<B, 128, 0, s>>>(psums, pcounts, tiles, B, D, K, sums, counts);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
