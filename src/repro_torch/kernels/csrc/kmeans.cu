// k-means kernels for Hopper (sm_90a), batched over a leading block dim B.
//
// Replaces the TPU kernels
//   kmeans_update_pallas  src/repro/kernels/kmeans_update.py:79  (one fused Lloyd step)
//   kmeans_assign_pallas  src/repro/kernels/kmeans_assign.py:59  (assignment only)
// and computes what they compute: d2 = |x|^2 - 2 x.c + |c|^2, the argmin label
// (ties to the lowest centroid id, as jnp.argmin), max(min d2, 0) and, for the
// update, the per-cluster weighted coordinate sums and weight counts.
//
// Bound on an H100 at the LAMC atom shape (B=128, P=10240, D=5, K=16): bytes.
// One pass reads x (26 MB) and writes labels and d2 (10 MB): ~11 us at
// 3.35 TB/s, against ~6 us for the ~0.4 GFLOP at the 67 TFLOP/s fp32 rate.
// What the design does about it:
//   * x is read from device memory exactly once, in coalesced loads of a
//     whole point tile into shared memory; D and K are runtime values, so
//     nothing is padded (the TPU wrapper pads D to 128 and K to 8, which at
//     D=5 would multiply the bytes read by 25).
//   * the (K, D) centroids and |c|^2 sit in shared memory; one thread scores
//     one point against all K centroids in registers.
//   * the update's one-hot never exists: each CTA reduces its tile into
//     per-tile partial sums/counts in a fixed point order, and a second
//     small kernel adds the tiles in a fixed tile order. CUDA blocks run in
//     no order, so the TPU kernel's sequential grid carry cannot be copied;
//     the two fixed orders make the result the same from run to run.
//
// Plain C interface for ctypes; every entry point returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTile = 256;
constexpr size_t kSmemLimit = 48 * 1024;  // static launch limit, no opt-in

// Odd row stride for the staged x tile: threads reading their own rows hit
// distinct banks.
__host__ __device__ inline int row_stride(int d) { return d | 1; }

size_t smem_floats(int tile, int d, int k, bool update) {
  size_t f = (size_t)k * d + k + (size_t)tile * row_stride(d);
  if (update) f += 2 * (size_t)tile;  // labels + weights of the tile
  return f;
}

int pick_tile(int d, int k, bool update) {
  int tile = kMaxTile;
  while (tile > 32 && smem_floats(tile, d, k, update) * 4 > kSmemLimit) tile /= 2;
  return tile;
}

// Load block b's centroids, their squared norms and the point tile starting
// at p0 into shared memory.
__device__ void stage(const float* __restrict__ x, const float* __restrict__ c,
                      int P, int D, int K, int p0, float* c_s, float* c2_s,
                      float* x_s) {
  const int b = blockIdx.y;
  const float* cb = c + (size_t)b * K * D;
  for (int i = threadIdx.x; i < K * D; i += blockDim.x) c_s[i] = cb[i];
  const float* xb = x + ((size_t)b * P + p0) * D;
  const int n = min((int)blockDim.x, P - p0) * D;
  const int ds = row_stride(D);
  for (int i = threadIdx.x; i < n; i += blockDim.x) x_s[(i / D) * ds + i % D] = xb[i];
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = __fadd_rn(s, __fmul_rn(c_s[k * D + d], c_s[k * D + d]));
    c2_s[k] = s;
  }
  __syncthreads();
}

// Nearest centroid of one staged point: x2 - 2*xc + c2 evaluated in the
// reference's association order (no contraction into fma), strict < over
// ascending k.
__device__ int nearest(const float* xr, const float* c_s, const float* c2_s,
                       int D, int K, float* dmin) {
  float x2 = 0.f;
  for (int d = 0; d < D; ++d) x2 = __fadd_rn(x2, __fmul_rn(xr[d], xr[d]));
  int best = 0;
  float bd = 0.f;
  for (int k = 0; k < K; ++k) {
    float xc = 0.f;
    for (int d = 0; d < D; ++d) xc = __fadd_rn(xc, __fmul_rn(xr[d], c_s[k * D + d]));
    const float d2 = __fadd_rn(__fsub_rn(x2, __fmul_rn(2.f, xc)), c2_s[k]);
    if (k == 0 || d2 < bd) {
      bd = d2;
      best = k;
    }
  }
  *dmin = fmaxf(bd, 0.f);
  return best;
}

__global__ void kmeans_assign_kernel(const float* __restrict__ x,
                                     const float* __restrict__ c, int P, int D,
                                     int K, int* __restrict__ labels,
                                     float* __restrict__ d2) {
  extern __shared__ float smem[];
  float* c_s = smem;
  float* c2_s = c_s + K * D;
  float* x_s = c2_s + K;
  const int p0 = blockIdx.x * blockDim.x;
  stage(x, c, P, D, K, p0, c_s, c2_s, x_s);
  const int p = p0 + threadIdx.x;
  if (p < P) {
    float dm;
    const int lab = nearest(x_s + threadIdx.x * row_stride(D), c_s, c2_s, D, K, &dm);
    const size_t o = (size_t)blockIdx.y * P + p;
    labels[o] = lab;
    d2[o] = dm;
  }
}

// Assign the tile, then write its partial statistics: entry e = k*(D+1)+j is
// sums[k][j] for j < D and counts[k] for j == D, summed over the tile's
// points in ascending order.
__global__ void kmeans_update_kernel(const float* __restrict__ x,
                                     const float* __restrict__ c,
                                     const float* __restrict__ w, int P, int D,
                                     int K, int* __restrict__ labels,
                                     float* __restrict__ d2,
                                     float* __restrict__ psums,
                                     float* __restrict__ pcounts) {
  extern __shared__ float smem[];
  const int tile = blockDim.x;
  const int ds = row_stride(D);
  float* c_s = smem;
  float* c2_s = c_s + K * D;
  float* x_s = c2_s + K;
  float* w_s = x_s + tile * ds;
  int* lab_s = reinterpret_cast<int*>(w_s + tile);
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * tile;
  stage(x, c, P, D, K, p0, c_s, c2_s, x_s);
  const int p = p0 + threadIdx.x;
  int lab = -1;
  float wt = 0.f;
  if (p < P) {
    float dm;
    lab = nearest(x_s + threadIdx.x * ds, c_s, c2_s, D, K, &dm);
    const size_t o = (size_t)b * P + p;
    labels[o] = lab;
    d2[o] = dm;
    wt = w ? w[o] : 1.f;
  }
  lab_s[threadIdx.x] = lab;
  w_s[threadIdx.x] = wt;
  __syncthreads();
  const int n = min(tile, P - p0);
  const size_t part = (size_t)blockIdx.x * gridDim.y + b;  // (tile, block) slot
  for (int e = threadIdx.x; e < K * (D + 1); e += tile) {
    const int k = e / (D + 1);
    const int j = e % (D + 1);
    float s = 0.f;
    for (int i = 0; i < n; ++i) {
      const float v = j < D ? __fmul_rn(w_s[i], x_s[i * ds + j]) : w_s[i];
      s = __fadd_rn(s, lab_s[i] == k ? v : 0.f);
    }
    if (j < D)
      psums[(part * K + k) * D + j] = s;
    else
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

// Points per CTA for a launch with these D, K; the wrapper sizes the
// partial-statistics scratch of kmeans_update_f32 from it.
int kmeans_tile(int D, int K, int update) { return pick_tile(D, K, update != 0); }

const char* kmeans_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (B,P,D), c (B,K,D) -> labels (B,P) int32, d2 (B,P).
int kmeans_assign_f32(const float* x, const float* c, int B, int P, int D, int K,
                      int* labels, float* d2, void* stream) {
  const int tile = pick_tile(D, K, false);
  const dim3 grid((P + tile - 1) / tile, B);
  const size_t smem = smem_floats(tile, D, K, false) * sizeof(float);
  kmeans_assign_kernel<<<grid, tile, smem, static_cast<cudaStream_t>(stream)>>>(
      x, c, P, D, K, labels, d2);
  return static_cast<int>(cudaGetLastError());
}

// x (B,P,D), c (B,K,D), w (B,P) or null -> labels, d2, sums (B,K,D),
// counts (B,K). psums (tiles,B,K,D) / pcounts (tiles,B,K) are scratch with
// tiles = ceil(P / kmeans_tile(D, K, 1)).
int kmeans_update_f32(const float* x, const float* c, const float* w, int B,
                      int P, int D, int K, int* labels, float* d2, float* psums,
                      float* pcounts, float* sums, float* counts, void* stream) {
  const int tile = pick_tile(D, K, true);
  const int tiles = (P + tile - 1) / tile;
  const size_t smem = smem_floats(tile, D, K, true) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kmeans_update_kernel<<<dim3(tiles, B), tile, smem, s>>>(x, c, w, P, D, K, labels,
                                                          d2, psums, pcounts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kmeans_reduce_kernel<<<B, 128, 0, s>>>(psums, pcounts, tiles, B, D, K, sums, counts);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
