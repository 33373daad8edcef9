// Tiled block-sparse SpMM kernels for Hopper (sm_90a).
//
// Replace the TPU kernels of src/repro/kernels/spmm.py:
//   spmm_pallas      (line 413)  out = A @ B           over the surviving tiles
//   spmm_t_pallas    (line 483)  out = A.T @ B         payloads visited via t_order
//   spmm_ata_pallas  (line 585)  out = A.T @ (A @ X)   [+ gram = out.T @ out]
// A is the tile-level format of kernels/spmm.py: blocks (G, bm, bk) f32,
// block_rows / block_cols (G,) i32 with block_rows sorted, t_order (G,) i32
// (payloads in tile-col order), optional pending scales rs (n_tr, bm) and
// cs (n_tc, bk) applied to each tile as (tile * rs[row]) * cs[col], in
// separately rounded multiplies, so a lazily scaled operator gives the same
// bits as the materialized one.
//
// Bound on an H100 at the sparse LAMC cell (131,072 x 16,384, every 128 x 128
// tile occupied, r = 6): bytes. Each product reads the 8 GiB payload stack
// once (~2.56 ms at 3.35 TB/s) and does 2 * r flops per 4-byte element,
// 3 flops per byte, far below the fp32 ridge. What the design does:
//   * The RHS width r is a run-time value (the TPU wrapper pads it to 128
//     columns, which at r = 6 would move 21x the RHS bytes). Kernels are
//     instantiated for stripe widths RN = 1..8; wider RHS runs in stripes.
//   * Each output tile-row (forward) or tile-col (transpose) belongs to a
//     fixed set of CTAs that walk its payload segment in a fixed order; the
//     Pallas grid's "revisit the resident output block" has no counterpart
//     because CUDA blocks run in no order. Segments that are few and long
//     (the transpose has 128 tile-cols against 1,024 tile-rows) are split
//     into chunks whose partial sums a second kernel adds in chunk order:
//     deterministic, no atomics.
//   * Payload rows are read as float4, a warp per row, with streaming loads
//     (__ldcs), all of a thread's rows of the next tile requested before the
//     RHS slice is staged in shared memory, so the loads are in flight
//     during the staging.
//   * spmm_ata cannot hold Y = A X on chip (3 MiB at the cell against 227 KB
//     of shared memory): Y goes to device memory, where the 50 MB L2 keeps
//     it for the transposed walk. So the fused form reads the payloads twice
//     and can reach at most half of the one-read bound.
//   * Offsets into blocks are 64-bit: the stack holds 2^31 elements at the
//     cell.
//
// Plain C interface for ctypes; every entry point returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 8;       // bm <= kWarps * kRowsPerWarp = 128
constexpr int kMaxTile = 128;         // bk <= 32 lanes * 4 columns
constexpr int kMaxRN = 8;
constexpr int kReduceThreads = 256;

// Payloads [c0, c1) of chunk `part` of `split` of the segment [s0, s1).
__device__ inline void chunk_of(int s0, int s1, int part, int split, int* c0, int* c1) {
  const long long len = s1 - s0;
  *c0 = s0 + (int)(len * part / split);
  *c1 = s0 + (int)(len * (part + 1) / split);
}

__device__ inline float4 scale4(float4 v, float rs, float4 cs) {
  v.x = __fmul_rn(__fmul_rn(v.x, rs), cs.x);
  v.y = __fmul_rn(__fmul_rn(v.y, rs), cs.y);
  v.z = __fmul_rn(__fmul_rn(v.z, rs), cs.z);
  v.w = __fmul_rn(__fmul_rn(v.w, rs), cs.w);
  return v;
}

// Forward: CTA (segment = tile-row i, chunk, stripe). Lane l owns tile columns
// 4l..4l+3, warp w owns tile rows w + 16q. acc[q][c] holds the lane's partial
// sum over its columns for row q, across the whole chunk; a butterfly over
// the lanes finishes each row at the end.
template <int RN>
__global__ void __launch_bounds__(kThreads, 1)
spmm_fwd_kernel(const float* __restrict__ blocks, const int* __restrict__ block_cols,
                const int* __restrict__ row_ptr, const float* __restrict__ rs,
                const float* __restrict__ cs, int bm, int bk,
                const float* __restrict__ b, int K, int r,
                float* __restrict__ out, int M, int split) {
  __shared__ __align__(16) float b_s[RN * kMaxTile];   // b_s[c * bk + kk]
  __shared__ float rs_s[kMaxTile];
  const int seg = blockIdx.x / split, part = blockIdx.x % split;
  const int c0 = blockIdx.y * RN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = 4 * lane;
  const bool col_ok = col < bk;
  const bool scaled = rs != nullptr;
  if (scaled)
    for (int a = threadIdx.x; a < bm; a += kThreads) rs_s[a] = rs[(size_t)seg * bm + a];
  int g0, g1;
  chunk_of(row_ptr[seg], row_ptr[seg + 1], part, split, &g0, &g1);
  float acc[kRowsPerWarp][RN];
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q)
#pragma unroll
    for (int c = 0; c < RN; ++c) acc[q][c] = 0.f;

  for (int g = g0; g < g1; ++g) {
    const int j = block_cols[g];
    float4 t[kRowsPerWarp];
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) {
      const int row = warp + kWarps * q;
      t[q] = (row < bm && col_ok)
                 ? __ldcs(reinterpret_cast<const float4*>(
                       blocks + ((size_t)g * bm + row) * bk + col))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();  // the previous payload's b_s reads are done
    for (int e = threadIdx.x; e < RN * bk; e += kThreads) {
      const int c = e / bk, kk = e % bk;
      const int grow = j * bk + kk;
      b_s[e] = (grow < K && c0 + c < r) ? b[(size_t)grow * r + c0 + c] : 0.f;
    }
    __syncthreads();
    if (col_ok) {
      const float4 csv = scaled ? __ldg(reinterpret_cast<const float4*>(cs + (size_t)j * bk + col))
                                : make_float4(1.f, 1.f, 1.f, 1.f);
      float bv[4][RN];
#pragma unroll
      for (int c = 0; c < RN; ++c) {
        const float4 v = *reinterpret_cast<const float4*>(&b_s[c * bk + col]);
        bv[0][c] = v.x;
        bv[1][c] = v.y;
        bv[2][c] = v.z;
        bv[3][c] = v.w;
      }
#pragma unroll
      for (int q = 0; q < kRowsPerWarp; ++q) {
        const int row = warp + kWarps * q;
        if (row < bm) {
          const float4 v = scaled ? scale4(t[q], rs_s[row], csv) : t[q];
#pragma unroll
          for (int c = 0; c < RN; ++c)
            acc[q][c] = fmaf(v.w, bv[3][c],
                             fmaf(v.z, bv[2][c], fmaf(v.y, bv[1][c], fmaf(v.x, bv[0][c], acc[q][c]))));
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q)
#pragma unroll
    for (int c = 0; c < RN; ++c) {
      float s = acc[q][c];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      acc[q][c] = s;
    }
  if (lane == 0) {
    float* dst = out + (size_t)part * M * r;
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) {
      const int row = warp + kWarps * q;
      const int grow = seg * bm + row;
      if (row < bm && grow < M)
#pragma unroll
        for (int c = 0; c < RN; ++c)
          if (c0 + c < r) dst[(size_t)grow * r + c0 + c] = acc[q][c];
    }
  }
}

// Transpose: CTA (segment = tile-col j, chunk, stripe), payloads visited as
// t_order[p]. Lane l owns tile columns 4l..4l+3 (output rows of tile-col j),
// warp w owns tile rows w + 16q; acc[jj][c] sums over the warp's rows across
// the chunk, and the 16 warps are added in warp order through shared memory.
template <int RN>
__global__ void __launch_bounds__(kThreads, 1)
spmm_t_kernel(const float* __restrict__ blocks, const int* __restrict__ block_rows,
              const int* __restrict__ t_order, const int* __restrict__ col_ptr,
              const float* __restrict__ rs, const float* __restrict__ cs, int bm, int bk,
              const float* __restrict__ b, int M, int r, float* __restrict__ out,
              int K, int split) {
  __shared__ float b_s[kMaxTile * RN];   // b_s[a * RN + c]
  __shared__ float rs_s[kMaxTile];
  __shared__ float red_s[kMaxTile * RN];  // red_s[kk * RN + c]
  const int seg = blockIdx.x / split, part = blockIdx.x % split;
  const int c0 = blockIdx.y * RN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = 4 * lane;
  const bool col_ok = col < bk;
  const bool scaled = rs != nullptr;
  const float4 csv = (scaled && col_ok)
                         ? __ldg(reinterpret_cast<const float4*>(cs + (size_t)seg * bk + col))
                         : make_float4(1.f, 1.f, 1.f, 1.f);
  int p0, p1;
  chunk_of(col_ptr[seg], col_ptr[seg + 1], part, split, &p0, &p1);
  float acc[4][RN];
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
#pragma unroll
    for (int c = 0; c < RN; ++c) acc[jj][c] = 0.f;

  for (int p = p0; p < p1; ++p) {
    const int g = t_order[p];
    const int i = block_rows[g];
    float4 t[kRowsPerWarp];
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) {
      const int row = warp + kWarps * q;
      t[q] = (row < bm && col_ok)
                 ? __ldcs(reinterpret_cast<const float4*>(
                       blocks + ((size_t)g * bm + row) * bk + col))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < bm * RN; e += kThreads) {
      const int a = e / RN, c = e % RN;
      const int grow = i * bm + a;
      b_s[e] = (grow < M && c0 + c < r) ? b[(size_t)grow * r + c0 + c] : 0.f;
    }
    if (scaled)
      for (int a = threadIdx.x; a < bm; a += kThreads) rs_s[a] = rs[(size_t)i * bm + a];
    __syncthreads();
    if (col_ok) {
#pragma unroll
      for (int q = 0; q < kRowsPerWarp; ++q) {
        const int row = warp + kWarps * q;
        if (row < bm) {
          const float4 v = scaled ? scale4(t[q], rs_s[row], csv) : t[q];
#pragma unroll
          for (int c = 0; c < RN; ++c) {
            const float bv = b_s[row * RN + c];
            acc[0][c] = fmaf(v.x, bv, acc[0][c]);
            acc[1][c] = fmaf(v.y, bv, acc[1][c]);
            acc[2][c] = fmaf(v.z, bv, acc[2][c]);
            acc[3][c] = fmaf(v.w, bv, acc[3][c]);
          }
        }
      }
    }
  }
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w && col_ok) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < RN; ++c) {
          float* slot = &red_s[(col + jj) * RN + c];
          *slot = w == 0 ? acc[jj][c] : __fadd_rn(*slot, acc[jj][c]);
        }
    }
    __syncthreads();
  }
  float* dst = out + (size_t)part * K * r;
  for (int e = threadIdx.x; e < bk * RN; e += kThreads) {
    const int kk = e / RN, c = e % RN;
    const int grow = seg * bk + kk;
    if (grow < K && c0 + c < r) dst[(size_t)grow * r + c0 + c] = red_s[e];
  }
}

// out[e] = part[0][e] + part[1][e] + ... in chunk order.
__global__ void sum_parts_kernel(const float* __restrict__ part, int split, size_t n,
                                 float* __restrict__ out) {
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    float s = part[e];
    for (int p = 1; p < split; ++p) s = __fadd_rn(s, part[(size_t)p * n + e]);
    out[e] = s;
  }
}

// Gram stage 1: chunk ch of the rows of z (K, r); part[ch][c1][c2] is the sum
// over the chunk, thread-strided then a fixed tree in shared memory.
__global__ void gram_partial_kernel(const float* __restrict__ z, int K, int r, int chunks,
                                    float* __restrict__ part) {
  __shared__ float red[kReduceThreads];
  const int ch = blockIdx.x;
  const int k0 = (int)((long long)K * ch / chunks);
  const int k1 = (int)((long long)K * (ch + 1) / chunks);
  for (int e = 0; e < r * r; ++e) {
    const int c1 = e / r, c2 = e % r;
    float s = 0.f;
    for (int row = k0 + threadIdx.x; row < k1; row += kReduceThreads)
      s = fmaf(z[(size_t)row * r + c1], z[(size_t)row * r + c2], s);
    red[threadIdx.x] = s;
    __syncthreads();
    for (int w = kReduceThreads / 2; w > 0; w >>= 1) {
      if (threadIdx.x < w) red[threadIdx.x] = __fadd_rn(red[threadIdx.x], red[threadIdx.x + w]);
      __syncthreads();
    }
    if (threadIdx.x == 0) part[(size_t)ch * r * r + e] = red[0];
    __syncthreads();
  }
}

// Gram stage 2: the chunk partials added in chunk order.
__global__ void gram_reduce_kernel(const float* __restrict__ part, int r, int chunks,
                                   float* __restrict__ gram) {
  for (int e = threadIdx.x; e < r * r; e += blockDim.x) {
    float s = part[e];
    for (int ch = 1; ch < chunks; ++ch) s = __fadd_rn(s, part[(size_t)ch * r * r + e]);
    gram[e] = s;
  }
}

int stripe_width(int r) { return r < kMaxRN ? r : kMaxRN; }

#define RN_SWITCH(RNV, ...)                 \
  switch (RNV) {                             \
    case 1: { constexpr int RN = 1; __VA_ARGS__; break; } \
    case 2: { constexpr int RN = 2; __VA_ARGS__; break; } \
    case 3: { constexpr int RN = 3; __VA_ARGS__; break; } \
    case 4: { constexpr int RN = 4; __VA_ARGS__; break; } \
    case 5: { constexpr int RN = 5; __VA_ARGS__; break; } \
    case 6: { constexpr int RN = 6; __VA_ARGS__; break; } \
    case 7: { constexpr int RN = 7; __VA_ARGS__; break; } \
    default: { constexpr int RN = 8; __VA_ARGS__; break; } \
  }

cudaError_t sum_parts(const float* part, int split, size_t n, float* out, cudaStream_t s) {
  const size_t want = (n + kReduceThreads - 1) / kReduceThreads;
  const int grid = (int)(want < 4096 ? want : 4096);
  sum_parts_kernel<<<grid, kReduceThreads, 0, s>>>(part, split, n, out);
  return cudaGetLastError();
}

cudaError_t forward(const float* blocks, const int* block_cols, const int* row_ptr,
                    const float* rs, const float* cs, int n_tr, int bm, int bk,
                    const float* b, int K, int r, float* out, int M, int split,
                    float* part, cudaStream_t s) {
  const int rn = stripe_width(r);
  const dim3 grid(n_tr * split, (r + rn - 1) / rn);
  float* dst = split > 1 ? part : out;
  RN_SWITCH(rn, spmm_fwd_kernel<RN><<<grid, kThreads, 0, s>>>(
                    blocks, block_cols, row_ptr, rs, cs, bm, bk, b, K, r, dst, M, split));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return err;
  return sum_parts(part, split, (size_t)M * r, out, s);
}

cudaError_t transpose(const float* blocks, const int* block_rows, const int* t_order,
                      const int* col_ptr, const float* rs, const float* cs, int n_tc,
                      int bm, int bk, const float* b, int M, int r, float* out, int K,
                      int split, float* part, cudaStream_t s) {
  const int rn = stripe_width(r);
  const dim3 grid(n_tc * split, (r + rn - 1) / rn);
  float* dst = split > 1 ? part : out;
  RN_SWITCH(rn, spmm_t_kernel<RN><<<grid, kThreads, 0, s>>>(
                    blocks, block_rows, t_order, col_ptr, rs, cs, bm, bk, b, M, r, dst, K,
                    split));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return err;
  return sum_parts(part, split, (size_t)K * r, out, s);
}

}  // namespace

extern "C" {

const char* spmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out (M, r) = A @ b, b (K, r). part: (split, M, r) scratch when split > 1.
int spmm_f32(const float* blocks, const int* block_cols, const int* row_ptr,
             const float* rs, const float* cs, int n_tr, int n_tc, int bm, int bk,
             const float* b, int K, int r, float* out, int M, int split, float* part,
             void* stream) {
  (void)n_tc;
  return static_cast<int>(forward(blocks, block_cols, row_ptr, rs, cs, n_tr, bm, bk, b,
                                  K, r, out, M, split, part,
                                  static_cast<cudaStream_t>(stream)));
}

// out (K, r) = A.T @ b, b (M, r). part: (split, K, r) scratch when split > 1.
int spmm_t_f32(const float* blocks, const int* block_rows, const int* t_order,
               const int* col_ptr, const float* rs, const float* cs, int n_tr, int n_tc,
               int bm, int bk, const float* b, int M, int r, float* out, int K, int split,
               float* part, void* stream) {
  (void)n_tr;
  return static_cast<int>(transpose(blocks, block_rows, t_order, col_ptr, rs, cs, n_tc,
                                    bm, bk, b, M, r, out, K, split, part,
                                    static_cast<cudaStream_t>(stream)));
}

// out (K, r) = A.T @ (A @ x) through y (M, r); with gram != null also
// gram (r, r) = out.T @ out, gram_part (gram_chunks, r, r) scratch.
int spmm_ata_f32(const float* blocks, const int* block_rows, const int* block_cols,
                 const int* t_order, const int* row_ptr, const int* col_ptr,
                 const float* rs, const float* cs, int n_tr, int n_tc, int bm, int bk,
                 const float* x, int M, int K, int r, float* y, float* out, int split_f,
                 float* part_f, int split_t, float* part_t, float* gram, float* gram_part,
                 int gram_chunks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = forward(blocks, block_cols, row_ptr, rs, cs, n_tr, bm, bk, x, K, r, y,
                            M, split_f, part_f, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = transpose(blocks, block_rows, t_order, col_ptr, rs, cs, n_tc, bm, bk, y, M, r, out,
                  K, split_t, part_t, s);
  if (err != cudaSuccess || gram == nullptr) return static_cast<int>(err);
  gram_partial_kernel<<<gram_chunks, kReduceThreads, 0, s>>>(out, K, r, gram_chunks,
                                                             gram_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gram_reduce_kernel<<<1, 64, 0, s>>>(gram_part, r, gram_chunks, gram);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
