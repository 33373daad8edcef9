// Flash-attention forward kernels for Hopper (sm_90a): the LM prefill's
// attention.
//
// Replaces the TPU kernel
//   flash_attention_pallas  src/repro/kernels/flash_attention.py:84
// and computes the function of the reference's chunked_causal_attention
// (src/repro/models/attention.py:37), of which the Pallas kernel is the
// window = 0, q_offset = 0 case:
//   s = (q . k) * (1 / sqrt(Dh)) in float32, masked entries set to -1e30
//   (key position >= kv_len; with causal, key position > query position
//   q_offset + i; with window > 0, query - key position >= window), a
//   running max m, normalizer l and accumulator in float32, then
//   acc / max(l, 1e-30) cast to q's type.
// q (B, Hq, Sq, Dh), k and v (B, Hkv, Skv, Dh), o (B, Hq, Sq, Dh), all
// contiguous, float32 or bf16 (nothing is accumulated in bf16). Query head h
// reads kv head h / (Hq / Hkv) directly: the GQA repeat is never
// materialized, which cuts K/V traffic by Hq / Hkv.
//
// A row with no live key keeps the reference's sentinel semantics: there
// every score is -1e30, exp(-1e30 - (-1e30)) = 1, and the reference's
// chunks add every key's v (its zero padding included) with weight 1. So
// such a row gets sum_{j < Skv} v_j / dead_den, where the caller passes
// dead_den = Skv rounded up to the reference's chunk size. The kernels
// detect such rows (m still -1e30 after their tiles) and write that value.
//
// What bounds it on an H100: operations. At the served prefill (B = 4,
// Hq = 32, Hkv = 8, S = 2048, Dh = 128, bf16, causal) the 4 Dh flops of each
// live (query, key) pair, 137 GFLOP, take 0.14 ms at the 989 TFLOP/s bf16
// tensor-core rate, while q, k, v and o are 100 MB, 0.03 ms at 3.35 TB/s.
// Only wgmma reaches that rate, so bf16 runs on one kernel built around it:
//
// * Route: bf16 with Dh % 8 == 0 (Dh <= 256) and 16-byte-aligned pointers.
//   Dh is bucketed to 64, 128 or 256 at compile time; a narrower head is
//   zero-filled by TMA past Dh, never padded in device memory.
// * Three warpgroups per CTA. Warp 0 of warpgroup 0 is the producer: one
//   thread issues TMA loads (each 128-row query tile's Q once, then K and V
//   tiles into a ring of stages with "full" and "empty" mbarriers), and the
//   warpgroup gives its registers away (setmaxnreg 24). Warpgroups 1 and 2
//   are consumers with 240 registers each; each owns 64 query rows.
// * Persistent at Dh <= 128: one CTA per SM walks the (b*Hq + h, query
//   tile) tiles, so the next tile's Q and K/V loads run under the current
//   tile's last products and its output store. The order is heads fastest
//   (neighbours share kv heads in L2) and, causal, the query tiles with the
//   most KV tiles first, so the last round is not a tail of long tiles. At
//   Dh = 256 O's staging buffer would not fit: one CTA per tile, same order.
// * Tiles: 128 keys per stage at Dh = 64 (4 stages) and 128 (2 stages), 64
//   keys at Dh = 256 (2 stages); dynamic shared memory about 162, 194 and
//   195 KB. The O accumulator (Dh / 2 floats a thread) and S (keys / 2) stay
//   in registers.
// * Tensor maps are 3-D (Dh, S, B*H) with 128-byte swizzle and 64-column
//   boxes, so a ragged tile's rows past S are zero-filled inside their own
//   head. They are built on the host by cuTensorMapEncodeTiled, reached
//   through cudaGetDriverEntryPoint (no -lcuda), and passed as
//   __grid_constant__ parameters.
// * S = Q K^T: wgmma m64nNk16, Q and K from shared memory (K's (key, d)
//   rows are the K-major B operand). O += P V: P from registers (S's
//   accumulator fragments rounded to bf16 once, as every bf16 flash kernel
//   does; the row sums use the float values), V from shared memory through
//   the transpose bit for B, one wgmma over all Dh columns per 16 keys.
// * Overlap: each consumer issues S of tile t and then P V of tile t - 1,
//   waits only for S and runs tile t's softmax under the P V product. The
//   two consumers take turns to issue (named barriers), so one's softmax
//   also runs under the other's products.
// * Masks only where needed: tiles with no live key are skipped (above the
//   causal diagonal, before the window, at and past kv_len); a tile whose
//   every (row, key) is live runs with no per-element test; the diagonal,
//   window-edge, kv_len-edge and ragged tiles are masked. exp2 with log2(e)
//   folded into the scale.
// * The output goes through shared memory in the tensor map's layout (its
//   own buffer, or Q's at Dh = 256) and out by TMA stores, which clip rows
//   past Sq and columns past Dh. No split-KV, no atomics: two launches give
//   equal bits.
// float32 inputs, and bf16 whose Dh is not a multiple of 8 or whose
// pointers are not 16-byte aligned (TMA needs both), take the float32-pipe
// kernel (67 TFLOP/s): a float32 product on the tensor cores would be TF32,
// 3 decimal digits where the reference keeps float32's 7, and the float32
// pipe already beats the library call at the served shape.
//
// Plain C interface for ctypes; every entry point returns a cudaError_t, or
// kEncodeError + the CUresult of a failed tensor-map encode.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>

#include <cuda.h>   // CUtensorMap and its enums; the entry point comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileQ = 64;
constexpr int kTileK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;   // the reference's mask sentinel
constexpr int kStrideP = kTileK + 4;
constexpr size_t kSmemLimit = 232448;   // a CTA's opt-in maximum on sm_90
constexpr int kMaxDevices = 64;
constexpr int kEncodeError = 100000;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// cudaFuncSetAttribute calls made so far (the analyzer's rebuild audit).
std::atomic<int> g_attribute_sets{0};

template <int kDh>
constexpr size_t smem_floats() {
  return 2 * (size_t)kTileQ * (kDh + 4) + (size_t)kTileK * kDh +
         (size_t)kTileQ * kStrideP + kDh;
}

// Stage rows [0, n) of a (rows, dh) tile at src into dst (row stride
// `stride`) as float32; columns [dh, width) and rows [n, 64) are zeros.
template <typename T>
__device__ void stage(const T* __restrict__ src, int n, int dh, int width,
                      int stride, float* dst) {
  for (int i = threadIdx.x; i < kTileQ * width; i += kThreads) {
    const int r = i / width, c = i - r * width;
    dst[r * stride + c] = (r < n && c < dh) ? load_f(src + (size_t)r * dh + c) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// float32-pipe path: 256 threads; each computes a 4 x 4 block of scores
// (rows 4 ty .. 4 ty + 3, keys tx + 16 j) from float4 shared-memory reads,
// keeps the running max and sum of its 4 rows (the 16 lanes sharing the rows
// reduce by shuffles) and owns the output columns tx + 16 jj of those rows.
// ---------------------------------------------------------------------------

template <typename T, int kDh>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Hq, int Hkv,
                 int Sq, int Skv, int Dh, int causal, int kv_len, int window,
                 int q_offset, float scale, float dead_den) {
  constexpr int kStrideQ = kDh + 4;   // float4 rows, 16-byte aligned
  constexpr int kCols = kDh / 16;     // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                              // [64][kStrideQ]
  float* ks = qs + kTileQ * kStrideQ;            // [64][kStrideQ]
  float* vs = ks + kTileK * kStrideQ;            // [64][kDh]
  float* ps = vs + kTileK * kDh;                 // [64][kStrideP]
  float* vsum = ps + kTileQ * kStrideP;          // [kDh] dead-row values

  const int t = threadIdx.x, ty = t >> 4, tx = t & 15;
  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh - b * Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * kTileQ;
  const int nq = min(kTileQ, Sq - q0);
  const int dh4 = (Dh + 3) & ~3;
  const T* qb = q + ((size_t)bh * Sq + q0) * Dh;
  const T* kb = k + ((size_t)b * Hkv + hk) * (size_t)Skv * Dh;
  const T* vb = v + ((size_t)b * Hkv + hk) * (size_t)Skv * Dh;
  T* ob = o + ((size_t)bh * Sq + q0) * Dh;

  // live keys of the tile's rows lie in [k_lo, k_hi)
  const int qp_first = q_offset + q0, qp_last = q_offset + q0 + nq - 1;
  int k_hi = kv_len;
  if (causal) k_hi = min(k_hi, qp_last + 1);
  const int k_lo = window > 0 ? max(0, qp_first - window + 1) : 0;
  const int kt_first = k_lo / kTileK;
  const int kt_end = k_hi > k_lo ? (k_hi + kTileK - 1) / kTileK : kt_first;

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) acc[i][jj] = 0.f;
  }
  stage(qb, nq, Dh, dh4, kStrideQ, qs);

  for (int kt = kt_first; kt < kt_end; ++kt) {
    const int kp0 = kt * kTileK;
    const int nk = min(kTileK, Skv - kp0);
    __syncthreads();   // the previous tile is consumed (and Q is staged)
    stage(kb + (size_t)kp0 * Dh, nk, Dh, dh4, kStrideQ, ks);
    stage(vb + (size_t)kp0 * Dh, nk, Dh, kDh, kDh, vs);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < dh4; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty * 4 + i) * kStrideQ + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * kStrideQ + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          s[i][j] = fmaf(qv[i].w, kv[j].w, a);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = qp_first + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = kp0 + tx + 16 * j;
        const bool live = kp < kv_len && (!causal || qp >= kp) &&
                          (window <= 0 || qp - kp < window);
        s[i][j] = live ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty * 4 + i) * kStrideP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) acc[i][jj] *= corr;
    }
    __syncthreads();   // P is complete

    for (int kk = 0; kk < kTileK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(ps + (ty * 4 + i) * kStrideP + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vr = vs + (kk + u) * kDh + tx;
#pragma unroll
        for (int jj = 0; jj < kCols; ++jj) {
          const float vv = vr[16 * jj];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y : u == 2 ? pv[i].z : pv[i].w;
            acc[i][jj] = fmaf(p, vv, acc[i][jj]);
          }
        }
      }
    }
  }

  // rows with no live key: the reference's sentinel value
  int dead = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) dead |= (ty * 4 + i < nq) && m[i] == kNegInf;
  if (__syncthreads_or(dead)) {
    for (int d = t; d < Dh; d += kThreads) {
      float sv = 0.f;
      for (int j = 0; j < Skv; ++j) sv += load_f(vb + (size_t)j * Dh + d);
      vsum[d] = sv / dead_den;
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= nq) continue;
    const bool row_dead = m[i] == kNegInf;
    const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) {
      const int d = tx + 16 * jj;
      if (d < Dh) store_f(ob + (size_t)r * Dh + d, row_dead ? vsum[d] : acc[i][jj] * inv_l);
    }
  }
}

template <typename T, int kDh>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Hq,
                   int Hkv, int Sq, int Skv, int Dh, int causal, int kv_len, int window,
                   int q_offset, float dead_den, cudaStream_t stream, size_t* opted) {
  const size_t smem = smem_floats<kDh>() * sizeof(float);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  // Opt in to the dynamic shared memory once per device (the attribute
  // belongs to the current device, the one the launch goes to: the wrapper
  // makes the tensors' device current first).
  if (smem > 48 * 1024 && opted[dev] < smem) {
    ++g_attribute_sets;
    err = cudaFuncSetAttribute(flash_fwd_kernel<T, kDh>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    opted[dev] = smem;
  }
  const dim3 grid((Sq + kTileQ - 1) / kTileQ, B * Hq);
  const float scale = (float)(1.0 / sqrt((double)Dh));
  flash_fwd_kernel<T, kDh><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Hq, Hkv, Sq, Skv, Dh, causal, kv_len, window, q_offset, scale,
      dead_den);
  return cudaGetLastError();
}

// The float32-pipe kernel at Dh bucketed to 64, 128 or 256.
template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int B, int Hq,
                     int Hkv, int Sq, int Skv, int Dh, int causal, int kv_len, int window,
                     int q_offset, float dead_den, cudaStream_t stream,
                     size_t (*opted)[kMaxDevices]) {
  if (Dh <= 64)
    return launch<T, 64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, Dh, causal, kv_len, window,
                         q_offset, dead_den, stream, opted[0]);
  if (Dh <= 128)
    return launch<T, 128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, Dh, causal, kv_len, window,
                          q_offset, dead_den, stream, opted[1]);
  return launch<T, 256>(q, k, v, o, B, Hq, Hkv, Sq, Skv, Dh, causal, kv_len, window,
                        q_offset, dead_den, stream, opted[2]);
}

// ---------------------------------------------------------------------------
// bf16 path: wgmma on tensor maps loaded by TMA (see the header).
// ---------------------------------------------------------------------------

constexpr int kBlockM = 128;             // query rows per CTA: two consumer warpgroups
constexpr int kWgThreads = 128;
constexpr int kCtaThreads = 3 * kWgThreads;
constexpr int kSwizzleRow = 128;         // bytes of one swizzled row: 64 bf16 columns
constexpr int kBoxCols = 64;

template <int kDh>
struct Cfg {
  static constexpr int kBlockN = kDh == 256 ? 64 : 128;   // keys per stage
  static constexpr int kStages = kDh == 64 ? 4 : 2;
  static constexpr int kBoxes = kDh / kBoxCols;           // 64-column boxes per row
  static constexpr int kQBox = kBlockM * kSwizzleRow;     // bytes of one box of Q
  static constexpr int kKBox = kBlockN * kSwizzleRow;     // of one box of K or V
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kKVBytes = kBoxes * kKBox;         // K (or V) of one stage
  static constexpr int kOffK = kQBytes;
  static constexpr int kOffV = kOffK + kStages * kKVBytes;
  // Persistent (one CTA per SM walking tiles) where O has a staging buffer
  // of its own; at Dh = 256 it would not fit, so each CTA takes one tile and
  // stages O in Q's buffer.
  static constexpr bool kPersist = kDh <= 128;
  static constexpr int kOffO = kPersist ? kOffV + kStages * kKVBytes : 0;
  static constexpr int kOffBar = kPersist ? kOffO + kQBytes : kOffV + kStages * kKVBytes;
  static constexpr int kBars = 2 + 4 * kStages;   // q_full, q_empty; k/v_full, k/v_empty
  static constexpr int kOffVsum = kOffBar + ((kBars * 8 + 15) / 16) * 16;
  static constexpr int kSmem = kOffVsum + 2 * kDh * 4 + 1024;   // + alignment slack
  static_assert(kSmem <= (int)kSmemLimit, "shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: a 3-D box of `map` at (c0, c1, c2) into shared memory, counted on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0, int c1,
                                          int c2) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::
                   "l"(reinterpret_cast<uint64_t>(map)),
               "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
               : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across a
// wgmma wait: the registers are written asynchronously.
template <int kN>
__device__ __forceinline__ void reg_fence(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int kN>
__device__ __forceinline__ void reg_fence(uint32_t (&d)[kN][4]) {
#pragma unroll
  for (int i = 0; i < kN; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(d[i][e])::"memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled tile (rows of 128
// bytes, 8-row groups 1024 bytes apart). K-major operands advance the start
// by 32 bytes per 16-column step inside the row; for the MN-major V the
// leading offset is the stride between 64-column boxes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lead_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lead_bytes >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Named barriers over the 256 consumer threads: one warpgroup arrives,
// the other waits for it.
__device__ __forceinline__ void pair_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

// Named barrier and OR-reduction over the 128 threads of one warpgroup.
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ bool wg_any(bool pred, int id) {
  uint32_t out;
  asm volatile(
      "{\n.reg .pred p, q;\n"
      "setp.ne.u32 p, %1, 0;\n"
      "bar.red.or.pred q, %2, 128, p;\n"
      "selp.u32 %0, 1, 0, q;\n}\n"
      : "=r"(out)
      : "r"(static_cast<uint32_t>(pred)), "r"(id)
      : "memory");
  return out != 0;
}

// d (+)= A B: A (64 x 16) and B (16 x 64) from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

// d (+)= A B: A (64 x 16) and B (16 x 128) from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

// d += A B: A (64 x 16) from registers, B (16 x 64) from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


// d += A B: A (64 x 16) from registers, B (16 x 128) from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A B: A (64 x 16) from registers, B (16 x 256) from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  wgmma_ss_n64(d, a, b, acc);
}
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int acc) {
  wgmma_ss_n128(d, a, b, acc);
}

// Issue S = Q K^T for one warpgroup's 64 rows and one stage of keys.
template <int kDh>
__device__ __forceinline__ void issue_qk(float (&s)[Cfg<kDh>::kBlockN / 2], uint32_t q_addr,
                                         uint32_t k_addr) {
  using C = Cfg<kDh>;
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk) {
    const uint32_t box = kk >> 2, off = (kk & 3) * 32;
    wgmma_ss(s, smem_desc(q_addr + box * C::kQBox + off, 16),
             smem_desc(k_addr + box * C::kKBox + off, 16), kk > 0);
  }
}

// Issue O += P V for one stage of keys: 16 keys per step.
template <int kDh>
__device__ __forceinline__ void issue_pv(float (&o)[Cfg<kDh>::kBoxes][32],
                                         const uint32_t (&p)[Cfg<kDh>::kBlockN / 16][4],
                                         uint32_t v_addr) {
  using C = Cfg<kDh>;
#pragma unroll
  for (int kk = 0; kk < C::kBlockN / 16; ++kk) {
    const uint64_t desc = smem_desc(v_addr + kk * 16 * kSwizzleRow, C::kKBox);
    // one wgmma over every column: the 64-column boxes are its leading-offset steps
    if constexpr (kDh == 64) wgmma_rs_n64(o[0], p[kk], desc);
    if constexpr (kDh == 128) wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&o[0][0]), p[kk], desc);
    if constexpr (kDh == 256) wgmma_rs_n256(*reinterpret_cast<float(*)[128]>(&o[0][0]), p[kk], desc);
  }
}

// A consumer thread's two rows (r0 and r0 + 8 of its warpgroup): query
// positions, running max and sum.
struct Rows {
  int qp0, qp1, qp_lo, qp_hi, qd;
  float m0, m1, l0, l1;
};

// One tile of scores: mask it where some (row, key) of the warpgroup's
// block is not live, update the running max and sum, and leave the
// exponentials in s and the factors c0, c1 that rescale the accumulator rows.
template <int kN>
__device__ __forceinline__ void softmax_tile(float (&s)[kN / 2], Rows& r, int kp0, int causal,
                                             int kv_len, int window, float scale_log2,
                                             float& c0, float& c1) {
  const bool full = kp0 + kN <= kv_len && (!causal || kp0 + kN - 1 <= r.qp_lo) &&
                    (window <= 0 || r.qp_hi - kp0 < window);
  if (!full) {
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) {
      const int kp = kp0 + (i >> 2) * 8 + 2 * r.qd + (i & 1);
      const int qp = (i & 2) ? r.qp1 : r.qp0;
      const bool live =
          kp < kv_len && (!causal || kp <= qp) && (window <= 0 || qp - kp < window);
      if (!live) s[i] = kNegInf;
    }
  }
  // a row's four lanes (a quad) hold its scores
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int i = 0; i < kN / 2; i += 4) {
    mx0 = fmaxf(mx0, fmaxf(s[i], s[i + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[i + 2], s[i + 3]));
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(r.m0, mx0), mn1 = fmaxf(r.m1, mx1);
  c0 = ex2((r.m0 - mn0) * scale_log2);
  c1 = ex2((r.m1 - mn1) * scale_log2);
  r.m0 = mn0;
  r.m1 = mn1;
  // A row with no live key so far gets p = 0: fma(-1e30, x, 1e30 x) is the
  // product's rounding error, which can overflow exp2. Such a row is either
  // rescaled by 0 once a live key comes, or written as a dead row.
  const float b0 = mn0 == kNegInf ? 0.f : mn0 * scale_log2;
  const float b1 = mn1 == kNegInf ? 0.f : mn1 * scale_log2;
  float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
  for (int i = 0; i < kN / 2; i += 4) {
    s[i] = ex2(fmaf(s[i], scale_log2, -b0));
    s[i + 1] = ex2(fmaf(s[i + 1], scale_log2, -b0));
    s[i + 2] = ex2(fmaf(s[i + 2], scale_log2, -b1));
    s[i + 3] = ex2(fmaf(s[i + 3], scale_log2, -b1));
    ls0 += s[i] + s[i + 1];
    ls1 += s[i + 2] + s[i + 3];
  }
  r.l0 = r.l0 * c0 + ls0;
  r.l1 = r.l1 * c1 + ls1;
}

// P in bf16 as the A operand of P V: 16 keys per fragment of four registers
// (the m64nNk16 accumulator's layout is the A layout of two key blocks).
template <int kN>
__device__ __forceinline__ void to_bf16(const float (&s)[kN / 2], uint32_t (&p)[kN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kN / 16; ++kk) {
    p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// A ring position: stage index and the parity of its current phase.
struct Ring {
  int stage = 0, phase = 0;
  template <int kStages>
  __device__ __forceinline__ void advance() {
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// The work of one query tile: its position and the KV tiles it reads.
struct Tile {
  int bh, bkv, q0, kt_first, kt_end;
};

template <int kBlockN>
__device__ __forceinline__ Tile tile_at(int t, int BH, int q_tiles, int Hq, int Hkv, int Sq,
                                        int causal, int kv_len, int window, int q_offset) {
  Tile tile;
  // heads vary fastest (neighbours share kv heads in L2); causal grids take
  // the query tiles with the most KV tiles first
  const int qi = t / BH;
  tile.bh = t - qi * BH;
  const int b = tile.bh / Hq, h = tile.bh - b * Hq;
  tile.bkv = b * Hkv + h / (Hq / Hkv);
  tile.q0 = (causal ? q_tiles - 1 - qi : qi) * kBlockM;
  const int nq = min(kBlockM, Sq - tile.q0);
  // live keys of the tile's rows lie in [k_lo, k_hi)
  const int qp_first = q_offset + tile.q0, qp_last = qp_first + nq - 1;
  int k_hi = kv_len;
  if (causal) k_hi = min(k_hi, qp_last + 1);
  const int k_lo = window > 0 ? max(0, qp_first - window + 1) : 0;
  tile.kt_first = k_lo / kBlockN;
  tile.kt_end = k_hi > k_lo ? (k_hi + kBlockN - 1) / kBlockN : tile.kt_first;
  return tile;
}

template <int kDh>
__global__ void __launch_bounds__(kCtaThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_o,
                       const __nv_bfloat16* __restrict__ v,
                       int BH, int q_tiles, int Hq, int Hkv, int Sq, int Skv, int Dh,
                       int causal, int kv_len, int window, int q_offset, float scale_log2,
                       float dead_den) {
  using C = Cfg<kDh>;
  constexpr int kBlockN = C::kBlockN, kStages = C::kStages, kBoxes = C::kBoxes;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on that boundary
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;
  uint8_t* ks = smem + C::kOffK;
  uint8_t* vs = smem + C::kOffV;
  uint8_t* os = smem + C::kOffO;   // O's staging buffer, laid out as Q's
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::kOffBar);
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_empty + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;
  float* vsum = reinterpret_cast<float*>(smem + C::kOffVsum);
  const int n_tiles = BH * q_tiles;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 2 * kWgThreads / 32);   // one arrival per consumer warp
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, 2 * kWgThreads / 32);
      mbar_init(v_empty + s, 2 * kWgThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < kWgThreads) {
    // ---- producer warpgroup: one thread keeps the TMA loads in flight ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      Ring ring;
      int round = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++round) {
        const Tile tile = tile_at<kBlockN>(t, BH, q_tiles, Hq, Hkv, Sq, causal, kv_len, window,
                                           q_offset);
        mbar_wait(q_empty, (round & 1) ^ 1);   // the previous tile's last S is done
        mbar_expect_tx(q_full, C::kQBytes);
        for (int j = 0; j < kBoxes; ++j)
          tma_load(qs + j * C::kQBox, &tm_q, q_full, j * kBoxCols, tile.q0, tile.bh);
        for (int kt = tile.kt_first; kt < tile.kt_end; ++kt) {
          const int off = ring.stage * C::kKVBytes;
          mbar_wait(k_empty + ring.stage, ring.phase ^ 1);   // the first pass is free
          mbar_expect_tx(k_full + ring.stage, C::kKVBytes);
          for (int j = 0; j < kBoxes; ++j)
            tma_load(ks + off + j * C::kKBox, &tm_k, k_full + ring.stage, j * kBoxCols,
                     kt * kBlockN, tile.bkv);
          mbar_wait(v_empty + ring.stage, ring.phase ^ 1);
          mbar_expect_tx(v_full + ring.stage, C::kKVBytes);
          for (int j = 0; j < kBoxes; ++j)
            tma_load(vs + off + j * C::kKBox, &tm_v, v_full + ring.stage, j * kBoxCols,
                     kt * kBlockN, tile.bkv);
          ring.advance<kStages>();
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows of each tile each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = threadIdx.x / kWgThreads - 1;
    const int tid = threadIdx.x % kWgThreads;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, qd = lane & 3;
    const int r0 = warp * 16 + g;             // this thread's rows: r0 and r0 + 8
    const uint32_t q_addr = smem_u32(qs) + cw * 64 * kSwizzleRow;
    const uint32_t k_base = smem_u32(ks), v_base = smem_u32(vs);
    float* vsum_wg = vsum + cw * kDh;
    float o[kBoxes][32];
    auto rescale = [&](float c0, float c1) {
#pragma unroll
      for (int j = 0; j < kBoxes; ++j)
#pragma unroll
        for (int i = 0; i < 32; i += 4) {
          o[j][i] *= c0;
          o[j][i + 1] *= c0;
          o[j][i + 2] *= c1;
          o[j][i + 3] *= c1;
        }
    };
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // The two consumer warpgroups take turns to issue their products
    // (named barriers 3 and 4), so one's softmax runs under the other's
    // wgmma; warpgroup 1 lets warpgroup 0 go first.
    auto my_turn = [&] { pair_sync(3 + cw); };
    auto your_turn = [&] { pair_arrive(4 - cw); };
    if (cw == 1) pair_arrive(3);

    Ring kr, vr;
    int round = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++round) {
      const Tile tile = tile_at<kBlockN>(t, BH, q_tiles, Hq, Hkv, Sq, causal, kv_len, window,
                                         q_offset);
      const int row0 = tile.q0 + cw * 64;     // the warpgroup's first row in the head
      Rows rows;
      rows.qd = qd;
      rows.qp_lo = q_offset + row0;
      rows.qp_hi = rows.qp_lo + 63;
      rows.qp0 = rows.qp_lo + r0;
      rows.qp1 = rows.qp0 + 8;
      rows.m0 = rows.m1 = kNegInf;
      rows.l0 = rows.l1 = 0.f;
#pragma unroll
      for (int j = 0; j < kBoxes; ++j)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[j][i] = 0.f;

      mbar_wait(q_full, round & 1);
      if (tile.kt_end > tile.kt_first) {
        // Software pipeline: the tensor cores compute S of KV tile t and
        // then O += P V of tile t - 1 while the warpgroup waits only for S
        // and runs tile t's softmax under the P V product. P of tile t is
        // rounded into the A registers once that product is done.
        float s[kBlockN / 2], c0, c1;
        uint32_t p[kBlockN / 16][4];
        mbar_wait(k_full + kr.stage, kr.phase);
        my_turn();
        wgmma_fence();
        issue_qk<kDh>(s, q_addr, k_base + kr.stage * C::kKVBytes);
        wgmma_commit();
        your_turn();
        wgmma_wait<0>();
        reg_fence(s);
        release(k_empty + kr.stage);
        kr.advance<kStages>();
        softmax_tile<kBlockN>(s, rows, tile.kt_first * kBlockN, causal, kv_len, window,
                              scale_log2, c0, c1);
        to_bf16<kBlockN>(s, p);
        for (int kt = tile.kt_first + 1; kt < tile.kt_end; ++kt) {
          mbar_wait(k_full + kr.stage, kr.phase);
          my_turn();
          wgmma_fence();
          issue_qk<kDh>(s, q_addr, k_base + kr.stage * C::kKVBytes);
          wgmma_commit();
          rescale(c0, c1);
          mbar_wait(v_full + vr.stage, vr.phase);
          wgmma_fence();
          issue_pv<kDh>(o, p, v_base + vr.stage * C::kKVBytes);
          wgmma_commit();
          your_turn();
          wgmma_wait<1>();   // S of this KV tile; P V may still run
          reg_fence(s);
          release(k_empty + kr.stage);
          kr.advance<kStages>();
          softmax_tile<kBlockN>(s, rows, kt * kBlockN, causal, kv_len, window, scale_log2, c0,
                                c1);
          wgmma_wait<0>();
#pragma unroll
          for (int j = 0; j < kBoxes; ++j) reg_fence(o[j]);
          reg_fence(p);
          release(v_empty + vr.stage);
          vr.advance<kStages>();
          to_bf16<kBlockN>(s, p);
        }
        release(q_empty);    // every S of this tile is done: the producer may load the next Q
        rescale(c0, c1);
        mbar_wait(v_full + vr.stage, vr.phase);
        wgmma_fence();
        issue_pv<kDh>(o, p, v_base + vr.stage * C::kKVBytes);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int j = 0; j < kBoxes; ++j) reg_fence(o[j]);
        release(v_empty + vr.stage);
        vr.advance<kStages>();
      } else {
        release(q_empty);
      }

      // the row sums were kept per lane; add the quad's
      float l0 = rows.l0, l1 = rows.l1;
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      const bool ok0 = row0 + r0 < Sq, ok1 = row0 + r0 + 8 < Sq;
      const bool dead0 = ok0 && rows.m0 == kNegInf, dead1 = ok1 && rows.m1 == kNegInf;
      if (wg_any(dead0 || dead1, 1 + cw)) {
        const __nv_bfloat16* vb = v + (size_t)tile.bkv * Skv * Dh;
        for (int d = tid; d < Dh; d += kWgThreads) {
          float sv = 0.f;
          for (int j = 0; j < Skv; ++j) sv += __bfloat162float(vb[(size_t)j * Dh + d]);
          vsum_wg[d] = sv / dead_den;
        }
        wg_sync(1 + cw);
      }
      // O into the warpgroup's 64 rows of the staging buffer, in the tensor
      // map's swizzled layout, then out by TMA, which clips rows past Sq and
      // columns past Dh. The buffer is reused once the last tile's store has
      // read it.
      if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      wg_sync(1 + cw);
      const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
      uint8_t* o_tile = os + cw * 64 * kSwizzleRow;
#pragma unroll
      for (int j = 0; j < kBoxes; ++j)
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          const int c = j * kBoxCols + nb * 8 + 2 * qd;
          const uint32_t lo = dead0 ? pack_bf16(vsum_wg[c], vsum_wg[c + 1])
                                    : pack_bf16(o[j][4 * nb] * inv0, o[j][4 * nb + 1] * inv0);
          const uint32_t hi = dead1 ? pack_bf16(vsum_wg[c], vsum_wg[c + 1])
                                    : pack_bf16(o[j][4 * nb + 2] * inv1, o[j][4 * nb + 3] * inv1);
          uint8_t* at = o_tile + j * C::kQBox + ((nb ^ g) << 4) + qd * 4;
          *reinterpret_cast<uint32_t*>(at + r0 * kSwizzleRow) = lo;
          *reinterpret_cast<uint32_t*>(at + (r0 + 8) * kSwizzleRow) = hi;
        }
      // generic-proxy writes, then the async proxy (TMA) reads them
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wg_sync(1 + cw);
      if (tid == 0 && row0 < Sq) {
        for (int j = 0; j < kBoxes; ++j)
          tma_store(&tm_o, o_tile + j * C::kQBox, j * kBoxCols, row0, tile.bh);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
    // shared memory must outlive the last store's read of it
    if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

cudaError_t encode_fn(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (!cached) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || !ptr) return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(ptr);
  }
  *fn = cached;
  return cudaSuccess;
}

// A 3-D map (Dh, rows, heads) of a contiguous bf16 (heads, rows, Dh) array,
// read in boxes of 64 columns x box_rows rows of one head, 128-byte swizzle,
// zeros outside. Returns 0 or kEncodeError + the CUresult.
int make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int Dh, int rows, int heads,
             int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)Dh, (cuuint64_t)rows, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)Dh * 2, (cuuint64_t)rows * Dh * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kBoxCols, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
                              dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(res);
}

template <int kDh>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv,
                 int Sq, int Skv, int Dh, int causal, int kv_len, int window, int q_offset,
                 float dead_den, cudaStream_t stream, size_t* opted) {
  using C = Cfg<kDh>;
  const int q_tiles = (Sq + kBlockM - 1) / kBlockM;
  EncodeTiled encode = nullptr;
  cudaError_t err = encode_fn(&encode);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  int bad = make_map(encode, &tm_q, q, Dh, Sq, B * Hq, kBlockM);
  if (!bad) bad = make_map(encode, &tm_k, k, Dh, Skv, B * Hkv, C::kBlockN);
  if (!bad) bad = make_map(encode, &tm_v, v, Dh, Skv, B * Hkv, C::kBlockN);
  if (!bad) bad = make_map(encode, &tm_o, o, Dh, Sq, B * Hq, 64);
  if (bad) return bad;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  static int sms[kMaxDevices] = {};
  if (!sms[dev]) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (opted[dev] < (size_t)C::kSmem) {
    ++g_attribute_sets;
    err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<kDh>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted[dev] = C::kSmem;
  }
  // persistent: one CTA per SM, each walking the tiles heavy-first
  const long long tiles = (long long)B * Hq * q_tiles;
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (int)(C::kPersist && tiles > sms[dev] ? sms[dev] : tiles);
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)Dh));
  flash_fwd_wgmma_kernel<kDh><<<grid, kCtaThreads, C::kSmem, stream>>>(
      tm_q, tm_k, tm_v, tm_o, static_cast<const __nv_bfloat16*>(v),
      B * Hq, q_tiles, Hq, Hkv, Sq, Skv, Dh, causal, kv_len, window, q_offset, scale_log2,
      dead_den);
  return static_cast<int>(cudaGetLastError());
}


// The kernel a call takes: 1 for the wgmma kernel, 0 for the float32 pipe.
int route(int bf16, int Dh, const void* q, const void* k, const void* v, const void* o) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) &
                        15) == 0;
  return bf16 && Dh % 8 == 0 && Dh <= 256 && aligned;
}

}  // namespace

extern "C" {

const char* flash_error_string(int err) {
  if (err >= kEncodeError) {
    static thread_local char msg[96];
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled failed (CUresult %d)", err - kEncodeError);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory (bytes) a launch at head width Dh requests from the
// kernel `route` numbers (1 the wgmma kernel, 0 the float32 pipe), and its
// threads a block in *threads; -1 for a Dh outside 1..256.
int flash_smem_bytes(int route, int Dh, int* threads) {
  if (Dh < 1 || Dh > 256) return -1;
  if (threads != nullptr) *threads = route ? kCtaThreads : kThreads;
  if (route) return Dh <= 64 ? Cfg<64>::kSmem : Dh <= 128 ? Cfg<128>::kSmem : Cfg<256>::kSmem;
  const size_t floats = Dh <= 64 ? smem_floats<64>() : Dh <= 128 ? smem_floats<128>()
                                                                  : smem_floats<256>();
  return static_cast<int>(floats * sizeof(float));
}

// cudaFuncSetAttribute calls this library has made.
int flash_attribute_sets(void) { return g_attribute_sets.load(); }

// The largest head width one launch takes.
int flash_max_head_dim(void) { return 256; }

// 1 if flash_attention_fwd with these arguments launches the wgmma kernel,
// 0 if the float32-pipe kernel.
int flash_route(int bf16, int Dh, const void* q, const void* k, const void* v, const void* o) {
  return route(bf16, Dh, q, k, v, o);
}

// q (B,Hq,Sq,Dh), k/v (B,Hkv,Skv,Dh) -> o (B,Hq,Sq,Dh); bf16 != 0 for
// __nv_bfloat16 operands, else float32. Sq, Skv >= 1; 1 <= Dh <= 256;
// Hq % Hkv == 0; 0 <= kv_len <= Skv; window >= 0 (0 = no window);
// q_offset >= 0; dead_den > 0.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int bf16,
                        int B, int Hq, int Hkv, int Sq, int Skv, int Dh, int causal,
                        int kv_len, int window, int q_offset, float dead_den,
                        void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv || Sq < 1 || Skv < 1 || Dh < 1 ||
      Dh > 256 || kv_len < 0 || kv_len > Skv || window < 0 || q_offset < 0 ||
      !(dead_den > 0.f) || (long long)B * Hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // shared memory opted in, per kernel instantiation and device: rows 0-2
  // the wgmma kernel, 3-5 the float32 pipe on float, 6-8 on bf16
  static size_t opted[9][kMaxDevices] = {};
  if (route(bf16, Dh, q, k, v, o)) {
    if (Dh <= 64)
      return launch_wgmma<64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, Dh, causal, kv_len, window,
                              q_offset, dead_den, s, opted[0]);
    if (Dh <= 128)
      return launch_wgmma<128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, Dh, causal, kv_len, window,
                               q_offset, dead_den, s, opted[1]);
    return launch_wgmma<256>(q, k, v, o, B, Hq, Hkv, Sq, Skv, Dh, causal, kv_len, window,
                             q_offset, dead_den, s, opted[2]);
  }
  const cudaError_t err =
      bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, Dh, causal, kv_len,
                                     window, q_offset, dead_den, s, opted + 6)
           : dispatch<float>(q, k, v, o, B, Hq, Hkv, Sq, Skv, Dh, causal, kv_len, window,
                             q_offset, dead_den, s, opted + 3);
  return static_cast<int>(err);
}

}  // extern "C"
