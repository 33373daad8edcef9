// Flash-attention forward kernel for Hopper (sm_90a): the LM prefill's
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
// contiguous, float32 or bf16 (each element is upcast as it is loaded;
// nothing is accumulated in bf16). Query head h reads kv head
// h / (Hq / Hkv) directly: the GQA repeat is never materialized, which cuts
// K/V traffic by Hq / Hkv.
//
// A row with no live key keeps the reference's sentinel semantics: there
// every score is -1e30, exp(-1e30 - (-1e30)) = 1, and the reference's
// chunks add every key's v (its zero padding included) with weight 1. So
// such a row gets sum_{j < Skv} v_j / dead_den, where the caller passes
// dead_den = Skv rounded up to the reference's chunk size. The kernel
// detects such rows (m still -1e30 after its tiles) and writes that value.
//
// Bound on an H100 at the served prefill (B = 4, Hq = 32, Hkv = 8, S = 2048,
// Dh = 128, bf16, causal): operations. 4 Dh flops per live (query, key)
// pair, 137 GFLOP, take 0.14 ms at the 989 TFLOP/s bf16 tensor-core rate;
// q, k, v and o are 100 MB, 0.03 ms at 3.35 TB/s. Two kernels share the
// masks, the tiling and the treatment of dead rows:
//   * bf16 with Dh % 8 == 0 and Dh <= 128 (every served config): the
//     products run on the tensor cores through mma.sync m16n8k16 with float32
//     accumulation (the second half of this file); P is rounded to bf16 for
//     the P V product, as every bf16 flash kernel does.
//   * float32, and bf16 of other widths (up to 256): the products run on the
//     float32 pipe (67 TFLOP/s), each element upcast as it is loaded.
// What both designs do:
//   * one CTA per (b*Hq + h, 64-row query tile); Q's tile and each 64-key K/V
//     tile are staged in shared memory, so each K/V element is read from
//     device memory once per query tile.
//   * the running max and sum of a row stay in the registers of the threads
//     that own the row's scores and its output columns, so the correction
//     factor never goes through shared memory.
//   * KV tiles with no live key for any row of the query tile are skipped:
//     above the causal diagonal, before the window, at and past kv_len.
//   * Dh is a run-time value up to 256, bucketed to 64, 128 or 256 for the
//     register and shared-memory sizes; nothing is padded in device memory,
//     and ragged Sq and Skv tiles are masked in the kernel.
//   * 64-bit offsets throughout.
// wgmma, TMA, cp.async double buffering and warp specialisation are left
// for a later kernel.
//
// Plain C interface for ctypes; every entry point returns a cudaError_t.

#include <cmath>
#include <cstdint>

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

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

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

// ---------------------------------------------------------------------------
// bf16 tensor-core path (mma.sync m16n8k16, float32 accumulation), taken for
// bf16 operands with Dh % 8 == 0 and Dh <= 128.
//
// One CTA of 4 warps per (b*Hq + h, 64-row query tile); warp w owns query
// rows 16 w .. 16 w + 15. Q's tile and each 64-key K/V tile are staged in
// shared memory as bf16 with 16-byte copies (rows padded by 8 elements, so
// the fragment loads below hit 32 distinct banks). S = Q K^T comes from
// mma.sync with Q as the row-major A operand and K's rows as the column-major
// B operand; the running max and sum of a row live in the 4 lanes that hold
// it (quad shuffles); P is rounded to bf16 and fed back as the A operand of
// O += P V straight from the S accumulators (the m16n8 accumulator layout is
// the m16n8k16 A layout of two adjacent key tiles), and V's B fragments come
// transposed from its row-major tile by ldmatrix.trans. The masks, the tile
// skipping and the rows with no live key are those of the float32 kernel.
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;
constexpr int kPadH = 8;   // bf16 elements of row padding

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Stage rows [0, n) of a (rows, dh) bf16 tile into dst (row stride kDh +
// kPadH) with 16-byte copies; columns [dh, kDh) and rows [n, 64) are zeros.
template <int kDh>
__device__ void stage_bf16(const __nv_bfloat16* __restrict__ src, int n, int dh,
                           __nv_bfloat16* dst) {
  constexpr int kChunks = kDh / 8;
  for (int i = threadIdx.x; i < kTileQ * kChunks; i += kMmaThreads) {
    const int r = i / kChunks, c = (i - r * kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < n && c < dh) val = *reinterpret_cast<const uint4*>(src + (size_t)r * dh + c);
    *reinterpret_cast<uint4*>(dst + r * (kDh + kPadH) + c) = val;
  }
}

template <int kDh>
constexpr size_t mma_smem_bytes() {
  return 3 * (size_t)kTileQ * (kDh + kPadH) * sizeof(__nv_bfloat16) + kDh * sizeof(float);
}

template <int kDh>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                     int Hq, int Hkv, int Sq, int Skv, int Dh, int causal, int kv_len,
                     int window, int q_offset, float scale, float dead_den) {
  constexpr int kStride = kDh + kPadH;
  constexpr int kDt = kDh / 8;     // output column tiles of 8
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kTileQ * kStride;
  __nv_bfloat16* vs = ks + kTileK * kStride;
  float* vsum = reinterpret_cast<float*>(vs + kTileK * kStride);

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh - b * Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * kTileQ;
  const int nq = min(kTileQ, Sq - q0);
  const __nv_bfloat16* qb = q + ((size_t)bh * Sq + q0) * Dh;
  const __nv_bfloat16* kb = k + ((size_t)b * Hkv + hk) * (size_t)Skv * Dh;
  const __nv_bfloat16* vb = v + ((size_t)b * Hkv + hk) * (size_t)Skv * Dh;
  __nv_bfloat16* ob = o + ((size_t)bh * Sq + q0) * Dh;

  const int qp_first = q_offset + q0, qp_last = q_offset + q0 + nq - 1;
  int k_hi = kv_len;
  if (causal) k_hi = min(k_hi, qp_last + 1);
  const int k_lo = window > 0 ? max(0, qp_first - window + 1) : 0;
  const int kt_first = k_lo / kTileK;
  const int kt_end = k_hi > k_lo ? (k_hi + kTileK - 1) / kTileK : kt_first;

  // this thread's two rows of the tile: r0 = 16 warp + g and r0 + 8
  const int r0 = warp * 16 + g;
  const int qp0 = qp_first + r0, qp1 = qp0 + 8;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kDt][4];
#pragma unroll
  for (int dt = 0; dt < kDt; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  stage_bf16<kDh>(qb, nq, Dh, qs);

  for (int kt = kt_first; kt < kt_end; ++kt) {
    const int kp0 = kt * kTileK;
    const int nk = min(kTileK, Skv - kp0);
    __syncthreads();
    stage_bf16<kDh>(kb + (size_t)kp0 * Dh, nk, Dh, ks);
    stage_bf16<kDh>(vb + (size_t)kp0 * Dh, nk, Dh, vs);
    __syncthreads();

    float sc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDh / 16; ++kk) {
      const __nv_bfloat16* qr = qs + r0 * kStride + kk * 16 + 2 * tq;
      const unsigned a0 = *reinterpret_cast<const unsigned*>(qr);
      const unsigned a1 = *reinterpret_cast<const unsigned*>(qr + 8 * kStride);
      const unsigned a2 = *reinterpret_cast<const unsigned*>(qr + 8);
      const unsigned a3 = *reinterpret_cast<const unsigned*>(qr + 8 * kStride + 8);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const __nv_bfloat16* kr = ks + (nt * 8 + g) * kStride + kk * 16 + 2 * tq;
        mma_bf16(sc[nt], a0, a1, a2, a3, *reinterpret_cast<const unsigned*>(kr),
                 *reinterpret_cast<const unsigned*>(kr + 8));
      }
    }

    // scale, mask, online softmax over this tile (rows r0 and r0 + 8)
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qp = e < 2 ? qp0 : qp1;
        const int kp = kp0 + nt * 8 + 2 * tq + (e & 1);
        const bool live = kp < kv_len && (!causal || qp >= kp) &&
                          (window <= 0 || qp - kp < window);
        sc[nt][e] = live ? sc[nt][e] * scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
      }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[nt][e] = expf(sc[nt][e] - m[e >> 1]);
        l[e >> 1] += sc[nt][e];
      }
#pragma unroll
    for (int dt = 0; dt < kDt; ++dt) {
      acc[dt][0] *= corr[0];
      acc[dt][1] *= corr[0];
      acc[dt][2] *= corr[1];
      acc[dt][3] *= corr[1];
    }

    // O += P V, 16 keys per step
#pragma unroll
    for (int kk = 0; kk < kTileK / 16; ++kk) {
      const unsigned a0 = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      const unsigned a1 = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      const unsigned a2 = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      const unsigned a3 = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
      // lanes 0-15 address the keys of d tile dt, lanes 16-31 of dt + 1
      const int key = kk * 16 + (lane & 15);
#pragma unroll
      for (int dt = 0; dt < kDt; dt += 2) {
        const int col = (dt + (lane >> 4)) * 8;
        unsigned b0, b1, b2, b3;
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
            : "=r"(b0), "=r"(b1), "=r"(b2), "=r"(b3)
            : "r"(smem_u32(vs + key * kStride + col)));
        mma_bf16(acc[dt], a0, a1, a2, a3, b0, b1);
        mma_bf16(acc[dt + 1], a0, a1, a2, a3, b2, b3);
      }
    }
  }

  // the row sums were kept per lane; add the quad's
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const int dead = (r0 < nq && m[0] == kNegInf) || (r0 + 8 < nq && m[1] == kNegInf);
  if (__syncthreads_or(dead)) {
    for (int d = t; d < Dh; d += kMmaThreads) {
      float sv = 0.f;
      for (int j = 0; j < Skv; ++j) sv += __bfloat162float(vb[(size_t)j * Dh + d]);
      vsum[d] = sv / dead_den;
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= nq) continue;
    const bool row_dead = m[i] == kNegInf;
    const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int dt = 0; dt < kDt; ++dt) {
      const int c = dt * 8 + 2 * tq;
      if (c >= Dh) continue;
      const float v0 = row_dead ? vsum[c] : acc[dt][2 * i] * inv_l;
      const float v1 = row_dead ? vsum[c + 1] : acc[dt][2 * i + 1] * inv_l;
      *reinterpret_cast<unsigned*>(ob + (size_t)r * Dh + c) = pack_bf16(v0, v1);
    }
  }
}

template <int kDh>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, int B, int Hq,
                       int Hkv, int Sq, int Skv, int Dh, int causal, int kv_len, int window,
                       int q_offset, float dead_den, cudaStream_t stream, size_t* opted) {
  const size_t smem = mma_smem_bytes<kDh>();
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && opted[dev] < smem) {
    err = cudaFuncSetAttribute(flash_fwd_mma_kernel<kDh>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    opted[dev] = smem;
  }
  const dim3 grid((Sq + kTileQ - 1) / kTileQ, B * Hq);
  const float scale = (float)(1.0 / sqrt((double)Dh));
  flash_fwd_mma_kernel<kDh><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Hq, Hkv, Sq, Skv,
      Dh, causal, kv_len, window, q_offset, scale, dead_den);
  return cudaGetLastError();
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

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int B, int Hq,
                     int Hkv, int Sq, int Skv, int Dh, int causal, int kv_len, int window,
                     int q_offset, float dead_den, cudaStream_t stream, bool tensor_cores) {
  static size_t opted[5][kMaxDevices] = {};
  if (tensor_cores && Dh <= 64)
    return launch_mma<64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, Dh, causal, kv_len, window,
                          q_offset, dead_den, stream, opted[3]);
  if (tensor_cores)
    return launch_mma<128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, Dh, causal, kv_len, window,
                           q_offset, dead_den, stream, opted[4]);
  if (Dh <= 64)
    return launch<T, 64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, Dh, causal, kv_len, window,
                         q_offset, dead_den, stream, opted[0]);
  if (Dh <= 128)
    return launch<T, 128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, Dh, causal, kv_len, window,
                          q_offset, dead_den, stream, opted[1]);
  return launch<T, 256>(q, k, v, o, B, Hq, Hkv, Sq, Skv, Dh, causal, kv_len, window,
                        q_offset, dead_den, stream, opted[2]);
}

}  // namespace

extern "C" {

const char* flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The largest head width one launch takes.
int flash_max_head_dim(void) { return 256; }

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
  // bf16 rows of whole, aligned 16-byte chunks up to 128 wide go to the
  // tensor cores; float32 (and the rest) to the float32-pipe kernel
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) &
                        15) == 0;
  const bool tensor_cores = bf16 && Dh % 8 == 0 && Dh <= 128 && aligned;
  const cudaError_t err =
      bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, Dh, causal, kv_len,
                                     window, q_offset, dead_den, s, tensor_cores)
           : dispatch<float>(q, k, v, o, B, Hq, Hkv, Sq, Skv, Dh, causal, kv_len, window,
                             q_offset, dead_den, s, false);
  return static_cast<int>(err);
}

}  // extern "C"
