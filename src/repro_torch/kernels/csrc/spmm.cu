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
// once (~2.56 ms at 3.35 TB/s) and does 2 * r flops per 4-byte element
// (4 * r for spmm_ata), far below the fp32 ridge.
//
// spmm and spmm_t (one walk each):
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
//
// spmm_ata (spmm_ata_kernel) is one pass over the payload stack: each slice
// is copied from device memory once for A X and once more, a few bands
// later, for A.T Y, meant to be served by the L2. A form that runs both
// walks reads the 8 GiB stack twice, a floor of 5.13 ms at the cell, twice
// the 2.565 ms one-read bound. Y = A X does not fit on chip (3 MiB at the cell), so the
// product walks bands of rows and reduces each band's Y across the grid:
//   * One persistent CTA per SM (grid = min(n_tc, SMs, 160)), launched
//     cooperatively so that every CTA is resident; a grid that cannot be
//     co-resident fails to launch and the wrapper raises. CTA c owns a
//     contiguous range of tile-cols and keeps A.T Y for them in registers (a
//     partial per warp, added in warp order at the end).
//   * A band is at most 128 rows: one tile-row at 128-row tiles (1,024 bands,
//     a 64 KB slice a CTA at the cell), 128 / bm tile-rows where bm <= 64,
//     row slices where a tile-row is too tall for the ring. The wrapper's
//     schedule lists each CTA's slices ("pieces") of each band in (tile-col,
//     tile-row) order.
//   * Warp roles: 8 consumer warps; a producer that bulk-copies (cp.async.bulk,
//     mbarrier completion) each band's pieces into F slots of a shared-memory
//     ring, a band ahead; a T producer that copies them again into T slots
//     2 lag bands later (the F copies carry an L2 evict_last hint, the T
//     copies evict_first, so that T's copies are meant to hit the L2: about
//     40 MB of slices are in flight at the cell against a 50 MB L2, and the
//     hit rate is not measured); a signal warp; an arrive warp.
//   * Consumer iteration t: T of band t - 2 lag, F of band t, R of band t -
//     lag. F: each slice scaled as read (scale4, the materialized operator's
//     multiply order, so lazy and materialized scales give the same bits),
//     its products with X summed over the lanes by a reduce-scatter and a
//     butterfly into the band's partial. R: this CTA's 1/grid share (16-byte
//     units) of band t - lag's Y, summed over every CTA's partial in a fixed
//     order. T: A_b.T Y_b into the registers. Only shared memory: the arrive
//     warp publishes each partial and Y share (coalesced stores, a fence,
//     then an add to the band's counter), and the signal warp, once every CTA
//     is past iteration t - lag, gathers what iteration t reads (R's share of
//     every partial, T's Y and row scales) a whole iteration ahead.
//   * The grid-wide wait is on work lag = 2 iterations old (kLag); counters are
//     zeroed by the wrapper, one per band, so nothing is reset inside the
//     launch. No atomics on data; every sum runs in a fixed order, so runs
//     repeat bit for bit. With the Gram, each CTA forms out.T out over its
//     rows and gram_reduce_kernel adds the CTAs' partials in CTA order.
//   * What holds it above the bound is latency, not bytes: each band passes
//     a chain of waits (copies, the grid-wide counter, the gathers) that the
//     consumers' work of one band hides only in part (PERF.md, section 6).
//     At that speed, whether T's copies come from the L2 or from device
//     memory did not change the time, so the gain over the two-walk form is
//     not shown to come from the single read.
//   * Offsets into blocks are 64-bit: the stack holds 2^31 elements at the
//     cell.
//
// Plain C interface for ctypes; every entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 8;       // bm <= kWarps * kRowsPerWarp = 128
constexpr int kMaxTile = 128;         // bk <= 32 lanes * 4 columns
constexpr int kMaxRN = 8;
constexpr int kReduceThreads = 256;
constexpr int kMaxDevices = 64;

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

// Gram stage 2: the chunk partials added in chunk order.
__global__ void gram_reduce_kernel(const float* __restrict__ part, int r, int chunks,
                                   float* __restrict__ gram) {
  for (int e = threadIdx.x; e < r * r; e += blockDim.x) {
    float s = part[e];
    for (int ch = 1; ch < chunks; ++ch) s = __fadd_rn(s, part[(size_t)ch * r * r + e]);
    gram[e] = s;
  }
}

// ---------------------------------------------------------------------------
// spmm_ata: one pass over the payloads (the design is in the header)
// ---------------------------------------------------------------------------

constexpr int kAtaWarps = 8;                       // consumer warps (up to 168 registers a thread)
constexpr int kAtaConsumers = 32 * kAtaWarps;
constexpr int kProducerWarp = kAtaWarps;           // bulk copies for F (from device memory)
constexpr int kTProducerWarp = kAtaWarps + 1;      // bulk copies for T (the same slices again)
constexpr int kSignalWarp = kAtaWarps + 2;         // polls the band counters, gathers R's and T's inputs
constexpr int kArriveWarp = kAtaWarps + 3;         // publishes partials and Y shares, arrives
constexpr int kAtaThreads = kAtaConsumers + 128;
constexpr int kRingBytes = 192 * 1024;             // the ring of payload slices
constexpr int kMaxSlots = 8;                       // F band slots of the ring
constexpr int kMaxTSlots = 2;                      // T band slots of the ring
constexpr int kMaxPieces = 32;                     // pieces of the ring ((slots + T slots) x cap)
constexpr int kMaxCap = 8;                         // pieces of one band slot
constexpr int kAtaMaxGrid = 160;                   // CTAs (5 partials a lane in R)
constexpr int kBandRows = 128;                     // rows of a band, at most
// Partial and Y slots in device memory. A CTA stores band t's partial before
// it waits for every CTA to be past iteration t - 1 - lag, so a slot comes
// back only after 2 lag + 1 bands; Y needs 2 lag (lag = kLag below).
constexpr int kSlots = 8;
constexpr int kMaxBandsKept = 8;                   // bands between F and T, >= 2 lag + 1
// Bands between a band's F and its R, and again to its T: the grid-wide wait
// is on work kLag iterations old (lag 1, waiting on the band just finished,
// ran slower at the cell).
constexpr int kLag = 2;
static_assert(2 * kLag + 1 <= kSlots && 2 * kLag + 1 <= kMaxBandsKept, "spmm_ata lag");
constexpr int kBandFloats = kBandRows * kMaxRN;    // a band's partial or Y
constexpr int kRbufFloats = 4 * 320;               // R's share of all partials: units x grid <= 320
constexpr unsigned long long kWaitTimeoutNs = 10ull * 1000 * 1000 * 1000;

// Byte offsets into the dynamic shared memory of spmm_ata_kernel; the
// buffers with two halves are used by iterations of either parity.
struct AtaSmem {
  static constexpr int ring = 0;
  static constexpr int bandp = ring + kRingBytes;            // F's partial (also T's flush sums)
  static constexpr int ys = bandp + 4 * kBandFloats;         // T's Y
  static constexpr int xs = ys + 4 * 2 * kBandFloats;
  static constexpr int cs = xs + 4 * kMaxTile * kMaxRN;      // col scales of the staged tile-col
  static constexpr int rs = cs + 4 * kMaxTile;               // row scales: F's three, T's two
  static constexpr int rbuf = rs + 4 * 5 * kBandRows;        // R's share of every partial
  static constexpr int desc = rbuf + 4 * 2 * kRbufFloats;
  static constexpr int tdesc = desc + 16 * kMaxPieces;       // a band's pieces, kept for its T
  static constexpr int slot_n = tdesc + 16 * kMaxBandsKept * kMaxCap;
  static constexpr int slot_p0 = slot_n + 4 * kMaxSlots;
  static constexpr int tmeta = slot_p0 + 4 * kMaxSlots;      // (n, p0) of the kept bands
  static constexpr int done = tmeta + 8 * kMaxBandsKept;     // iterations the consumers are past
  static constexpr int bars = done + 8;   // full[], empty[], tfull[], tempty[], inputs[2]
  static constexpr int total = bars + 8 * (2 * kMaxSlots + 2 * kMaxTSlots + 2);
};
static_assert(AtaSmem::total <= 232448, "spmm_ata shared memory");
static_assert(AtaSmem::bars % 8 == 0 && AtaSmem::rbuf % 16 == 0 && AtaSmem::ys % 16 == 0,
              "alignment");

struct AtaArgs {
  const float* blocks;
  const int4* sched;   // {payload, tile-row, tile-col, 0}: by CTA, band group, tile-col, tile-row
  const int* bptr;     // CTA c's pieces of band group q: sched[bptr[c n_q + q] .. bptr[c n_q + q + 1])
  const float* rs;
  const float* cs;
  const float* x;      // (K, r)
  float* out;          // (K, r)
  float* part;         // (kSlots, grid, es): the CTAs' partials A X of a band
  float* ybuf;         // (kSlots, es): a band's Y
  unsigned* cnt;       // (n_bands + 2 kLag,), zeroed: CTAs past each band
  float* gram_part;    // (grid, r, r), or null
  int M, K, r, c0;
  int n_tr, n_tc, bm, bk;
  int grp, sub, h, n_q, n_bands, nb, tb, cap, es;
};

// Band b: tile-rows i0 .. i0 + grp - 1 (grp > 1 only where sub = 1), rows
// s0 .. s0 + hs - 1 of each.
struct Band {
  int i0, s0, hs;
};

__device__ __forceinline__ Band band_of(const AtaArgs& p, int b) {
  const int q = b / p.sub, s = b - q * p.sub;
  Band B;
  B.i0 = q * p.grp;
  B.s0 = s * p.h;
  B.hs = min(p.bm, B.s0 + p.h) - B.s0;
  return B;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// A wait that outlives kWaitTimeoutNs traps: a fault in the schedule becomes a
// launch error instead of a card that never finishes.
__device__ __forceinline__ void wait_timeout(unsigned long long& t0, unsigned spins) {
  if ((spins & 255u) != 255u) return;
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  if (t0 == 0) t0 = now;
  else if (now - t0 > kWaitTimeoutNs) __trap();
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  unsigned long long t0 = 0;
  for (unsigned spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    wait_timeout(t0, spins);
  }
}

// L2 policies: keep a slice F reads until T's copy of it, drop it after that.
__device__ __forceinline__ uint64_t l2_policy(bool keep) {
  uint64_t policy;
  if (keep)
    asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(policy));
  else
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, counted on bar,
// with an L2 eviction policy.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(__cvta_generic_to_global(src)), "r"(bytes), "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* ptr) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(__cvta_generic_to_global(ptr))
               : "memory");
  return v;
}

// 4 bytes from global to shared without holding a register; waited by
// cp_async_wait_all in the same thread.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)),
               "l"(__cvta_generic_to_global(src))
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(__cvta_generic_to_global(src))
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ unsigned ld_acquire_cta(const unsigned* ptr) {
  unsigned v;
  asm volatile("ld.acquire.cta.shared::cta.u32 %0, [%1];\n" : "=r"(v) : "r"(smem_u32(ptr)) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_cta(unsigned* ptr, unsigned v) {
  asm volatile("st.release.cta.shared::cta.u32 [%0], %1;\n" ::"r"(smem_u32(ptr)), "r"(v) : "memory");
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kAtaConsumers) : "memory");
}

// Chunk m (columns 4m..4m+3) of row a of piece d, whose rows start at s0,
// from device memory, scaled in the materialized operator's multiply order.
__device__ __forceinline__ float4 global_chunk(const AtaArgs& p, int4 d, int s0, int a, int m) {
  float4 v = __ldg(reinterpret_cast<const float4*>(p.blocks + ((size_t)d.x * p.bm + s0 + a) * p.bk) +
                   m);
  if (p.rs != nullptr)
    v = scale4(v, __ldg(p.rs + (size_t)d.y * p.bm + s0 + a),
               __ldg(reinterpret_cast<const float4*>(p.cs + (size_t)d.z * p.bk) + m));
  return v;
}

// X rows of tile-col j, stripe columns c0 .. c0 + RN - 1, as xs[kk RN + c]
// (zero past K and r); with scales also the tile-col's column scales.
template <int RN>
__device__ void stage_x(const AtaArgs& p, int j, float* xs, float* cs_col, int tid) {
  for (int e = tid; e < p.bk * RN; e += kAtaConsumers) {
    const int kk = e / RN, c = e - kk * RN;
    const int row = j * p.bk + kk;
    xs[e] = (row < p.K && p.c0 + c < p.r) ? __ldg(p.x + (size_t)row * p.r + p.c0 + c) : 0.f;
  }
  if (p.rs != nullptr)
    for (int kk = tid; kk < p.bk; kk += kAtaConsumers) cs_col[kk] = __ldg(p.cs + (size_t)j * p.bk + kk);
}

// F, one piece, into bandp: warp w owns rows w + 8q of the slice, lane l
// columns 4l..4l+3, each chunk scaled as read (scale4: the materialized
// operator's bits). For each group of 8 rows the lane's 8 RN products with X
// are summed over the lanes by a reduce-scatter (xor 16, 8, 4: each step keeps
// half the rows) and a butterfly (xor 2, 1), in a fixed order; lane l then
// holds row m = 4 b4 + 2 b3 + b2 (its bits 4, 3, 2) and adds columns l & 3 and
// (l & 3) + 4 to bandp. The lane's q-th row of a group is row q ^ m, so each
// step keeps its low half and sends its high half: no selects. A (row,
// column) of a band belongs to one lane, so pieces of one band need no
// barrier between them. Loads are unconditional (clamped rows and lanes), so
// a group's are all in flight before their use.
template <int RN, bool kRing>
__device__ void f_piece(const AtaArgs& p, float4* piece, int4 d, const Band& B, int C,
                        const float* rs_band, const float* cs_col, const float* xs,
                        float* bandp, int warp, int lane) {
  const bool scaled = p.rs != nullptr, col_ok = lane < C;
  const int lc = min(lane, C - 1);   // loads stay in bounds; lanes past C get zeros
  const float4 csv = scaled ? reinterpret_cast<const float4*>(cs_col)[lc]
                            : make_float4(1.f, 1.f, 1.f, 1.f);
  float x[4][RN];
  {
    const float4* x4 = reinterpret_cast<const float4*>(xs + 4 * lc * RN);
#pragma unroll
    for (int k = 0; k < RN; ++k) {
      const float4 v = col_ok ? x4[k] : make_float4(0.f, 0.f, 0.f, 0.f);
      const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) x[(4 * k + u) / RN][(4 * k + u) % RN] = f[u];
    }
  }
  const int row0 = (d.y - B.i0) * B.hs;
  const int m = (lane >> 2) & 7;   // this lane's row of each group
  for (int a0 = warp; a0 < B.hs; a0 += 8 * kAtaWarps) {
    float4 v[8];   // invalid rows and lanes are zeroed after the loads
    float r[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int a = min(a0 + (q ^ m) * kAtaWarps, B.hs - 1);
      if (kRing) {
        v[q] = piece[a * C + lc];
        r[q] = scaled ? rs_band[row0 + a] : 1.f;
      } else {
        v[q] = a0 + (q ^ m) * kAtaWarps < B.hs && col_ok ? global_chunk(p, d, B.s0, a, lc)
                                                          : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    float acc[8][RN];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      float4 u = kRing ? scale4(v[q], r[q], csv) : v[q];   // exact: x * 1 == x
      if (!(a0 + (q ^ m) * kAtaWarps < B.hs && col_ok)) u = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int c = 0; c < RN; ++c)
        acc[q][c] = fmaf(u.w, x[3][c], fmaf(u.z, x[2][c], fmaf(u.y, x[1][c], u.x * x[0][c])));
    }
    float w1[4][RN], w2[2][RN], w3[RN];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int c = 0; c < RN; ++c)
        w1[q][c] = __fadd_rn(acc[q][c], __shfl_xor_sync(0xffffffffu, acc[q + 4][c], 16));
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int c = 0; c < RN; ++c)
        w2[q][c] = __fadd_rn(w1[q][c], __shfl_xor_sync(0xffffffffu, w1[q + 2][c], 8));
#pragma unroll
    for (int c = 0; c < RN; ++c)
      w3[c] = __fadd_rn(w2[0][c], __shfl_xor_sync(0xffffffffu, w2[1][c], 4));
#pragma unroll
    for (int off = 2; off > 0; off >>= 1)
#pragma unroll
      for (int c = 0; c < RN; ++c) w3[c] = __fadd_rn(w3[c], __shfl_xor_sync(0xffffffffu, w3[c], off));
    const int a = a0 + m * kAtaWarps;
    if (a < B.hs) {
      float* dst = &bandp[(row0 + a) * RN];
#pragma unroll
      for (int c = 0; c < RN; ++c)
        if ((c & 3) == (lane & 3)) dst[c] = __fadd_rn(dst[c], w3[c]);
    }
  }
}

// T, one piece (in the T ring, or for a piece past the ring's cap read from
// device memory), scaled as F scaled it: lane l owns columns 4l..4l+3 of the
// tile-col, warp w rows w + 8q; acc sums over the warp's rows across pieces
// and bands. rs_band holds the band's row scales.
template <int RN, bool kRing>
__device__ void t_piece(const AtaArgs& p, const float4* piece, int4 d, const Band& B, int C,
                        const float* rs_band, const float* ys, float (&acc)[4][RN], int warp,
                        int lane) {
  const int row0 = (d.y - B.i0) * B.hs;
  const bool scaled = p.rs != nullptr, col_ok = lane < C;
  const int lc = min(lane, C - 1);   // loads stay in bounds; lanes past C get zeros
  const float4 csv = scaled ? __ldg(reinterpret_cast<const float4*>(p.cs + (size_t)d.z * p.bk) + lc)
                            : make_float4(1.f, 1.f, 1.f, 1.f);
  for (int a0 = warp; a0 < B.hs; a0 += 8 * kAtaWarps) {
    float4 v[8];
    float r[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int a = min(a0 + q * kAtaWarps, B.hs - 1);
      if (kRing) {
        v[q] = piece[a * C + lc];
        r[q] = scaled ? rs_band[row0 + a] : 1.f;
      } else {
        v[q] = global_chunk(p, d, B.s0, a, lc);
        r[q] = 1.f;
      }
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int a = min(a0 + q * kAtaWarps, B.hs - 1);
      float4 u = scale4(v[q], r[q], kRing ? csv : make_float4(1.f, 1.f, 1.f, 1.f));
      if (!(a0 + q * kAtaWarps < B.hs && col_ok)) u = make_float4(0.f, 0.f, 0.f, 0.f);
      const float* y = ys + (row0 + a) * RN;
#pragma unroll
      for (int c = 0; c < RN; ++c) {
        const float yv = y[c];
        acc[0][c] = fmaf(u.x, yv, acc[0][c]);
        acc[1][c] = fmaf(u.y, yv, acc[1][c]);
        acc[2][c] = fmaf(u.z, yv, acc[2][c]);
        acc[3][c] = fmaf(u.w, yv, acc[3][c]);
      }
    }
  }
}

// The warps' partials of tile-col j added in warp order through `red`, then
// written to out (direct) or added to it; acc starts again at zero.
template <int RN>
__device__ void t_flush(const AtaArgs& p, int j, bool direct, float (&acc)[4][RN], float* red,
                        int warp, int lane, int tid) {
  const int C = p.bk >> 2;
  consumer_sync();
  for (int w = 0; w < kAtaWarps; ++w) {
    if (warp == w && lane < C) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < RN; ++c) {
          float* slot = &red[(4 * lane + jj) * RN + c];
          *slot = w == 0 ? acc[jj][c] : __fadd_rn(*slot, acc[jj][c]);
        }
    }
    consumer_sync();
  }
  for (int e = tid; e < p.bk * RN; e += kAtaConsumers) {
    const int kk = e / RN, c = e - kk * RN;
    const int row = j * p.bk + kk;
    if (row < p.K && p.c0 + c < p.r) {
      float* o = p.out + (size_t)row * p.r + p.c0 + c;
      *o = direct ? red[e] : __fadd_rn(*o, red[e]);
    }
    red[e] = 0.f;   // red is F's partial buffer, which starts from zero
  }
  consumer_sync();
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
#pragma unroll
    for (int c = 0; c < RN; ++c) acc[jj][c] = 0.f;
}

// Until *counter >= want (acquire: what the arriving CTAs wrote before their
// release is visible after it).
__device__ __forceinline__ void spin_count(const unsigned* counter, int want) {
  unsigned long long t0 = 0;
  for (unsigned spins = 0; ld_acquire(counter) < (unsigned)want; ++spins) wait_timeout(t0, spins);
}

// Row scales of band b (its rows are consecutive rows of the matrix) into
// dst by cp.async; nothing without scales or past the last band.
__device__ void fetch_rs(const AtaArgs& p, int b, float* dst, int tid, int nt) {
  if (p.rs == nullptr || b < 0 || b >= p.n_bands) return;
  const Band B = band_of(p, b);
  const long long row0 = (long long)B.i0 * p.bm + B.s0, len = (long long)p.n_tr * p.bm;
  for (int e = tid; e < p.grp * B.hs; e += nt)
    if (row0 + e < len) cp_async4(dst + e, p.rs + row0 + e);
}

// One stripe (columns c0 .. c0 + RN - 1) of out = A.T (A X); with gram_part
// also each CTA's out.T out over its rows, all columns.
template <int RN>
__global__ void __launch_bounds__(kAtaThreads, 1) spmm_ata_kernel(const __grid_constant__ AtaArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  float4* ring = reinterpret_cast<float4*>(smem + AtaSmem::ring);
  float* bandp = reinterpret_cast<float*>(smem + AtaSmem::bandp);
  float* ys = reinterpret_cast<float*>(smem + AtaSmem::ys);
  float* xs = reinterpret_cast<float*>(smem + AtaSmem::xs);
  float* cs_col = reinterpret_cast<float*>(smem + AtaSmem::cs);
  float* rs_s = reinterpret_cast<float*>(smem + AtaSmem::rs);
  float* rbuf = reinterpret_cast<float*>(smem + AtaSmem::rbuf);
  int4* desc = reinterpret_cast<int4*>(smem + AtaSmem::desc);
  int4* tdesc = reinterpret_cast<int4*>(smem + AtaSmem::tdesc);
  int* slot_n = reinterpret_cast<int*>(smem + AtaSmem::slot_n);
  int* slot_p0 = reinterpret_cast<int*>(smem + AtaSmem::slot_p0);
  int2* tmeta = reinterpret_cast<int2*>(smem + AtaSmem::tmeta);
  unsigned* done = reinterpret_cast<unsigned*>(smem + AtaSmem::done);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + AtaSmem::bars);
  uint64_t* empty = full + kMaxSlots;
  uint64_t* tfull = empty + kMaxSlots;
  uint64_t* tempty = tfull + kMaxTSlots;
  uint64_t* inputs = tempty + kMaxTSlots;

  const int cta = blockIdx.x, grid = gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_iter = p.n_bands + 2 * kLag;
  const int C = p.bk >> 2;
  const int piece_f4 = p.h * C;   // float4s of a ring piece
  const int es = p.es, nu = es >> 2;   // floats of a band's partial and Y; its 16-byte units
  // R's units of every band: a contiguous share per CTA
  const int u0 = (int)((long long)cta * nu / grid), u1 = (int)((long long)(cta + 1) * nu / grid);
  float4* tring = ring + (size_t)p.nb * p.cap * piece_f4;

  if (threadIdx.x == 0) {
    for (int k = 0; k < kMaxSlots; ++k) {
      mbar_init(&full[k], 1);
      mbar_init(&empty[k], kAtaWarps);
    }
    for (int k = 0; k < kMaxTSlots; ++k) {
      mbar_init(&tfull[k], 1);
      mbar_init(&tempty[k], kAtaWarps);
    }
    mbar_init(&inputs[0], 32);
    mbar_init(&inputs[1], 32);
    *done = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int e = threadIdx.x; e < kBandFloats; e += kAtaThreads) bandp[e] = 0.f;
  __syncthreads();   // the last barrier of all 12 warps

  if (warp == kProducerWarp) {
    // Band b into F slot b % nb once F of band b - nb has freed it: the bulk
    // copies of its first `cap` pieces on full[slot]. The descriptors are
    // loaded a band ahead (bptr two bands ahead), so their latency overlaps
    // the wait.
    const uint64_t keep = l2_policy(true);
    int p0 = __ldg(p.bptr + (size_t)cta * p.n_q), n = __ldg(p.bptr + (size_t)cta * p.n_q + 1) - p0;
    int4 d = lane < min(n, p.cap) ? __ldg(p.sched + p0 + lane) : make_int4(0, 0, 0, 0);
    const size_t g1 = (size_t)cta * p.n_q + min(1, p.n_bands - 1) / p.sub;
    int p0_next = __ldg(p.bptr + g1), n_next = __ldg(p.bptr + g1 + 1) - p0_next;
    for (int b = 0; b < p.n_bands; ++b) {
      const int slot = b % p.nb;
      const Band B = band_of(p, b);
      const size_t g2 = (size_t)cta * p.n_q + min(b + 2, p.n_bands - 1) / p.sub;
      const int4 d_next =
          lane < min(n_next, p.cap) ? __ldg(p.sched + p0_next + lane) : make_int4(0, 0, 0, 0);
      const int p0_after = __ldg(p.bptr + g2), n_after = __ldg(p.bptr + g2 + 1) - p0_after;
      const int nr = min(n, p.cap);
      if (b >= p.nb) mbar_wait(&empty[slot], ((b / p.nb) - 1) & 1);
      if (lane < nr) desc[slot * p.cap + lane] = d;
      if (lane == 0) {
        slot_n[slot] = n;
        slot_p0[slot] = p0;
      }
      const uint32_t bytes = (uint32_t)B.hs * p.bk * 4;
      __syncwarp();
      if (lane == 0) mbar_arrive_tx(&full[slot], nr * bytes);
      __syncwarp();
      if (lane < nr)
        bulk_load(ring + (size_t)(slot * p.cap + lane) * piece_f4,
                  p.blocks + ((size_t)d.x * p.bm + B.s0) * p.bk, bytes, &full[slot], keep);
      p0 = p0_next, n = n_next, d = d_next;
      p0_next = p0_after, n_next = n_after;
    }
    return;
  }

  if (warp == kTProducerWarp) {
    // Band b's first `cap` pieces again, into T slot b % tb once T of band
    // b - tb has freed it. T of band b runs 2 lag bands after its F, so these
    // copies are meant to find the slices in the L2 (not measured).
    const uint64_t drop = l2_policy(false);
    for (int b = 0; b < p.n_bands; ++b) {
      const int slot = b % p.tb;
      const Band B = band_of(p, b);
      const size_t g = (size_t)cta * p.n_q + b / p.sub;
      const int p0 = __ldg(p.bptr + g), nr = min(__ldg(p.bptr + g + 1) - p0, p.cap);
      const int4 d = lane < nr ? __ldg(p.sched + p0 + lane) : make_int4(0, 0, 0, 0);
      if (b >= p.tb) mbar_wait(&tempty[slot], ((b / p.tb) - 1) & 1);
      const uint32_t bytes = (uint32_t)B.hs * p.bk * 4;
      if (lane == 0) mbar_arrive_tx(&tfull[slot], nr * bytes);
      __syncwarp();
      if (lane < nr)
        bulk_load(tring + (size_t)(slot * p.cap + lane) * piece_f4,
                  p.blocks + ((size_t)d.x * p.bm + B.s0) * p.bk, bytes, &tfull[slot], drop);
    }
    return;
  }

  if (warp == kSignalWarp) {
    // The inputs of consumer iteration t, into the buffers of its parity once
    // every CTA is past iteration t - lag and the consumers are past iteration
    // t - 2 (the last to read those buffers): R's share of every CTA's partial
    // of band t - lag (rbuf[(u - u0) grid + cc] = unit u of CTA cc, float4s),
    // T's Y and row scales of band t - 2 lag; and F's row scales of band
    // t + 1 (three buffers: F of band t - 2 read that one last).
    for (int t = 0; t < n_iter; ++t) {
      const int par = t & 1, bR = t - kLag, bT = t - 2 * kLag;
      if (lane == 0) {
        if (bR >= 0) spin_count(p.cnt + bR, grid);
        unsigned long long t0 = 0;
        for (unsigned spins = 0; t >= 2 && ld_acquire_cta(done) < (unsigned)(t - 1); ++spins)
          wait_timeout(t0, spins);
      }
      __syncwarp();
      if (bR >= 0) ld_acquire(p.cnt + bR);   // every lane acquires what the arrivals released
      ld_acquire_cta(done);
      if (bR >= 0 && bR < p.n_bands) {
        float* rb = rbuf + par * kRbufFloats;
        const float* src = p.part + (size_t)(bR % kSlots) * grid * es;
        for (int e = lane; e < (u1 - u0) * grid; e += 32) {
          const int u = e / grid, cc = e - u * grid;
          cp_async16(rb + 4 * e, src + (size_t)cc * es + 4 * (u0 + u));
        }
      }
      if (bT >= 0) {
        for (int e = lane; e < nu; e += 32)
          cp_async16(ys + par * kBandFloats + 4 * e, p.ybuf + (size_t)(bT % kSlots) * es + 4 * e);
        fetch_rs(p, bT, rs_s + (3 + par) * kBandRows, lane, 32);
      }
      fetch_rs(p, t + 1, rs_s + (t + 1) % 3 * kBandRows, lane, 32);   // F's, a band ahead
      cp_async_wait_all();
      mbar_arrive(&inputs[par]);   // every lane, after its own copies landed
    }
    return;
  }

  if (warp == kArriveWarp) {
    // After consumer iteration t (its partial of band t and Y share of band
    // t - lag are stored by the consumers), fenced, arrive on cnt[t]. Off the
    // consumers' path: they go on to iteration t + 1 meanwhile.
    if (lane == 0)
      for (int t = 0; t < n_iter; ++t) {
        unsigned long long t0 = 0;
        for (unsigned spins = 0; ld_acquire_cta(done) < (unsigned)(t + 1); ++spins)
          wait_timeout(t0, spins);
        __threadfence();
        atomicAdd(p.cnt + t, 1u);
      }
    return;
  }

  // Consumers.
  const int tid = threadIdx.x;
  const int j0 = (int)((long long)cta * p.n_tc / grid);
  const int j1 = (int)((long long)(cta + 1) * p.n_tc / grid);
  const bool one_col = j1 - j0 == 1;
  const long long k0 = (long long)j0 * p.bk, k1 = min((long long)p.K, (long long)j1 * p.bk);
  if (!one_col)   // several tile-cols: their flushes add to out
    for (long long e = tid; e < (k1 - k0) * RN; e += kAtaConsumers) {
      const int c = (int)(e % RN);
      if (p.c0 + c < p.r) p.out[(k0 + e / RN) * p.r + p.c0 + c] = 0.f;
    }
  float tacc[4][RN];
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
#pragma unroll
    for (int c = 0; c < RN; ++c) tacc[jj][c] = 0.f;
  int tj = -1, xj = -1;

  fetch_rs(p, 0, rs_s, tid, kAtaConsumers);   // F's row scales of band 0
  cp_async_wait_all();
  consumer_sync();

  // Iteration t: F of band t (its row scales came with iteration t - 1's
  // inputs), its partial stored at once; then, once iteration t's inputs are
  // in, R of band t - lag (its Y share stored) and T of band t - 2 lag. The
  // arrive warp fences those stores after the iteration, the signal warp
  // brings what the next iteration reads: every wait is on work at least an
  // iteration old.
  for (int t = 0; t < n_iter; ++t) {
    const int par = t & 1;
    const int bF = t < p.n_bands ? t : -1;
    const int bR = (t >= kLag && t - kLag < p.n_bands) ? t - kLag : -1;
    const int bT = t >= 2 * kLag ? t - 2 * kLag : -1;

    if (bF >= 0) {   // F: this CTA's partial of band bF
      const int slot = bF % p.nb;
      const Band B = band_of(p, bF);
      const float* rs_band = rs_s + bF % 3 * kBandRows;
      mbar_wait(&full[slot], (bF / p.nb) & 1);
      const int n = slot_n[slot], p0 = slot_p0[slot];
      const int kept = bF % kMaxBandsKept;   // read by T 2 lag bands later
      if (tid < min(n, p.cap)) tdesc[kept * kMaxCap + tid] = desc[slot * p.cap + tid];
      if (tid == 0) tmeta[kept] = make_int2(n, p0);
      for (int k = 0; k < n; ++k) {
        const bool in_ring = k < p.cap;
        const int4 d = in_ring ? desc[slot * p.cap + k] : __ldg(p.sched + p0 + k);
        float4* piece = ring + (size_t)(slot * p.cap + (in_ring ? k : 0)) * piece_f4;
        if (d.z != xj) {
          consumer_sync();
          stage_x<RN>(p, d.z, xs, cs_col, tid);
          xj = d.z;
          consumer_sync();
        }
        if (in_ring) f_piece<RN, true>(p, piece, d, B, C, rs_band, cs_col, xs, bandp, warp, lane);
        else f_piece<RN, false>(p, piece, d, B, C, rs_band, cs_col, xs, bandp, warp, lane);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);   // this warp is done with the F slot
      consumer_sync();
      float4* src = reinterpret_cast<float4*>(bandp);
      float4* dst = reinterpret_cast<float4*>(p.part + ((size_t)(bF % kSlots) * grid + cta) * es);
      for (int e = tid; e < nu; e += kAtaConsumers) {
        __stcg(dst + e, src[e]);
        src[e] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }

    mbar_wait(&inputs[par], (t >> 1) & 1);

    if (bR >= 0) {   // R: this CTA's units of band bR's Y, over the CTAs in a fixed order
      const Band B = band_of(p, bR);
      const long long row0 = (long long)B.i0 * p.bm + B.s0;
      const int per = (grid + 31) >> 5;   // lane l adds CTAs l per .. l per + per - 1
      for (int u = u0 + warp; u < u1; u += kAtaWarps) {
        const float4* v = reinterpret_cast<const float4*>(rbuf + par * kRbufFloats + 4 * (u - u0) * grid);
        float4 part_v[kAtaMaxGrid / 32];
#pragma unroll
        for (int k = 0; k < kAtaMaxGrid / 32; ++k)   // all loads first (clamped), then the sum
          part_v[k] = v[min(lane * per + k, grid - 1)];
        float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int k = 0; k < kAtaMaxGrid / 32; ++k)
          if (k < per && lane * per + k < grid) {
            sum[0] = __fadd_rn(sum[0], part_v[k].x);
            sum[1] = __fadd_rn(sum[1], part_v[k].y);
            sum[2] = __fadd_rn(sum[2], part_v[k].z);
            sum[3] = __fadd_rn(sum[3], part_v[k].w);
          }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            sum[i] = __fadd_rn(sum[i], __shfl_xor_sync(0xffffffffu, sum[i], off));
        if (lane == 0) {
          float4 yv;
          yv.x = row0 + (4 * u + 0) / RN < p.M ? sum[0] : 0.f;
          yv.y = row0 + (4 * u + 1) / RN < p.M ? sum[1] : 0.f;
          yv.z = row0 + (4 * u + 2) / RN < p.M ? sum[2] : 0.f;
          yv.w = row0 + (4 * u + 3) / RN < p.M ? sum[3] : 0.f;
          __stcg(reinterpret_cast<float4*>(p.ybuf + (size_t)(bR % kSlots) * es) + u, yv);
        }
      }
    }

    if (bT >= 0) {   // T: out += A_b.T Y_b
      const int kept = bT % kMaxBandsKept, slot = bT % p.tb;
      const Band B = band_of(p, bT);
      const float* yb = ys + par * kBandFloats;
      const float* rs_band = rs_s + (3 + par) * kBandRows;
      const float4* tpiece = tring + (size_t)slot * p.cap * piece_f4;
      const int n = tmeta[kept].x, p0 = tmeta[kept].y;
      mbar_wait(&tfull[slot], (bT / p.tb) & 1);
      for (int k = 0; k < n; ++k) {
        const bool in_ring = k < p.cap;
        const int4 d = in_ring ? tdesc[kept * kMaxCap + k] : __ldg(p.sched + p0 + k);
        if (d.z != tj) {
          if (tj >= 0) t_flush<RN>(p, tj, false, tacc, bandp, warp, lane, tid);
          tj = d.z;
        }
        if (in_ring)
          t_piece<RN, true>(p, tpiece + (size_t)k * piece_f4, d, B, C, rs_band, yb, tacc, warp, lane);
        else
          t_piece<RN, false>(p, tpiece, d, B, C, rs_band, yb, tacc, warp, lane);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&tempty[slot]);   // this warp is done with the T slot
    }

    consumer_sync();   // every consumer thread is past iteration t
    if (tid == 0) st_release_cta(done, t + 1);
  }

  if (one_col) t_flush<RN>(p, j0, true, tacc, bandp, warp, lane, tid);
  else if (tj >= 0) t_flush<RN>(p, tj, false, tacc, bandp, warp, lane, tid);
  if (p.gram_part != nullptr) {   // this CTA's rows of out.T out, all r columns, in row order
    consumer_sync();
    for (int e = tid; e < p.r * p.r; e += kAtaConsumers) {
      const int c1 = e / p.r, c2 = e - c1 * p.r;
      float s = 0.f;
#pragma unroll 4
      for (long long row = k0; row < k1; ++row)
        s = fmaf(__ldcg(p.out + row * p.r + c1), __ldcg(p.out + row * p.r + c2), s);
      p.gram_part[(size_t)cta * p.r * p.r + e] = s;
    }
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


// Raise spmm_ata_kernel<RN>'s dynamic shared-memory limit once per device (the
// current one, which the wrapper makes the tensors' device), then launch it
// cooperatively: the launch fails unless every CTA can be resident at once,
// which the kernel's grid-wide waits need.
template <int RN>
cudaError_t launch_ata(const AtaArgs& args, int grid, cudaStream_t s) {
  static bool opted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(spmm_ata_kernel<RN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               AtaSmem::total);
    if (err != cudaSuccess) return err;
    opted[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kAtaThreads);
  cfg.dynamicSmemBytes = AtaSmem::total;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, spmm_ata_kernel<RN>, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
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

// CTAs of spmm_ata on the current device for n_tc tile-cols: one per SM, at
// most one per tile-col (each owns a contiguous range of them); -1 on error.
int spmm_ata_grid(int n_tc) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  const int most = sms < kAtaMaxGrid ? sms : kAtaMaxGrid;
  return n_tc < most ? n_tc : most;
}

// out (K, r) = A.T @ (A @ x) in one pass over the payloads
// (spmm_ata_kernel, one cooperative launch per stripe of 8 columns); with
// gram != null also gram (r, r) = out.T @ out from gram_part (grid, r, r)
// scratch. sched and bptr are the wrapper's schedule for this grid
// and band group grp; part (8, grid, es) and ybuf (8, es) are scratch, es a multiple
// of 4 of at least grp h min(r, 8) floats; cnt (stripes, n_bands + 2 kLag)
// must be zero.
int spmm_ata_f32(const float* blocks, const int* sched, const int* bptr,
                 const float* rs, const float* cs, int n_tr, int n_tc, int bm, int bk,
                 const float* x, int M, int K, int r, float* out, float* part, float* ybuf,
                 unsigned* cnt, float* gram, float* gram_part, int grid, int grp, int sub, int h,
                 int n_q, int n_bands, int nb, int tb, int cap, int es, void* stream) {
  const int rn = stripe_width(r), stripes = (r + rn - 1) / rn;
  const long long nu = es / 4, share = (nu + grid - 1) / grid;
  if (grid < 1 || grid > kAtaMaxGrid || nb < 2 || nb > kMaxSlots || tb < 1 || tb > kMaxTSlots ||
      cap < 1 || cap > kMaxCap || (nb + tb) * cap > kMaxPieces || h < 1 || grp * h > kBandRows ||
      (long long)h * bk * 4 * (nb + tb) * cap > kRingBytes || bm > kMaxTile || bk > kMaxTile ||
      sub < 1 || n_bands != n_q * sub || es % 4 || es < grp * h * rn || es > kBandFloats ||
      share * grid * 4 > kRbufFloats)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_iter = n_bands + 2 * kLag;
  cudaError_t err = cudaSuccess;
  for (int y = 0; y < stripes; ++y) {
    AtaArgs args{blocks, reinterpret_cast<const int4*>(sched), bptr, rs, cs, x, out,
                 part, ybuf, cnt + (size_t)y * n_iter,
                 (gram != nullptr && y == stripes - 1) ? gram_part : nullptr, M, K, r, y * rn,
                 n_tr, n_tc, bm, bk, grp, sub, h, n_q, n_bands, nb, tb, cap, es};
    RN_SWITCH(rn, err = launch_ata<RN>(args, grid, s));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (gram == nullptr) return 0;
  gram_reduce_kernel<<<1, 64, 0, s>>>(gram_part, r, grid, gram);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
