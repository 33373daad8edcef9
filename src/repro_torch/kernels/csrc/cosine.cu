// Cosine scoring kernel for Hopper (sm_90a): the serving path's scorer.
//
// Replaces the TPU kernels
//   cosine_assign_pallas  src/repro/kernels/kmeans_assign.py:168  (argmax_k x.s_k)
//   cosine_topk_pallas    src/repro/kernels/kmeans_assign.py:132  (k_top best, descending)
// and computes what they compute: scores = x @ s^T in float32 with float32
// accumulation, then the k_top first of each point's scores in the order of
// a stable descending sort: NaN before every number (the first NaN wins,
// and a NaN score comes back as the canonical NaN), then larger scores,
// equal scores to the lower signature id. That is the order of jnp.argmax
// and of the reference's argmax-and-mask rounds (which, unlike this
// kernel, pick the first -inf again once only -inf is left). cosine_assign is
// the k_top = 1 launch of the one entry point, so cosine_topk(...)[:, 0]
// equals it bit for bit.
//
// Bound on an H100: at the reference's envelope (P = 4096, q = K = 1024)
// operations, 2 P q K flops at the 67 TFLOP/s float32 FFMA rate (exact
// float32: no TF32); at the served model's shape (q = 64 anchors, K = 16
// signatures) bytes (reading x), where the time is a launch and one
// device-memory latency. The previous design (a CTA of 32 points, 4 x 4
// scores a thread, the score tile in shared memory, one CTA to an SM, two
// barriers a 16-feature slice, selection after the product) ran at 27 % of
// the FFMA rate. What this one does:
//   * register tiles of 16 points x 8 signatures a thread: 128 FFMAs for 6
//     LDS.128 a feature. Slices are staged transposed (feature-major), so a
//     float4 holds one feature of 4 points or of 4 signatures, and a warp's
//     LDS.128 read 32 or 256 contiguous bytes: no bank conflicts.
//   * a ring of slices of 32 features, two deep, loaded by cp.async: 4-byte
//     copies that transpose as they land, zero-filled past P, K and q (so
//     nothing is padded in device memory), one barrier a slice, the next
//     slice's copies issued after a quarter of this slice's products.
//   * the signature axis split twice. In a CTA, 4 warps score 4 signature
//     tiles of 128 against the same 64 staged points, so each point's scores
//     of a tile stay in one half-warp. A thread-block cluster of 2 CTAs
//     splits the passes of 512 signatures: at the envelope 64 point tiles x 2
//     = 128 CTAs of 256 threads, one to an SM. Clusters of 4 or 8 CTAs of
//     128 signatures would split further, but fewer of them fit on the H100
//     at once than the envelope needs (cudaOccupancyMaxActiveClusters, at
//     one or two CTAs to an SM), so the grid ran in two waves; clusters of 2
//     reach all 132 SMs.
//   * a running top-k fused into the epilogue. After each pass every warp
//     merges its tile's ranks into its points' k_top best so far (kept in
//     shared memory, lane t of a half-warp keeping entry t) by k_top rounds:
//     each lane's best below the last round's winner, then one shuffle
//     reduction over the half-warp (two chained redux.sync were slower),
//     four points' rounds interleaved. No score tile exists in shared
//     or device memory. At the end a point's 2 x 4 lists meet through
//     distributed shared memory, every CTA of the cluster merging every
//     cs-th point and writing its labels and scores. A 64-bit rank (score key
//     above K - id) is a total order, so every merge gives the same answer in
//     any order: one launch, no atomics, no scratch.
//   * above kCap (16) the top-k is not kept running: the caller passes a
//     (P, K) float32 scratch, the CTAs store their scores there and, after a
//     cluster barrier, select each point's k_top by rank rounds over its row
//     (eight lanes a point, the rows staged in shared memory when they fit).
//     K and k_top have no ceiling, as in the reference's wrapper.
//   * K <= 16 (the served model): a narrow tile of 32 points x 16 signatures
//     (128 threads, 4 x 1 a thread, slices of 16 features four deep, so all
//     of q = 64 is in flight at once); each score's place among its point's
//     16 is counted by 16 shuffles, with no rounds. One short launch of
//     P / 32 CTAs.
//   * q, K and k_top are run-time values: the TPU wrapper pads q to 128 and K
//     to 8 and masks the padded signatures to -inf; here a signature id >= K
//     is never a candidate, so there is nothing to mask. The caller's k_valid
//     is passed as K: rows at and beyond it are never read.
//   * each (point, signature) score is one fmaf chain over ascending
//     features, starting from 0, whatever the tile: the feature axis is never
//     split, and the features past q in the last slice are zeros (fmaf(0, 0,
//     a) == a up to the sign of a zero, which the rank order ignores). So
//     results are the same from run to run and equal, bit for bit, to those
//     of the previous design.
//
// Plain C interface for ctypes; every entry point returns a cudaError_t.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>
#include <climits>

namespace cg = cooperative_groups;

namespace {

using u64 = unsigned long long;

constexpr int kLanesK = 16;      // lanes side by side along the signatures
constexpr int kCap = kLanesK;    // most k_top kept as a running top-k
constexpr int kMaxCluster = 8;   // lists one final merge takes (the portable cluster size)
constexpr int kSpillGroup = 8;   // lanes selecting one point from the scratch
constexpr int kMaxDevices = 64;

// A CTA tile: WarpsP x WarpsK warps, each two lane rows of kLanesK lanes.
// Lane (lr, lc) of warp (wp, wk) holds MP points, float4 f of them at
// wp 2 MP + 8 f + 4 lr, and MK signatures of the warp's own signature tile
// wk: lc if MK = 1, else float4 g of them at 64 g + 4 lc. So a pass scores
// kTileP points against WarpsK signature tiles, and each point's scores of
// one tile stay in one half-warp. Slices of ChunkQ features, Stages deep,
// are staged transposed: row c of a slice holds feature c of the pass's
// points, then of its signatures (kLd floats, 16-byte aligned).
template <int MP, int MK, int WarpsP, int WarpsK, int ChunkQ, int Stages, int MinBlocks>
struct Tile {
  static constexpr int kMicroP = MP, kMicroK = MK, kWarpsP = WarpsP, kWarpsK = WarpsK;
  static constexpr int kChunkQ = ChunkQ, kStages = Stages, kMinBlocks = MinBlocks;
  static constexpr int kThreads = 32 * WarpsP * WarpsK;
  static constexpr int kTileP = WarpsP * 2 * MP;
  static constexpr int kWarpK = kLanesK * MK;           // signatures a warp scores a pass
  static constexpr int kTileK = WarpsK * kWarpK;        // ... the CTA
  static constexpr int kRows = kTileP + kTileK;         // staged rows: points, then signatures
  static constexpr int kLd = kRows + 4;                 // floats per staged feature
  static constexpr int kStageFloats = ChunkQ * kLd;
  static constexpr int kRowsPerPass = kThreads / ChunkQ;  // rows one copy per thread covers
  static constexpr int kCopiesP = kTileP / kRowsPerPass;  // a thread's copies of point rows
  static constexpr int kCopies = kRows / kRowsPerPass;    // ... of all rows
  static constexpr int kLists = WarpsK * kTileP;          // running top-k lists
  static constexpr size_t kSmem =
      sizeof(float) * Stages * kStageFloats + sizeof(u64) * kLists * kCap;
  static_assert(MP % 4 == 0, "points come in float4s");
  static_assert(MK == 1 || MK % 4 == 0, "signatures come one a lane or in float4s");
  static_assert(kThreads % ChunkQ == 0 && kTileP % kRowsPerPass == 0 &&
                kTileK % kRowsPerPass == 0, "whole rows a copy pass");
  static_assert(kMaxCluster % WarpsK == 0, "a point's lists fit one merge");
  static_assert(Stages >= 2, "a ring");
};

// 64 points x 4 signature tiles of 128, 256 threads of 16 x 8, one CTA to
// an SM, slices of 32 features two deep: the envelope's 4096 points take 64
// point tiles x 2 CTAs.
using Wide = Tile<16, 8, 2, 4, 32, 2, 1>;
// 32 points x 16 signatures, 128 threads of 4 x 1: the served model (K <= 16).
using Narrow = Tile<4, 1, 4, 1, 16, 4, 1>;

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// A score as an unsigned key in the order of a stable descending sort:
// NaN above +inf, -0 equal to +0, the rest as the floats order. Every key is
// at least 0x007fffff (-inf), so key 0 marks "no candidate".
__device__ __forceinline__ unsigned order_key(float v) {
  if (isnan(v)) return 0xffffffffu;
  const unsigned u = __float_as_uint(v == 0.f ? 0.f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The score of a key (every NaN comes back as the same NaN).
__device__ __forceinline__ float key_score(unsigned key) {
  if (key == 0xffffffffu) return __uint_as_float(0x7fffffffu);
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// The 64-bit rank of signature k's score: its key above K - k, so a larger
// rank comes first in a stable descending sort and no two ranks are equal.
__device__ __forceinline__ u64 make_rank(float v, int k, int K) {
  return (static_cast<u64>(order_key(v)) << 32) | static_cast<unsigned>(K - k);
}

__device__ __forceinline__ void write_rank(u64 w, int K, int* label, float* score) {
  *label = K - static_cast<int>(static_cast<unsigned>(w));
  *score = key_score(static_cast<unsigned>(w >> 32));
}

// The largest rank over the aligned group of `Lanes` lanes holding this
// lane, by a butterfly of shuffles (two 32-bit redux.sync in a row were
// slower on the H100).
template <int Lanes>
__device__ __forceinline__ u64 group_max(u64 v) {
  static_assert(Lanes == 8 || Lanes == 16, "a group is an aligned part of a warp");
#pragma unroll
  for (int off = Lanes / 2; off > 0; off >>= 1) {
    const u64 other = __shfl_xor_sync(0xffffffffu, v, off, Lanes);
    v = other > v ? other : v;
  }
  return v;
}

// Round r of a selection takes, for each of M points, the largest rank
// below round r - 1's over the group's candidates; after k_top rounds lane
// r holds the r-th best of each point in `out`. `cand[i]` are this lane's N
// candidates for point i (0: none). The M points' rounds are independent,
// so their reductions overlap.
template <int M, int N>
__device__ __forceinline__ void select_rounds(const u64 (&cand)[M][N], int k_top, int col,
                                              u64 (&out)[M]) {
  u64 prev[M];
#pragma unroll
  for (int i = 0; i < M; ++i) prev[i] = ~0ull, out[i] = 0;
  for (int r = 0; r < k_top; ++r) {
#pragma unroll
    for (int i = 0; i < M; ++i) {
      u64 best = 0;
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (cand[i][j] < prev[i] && cand[i][j] > best) best = cand[i][j];
      const u64 w = group_max<kLanesK>(best);
      if (col == r) out[i] = w;
      prev[i] = w;
    }
  }
}

// k_top rounds over each of this CTA's points' rows of the (P, K) scratch,
// kSpillGroup lanes a point: every cs-th point of the tile, staged in shared
// memory (`stage`, `room` floats) when a batch of rows fits there.
template <int kThreads, int kTileP>
__device__ void select_from_scratch(const float* spill, long long p0, int P, int K, int k_top,
                                    int rank, int cs, float* stage, int room, int* labels,
                                    float* scores) {
  constexpr int kGroups = kThreads / kSpillGroup;
  const int t = threadIdx.x, g = t % kSpillGroup;
  const bool staged = static_cast<long long>(kGroups) * K <= room;
  const size_t kt = static_cast<size_t>(k_top);
  for (int base = rank; base < kTileP; base += cs * kGroups) {
    if (staged) {
      __syncthreads();   // the previous batch's rounds are done with the stage
      for (int i = t; i < kGroups * K; i += kThreads) {
        const int pl = base + cs * (i / K);
        const long long p = p0 + pl;
        stage[i] = (pl < kTileP && p < P) ? __ldcg(spill + p * K + i % K) : 0.f;
      }
      __syncthreads();
    }
    const int pl = base + cs * (t / kSpillGroup);
    const long long p = p0 + pl;
    const bool live = pl < kTileP && p < P;
    const float* row = staged ? stage + (t / kSpillGroup) * K : spill + (live ? p : 0) * K;
    auto rank_at = [&](int k) { return make_rank(staged ? row[k] : __ldcg(row + k), k, K); };
    u64 prev = ~0ull;
    for (int r = 0; r < k_top; ++r) {
      // four running maxima, so that the scan is not one chain of compares
      u64 most[4] = {0, 0, 0, 0};
      if (live) {
        int k = g;
        for (; k + 3 * kSpillGroup < K; k += 4 * kSpillGroup) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const u64 rk = rank_at(k + u * kSpillGroup);
            if (rk < prev && rk > most[u]) most[u] = rk;
          }
        }
        for (; k < K; k += kSpillGroup) {
          const u64 rk = rank_at(k);
          if (rk < prev && rk > most[0]) most[0] = rk;
        }
      }
      u64 best = most[0] > most[1] ? most[0] : most[1];
      const u64 other = most[2] > most[3] ? most[2] : most[3];
      best = group_max<kSpillGroup>(best > other ? best : other);
      if (live && g == 0) write_rank(best, K, labels + p * kt + r, scores + p * kt + r);
      prev = best;
    }
  }
}

template <class T>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks)
cosine_topk_kernel(const float* __restrict__ x, const float* __restrict__ s,
                   int P, int Q, int K, int k_top, int cs, int* __restrict__ labels,
                   float* __restrict__ scores, float* __restrict__ spill) {
  constexpr int kTileP = T::kTileP, kTileK = T::kTileK, kChunkQ = T::kChunkQ;
  constexpr int kThreads = T::kThreads, kStages = T::kStages, kLd = T::kLd;
  constexpr int MP = T::kMicroP, MK = T::kMicroK, kWarpsK = T::kWarpsK;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                          // kStages x [kChunkQ][kLd]
  u64* lists = reinterpret_cast<u64*>(smem + kStages * T::kStageFloats);  // [kLists][kCap]

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int lr = lane >> 4, lc = lane & 15;
  const int wp = warp % T::kWarpsP, wk = warp / T::kWarpsP;
  const int rank = static_cast<int>(blockIdx.x % static_cast<unsigned>(cs));
  const long long p0 = static_cast<long long>(blockIdx.x / static_cast<unsigned>(cs)) * kTileP;
  const int n_q = (Q + kChunkQ - 1) / kChunkQ;
  const int n_kt = (K + kTileK - 1) / kTileK;
  const int n_steps = ((n_kt - rank + cs - 1) / cs) * n_q;

  // This thread copies feature c of rows r0 + j kRowsPerPass of every slice:
  // point rows for j < kCopiesP, signature rows after. n_x / n_s count the
  // rows that exist (zero-filled past P and K). Slices are loaded in order;
  // the next one starts at feature q_next of the signature rows from k_next.
  const int c = t % kChunkQ, r0 = t / kChunkQ;
  const long long pass = static_cast<long long>(T::kRowsPerPass) * Q;
  auto rows_left = [](long long left) {
    return left <= 0 ? 0 : static_cast<int>((left - 1) / T::kRowsPerPass + 1);
  };
  const float* x_src = x + (p0 + r0) * Q + c;
  const int n_x = rows_left(static_cast<long long>(P) - p0 - r0);
  long long k_next = static_cast<long long>(rank) * kTileK + r0;
  const float* s_src = s + k_next * Q + c;
  int n_s = rows_left(K - k_next), q_next = 0;
  auto load_next = [&](int slot) {
    const bool fok = q_next + c < Q;
    float* dst = ring + slot * T::kStageFloats + c * kLd + r0;
#pragma unroll
    for (int j = 0; j < T::kCopies; ++j) {
      const bool is_x = j < T::kCopiesP;
      const int jj = is_x ? j : j - T::kCopiesP;
      const bool ok = fok && jj < (is_x ? n_x : n_s);
      const float* src = (is_x ? x_src : s_src) + q_next + jj * pass;
      cp_async4(dst + j * T::kRowsPerPass, ok ? src : x, ok ? 4 : 0);
    }
    q_next += kChunkQ;
    if (q_next >= Q) {   // the pass's last slice: the next starts the CTA's next pass
      q_next = 0;
      k_next += static_cast<long long>(cs) * kTileK;
      s_src += static_cast<long long>(cs) * kTileK * Q;
      n_s = rows_left(K - k_next);
    }
  };

  // this lane's point i in the tile, its signature j in a pass, its list of point i
  auto point = [&](int i) { return wp * 2 * MP + 8 * (i / 4) + 4 * lr + i % 4; };
  auto sig = [&](int j) { return wk * T::kWarpK + (MK == 1 ? lc : 64 * (j / 4) + 4 * lc + j % 4); };
  auto list = [&](int i) { return lists + (wk * kTileP + point(i)) * kCap + lc; };
  if constexpr (MK > 1) {
#pragma unroll
    for (int i = 0; i < MP; ++i) *list(i) = 0;
  }
  float acc[MP][MK];
#pragma unroll
  for (int i = 0; i < MP; ++i)
#pragma unroll
    for (int j = 0; j < MK; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_steps) load_next(st);
    cp_async_commit();
  }
  const int a_off = wp * 2 * MP + 4 * lr;                       // this lane's first point
  const int b_off = kTileP + sig(0);                              // ... and signature column
  // The scores of slice `stage`, features [f0, f1).
  auto product = [&](const float* stage, int f0, int f1) {
#pragma unroll 4
    for (int f = f0; f < f1; ++f) {
      const float* row = stage + f * kLd;
      float a[MP], b[MK];
#pragma unroll
      for (int i = 0; i < MP / 4; ++i)
        *reinterpret_cast<float4*>(a + 4 * i) =
            *reinterpret_cast<const float4*>(row + a_off + 8 * i);
      if constexpr (MK == 1) {
        b[0] = row[b_off];
      } else {
#pragma unroll
        for (int g = 0; g < MK / 4; ++g)
          *reinterpret_cast<float4*>(b + 4 * g) =
              *reinterpret_cast<const float4*>(row + b_off + 64 * g);
      }
#pragma unroll
      for (int i = 0; i < MP; ++i)
#pragma unroll
        for (int j = 0; j < MK; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  };
  int slice = 0, k0 = rank * kTileK;   // slice st's place in its pass, the pass's first id
  for (int st = 0; st < n_steps; ++st) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // slice st has landed, and every thread is done with slice st - 1
    const float* stage = ring + (st % kStages) * T::kStageFloats;
    // a quarter of the slice before the next slice's copies are issued
    product(stage, 0, kChunkQ / 4);
    {
      const int next = st + kStages - 1;
      if (next < n_steps) load_next(next % kStages);
      cp_async_commit();
    }
    product(stage, kChunkQ / 4, kChunkQ);
    if constexpr (MK == 1) continue;   // one pass: selected after the loop
    if (++slice < n_q) continue;
    // The pass's last slice: its scores, of ids kp + sig(j), are done.
    slice = 0;
    const int kp = k0;
    k0 += cs * kTileK;
    if (spill) {
#pragma unroll
      for (int i = 0; i < MP; ++i) {
        const long long p = p0 + point(i);
#pragma unroll
        for (int j = 0; j < MK; ++j) {
          const int k = kp + sig(j);
          if (p < P && k < K) spill[p * K + k] = acc[i][j];
          acc[i][j] = 0.f;
        }
      }
      continue;
    }
    // Merge the tile into each point's running top k_top, kSel points at
    // a time: the candidates are this lane's MK new ranks and the list
    // entry it keeps.
    constexpr int kSel = MP >= 16 ? 4 : 2;
#pragma unroll
    for (int i0 = 0; i0 < MP; i0 += kSel) {
      u64 cand[kSel][MK + 1], best[kSel];
#pragma unroll
      for (int i = 0; i < kSel; ++i) {
#pragma unroll
        for (int j = 0; j < MK; ++j) {
          const int k = kp + sig(j);
          cand[i][j] = k < K ? make_rank(acc[i0 + i][j], k, K) : 0ull;
          acc[i0 + i][j] = 0.f;
        }
        cand[i][MK] = *list(i0 + i);
      }
      select_rounds(cand, k_top, lc, best);
#pragma unroll
      for (int i = 0; i < kSel; ++i) *list(i0 + i) = best[i];
    }
  }

  const size_t kt = static_cast<size_t>(k_top);
  if constexpr (MK == 1) {
    // K <= kTileK: this CTA saw every signature, lane lc signature lc. A
    // score's place is the number of the half-warp's ranks above its own.
#pragma unroll
    for (int i = 0; i < MP; ++i) {
      const long long p = p0 + point(i);
      const unsigned key = lc < K ? order_key(acc[i][0]) : 0u;
      int place = 0;
#pragma unroll
      for (int m = 0; m < kLanesK; ++m) {
        const unsigned other = __shfl_sync(0xffffffffu, key, m, kLanesK);
        place += (other > key || (other == key && m < lc)) ? 1 : 0;
      }
      if (p < P && lc < K && place < k_top) {
        labels[p * kt + place] = lc;
        scores[p * kt + place] = key_score(key);
      }
    }
    return;
  }
  if (spill) {
    // Every CTA of the cluster has stored its scores; select each point's
    // k_top from its row, every cs-th point of the tile in this CTA.
    if (cs > 1) cg::this_cluster().sync(); else __syncthreads();
    select_from_scratch<kThreads, kTileP>(spill, p0, P, K, k_top, rank, cs, ring,
                                          kStages * T::kStageFloats, labels, scores);
    return;
  }
  // Merge the point's cs x kWarpsK lists (its warps', in every CTA of the
  // cluster) through distributed shared memory: a half-warp per point, lane
  // lc reading entry lc of every list; each CTA merges every cs-th point.
  cg::cluster_group cluster = cg::this_cluster();
  if (cs > 1) cluster.sync(); else __syncthreads();
  constexpr int kHalfWarps = kThreads / kLanesK;
  for (int base = rank; base < kTileP; base += cs * kHalfWarps) {
    const int pl = base + cs * (t / kLanesK);
    const long long p = p0 + pl;
    const bool live = pl < kTileP && p < P && lc < k_top;
    u64 cand[1][kMaxCluster], w[1];
#pragma unroll
    for (int j = 0; j < kMaxCluster; ++j) {
      const int owner = j / kWarpsK;   // the CTA holding list j
      cand[0][j] = 0;
      if (live && owner < cs) {
        const u64* from = owner == rank ? lists : cluster.map_shared_rank(lists, owner);
        cand[0][j] = from[((j % kWarpsK) * kTileP + pl) * kCap + lc];
      }
    }
    select_rounds(cand, k_top, lc, w);
    if (live) write_rank(w[0], K, labels + p * kt + lc, scores + p * kt + lc);
  }
  if (cs > 1) cluster.sync();   // no CTA leaves while another reads its lists
}

// cudaFuncSetAttribute calls made so far (the analyzer's rebuild audit).
std::atomic<int> g_attribute_sets{0};

// Launch one tile shape: a cluster of up to kMaxCluster / kWarpsK CTAs per
// point tile along the signature passes.
template <class T>
cudaError_t launch(const float* x, const float* s, int P, int Q, int K, int k_top,
                   int* labels, float* scores, float* spill, cudaStream_t stream) {
  auto kernel = cosine_topk_kernel<T>;
  // Raise the kernel's dynamic shared-memory limit once per device, so
  // steady-state launches (and launches captured in a CUDA graph) make no
  // attribute call. The limit is an attribute of the current device, the
  // one the launch goes to: the wrapper makes the tensors' device current
  // first. Racing threads at worst set the same value twice.
  static bool opted_in[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (T::kSmem > 48 * 1024 && !opted_in[dev]) {
    ++g_attribute_sets;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(T::kSmem));
    if (err != cudaSuccess) return err;
    opted_in[dev] = true;
  }
  // The CTAs of a cluster split the signature passes; with kWarpsK lists a
  // point in each, a cluster's lists fit one merge of kMaxCluster.
  constexpr int kMaxCs = kMaxCluster / T::kWarpsK;
  const int n_kt = (K + T::kTileK - 1) / T::kTileK;
  const int cs = n_kt < kMaxCs ? n_kt : kMaxCs;
  const long long grid = ((static_cast<long long>(P) + T::kTileP - 1) / T::kTileP) * cs;
  if (grid > INT_MAX) return cudaErrorInvalidValue;
  if (cs == 1) {
    kernel<<<static_cast<unsigned>(grid), T::kThreads, T::kSmem, stream>>>(
        x, s, P, Q, K, k_top, cs, labels, scores, spill);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(T::kThreads);
  cfg.dynamicSmemBytes = T::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cs);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, x, s, P, Q, K, k_top, cs, labels, scores, spill);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* cosine_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory (bytes) a launch over K signatures requests, and its
// threads a block in *threads (K <= 16 takes the narrow tile).
int cosine_smem_bytes(int K, int* threads) {
  const bool narrow = K <= Narrow::kTileK;
  if (threads != nullptr) *threads = narrow ? Narrow::kThreads : Wide::kThreads;
  return static_cast<int>(narrow ? Narrow::kSmem : Wide::kSmem);
}

// cudaFuncSetAttribute calls this library has made.
int cosine_attribute_sets(void) { return g_attribute_sets.load(); }

// The largest k_top kept as a running top-k: above it the caller passes a
// (P, K) scratch for the scores.
int cosine_max_k(void) { return kCap; }

// x (P,Q), s (K,Q) -> labels (P,k_top) int32, scores (P,k_top), descending.
// K is the caller's k_valid: only the first K rows of s are read. spill is
// null, or a (P, K) float32 scratch for the scores; it is needed (and used)
// only when k_top > cosine_max_k().
int cosine_topk_f32(const float* x, const float* s, int P, int Q, int K, int k_top,
                    int* labels, float* scores, float* spill, void* stream) {
  if (P < 1 || Q < 1 || K < 1 || k_top < 1 || k_top > K)
    return static_cast<int>(cudaErrorInvalidValue);
  if (k_top > kCap && spill == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  float* sp = k_top > kCap ? spill : nullptr;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // K <= 16 (the served model) takes the narrow tile; it never spills
  // (k_top <= K <= kCap).
  const cudaError_t err =
      K <= Narrow::kTileK ? launch<Narrow>(x, s, P, Q, K, k_top, labels, scores, sp, st)
                          : launch<Wide>(x, s, P, Q, K, k_top, labels, scores, sp, st);
  return static_cast<int>(err);
}

}  // extern "C"
