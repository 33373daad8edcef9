// k-means kernels for Hopper (sm_90a), batched over a leading block dim B.
//
// Replaces the TPU kernels
//   kmeans_update_pallas  src/repro/kernels/kmeans_update.py:79  (one fused Lloyd step)
//   kmeans_assign_pallas  src/repro/kernels/kmeans_assign.py:59  (assignment only)
// and computes what they compute: d2 = |x|^2 - 2 x.c + |c|^2, the argmin label
// (ties to the lowest centroid id, as jnp.argmin), max(min d2, 0) and, for the
// update, the per-cluster weighted coordinate sums and weight counts. K, D and
// P are run-time values with no ceiling, as in the reference's wrapper; nothing
// is padded in device memory (the TPU wrapper pads D to 128 and K to 8, which
// at D = 5 would multiply the bytes read by 25).
//
// Bound on an H100. At the LAMC atom shape (B = 128, P = 10,240, D = 5,
// K = 16) and the sparse cell's (B = 1, P = 147,456): bytes. One pass reads x
// (26 MB at the atom shape) and writes labels and d2 (10 MB): ~11 us at
// 3.35 TB/s, against ~6 us for the ~0.4 GFLOP at the 67 TFLOP/s fp32 rate. At
// D = K = 128: operations, 2 P K D flops at the FFMA rate. Two tile shapes:
//   * narrow (D <= 16 and K <= 32, the atom and sparse shapes): 256 threads,
//     4 points each (1024 points a CTA). The tile's rows are one contiguous
//     run of 1024 D floats, brought into shared memory by 16-byte cp.async;
//     each thread then holds its points' features in registers (D is a
//     template bound: exact for D <= 8; 16 above, the features past D zero),
//     the CTA's centroids (padded the same way) and |c|^2 are staged once,
//     and each centroid row is read by LDS.128 once for four points.
//     Dynamic shared memory is sized from D and K, so occupancy is not held
//     by a fixed cap. The time goes to instructions (~10 a point-centroid
//     pair: D fmaf, the distance, the compare and two selects) as much as to
//     the bytes.
//   * wide (everything else; the K = D = 128 row): 128 points x 128 centroids
//     a pass, 256 threads of 8 x 8 (points x centroids) fmaf accumulators.
//     Feature slices of 32 go through a three-deep ring, staged transposed
//     by 4-byte cp.async (a float4 is one feature of 4 points or 4
//     centroids), one barrier a slice; thread t also carries the |x|^2 or
//     |c|^2 chain of staged row t. Each thread keeps a running (bd, best)
//     over its ascending centroid ids; the 16 lanes that share a point merge
//     theirs by a butterfly on the total order (d2, id), so any merge order
//     gives the same label. K > 128 takes more passes over the point tile;
//     two CTAs fit on an SM.
//   * every dot product, |x|^2 and |c|^2 is one fmaf chain over ascending
//     features starting from 0, and d2 = (|x|^2 - 2 x.c) + |c|^2 with
//     fmaf(-2, x.c, |x|^2) (2 x.c is exact, so this rounds as the
//     reference's association does). Neither tile splits the feature axis;
//     the narrow tile's zero features at the end of a chain add exact zeros
//     (at most turning a -0 into +0, which d2 does not see). So a point's
//     d2 to a centroid depends only on the two rows, and for finite d2 so
//     does its label: both tiles, and kmeans_assign and kmeans_update, give
//     the same bits. (A NaN d2, from a NaN point or centroid, is ordered
//     differently by the two tiles' merges and by the reference's argmin;
//     core/kmeans.py keeps an empty cluster from making a NaN centroid.)
//     The TPU kernel computes x.c on the MXU; the results are held to the
//     plain version by a near-tie rule and a tolerance, not bit for bit.
//   * the update's one-hot never exists. Each CTA reduces its tile to one
//     partial (K x (D + 1): the weighted sums, then the weight count) in a
//     fixed order: in the narrow tile, thread (segment, column) adds its
//     segment's points in point order into its own row of a shared-memory
//     slab, and the segments are then added in segment order; in the wide
//     tile, the 128 points are put in a stable order by label while their
//     rows are copied again into the ring (up to 194 features at a time),
//     and thread f adds column f of each label's run in a register and
//     writes it as that label's row of the partial. The wide update is held
//     by bytes past the assignment: it reads x a second time and writes and
//     reads back a K x (D + 1) partial for every 128 points. (Adding the
//     partials of a cluster of 2-8 CTAs through distributed shared memory
//     moved a quarter of those bytes, but the cluster launch at two CTAs to
//     an SM cost more than that saved.) A second launch, parallel over
//     (b, k, column), adds the tiles' partials: lane group g sums tiles g,
//     g + 8, ... in order, then the eight group sums in group order. No
//     float atomics; every CTA covers a fixed range of points, so no result
//     depends on the number of SMs or on scheduling.
//
// Plain C interface for ctypes; every entry point returns a cudaError_t.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = kThreads / 32;   // lane groups of the cross-tile sum
constexpr int kMaxDevices = 64;

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// d2 from x.c, |x|^2 and |c|^2: (|x|^2 - 2 x.c) + |c|^2, rounded twice.
__device__ __forceinline__ float dist2(float xc, float x2, float c2) {
  return __fadd_rn(__fmaf_rn(-2.f, xc, x2), c2);
}

__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }

// ---------------------------------------------------------------- narrow

constexpr int kNarrowMP = 4;                        // points a thread
constexpr int kNarrowTile = kThreads * kNarrowMP;   // points a CTA
constexpr int kNarrowMaxD = 16;
constexpr int kNarrowMaxK = 32;

// Offsets (floats) of the narrow tile's dynamic shared memory: the centroids
// (K rows of cs floats), |c|^2, the point rows (up to 3 floats early, from
// the 16-byte-aligned address at or before the run's start), and for the
// update the tile's labels, weights and the statistics slab (segs x K x
// (D + 1)).
struct NarrowSmem {
  int c2, x, lab, w, slab, total;
};

__host__ __device__ constexpr NarrowSmem narrow_smem(int cs, int D, int K, bool update) {
  const int c2 = K * cs;
  const int x = c2 + round4(K);
  const int lab = x + round4(kNarrowTile * D + 3);
  const int w = lab + kNarrowTile;
  const int slab = w + kNarrowTile;
  const int total = update ? slab + (kThreads / (D + 1)) * K * (D + 1) : lab;
  return NarrowSmem{c2, x, lab, w, slab, total};
}

// DM bounds D (D == DM for D <= 8), so the features of a point live in
// registers. Features D to DM - 1 are 0 in xr and in c_s: the chains run over
// DM features unpredicated.
template <int DM, bool kUpdate>
__global__ void __launch_bounds__(kThreads)
kmeans_narrow_kernel(const float* __restrict__ x, const float* __restrict__ c,
                     const float* __restrict__ w, int P, int D, int K,
                     int* __restrict__ labels, float* __restrict__ d2,
                     float* __restrict__ partials) {
  constexpr int MP = kNarrowMP, CS = round4(DM);
  extern __shared__ __align__(16) float smem[];
  const NarrowSmem lay = narrow_smem(CS, D, K, kUpdate);
  float* c_s = smem;
  float* c2_s = smem + lay.c2;
  float* x_s = smem + lay.x;
  const int t = threadIdx.x, b = blockIdx.y;
  const long long p0 = static_cast<long long>(blockIdx.x) * kNarrowTile;
  const int n = static_cast<int>(min(static_cast<long long>(kNarrowTile), P - p0));
  const size_t row0 = static_cast<size_t>(b) * P + p0;   // the tile's first point

  // The tile's n rows are one run of n D floats: 16-byte copies from the
  // aligned address `skew` floats before its start (the same 16 bytes as
  // the run's first float, so never outside mapped memory).
  const float* xg = x + row0 * D;
  const int skew = static_cast<int>((reinterpret_cast<uintptr_t>(xg) >> 2) & 3);
  const float* xa = xg - skew;
  const int run = skew + n * D;
  for (int q = 4 * t; q < run; q += 4 * kThreads)
    cp_async16(x_s + q, xa + q, 4 * min(4, run - q));
  cp_async_commit();

  const float* cb = c + static_cast<size_t>(b) * K * D;
  for (int e = t; e < K * CS; e += kThreads) {
    const int k = e / CS, f = e - k * CS;
    c_s[e] = f < D ? cb[static_cast<size_t>(k) * D + f] : 0.f;
  }
  if constexpr (kUpdate) {
    float* slab = smem + lay.slab;
    for (int e = t; e < lay.total - lay.slab; e += kThreads) slab[e] = 0.f;
  }
  __syncthreads();
  if (t < K) {
    const float* cr = c_s + t * CS;
    float s = 0.f;
#pragma unroll
    for (int f = 0; f < DM; ++f) s = __fmaf_rn(cr[f], cr[f], s);
    c2_s[t] = s;
  }
  cp_async_wait<0>();
  __syncthreads();

  // point j of this thread: row j kThreads + t of the tile
  float xr[MP][DM], x2[MP], bd[MP];
  int best[MP];
#pragma unroll
  for (int j = 0; j < MP; ++j) {
    const int r = j * kThreads + t;
    const float* row = x_s + skew + r * D;
    x2[j] = 0.f;
#pragma unroll
    for (int f = 0; f < DM; ++f) {
      xr[j][f] = (f < D && r < n) ? row[f] : 0.f;
      x2[j] = __fmaf_rn(xr[j][f], xr[j][f], x2[j]);
    }
    bd[j] = 0.f;
    best[j] = 0;
  }
  for (int k = 0; k < K; ++k) {
    float cv[CS];
#pragma unroll
    for (int g = 0; g < CS / 4; ++g)
      *reinterpret_cast<float4*>(cv + 4 * g) =
          *reinterpret_cast<const float4*>(c_s + k * CS + 4 * g);
    const float c2 = c2_s[k];
#pragma unroll
    for (int j = 0; j < MP; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int f = 0; f < DM; ++f) acc = __fmaf_rn(xr[j][f], cv[f], acc);
      const float dd = dist2(acc, x2[j], c2);
      if (k == 0 || dd < bd[j]) {
        bd[j] = dd;
        best[j] = k;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < MP; ++j) {
    const int r = j * kThreads + t;
    if (r < n) {
      labels[row0 + r] = best[j];
      d2[row0 + r] = fmaxf(bd[j], 0.f);
    }
  }

  if constexpr (kUpdate) {
    int* lab_s = reinterpret_cast<int*>(smem + lay.lab);
    float* w_s = smem + lay.w;
    float* slab = smem + lay.slab;
#pragma unroll
    for (int j = 0; j < MP; ++j) {
      const int r = j * kThreads + t;
      if (r < n) {
        lab_s[r] = best[j];
        w_s[r] = w ? w[row0 + r] : 1.f;
      }
    }
    __syncthreads();
    // Thread (seg, col) adds the points of its segment, in order, into row
    // seg of the slab: column col < D the weighted feature, col == D the
    // weight.
    const int cols = D + 1, segs = kThreads / cols;
    const int len = (n + segs - 1) / segs;
    const int seg = t / cols, col = t - seg * cols;
    if (seg < segs) {
      float* mine = slab + seg * K * cols + col;
      const int end = min(n, (seg + 1) * len);
      for (int p = seg * len; p < end; ++p) {
        const float v = col < D ? x_s[skew + p * D + col] : 1.f;
        float* s = mine + lab_s[p] * cols;
        *s = __fmaf_rn(w_s[p], v, *s);
      }
    }
    __syncthreads();
    // the tile's partial: the segments added in segment order
    const size_t out = (static_cast<size_t>(blockIdx.x) * gridDim.y + b) * K * cols;
    for (int o = t; o < K * cols; o += kThreads) {
      float s = slab[o];
      for (int g = 1; g < segs; ++g) s = __fadd_rn(s, slab[g * K * cols + o]);
      partials[out + o] = s;
    }
  }
}

// ------------------------------------------------------------------ wide

// A CTA: 8 warps x 16 points, each warp against the pass's 128 centroids.
// Lane (lr, lc) of warp wp holds points wp 16 + 8 (i / 4) + 4 lr + i % 4 and
// centroids 64 (j / 4) + 4 lc + j % 4 of the pass (i, j < 8), so a point's 16
// lanes share a half-warp. Slices of kChunkD features are staged transposed:
// row f of a slice holds feature f of the 128 points, then of the 128
// centroids (kLd floats, 16-byte aligned).
struct Wide {
  static constexpr int kMP = 8, kMK = 8;
  static constexpr int kTileP = 128, kTileK = 128;
  static constexpr int kChunkD = 32, kStages = 3;
  static constexpr int kRows = kTileP + kTileK;
  static constexpr int kLd = kRows + 4;
  static constexpr int kStageFloats = kChunkD * kLd;
  static constexpr int kRingFloats = kStages * kStageFloats;
  static constexpr int kRowsPerPass = kThreads / kChunkD;    // rows one copy per thread covers
  static constexpr int kCopies = kRows / kRowsPerPass;       // a thread's copies of a slice
  static constexpr int kCopiesP = kTileP / kRowsPerPass;     // ... of point rows
  static constexpr size_t kSmem = sizeof(float) * (kRingFloats + kRows) +
                                  (sizeof(int) + sizeof(float)) * kTileP;
  static_assert(kRows == kThreads, "thread t carries the |.|^2 chain of staged row t");
  static_assert(kTileP == 16 * (kThreads / 32) && kTileK == 16 * kMK, "the lane layout");
};

template <bool kUpdate>
__global__ void __launch_bounds__(kThreads, 2)
kmeans_wide_kernel(const float* __restrict__ x, const float* __restrict__ c,
                   const float* __restrict__ w, int P, int D, int K,
                   int* __restrict__ labels, float* __restrict__ d2,
                   float* __restrict__ partials) {
  using T = Wide;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                                  // kStages x [kChunkD][kLd]
  float* sq_s = ring + T::kRingFloats;                 // |x|^2 of the points, |c|^2 of the pass
  int* lab_s = reinterpret_cast<int*>(sq_s + T::kRows);
  float* w_s = reinterpret_cast<float*>(lab_s + T::kTileP);

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int lr = lane >> 4, lc = lane & 15;
  const int b = blockIdx.y;
  const long long p0 = static_cast<long long>(blockIdx.x) * T::kTileP;
  const int n = static_cast<int>(min(static_cast<long long>(T::kTileP), P - p0));
  const size_t row0 = static_cast<size_t>(b) * P + p0;
  const float* xb = x + row0 * D;
  const float* cb = c + static_cast<size_t>(b) * K * D;
  const int n_d = (D + T::kChunkD - 1) / T::kChunkD;
  const int n_kt = (K + T::kTileK - 1) / T::kTileK;
  const int n_steps = n_d * n_kt;

  // This thread copies feature cf of rows r0 + 8 j of every slice: point rows
  // for j < kCopiesP, centroid rows after, zero-filled past n, K and D.
  // Slices are loaded in order; the next starts at feature d_next of the
  // pass whose first centroid is k_next.
  const int cf = t % T::kChunkD, r0 = t / T::kChunkD;
  int d_next = 0, k_next = 0;
  auto load_next = [&](int slot) {
    const int f = d_next + cf;
    float* dst = ring + slot * T::kStageFloats + cf * T::kLd + r0;
#pragma unroll
    for (int j = 0; j < T::kCopies; ++j) {
      const int row = r0 + j * T::kRowsPerPass;
      bool ok;
      const float* src;
      if (j < T::kCopiesP) {
        ok = row < n;
        src = xb + static_cast<size_t>(row) * D + f;
      } else {
        const int k = k_next + row - T::kTileP;
        ok = k < K;
        src = cb + static_cast<size_t>(k) * D + f;
      }
      ok = ok && f < D;
      cp_async4(dst + j * T::kRowsPerPass, ok ? src : x, ok ? 4 : 0);
    }
    d_next += T::kChunkD;
    if (d_next >= D) {
      d_next = 0;
      k_next += T::kTileK;
    }
  };

  float acc[T::kMP][T::kMK];
#pragma unroll
  for (int i = 0; i < T::kMP; ++i)
#pragma unroll
    for (int j = 0; j < T::kMK; ++j) acc[i][j] = 0.f;
  float sq = 0.f;            // |.|^2 chain of staged row t over this pass's slices
  float bd[T::kMP];          // this thread's nearest so far (best < 0: none yet)
  int best[T::kMP];
#pragma unroll
  for (int i = 0; i < T::kMP; ++i) {
    bd[i] = 0.f;
    best[i] = -1;
  }

#pragma unroll
  for (int st = 0; st < T::kStages - 1; ++st) {
    if (st < n_steps) load_next(st);
    cp_async_commit();
  }
  const int a_off = warp * 16 + 4 * lr;     // this lane's first point
  const int b_off = T::kTileP + 4 * lc;     // ... and first centroid's row
  int ds = 0, k0 = 0;                       // the slice's first feature, the pass's first id
  for (int st = 0; st < n_steps; ++st) {
    cp_async_wait<T::kStages - 2>();
    __syncthreads();   // slice st has landed; every thread is done with slice st - 1
    {
      const int next = st + T::kStages - 1;
      if (next < n_steps) load_next(next % T::kStages);
      cp_async_commit();
    }
    const float* stage = ring + (st % T::kStages) * T::kStageFloats;
    const int fn = min(T::kChunkD, D - ds);
#pragma unroll 4
    for (int f = 0; f < fn; ++f) {
      const float* row = stage + f * T::kLd;
      float a[T::kMP], bv[T::kMK];
      *reinterpret_cast<float4*>(a) = *reinterpret_cast<const float4*>(row + a_off);
      *reinterpret_cast<float4*>(a + 4) = *reinterpret_cast<const float4*>(row + a_off + 8);
      *reinterpret_cast<float4*>(bv) = *reinterpret_cast<const float4*>(row + b_off);
      *reinterpret_cast<float4*>(bv + 4) = *reinterpret_cast<const float4*>(row + b_off + 64);
#pragma unroll
      for (int i = 0; i < T::kMP; ++i)
#pragma unroll
        for (int j = 0; j < T::kMK; ++j) acc[i][j] = __fmaf_rn(a[i], bv[j], acc[i][j]);
      const float v = row[t];
      sq = __fmaf_rn(v, v, sq);
    }
    ds += T::kChunkD;
    if (ds < D) continue;
    // The pass's last slice: its products, of ids k0 + centroid j, are done.
    ds = 0;
    sq_s[t] = sq;
    sq = 0.f;
    __syncthreads();
    float x2[T::kMP], c2[T::kMK];
#pragma unroll
    for (int i = 0; i < T::kMP; ++i) x2[i] = sq_s[a_off + 8 * (i / 4) + i % 4];
#pragma unroll
    for (int j = 0; j < T::kMK; ++j) c2[j] = sq_s[b_off + 64 * (j / 4) + j % 4];
#pragma unroll
    for (int j = 0; j < T::kMK; ++j) {   // ascending ids
      const int k = k0 + 64 * (j / 4) + 4 * lc + j % 4;
#pragma unroll
      for (int i = 0; i < T::kMP; ++i) {
        const float dd = dist2(acc[i][j], x2[i], c2[j]);
        if (k < K && (best[i] < 0 || dd < bd[i])) {
          bd[i] = dd;
          best[i] = k;
        }
        acc[i][j] = 0.f;
      }
    }
    k0 += T::kTileK;
  }

  // A point's 16 lanes agree on the least (d2, id); lane lc == i writes
  // point i of its half-warp.
#pragma unroll
  for (int i = 0; i < T::kMP; ++i) {
    float v = bd[i];
    int id = best[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off, 16);
      const int oid = __shfl_xor_sync(0xffffffffu, id, off, 16);
      if (oid >= 0 && (id < 0 || ov < v || (ov == v && oid < id))) {
        v = ov;
        id = oid;
      }
    }
    if (lc == i) {
      const int p = a_off + 8 * (i / 4) + i % 4;
      if (p < n) {
        labels[row0 + p] = id;
        d2[row0 + p] = fmaxf(v, 0.f);
        if constexpr (kUpdate) {
          lab_s[p] = id;
          w_s[p] = w ? w[row0 + p] : 1.f;
        }
      }
    }
  }

  if constexpr (kUpdate) {
    cp_async_wait<0>();
    __syncthreads();   // labels and weights published; the ring is free
    // The ring now holds the tile's points in a stable order by label, then
    // up to kCols features of each of its points ([point][feature]), copied
    // again while the order is worked out.
    constexpr int kCols = (T::kRingFloats - T::kTileP) / T::kTileP;
    int* order = reinterpret_cast<int*>(ring);
    float* xs_s = ring + T::kTileP;
    auto stage = [&](int f0) {   // features f0 .. f0 + kCols - 1
      const int fx = min(kCols, D - f0);
      for (int e = t; e < n * fx; e += kThreads) {
        const int p = e / fx;
        cp_async4(xs_s + e, xb + static_cast<size_t>(p) * D + f0 + (e - p * fx), 4);
      }
      cp_async_commit();
    };
    stage(0);
    // point p goes to place #{q : lab_q < lab_p} + #{q < p : lab_q == lab_p}
    if (t < n) {
      const int l = lab_s[t];
      int place = 0;
      for (int q = 0; q < n; ++q) {
        const int lq = lab_s[q];
        place += (lq < l || (lq == l && q < t)) ? 1 : 0;
      }
      order[place] = t;
    }
    // Thread f walks the points in that order, adding column f (a feature,
    // or for f == D the weight) of each run of one label in a register, in
    // point order, and writes the run's sum as that label's row of the
    // partial; rows of labels no point has are written 0.
    const int cols = D + 1;
    const size_t out = (static_cast<size_t>(blockIdx.x) * gridDim.y + b) * K * cols;
    for (int f0 = 0; f0 < cols; f0 += kCols) {
      if (f0 > 0) {
        __syncthreads();   // every thread is done with the previous columns
        if (f0 < D) stage(f0);
      }
      cp_async_wait<0>();
      __syncthreads();   // the order and the staged columns are visible
      const int fx = min(kCols, D - f0);
      for (int f = t; f < min(kCols, cols - f0); f += kThreads) {
        const int col = f0 + f;
        float* row = partials + out + col;
        int next = 0;   // the first row not written yet
        auto finish = [&](int k, float v) {
          for (; next < k; ++next) row[static_cast<size_t>(next) * cols] = 0.f;
          if (k < K) {
            row[static_cast<size_t>(k) * cols] = v;
            next = k + 1;
          }
        };
        int cur = lab_s[order[0]];
        float acc = 0.f;
#pragma unroll 4
        for (int i = 0; i < n; ++i) {
          const int p = order[i];
          const int l = lab_s[p];
          if (l != cur) {
            finish(cur, acc);
            acc = 0.f;
            cur = l;
          }
          acc = __fmaf_rn(w_s[p], col < D ? xs_s[p * fx + f] : 1.f, acc);
        }
        finish(cur, acc);
        finish(K, 0.f);
      }
    }
  }
}

// ------------------------------------------------------- cross-tile sum

// sums[b, k, j] / counts[b, k] = the tiles' partials added in a fixed order:
// warp g of a CTA sums tiles g, g + kGroups, ... of 32 outputs, then the
// kGroups sums are added in group order.
__global__ void __launch_bounds__(kThreads)
kmeans_reduce_kernel(const float* __restrict__ partials, int tiles, int B, int D, int K,
                     float* __restrict__ sums, float* __restrict__ counts) {
  __shared__ float part[kGroups][32];
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int cols = D + 1;
  const long long N = static_cast<long long>(B) * K * cols;
  const long long o = static_cast<long long>(blockIdx.x) * 32 + lane;
  float s = 0.f;
  if (o < N) {
#pragma unroll 4
    for (int tt = g; tt < tiles; tt += kGroups)
      s = __fadd_rn(s, __ldg(partials + static_cast<size_t>(tt) * N + o));
  }
  part[g][lane] = s;
  __syncthreads();
  if (g == 0 && o < N) {
    float tot = part[0][lane];
#pragma unroll
    for (int q = 1; q < kGroups; ++q) tot = __fadd_rn(tot, part[q][lane]);
    const long long bk = o / cols;
    const int j = static_cast<int>(o - bk * cols);
    if (j < D)
      sums[bk * D + j] = tot;
    else
      counts[bk] = tot;
  }
}

// ------------------------------------------------------------------ host

bool uses_narrow(int D, int K) { return D <= kNarrowMaxD && K <= kNarrowMaxK; }

int tile_points(int D, int K) { return uses_narrow(D, K) ? kNarrowTile : Wide::kTileP; }

// Raise a kernel's dynamic shared-memory limit to `most` once per device, so
// steady-state launches (and launches captured in a CUDA graph) make no
// attribute call. The limit is an attribute of the current device, the one
// the launch goes to: the wrapper makes the tensors' device current first.
// Racing threads at worst set the same value twice.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t most, bool (&opted)[kMaxDevices]) {
  if (most <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (opted[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(most));
  if (err == cudaSuccess) opted[dev] = true;
  return err;
}

template <int DM, bool kUpdate>
cudaError_t launch_narrow(const float* x, const float* c, const float* w, int B, int P,
                          int D, int K, int* labels, float* d2, float* partials,
                          cudaStream_t stream) {
  constexpr int CS = round4(DM);
  static bool opted[kMaxDevices] = {};
  auto kernel = kmeans_narrow_kernel<DM, kUpdate>;
  // the most any (D <= DM, K <= kNarrowMaxK) launch of this instance takes
  constexpr size_t most =
      sizeof(float) * narrow_smem(CS, DM, kNarrowMaxK, kUpdate).total;
  cudaError_t err = allow_smem(kernel, most, opted);
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(float) * narrow_smem(CS, D, K, kUpdate).total;
  const dim3 grid(static_cast<unsigned>((P + kNarrowTile - 1LL) / kNarrowTile), B);
  kernel<<<grid, kThreads, smem, stream>>>(x, c, w, P, D, K, labels, d2, partials);
  return cudaGetLastError();
}

template <bool kUpdate>
cudaError_t launch_wide(const float* x, const float* c, const float* w, int B, int P,
                        int D, int K, int* labels, float* d2, float* partials,
                        cudaStream_t stream) {
  static bool opted[kMaxDevices] = {};
  auto kernel = kmeans_wide_kernel<kUpdate>;
  cudaError_t err = allow_smem(kernel, Wide::kSmem, opted);
  if (err != cudaSuccess) return err;
  const long long tiles = (P + Wide::kTileP - 1LL) / Wide::kTileP;
  kernel<<<dim3(static_cast<unsigned>(tiles), B), kThreads, Wide::kSmem, stream>>>(
      x, c, w, P, D, K, labels, d2, partials);
  return cudaGetLastError();
}

// Labels and d2 of every point and, for the update, each tile's partial.
template <bool kUpdate>
cudaError_t launch_tiles(const float* x, const float* c, const float* w, int B, int P,
                         int D, int K, int* labels, float* d2, float* partials,
                         cudaStream_t s) {
  if (!uses_narrow(D, K))
    return launch_wide<kUpdate>(x, c, w, B, P, D, K, labels, d2, partials, s);
  // one instance for each D <= 8 (at D = 5, 14-16 % less device time than
  // D padded to 8: PERF.md section 6), one for 9 <= D <= 16
  switch (D) {
    case 1: return launch_narrow<1, kUpdate>(x, c, w, B, P, D, K, labels, d2, partials, s);
    case 2: return launch_narrow<2, kUpdate>(x, c, w, B, P, D, K, labels, d2, partials, s);
    case 3: return launch_narrow<3, kUpdate>(x, c, w, B, P, D, K, labels, d2, partials, s);
    case 4: return launch_narrow<4, kUpdate>(x, c, w, B, P, D, K, labels, d2, partials, s);
    case 5: return launch_narrow<5, kUpdate>(x, c, w, B, P, D, K, labels, d2, partials, s);
    case 6: return launch_narrow<6, kUpdate>(x, c, w, B, P, D, K, labels, d2, partials, s);
    case 7: return launch_narrow<7, kUpdate>(x, c, w, B, P, D, K, labels, d2, partials, s);
    case 8: return launch_narrow<8, kUpdate>(x, c, w, B, P, D, K, labels, d2, partials, s);
    default:
      return launch_narrow<kNarrowMaxD, kUpdate>(x, c, w, B, P, D, K, labels, d2, partials, s);
  }
}

}  // namespace

extern "C" {

// Points one partial of the update covers at (D, K); kmeans_update_f32's
// partials hold ceil(P / kmeans_tile(D, K)) of them for each block.
int kmeans_tile(int D, int K) { return tile_points(D, K); }

const char* kmeans_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (B,P,D), c (B,K,D) -> labels (B,P) int32, d2 (B,P).
int kmeans_assign_f32(const float* x, const float* c, int B, int P, int D, int K,
                      int* labels, float* d2, void* stream) {
  if (B < 1 || P < 1 || D < 1 || K < 1 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_tiles<false>(x, c, nullptr, B, P, D, K, labels, d2,
                                              nullptr, static_cast<cudaStream_t>(stream)));
}

// x (B,P,D), c (B,K,D), w (B,P) or null -> labels, d2, sums (B,K,D),
// counts (B,K). partials (tiles, B, K, D + 1) is scratch with
// tiles = ceil(P / kmeans_tile(D, K)).
int kmeans_update_f32(const float* x, const float* c, const float* w, int B, int P,
                      int D, int K, int* labels, float* d2, float* partials, float* sums,
                      float* counts, void* stream) {
  if (B < 1 || P < 1 || D < 1 || K < 1 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long outputs = static_cast<long long>(B) * K * (D + 1);
  const long long grid = (outputs + 31) / 32;
  if (grid > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = static_cast<int>((P + tile_points(D, K) - 1LL) / tile_points(D, K));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_tiles<true>(x, c, w, B, P, D, K, labels, d2, partials, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  kmeans_reduce_kernel<<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
      partials, tiles, B, D, K, sums, counts);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
