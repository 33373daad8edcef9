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
// Bound on an H100: at the served model's shape (q = 64 anchors, K = 16
// signatures) bytes (reading x), at the reference's envelope (q = K = 1024)
// operations (2 P q K flops at the 67 TFLOP/s float32 rate). What the design
// does about it:
//   * x is read from device memory once, in coalesced slices of kChunkQ
//     features staged in shared memory; each staged signature slice serves
//     all kTileP points of the tile and each staged point slice every
//     signature of the pass. The next slice is loaded into registers while
//     the current one is multiplied.
//   * each thread keeps a kMicroP x kMicroK block of scores in registers and
//     reads its operands as float4 from shared memory. A warp covers 16
//     points x 32 signatures, so one 128-byte signature row and one 64-byte
//     point row serve 16 fused multiply-adds of each thread: the loop is
//     bound by the float32 pipe, not by shared-memory bandwidth.
//   * q, K and k_top are run-time values and nothing is padded in device
//     memory: the TPU wrapper pads q to 128 and K to 8 and masks the padded
//     signatures to -inf; here a signature id >= K is never stored, so
//     there is nothing to mask. The caller's k_valid is passed as K: rows
//     at and beyond it are never read.
//   * the (kTileP, K) score tile stays in shared memory for the k_top
//     rounds: eight lanes per point scan its row and reduce (score, id) by
//     shuffles, all 32 points at once. No score goes to device memory while
//     the tile fits in a CTA's shared memory (K <= cosine_max_k(), about
//     1,800). Above that the caller passes a (P, K) scratch and the tile
//     lives there instead (the L2 holds it between the products and the
//     selection); the passes, the selection and so the results are the same,
//     so K has no ceiling, as in the reference's wrapper.
//   * each (point, signature) score is one fmaf chain over ascending
//     features, starting from 0, whatever the tile (the features past q in
//     the last staged slice are zeros, and fmaf(0, 0, a) == a), so results
//     are the same from run to run.
//
// Plain C interface for ctypes; every entry point returns a cudaError_t.

#include <cuda_runtime.h>

namespace {

constexpr int kTileP = 32;     // points per CTA
constexpr int kChunkK = 128;   // signatures per product pass
constexpr int kChunkQ = 16;    // features per staged slice
constexpr int kThreads = 256;
constexpr int kMicroP = 4;     // points per thread
constexpr int kMicroK = 4;     // signatures per thread
constexpr int kWarpsK = 4;     // warps side by side along the signatures
constexpr int kLanesK = 8;     // lanes side by side along the signatures
static_assert(kWarpsK * kLanesK * kMicroK == kChunkK, "the warps span a pass");
static_assert((kThreads / 32 / kWarpsK) * (32 / kLanesK) * kMicroP == kTileP,
              "the warps span the tile");
constexpr int kLoadX = kTileP * kChunkQ / kThreads;    // slice values per thread
constexpr int kLoadS = kChunkK * kChunkQ / kThreads;
static_assert(kLoadX * kThreads == kTileP * kChunkQ, "whole point slices");
static_assert(kLoadS * kThreads == kChunkK * kChunkQ, "whole signature slices");
constexpr int kGroup = kThreads / kTileP;   // lanes that select one point's top k
static_assert(kGroup == 8, "the selection's shuffles span 8 lanes");
constexpr int kStrideX = kTileP + 4;    // xs[c][p]: float4-aligned rows
constexpr int kStrideS = kChunkK + 4;   // ss[c][k]
constexpr int kStaging = kChunkQ * (kStrideX + kStrideS);   // floats
constexpr size_t kSmemLimit = 232448;   // a CTA's opt-in maximum on sm_90
constexpr int kMaxDevices = 64;

size_t smem_bytes(int K, bool spill) {
  return sizeof(float) * ((spill ? 0 : (size_t)kTileP * (K + 1)) + kStaging);
}

// A score as an unsigned key in the order of a stable descending sort:
// NaN above +inf, -0 equal to +0, the rest as the floats order.
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

__global__ void __launch_bounds__(kThreads)
cosine_topk_kernel(const float* __restrict__ x, const float* __restrict__ s,
                   int P, int Q, int K, int k_top, int* __restrict__ labels,
                   float* __restrict__ scores, float* spill) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                          // [kChunkQ][kStrideX] point slice
  float* ss = xs + kChunkQ * kStrideX;       // [kChunkQ][kStrideS] signature slice
  const int t = threadIdx.x;
  const size_t p0 = (size_t)blockIdx.x * kTileP;
  // [kTileP][ks] scores: in shared memory, or this tile's rows of the spill
  const int ks = spill ? K : K + 1;
  float* sc = spill ? spill + p0 * K : ss + kChunkQ * kStrideS;
  const long long left = (long long)P - (long long)p0;
  const int np = left < kTileP ? (int)left : kTileP;   // points in this tile
  const int warp = t >> 5, lane = t & 31;
  // this thread's first point in the tile and first signature of a pass
  const int tp = ((warp / kWarpsK) * (32 / kLanesK) + lane / kLanesK) * kMicroP;
  const int tk = ((warp % kWarpsK) * kLanesK + lane % kLanesK) * kMicroK;

  // The slices are walked as one sequence of steps (signature pass, feature
  // slice). The next step's slice is loaded into registers while the
  // current one is multiplied, so the device-memory latency is hidden
  // behind the products.
  const int n_q = (Q + kChunkQ - 1) / kChunkQ;
  const int n_steps = n_q * ((K + kChunkK - 1) / kChunkK);
  float xr[kLoadX], sr[kLoadS];
  auto load = [&](int step) {
    const int k0 = (step / n_q) * kChunkK, q0 = (step % n_q) * kChunkQ;
#pragma unroll
    for (int j = 0; j < kLoadX; ++j) {
      const int i = t + j * kThreads, r = i / kChunkQ, c = q0 + i % kChunkQ;
      xr[j] = (r < np && c < Q) ? x[(p0 + r) * Q + c] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kLoadS; ++j) {
      const int i = t + j * kThreads, r = k0 + i / kChunkQ, c = q0 + i % kChunkQ;
      sr[j] = (r < K && c < Q) ? s[(size_t)r * Q + c] : 0.f;
    }
  };

  float acc[kMicroP][kMicroK];
#pragma unroll
  for (int i = 0; i < kMicroP; ++i)
#pragma unroll
    for (int j = 0; j < kMicroK; ++j) acc[i][j] = 0.f;
  load(0);
  for (int step = 0; step < n_steps; ++step) {
    __syncthreads();  // the previous slice is consumed
#pragma unroll
    for (int j = 0; j < kLoadX; ++j) {
      const int i = t + j * kThreads;
      xs[(i % kChunkQ) * kStrideX + i / kChunkQ] = xr[j];
    }
#pragma unroll
    for (int j = 0; j < kLoadS; ++j) {
      const int i = t + j * kThreads;
      ss[(i % kChunkQ) * kStrideS + i / kChunkQ] = sr[j];
    }
    __syncthreads();
    if (step + 1 < n_steps) load(step + 1);
#pragma unroll
    for (int c = 0; c < kChunkQ; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(xs + c * kStrideX + tp);
      const float4 b = *reinterpret_cast<const float4*>(ss + c * kStrideS + tk);
      const float av[kMicroP] = {a.x, a.y, a.z, a.w};
      const float bv[kMicroK] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < kMicroP; ++i)
#pragma unroll
        for (int j = 0; j < kMicroK; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (step % n_q == n_q - 1) {   // the pass's last slice: its scores are done
      const int k0 = (step / n_q) * kChunkK;
#pragma unroll
      for (int i = 0; i < kMicroP; ++i)
#pragma unroll
        for (int j = 0; j < kMicroK; ++j) {
          const int k = k0 + tk + j;
          if (tp + i < np && k < K) sc[(tp + i) * ks + k] = acc[i][j];
          acc[i][j] = 0.f;
        }
    }
  }
  __syncthreads();

  // k_top rounds of selection. kGroup lanes share a point (all 32 points
  // at once). Each (score, id) is one 64-bit rank, the score's key above
  // K - id, so a larger rank comes first in a stable descending sort and
  // no two ranks are equal. Round r takes the largest rank below round
  // r - 1's: each lane scans every kGroup-th score of its row, then the
  // group reduces by xor shuffles, so every lane holds the winner. Nothing
  // is masked, so no id is chosen twice even where scores are -inf or NaN;
  // every rank is at least 1 and below ~0, the two sentinels.
  const int r = t / kGroup, g = t % kGroup;
  const bool live = r < np;
  const float* row = sc + (size_t)r * ks;
  unsigned long long prev = ~0ull;
  for (int round = 0; round < k_top; ++round) {
    unsigned long long best = 0;
    if (live) {
      for (int k = g; k < K; k += kGroup) {
        const unsigned long long rank =
            ((unsigned long long)order_key(row[k]) << 32) | (unsigned)(K - k);
        if (rank < prev && rank > best) best = rank;
      }
    }
#pragma unroll
    for (int off = kGroup / 2; off > 0; off >>= 1) {
      const unsigned long long other = __shfl_xor_sync(0xffffffffu, best, off, kGroup);
      if (other > best) best = other;
    }
    if (live && g == 0) {
      const size_t out = (p0 + r) * (size_t)k_top + round;
      labels[out] = K - (int)(unsigned)best;
      scores[out] = key_score((unsigned)(best >> 32));
    }
    prev = best;
  }
}

}  // namespace

extern "C" {

const char* cosine_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The most signatures whose score tile fits in shared memory: the (kTileP,
// K) tile and the two staged slices must fit in a CTA's shared memory.
int cosine_max_k(void) {
  return (int)((kSmemLimit / sizeof(float) - (size_t)kStaging) / kTileP) - 1;
}

// x (P,Q), s (K,Q) -> labels (P,k_top) int32, scores (P,k_top), descending.
// K is the caller's k_valid: only the first K rows of s are read. spill is
// null, or a (P, K) float32 scratch that holds the score tiles; it is needed
// when K > cosine_max_k().
int cosine_topk_f32(const float* x, const float* s, int P, int Q, int K, int k_top,
                    int* labels, float* scores, float* spill, void* stream) {
  if (P < 1 || Q < 1 || K < 1 || k_top < 1 || k_top > K)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(K, spill != nullptr);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  // Raise the kernel's dynamic shared-memory limit once per device and
  // larger size, so steady-state launches (and launches captured in a CUDA
  // graph) make no attribute call. The limit is an attribute of the current
  // device, the one the launch goes to: the wrapper makes the tensors'
  // device current first. Racing threads at worst set the same value twice.
  static size_t opted_in[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > 48 * 1024 && smem > opted_in[dev]) {
    err = cudaFuncSetAttribute(cosine_topk_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[dev] = smem;
  }
  const unsigned grid = (unsigned)(((size_t)P + kTileP - 1) / kTileP);
  cosine_topk_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, s, P, Q, K, k_top, labels, scores, spill);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
