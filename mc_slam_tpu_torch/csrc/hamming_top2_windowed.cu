// Windowed Hamming top-2 projection search for NVIDIA Hopper (sm_90a).
//
// Replaces mc_slam_tpu/frontend/match_pallas.py::hamming_top2_windowed, the
// TPU kernel of every tracked frame's projection search: M map points
// (queries) against N frame features (candidates). For each query row it
// returns, over the candidates that pass the gate
//     |du| < r, |dv| < r, |dlevel| <= level_tol, both sides valid,
// best   = min Hamming distance (BIG = 10000 when nothing passes),
// idx    = its column, ties to the LOWEST column (0 when nothing passes),
// second = min over every other column, so an equal distance elsewhere gives
//          second == best.
//
// What bounds it on this card: operations, not bytes. At the tracking shapes
// (M = 16384, N = 1024) the inputs and outputs are ~1 MB, while the gate has
// to be evaluated for all ~17 M (query, candidate) pairs at ~8 float/int
// operations a pair; the popcount runs for the ~0.1-1 % of pairs that pass
// and adds little. The first version of this kernel (one thread per query,
// 128-thread blocks, so 128 blocks of 4 warps on 132 SMs) was bound by
// neither: each thread walked the 1024 candidates through a dependent chain
// of shared-memory loads and branches with one warp per scheduler, and the
// card showed 67 / 81 / 103 us at r = 4 / 15 / 40 px: latency, not issue.
// This version takes 14 / 15 / 21 us there (H100 80GB HBM3, 700 W; bound
// ~3.5 us). Group sizes 4-32, 128- or 256-thread blocks, unrolls 2-8 and
// 2-8 queries per group all land within 13-17 us at r = 15, so what is left
// is the gate's instruction issue plus launch and staging, not occupancy and
// not the shared-memory pipe; visiting only the image cells a window
// overlaps (bucketing the candidates) is the step not taken.
//
// What this design does about it:
// * kGroup lanes share one query. Lane g walks candidates g, g + kGroup, ...
//   and keeps its own (best, column, second); the group merges with
//   __shfl_xor_sync. That gives M * kGroup / kThreads blocks (512 at the
//   tracking shapes) and tens of resident warps per SM to hide latency.
// * The gate data of a candidate is ONE 16-byte shared-memory word
//   (u, v, level bits, unused); an invalid candidate has u = NaN, so no
//   comparison with it passes and the gate needs no validity branch. Lanes
//   of different groups in a warp read the same word (a broadcast).
// * kUnroll candidates are gated per iteration without branches; the
//   popcount path is entered only if one of them passed. Descriptors of the
//   candidates stay in global memory (32 KB, L1-resident) because well under
//   1 % of pairs read them; the query's 8 words sit in registers, loaded as
//   two 16-byte words.
// * The float32 gate arithmetic is the JAX gate's (|a - b| < r per axis, no
//   fast-math), so borderline pairs agree with the twin.
//
// The merge keeps the contract whatever order lanes saw the columns in:
// best = the lowest (distance, column) pair; second = min(second_a,
// second_b, the losing side's best). Rows where nothing passes keep BIG and
// column 0 on every lane, and so after the merge.
//
// Distance: XOR + __popc over the 8 packed 32-bit words of each descriptor
// (the bits of Features.desc / MapState.mp_desc, held as int32): the exact
// integer Hamming distance. Any M and N: ragged edges are NaN-padded, and
// N above kMaxTile is walked tile by tile.
//
// Batches: B independent problems of the same (M, N) in ONE launch (the
// port of the batch axis that jax.vmap gives the Pallas grid; the B
// sequences of parallel/multiseq.py). blockIdx.y is the problem: its
// queries, candidates and outputs start at row b * M (queries, outputs) and
// b * N (candidates), and each block stages its own problem's candidates in
// shared memory. One problem is B = 1, with the grid it always had.
#include <cstdint>
#include <cuda_runtime.h>

#ifndef HT2W_GROUP
#define HT2W_GROUP 8
#endif
#ifndef HT2W_THREADS
#define HT2W_THREADS 256
#endif
#ifndef HT2W_UNROLL
#define HT2W_UNROLL 4
#endif

namespace {

constexpr int kBig = 10000;
constexpr int kGroup = HT2W_GROUP;       // lanes per query (power of two <= 32)
constexpr int kThreads = HT2W_THREADS;   // threads per block
constexpr int kUnroll = HT2W_UNROLL;     // candidates gated per lane per iteration
constexpr int kStep = kGroup * kUnroll;  // candidates per group per iteration
constexpr int kMaxTile = 2048;           // candidates resident in shared memory
constexpr int kRowsPerBlock = kThreads / kGroup;

static_assert(kGroup >= 1 && kGroup <= 32 && (kGroup & (kGroup - 1)) == 0,
              "group must be a power of two within a warp");
static_assert(kThreads % 32 == 0 && kThreads % kGroup == 0, "block shape");
static_assert(kMaxTile % kStep == 0, "tile must hold whole iterations");

struct Top2 {
  int best, second, idx;
};

__device__ __forceinline__ void top2_insert(Top2& t, int d, int col) {
  // columns arrive in ascending order on one lane: strict '<' keeps the
  // lowest column among equals, and an equal distance lands in `second`
  if (d < t.best) {
    t.second = t.best;
    t.best = d;
    t.idx = col;
  } else if (d < t.second) {
    t.second = d;
  }
}

__device__ __forceinline__ Top2 top2_merge(const Top2& a, const Top2& b) {
  const bool a_wins = a.best < b.best || (a.best == b.best && a.idx <= b.idx);
  Top2 out;
  out.best = a_wins ? a.best : b.best;
  out.idx = a_wins ? a.idx : b.idx;
  const int loser = a_wins ? b.best : a.best;
  out.second = min(min(a.second, b.second), loser);
  return out;
}

__global__ void __launch_bounds__(kThreads)
hamming_top2_windowed_kernel(const int32_t* __restrict__ a_desc,   // (M, 8)
                             const float* __restrict__ a_uv,       // (M, 2)
                             const int32_t* __restrict__ a_lvl,    // (M,)
                             const uint8_t* __restrict__ a_valid,  // (M,)
                             const int32_t* __restrict__ b_desc,   // (N, 8)
                             const float* __restrict__ b_uv,       // (N, 2)
                             const int32_t* __restrict__ b_lvl,    // (N,)
                             const uint8_t* __restrict__ b_valid,  // (N,)
                             float radius, int level_tol, int M, int N,
                             int32_t* __restrict__ best_out,
                             int32_t* __restrict__ second_out,
                             int32_t* __restrict__ idx_out) {
  extern __shared__ float4 s_gate[];   // (u, v, level bits, -); u = NaN: never passes

  // this block's problem: its rows of every table
  const size_t prob = blockIdx.y;
  a_desc += prob * M * 8;
  a_uv += prob * M * 2;
  a_lvl += prob * M;
  a_valid += prob * M;
  b_desc += prob * N * 8;
  b_uv += prob * N * 2;
  b_lvl += prob * N;
  b_valid += prob * N;
  best_out += prob * M;
  second_out += prob * M;
  idx_out += prob * M;

  const int g = threadIdx.x % kGroup;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kGroup;
  const bool active = row < M && a_valid[row] != 0;

  // the query: uv and level, and its 8 descriptor words as two 16-byte loads;
  // an inactive row keeps u = v = NaN and so passes no gate
  const float nan = __int_as_float(0x7fc00000);
  float qu = nan, qv = nan;
  int ql = 0;
  uint4 q0 = make_uint4(0, 0, 0, 0), q1 = q0;
  if (active) {
    const float2 uv = reinterpret_cast<const float2*>(a_uv)[row];
    qu = uv.x;
    qv = uv.y;
    ql = a_lvl[row];
    const uint4* qd = reinterpret_cast<const uint4*>(a_desc) + 2 * row;
    q0 = qd[0];
    q1 = qd[1];
  }
  const uint4* cand_desc = reinterpret_cast<const uint4*>(b_desc);

  Top2 t{kBig, kBig, 0};
  for (int base = 0; base < N; base += kMaxTile) {
    const int n_tile = min(kMaxTile, N - base);
    const int n_pad = (n_tile + kStep - 1) / kStep * kStep;
    for (int j = threadIdx.x; j < n_pad; j += kThreads) {
      float4 e = make_float4(nan, nan, 0.f, 0.f);
      if (j < n_tile && b_valid[base + j] != 0) {
        const float2 uv = reinterpret_cast<const float2*>(b_uv)[base + j];
        e = make_float4(uv.x, uv.y, __int_as_float(b_lvl[base + j]), 0.f);
      }
      s_gate[j] = e;
    }
    __syncthreads();
    for (int j0 = g; j0 < n_pad; j0 += kStep) {
      bool pass[kUnroll];
      bool any = false;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float4 c = s_gate[j0 + u * kGroup];
        const int dl = ql - __float_as_int(c.z);
        // same float32 arithmetic as the JAX gate: |a - b| < r per axis
        pass[u] = (fabsf(qu - c.x) < radius) & (fabsf(qv - c.y) < radius) &
                  (abs(dl) <= level_tol);
        any |= pass[u];
      }
      if (any) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (pass[u]) {
            const int col = base + j0 + u * kGroup;
            const uint4 c0 = __ldg(cand_desc + 2 * col);
            const uint4 c1 = __ldg(cand_desc + 2 * col + 1);
            const int d = __popc(q0.x ^ c0.x) + __popc(q0.y ^ c0.y) +
                          __popc(q0.z ^ c0.z) + __popc(q0.w ^ c0.w) +
                          __popc(q1.x ^ c1.x) + __popc(q1.y ^ c1.y) +
                          __popc(q1.z ^ c1.z) + __popc(q1.w ^ c1.w);
            top2_insert(t, d, col);
          }
        }
      }
    }
    __syncthreads();   // the next tile overwrites s_gate
  }

  // merge the group's lanes; every thread of the warp takes part
#pragma unroll
  for (int off = kGroup / 2; off > 0; off >>= 1) {
    Top2 o;
    o.best = __shfl_xor_sync(0xffffffffu, t.best, off);
    o.second = __shfl_xor_sync(0xffffffffu, t.second, off);
    o.idx = __shfl_xor_sync(0xffffffffu, t.idx, off);
    t = top2_merge(t, o);
  }
  if (g == 0 && row < M) {
    best_out[row] = t.best;
    second_out[row] = t.second;
    idx_out[row] = t.idx;
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes). Every pointer and the stream are
// passed as void*; each returns cudaGetLastError() of its launch (0 =
// success). The descriptor and uv tables must be 16- and 8-byte aligned:
// rows of a contiguous torch tensor are. The batched entry takes B problems
// stacked row-wise ((B, M, .) queries, (B, N, .) candidates, (B, M) outputs)
// and launches once; the single-problem entry is its B = 1 case.
extern "C" int hamming_top2_windowed_launch_batched(
    const void* a_desc, const void* a_uv, const void* a_lvl, const void* a_valid,
    const void* b_desc, const void* b_uv, const void* b_lvl, const void* b_valid,
    float radius, int level_tol, int B, int M, int N,
    void* best, void* second, void* idx, void* stream) {
  if (M <= 0 || B <= 0) return 0;
  if (B > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid((M + kRowsPerBlock - 1) / kRowsPerBlock, B);
  const int n_tile = N < kMaxTile ? N : kMaxTile;
  const size_t smem =
      static_cast<size_t>((n_tile + kStep - 1) / kStep * kStep) * sizeof(float4);
  hamming_top2_windowed_kernel<<<grid, kThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a_desc), static_cast<const float*>(a_uv),
      static_cast<const int32_t*>(a_lvl), static_cast<const uint8_t*>(a_valid),
      static_cast<const int32_t*>(b_desc), static_cast<const float*>(b_uv),
      static_cast<const int32_t*>(b_lvl), static_cast<const uint8_t*>(b_valid),
      radius, level_tol, M, N, static_cast<int32_t*>(best),
      static_cast<int32_t*>(second), static_cast<int32_t*>(idx));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hamming_top2_windowed_launch(
    const void* a_desc, const void* a_uv, const void* a_lvl, const void* a_valid,
    const void* b_desc, const void* b_uv, const void* b_lvl, const void* b_valid,
    float radius, int level_tol, int M, int N,
    void* best, void* second, void* idx, void* stream) {
  return hamming_top2_windowed_launch_batched(
      a_desc, a_uv, a_lvl, a_valid, b_desc, b_uv, b_lvl, b_valid, radius,
      level_tol, 1, M, N, best, second, idx, stream);
}
