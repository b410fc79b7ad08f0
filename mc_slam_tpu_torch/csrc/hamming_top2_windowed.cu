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
// What bounds it on this card: integer issue, not bytes. At the tracking
// shapes (M = 16384, N = 1024) there are ~17 M pairs and under 1 MB to read
// (packed 32-byte descriptors, uv, level, valid). A dense XOR + popcount
// over every pair would cost 8 popc + 8 xor + adds per pair; the window gate
// at 4-15 px on a 752x480 frame passes well under 1% of pairs. So the design
// tests the cheap gate FIRST (2 float subtracts, 3 compares) and computes
// the distance only for survivors.
//
// Distance: XOR + __popc over the 8 packed 32-bit words of each descriptor
// (the bits of Features.desc / MapState.mp_desc, held as int32). It is the
// exact integer Hamming distance, reads 32 bytes per descriptor instead of
// the 256 of the int8 +/-1 rows, and needs no tensor-core tile shapes.
//
// Layout: one thread per query row, its 8 words in registers; the candidate
// set is staged tile by tile through shared memory and walked in ascending
// column order, so strict '<' for best keeps ties on the lowest column.
// Any M and N: the ragged edges are masked.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBig = 10000;
constexpr int kThreads = 128;
constexpr int kTileN = 256;

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
  __shared__ uint32_t s_desc[kTileN][8];
  __shared__ float2 s_uv[kTileN];
  __shared__ int32_t s_lvl[kTileN];   // INT32_MIN marks an invalid candidate

  const int row = blockIdx.x * kThreads + threadIdx.x;
  const bool active = row < M && a_valid[row] != 0;

  uint32_t q[8];
  float qu = 0.f, qv = 0.f;
  int ql = 0;
  if (active) {
#pragma unroll
    for (int w = 0; w < 8; ++w) q[w] = static_cast<uint32_t>(a_desc[row * 8 + w]);
    qu = a_uv[row * 2 + 0];
    qv = a_uv[row * 2 + 1];
    ql = a_lvl[row];
  }

  int best = kBig, second = kBig, bidx = 0;
  for (int base = 0; base < N; base += kTileN) {
    const int n_tile = min(kTileN, N - base);
    for (int j = threadIdx.x; j < n_tile; j += kThreads) {
      const int c = base + j;
#pragma unroll
      for (int w = 0; w < 8; ++w)
        s_desc[j][w] = static_cast<uint32_t>(b_desc[c * 8 + w]);
      s_uv[j] = make_float2(b_uv[c * 2 + 0], b_uv[c * 2 + 1]);
      s_lvl[j] = b_valid[c] ? b_lvl[c] : INT32_MIN;
    }
    __syncthreads();
    if (active) {
      for (int j = 0; j < n_tile; ++j) {
        const int cl = s_lvl[j];
        if (cl == INT32_MIN) continue;
        const float2 cuv = s_uv[j];
        // same float32 arithmetic as the JAX gate: |a - b| < r per axis
        if (!(fabsf(qu - cuv.x) < radius) || !(fabsf(qv - cuv.y) < radius)) continue;
        const int dl = ql - cl;
        if (dl > level_tol || -dl > level_tol) continue;
        int d = 0;
#pragma unroll
        for (int w = 0; w < 8; ++w) d += __popc(q[w] ^ s_desc[j][w]);
        if (d < best) {
          second = best;
          best = d;
          bidx = base + j;
        } else if (d < second) {
          second = d;
        }
      }
    }
    __syncthreads();
  }
  if (row < M) {
    best_out[row] = best;
    second_out[row] = second;
    idx_out[row] = bidx;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Every pointer and the stream are
// passed as void*; returns cudaGetLastError() of the launch (0 = success).
extern "C" int hamming_top2_windowed_launch(
    const void* a_desc, const void* a_uv, const void* a_lvl, const void* a_valid,
    const void* b_desc, const void* b_uv, const void* b_lvl, const void* b_valid,
    float radius, int level_tol, int M, int N,
    void* best, void* second, void* idx, void* stream) {
  if (M <= 0) return 0;
  const dim3 grid((M + kThreads - 1) / kThreads);
  hamming_top2_windowed_kernel<<<grid, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a_desc), static_cast<const float*>(a_uv),
      static_cast<const int32_t*>(a_lvl), static_cast<const uint8_t*>(a_valid),
      static_cast<const int32_t*>(b_desc), static_cast<const float*>(b_uv),
      static_cast<const int32_t*>(b_lvl), static_cast<const uint8_t*>(b_valid),
      radius, level_tol, M, N, static_cast<int32_t*>(best),
      static_cast<int32_t*>(second), static_cast<int32_t*>(idx));
  return static_cast<int>(cudaGetLastError());
}
