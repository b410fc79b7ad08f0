// The pose LM of ba.pose_only_visual for NVIDIA Hopper (sm_90a): every
// Levenberg-Marquardt iteration of B body-pose problems, each against its
// own fixed world points, in ONE launch.
//
// Replaces no TPU kernel. The JAX package runs this loop (lm.lm_optimize
// over ba.pose_only_visual's closures) as one lax.scan that XLA fuses; the
// port ran it as eager PyTorch, ~250 small launches an iteration, so the
// host's launch cost and not the card set its time (about half of the
// batched localization step's launches). This kernel was added to take
// those launches away. Its plain twin is ba.pose_only_visual_ref, the same
// algorithm as PyTorch operators; the kernel repeats the twin's float32
// arithmetic, with sums taken in another order.
//
// What bounds it on this card: latency. At the batched step's shapes
// (B = 11, O = 1024 observations, 10 iterations) the work is 11 passes of
// ~280 float operations per observation (~35 MFLOP) over ~0.45 MB of
// inputs: 0.5 us at the card's float32 peak. What takes the time is the
// chain: each iteration is a 6x6 Cholesky solve on one thread, then a pass
// over the observations and a block reduction, and the next iteration
// needs the result. One launch there takes ~63 us (~68 us with a cold L2;
// H100 80GB HBM3, 700 W), ~5.7 us an iteration, on 11 of the 132 SMs.
//
// What this design does about it:
// * One block of 256 threads per problem (B blocks); the problem never
//   leaves the SM. A thread holds its observations in registers for the
//   whole solve (observation o = k * 256 + thread, k < 8, so O <= 2048),
//   gathered once from pts_w by obs.pt. One row count for every O keeps the
//   build to two instantiations (monocular, stereo), built at a run's first
//   launch; with instantiations for 1, 2, 4 and 8 rows a thread the build
//   took 13 s.
// * One pass per iteration, not two: the pass at the candidate pose gives
//   both its robust cost (the accept test) and its normal equations (H's 21
//   entries, g's 6). An accepted candidate's system is the next
//   iteration's; a rejected one leaves the pose and so the previous system,
//   which the kernel keeps (the twin linearizes the unchanged pose again:
//   the same numbers). A candidate that is not finite (a failed Cholesky) is
//   rejected without a pass, as the twin rejects it whatever its cost.
// * The 28 sums are a fixed-order reduction (a shuffle tree in each warp,
//   then the warps in order), so a launch gives the same bits every time.
// * The damping, the Cholesky solve, the retraction (R so3_exp(dphi)) and
//   the accept rule run on thread 0 from shared memory.
//
// Semantics, as ba.pose_only_visual_ref: residual rows of
// factors.reproj_xyz, or with ur the 3-row factors.reproj_xyz3 (rows with
// ur < 0 monocular, the u_right row's bf / z^2 term), a compile-time variant;
// weights info * truncated-Huber (lm.trunc_huber_weight) * valid * (z > 1e-6);
// cost sum valid * trunc-Huber, out-of-frustum rows on the plateau; damping
// H + diag(lam diag(H) + 1e-10); a non-positive or non-finite pivot gives a
// NaN step; accept iff the cost falls and the candidate is finite; lam x0.5
// on accept, x4 on reject, clamped to [1e-9, 1e6], from 1e-4; with rtol > 0
// the solve stops once an accepted step gains less than rtol relative. Then
// chi2 per row at the final pose, n_inlier = #(chi2 <= gate, z > 0, valid),
// and R through so3_normalize_fast's Gram-Schmidt.
//
// An index of obs.pt outside [0, Np) is clamped into it (the twin's gather
// would fault): the tracker's tables clamp theirs the same way.
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 8;   // observation rows a thread holds
constexpr int kMaxObs = kThreads * kPerThread;
constexpr int kSums = 28;      // H's lower triangle (21, row-major), g (6), the cost
constexpr int kCost = 27;

// The robust policy, formed at launch from the caller's gates (ba.CHI2_MONO,
// ba.CHI2_STEREO) and lm.HUBER_TRUNC, which stay its only owners, as the twin
// forms it: on a monocular problem T = HUBER_TRUNC d2, 0.3 T and the
// plateau (2 sqrt(HUBER_TRUNC) - 1) d2 as doubles rounded once to float32; in
// the 3-row variant float32 products of the per-row gate.
struct Robust {
  float d2_mono, d2_stereo;           // the chi2 gates
  float T_mono, T3_mono, plat_mono;   // monocular problems
  float trunc, plat_k;                // 3-row variant: T = trunc d2, plateau = plat_k d2
};

struct Args {
  const float* P0;      // (B, 3)
  const float* R0;      // (B, 3, 3)
  const float* pts;     // (B, Np, 3)
  const int64_t* pt;    // (B, O)
  const float* uv;      // (B, O, 2)
  const float* isig;    // (B, O)
  const float* valid;   // (B, O)
  const float* ur;      // (B, O) or null
  const float* fx; const float* fy; const float* cx; const float* cy;   // 0-d
  const float* Rcb;     // (3, 3)
  const float* tcb;     // (3,)
  const float* bf_ptr;  // 0-d or null (then bf)
  float bf;
  int O, Np, iters;
  float rtol;
  Robust rb;
  float* P;             // (B, 3)
  float* R;             // (B, 3, 3)
  float* chi2;          // (B, O)
  int64_t* n_in;        // (B,)
};

struct Cam {
  float fx, fy, cx, cy, bf;
  float Rcb[9], tcb[3];
  Robust rb;
};

__device__ __forceinline__ int tri(int i, int j) { return i * (i + 1) / 2 + j; }

// One observation's rows at the pose (P, R), Q = Rcb R^T: residuals r,
// pose Jacobian J (d/d[dP, dphi]), depth z and the row's gate d2.
template <bool kStereo>
struct Row {
  static constexpr int kR = kStereo ? 3 : 2;
  float r[kR];
  float J[kR][6];
  float z, d2;
};

template <bool kStereo, bool kJac>
__device__ __forceinline__ void eval_row(const Cam& c, const float* P, const float* R,
                                         const float* Q, const float* pw, float u,
                                         float v, float ur, Row<kStereo>& row) {
  const float d[3] = {pw[0] - P[0], pw[1] - P[1], pw[2] - P[2]};
  float Pb[3], Pc[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) Pb[i] = R[i] * d[0] + R[3 + i] * d[1] + R[6 + i] * d[2];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    Pc[i] = c.Rcb[3 * i] * Pb[0] + c.Rcb[3 * i + 1] * Pb[1] + c.Rcb[3 * i + 2] * Pb[2]
            + c.tcb[i];
  const float z = Pc[2];
  const float zs = fabsf(z) < 1e-9f ? 1e-9f : z;
  const float uh = c.fx * Pc[0] / zs + c.cx;
  const float vh = c.fy * Pc[1] / zs + c.cy;
  row.z = z;
  row.r[0] = uh - u;
  row.r[1] = vh - v;
  float st = 0.f;
  if constexpr (kStereo) {
    st = ur >= 0.f ? 1.f : 0.f;
    row.r[2] = st * (uh - c.bf / zs - ur);
    row.d2 = ur >= 0.f ? c.rb.d2_stereo : c.rb.d2_mono;
  } else {
    row.d2 = c.rb.d2_mono;
  }
  if constexpr (kJac) {
    const float iz = 1.f / zs;
    const float iz2 = iz * iz;
    // d(pixel)/d(Pc), camera.project_jacobian; the u_right row adds bf / z^2
    float jp[Row<kStereo>::kR][3] = {};
    jp[0][0] = c.fx * iz;
    jp[0][2] = -c.fx * Pc[0] * iz2;
    jp[1][1] = c.fy * iz;
    jp[1][2] = -c.fy * Pc[1] * iz2;
    if constexpr (kStereo) {
      jp[2][0] = st * jp[0][0];
      jp[2][2] = st * (jp[0][2] + c.bf / (zs * zs));
    }
#pragma unroll
    for (int q = 0; q < Row<kStereo>::kR; ++q) {
      float a[3];
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        row.J[q][m] = -(jp[q][0] * Q[m] + jp[q][1] * Q[3 + m] + jp[q][2] * Q[6 + m]);
        a[m] = jp[q][0] * c.Rcb[m] + jp[q][1] * c.Rcb[3 + m] + jp[q][2] * c.Rcb[6 + m];
      }
      // (Jpi Rcb) hat(Pb) = (Jpi Rcb) x Pb
      row.J[q][3] = a[1] * Pb[2] - a[2] * Pb[1];
      row.J[q][4] = a[2] * Pb[0] - a[0] * Pb[2];
      row.J[q][5] = a[0] * Pb[1] - a[1] * Pb[0];
    }
  }
}

template <bool kStereo>
__device__ __forceinline__ float row_chi2(const Row<kStereo>& row, float isig) {
  float s = row.r[0] * row.r[0] + row.r[1] * row.r[1];
  if constexpr (kStereo) s = s + row.r[2] * row.r[2];
  return s * isig;
}

// The pose (P, R) in shared memory and Q = Rcb R^T, in registers.
__device__ __forceinline__ void load_pose(const Cam& c, const float* pose, float* P,
                                          float* R, float* Q) {
#pragma unroll
  for (int i = 0; i < 3; ++i) P[i] = pose[i];
#pragma unroll
  for (int i = 0; i < 9; ++i) R[i] = pose[3 + i];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      Q[3 * i + j] = c.Rcb[3 * i] * R[3 * j] + c.Rcb[3 * i + 1] * R[3 * j + 1]
                     + c.Rcb[3 * i + 2] * R[3 * j + 2];
}

// This thread's share of the normal equations and of the robust cost at
// `pose`: acc[0..20] H (lower, row-major), acc[21..26] g, acc[27] the cost.
template <bool kStereo, int K>
__device__ __forceinline__ void linearize(const Cam& c, const float* pose, int O,
                                          const float (&pw)[K][3], const float (&uv)[K][2],
                                          const float (&ur)[K], const float (&isig)[K],
                                          const float (&valid)[K], float (&acc)[kSums]) {
  float P[3], R[9], Q[9];
  load_pose(c, pose, P, R, Q);
#pragma unroll
  for (int v = 0; v < kSums; ++v) acc[v] = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (k * kThreads + static_cast<int>(threadIdx.x) >= O) break;
    Row<kStereo> row;
    eval_row<kStereo, true>(c, P, R, Q, pw[k], uv[k][0], uv[k][1], ur[k], row);
    const float chi2 = row_chi2(row, isig[k]);
    const float d2 = row.d2;
    float T, T3, plateau;
    if constexpr (kStereo) {
      T = c.rb.trunc * d2;
      T3 = 0.3f * T;
      plateau = c.rb.plat_k * d2;
    } else {
      T = c.rb.T_mono;
      T3 = c.rb.T3_mono;
      plateau = c.rb.plat_mono;
    }
    // lm.trunc_huber_weight / trunc_huber_cost
    const float safe = fmaxf(chi2, 1e-12f);
    const float hw = chi2 <= d2 ? 1.f : sqrtf(d2 / safe);
    const float ramp = fminf(fmaxf((T - chi2) / T3, 0.f), 1.f);
    const float pos = row.z > 1e-6f ? 1.f : 0.f;
    const float w = isig[k] * (hw * ramp) * valid[k] * pos;
    const float hub = chi2 <= d2 ? chi2 : 2.f * sqrtf(d2 * safe) - d2;
    float rho = hub > plateau ? plateau : hub;
    rho = row.z > 1e-6f ? rho : plateau;
    acc[kCost] += valid[k] * rho;
#pragma unroll
    for (int q = 0; q < Row<kStereo>::kR; ++q) {
      float wj[6];
#pragma unroll
      for (int m = 0; m < 6; ++m) wj[m] = w * row.J[q][m];
#pragma unroll
      for (int m = 0; m < 6; ++m) {
#pragma unroll
        for (int n = 0; n <= m; ++n) acc[tri(m, n)] += wj[m] * row.J[q][n];
        acc[21 + m] += wj[m] * row.r[q];
      }
    }
  }
}

// Fixed-order block sum of acc into dst (shared); every thread returns
// after dst is written.
__device__ __forceinline__ void block_sum(float (&acc)[kSums], float (*red)[kSums],
                                          float* dst) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int v = 0; v < kSums; ++v) {
    float x = acc[v];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) red[warp][v] = x;
  }
  __syncthreads();
  if (threadIdx.x < kSums) {
    float s = red[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += red[w][threadIdx.x];
    dst[threadIdx.x] = s;
  }
  __syncthreads();
}

// The damped step: (H + diag(lam diag(H) + 1e-10)) dx = -g by Cholesky; NaN
// where a pivot is not positive (lm.cho_solve_nan).
__device__ void solve_step(const float* sys, float lam, float* dx) {
  float L[21];
  bool ok = true;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
#pragma unroll
    for (int i = j; i < 6; ++i) {
      float s = sys[tri(i, j)];
      if (i == j) s = s + (lam * s + 1e-10f);
#pragma unroll
      for (int k = 0; k < j; ++k) s -= L[tri(i, k)] * L[tri(j, k)];
      if (i == j) {
        ok = ok && (s > 0.f);
        L[tri(j, j)] = sqrtf(s);
      } else {
        L[tri(i, j)] = s / L[tri(j, j)];
      }
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = -sys[21 + i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= L[tri(i, k)] * y[k];
    y[i] = s / L[tri(i, i)];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s -= L[tri(k, i)] * dx[k];
    dx[i] = s / L[tri(i, i)];
  }
  if (!ok) {
#pragma unroll
    for (int i = 0; i < 6; ++i) dx[i] = __int_as_float(0x7fc00000);
  }
}

// cand = (P + dx[:3], R so3_exp(dx[3:])) (lie.so3_exp's Rodrigues form with
// its Taylor branch below 1e-6 rad); returns whether every entry is finite.
__device__ bool retract(const float* pose, const float* dx, float* cand) {
  const float p0 = dx[3], p1 = dx[4], p2 = dx[5];
  const float ts = p0 * p0 + p1 * p1 + p2 * p2;
  const bool small = ts < 1e-12f;
  const float ts_safe = small ? 1.f : ts;
  const float th = sqrtf(ts_safe);
  const float A = small ? 1.f - ts / 6.f + ts * ts / 120.f : sinf(th) / th;
  const float B = small ? 0.5f - ts / 24.f + ts * ts / 720.f : (1.f - cosf(th)) / ts_safe;
  const float W[9] = {0.f, -p2, p1, p2, 0.f, -p0, -p1, p0, 0.f};
  float E[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float ww = W[3 * i] * W[j] + W[3 * i + 1] * W[3 + j] + W[3 * i + 2] * W[6 + j];
      E[3 * i + j] = ((i == j ? 1.f : 0.f) + A * W[3 * i + j]) + B * ww;
    }
  bool finite = true;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    cand[i] = pose[i] + dx[i];
    finite = finite && isfinite(cand[i]);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float* R = pose + 3;
      const float x = R[3 * i] * E[j] + R[3 * i + 1] * E[3 + j] + R[3 * i + 2] * E[6 + j];
      cand[3 + 3 * i + j] = x;
      finite = finite && isfinite(x);
    }
  return finite;
}

template <bool kStereo, int K>
__global__ void __launch_bounds__(kThreads) pose_lm_kernel(const Args a) {
  __shared__ float s_pose[12], s_cand[12], s_sys[kSums], s_sum[kSums];
  __shared__ float s_red[kWarps][kSums];
  __shared__ int s_skip, s_stop, s_count[kWarps];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int O = a.O;

  Cam c;
  c.fx = *a.fx;
  c.fy = *a.fy;
  c.cx = *a.cx;
  c.cy = *a.cy;
  c.bf = a.bf_ptr != nullptr ? *a.bf_ptr : a.bf;
#pragma unroll
  for (int i = 0; i < 9; ++i) c.Rcb[i] = a.Rcb[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) c.tcb[i] = a.tcb[i];
  c.rb = a.rb;

  // this thread's observations, o = k * kThreads + tid
  float pw[K][3], uv[K][2], ur[K], isig[K], valid[K];
  const int64_t row0 = static_cast<int64_t>(b) * O;
  const float* pts = a.pts + static_cast<int64_t>(b) * a.Np * 3;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int o = k * kThreads + tid;
    pw[k][0] = pw[k][1] = pw[k][2] = 0.f;
    uv[k][0] = uv[k][1] = 0.f;
    ur[k] = -1.f;
    isig[k] = valid[k] = 0.f;
    if (o < O) {
      int64_t p = a.pt[row0 + o];
      p = p < 0 ? 0 : (p >= a.Np ? a.Np - 1 : p);
      pw[k][0] = pts[3 * p];
      pw[k][1] = pts[3 * p + 1];
      pw[k][2] = pts[3 * p + 2];
      uv[k][0] = a.uv[2 * (row0 + o)];
      uv[k][1] = a.uv[2 * (row0 + o) + 1];
      if constexpr (kStereo) ur[k] = a.ur[row0 + o];
      isig[k] = a.isig[row0 + o];
      valid[k] = a.valid[row0 + o];
    }
  }
  if (tid < 3) s_pose[tid] = a.P0[3 * b + tid];
  if (tid < 9) s_pose[3 + tid] = a.R0[9 * b + tid];
  __syncthreads();

  float acc[kSums];
  linearize<kStereo, K>(c, s_pose, O, pw, uv, ur, isig, valid, acc);
  block_sum(acc, s_red, s_sys);
  float lam = 1e-4f, cost = s_sys[kCost];   // thread 0's
  for (int it = 0; it < a.iters; ++it) {
    if (tid == 0) {
      float dx[6];
      solve_step(s_sys, lam, dx);
      s_skip = retract(s_pose, dx, s_cand) ? 0 : 1;
    }
    __syncthreads();
    const bool skip = s_skip != 0;
    if (!skip) {
      linearize<kStereo, K>(c, s_cand, O, pw, uv, ur, isig, valid, acc);
      block_sum(acc, s_red, s_sum);
    }
    if (tid == 0) {
      const bool accept = !skip && s_sum[kCost] < cost;
      const float cost2 = accept ? s_sum[kCost] : cost;
      const bool done = a.rtol > 0.f && accept
                        && (cost - cost2 < a.rtol * fmaxf(cost, 1e-12f));
      if (accept) {
        for (int i = 0; i < 12; ++i) s_pose[i] = s_cand[i];
        for (int i = 0; i < kSums; ++i) s_sys[i] = s_sum[i];
      }
      lam = fminf(fmaxf(accept ? lam * 0.5f : lam * 4.f, 1e-9f), 1e6f);
      cost = cost2;
      s_stop = done ? 1 : 0;
    }
    __syncthreads();
    if (s_stop) break;
  }

  // chi2 per row and the inlier count at the final pose
  {
    float P[3], R[9], Q[9];
    load_pose(c, s_pose, P, R, Q);
    int count = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int o = k * kThreads + tid;
      if (o >= O) break;
      Row<kStereo> row;
      eval_row<kStereo, false>(c, P, R, Q, pw[k], uv[k][0], uv[k][1], ur[k], row);
      const float chi2 = row_chi2(row, isig[k]);
      a.chi2[row0 + o] = chi2;
      count += (chi2 <= row.d2 && row.z > 0.f && valid[k] > 0.f) ? 1 : 0;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) count += __shfl_down_sync(0xffffffffu, count, off);
    if ((tid & 31) == 0) s_count[tid >> 5] = count;
  }
  __syncthreads();
  if (tid == 0) {
    int64_t n = 0;
    for (int w = 0; w < kWarps; ++w) n += s_count[w];
    a.n_in[b] = n;
    for (int i = 0; i < 3; ++i) a.P[3 * b + i] = s_pose[i];
    // lie.so3_normalize_fast
    const float* R = s_pose + 3;
    float r0[3] = {R[0], R[1], R[2]}, r1[3] = {R[3], R[4], R[5]};
    const float n0 = fmaxf(sqrtf(r0[0] * r0[0] + r0[1] * r0[1] + r0[2] * r0[2]), 1e-12f);
    for (int i = 0; i < 3; ++i) r0[i] = r0[i] / n0;
    const float d = r0[0] * r1[0] + r0[1] * r1[1] + r0[2] * r1[2];
    for (int i = 0; i < 3; ++i) r1[i] = r1[i] - d * r0[i];
    const float n1 = fmaxf(sqrtf(r1[0] * r1[0] + r1[1] * r1[1] + r1[2] * r1[2]), 1e-12f);
    for (int i = 0; i < 3; ++i) r1[i] = r1[i] / n1;
    float* Ro = a.R + 9 * b;
    for (int i = 0; i < 3; ++i) {
      Ro[i] = r0[i];
      Ro[3 + i] = r1[i];
    }
    Ro[6] = r0[1] * r1[2] - r0[2] * r1[1];
    Ro[7] = r0[2] * r1[0] - r0[0] * r1[2];
    Ro[8] = r0[0] * r1[1] - r0[1] * r1[0];
  }
}

}  // namespace

// B problems of O observations against Np points each, in one launch on
// `stream`; ur null: monocular rows. d2_mono / d2_stereo: the chi2 gates;
// huber_trunc: where the robust kernel goes flat, in gates. Returns the
// launch's cudaError_t.
extern "C" int pose_lm_launch(
    const void* P0, const void* R0, const void* pts, const void* pt, const void* uv,
    const void* isig, const void* valid, const void* ur, const void* fx, const void* fy,
    const void* cx, const void* cy, const void* Rcb, const void* tcb, const void* bf_ptr,
    float bf, int B, int O, int Np, int iters, float rtol, double d2_mono, double d2_stereo,
    double huber_trunc, void* P, void* R, void* chi2, void* n_in, void* stream) {
  if (B <= 0) return 0;
  if (O < 0 || O > kMaxObs || Np <= 0 || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.P0 = static_cast<const float*>(P0);
  a.R0 = static_cast<const float*>(R0);
  a.pts = static_cast<const float*>(pts);
  a.pt = static_cast<const int64_t*>(pt);
  a.uv = static_cast<const float*>(uv);
  a.isig = static_cast<const float*>(isig);
  a.valid = static_cast<const float*>(valid);
  a.ur = static_cast<const float*>(ur);
  a.fx = static_cast<const float*>(fx);
  a.fy = static_cast<const float*>(fy);
  a.cx = static_cast<const float*>(cx);
  a.cy = static_cast<const float*>(cy);
  a.Rcb = static_cast<const float*>(Rcb);
  a.tcb = static_cast<const float*>(tcb);
  a.bf_ptr = static_cast<const float*>(bf_ptr);
  a.bf = bf;
  a.O = O;
  a.Np = Np;
  a.iters = iters;
  a.rtol = rtol;
  const double plat_k = 2.0 * std::sqrt(huber_trunc) - 1.0;   // lm.trunc_plateau's factor
  a.rb.d2_mono = static_cast<float>(d2_mono);
  a.rb.d2_stereo = static_cast<float>(d2_stereo);
  a.rb.T_mono = static_cast<float>(huber_trunc * d2_mono);
  a.rb.T3_mono = static_cast<float>(0.3 * (huber_trunc * d2_mono));
  a.rb.plat_mono = static_cast<float>(plat_k * d2_mono);
  a.rb.trunc = static_cast<float>(huber_trunc);
  a.rb.plat_k = static_cast<float>(plat_k);
  a.P = static_cast<float*>(P);
  a.R = static_cast<float*>(R);
  a.chi2 = static_cast<float*>(chi2);
  a.n_in = static_cast<int64_t*>(n_in);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ur != nullptr) {
    pose_lm_kernel<true, kPerThread><<<B, kThreads, 0, s>>>(a);
  } else {
    pose_lm_kernel<false, kPerThread><<<B, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
