// The VI pose LM of ba_vi.pose_only_vi for NVIDIA Hopper (sm_90a): the
// joint (last, current) NavState solve of one VI frame, tied by the IMU PRV
// and bias random-walk edges, the last state held by its marginal prior, the
// map points fixed; every Levenberg-Marquardt iteration, the final chi2 and
// inlier count and the current state's 15x15 marginal in ONE launch.
//
// Replaces no TPU kernel. The JAX package runs this loop (lm.lm_optimize
// over ba_vi.pose_only_vi's closures) as one lax.scan that XLA fuses; the
// port ran it as eager PyTorch, ~1,300 small launches an iteration and
// ~26,400 a solve, two solves a VI frame, so the host's launch cost and not
// the card set the frame's time. This kernel was added to take those
// launches away. Its plain twin is ba_vi.pose_only_vi_ref, the same
// algorithm as PyTorch operators; the kernel repeats the twin's float32
// arithmetic, with sums taken in another order.
//
// What bounds it on this card: latency. At the tracker's shapes (O = 1024
// observation rows, 20 iterations) the work is ~22 passes of ~280 float
// operations per row plus ~60k operations of the 30-d system a pass (~7.9 M
// float operations): ~0.12 us at the card's float32 peak, on one SM. What
// takes the time is the chain of dependent iterations, each a 30x30
// Cholesky solve, a retraction, a pass over the rows, a block reduction and
// the assembly of the 30-d system, the next needing the last: one launch
// takes ~0.6 ms (H100 80GB HBM3, 700 W), ~27 us an iteration, of which the
// Cholesky and the two triangular solves on one warp take ~19 us.
//
// What this design does about it:
// * One block of 256 threads; the problem never leaves the SM. A thread
//   holds its observations in registers for the whole solve (observation
//   o = k * 256 + thread, k < 8, so O <= 2048), gathered once from pts_w by
//   obs.pt. Two instantiations (monocular, 3-row), as csrc/pose_lm.cu.
// * One pass per iteration, at the candidate state: it gives both the
//   candidate's total cost (the accept test) and its system. An accepted
//   candidate's system is the next iteration's; a rejected one leaves the
//   state and so the previous system, which the kernel keeps in a second
//   buffer (the twin linearizes the unchanged state again: the same
//   numbers). A candidate that is not finite (a failed Cholesky) is rejected
//   without a pass, as the twin rejects it whatever its cost.
// * The visual rows touch only the current state's [dP, dphi] block: 28
//   sums (its 21 lower entries, 6 of g, the robust cost) in a fixed-order
//   reduction (a shuffle tree in each warp, then the warps in order), so a
//   launch gives the same bits every time.
// * The PRV, bias and prior residuals and Jacobians do not depend on O: one
//   thread of each of three warps evaluates one factor into shared memory;
//   then all 256 threads form J^T (w Lambda) and the 30-d system's 465 lower
//   entries and g from it, factor by factor in the twin's order (visual,
//   PRV, bias, prior).
// * The damped 30x30 Cholesky runs on one warp, a lane a row held in
//   registers: a column step, then the trailing update across the lanes;
//   the triangular solves pass the unknowns along the lanes by shuffles.
//   The retraction of the two states runs on two lanes side by side.
// * The marginal: one more pass at the final state with the re-classified
//   rows, then Hcc - Hlc^T (Hll + 1e-8 I)^-1 Hlc, the 15x15 inverse applied
//   by Gaussian elimination with partial pivoting on one warp, a lane a
//   column of [Hll | Hlc] (the twin's torch.linalg.solve_ex is an LU too).
//
// Semantics, as ba_vi.pose_only_vi_ref (one round of lm.lm_two_phase with
// enable=False): state [last, current] x [dP, dphi, dV, ddbg, ddba]; visual
// rows of factors.reproj_xyz, or with ur the 3-row factors.reproj_xyz3 (rows
// with ur < 0 monocular) on the current state, weights info * truncated-Huber
// (lm.trunc_huber_weight) * valid * (z > 1e-6), cost sum valid * trunc-Huber
// with out-of-frustum rows on the plateau; factors.imu_prv with info_prv and
// factors.bias_rw with info_bias between the two; factors.prior_pr_v_bias on
// state prior.cam with prior.info x prior.valid; total cost the robust
// visual cost plus each factor's r^T (w Lambda) r; damping H + diag(lam
// diag(H) + 1e-10); a non-positive or non-finite pivot gives a NaN step;
// retract_states on both states; accept iff the total cost falls and the
// candidate is finite; lam x0.5 on accept, x4 on reject, clamped to [1e-9,
// 1e6], from 1e-4; with rtol > 0 the solve stops once an accepted step gains
// less than rtol relative. Then both rotations through so3_normalize_fast,
// chi2 per row at the current state, n_inliers = #(chi2 <= gate, z > 0,
// valid), and with the marginal the rows re-classified (chi2 <= gate, z >
// 1e-6) for its system.
//
// An index of obs.pt outside [0, Np) is clamped into it (the twin's gather
// would fault): the tracker's tables clamp theirs the same way. The prior's
// state index is clamped into {0, 1}.
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 8;   // observation rows a thread holds
constexpr int kMaxObs = kThreads * kPerThread;
constexpr int kVis = 28;        // visual sums: H's lower 6x6 (21), g (6), the cost
constexpr int kVisCost = 27;
constexpr int kDC = 15;         // a state's dims: dP, dphi, dV, ddbg, ddba
constexpr int kN = 2 * kDC;     // the system: [last, current]
constexpr int kTri = kN * (kN + 1) / 2;
constexpr int kG = kTri;        // a system buffer: H's lower triangle, g, the cost
constexpr int kCost = kTri + kN;
constexpr int kSys = kCost + 1;
constexpr int kRows = 30;       // factor rows: PRV 0-8, bias 9-14, prior 15-29
constexpr int kX = 27;          // a state in shared memory: P, R, V, bg, ba, dbg, dba
constexpr int oP = 0, oR = 3, oV = 12, oBG = 15, oBA = 18, oDBG = 21, oDBA = 24;
constexpr unsigned kFull = 0xffffffffu;

// The pointer table the wrapper passes (solver/pose_vi_lm_cuda.pose_only_vi_lm
// lists the same entries in the same order): NavStates in NavState's field
// order.
enum Ptr {
  kCurP, kCurV, kCurR, kCurBg, kCurBa, kCurDbg, kCurDba,
  kLastP, kLastV, kLastR, kLastBg, kLastBa, kLastDbg, kLastDba,
  kPreDP, kPreDV, kPreDR, kPreJPbg, kPreJPba, kPreJVbg, kPreJVba, kPreJRbg, kPreDT,
  kInfoPrv, kInfoBias,
  kPriorP, kPriorV, kPriorR, kPriorDbg, kPriorDba, kPriorInfo, kPriorCam, kPriorValid,
  kGw, kFx, kFy, kCx, kCy, kRcb, kTcb, kBf,
  kPts, kPt, kUv, kIsig, kValid, kUr,
  kOutState, kOutChi2, kOutNin, kOutHmarg,
  kNumPtrs
};

// The robust policy, formed at launch from the caller's gates (ba.CHI2_MONO,
// ba.CHI2_STEREO) and lm.HUBER_TRUNC, as csrc/pose_lm.cu forms it.
struct Robust {
  float d2_mono, d2_stereo;           // the chi2 gates
  float T_mono, T3_mono, plat_mono;   // monocular problems
  float trunc, plat_k;                // 3-row variant: T = trunc d2, plateau = plat_k d2
};

struct Args {
  const void* p[kNumPtrs];
  float bf;             // when p[kBf] is null
  int O, Np, iters, marg;
  float rtol;
  Robust rb;
};

template <typename T>
__device__ __forceinline__ const T* in(const Args& a, int i) {
  return static_cast<const T*>(a.p[i]);
}

template <typename T>
__device__ __forceinline__ T* out(const Args& a, int i) {
  return static_cast<T*>(const_cast<void*>(a.p[i]));
}

struct Cam {
  float fx, fy, cx, cy, bf;
  float Rcb[9], tcb[3];
  Robust rb;
};

struct Shared {
  float x[2][2][kX];       // [buffer][last, current]: the accepted state, the candidate
  float sys[2][kSys];      // the accepted state's system, the candidate's
  float J[kRows][kN];      // the factors' Jacobian rows over the 30 columns
  float r[kRows];          // and residuals
  float T[kN][kRows];      // J^T (w Lambda), factor by factor
  float info_p[9][9], info_b[6][6], info_q[15][15];   // w Lambda of each factor
  float qcost[3];          // r^T (w Lambda) r: PRV, bias, prior
  float pre[61];           // dP, dV, dR, J_P_bg, J_P_ba, J_V_bg, J_V_ba, J_R_bg, dT
  float gw[3];
  float prior[21];         // the prior's P, R, V, dbg, dba
  float vis[kVis];
  float red[kWarps][kVis];
  float A[kN][kN + 1];     // the Cholesky factor; the marginal's [Hll | Hlc]
  float col[kN];           // the factor's column of the current Cholesky step
  float dx[kN];
  int finite[2], count[kWarps];
};
constexpr int qDP = 0, qDV = 3, qDR = 6, qJPbg = 15, qJPba = 24, qJVbg = 33, qJVba = 42,
              qJRbg = 51, qDT = 60;

__device__ __forceinline__ int tri(int i, int j) { return i * (i + 1) / 2 + j; }

// ---------------------------------------------------------------------------
// 3x3 and SO(3) (lie.py's forms, float32; row-major 3x3)

__device__ __forceinline__ void mm3(const float* A, const float* B, float* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
}

// C = A^T B
__device__ __forceinline__ void mm3_tn(const float* A, const float* B, float* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[i] * B[j] + A[3 + i] * B[3 + j] + A[6 + i] * B[6 + j];
}

__device__ __forceinline__ void mv3(const float* M, const float* v, float* o) {
#pragma unroll
  for (int i = 0; i < 3; ++i) o[i] = M[3 * i] * v[0] + M[3 * i + 1] * v[1] + M[3 * i + 2] * v[2];
}

// (A, B, C) = (sin t / t, (1 - cos t) / t^2, (t - sin t) / t^3), Taylor forms
// below 1e-6 rad (lie._taylor_coeffs)
__device__ __forceinline__ void taylor(float ts, float& A, float& B, float& C) {
  const bool small = ts < 1e-12f;
  const float ts_safe = small ? 1.f : ts;
  const float th = sqrtf(ts_safe);
  const float st = sinf(th), ct = cosf(th);
  A = small ? (1.f - ts / 6.f) + ts * ts / 120.f : st / th;
  B = small ? (0.5f - ts / 24.f) + ts * ts / 720.f : (1.f - ct) / ts_safe;
  C = small ? (1.f / 6.f - ts / 120.f) + ts * ts / 5040.f : (th - st) / (ts_safe * th);
}

__device__ __forceinline__ float sq3(const float* p) {
  return p[0] * p[0] + p[1] * p[1] + p[2] * p[2];
}

// I + a W + b W^2, W = hat(phi)
__device__ __forceinline__ void rodrigues(const float* phi, float a, float b, float* M) {
  const float W[9] = {0.f, -phi[2], phi[1], phi[2], 0.f, -phi[0], -phi[1], phi[0], 0.f};
  float WW[9];
  mm3(W, W, WW);
#pragma unroll
  for (int i = 0; i < 9; ++i) M[i] = ((i % 4 == 0 ? 1.f : 0.f) + a * W[i]) + b * WW[i];
}

__device__ void so3_exp(const float* phi, float* E) {
  float A, B, C;
  taylor(sq3(phi), A, B, C);
  rodrigues(phi, A, B, E);
}

// right Jacobian I - B W + C W^2
__device__ void so3_jr(const float* phi, float* J) {
  float A, B, C;
  taylor(sq3(phi), A, B, C);
  rodrigues(phi, -B, C, J);
}

// inverse right Jacobian I + W / 2 + k W^2 (lie._jr_inv_coeff)
__device__ void so3_jr_inv(const float* phi, float* J) {
  const float ts = sq3(phi);
  const bool small = ts < 1e-12f;
  const float ts_safe = small ? 1.f : ts;
  const float t = sqrtf(ts_safe);
  const float st = sinf(t), ct = cosf(t);
  const float k = small ? (1.f / 12.f + ts / 720.f) + ts * ts / 30240.f
                        : 1.f / ts_safe - (1.f + ct) / ((2.f * t) * st);
  rodrigues(phi, 0.5f, k, J);
}

// lie.so3_log: through the quaternion of the largest of four pivots
// (so3_to_quat's first maximum), w >= 0
__device__ void so3_log(const float* R, float* phi) {
  const float r00 = R[0], r01 = R[1], r02 = R[2], r10 = R[3], r11 = R[4], r12 = R[5];
  const float r20 = R[6], r21 = R[7], r22 = R[8];
  const float t[4] = {((1.f + r00) + r11) + r22, ((1.f + r00) - r11) - r22,
                      ((1.f - r00) + r11) - r22, ((1.f - r00) - r11) + r22};
  int idx = 0;
#pragma unroll
  for (int i = 1; i < 4; ++i)
    if (t[i] > t[idx]) idx = i;
  float q[4];
  if (idx == 0) {
    q[0] = t[0]; q[1] = r21 - r12; q[2] = r02 - r20; q[3] = r10 - r01;
  } else if (idx == 1) {
    q[0] = r21 - r12; q[1] = t[1]; q[2] = r01 + r10; q[3] = r02 + r20;
  } else if (idx == 2) {
    q[0] = r02 - r20; q[1] = r01 + r10; q[2] = t[2]; q[3] = r12 + r21;
  } else {
    q[0] = r10 - r01; q[1] = r02 + r20; q[2] = r12 + r21; q[3] = t[3];
  }
  const float n = fmaxf(sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]), 1e-20f);
  const float sgn = q[0] / n < 0.f ? -1.f : 1.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = q[i] / n * sgn;
  const float vn = sqrtf(q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  const float theta = 2.f * atan2f(vn, q[0]);
  const bool small = vn < 1e-6f;
  const float scale = small ? 2.f / fmaxf(q[0], 0.5f) : theta / (small ? 1.f : vn);
#pragma unroll
  for (int i = 0; i < 3; ++i) phi[i] = scale * q[1 + i];
}

// lie.so3_normalize_fast, in place
__device__ void so3_normalize(float* R) {
  float r0[3] = {R[0], R[1], R[2]}, r1[3] = {R[3], R[4], R[5]};
  const float n0 = fmaxf(sqrtf(sq3(r0)), 1e-12f);
  for (int i = 0; i < 3; ++i) r0[i] = r0[i] / n0;
  const float d = r0[0] * r1[0] + r0[1] * r1[1] + r0[2] * r1[2];
  for (int i = 0; i < 3; ++i) r1[i] = r1[i] - d * r0[i];
  const float n1 = fmaxf(sqrtf(sq3(r1)), 1e-12f);
  for (int i = 0; i < 3; ++i) r1[i] = r1[i] / n1;
  for (int i = 0; i < 3; ++i) {
    R[i] = r0[i];
    R[3 + i] = r1[i];
  }
  R[6] = r0[1] * r1[2] - r0[2] * r1[1];
  R[7] = r0[2] * r1[0] - r0[0] * r1[2];
  R[8] = r0[0] * r1[1] - r0[1] * r1[0];
}

// ba_vi.retract_states on one state; returns whether every entry is finite
__device__ bool retract_state(const float* x, const float* d, float* c) {
  float E[9];
  so3_exp(d + 3, E);
  mm3(x + oR, E, c + oR);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    c[oP + i] = x[oP + i] + d[i];
    c[oV + i] = x[oV + i] + d[6 + i];
    c[oBG + i] = x[oBG + i];
    c[oBA + i] = x[oBA + i];
    c[oDBG + i] = x[oDBG + i] + d[9 + i];
    c[oDBA + i] = x[oDBA + i] + d[12 + i];
  }
  bool finite = true;
  for (int i = 0; i < kX; ++i) finite = finite && isfinite(c[i]);
  return finite;
}

// ---------------------------------------------------------------------------
// the camera-only factors (factors.imu_prv, bias_rw, prior_pr_v_bias), each
// on one thread: residual rows, the non-constant Jacobian entries, and the
// factor's r^T (w Lambda) r

__device__ float quad(const float* r, const float* L, int n) {
  float c = 0.f;
  for (int s = 0; s < n; ++s) {
    float t = 0.f;
    for (int q = 0; q < n; ++q) t += r[q] * L[q * n + s];
    c += t * r[s];
  }
  return c;
}

// PRV edge from the last state xi to the current xj: rows 0-8 [rP, rPhi, rV],
// columns 0-14 (last) and 15-23 (current's dP, dphi, dV; its bias columns
// stay zero)
__device__ void eval_prv(Shared& s, const float* xi, const float* xj) {
  const float* pre = s.pre;
  const float dT = pre[qDT], dT2 = dT * dT;
  const float* Ri = xi + oR;
  const float* Rj = xj + oR;
  const float* dbg = xi + oDBG;
  const float* dba = xi + oDBA;
  float RiT[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) RiT[3 * i + j] = Ri[3 * j + i];
  float t0[3], t1[3], pvec[3], vvec[3], a[3], b[3];
  mv3(pre + qJPbg, dbg, t0);
  mv3(pre + qJPba, dba, t1);
  float dPc[3], dVc[3];
  for (int i = 0; i < 3; ++i) dPc[i] = (pre[qDP + i] + t0[i]) + t1[i];
  mv3(pre + qJVbg, dbg, t0);
  mv3(pre + qJVba, dba, t1);
  for (int i = 0; i < 3; ++i) dVc[i] = (pre[qDV + i] + t0[i]) + t1[i];
  for (int i = 0; i < 3; ++i) {
    pvec[i] = ((xj[oP + i] - xi[oP + i]) - xi[oV + i] * dT) - (0.5f * s.gw[i]) * dT2;
    vvec[i] = (xj[oV + i] - xi[oV + i]) - s.gw[i] * dT;
  }
  mv3(RiT, pvec, a);
  mv3(RiT, vvec, b);
  float cphi[3], Ec[9], dRc[9], RiTRj[9], rR[9], rphi[3];
  mv3(pre + qJRbg, dbg, cphi);
  so3_exp(cphi, Ec);
  mm3(pre + qDR, Ec, dRc);
  mm3(RiT, Rj, RiTRj);
  mm3_tn(dRc, RiTRj, rR);
  so3_log(rR, rphi);
  for (int i = 0; i < 3; ++i) {
    s.r[i] = a[i] - dPc[i];
    s.r[3 + i] = rphi[i];
    s.r[6 + i] = b[i] - dVc[i];
  }
  float Jri[9], RjTRi[9], M[9];
  so3_jr_inv(rphi, Jri);
  mm3_tn(Rj, Ri, RjTRi);
  mm3(Jri, RjTRi, M);
  // d rPhi / d dbg_i = -(JrInv Exp(-rPhi)) (Jr(corr_phi) J_R_bg)
  float nphi[3] = {-rphi[0], -rphi[1], -rphi[2]}, En[9], A1[9], Jrc[9], A2[9], Jb[9];
  so3_exp(nphi, En);
  mm3(Jri, En, A1);
  so3_jr(cphi, Jrc);
  mm3(Jrc, pre + qJRbg, A2);
  mm3(A1, A2, Jb);
  const float ha[9] = {0.f, -a[2], a[1], a[2], 0.f, -a[0], -a[1], a[0], 0.f};
  const float hb[9] = {0.f, -b[2], b[1], b[2], 0.f, -b[0], -b[1], b[0], 0.f};
  for (int i = 0; i < 3; ++i) {
    float* rowP = s.J[i];
    float* rowR = s.J[3 + i];
    float* rowV = s.J[6 + i];
    for (int j = 0; j < 3; ++j) {
      const float Rt = RiT[3 * i + j];
      // last state: [dP, dphi] (J_pri), dV (J_vi), [ddbg, ddba] (J_bi)
      rowP[j] = -Rt;
      rowP[3 + j] = ha[3 * i + j];
      rowP[6 + j] = -Rt * dT;
      rowP[9 + j] = -pre[qJPbg + 3 * i + j];
      rowP[12 + j] = -pre[qJPba + 3 * i + j];
      rowR[j] = 0.f;
      rowR[3 + j] = -M[3 * i + j];
      rowR[6 + j] = 0.f;
      rowR[9 + j] = -Jb[3 * i + j];
      rowR[12 + j] = 0.f;
      rowV[j] = 0.f;
      rowV[3 + j] = hb[3 * i + j];
      rowV[6 + j] = -Rt;
      rowV[9 + j] = -pre[qJVbg + 3 * i + j];
      rowV[12 + j] = -pre[qJVba + 3 * i + j];
      // current state: [dP, dphi] (J_prj), dV (J_vj)
      rowP[15 + j] = Rt;
      rowP[18 + j] = 0.f;
      rowP[21 + j] = 0.f;
      rowR[15 + j] = 0.f;
      rowR[18 + j] = Jri[3 * i + j];
      rowR[21 + j] = 0.f;
      rowV[15 + j] = 0.f;
      rowV[18 + j] = 0.f;
      rowV[21 + j] = Rt;
    }
  }
  s.qcost[0] = quad(s.r, &s.info_p[0][0], 9);
}

// bias random walk: rows 9-14, r = [bg_j + dbg_j - (bg_i + dbg_i), ba ...];
// its Jacobian (-I on the last state's bias columns, +I on the current's)
// is constant
__device__ void eval_bias(Shared& s, const float* xi, const float* xj) {
  for (int i = 0; i < 3; ++i) {
    s.r[9 + i] = (xj[oBG + i] + xj[oDBG + i]) - (xi[oBG + i] + xi[oDBG + i]);
    s.r[12 + i] = (xj[oBA + i] + xj[oDBA + i]) - (xi[oBA + i] + xi[oDBA + i]);
  }
  s.qcost[1] = quad(s.r + 9, &s.info_b[0][0], 6);
}

// the prior on state xc (columns col0 ...): rows 15-29, r = [P - P0, Log(R0^T
// R), V - V0, dbg - dbg0, dba - dba0]; Jacobian block-diag(I, JrInv(rPhi),
// I, I, I), whose identity blocks are constant
__device__ void eval_prior(Shared& s, const float* xc, int col0) {
  const float* p0 = s.prior;
  float M[9], rphi[3], Jri[9];
  mm3_tn(p0 + 3, xc + oR, M);
  so3_log(M, rphi);
  for (int i = 0; i < 3; ++i) {
    s.r[15 + i] = xc[oP + i] - p0[i];
    s.r[18 + i] = rphi[i];
    s.r[21 + i] = xc[oV + i] - p0[12 + i];
    s.r[24 + i] = xc[oDBG + i] - p0[15 + i];
    s.r[27 + i] = xc[oDBA + i] - p0[18 + i];
  }
  so3_jr_inv(rphi, Jri);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) s.J[18 + i][col0 + 3 + j] = Jri[3 * i + j];
  s.qcost[2] = quad(s.r + 15, &s.info_q[0][0], 15);
}

// ---------------------------------------------------------------------------
// the visual rows (csrc/pose_lm.cu's, on the current state's pose)

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

// the pose (P, R) of a state and Q = Rcb R^T
__device__ __forceinline__ void load_pose(const Cam& c, const float* x, float* P, float* R,
                                          float* Q) {
#pragma unroll
  for (int i = 0; i < 3; ++i) P[i] = x[oP + i];
#pragma unroll
  for (int i = 0; i < 9; ++i) R[i] = x[oR + i];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      Q[3 * i + j] = c.Rcb[3 * i] * R[3 * j] + c.Rcb[3 * i + 1] * R[3 * j + 1]
                     + c.Rcb[3 * i + 2] * R[3 * j + 2];
}

// This thread's observation rows, gathered once.
template <int K>
struct Obs {
  float pw[K][3], uv[K][2], ur[K], isig[K];
};

// This thread's share of the visual sums at the current state x:
// acc[0..20] H (lower, row-major), acc[21..26] g, acc[27] the robust cost.
template <bool kStereo, int K>
__device__ __forceinline__ void visual(const Cam& c, const float* x, int O, const Obs<K>& ob,
                                       const float (&valid)[K], float (&acc)[kVis]) {
  float P[3], R[9], Q[9];
  load_pose(c, x, P, R, Q);
#pragma unroll
  for (int v = 0; v < kVis; ++v) acc[v] = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (k * kThreads + static_cast<int>(threadIdx.x) >= O) break;
    Row<kStereo> row;
    eval_row<kStereo, true>(c, P, R, Q, ob.pw[k], ob.uv[k][0], ob.uv[k][1], ob.ur[k], row);
    const float chi2 = row_chi2(row, ob.isig[k]);
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
    const float w = ob.isig[k] * (hw * ramp) * valid[k] * pos;
    const float hub = chi2 <= d2 ? chi2 : 2.f * sqrtf(d2 * safe) - d2;
    float rho = hub > plateau ? plateau : hub;
    rho = row.z > 1e-6f ? rho : plateau;
    acc[kVisCost] += valid[k] * rho;
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

// Fixed-order block sum of acc into s.vis; every thread returns after it is
// written (and after every earlier shared write of the block is visible).
__device__ __forceinline__ void block_sum(Shared& s, float (&acc)[kVis]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int v = 0; v < kVis; ++v) {
    float x = acc[v];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(kFull, x, off);
    if (lane == 0) s.red[warp][v] = x;
  }
  __syncthreads();
  if (threadIdx.x < kVis) {
    float t = s.red[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) t += s.red[w][threadIdx.x];
    s.vis[threadIdx.x] = t;
  }
  __syncthreads();
}

// the factor block of global row q: first row, size, w Lambda
__device__ __forceinline__ void factor_of(Shared& s, int q, int& f0, int& n, const float*& L) {
  if (q < 9) {
    f0 = 0; n = 9; L = &s.info_p[0][0];
  } else if (q < 15) {
    f0 = 9; n = 6; L = &s.info_b[0][0];
  } else {
    f0 = 15; n = 15; L = &s.info_q[0][0];
  }
}

// sum over the rows of one factor of T[a][q] v(q)
__device__ __forceinline__ float tdot(const Shared& s, int a, int f0, int n, const float* v,
                                      int stride) {
  float t = 0.f;
  for (int q = f0; q < f0 + n; ++q) t += s.T[a][q] * v[q * stride];
  return t;
}

// The whole system at the states x[2] into sys (H's lower triangle, g, the
// total cost), with the visual rows weighted by `valid`. Every thread of
// the block calls it; it returns after sys is written. Not inlined: with
// its three call sites inlined nvcc took 16.1 s for the two variants, not
// 8.3 s, for the same time a launch; the rows it reads stay in the thread's
// local memory, cached in L1.
template <bool kStereo, int K>
__device__ __noinline__ void linearize(Shared& s, const Cam& c, const float (*x)[kX],
                                          int prior_col, float* sys, int O, const Obs<K>& ob,
                                          const float (&valid)[K]) {
  const int tid = threadIdx.x;
  if (tid == 0) eval_prv(s, x[0], x[1]);
  if (tid == 32) eval_prior(s, x[prior_col / kDC], prior_col);
  if (tid == 64) eval_bias(s, x[0], x[1]);
  float acc[kVis];
  visual<kStereo, K>(c, x[1], O, ob, valid, acc);
  block_sum(s, acc);
  // T = J^T (w Lambda), factor by factor (lm.accumulate_cam_factors' JtW)
  for (int t = tid; t < kN * kRows; t += kThreads) {
    const int a = t / kRows, q = t % kRows;
    int f0, n;
    const float* L;
    factor_of(s, q, f0, n, L);
    float v = 0.f;
    for (int p = f0; p < f0 + n; ++p) v += s.J[p][a] * L[(p - f0) * n + (q - f0)];
    s.T[a][q] = v;
  }
  __syncthreads();
  // H = visual + PRV + bias + prior, g likewise, in the twin's order
  for (int t = tid; t < kTri + kN; t += kThreads) {
    int a, b;
    if (t < kTri) {
      a = static_cast<int>((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
      while (tri(a, 0) > t) --a;
      while (tri(a + 1, 0) <= t) ++a;
      b = t - tri(a, 0);
    } else {
      a = t - kTri;
      b = -1;
    }
    const bool vis = a >= kDC && a < kDC + 6 && (b < 0 || b >= kDC);
    float h;
    if (b >= 0) {
      h = vis ? s.vis[tri(a - kDC, b - kDC)] : 0.f;
      h += tdot(s, a, 0, 9, &s.J[0][b], kN);
      h += tdot(s, a, 9, 6, &s.J[0][b], kN);
      h += tdot(s, a, 15, 15, &s.J[0][b], kN);
    } else {
      h = vis ? s.vis[21 + a - kDC] : 0.f;
      h += tdot(s, a, 0, 9, s.r, 1);
      h += tdot(s, a, 9, 6, s.r, 1);
      h += tdot(s, a, 15, 15, s.r, 1);
    }
    sys[t] = h;
  }
  if (tid == 0) sys[kCost] = ((s.vis[kVisCost] + s.qcost[0]) + s.qcost[1]) + s.qcost[2];
  __syncthreads();
}

// Warp 0: the damped step (H + diag(lam diag(H) + 1e-10)) dx = -g by
// Cholesky into s.dx, all NaN where a pivot is not positive
// (lm.cho_solve_nan). Lane j holds row j of the factor in registers (the
// loops unrolled): a column step, then the trailing update, each lane its
// row against the column passed through shared memory; the forward solve
// passes the unknowns along the lanes by shuffles, the backward one reads
// the factor back from shared memory. With the row in shared memory and
// the update a loop, the update's loads waited on its stores: ~26 us a
// solve against ~19 us (H100 80GB HBM3).
__device__ void solve_step(Shared& s, const float* sys, float lam) {
  const int lane = threadIdx.x & 31;
  float row[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    float h = 0.f;
    if (lane < kN && i <= lane) {
      h = sys[tri(lane, i)];
      if (i == lane) h = h + (lam * h + 1e-10f);
    }
    row[i] = h;
  }
  bool ok = true;
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    const float d = __shfl_sync(kFull, row[k], k);
    ok = ok && (d > 0.f);
    const float l = sqrtf(d);
    if (lane == k) row[k] = l;
    else if (lane > k) row[k] = row[k] / l;
    if (lane < kN) s.col[lane] = row[k];
    __syncwarp();
#pragma unroll
    for (int i = k + 1; i < kN; ++i)
      if (i <= lane) row[i] -= row[k] * s.col[i];
    __syncwarp();
  }
  // L y = -g, then L^T dx = y; lane j carries entry j
  float b = lane < kN ? -sys[kG + lane] : 0.f;
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    const float yk = __shfl_sync(kFull, b, k) / __shfl_sync(kFull, row[k], k);
    if (lane == k) b = yk;
    else if (lane > k) b -= row[k] * yk;
  }
  auto& A = s.A;
  if (lane < kN) {
#pragma unroll
    for (int i = 0; i < kN; ++i)
      if (i <= lane) A[lane][i] = row[i];
  }
  __syncwarp();
#pragma unroll
  for (int k = kN - 1; k >= 0; --k) {
    const float xk = __shfl_sync(kFull, b, k) / A[k][k];
    if (lane == k) b = xk;
    else if (lane < k) b -= A[k][lane] * xk;
  }
  if (lane < kN) s.dx[lane] = ok ? b : __int_as_float(0x7fc00000);
  __syncwarp();
}

// Warp 0: X = (Hll + 1e-8 I)^-1 Hlc of the system sys into s.A[:15][15:30],
// by Gaussian elimination with partial pivoting on [Hll | Hlc] (lane c:
// column c), then back substitution on the Hlc columns.
__device__ void marginal(Shared& s, const float* sys) {
  const int lane = threadIdx.x & 31;
  auto& M = s.A;
  auto H = [&](int a, int b) { return a >= b ? sys[tri(a, b)] : sys[tri(b, a)]; };
  if (lane < kN) {
    for (int i = 0; i < kDC; ++i)
      M[i][lane] = lane < kDC ? H(i, lane) + (i == lane ? 1e-8f : 0.f) : H(i, lane);
  }
  __syncwarp();
  for (int k = 0; k < kDC; ++k) {
    int p = k;
    float best = fabsf(M[k][k]);
    for (int i = k + 1; i < kDC; ++i) {
      const float v = fabsf(M[i][k]);
      if (v > best) {
        best = v;
        p = i;
      }
    }
    if (lane < kN && p != k) {
      const float t = M[k][lane];
      M[k][lane] = M[p][lane];
      M[p][lane] = t;
    }
    __syncwarp();
    if (lane > k && lane < kN) {
      const float ukc = M[k][lane];
      for (int i = k + 1; i < kDC; ++i) M[i][lane] -= (M[i][k] / M[k][k]) * ukc;
    }
    __syncwarp();
  }
  if (lane >= kDC && lane < kN) {
    for (int k = kDC - 1; k >= 0; --k) {
      float t = M[k][lane];
      for (int j = k + 1; j < kDC; ++j) t -= M[k][j] * M[j][lane];
      M[k][lane] = t / M[k][k];
    }
  }
  __syncwarp();
}

template <bool kStereo, int K>
__global__ void __launch_bounds__(kThreads) pose_vi_lm_kernel(const Args a) {
  __shared__ Shared s;
  const int tid = threadIdx.x;
  const int O = a.O;

  Cam c;
  c.fx = *in<float>(a, kFx);
  c.fy = *in<float>(a, kFy);
  c.cx = *in<float>(a, kCx);
  c.cy = *in<float>(a, kCy);
  c.bf = a.p[kBf] != nullptr ? *in<float>(a, kBf) : a.bf;
#pragma unroll
  for (int i = 0; i < 9; ++i) c.Rcb[i] = in<float>(a, kRcb)[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) c.tcb[i] = in<float>(a, kTcb)[i];
  c.rb = a.rb;

  // this thread's observations, o = k * kThreads + tid
  Obs<K> ob;
  float valid[K];
  const float* pts = in<float>(a, kPts);
  const int64_t* pt = in<int64_t>(a, kPt);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int o = k * kThreads + tid;
    ob.pw[k][0] = ob.pw[k][1] = ob.pw[k][2] = 0.f;
    ob.uv[k][0] = ob.uv[k][1] = 0.f;
    ob.ur[k] = -1.f;
    ob.isig[k] = valid[k] = 0.f;
    if (o < O) {
      int64_t p = pt[o];
      p = p < 0 ? 0 : (p >= a.Np ? a.Np - 1 : p);
      ob.pw[k][0] = pts[3 * p];
      ob.pw[k][1] = pts[3 * p + 1];
      ob.pw[k][2] = pts[3 * p + 2];
      ob.uv[k][0] = in<float>(a, kUv)[2 * o];
      ob.uv[k][1] = in<float>(a, kUv)[2 * o + 1];
      if constexpr (kStereo) ob.ur[k] = in<float>(a, kUr)[o];
      ob.isig[k] = in<float>(a, kIsig)[o];
      valid[k] = in<float>(a, kValid)[o];
    }
  }

  // the states, the preintegration, gravity, the prior and the constant
  // Jacobian entries
  int64_t cam = *in<int64_t>(a, kPriorCam);
  const int prior_col = (cam <= 0 ? 0 : 1) * kDC;
  const float pw_prior = *in<float>(a, kPriorValid);
  for (int t = tid; t < kRows * kN; t += kThreads) (&s.J[0][0])[t] = 0.f;
  if (tid < 2 * kX) {
    const int st = tid / kX, f = tid % kX;
    const int base = st == 0 ? kLastP : kCurP;
    // shared layout P, R, V, bg, ba, dbg, dba from NavState's P, V, R, ...
    float v;
    if (f < oR) v = in<float>(a, base + 0)[f];
    else if (f < oV) v = in<float>(a, base + 2)[f - oR];
    else {
      const int g = (f - oV) / 3;   // V, bg, ba, dbg, dba
      v = in<float>(a, base + (g == 0 ? 1 : g + 2))[(f - oV) % 3];
    }
    s.x[0][st][f] = v;
  }
  if (tid < 81) (&s.info_p[0][0])[tid] = in<float>(a, kInfoPrv)[tid];
  if (tid < 36) (&s.info_b[0][0])[tid] = in<float>(a, kInfoBias)[tid];
  if (tid < 225) (&s.info_q[0][0])[tid] = in<float>(a, kPriorInfo)[tid] * pw_prior;
  if (tid < 61) {
    const int fields[9] = {kPreDP, kPreDV, kPreDR, kPreJPbg, kPreJPba, kPreJVbg, kPreJVba,
                           kPreJRbg, kPreDT};
    const int starts[10] = {qDP, qDV, qDR, qJPbg, qJPba, qJVbg, qJVba, qJRbg, qDT, 61};
    int f = 0;
    while (tid >= starts[f + 1]) ++f;
    s.pre[tid] = in<float>(a, fields[f])[tid - starts[f]];
  }
  if (tid < 3) s.gw[tid] = in<float>(a, kGw)[tid];
  if (tid < 21) {
    float v;
    if (tid < 3) v = in<float>(a, kPriorP)[tid];
    else if (tid < 12) v = in<float>(a, kPriorR)[tid - 3];
    else if (tid < 15) v = in<float>(a, kPriorV)[tid - 12];
    else if (tid < 18) v = in<float>(a, kPriorDbg)[tid - 15];
    else v = in<float>(a, kPriorDba)[tid - 18];
    s.prior[tid] = v;
  }
  __syncthreads();
  if (tid < 6) {
    s.J[9 + tid][9 + tid] = -1.f;
    s.J[9 + tid][kDC + 9 + tid] = 1.f;
  }
  if (tid >= 32 && tid < 32 + 15 && (tid - 32 < 3 || tid - 32 >= 6))
    s.J[15 + tid - 32][prior_col + tid - 32] = 1.f;
  __syncthreads();

  int cur = 0;   // the buffer of the accepted state and its system
  linearize<kStereo, K>(s, c, s.x[cur], prior_col, s.sys[cur], O, ob, valid);
  float lam = 1e-4f, cost = s.sys[cur][kCost];
  for (int it = 0; it < a.iters; ++it) {
    if (tid < 32) {
      solve_step(s, s.sys[cur], lam);
      if (tid < 2) s.finite[tid] = retract_state(s.x[cur][tid], s.dx + kDC * tid,
                                                 s.x[cur ^ 1][tid]) ? 1 : 0;
    }
    __syncthreads();
    const bool skip = !(s.finite[0] && s.finite[1]);
    if (!skip) linearize<kStereo, K>(s, c, s.x[cur ^ 1], prior_col, s.sys[cur ^ 1], O, ob, valid);
    const float c_new = s.sys[cur ^ 1][kCost];
    const bool accept = !skip && c_new < cost;
    const float cost2 = accept ? c_new : cost;
    const bool done = a.rtol > 0.f && accept && (cost - cost2 < a.rtol * fmaxf(cost, 1e-12f));
    if (accept) cur ^= 1;
    lam = fminf(fmaxf(accept ? lam * 0.5f : lam * 4.f, 1e-9f), 1e6f);
    cost = cost2;
    __syncthreads();
    if (done) break;
  }

  // both rotations normalized; chi2 per row and the inliers at the current
  // state; the rows the marginal keeps
  if (tid < 2) so3_normalize(s.x[cur][tid] + oR);
  __syncthreads();
  float* chi2_out = out<float>(a, kOutChi2);
  float vc[K];
  {
    float P[3], R[9], Q[9];
    load_pose(c, s.x[cur][1], P, R, Q);
    int count = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int o = k * kThreads + tid;
      vc[k] = 0.f;
      if (o >= O) continue;
      Row<kStereo> row;
      eval_row<kStereo, false>(c, P, R, Q, ob.pw[k], ob.uv[k][0], ob.uv[k][1], ob.ur[k], row);
      const float chi2 = row_chi2(row, ob.isig[k]);
      chi2_out[o] = chi2;
      count += (chi2 <= row.d2 && row.z > 0.f && valid[k] > 0.f) ? 1 : 0;
      vc[k] = valid[k] * ((chi2 <= row.d2 && row.z > 1e-6f) ? 1.f : 0.f);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) count += __shfl_down_sync(kFull, count, off);
    if ((tid & 31) == 0) s.count[tid >> 5] = count;
  }
  __syncthreads();
  float* out_state = out<float>(a, kOutState);
  float* out_H = out<float>(a, kOutHmarg);
  if (tid == 0) {
    int64_t n = 0;
    for (int w = 0; w < kWarps; ++w) n += s.count[w];
    *out<int64_t>(a, kOutNin) = n;
  }
  if (tid < kX) {
    // NavState's order: P, V, R, bg, ba, dbg, dba
    const float* x = s.x[cur][1];
    const int f = tid;
    float v;
    if (f < 3) v = x[oP + f];
    else if (f < 6) v = x[oV + f - 3];
    else if (f < 15) v = x[oR + f - 6];
    else v = x[f];
    out_state[f] = v;
  }
  if (a.marg) {
    linearize<kStereo, K>(s, c, s.x[cur], prior_col, s.sys[cur ^ 1], O, ob, vc);
    if (tid < 32) marginal(s, s.sys[cur ^ 1]);
    __syncthreads();
    const float* sys = s.sys[cur ^ 1];
    auto H = [&](int i, int j) { return i >= j ? sys[tri(i, j)] : sys[tri(j, i)]; };
    for (int t = tid; t < kDC * kDC; t += kThreads) {
      const int i = t / kDC, j = t % kDC;
      float v = 0.f;
      for (int k = 0; k < kDC; ++k) v += H(kDC + i, k) * s.A[k][kDC + j];
      out_H[t] = H(kDC + i, kDC + j) - v;
    }
  } else {
    for (int t = tid; t < kDC * kDC; t += kThreads) out_H[t] = 0.f;
  }
}

}  // namespace

// One joint (last, current) VI pose solve of O rows against Np points, in
// one launch on `stream`. ptrs: kNumPtrs device pointers in the Ptr order
// (p[kBf] null: bf; p[kUr] null: monocular rows); marg: whether to form the
// marginal (else H_marg is zeros); d2_mono / d2_stereo: the chi2 gates;
// huber_trunc: where the robust kernel goes flat, in gates. Returns the
// launch's cudaError_t.
extern "C" int pose_vi_lm_launch(const void* const* ptrs, int n_ptrs, float bf, int O, int Np,
                                 int iters, float rtol, int marg, double d2_mono,
                                 double d2_stereo, double huber_trunc, void* stream) {
  if (n_ptrs != kNumPtrs || O < 0 || O > kMaxObs || Np <= 0 || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  for (int i = 0; i < kNumPtrs; ++i) a.p[i] = ptrs[i];
  a.bf = bf;
  a.O = O;
  a.Np = Np;
  a.iters = iters;
  a.marg = marg;
  a.rtol = rtol;
  const double plat_k = 2.0 * std::sqrt(huber_trunc) - 1.0;   // lm.trunc_plateau's factor
  a.rb.d2_mono = static_cast<float>(d2_mono);
  a.rb.d2_stereo = static_cast<float>(d2_stereo);
  a.rb.T_mono = static_cast<float>(huber_trunc * d2_mono);
  a.rb.T3_mono = static_cast<float>(0.3 * (huber_trunc * d2_mono));
  a.rb.plat_mono = static_cast<float>(plat_k * d2_mono);
  a.rb.trunc = static_cast<float>(huber_trunc);
  a.rb.plat_k = static_cast<float>(plat_k);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ptrs[kUr] != nullptr) {
    pose_vi_lm_kernel<true, kPerThread><<<1, kThreads, 0, s>>>(a);
  } else {
    pose_vi_lm_kernel<false, kPerThread><<<1, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
