// rk4 propagation over one IMU window for Hopper (sm_90a), one launch for a
// batch of windows:
//
//   * the window's K samples corrected by the biases and the five fixed
//     intrinsic matrices (models/propagator.correct_imu):
//         a = R_a (Da (a_m - ba)),  w = R_w (Dw (w_m - bg - Tg a));
//   * the K - 1 rk4 mean steps (propagator._step_mean_rk4: the quaternion
//     integrated in R^4 and renormalized inside each derivative and after
//     the step);
//   * each interval's error-state transition Phi_k [15, 15] and noise
//     Qd_k = G_k diag(qc) G_k^T (propagator._phi_qd), linearized at the FEJ
//     point for the first interval and at the running mean after it; an
//     interval with dt = 0 is Phi_k = I, Qd_k = 0 (propagator._mask_padded);
//   * their composition in propagator._compose_transitions' pairwise tree
//     (Phi' = Phi_b Phi_a, Qd' = Phi_b Qd_a Phi_b^T + Qd_b, a earlier), the
//     identity padding to a power of two left out: a product with an exact
//     identity is exact, so the result is the padded tree's;
//   * out: q|p|v [10], Phi [15, 15] and 0.5 (Qd + Qd^T) [15, 15].
//
// Operands per stream (float32, each stream's entries contiguous, streams
// at a batch stride, 0 for an operand that every stream shares): x [26] =
// q, p, v, q_fej, p_fej, v_fej, bg, ba; mats [45] = Dw, Da, Tg, R_w, R_a,
// row-major 3 x 3; t [K]; w, a [K, 3].
//
// Design: one warp per window, up to four windows per CTA, in three
// phases.  (1) The lanes correct one sample each, then every lane runs the
// mean recursion in registers (the only sequential part, about 450
// operations an interval) and lane 0 keeps each interval's end point in
// shared memory.  (2) Lane c builds interval c's 3 x 3 blocks (dR, the
// bias and theta columns, R_k^T R_a Da), all intervals at once.  (3) In
// order, each interval's Phi_k and G_k^T are placed from its blocks (one
// lane per block entry), Qd_k = (G qc) G^T is formed, and the tree is
// walked as a binary counter: leaf c is pushed onto a stack of (Phi, Qd)
// pairs and merged ctz(c + 1) times with the entry below it, which visits
// the tree's nodes in the same pairing; what remains on the stack (one
// entry per set bit of K - 1) is merged from the top down, the padded
// tree's right spine.  A 15 x 15 lives in shared memory at a row pitch of
// 16; in a product lane 2 i + h owns row i, columns 8 h .. 8 h + 7, and
// reads row segments as float4 (one scalar and two vector loads for 8
// FMAs); T = Phi_b Qd_a is stored transposed so that the third product
// reads row segments too.  Shared memory per warp at K = 11: 12.4 KB.
//
// What bounds it: at K = 11 a window reads 592 B and writes 1.84 KB, and
// its dense 15 x 15 products are 2.6e5 operations (9 merges of three
// products, 2 x 15^3 each; 10 leaves' Qd, 3 x 15^2 x 12), so a batch of 4,096
// is 10 MB and 1.08 GFLOP: 16 us at the card's f32 rate.  It takes about
// 0.11 ms there: the sequential mean recursion and the shared-memory traffic
// of the products hold each warp, at 120 registers a thread.  A first
// version that computed each interval's blocks on every lane in turn and
// read two shared floats per FMA took 0.25 ms.

#include <cuda_runtime.h>

namespace {

constexpr int N = 15;        // error-state block
constexpr int NN = N * N;    // 225
constexpr int NG = 12;       // noise inputs: n_g n_a n_wg n_wa
constexpr int LD = 16;       // row pitch of a 15 x 15 in shared memory
constexpr int MAT = N * LD;  // 240 floats
constexpr int MAX_WARPS = 4; // windows per CTA

constexpr int ME = 12;  // a mean: q p v, the interval's dt, pad
constexpr int RL = 56;  // an interval's blocks: dR Fbg Fba Fp Fv RtDa, pad

// shared floats of one warp: the stack, G^T, T^T, the corrected samples,
// the means and the intervals' blocks
__host__ __device__ __forceinline__ int warp_floats(int levels, int K) {
  return levels * 2 * MAT + NG * LD + MAT + ((6 * K + 3) / 4) * 4 + ME * K +
         RL * (K - 1);
}

__device__ __forceinline__ void mul33(const float* A, const float* B,
                                      float* C) {  // C = A B
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] +
                     A[3 * i + 2] * B[6 + j];
}

__device__ __forceinline__ void matvec(const float* M, const float* x,
                                       float* y) {  // y = M x
#pragma unroll
  for (int i = 0; i < 3; ++i)
    y[i] = M[3 * i] * x[0] + M[3 * i + 1] * x[1] + M[3 * i + 2] * x[2];
}

__device__ __forceinline__ void transpose33(const float* A, float* T) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) T[3 * j + i] = A[3 * i + j];
}

// -skew(e) R^T, with R^T given: row i of -[e]x is (0, e2, -e1), ...
__device__ __forceinline__ void neg_skew_mul(const float* e, const float* M,
                                             float* C) {
  const float S[9] = {0.f, e[2], -e[1], -e[2], 0.f, e[0], e[1], -e[0], 0.f};
  mul33(S, M, C);
}

// JPL quaternion [x y z w] -> rotation (global to local), lie.quat_2_rot
__device__ __forceinline__ void quat_2_rot(const float* q, float* R) {
  const float x = q[0], y = q[1], z = q[2], w = q[3];
  const float d = 2.f * w * w - 1.f;
  R[0] = d + 2.f * x * x;
  R[1] = 2.f * (w * z + x * y);
  R[2] = 2.f * (x * z - w * y);
  R[3] = 2.f * (x * y - w * z);
  R[4] = d + 2.f * y * y;
  R[5] = 2.f * (w * x + y * z);
  R[6] = 2.f * (w * y + x * z);
  R[7] = 2.f * (y * z - w * x);
  R[8] = d + 2.f * z * z;
}

// normalize, scalar part non-negative (lie.quat_norm)
__device__ __forceinline__ void quat_norm(float* q) {
  const float n = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = q[i] / n;
  if (q[3] < 0.f) {
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = -q[i];
  }
}

// rk4's derivative: q' = 0.5 Omega(w) q, v' = R(q / |q|)^T a - g
__device__ __forceinline__ void deriv(const float* q, const float* w,
                                      const float* a, float g, float* dq,
                                      float* dv) {
  dq[0] = 0.5f * (w[2] * q[1] - w[1] * q[2] + w[0] * q[3]);
  dq[1] = 0.5f * (-w[2] * q[0] + w[0] * q[2] + w[1] * q[3]);
  dq[2] = 0.5f * (w[1] * q[0] - w[0] * q[1] + w[2] * q[3]);
  dq[3] = 0.5f * (-w[0] * q[0] - w[1] * q[1] - w[2] * q[2]);
  const float n = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  const float qn[4] = {q[0] / n, q[1] / n, q[2] / n, q[3] / n};
  float R[9];
  quat_2_rot(qn, R);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    dv[i] = R[i] * a[0] + R[3 + i] * a[1] + R[6 + i] * a[2];
  dv[2] -= g;
}

// one rk4 step from (q, p, v) with the corrected samples at both ends
__device__ __forceinline__ void rk4_step(float* q, float* p, float* v,
                                         const float* w1, const float* a1,
                                         const float* w2, const float* a2,
                                         float dt, float g) {
  float wm[3], am[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    wm[i] = 0.5f * (w1[i] + w2[i]);
    am[i] = 0.5f * (a1[i] + a2[i]);
  }
  const float h2 = 0.5f * dt;
  float k1q[4], k2q[4], k3q[4], k4q[4], k1v[3], k2v[3], k3v[3], k4v[3];
  float qs[4], v2[3], v3[3], v4[3];
  deriv(q, w1, a1, g, k1q, k1v);
#pragma unroll
  for (int i = 0; i < 4; ++i) qs[i] = q[i] + h2 * k1q[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) v2[i] = v[i] + h2 * k1v[i];
  deriv(qs, wm, am, g, k2q, k2v);
#pragma unroll
  for (int i = 0; i < 4; ++i) qs[i] = q[i] + h2 * k2q[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) v3[i] = v[i] + h2 * k2v[i];
  deriv(qs, wm, am, g, k3q, k3v);
#pragma unroll
  for (int i = 0; i < 4; ++i) qs[i] = q[i] + dt * k3q[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) v4[i] = v[i] + dt * k3v[i];
  deriv(qs, w2, a2, g, k4q, k4v);
  const float h6 = dt / 6.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    q[i] = q[i] + h6 * (k1q[i] + 2.f * k2q[i] + 2.f * k3q[i] + k4q[i]);
  quat_norm(q);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    // p' = v at each stage: v, v2, v3, v4
    const float pn = p[i] + h6 * (v[i] + 2.f * v2[i] + 2.f * v3[i] + v4[i]);
    v[i] = v[i] + h6 * (k1v[i] + 2.f * k2v[i] + 2.f * k3v[i] + k4v[i]);
    p[i] = pn;
  }
}

// log of a rotation through its Shepperd quaternion (lie.log_so3)
__device__ __forceinline__ void log_so3(const float* R, float* out) {
  const float eps = 1e-12f;
  const float tr = R[0] + R[4] + R[8];
  const float cw = 1.f + tr;
  const float cx = 1.f + 2.f * R[0] - tr;
  const float cy = 1.f + 2.f * R[4] - tr;
  const float cz = 1.f + 2.f * R[8] - tr;
  const float sxy = R[1] + R[3], syz = R[5] + R[7], szx = R[6] + R[2];
  const float dyz = R[5] - R[7], dzx = R[6] - R[2], dxy = R[1] - R[3];
  float q[4];
  // the largest pivot, the first on ties (torch.argmax)
  if (cw >= cx && cw >= cy && cw >= cz) {
    const float s = 0.5f * sqrtf(fmaxf(cw, eps));
    q[0] = dyz / (4.f * s); q[1] = dzx / (4.f * s); q[2] = dxy / (4.f * s);
    q[3] = s;
  } else if (cx >= cy && cx >= cz) {
    const float s = 0.5f * sqrtf(fmaxf(cx, eps));
    q[0] = s; q[1] = sxy / (4.f * s); q[2] = szx / (4.f * s);
    q[3] = dyz / (4.f * s);
  } else if (cy >= cz) {
    const float s = 0.5f * sqrtf(fmaxf(cy, eps));
    q[0] = sxy / (4.f * s); q[1] = s; q[2] = syz / (4.f * s);
    q[3] = dzx / (4.f * s);
  } else {
    const float s = 0.5f * sqrtf(fmaxf(cz, eps));
    q[0] = szx / (4.f * s); q[1] = syz / (4.f * s); q[2] = s;
    q[3] = dxy / (4.f * s);
  }
  quat_norm(q);
  const float n2 = q[0] * q[0] + q[1] * q[1] + q[2] * q[2];
  const float n = sqrtf(fmaxf(n2, eps));
  const float scale = n2 < 1e-14f ? 2.f / fmaxf(q[3], eps)
                                  : 2.f * atan2f(n, q[3]) / n;
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = -scale * q[i];
}

// right Jacobian Jr(w) = Jl(-w) = I - B [w]x + C [w]x^2 (lie.Jr_so3)
__device__ __forceinline__ void jr_so3(const float* w, float* J) {
  const float u[3] = {-w[0], -w[1], -w[2]};
  const float t2 = u[0] * u[0] + u[1] * u[1] + u[2] * u[2];
  const bool small = t2 < 1e-8f;
  const float safe = small ? 1.f : t2;
  const float t = sqrtf(fmaxf(safe, 1e-12f));
  const float B = small ? 0.5f - t2 / 24.f : (1.f - cosf(t)) / safe;
  const float C = small ? 1.f / 6.f - t2 / 120.f : (t - sinf(t)) / (safe * t);
  const float U[9] = {0.f, -u[2], u[1], u[2], 0.f, -u[0], -u[1], u[0], 0.f};
  float U2[9];
  mul33(U, U, U2);
#pragma unroll
  for (int e = 0; e < 9; ++e)
    J[e] = ((e % 4 == 0) ? 1.f : 0.f) + B * U[e] + C * U2[e];
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c,
                                    float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// acc[0..7] += s * row[0..7] (a row segment, 16-byte aligned)
__device__ __forceinline__ void axpy8(float s, const float* row, float* acc) {
  const float4 x0 = ld4(row), x1 = ld4(row + 4);
  acc[0] = fmaf(s, x0.x, acc[0]);
  acc[1] = fmaf(s, x0.y, acc[1]);
  acc[2] = fmaf(s, x0.z, acc[2]);
  acc[3] = fmaf(s, x0.w, acc[3]);
  acc[4] = fmaf(s, x1.x, acc[4]);
  acc[5] = fmaf(s, x1.y, acc[5]);
  acc[6] = fmaf(s, x1.z, acc[6]);
  acc[7] = fmaf(s, x1.w, acc[7]);
}

// the stack entry `a` <- merge(earlier a, later b):
//   Phi_a <- Phi_b Phi_a,  Qd_a <- (Phi_b Qd_a) Phi_b^T + Qd_b
// Lane 2 i + h (i < 15) owns row i, columns 8 h .. 8 h + 7 (column 15 is
// the pitch's pad, computed and never read into a real entry).  T = Phi_b
// Qd_a goes to shared memory transposed, so the second product reads row
// segments too: lane 2 j + h owns entries (8 h .. 8 h + 7, j) of Qd_a.
__device__ __forceinline__ void merge(float* a, const float* b, float* TT,
                                      int lane) {
  float* Pa = a;
  float* Qa = a + MAT;
  const float* Pb = b;
  const float* Qb = b + MAT;
  const int i = lane >> 1, c0 = (lane & 1) * 8;
  float pn[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float tn[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (i < N) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float bik = Pb[i * LD + k];
      axpy8(bik, Pa + k * LD + c0, pn);
      axpy8(bik, Qa + k * LD + c0, tn);
    }
  }
  __syncwarp();
  if (i < N) {
    st4(Pa + i * LD + c0, pn[0], pn[1], pn[2], pn[3]);
    st4(Pa + i * LD + c0 + 4, pn[4], pn[5], pn[6], pn[7]);
#pragma unroll
    for (int r = 0; r < 8; ++r)
      if (c0 + r < N) TT[(c0 + r) * LD + i] = tn[r];
  }
  __syncwarp();
  if (i < N) {  // i is the column j of Qd_a here
    float qn[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < N; ++k) axpy8(Pb[i * LD + k], TT + k * LD + c0, qn);
#pragma unroll
    for (int r = 0; r < 8; ++r)
      if (c0 + r < N) Qa[(c0 + r) * LD + i] = qn[r] + Qb[(c0 + r) * LD + i];
  }
  __syncwarp();
}

__global__ void __launch_bounds__(MAX_WARPS * 32)
imu_rk4_window_kernel(const float* __restrict__ xs, long long sx,
                      const float* __restrict__ ms, long long sm,
                      const float* __restrict__ ts, long long st,
                      const float* __restrict__ ws, long long sw,
                      const float* __restrict__ as, long long sa,
                      float* __restrict__ mean_out,
                      float* __restrict__ phi_out,
                      float* __restrict__ qd_out, int batch, int K,
                      int levels, int warps, float g, float dens_w,
                      float dens_a, float dens_wb, float dens_ab) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long b = (long long)blockIdx.x * warps + warp;
  if (b >= batch) return;  // whole warps only; no block barrier below
  float* stack = smem + warp * warp_floats(levels, K);  // [levels][Phi|Qd]
  float* GT = stack + levels * 2 * MAT;  // G^T [12][LD]
  float* TT = GT + NG * LD;              // a merge's T^T [15][LD]
  float* S = TT + MAT;                   // corrected samples [K][w a]
  float* E = S + ((6 * K + 3) / 4) * 4;  // means [K][ME]
  float* R = E + ME * K;                 // interval blocks [K - 1][RL]

  const float* x = xs + b * sx;
  const float* m = ms + b * sm;
  const float* t = ts + b * st;
  const float* w = ws + b * sw;
  const float* a = as + b * sa;

  float RwDw[9], RaDa[9], M[9];
  {
    float Dw[9], Da[9], Tg[9], Rw[9], Ra[9], RwDwTg[9];
#pragma unroll
    for (int e = 0; e < 9; ++e) {
      Dw[e] = m[e];
      Da[e] = m[9 + e];
      Tg[e] = m[18 + e];
      Rw[e] = m[27 + e];
      Ra[e] = m[36 + e];
    }
    mul33(Rw, Dw, RwDw);
    mul33(Ra, Da, RaDa);
    mul33(RwDw, Tg, RwDwTg);
    mul33(RwDwTg, RaDa, M);  // RwDw Tg RaDa
    // sample k on lane k: a = Ra (Da (a_m - ba)), w = Rw (Dw (w_m - bg -
    // Tg a))
    for (int k = lane; k < K; k += 32) {
      float u[3], y[3], ac[3], wc[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) u[i] = a[3 * k + i] - x[23 + i];
      matvec(Da, u, y);
      matvec(Ra, y, ac);
      matvec(Tg, ac, y);
#pragma unroll
      for (int i = 0; i < 3; ++i) u[i] = w[3 * k + i] - x[20 + i] - y[i];
      matvec(Dw, u, y);
      matvec(Rw, y, wc);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        S[6 * k + i] = wc[i];
        S[6 * k + 3 + i] = ac[i];
      }
    }
  }

  __syncwarp();
  const int n = K - 1;

  // 1. the mean recursion (every lane, in registers); E[0] is the FEJ
  //    point, E[c + 1] the mean after interval c: interval c is linearized
  //    at E[c] and ends at E[c + 1]
  float q[4], p[3], v[3];
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = x[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    p[i] = x[4 + i];
    v[i] = x[7 + i];
  }
  if (lane < 10) E[lane] = x[10 + lane];
  for (int c = 0; c < n; ++c) {
    const float* s1 = S + 6 * c;
    const float* s2 = s1 + 6;
    const float dt = fmaxf(t[c + 1] - t[c], 0.f);
    rk4_step(q, p, v, s1, s1 + 3, s2, s2 + 3, dt, g);
    if (lane == 0) {
      float* e = E + ME * (c + 1);
#pragma unroll
      for (int i = 0; i < 4; ++i) e[i] = q[i];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        e[4 + i] = p[i];
        e[7 + i] = v[i];
      }
      e[10] = dt;
    }
  }
  __syncwarp();

  // 2. every interval's blocks at once, interval c on lane c
  for (int c = lane; c < n; c += 32) {
    const float* lin = E + ME * c;
    const float* nw = E + ME * (c + 1);
    const float dt = nw[10];
    float* L = R + RL * c;
    if (dt > 0.f) {
      float Rk[9], RkT[9], Rn[9], dR[9], lg[3], Jr[9], dRJr[9];
      quat_2_rot(lin, Rk);
      transpose33(Rk, RkT);
      quat_2_rot(nw, Rn);
      mul33(Rn, RkT, dR);
      log_so3(dR, lg);
      jr_so3(lg, Jr);
      mul33(dR, Jr, dRJr);
#pragma unroll
      for (int e = 0; e < 9; ++e) dRJr[e] *= dt;
      float ep[3], ev[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        ep[i] = nw[4 + i] - lin[4 + i] - lin[7 + i] * dt;
        ev[i] = nw[7 + i] - lin[7 + i];
      }
      ep[2] += 0.5f * g * dt * dt;
      ev[2] += g * dt;
#pragma unroll
      for (int e = 0; e < 9; ++e) L[e] = dR[e];
      mul33(dRJr, RwDw, L + 9);  // Fth_bg, negated when placed
      mul33(dRJr, M, L + 18);    // Fth_ba
      neg_skew_mul(ep, RkT, L + 27);  // Fp_th
      neg_skew_mul(ev, RkT, L + 36);  // Fv_th
      mul33(RkT, RaDa, L + 45);       // R_k^T R_a Da
    }
  }
  __syncwarp();

  // 3. in order: leaf c placed into slot popcount(c) (Phi_k, and G_k^T for
  //    Qd_k), Qd_k, then the merges
  const int row = lane >> 1, c0 = (lane & 1) * 8;  // a product's entries
  for (int c = 0; c < n; ++c) {
    const float dt = E[ME * (c + 1) + 10];
    const float* L = R + RL * c;
    float* Pk = stack + __popc(c) * 2 * MAT;
    float* Qk = Pk + MAT;
    for (int e = lane; e < MAT / 4; e += 32)
      st4(Pk + 4 * e, 0.f, 0.f, 0.f, 0.f);
    for (int e = lane; e < NG * LD / 4; e += 32)
      st4(GT + 4 * e, 0.f, 0.f, 0.f, 0.f);
    __syncwarp();
    const bool live = dt > 0.f;
    if (live && lane < 9) {  // entry (i, j) of every 3 x 3 block
      const int i = lane / 3, j = lane - 3 * (lane / 3);
      const float hdt2 = -0.5f * dt * dt;
      const float fbg = -1.f * L[9 + lane], fba = L[18 + lane];
      const float rt = L[45 + lane];
      Pk[i * LD + j] = L[lane];
      Pk[i * LD + 9 + j] = fbg;
      Pk[i * LD + 12 + j] = fba;
      Pk[(3 + i) * LD + j] = L[27 + lane];
      Pk[(3 + i) * LD + 12 + j] = hdt2 * rt;
      Pk[(6 + i) * LD + j] = L[36 + lane];
      Pk[(6 + i) * LD + 12 + j] = -dt * rt;
      // G [15][12] over [n_g n_a n_wg n_wa], stored transposed
      GT[j * LD + i] = fbg;
      GT[(3 + j) * LD + i] = fba;
      GT[(3 + j) * LD + 3 + i] = hdt2 * rt;
      GT[(3 + j) * LD + 6 + i] = -dt * rt;
    } else if (live && lane < 9 + N) {  // the diagonals
      const int d = lane - 9;
      if (d >= 3) {
        Pk[d * LD + d] = 1.f;
      } else {
        Pk[(3 + d) * LD + 6 + d] = dt;
        GT[(6 + d) * LD + 9 + d] = dt;
        GT[(9 + d) * LD + 12 + d] = dt;
      }
    } else if (!live && lane < N) {
      Pk[lane * LD + lane] = 1.f;  // a padded interval: Phi = I, Qd = 0
    }
    __syncwarp();
    // Qd_k = (G qc) G^T: lane 2 i + h owns row i, columns 8 h ..
    const float inv_dt = live ? 1.f / fmaxf(dt, 1e-12f) : 0.f;
    const float qc[4] = {dens_w * inv_dt, dens_a * inv_dt, dens_wb * inv_dt,
                         dens_ab * inv_dt};
    if (row < N) {
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int cc = 0; cc < NG; ++cc)
        axpy8(GT[cc * LD + row] * qc[cc / 3], GT + cc * LD + c0, acc);
      st4(Qk + row * LD + c0, acc[0], acc[1], acc[2], acc[3]);
      st4(Qk + row * LD + c0 + 4, acc[4], acc[5], acc[6], acc[7]);
    }
    __syncwarp();
    // binary counter: merge ctz(c + 1) times
    int top = __popc(c);
    for (int done = c + 1; (done & 1) == 0; done >>= 1) {
      merge(stack + (top - 1) * 2 * MAT, stack + top * 2 * MAT, TT, lane);
      --top;
    }
  }
  // the padded tree's right spine: merge what is left from the top down
  for (int top = __popc(n) - 1; top > 0; --top)
    merge(stack + (top - 1) * 2 * MAT, stack + top * 2 * MAT, TT, lane);

  if (lane == 0) {
    float* mo = mean_out + b * 10;
#pragma unroll
    for (int i = 0; i < 4; ++i) mo[i] = q[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      mo[4 + i] = p[i];
      mo[7 + i] = v[i];
    }
  }
  float* po = phi_out + b * NN;
  float* qo = qd_out + b * NN;
  const float* Pf = stack;
  const float* Qf = stack + MAT;
  for (int e = lane; e < NN; e += 32) {
    const int i = e / N, j = e - (e / N) * N;
    po[e] = Pf[i * LD + j];
    qo[e] = 0.5f * (Qf[i * LD + j] + Qf[j * LD + i]);
  }
}

}  // namespace

// Launch `batch` windows of K samples on `stream`; operand b of x, mats, t,
// w and a at b times its stride (in floats).  `dens_*` are the noise
// densities sigma^2 of (gyro, accel, gyro bias, accel bias).  Returns
// cudaGetLastError() (0 = launched).
extern "C" int imu_rk4_window_f32(const float* x, long long sx,
                                  const float* mats, long long sm,
                                  const float* t, long long st,
                                  const float* w, long long sw,
                                  const float* a, long long sa, float* mean,
                                  float* phi, float* qd, int batch, int K,
                                  float gravity, float dens_w, float dens_a,
                                  float dens_wb, float dens_ab, void* stream) {
  if (batch <= 0 || K < 2) return (int)cudaErrorInvalidValue;
  const int n = K - 1;
  int levels = 1;  // stack entries: 1 + the largest popcount below n
  for (int c = 0; c < n; ++c)
    if (__builtin_popcount(c) + 1 > levels) levels = __builtin_popcount(c) + 1;
  const size_t per_warp = (size_t)warp_floats(levels, K) * sizeof(float);
  int warps = (int)((48 * 1024) / per_warp);
  if (warps < 1) return (int)cudaErrorInvalidValue;
  if (warps > MAX_WARPS) warps = MAX_WARPS;
  const long long blocks = (batch + warps - 1) / warps;
  imu_rk4_window_kernel<<<(unsigned)blocks, warps * 32, warps * per_warp,
                          (cudaStream_t)stream>>>(
      x, sx, mats, sm, t, st, w, sw, a, sa, mean, phi, qd, batch, K, levels,
      warps, gravity, dens_w, dens_a, dens_wb, dens_ab);
  return (int)cudaGetLastError();
}
