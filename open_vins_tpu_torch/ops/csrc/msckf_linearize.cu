// The MSCKF update's linearize stage for Hopper (sm_90a), one launch for a
// batch of streams: for each of a stream's F candidate features, with its O
// observations (one per clone slot and camera),
//
//   * the observation context: the clone rotations at the estimate and at
//     the FEJ point, the camera extrinsics and intrinsics
//     (update_helper.obs_context);
//   * each observation's 2 x 3 feature block, 2 x 6 clone block and, with
//     online calibration, its 2 x 6 extrinsic and 2 x 8 intrinsic blocks,
//     at the FEJ points, with the residual at the estimate; rows of an
//     observation that is masked or lies within 5 cm of its camera (at the
//     estimate or at the FEJ point) are multiplied by 0
//     (update_helper.feature_jacobian_batch);
//   * the left-nullspace projection of the feature block by the same three
//     Householder reflectors as update_helper.householder_rotate (sign + 1
//     when the pivot is >= 0, a reflector with |v|^2 <= 1e-30 the identity),
//     applied to [H_x | res] on the camera support's k columns only;
//   * the chi^2 statistic gamma = res_p^T (H_p P H_p^T + sigma^2 I)^-1 res_p
//     with P the support's k x k block of the covariance
//     (update_helper.chi2_statistic): the Cholesky and forward solve of
//     smallmat.chi2_quadform when the 2O rows are at most 24; above, gamma
//     is NaN here and the wrapper calls chi2_statistic on the outputs;
//   * out: H_proj [F, m, D] (m = 2O - 3, zero outside the support),
//     res_proj [F, m], the live rows [F] (2 per valid observation), gamma [F].
//
// It replaces no TPU kernel: the JAX package runs this stage as XLA fusions
// (open_vins_tpu/models/update_helper.py), and before this kernel the port
// ran it as about a thousand small PyTorch launches a step.
//
// Operands per stream (float32 unless said, each stream's entries
// contiguous, streams at a batch stride in elements, 0 for an operand that
// every stream shares): uv [F, O, 2]; mask [F, O] bool; p_f [F, 3];
// clones_q [C, 4], clones_p [C, 3] and their FEJ values; calib_ext_q [N, 4],
// calib_ext_p [N, 3], calib_intr [N, 8]; cov [D, D]; clone_slot, cam [O]
// int64.
//
// Design: one CTA per stream (or per group of features when the batch is
// too small to fill the card), one warp per feature, two CTAs of 7 warps on
// an SM.  The CTA loads the support's k x k covariance block (k = 81 in
// both benchmark cells, 26 KB) once for its features.  In a warp:
//
//   1. lane o builds observation o's blocks in registers and writes their
//      nonzero columns into W = [H_f | H_x | res] (2O x (k + 4), shared);
//   2. M = H_x P H_x^T (2O x 2O) from the unprojected blocks, one lane per
//      pair of observations: 2 x NC by NC x NC by NC x 2 (NC = 6 without
//      online calibration) in place of the dense 19 x 81 x 81 product.  The
//      projection cancels most of M (the clone-position blocks equal -H_f),
//      so M and S are formed in float64, where that cancellation costs
//      nothing; H_proj and res_proj stay float32, as in the plain version;
//   3. lanes 0-2 hold H_f's columns and form the three reflectors;
//   4. lane c holds column c of [H_x | res] in registers, applies the
//      reflectors and writes its rows 3.. straight to H_proj: 32
//      neighbouring columns a store; the columns outside the support are
//      then written 0, also 32 neighbours a store;
//   5. lane c applies the reflectors to column c of M, writes the result as
//      row c, and applies them again to column c: S's row c of Q^T M Q,
//      which lane 3 + i keeps for the Cholesky (one reciprocal square root
//      a column) and the forward solve.
//
// What bounds it: the output.  At msckf.mc's shape (4,096 streams x 40
// features, m = 19, D = 120) H_proj is 1.49 GB, 0.45 ms at 3.35 TB/s; the
// operations as done here are about 5e4 a feature (step 2's pairs, the
// reflectors on 82 columns and twice on M, a 19 x 19 Cholesky), 8 GFLOP in
// all.  The kernel takes about 3.5 ms there, half of it in the chi^2 steps
// (M, S, the Cholesky): each warp's steps are chains of dependent
// shared-memory loads and float64 operations, and two CTAs of 7 warps an SM
// (27 KB of P and column maps, 12.5 KB a warp; 144 registers a thread) hide
// little of their latency.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_O = 32;       // observations a feature: rows 2O <= 64
constexpr int MAX_RANGES = 4;   // column ranges of the support
constexpr int MAX_WARPS = 7;    // features a CTA works on at once
constexpr int FILL_CTAS = 264;  // two CTAs on each of the card's 132 SMs
constexpr int SMEM_MAX = 232448;   // a CTA's shared memory
constexpr int SMEM_HALF = 115712;  // each of two CTAs on one SM

struct Operands {
  const float* uv;
  long long s_uv;
  const unsigned char* mask;
  long long s_mask;
  const float* pf;
  long long s_pf;
  const float* cq;
  long long s_cq;
  const float* cp;
  long long s_cp;
  const float* cqf;
  long long s_cqf;
  const float* cpf;
  long long s_cpf;
  const float* eq;
  long long s_eq;
  const float* ep;
  long long s_ep;
  const float* zi;
  long long s_zi;
  const float* cov;
  long long s_cov;
  const long long* slot;
  long long s_slot;
  const long long* cam;
  long long s_cam;
};

struct Layout {
  int F, O, D, k;
  int clones_off, ext_off, intr_off;
  int equi;
  int n_ranges;
  int ra[MAX_RANGES], rb[MAX_RANGES];
  int n_gaps;  // the columns outside the support
  int za[MAX_RANGES + 1], zb[MAX_RANGES + 1];
  float sigma2;
  int lw, lm;      // row pitches of [H_f | H_x | res] and of M (odd)
  int per_warp;    // shared floats of one warp
  int head;        // shared floats before the warps' (column maps, P)
  int warps, fpc;  // warps a CTA, features a CTA
  int groups;      // CTAs a stream
};

__device__ __forceinline__ double warp_sum_d(double x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
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

__device__ __forceinline__ void skew(const float* v, float* S) {
  S[0] = 0.f;
  S[1] = -v[2];
  S[2] = v[1];
  S[3] = v[2];
  S[4] = 0.f;
  S[5] = -v[0];
  S[6] = -v[1];
  S[7] = v[0];
  S[8] = 0.f;
}

// 2 x 3 = (2 x 3) (3 x 3)
__device__ __forceinline__ void mul23(const float* A, const float* B,
                                      float* C) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] +
                     A[3 * i + 2] * B[6 + j];
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

// cameras.distort_jacobians_soa for one point: the raw pixel uv, its
// Jacobian by the normalized point Jd [2, 2] and by the intrinsics Jz [2, 8]
__device__ __forceinline__ void distort(bool equi, const float* z, float x,
                                        float y, float* uv, float* Jd,
                                        float* Jz) {
  const float fx = z[0], fy = z[1], cx = z[2], cy = z[3];
  const float r2 = x * x + y * y;
  float xd, yd, dxx, dxy, dyx, dyy;
  if (!equi) {
    const float k1 = z[4], k2 = z[5], p1 = z[6], p2 = z[7];
    const float radial = 1.f + k1 * r2 + k2 * r2 * r2;
    xd = x * radial + 2.f * p1 * x * y + p2 * (r2 + 2.f * x * x);
    yd = y * radial + p1 * (r2 + 2.f * y * y) + 2.f * p2 * x * y;
    const float dk = k1 + 2.f * k2 * r2;
    dxx = radial + 2.f * x * x * dk + 2.f * p1 * y + 6.f * p2 * x;
    dxy = 2.f * x * y * dk + 2.f * p1 * x + 2.f * p2 * y;
    dyx = dxy;
    dyy = radial + 2.f * y * y * dk + 6.f * p1 * y + 2.f * p2 * x;
    const float J0[8] = {xd, 0.f, 1.f, 0.f, fx * x * r2, fx * x * r2 * r2,
                         fx * 2.f * x * y, fx * (r2 + 2.f * x * x)};
    const float J1[8] = {0.f, yd, 0.f, 1.f, fy * y * r2, fy * y * r2 * r2,
                         fy * (r2 + 2.f * y * y), fy * 2.f * x * y};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      Jz[i] = J0[i];
      Jz[8 + i] = J1[i];
    }
  } else {
    const float k1 = z[4], k2 = z[5], k3 = z[6], k4 = z[7];
    const float r = sqrtf(fmaxf(r2, 1e-24f));
    const bool small = r2 < 1e-16f;
    const float th = atanf(r);
    const float t2 = th * th;
    const float poly = 1.f + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)));
    const float thd = th * poly;
    const float scale = small ? 1.f : thd / r;
    xd = x * scale;
    yd = y * scale;
    const float dthd =
        1.f +
        t2 * (3.f * k1 + t2 * (5.f * k2 + t2 * (7.f * k3 + 9.f * k4 * t2)));
    const float dth_dr = 1.f / (1.f + r2);
    const float rs = fmaxf(r, 1e-12f);
    const float dsc = small ? 0.f : (dthd * dth_dr - scale) / rs;
    const float rx = small ? 0.f : x / rs;
    const float ry = small ? 0.f : y / rs;
    dxx = scale + x * dsc * rx;
    dxy = x * dsc * ry;
    dyx = y * dsc * rx;
    dyy = scale + y * dsc * ry;
    const float t3 = t2 * th;
    const float inv_r = small ? 0.f : 1.f / rs;
    const float dk[4] = {t3, t3 * t2, t3 * t2 * t2, t3 * t2 * t2 * t2};
    Jz[0] = xd;
    Jz[1] = 0.f;
    Jz[2] = 1.f;
    Jz[3] = 0.f;
    Jz[8] = 0.f;
    Jz[9] = yd;
    Jz[10] = 0.f;
    Jz[11] = 1.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      Jz[4 + i] = fx * x * inv_r * dk[i];
      Jz[12 + i] = fy * y * inv_r * dk[i];
    }
  }
  uv[0] = fx * xd + cx;
  uv[1] = fy * yd + cy;
  Jd[0] = fx * dxx;
  Jd[1] = fx * dxy;
  Jd[2] = fy * dyx;
  Jd[3] = fy * dyy;
}

__device__ __forceinline__ int zero_col(const Layout& L, int z) {
  for (int r = 0; r < L.n_gaps; ++r) {
    const int n = L.zb[r] - L.za[r];
    if (z < n) return L.za[r] + z;
    z -= n;
  }
  return 0;
}

// The NC support columns of an observation of clone `slot` by camera `cam`:
// its clone block, then with online calibration its camera's extrinsic and
// intrinsic blocks
template <bool EXT, bool INTR>
__device__ __forceinline__ void obs_cols(const Layout& L, const int* colmap,
                                         int slot, int cam, int* cl) {
#pragma unroll
  for (int j = 0; j < 6; ++j) cl[j] = colmap[L.clones_off + 6 * slot + j];
  if (EXT) {
#pragma unroll
    for (int j = 0; j < 6; ++j) cl[6 + j] = colmap[L.ext_off + 6 * cam + j];
  }
  if (INTR) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      cl[(EXT ? 12 : 6) + j] = colmap[L.intr_off + 8 * cam + j];
  }
}

// Observation o of feature f: its two rows of [H_f | H_x | res] (W, whose
// rows are zero on entry), its clone slot and camera (oc) and whether it is
// valid.
template <bool EXT, bool INTR>
__device__ bool build_obs(const Operands& in, const Layout& L, long long b,
                          int f, int o, const int* colmap, float* W,
                          int* oc) {
  const int slot = (int)in.slot[b * in.s_slot + o];
  const int cam = (int)in.cam[b * in.s_cam + o];
  float Rg[9], Rgf[9], Ric[9];
  quat_2_rot(in.cq + b * in.s_cq + 4 * slot, Rg);
  quat_2_rot(in.cqf + b * in.s_cqf + 4 * slot, Rgf);
  quat_2_rot(in.eq + b * in.s_eq + 4 * cam, Ric);
  const float* pc = in.cp + b * in.s_cp + 3 * slot;
  const float* pcf = in.cpf + b * in.s_cpf + 3 * slot;
  const float* pic = in.ep + b * in.s_ep + 3 * cam;
  const float* zeta = in.zi + b * in.s_zi + 8 * cam;
  const float* pf = in.pf + b * in.s_pf + 3 * f;

  // geometry at the estimate: the residual and the depth gate
  float d[3], pI[3], pC[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) d[i] = pf[i] - pc[i];
  matvec(Rg, d, pI);
  matvec(Ric, pI, pC);
#pragma unroll
  for (int i = 0; i < 3; ++i) pC[i] += pic[i];
  const float zs = fabsf(pC[2]) > 1e-6f ? pC[2] : 1e-6f;
  float uvp[2], Jd[4], Jz[16];
  distort(L.equi != 0, zeta, pC[0] / zs, pC[1] / zs, uvp, Jd, Jz);
  const float* uv = in.uv + b * in.s_uv + 2 * ((long long)f * L.O + o);
  const float r0 = uv[0] - uvp[0], r1 = uv[1] - uvp[1];

  // geometry at the FEJ point: the Jacobians
  float pIf[3], pCf[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) d[i] = pf[i] - pcf[i];
  matvec(Rgf, d, pIf);
  matvec(Ric, pIf, pCf);
#pragma unroll
  for (int i = 0; i < 3; ++i) pCf[i] += pic[i];
  const float zf = fabsf(pCf[2]) > 1e-6f ? pCf[2] : 1e-6f;
  const float iz = 1.f / zf;
  const float Jp[6] = {iz, 0.f, -pCf[0] * iz * iz, 0.f, iz, -pCf[1] * iz * iz};
  float dz[6];  // dz/dp_C = Jd Jp
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      dz[3 * i + j] = Jd[2 * i] * Jp[j] + Jd[2 * i + 1] * Jp[3 + j];
  float S[9], T[9], Hf[6], Hth[6];
  skew(pIf, S);
  mul33(Ric, S, T);  // dp_C / d theta
  mul23(dz, T, Hth);
  mul33(Ric, Rgf, T);  // dp_C / dp_f
  mul23(dz, T, Hf);

  const bool mask = in.mask[b * in.s_mask + (long long)f * L.O + o] != 0;
  const bool valid = mask && pC[2] > 0.05f && pCf[2] > 0.05f;
  const float w = valid ? 1.f : 0.f;
  float* w0 = W + 2 * o * L.lw;
  float* w1 = w0 + L.lw;
  oc[2 * o] = slot;
  oc[2 * o + 1] = cam;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    w0[j] = Hf[j] * w;
    w1[j] = Hf[3 + j] * w;
  }
  const int cb = L.clones_off + 6 * slot;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int s0 = colmap[cb + j], s1 = colmap[cb + 3 + j];
    w0[3 + s0] = Hth[j] * w;
    w1[3 + s0] = Hth[3 + j] * w;
    w0[3 + s1] = -Hf[j] * w;
    w1[3 + s1] = -Hf[3 + j] * w;
  }
  if (EXT) {
    float e[3], Hc[6];
    matvec(Ric, pIf, e);
    skew(e, S);
    mul23(dz, S, Hc);
    const int eb = L.ext_off + 6 * cam;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int s0 = colmap[eb + j], s1 = colmap[eb + 3 + j];
      w0[3 + s0] = Hc[j] * w;
      w1[3 + s0] = Hc[3 + j] * w;
      w0[3 + s1] = dz[j] * w;
      w1[3 + s1] = dz[3 + j] * w;
    }
  }
  if (INTR) {
    const int ib = L.intr_off + 8 * cam;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int s = colmap[ib + j];
      w0[3 + s] = Jz[j] * w;
      w1[3 + s] = Jz[8 + j] * w;
    }
  }
  w0[3 + L.k] = r0 * w;
  w1[3 + L.k] = r1 * w;
  return valid;
}

// Rows 2o, 2o + 1 by rows 2o2, 2o2 + 1 of M = H_x P H_x^T (o <= o2), and
// their mirror, in double precision: the projection that follows cancels
// most of M, so S is formed where float32 rounding of M would not cancel
template <bool EXT, bool INTR>
__device__ void pair_block(const Layout& L, const float* P, const float* W,
                           const int* colmap, const int* oc, double* M,
                           int o, int o2) {
  constexpr int NC = 6 + (EXT ? 6 : 0) + (INTR ? 8 : 0);
  int ca[NC], cl[NC];
  obs_cols<EXT, INTR>(L, colmap, oc[2 * o], oc[2 * o + 1], ca);
  obs_cols<EXT, INTR>(L, colmap, oc[2 * o2], oc[2 * o2 + 1], cl);
  const float* a0 = W + 2 * o * L.lw + 3;
  const float* a1 = a0 + L.lw;
  const float* b0 = W + 2 * o2 * L.lw + 3;
  const float* b1 = b0 + L.lw;
  double u0[NC], u1[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    u0[j] = 0.0;
    u1[j] = 0.0;
  }
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = ca[i];
    const double h0 = a0[c], h1 = a1[c];
    const float* Pr = P + c * L.k;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const double p = Pr[cl[j]];
      u0[j] = fma(h0, p, u0[j]);
      u1[j] = fma(h1, p, u1[j]);
    }
  }
  double m00 = 0.0, m01 = 0.0, m10 = 0.0, m11 = 0.0;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const double g0 = b0[cl[j]], g1 = b1[cl[j]];
    m00 = fma(u0[j], g0, m00);
    m01 = fma(u0[j], g1, m01);
    m10 = fma(u1[j], g0, m10);
    m11 = fma(u1[j], g1, m11);
  }
  const int r = 2 * o, c = 2 * o2, lm = L.lm;
  M[r * lm + c] = m00;
  M[r * lm + c + 1] = m01;
  M[(r + 1) * lm + c + 1] = m11;
  if (o != o2) {
    M[(r + 1) * lm + c] = m10;
    M[c * lm + r] = m00;
    M[(c + 1) * lm + r] = m01;
    M[c * lm + r + 1] = m10;
    M[(c + 1) * lm + r + 1] = m11;
  } else {
    M[(r + 1) * lm + c] = m01;  // the diagonal block kept symmetric
  }
}

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}

__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

// x <- (I - s_j v_j v_j^T) x for the three reflectors, x in registers, the
// reflectors zero past the rows
template <int MAXR, typename T>
__device__ __forceinline__ void reflect3(const T* V, const T* sc, T* x) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const T* v = V + j * MAXR;
    T dot = 0;
#pragma unroll
    for (int r = 0; r < MAXR; ++r) dot = fma_t(v[r], x[r], dot);
    const T s = sc[j];
#pragma unroll
    for (int r = 0; r < MAXR; ++r) x[r] -= (s * v[r]) * dot;
  }
}

// GAMMA: the rows fit one warp's registers (2O <= MAXR = 24) and gamma is
// formed here; otherwise the wrapper forms it from the outputs
template <bool EXT, bool INTR, int MAXR>
__global__ void __launch_bounds__(MAX_WARPS * 32, 2)
    msckf_linearize_kernel(Operands in, Layout L, float* H, float* res,
                           int* nrows, float* gamma) {
  constexpr bool GAMMA = MAXR <= 24;
  extern __shared__ float smem[];
  const long long b = blockIdx.x / L.groups;
  const int g = blockIdx.x - (int)(b * L.groups);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k = L.k, lw = L.lw, lm = L.lm;
  int* colmap = reinterpret_cast<int*>(smem);  // state column -> support
  int* sup = colmap + ((L.D + 3) & ~3);        // support -> state column
  float* P = reinterpret_cast<float*>(sup + ((k + 3) & ~3));  // k x k

  for (int c = tid; c < L.D; c += blockDim.x) {
    int s = -1, off = 0;
    for (int r = 0; r < L.n_ranges; ++r) {
      if (c >= L.ra[r] && c < L.rb[r]) s = off + c - L.ra[r];
      off += L.rb[r] - L.ra[r];
    }
    colmap[c] = s;
    if (s >= 0) sup[s] = c;
  }
  __syncthreads();
  // P = take_cols(take_cols(cov, sup)^T, sup): P[s][s2] = cov[sup s2][sup s],
  // a warp a row of cov
  if (GAMMA) {
    const float* cov = in.cov + b * in.s_cov;
    for (int s2 = warp; s2 < k; s2 += blockDim.x / 32) {
      const float* row = cov + (long long)sup[s2] * L.D;
      for (int s = lane; s < k; s += 32) P[s * k + s2] = row[sup[s]];
    }
  }
  __syncthreads();

  const int O = L.O, R = 2 * O, m = R - 3;
  double* M = reinterpret_cast<double*>(smem + L.head +
                                        warp * L.per_warp);  // [R][lm]
  double* Vd = M + (GAMMA ? R * lm : 0);          // reflectors, [3][MAXR]
  double* scd = Vd + 3 * MAXR;                    // their scales, [4]
  float* W = reinterpret_cast<float*>(scd + 4);   // [R][lw]
  float* Vs = W + R * lw;                         // [3][MAXR]
  float* scs = Vs + 3 * MAXR;                     // [4]
  int* oc = reinterpret_cast<int*>(scs + 4);      // [O][slot, camera]
  const int f_end = min(L.F, (g + 1) * L.fpc);
  for (int f = g * L.fpc + warp; f < f_end; f += L.warps) {
    const long long fi = b * L.F + f;
    for (int e = lane; e < R * lw; e += 32) W[e] = 0.f;
    __syncwarp();
    bool valid = false;
    if (lane < O)
      valid = build_obs<EXT, INTR>(in, L, b, f, lane, colmap, W, oc);
    const unsigned valid_bits = __ballot_sync(0xffffffffu, valid);
    __syncwarp();

    // M = H_x P H_x^T from the unrotated blocks, one lane per pair o <= o2
    if (GAMMA) {
      const int n_pairs = O * (O + 1) / 2;
      for (int p = lane; p < n_pairs; p += 32) {
        int o2 = (int)((sqrtf(8.f * p + 1.f) - 1.f) * 0.5f);
        while ((o2 + 1) * (o2 + 2) / 2 <= p) ++o2;
        while (o2 * (o2 + 1) / 2 > p) --o2;
        pair_block<EXT, INTR>(L, P, W, colmap, oc, M, p - o2 * (o2 + 1) / 2,
                              o2);
      }
    }

    // householder_rotate's three reflectors from H_f (lane j < 3 holds
    // column j): reflector j from column j's rows >= j, then applied to
    // the three columns
    float a[MAXR];
    if (lane < 3) {
#pragma unroll
      for (int r = 0; r < MAXR; ++r) a[r] = r < R ? W[r * lw + lane] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (lane == j) {
        float nx = 0.f;
#pragma unroll
        for (int r = 0; r < MAXR; ++r)
          if (r >= j) nx = fmaf(a[r], a[r], nx);
        const float beta = -(a[j] >= 0.f ? 1.f : -1.f) * sqrtf(nx);
        float vn2 = 0.f;
#pragma unroll
        for (int r = 0; r < MAXR; ++r) {
          const float v = r < j ? 0.f : (r == j ? a[r] - beta : a[r]);
          vn2 = fmaf(v, v, vn2);
          Vs[j * MAXR + r] = v;
          if (GAMMA) Vd[j * MAXR + r] = v;
        }
        const float s = vn2 > 1e-30f ? 2.f / vn2 : 0.f;
        scs[j] = s;
        if (GAMMA) scd[j] = s;
      }
      __syncwarp();
      if (lane < 3) {
        float dot = 0.f;
#pragma unroll
        for (int r = 0; r < MAXR; ++r) dot = fmaf(Vs[j * MAXR + r], a[r], dot);
#pragma unroll
        for (int r = 0; r < MAXR; ++r)
          a[r] -= (scs[j] * Vs[j * MAXR + r]) * dot;
      }
    }
    __syncwarp();

    // [H_x | res] by columns, lane c owns column c in registers: rotated,
    // then its rows 3.. written to H_proj (32 neighbouring columns a store)
    // or res_proj; the residual column goes back to W for gamma
    for (int c = 3 + lane; c < k + 4; c += 32) {
      float x[MAXR];
#pragma unroll
      for (int r = 0; r < MAXR; ++r) x[r] = r < R ? W[r * lw + c] : 0.f;
      reflect3<MAXR, float>(Vs, scs, x);
      if (c < k + 3) {
        float* out = H + fi * m * L.D + sup[c - 3];
#pragma unroll
        for (int i = 3; i < MAXR; ++i)
          if (i < R) out[(long long)(i - 3) * L.D] = x[i];
      } else {
#pragma unroll
        for (int i = 3; i < MAXR; ++i)
          if (i < R) {
            res[fi * m + i - 3] = x[i];
            W[i * lw + c] = x[i];
          }
      }
    }
    // zeros outside the support
    for (int z = lane; z < L.D - k; z += 32) {
      float* out = H + fi * m * L.D + zero_col(L, z);
      for (int i = 0; i < m; ++i) out[(long long)i * L.D] = 0.f;
    }

    if (GAMMA) {
      // S = (Q^T M Q)[3:, 3:]: lane c takes column c of M to Q^T M, stores
      // it as row c, then takes column c again (row c of Q^T M) to row c
      // of Q^T M Q, which it keeps
      double x[MAXR];
      __syncwarp();
      if (lane < R) {
#pragma unroll
        for (int r = 0; r < MAXR; ++r) x[r] = r < R ? M[r * lm + lane] : 0.0;
        reflect3<MAXR, double>(Vd, scd, x);
      }
      __syncwarp();
      if (lane < R) {
#pragma unroll
        for (int r = 0; r < MAXR; ++r)
          if (r < R) M[lane * lm + r] = x[r];
      }
      __syncwarp();
      if (lane < R) {
#pragma unroll
        for (int r = 0; r < MAXR; ++r) x[r] = r < R ? M[r * lm + lane] : 0.0;
        reflect3<MAXR, double>(Vd, scd, x);
      }
      __syncwarp();
      // chi2_quadform's Cholesky of S + sigma^2 I (lane 3 + i owns row i,
      // x[3 + q] its entry q; L's rows also in M's place for the others),
      // then its forward solve
      const int i = lane - 3;
      const bool row = i >= 0 && i < m;
      double y = 0.0;
#pragma unroll
      for (int j = 0; j < MAXR - 3; ++j) {
        if (j < m) {
          double s = 0.0;
          if (row && i >= j) {
            double acc = 0.0;
#pragma unroll
            for (int q = 0; q < j; ++q) acc = fma(x[3 + q], M[j * lm + q], acc);
            s = x[3 + j] + (i == j ? (double)L.sigma2 : 0.0) - acc;
          }
          const double rinv =
              rsqrt(fmax(__shfl_sync(0xffffffffu, s, j + 3), 1e-20));
          if (row && i >= j) {
            x[3 + j] = s * rinv;
            M[i * lm + j] = x[3 + j];
          }
          __syncwarp();
        }
      }
      double d = 1.0, acc = 0.0;
#pragma unroll
      for (int j = 0; j < MAXR - 3; ++j)
        if (j == i) d = x[3 + j];
      const double inv_d = 1.0 / d;
      const double bi = row ? (double)W[lane * lw + k + 3] : 0.0;
#pragma unroll
      for (int j = 0; j < MAXR - 3; ++j) {
        if (j < m) {
          const double yj = __shfl_sync(0xffffffffu, (bi - acc) * inv_d, j + 3);
          if (i == j) y = yj;
          if (row && i > j) acc = fma(x[3 + j], yj, acc);
        }
      }
      const double gam = warp_sum_d(row ? y * y : 0.0);
      if (lane == 0) gamma[fi] = (float)gam;
    } else if (lane == 0) {
      gamma[fi] = __int_as_float(0x7fc00000);  // NaN: the wrapper forms it
    }
    if (lane == 0) nrows[fi] = 2 * __popc(valid_bits);
    __syncwarp();
  }
}

template <bool EXT, bool INTR, int MAXR>
int launch(const Operands& in, Layout L, float* H, float* res, int* nrows,
           float* gamma, int batch, cudaStream_t stream) {
  constexpr bool GAMMA = MAXR <= 24;
  const int R = 2 * L.O;
  L.lw = (L.k + 4) | 1;
  L.lm = R | 1;
  // per warp: M and the reflectors (doubles), W, the reflectors (floats),
  // each observation's slot and camera; even counts keep the doubles
  // 8-byte aligned
  L.per_warp = 2 * ((GAMMA ? R * L.lm : 0) + 3 * MAXR + 4) + R * L.lw +
               3 * MAXR + 4 + 2 * L.O;
  L.per_warp += L.per_warp & 1;
  L.head = ((L.D + 3) & ~3) + ((L.k + 3) & ~3) +
           (GAMMA ? ((L.k * L.k + 3) & ~3) : 0);
  const int two = (SMEM_HALF / 4 - L.head) / L.per_warp;
  const int fit = two >= 1 ? two : (SMEM_MAX / 4 - L.head) / L.per_warp;
  int warps = fit < MAX_WARPS ? fit : MAX_WARPS;
  if (warps > L.F) warps = L.F;
  if (warps < 1) return (int)cudaErrorInvalidValue;
  // few streams: split each stream's features over more CTAs
  int groups = 1;
  if (batch < FILL_CTAS) {
    const int most = (L.F + warps - 1) / warps;
    groups = (FILL_CTAS + batch - 1) / batch;
    if (groups > most) groups = most;
  }
  L.warps = warps;
  L.groups = groups;
  L.fpc = (L.F + groups - 1) / groups;
  const size_t bytes = 4 * ((size_t)L.head + (size_t)warps * L.per_warp);
  // raised once per size, so that a launch captured into a CUDA graph makes
  // no other runtime call
  static size_t allowed = 48 * 1024;
  if (bytes > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        msckf_linearize_kernel<EXT, INTR, MAXR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    allowed = bytes;
  }
  const long long blocks = (long long)batch * groups;
  msckf_linearize_kernel<EXT, INTR, MAXR>
      <<<(unsigned)blocks, warps * 32, bytes, stream>>>(in, L, H, res, nrows,
                                                        gamma);
  return (int)cudaGetLastError();
}

template <bool EXT, bool INTR>
int launch_rows(const Operands& in, const Layout& L, float* H, float* res,
                int* nrows, float* gamma, int batch, cudaStream_t stream) {
  if (2 * L.O <= 24)
    return launch<EXT, INTR, 24>(in, L, H, res, nrows, gamma, batch, stream);
  return launch<EXT, INTR, 2 * MAX_O>(in, L, H, res, nrows, gamma, batch,
                                      stream);
}

}  // namespace

// Launch `batch` streams on `stream`: each operand at b times its stride (in
// elements).  The support is the n_ranges column ranges [ra_i, rb_i);
// clones_off, ext_off and intr_off are the error state's clone, camera
// extrinsic and camera intrinsic offsets; equi selects the equidistant
// model over radtan; sigma2 is the pixel noise's variance.  Returns
// cudaGetLastError() (0 = launched).
extern "C" int msckf_linearize_f32(
    const float* uv, long long s_uv, const unsigned char* mask,
    long long s_mask, const float* pf, long long s_pf, const float* cq,
    long long s_cq, const float* cp, long long s_cp, const float* cqf,
    long long s_cqf, const float* cpf, long long s_cpf, const float* eq,
    long long s_eq, const float* ep, long long s_ep, const float* zi,
    long long s_zi, const float* cov, long long s_cov, const long long* slot,
    long long s_slot, const long long* cam, long long s_cam, float* H,
    float* res, int* nrows, float* gamma, int batch, int F, int O, int D,
    int C, int N, int clones_off, int ext_off, int intr_off, int equi,
    int calib_ext, int calib_intr, int n_ranges, int ra0, int rb0, int ra1,
    int rb1, int ra2, int rb2, int ra3, int rb3, float sigma2, void* stream) {
  if (batch <= 0 || F <= 0 || O < 2 || O > MAX_O || O != C * N ||
      n_ranges < 1 || n_ranges > MAX_RANGES)
    return (int)cudaErrorInvalidValue;
  const Operands in = {uv, s_uv, mask, s_mask, pf, s_pf, cq, s_cq, cp,
                       s_cp, cqf, s_cqf, cpf, s_cpf, eq, s_eq, ep, s_ep,
                       zi, s_zi, cov, s_cov, slot, s_slot, cam, s_cam};
  Layout L = {};
  L.F = F;
  L.O = O;
  L.D = D;
  L.clones_off = clones_off;
  L.ext_off = ext_off;
  L.intr_off = intr_off;
  L.equi = equi;
  L.n_ranges = n_ranges;
  const int ra[MAX_RANGES] = {ra0, ra1, ra2, ra3};
  const int rb[MAX_RANGES] = {rb0, rb1, rb2, rb3};
  L.k = 0;
  int start = 0;  // ranges ascending and disjoint; the gaps between them
  for (int r = 0; r < n_ranges; ++r) {
    if (ra[r] < start || rb[r] <= ra[r] || rb[r] > D)
      return (int)cudaErrorInvalidValue;
    L.ra[r] = ra[r];
    L.rb[r] = rb[r];
    L.k += rb[r] - ra[r];
    if (ra[r] > start) {
      L.za[L.n_gaps] = start;
      L.zb[L.n_gaps++] = ra[r];
    }
    start = rb[r];
  }
  if (start < D) {
    L.za[L.n_gaps] = start;
    L.zb[L.n_gaps++] = D;
  }
  L.sigma2 = sigma2;
  cudaStream_t s = (cudaStream_t)stream;
  if (calib_ext && calib_intr)
    return launch_rows<true, true>(in, L, H, res, nrows, gamma, batch, s);
  if (calib_ext)
    return launch_rows<true, false>(in, L, H, res, nrows, gamma, batch, s);
  if (calib_intr)
    return launch_rows<false, true>(in, L, H, res, nrows, gamma, batch, s);
  return launch_rows<false, false>(in, L, H, res, nrows, gamma, batch, s);
}
