// Blocked Householder QR in compact WY form for Hopper (sm_90a):
//
//     R[b] = triu(top n rows of H_{n-1} ... H_0 A[b]),   b = 0 .. g-1
//
// A [g, B, n] float32, row-major and contiguous, B >= n; R [g, n, n] with the
// strict lower triangle exactly 0.  The row blocks of a TSQR reduction
// (update_helper._tsqr_r): each block is factored independently, and the
// stacked R factors are combined outside this kernel.
//
// Replaces the TPU kernel `_house_qr_block_kernel` (open_vins_tpu/ops/
// pallas_kernels.py, reached through householder_qr_blocks_pallas), which
// keeps one [B, n] block in VMEM and applies each reflector as two MXU
// products.  It applies the same reflectors (sign +1 when alpha >= 0;
// scale = 2/|v|^2 only when |v|^2 > 1e-30, so a zero column is an identity
// reflector; v not normalised), so it can be compared element by element
// with `householder_qr_blocks_ref`.
//
// The LAPACK geqrt scheme.  The entry point copies A into a working copy and
// walks over panels of nb columns; per panel starting at column j0:
//
//   1. panel kernel, one CTA of 512 threads per row block, factors the panel
//      A[j0:B, j0:j0+nb] column by column.  Each column's reflector v stays
//      below the diagonal of the panel (only the diagonal entry of its own
//      column is updated), so the panel holds R and V together.  Per column
//      two barriers: the reflector is formed by every thread from per-warp
//      sums of squares (added in a fixed order), then part[warp][c] = sum
//      over the warp's rows of v[r] A[r][c] for every panel column c, then
//      one update pass, in which the lane of column j + 1 also leaves that
//      column's sums of squares for the next step.  For c < j the same sums
//      are y = V[:, c]^T v_j, which build the triangular factor T with
//      H_j0 ... H_{j0+nb-1} = I - V T V^T (LAPACK larft, forward, columnwise:
//      T[j][j] = scale_j, T[0:j, j] = -scale_j T[0:j, 0:j] y).  A zero scale
//      gives a zero row and column of T and a zero column of V.  The panel
//      (R rows), V [B - j0, 32] and T [32, 32] go to global memory.
//      Two versions: up to 640 rows (B = 2n for n <= 320, every block the
//      port cuts) the panel lives in registers, thread (warp, lane) holding
//      column `lane` of rows warp + 16 i, and column j reaches the other
//      lanes by warp shuffles (qr_panel_reg_kernel, nb = 32); taller panels
//      live in shared memory (qr_panel_kernel, nb = 32, or narrower when 32
//      columns of B rows do not fit).
//   2. trailing-update kernel, one CTA per (row block, 32 trailing columns):
//      C -= V (T^T (V^T C)) for C = A[j0:B, j0+nb:n], V and C staged through
//      shared memory in chunks of 64 rows, with register-tiled f32 FMAs (no
//      TF32, no tensor cores).  An exactly zero column C stays exactly 0.
//
// After the last panel one kernel writes R = triu(top n rows).  Ragged cases
// are loop bounds: the last panel (n not a multiple of nb), n < nb, B = n,
// g = 1.  Every sum runs in a fixed order, so the result is deterministic.
//
// What bounds it: the work is 2 B n^2 - 2/3 n^3 flops per block (67 MFLOP at
// (544, 271)), the bytes one read of A and one write of R: a few
// microseconds on an H100.  The n dependent column steps of the panels run
// on g CTAs with two barriers each; at (3, 544, 271) they take about 1.5-2
// us each and set the time (70 % of it), the trailing updates the rest.

#include <cuda_runtime.h>
#include <stddef.h>

#define NBMAX 32          // panel width; V and T are stored 32 wide
#define PANEL_NT 512      // panel kernel threads
#define PANEL_WARPS (PANEL_NT / 32)
#define TRAIL_NT 256      // trailing kernel threads: 8 warps x 32 lanes
#define TRAIL_CT 32       // trailing columns per CTA (one per lane)
#define TRAIL_RC 64       // rows per staged chunk
#define MAX_SMEM 232448   // bytes of shared memory a block may use (H100)
#define REG_RPT_MAX 40    // register panel: at most 16 * 40 = 640 rows

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool pred) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 4 : 0));  // size 0: fill with zeros
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool pred) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Factor the panel of nb columns at j0 of every row block.  work [g, B, n]
// (in/out), V [g, B, 32] (rows j0.. written), T [g, 32, 32] (written).
__global__ void __launch_bounds__(PANEL_NT)
qr_panel_kernel(float* __restrict__ work, float* __restrict__ Vg,
                float* __restrict__ Tg, int B, int n, int j0, int nb) {
  extern __shared__ float pn[];  // [B - j0][nb + 1]: the panel, rows padded
                                 // by one so column reads are conflict-free
  __shared__ float red[2][PANEL_WARPS];  // per-warp sums of squares
  __shared__ float part[PANEL_WARPS][NBMAX];
  __shared__ float Y[NBMAX][NBMAX];  // Y[c][j] = V[:, c]^T v_j, c < j
  __shared__ float Ts[NBMAX][NBMAX];
  __shared__ float tau[NBMAX];
  __shared__ float vdiag[NBMAX];

  const size_t blk = blockIdx.x;
  float* a = work + blk * (size_t)B * n;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int Bp = B - j0;
  const int w = min(nb, n - j0);  // this panel's columns
  const int ld = nb + 1;

  for (int i = tid; i < Bp * nb; i += PANEL_NT) {
    const int r = i / nb;
    const int c = i - r * nb;
    const bool in = c < w;
    cp_async4(&pn[r * ld + c], a + (in ? (size_t)(j0 + r) * n + j0 + c : 0),
              in);
  }
  cp_async_commit();
  for (int i = tid; i < NBMAX * NBMAX; i += PANEL_NT) {
    Ts[i / NBMAX][i % NBMAX] = 0.f;
    Y[i / NBMAX][i % NBMAX] = 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();

  // red[j & 1][warp]: the warp's sum of squares of column j below the
  // diagonal (rows strided by the block, then shuffles)
  auto column_squares = [&](int j) {
    float s = 0.f;
    for (int r = j + 1 + tid; r < Bp; r += PANEL_NT) {
      const float x = pn[r * ld + j];
      s = fmaf(x, x, s);
    }
    s = warp_sum(s);
    if (lane == 0) red[j & 1][warp] = s;
  };
  column_squares(0);
  __syncthreads();

  for (int j = 0; j < w; ++j) {
    // 1. every thread forms the same reflector from the same sums
    float t = 0.f;
    for (int q = 0; q < PANEL_WARPS; ++q) t += red[j & 1][q];
    const float alpha = pn[j * ld + j];
    const float normx = sqrtf(fmaf(alpha, alpha, t));
    const float beta = alpha >= 0.f ? -normx : normx;
    const float vj = alpha - beta;
    const float vn2 = fmaf(vj, vj, t);
    const float scale = vn2 > 1e-30f ? 2.f / vn2 : 0.f;
    if (tid == 0) {
      tau[j] = scale;
      vdiag[j] = vj;
    }
    if (scale == 0.f) {  // identity reflector (uniform branch)
      if (j + 1 < w) column_squares(j + 1);
      __syncthreads();
      continue;
    }

    // 2. part[warp][c] = sum over the warp's rows r >= j of v[r] A[r][c],
    //    four rows at a time into four sums added in a fixed order
    if (lane < w) {
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
      int r = j + warp;
      for (; r + 3 * PANEL_WARPS < Bp; r += 4 * PANEL_WARPS) {
        const int r1 = r + PANEL_WARPS, r2 = r1 + PANEL_WARPS,
                  r3 = r2 + PANEL_WARPS;
        s0 = fmaf(r == j ? vj : pn[r * ld + j], pn[r * ld + lane], s0);
        s1 = fmaf(pn[r1 * ld + j], pn[r1 * ld + lane], s1);
        s2 = fmaf(pn[r2 * ld + j], pn[r2 * ld + lane], s2);
        s3 = fmaf(pn[r3 * ld + j], pn[r3 * ld + lane], s3);
      }
      for (; r < Bp; r += PANEL_WARPS)
        s0 = fmaf(r == j ? vj : pn[r * ld + j], pn[r * ld + lane], s0);
      part[warp][lane] = (s0 + s1) + (s2 + s3);
    }
    __syncthreads();

    // 3. lane c: its column's sum in a fixed order; c < j keeps y for T,
    //    c > j takes the update A[r][c] -= v[r] scale w[c], c = j only its
    //    diagonal entry (the entries below stay v).  Lane j + 1 also sums
    //    the squares of its new entries below row j + 1 for the next step.
    if (lane < w) {
      float sum = 0.f;
      for (int q = 0; q < PANEL_WARPS; ++q) sum += part[q][lane];
      if (lane < j) {
        if (warp == 0) Y[lane][j] = sum;
      } else if (lane == j) {
        if (warp == 0) pn[j * ld + j] = fmaf(-vj, scale * sum, alpha);
      } else {
        const float wc = scale * sum;
        float sq = 0.f;
        // four rows at a time: their loads ahead of their stores
        int r = j + warp;
        for (; r + 3 * PANEL_WARPS < Bp; r += 4 * PANEL_WARPS) {
          float vr[4], x[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int ru = r + u * PANEL_WARPS;
            vr[u] = ru == j ? vj : pn[ru * ld + j];
            x[u] = pn[ru * ld + lane];
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int ru = r + u * PANEL_WARPS;
            x[u] = fmaf(-vr[u], wc, x[u]);
            pn[ru * ld + lane] = x[u];
            if (ru > j + 1) sq = fmaf(x[u], x[u], sq);
          }
        }
        for (; r < Bp; r += PANEL_WARPS) {
          const float vr = r == j ? vj : pn[r * ld + j];
          const float x = fmaf(-vr, wc, pn[r * ld + lane]);
          pn[r * ld + lane] = x;
          if (r > j + 1) sq = fmaf(x, x, sq);
        }
        if (lane == j + 1) red[(j + 1) & 1][warp] = sq;
      }
    }
    __syncthreads();  // column j + 1 and its squares are read next
  }

  // T, column by column: T[i][j] = -tau_j sum_{k=i}^{j-1} T[i][k] Y[k][j]
  if (tid < NBMAX) Ts[tid][tid] = tid < w ? tau[tid] : 0.f;
  __syncthreads();
  for (int j = 1; j < w; ++j) {
    if (tid < j && tau[j] != 0.f) {
      float z = 0.f;
      for (int k = tid; k < j; ++k) z = fmaf(Ts[tid][k], Y[k][j], z);
      Ts[tid][j] = -tau[j] * z;
    }
    __syncthreads();
  }

  // the panel back (R rows; what lies below the diagonal is never read),
  // V with its explicit zeros and diagonal, and T
  float* vb = Vg + blk * (size_t)B * NBMAX;
  for (int i = tid; i < Bp * NBMAX; i += PANEL_NT) {
    const int r = i / NBMAX;
    const int c = i - r * NBMAX;
    const float x = c < w ? pn[r * ld + c] : 0.f;
    if (c < w) a[(size_t)(j0 + r) * n + j0 + c] = x;
    float v = 0.f;
    if (c < w && tau[c] != 0.f) v = r > c ? x : (r == c ? vdiag[c] : 0.f);
    vb[(size_t)(j0 + r) * NBMAX + c] = v;
  }
  float* tb = Tg + blk * NBMAX * NBMAX;
  for (int i = tid; i < NBMAX * NBMAX; i += PANEL_NT)
    tb[i] = Ts[i / NBMAX][i % NBMAX];
}

// The same panel factorization with the panel in registers, for panels of
// at most 16 * RPT rows: thread (warp, lane) holds column `lane` of rows
// warp + 16 i, i < RPT.  Column j reaches the other lanes by warp shuffles
// from lane j, so a row costs a shuffle and three FMAs per column step
// instead of shared-memory loads and stores.  Same reflectors, same T, same
// outputs as qr_panel_kernel; panel width 32.
template <int RPT>
__global__ void __launch_bounds__(PANEL_NT)
qr_panel_reg_kernel(float* __restrict__ work, float* __restrict__ Vg,
                    float* __restrict__ Tg, int B, int n, int j0) {
  __shared__ float red[2][PANEL_WARPS];  // per-warp sums of squares
  __shared__ float diag[2];              // the next column's diagonal entry
  __shared__ float part[PANEL_WARPS][NBMAX];
  __shared__ float Y[NBMAX][NBMAX];  // Y[c][j] = V[:, c]^T v_j, c < j
  __shared__ float Ts[NBMAX][NBMAX];
  __shared__ float tau[NBMAX];
  __shared__ float vdiag[NBMAX];

  const size_t blk = blockIdx.x;
  float* a = work + blk * (size_t)B * n;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int Bp = B - j0;
  const int w = min(NBMAX, n - j0);  // this panel's columns

  float x[RPT];  // rows warp + 16 i of column `lane`
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = warp + PANEL_WARPS * i;
    x[i] = (lane < w && r < Bp) ? a[(size_t)(j0 + r) * n + j0 + lane] : 0.f;
  }
  for (int i = tid; i < NBMAX * NBMAX; i += PANEL_NT) {
    Ts[i / NBMAX][i % NBMAX] = 0.f;
    Y[i / NBMAX][i % NBMAX] = 0.f;
  }

  // lane c of every warp: the warp's sum of squares of column c below the
  // diagonal into red[c & 1], and the owner of (c, c) its entry
  auto column_stats = [&](int c) {
    if (lane != c) return;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = warp + PANEL_WARPS * i;
      if (r > c) sq = fmaf(x[i], x[i], sq);
      if (r == c) diag[c & 1] = x[i];
    }
    red[c & 1][warp] = sq;
  };
  column_stats(0);
  __syncthreads();

  for (int j = 0; j < w; ++j) {
    // 1. every thread forms the same reflector from the same sums
    float t = 0.f;
    for (int q = 0; q < PANEL_WARPS; ++q) t += red[j & 1][q];
    const float alpha = diag[j & 1];
    const float normx = sqrtf(fmaf(alpha, alpha, t));
    const float beta = alpha >= 0.f ? -normx : normx;
    const float vj = alpha - beta;
    const float vn2 = fmaf(vj, vj, t);
    const float scale = vn2 > 1e-30f ? 2.f / vn2 : 0.f;
    if (tid == 0) {
      tau[j] = scale;
      vdiag[j] = vj;
    }
    if (scale == 0.f) {  // identity reflector (uniform branch)
      if (j + 1 < w) column_stats(j + 1);
      __syncthreads();
      continue;
    }

    // 2. v (column j of the warp's rows, 0 above row j, vj at row j) and
    //    part[warp][c] = sum over the warp's rows of v[r] A[r][c]
    float v[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = warp + PANEL_WARPS * i;
      const float s = __shfl_sync(0xffffffffu, x[i], j);
      v[i] = r < j ? 0.f : (r == j ? vj : s);
    }
    float s4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < RPT; ++i) s4[i & 3] = fmaf(v[i], x[i], s4[i & 3]);
    part[warp][lane] = (s4[0] + s4[1]) + (s4[2] + s4[3]);
    __syncthreads();

    // 3. lane c: its column's sum in a fixed order; c < j keeps y for T,
    //    c > j takes the update, c = j only its diagonal entry; lane j + 1
    //    also leaves the next column's squares and diagonal
    float sum = 0.f;
    for (int q = 0; q < PANEL_WARPS; ++q) sum += part[q][lane];
    if (lane < j) {
      if (warp == 0) Y[lane][j] = sum;
    } else if (lane == j) {
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        if (warp + PANEL_WARPS * i == j) x[i] = fmaf(-vj, scale * sum, alpha);
    } else if (lane < w) {
      const float wc = scale * sum;
#pragma unroll
      for (int i = 0; i < RPT; ++i) x[i] = fmaf(-v[i], wc, x[i]);
      column_stats(j + 1);
    }
    __syncthreads();  // column j + 1's sums are read next
  }

  // T, column by column: T[i][j] = -tau_j sum_{k=i}^{j-1} T[i][k] Y[k][j]
  if (tid < NBMAX) Ts[tid][tid] = tid < w ? tau[tid] : 0.f;
  __syncthreads();
  for (int j = 1; j < w; ++j) {
    if (tid < j && tau[j] != 0.f) {
      float z = 0.f;
      for (int k = tid; k < j; ++k) z = fmaf(Ts[tid][k], Y[k][j], z);
      Ts[tid][j] = -tau[j] * z;
    }
    __syncthreads();
  }

  // the panel back, V with its explicit zeros and diagonal, and T
  float* vb = Vg + blk * (size_t)B * NBMAX;
  const bool reflector = lane < w && tau[lane] != 0.f;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = warp + PANEL_WARPS * i;
    if (r < Bp) {
      if (lane < w) a[(size_t)(j0 + r) * n + j0 + lane] = x[i];
      float v = 0.f;
      if (reflector) v = r > lane ? x[i] : (r == lane ? vdiag[lane] : 0.f);
      vb[(size_t)(j0 + r) * NBMAX + lane] = v;
    }
  }
  float* tb = Tg + blk * NBMAX * NBMAX;
  for (int i = tid; i < NBMAX * NBMAX; i += PANEL_NT)
    tb[i] = Ts[i / NBMAX][i % NBMAX];
}

// C -= V T^T V^T C for C = work[b][j0:B, c0:c0+32], c0 = j0 + nb +
// 32 * blockIdx.x, b = blockIdx.y.  V and T are 32 wide, zero past nb.  The
// V and C chunks of 64 rows come through a double buffer of cp.async copies
// (rows past B and columns past n are zero-filled).
__global__ void __launch_bounds__(TRAIL_NT)
qr_trailing_kernel(float* __restrict__ work, const float* __restrict__ Vg,
                   const float* __restrict__ Tg, int B, int n, int j0,
                   int nb) {
  __shared__ __align__(16) float Vc[2][TRAIL_RC][NBMAX];
  __shared__ float Cc[2][TRAIL_RC][TRAIL_CT];
  __shared__ float Ts[NBMAX][NBMAX];
  __shared__ float Ys[NBMAX][TRAIL_CT];  // Y, then W

  const size_t blk = blockIdx.y;
  float* a = work + blk * (size_t)B * n;
  const float* vb = Vg + blk * (size_t)B * NBMAX;
  const float* tb = Tg + blk * NBMAX * NBMAX;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;  // 0..7: reflectors 4 warp .. 4 warp + 3
  const int c0 = j0 + nb + TRAIL_CT * blockIdx.x;
  const int col = c0 + lane;
  const int n_chunks = (B - j0 + TRAIL_RC - 1) / TRAIL_RC;

  auto load_chunk = [&](int buf, int chunk) {
    const int r0 = j0 + chunk * TRAIL_RC;
#pragma unroll
    for (int e = tid; e < TRAIL_RC * NBMAX / 4; e += TRAIL_NT) {
      const int r = e / (NBMAX / 4);
      const int q = e - r * (NBMAX / 4);
      const bool in = r0 + r < B;
      cp_async16(&Vc[buf][r][4 * q],
                 vb + (in ? (size_t)(r0 + r) * NBMAX + 4 * q : 0), in);
    }
#pragma unroll
    for (int e = tid; e < TRAIL_RC * TRAIL_CT; e += TRAIL_NT) {
      const int r = e / TRAIL_CT;
      const int c = e - r * TRAIL_CT;
      const bool in = r0 + r < B && c0 + c < n;
      cp_async4(&Cc[buf][r][c], a + (in ? (size_t)(r0 + r) * n + c0 + c : 0),
                in);
    }
    cp_async_commit();
  };

  for (int i = tid; i < NBMAX * NBMAX; i += TRAIL_NT)
    Ts[i / NBMAX][i % NBMAX] = tb[i];

  // 1. Y = V^T C: thread (warp, lane) sums rows for reflectors 4 warp + i
  float y[4] = {0.f, 0.f, 0.f, 0.f};
  load_chunk(0, 0);
  for (int ch = 0; ch < n_chunks; ++ch) {
    if (ch + 1 < n_chunks) {
      load_chunk((ch + 1) & 1, ch + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int buf = ch & 1;
#pragma unroll 8
    for (int r = 0; r < TRAIL_RC; ++r) {
      const float cv = Cc[buf][r][lane];
      const float4 v4 = *reinterpret_cast<const float4*>(&Vc[buf][r][4 * warp]);
      y[0] = fmaf(v4.x, cv, y[0]);
      y[1] = fmaf(v4.y, cv, y[1]);
      y[2] = fmaf(v4.z, cv, y[2]);
      y[3] = fmaf(v4.w, cv, y[3]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) Ys[4 * warp + i][lane] = y[i];
  load_chunk(0, 0);  // step 3's first chunk, in flight during step 2
  __syncthreads();

  // 2. W = T^T Y: thread (warp, lane) forms rows 4 warp + i of column lane,
  //    then every thread takes its column of W into registers
  float wk[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i = 0; i < 4 * warp + 4; ++i) {
    const float yi = Ys[i][lane];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      wk[u] = fmaf(Ts[i][4 * warp + u], yi, wk[u]);  // T[i][k] = 0 for i > k
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < 4; ++u) Ys[4 * warp + u][lane] = wk[u];
  __syncthreads();
  float wreg[NBMAX];
#pragma unroll
  for (int k = 0; k < NBMAX; ++k) wreg[k] = Ys[k][lane];

  // 3. C -= V W, rows warp + 8 i of each chunk
  for (int ch = 0; ch < n_chunks; ++ch) {
    if (ch + 1 < n_chunks) {
      load_chunk((ch + 1) & 1, ch + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int buf = ch & 1;
    const int r0 = j0 + ch * TRAIL_RC;
#pragma unroll
    for (int r = warp; r < TRAIL_RC; r += TRAIL_NT / 32) {
      float cv = Cc[buf][r][lane];
#pragma unroll
      for (int k = 0; k < NBMAX; k += 4) {
        const float4 v4 = *reinterpret_cast<const float4*>(&Vc[buf][r][k]);
        cv = fmaf(-v4.x, wreg[k], cv);
        cv = fmaf(-v4.y, wreg[k + 1], cv);
        cv = fmaf(-v4.z, wreg[k + 2], cv);
        cv = fmaf(-v4.w, wreg[k + 3], cv);
      }
      if (r0 + r < B && col < n) a[(size_t)(r0 + r) * n + col] = cv;
    }
    __syncthreads();
  }
}

// R = upper triangle of the top n rows of each block's working copy.
__global__ void qr_extract_r_kernel(const float* __restrict__ work,
                                    float* __restrict__ R, int B, int n) {
  const size_t blk = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * n) return;
  const int r = i / n;
  const int c = i - r * n;
  R[blk * (size_t)n * n + i] =
      c >= r ? work[blk * (size_t)B * n + (size_t)r * n + c] : 0.f;
}


// The register panel with the fewest rows per thread that hold the panel.
static void launch_reg_panel(int rows_per_thread, int g, cudaStream_t st,
                             float* work, float* Vg, float* Tg, int B, int n,
                             int j0) {
  if (rows_per_thread <= 8)
    qr_panel_reg_kernel<8><<<g, PANEL_NT, 0, st>>>(work, Vg, Tg, B, n, j0);
  else if (rows_per_thread <= 16)
    qr_panel_reg_kernel<16><<<g, PANEL_NT, 0, st>>>(work, Vg, Tg, B, n, j0);
  else if (rows_per_thread <= 24)
    qr_panel_reg_kernel<24><<<g, PANEL_NT, 0, st>>>(work, Vg, Tg, B, n, j0);
  else if (rows_per_thread <= 32)
    qr_panel_reg_kernel<32><<<g, PANEL_NT, 0, st>>>(work, Vg, Tg, B, n, j0);
  else
    qr_panel_reg_kernel<REG_RPT_MAX><<<g, PANEL_NT, 0, st>>>(work, Vg, Tg, B,
                                                            n, j0);
}

// Launch on `stream`: A [g, B, n] in; work [g, B, n] and vt
// [g, B * 32 + 32 * 32] scratch; R [g, n, n] out.  Every launch is checked;
// returns the first error (0 = all launched).
extern "C" int householder_qr_blocks_f32(const float* A, float* work,
                                         float* vt, float* R, int g, int B,
                                         int n, void* stream) {
  if (g <= 0 || n <= 0 || B < n) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  const bool in_registers = B <= PANEL_WARPS * REG_RPT_MAX;
  int nb = NBMAX;
  size_t smem = 0;  // the shared-memory panel's dynamic bytes
  if (!in_registers) {
    // the widest panel (32, 16, ..., 1 columns) whose B rows fit
    const size_t static_smem = sizeof(float) * (2 * PANEL_WARPS +
        PANEL_WARPS * NBMAX + 2 * NBMAX * NBMAX + 2 * NBMAX);
    while (nb > 1 && sizeof(float) * (size_t)B * (nb + 1) + static_smem >
                         MAX_SMEM)
      nb >>= 1;
    smem = sizeof(float) * (size_t)B * (nb + 1);
    if (smem + static_smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
    e = cudaFuncSetAttribute(qr_panel_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  e = cudaMemcpyAsync(work, A, sizeof(float) * (size_t)g * B * n,
                      cudaMemcpyDeviceToDevice, st);
  if (e != cudaSuccess) return (int)e;
  float* Vg = vt;
  float* Tg = vt + (size_t)g * B * NBMAX;
  for (int j0 = 0; j0 < n; j0 += nb) {
    if (in_registers)
      launch_reg_panel((B - j0 + PANEL_WARPS - 1) / PANEL_WARPS, g, st, work,
                       Vg, Tg, B, n, j0);
    else
      qr_panel_kernel<<<g, PANEL_NT, smem, st>>>(work, Vg, Tg, B, n, j0, nb);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const int trailing = n - j0 - nb;
    if (trailing > 0) {
      dim3 grid((trailing + TRAIL_CT - 1) / TRAIL_CT, g);
      qr_trailing_kernel<<<grid, TRAIL_NT, 0, st>>>(work, Vg, Tg, B, n, j0,
                                                    nb);
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
  }
  dim3 grid((n * n + 255) / 256, g);
  qr_extract_r_kernel<<<grid, 256, 0, st>>>(work, R, B, n);
  return (int)cudaGetLastError();
}
