// Symmetric covariance downdate for Hopper (sm_90a):
//
//     out = sym(P - K PHt^T) = 0.5 (P + P^T) - 0.5 (K PHt^T + PHt K^T)
//
// P [D, D], K and PHt [D, m], all float32, row-major and contiguous.
//
// Replaces the TPU kernel `_downdate_kernel` (open_vins_tpu/ops/pallas_kernels.py,
// reached through symmetric_downdate_pallas).  That kernel pads D and m up to
// 128 and computes every 128x128 output tile with two MXU products.  Here:
//
//   * a grid over the upper-triangle tile pairs (i <= j) only, with BM x BM
//     output tiles, each thread owning a TM x TM register micro-tile of
//     outputs, plain f32 FMAs (no TF32).  Two configurations, chosen by D:
//     from D = 512 on, 64 x 64 tiles on 16 x 16 threads (4 x 4 micro-tiles;
//     276 CTAs at D = 1434); below, 16 x 16 tiles on 8 x 8 threads (2 x 2
//     micro-tiles; 153 CTAs at D = 270, where 32 x 32 tiles gave 45 CTAs and
//     left most SMs idle);
//   * the K (and PHt) row panels of tiles i and j are staged along m in
//     chunks (16 wide for the large tiles, 32 for the small ones) with
//     4-byte cp.async into a ring of STAGES buffers, transposed, so a thread
//     reads its micro-tile's rows as one vector.  STAGES - 1 chunks are in
//     flight.  Ragged D and m are zero-filled by the copy (source size 0),
//     with no padded copies.  K rows of m = 231 floats are not 16-byte
//     aligned, so the copies are 4 bytes wide;
//   * `same` (K and PHt are one tensor, the only form the EKF update calls)
//     forms the single product sum_k K[r,k] K[c,k]: 0.5 (a + a) = a exactly,
//     so this is the two-product result up to the order of the sums, for
//     half the operations.  K != PHt keeps both products (the information,
//     Newton and SPD update forms call it so);
//   * exact symmetry by construction: an off-diagonal tile is stored at
//     (i, j) and mirrored to (j, i) through a shared-memory transpose; a
//     diagonal tile writes its upper triangle and mirrors it.  P^T's tile
//     is copied (coalesced, with the first chunk) into shared memory and
//     this thread's entries of P into registers before the products, so
//     their latency hides behind the main loop.
//
// What bounds it: at (1434, 231) with K = PHt the call does D (D + 1) m
// = 0.475 GFLOP and moves 17.8 MB, so it is bound by f32 FMA throughput
// (7 us at 67 TFLOP/s); at the main paths' (120, 81) and (270, 231) the
// device work is a few microseconds, and the loop is bound by the latency of
// its loads and barriers over 15 or fewer chunks.

#include <cuda_runtime.h>
#include <stddef.h>

#define STAGES 4  // ring of staged m chunks, STAGES - 1 in flight

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool pred) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = pred ? 4 : 0;  // 0: fill the destination with zeros
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// TM consecutive floats of a staged panel row (16 or 8 B aligned)
template <int TM>
__device__ __forceinline__ void load_frag(const float* p, float* f) {
  static_assert(TM == 4 || TM == 2, "micro-tiles are 4x4 or 2x2");
  if constexpr (TM == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    f[0] = v.x; f[1] = v.y;
  }
}

template <int BM, int TX, int BK, bool SAME>
__global__ void __launch_bounds__(TX * TX)
symmetric_downdate_kernel(const float* __restrict__ P,
                          const float* __restrict__ K,
                          const float* __restrict__ PHt,
                          float* __restrict__ out, int D, int m, int T) {
  constexpr int NT = TX * TX;
  constexpr int TM = BM / TX;       // micro-tile side
  constexpr int LD = BM + 4;        // staged panel row: [BK][LD], 16 B aligned
  constexpr int PANEL = BK * LD;
  constexpr int NP = SAME ? 2 : 4;  // panels per stage: Ki, Kj (, Hi, Hj)
  constexpr int STAGE = NP * PANEL;
  constexpr int TLD = BM + 1;  // epilogue tiles [BM][BM + 1]
  static_assert(STAGES * STAGE >= BM * TLD, "epilogue tile must fit");
  // [STAGES][STAGE] ring (the output tile in the epilogue), then P^T's tile
  extern __shared__ __align__(16) float smem[];
  float* pt_tile = smem + STAGES * STAGE;

  // decode the linear block index into an upper-triangle tile pair (ti, tj)
  int q = blockIdx.x;
  int ti = 0;
  while (q >= T - ti) {
    q -= T - ti;
    ++ti;
  }
  const int tj = ti + q;
  const int r0 = ti * BM;  // output rows
  const int c0 = tj * BM;  // output columns

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;

  // stage s: panels [k][row] of rows r0.. (i) and c0.. (j), chunk k0
  auto load_stage = [&](int buf, int k0) {
    float* st = smem + buf * STAGE;
#pragma unroll
    for (int e = tid; e < BM * BK; e += NT) {
      const int row = e / BK;
      const int kk = e - row * BK;
      const int k = k0 + kk;
      const int ri = r0 + row;
      const int rj = c0 + row;
      const bool ki = ri < D && k < m;
      const bool kj = rj < D && k < m;
      const size_t oi = ki ? (size_t)ri * m + k : 0;
      const size_t oj = kj ? (size_t)rj * m + k : 0;
      cp_async4(st + kk * LD + row, K + oi, ki);
      cp_async4(st + PANEL + kk * LD + row, K + oj, kj);
      if constexpr (!SAME) {
        cp_async4(st + 2 * PANEL + kk * LD + row, PHt + oi, ki);
        cp_async4(st + 3 * PANEL + kk * LD + row, PHt + oj, kj);
      }
    }
  };

  float acc[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = 0.f;

  // P^T's tile, pt_tile[y][x] = P[c0 + y][r0 + x], coalesced, with the
  // first chunk; this thread's entries of P into registers
  for (int e = tid; e < BM * BM; e += NT) {
    const int y = e / BM;
    const int x = e - y * BM;
    const bool in = c0 + y < D && r0 + x < D;
    cp_async4(pt_tile + y * TLD + x, P + (in ? (size_t)(c0 + y) * D + r0 + x : 0),
              in);
  }
  float p[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + ty * TM + i;
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int c = c0 + tx * TM + j;
      p[i][j] = (r < D && c < D) ? P[(size_t)r * D + c] : 0.f;
    }
  }

  const int nk = (m + BK - 1) / BK;
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s * BK);
    cp_async_commit();  // one group per chunk, empty past the end
  }
  for (int s = 0; s < nk; ++s) {
    cp_async_wait<STAGES - 2>();  // chunk s has landed
    __syncthreads();              // ... for every thread; chunk s - 1 is free
    const int nxt = s + STAGES - 1;
    if (nxt < nk) load_stage(nxt % STAGES, nxt * BK);
    cp_async_commit();
    const float* st = smem + (s % STAGES) * STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TM];
      load_frag<TM>(st + kk * LD + ty * TM, a);          // K rows of tile i
      load_frag<TM>(st + PANEL + kk * LD + tx * TM, b);  // K rows of tile j
      if constexpr (SAME) {
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TM; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      } else {
        float h[TM], g[TM];
        load_frag<TM>(st + 2 * PANEL + kk * LD + ty * TM, h);  // PHt, tile i
        load_frag<TM>(st + 3 * PANEL + kk * LD + tx * TM, g);  // PHt, tile j
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TM; ++j)
            acc[i][j] = fmaf(h[i], b[j], fmaf(a[i], g[j], acc[i][j]));
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // P^T's tile has landed; the ring is free

  float val[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int rl = ty * TM + i;
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int cl = tx * TM + j;
      const float sym = 0.5f * (p[i][j] + pt_tile[cl * TLD + rl]);
      val[i][j] = SAME ? sym - acc[i][j] : sym - 0.5f * acc[i][j];
    }
  }
  float* tile = smem;  // the output tile, for the mirrored store
  const bool diag = ti == tj;  // uniform across the block
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int rl = ty * TM + i;
    const int r = r0 + rl;
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int cl = tx * TM + j;
      const int c = c0 + cl;
      if (r < D && c < D && (!diag || rl <= cl))
        out[(size_t)r * D + c] = val[i][j];
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j)
      tile[(ty * TM + i) * TLD + tx * TM + j] = val[i][j];
  __syncthreads();
  // the mirror: out[c0 + y][r0 + x] = val at (r0 + x, c0 + y); on a
  // diagonal tile only the strict lower triangle (y > x)
  for (int e = tid; e < BM * BM; e += NT) {
    const int y = e / BM;
    const int x = e - y * BM;
    const int orow = c0 + y;
    const int ocol = r0 + x;
    if (orow < D && ocol < D && (!diag || y > x))
      out[(size_t)orow * D + ocol] = tile[x * TLD + y];
  }
}

template <int BM, int TX, int BK, bool SAME>
static int launch(const float* P, const float* K, const float* PHt,
                  float* out, int D, int m, cudaStream_t stream) {
  constexpr int smem = (STAGES * (SAME ? 2 : 4) * BK * (BM + 4) +
                        BM * (BM + 1)) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        symmetric_downdate_kernel<BM, TX, BK, SAME>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int T = (D + BM - 1) / BM;
  const int n_blocks = T * (T + 1) / 2;
  symmetric_downdate_kernel<BM, TX, BK, SAME><<<n_blocks, TX * TX, smem,
                                                 stream>>>(
      P, K, PHt, out, D, m, T);
  return (int)cudaGetLastError();
}

// Launch on `stream`; `same` != 0 when K and PHt are one tensor.  Returns
// cudaGetLastError() (0 = launched).
extern "C" int symmetric_downdate_f32(const float* P, const float* K,
                                      const float* PHt, float* out, int D,
                                      int m, int same, void* stream) {
  if (D <= 0 || m < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (D >= 512)
    return same ? launch<64, 16, 16, true>(P, K, PHt, out, D, m, st)
                : launch<64, 16, 16, false>(P, K, PHt, out, D, m, st);
  return same ? launch<16, 8, 32, true>(P, K, PHt, out, D, m, st)
              : launch<16, 8, 32, false>(P, K, PHt, out, D, m, st);
}
