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
//   * 32x32 output tiles, one thread per element, and a grid over the
//     upper-triangle tile pairs (i <= j) only;
//   * the K and PHt row panels of tiles i and j are staged through shared
//     memory in chunks of 32 along m; products are plain f32 FMAs (no TF32);
//   * each element is written to both (r, c) and (c, r) -- the mirrored
//     store goes through a shared-memory transpose so it stays coalesced --
//     so the result is exactly symmetric by construction.  On a diagonal
//     tile the two threads that own (r, c) and (c, r) form the same products
//     in the same order, so they write the same bits;
//   * ragged D and m are masked in the loads and stores: no padded copies;
//   * K != PHt is allowed (the information, Newton and SPD update forms
//     call it so).
//
// What bounds it: at the MSCKF operating point (D = 120, m = 81) the call
// moves ~0.15 MB (P, K, PHt read once, out written once) and does
// 2 * D^2 * m ~ 2.3 MFLOP -- about 0.05 us of HBM time and 0.03 us of f32
// FMA time on an H100, far below the few microseconds of one launch, so the
// kernel is launch-bound there.  At D = 1434 it is still memory-bound
// (8 MB moved, 0.9 GFLOP).  This first version is simple and right; it is
// not tuned.

#include <cuda_runtime.h>
#include <stddef.h>

#define TILE 32

__global__ void __launch_bounds__(TILE * TILE)
symmetric_downdate_kernel(const float* __restrict__ P,
                          const float* __restrict__ K,
                          const float* __restrict__ PHt,
                          float* __restrict__ out, int D, int m, int T) {
  // decode the linear block index into an upper-triangle tile pair (ti, tj)
  int k = blockIdx.x;
  int ti = 0;
  while (k >= T - ti) {
    k -= T - ti;
    ++ti;
  }
  const int tj = ti + k;

  __shared__ float Ki[TILE][TILE + 1];
  __shared__ float Hi[TILE][TILE + 1];
  __shared__ float Kj[TILE][TILE + 1];
  __shared__ float Hj[TILE][TILE + 1];
  __shared__ float Pt[TILE][TILE + 1];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int r = ti * TILE + ty;  // output row
  const int c = tj * TILE + tx;  // output column
  const int ri = ti * TILE + ty;  // panel row loaded by this thread, tile i
  const int rj = tj * TILE + ty;  // panel row loaded by this thread, tile j

  float a = 0.f;  // sum_k K[r,k] PHt[c,k]
  float b = 0.f;  // sum_k PHt[r,k] K[c,k]
  for (int k0 = 0; k0 < m; k0 += TILE) {
    const int kk = k0 + tx;
    const bool kin = kk < m;
    Ki[ty][tx] = (ri < D && kin) ? K[(size_t)ri * m + kk] : 0.f;
    Hi[ty][tx] = (ri < D && kin) ? PHt[(size_t)ri * m + kk] : 0.f;
    Kj[ty][tx] = (rj < D && kin) ? K[(size_t)rj * m + kk] : 0.f;
    Hj[ty][tx] = (rj < D && kin) ? PHt[(size_t)rj * m + kk] : 0.f;
    __syncthreads();
#pragma unroll
    for (int q = 0; q < TILE; ++q) {
      a = fmaf(Ki[ty][q], Hj[tx][q], a);
      b = fmaf(Hi[ty][q], Kj[tx][q], b);
    }
    __syncthreads();
  }

  // P tile (tj, ti), loaded coalesced, read transposed: Pt[tx][ty] = P[c][r]
  {
    const int pr = tj * TILE + ty;
    const int pc = ti * TILE + tx;
    Pt[ty][tx] = (pr < D && pc < D) ? P[(size_t)pr * D + pc] : 0.f;
  }
  __syncthreads();
  const float p_rc = (r < D && c < D) ? P[(size_t)r * D + c] : 0.f;
  const float val = 0.5f * (p_rc + Pt[tx][ty]) - 0.5f * (a + b);
  if (r < D && c < D) out[(size_t)r * D + c] = val;

  if (ti != tj) {  // uniform across the block
    __syncthreads();
    Pt[ty][tx] = val;
    __syncthreads();
    // out[tj*32+ty][ti*32+tx] is the value of the thread (ty'=tx, tx'=ty)
    const int orow = tj * TILE + ty;
    const int ocol = ti * TILE + tx;
    if (orow < D && ocol < D) out[(size_t)orow * D + ocol] = Pt[tx][ty];
  }
}

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int symmetric_downdate_f32(const float* P, const float* K,
                                      const float* PHt, float* out, int D,
                                      int m, void* stream) {
  if (D <= 0 || m < 0) return (int)cudaErrorInvalidValue;
  const int T = (D + TILE - 1) / TILE;
  const int n_blocks = T * (T + 1) / 2;
  dim3 block(TILE, TILE);
  symmetric_downdate_kernel<<<n_blocks, block, 0, (cudaStream_t)stream>>>(
      P, K, PHt, out, D, m, T);
  return (int)cudaGetLastError();
}
