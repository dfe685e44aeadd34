// Block Householder QR for Hopper (sm_90a):
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
// keeps one [B, n] block in VMEM, pads n to 128 and applies each reflector
// as two MXU products.  It computes the same function with the same
// reflectors (sign +1 when alpha >= 0; scale = 2/|v|^2 only when
// |v|^2 > 1e-30, so a zero column is an identity reflector), so it can be
// compared element by element with `householder_qr_blocks_ref`.  Here:
//
//   * one thread block of 512 threads per row block; ragged B and n are
//     handled by the loop bounds, with no padding;
//   * a block does not fit in shared memory (B = 544, n = 271 is 590 KB;
//     an SM gives a thread block at most 227 KB), so each block's working
//     copy lives in global memory, where the 50 MB L2 holds it, and only v,
//     the partial sums of w and the reductions are staged in shared memory;
//   * per column j: one block-wide reduction of |x|^2 below the diagonal
//     (warp shuffles, then the 16 warp sums in a fixed order); w = v^T A
//     over columns >= j, with lanes on neighbouring columns (coalesced) and
//     the 16 warps on interleaved rows, summed in a fixed order; then the
//     rank-1 update A -= v (scale w) of rows >= j and columns >= j.  Columns
//     < j are never touched again: their entries below the diagonal are
//     discarded, exactly as the final mask discards them in the TPU kernel.
//     All sums run in a fixed order, so the result is deterministic.
//
// What bounds it: the work is 2 B n^2 - 2/3 n^3 flops per block, about
// 67 MFLOP at (544, 271), and the bytes are one read of A and one write of
// R.  On an H100 that is a few microseconds of f32 FMA time over the card
// (67 TFLOP/s) and under a microsecond of HBM time.  This kernel is far
// from that: its n steps are sequential, each with two block-wide barriers
// and a pass over the trailing submatrix in L2, and g blocks occupy only g
// of the 132 SMs.  It is a first, simple and right version; a shared-memory
// resident block (n <= ~170 at B = 2n) or a thread-block-cluster design is
// later work.

#include <cuda_runtime.h>
#include <stddef.h>

#define NT 512
#define WARPS (NT / 32)

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

__global__ void __launch_bounds__(NT)
householder_qr_blocks_kernel(const float* __restrict__ A, float* work_all,
                             float* __restrict__ R, int B, int n) {
  extern __shared__ float smem[];
  float* v = smem;            // [B]   reflector, rows >= j
  float* w = v + B;           // [n]   scale * v^T A, columns >= j
  float* part = w + n;        // [WARPS][n] per-warp partial sums of v^T A
  __shared__ float red[WARPS];
  __shared__ float scale_s;

  const size_t blk = blockIdx.x;
  const size_t Bn = (size_t)B * n;
  const float* a = A + blk * Bn;
  float* work = work_all + blk * Bn;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (size_t i = tid; i < Bn; i += NT) work[i] = a[i];
  __syncthreads();

  for (int j = 0; j < n; ++j) {
    // 1. x = A[j:, j]; v = x below the diagonal, s = sum of their squares
    float s = 0.f;
    for (int r = j + 1 + tid; r < B; r += NT) {
      const float x = work[(size_t)r * n + j];
      v[r] = x;
      s = fmaf(x, x, s);
    }
    s = warp_sum(s);
    if (lane == 0) red[warp] = s;
    __syncthreads();
    if (tid == 0) {
      float t = 0.f;
      for (int q = 0; q < WARPS; ++q) t += red[q];
      const float alpha = work[(size_t)j * n + j];
      const float normx = sqrtf(fmaf(alpha, alpha, t));
      const float beta = alpha >= 0.f ? -normx : normx;
      const float vj = alpha - beta;
      const float vn2 = fmaf(vj, vj, t);
      v[j] = vj;
      scale_s = vn2 > 1e-30f ? 2.f / vn2 : 0.f;
    }
    __syncthreads();
    const float scale = scale_s;
    if (scale == 0.f) continue;  // identity reflector (uniform branch)

    // 2. w = scale * v^T A[j:, j:]
    for (int c0 = j; c0 < n; c0 += 32) {
      const int c = c0 + lane;
      if (c < n) {
        float acc = 0.f;
        for (int r = j + warp; r < B; r += WARPS)
          acc = fmaf(v[r], work[(size_t)r * n + c], acc);
        part[warp * n + c] = acc;
      }
    }
    __syncthreads();
    for (int c = j + tid; c < n; c += NT) {
      float t = 0.f;
      for (int q = 0; q < WARPS; ++q) t += part[q * n + c];
      w[c] = scale * t;
    }
    __syncthreads();

    // 3. A[j:, j:] -= v w
    for (int r = j + warp; r < B; r += WARPS) {
      const float vr = v[r];
      float* row = work + (size_t)r * n;
      for (int c = j + lane; c < n; c += 32) row[c] = fmaf(-vr, w[c], row[c]);
    }
    __syncthreads();
  }

  // 4. R = upper triangle of the top n rows
  float* rb = R + blk * (size_t)n * n;
  for (int i = tid; i < n * n; i += NT) {
    const int r = i / n;
    const int c = i - r * n;
    rb[i] = c >= r ? work[(size_t)r * n + c] : 0.f;
  }
}

// Launch on `stream`: A [g, B, n] in, work [g, B, n] scratch, R [g, n, n]
// out.  Returns cudaGetLastError() (0 = launched).
extern "C" int householder_qr_blocks_f32(const float* A, float* work,
                                         float* R, int g, int B, int n,
                                         void* stream) {
  if (g <= 0 || n <= 0 || B < n) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)B + n + (size_t)WARPS * n);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        householder_qr_blocks_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  householder_qr_blocks_kernel<<<g, NT, smem, (cudaStream_t)stream>>>(
      A, work, R, B, n);
  return (int)cudaGetLastError();
}
