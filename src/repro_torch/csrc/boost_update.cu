// The AdaBoost.F inner loop (paper steps 3-4): the weighted error of every
// hypothesis on every shard, and the fused sample-weight update.
//
// weighted_errors:  eps[c, h] = sum_n w[c, n] * 1[preds[c, h, n] != y[c, n]]
//   Replaces: src/repro/kernels/boost_update.py:weighted_errors (Pallas body
//   _err_kernel), called there once per collaborator under vmap
//   (src/repro/core/scoring.py:error_matrix).  Here one launch covers the
//   whole [C, H, n] prediction tensor.
//   Bound on an H100: bytes.  C*H*n*4 (preds) + 2*C*n*4 (y, w) read once,
//   C*H*4 written, over 3.35 TB/s; one compare and one add per element is far
//   below any compute peak.  At the main path's shapes (adult: [8, 8, 4070])
//   that is ~1.3 MB, well under a microsecond: launch latency dominates.
//   Design: one block per (c, h) row; threads stride over n with coalesced
//   loads, then a warp-shuffle and shared-memory tree reduction.  The order of
//   the sum depends only on n and the block size, so the result is the same
//   from run to run.  It is held to the plain row sum (repro_torch/kernels/
//   ref.py:weighted_errors_ref) at rtol 1e-4, not to the Pallas matvec.
//
// weight_update:  out[i] = w[i] * expf(alpha * mis[i]) * mask[i]
//   Replaces: src/repro/kernels/boost_update.py:weight_update (Pallas body
//   _upd_kernel), applied to the flattened [C*n] weights
//   (src/repro/core/scoring.py:update_weights).
//   Bound on an H100: bytes.  3*N*4 read + N*4 written over 3.35 TB/s
//   (adult: N = 32560, 0.5 MB).
//   Design: a grid-stride elementwise pass.  alpha is read from device memory
//   through a pointer, so the round never copies it to the host; expf (not
//   __expf) keeps it within rtol 1e-5 of the plain version.  The global
//   renormalisation stays a separate sum, as in the JAX package.

#include <cuda_runtime.h>

namespace {

__global__ void weighted_errors_kernel(const int* __restrict__ preds,
                                       const int* __restrict__ y,
                                       const float* __restrict__ w,
                                       float* __restrict__ out, int H, int n) {
  __shared__ float partial[32];
  const int row = blockIdx.x;  // c * H + h
  const int c = row / H;
  const int* p = preds + (long long)row * n;
  const int* yc = y + (long long)c * n;
  const float* wc = w + (long long)c * n;

  float acc = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    acc += (p[i] != yc[i]) ? wc[i] : 0.f;
  }
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) partial[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    acc = lane < n_warps ? partial[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) out[row] = acc;
  }
}

__global__ void weight_update_kernel(const float* __restrict__ w,
                                     const float* __restrict__ mis,
                                     const float* __restrict__ mask,
                                     const float* __restrict__ alpha,
                                     float* __restrict__ out, long long N) {
  const float a = *alpha;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < N; i += stride) {
    out[i] = w[i] * expf(a * mis[i]) * mask[i];
  }
}

}  // namespace

// preds [C, H, n] i32, y [C, n] i32, w [C, n] f32 -> out [C, H] f32.
// threads must be a multiple of 32, at most 1024.
extern "C" int repro_weighted_errors(const void* preds, const void* y, const void* w,
                                     void* out, int C, int H, int n, int threads,
                                     void* stream) {
  weighted_errors_kernel<<<C * H, threads, 0, (cudaStream_t)stream>>>(
      (const int*)preds, (const int*)y, (const float*)w, (float*)out, H, n);
  return (int)cudaGetLastError();
}

// w, mis, mask, out [N] f32; alpha [1] f32 on the device.
extern "C" int repro_weight_update(const void* w, const void* mis, const void* mask,
                                   const void* alpha, void* out, long long N,
                                   int blocks, int threads, void* stream) {
  weight_update_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)w, (const float*)mis, (const float*)mask, (const float*)alpha,
      (float*)out, N);
  return (int)cudaGetLastError();
}
