// vote_argmax: the alpha-weighted majority vote of an ensemble's members,
// the one reduction between the members' predicts and a served response.
//
//   out[i] = argmax_k sum_t alpha[t] * 1[preds[t, i] == k]
//
// Replaces: src/repro/kernels/vote_argmax.py:vote_argmax (Pallas body
// _vote_kernel), whose grid walks the member axis in order while an
// [Nblk, K] vote tile stays resident in VMEM.  Hopper runs blocks in no
// order, so the member axis becomes a loop inside the block, and each
// sample's votes stay in shared memory for the whole loop.
//
// What bounds it on an H100: bytes.  preds (T*n*4), alpha (T*4) read once and
// out (n*4) written once, over 3.35 TB/s; one compare and one add per (member,
// sample) is far below any compute peak.  At the serving batch (T = 10,
// n = 256) that is 11.3 KB, a few nanoseconds: launch latency dominates.
//
// Design:
//  * one thread per sample, blockDim.x samples per block; neighbouring
//    threads read neighbouring preds[t, i], so every load is coalesced;
//  * alpha is staged through shared memory a tile of 256 members at a time;
//  * the votes live in dynamic shared memory as votes[k][tid]: a column
//    private to each thread, so no atomics, and with blockDim.x a multiple of
//    32 each warp's accesses fall on 32 distinct banks.  K*blockDim.x*4 bytes;
//    the wrapper shrinks the block to stay under 48 KB and this function opts
//    in to more for a K that still does not fit (repro_torch/kernels/
//    vote_argmax.py:launch_plan);
//  * each sample sums alpha over t in ascending order, one fp32 add per member
//    that votes for the class, so the result has the same bits on every run
//    and equals a running tally built member by member
//    (repro_torch/core/scoring.py:tally_new_votes);
//  * the argmax scans k upward with a strict '>', so the lowest class index
//    wins a tie, as torch.argmax and jnp.argmax do;
//  * a prediction outside [0, K) votes for nothing (jax.nn.one_hot's and the
//    Pallas kernel's behaviour) and is never used as an index;
//  * the ragged edge of n is masked here: no padded copy of preds or alpha.
//    T = 0, or alpha all zero, gives class 0.

#include <cuda_runtime.h>

namespace {

constexpr int ALPHA_TILE = 256;

__global__ void vote_argmax_kernel(const int* __restrict__ preds,
                                   const float* __restrict__ alpha,
                                   int* __restrict__ out, int T, int n, int K) {
  extern __shared__ float votes[];  // [K][blockDim.x]
  __shared__ float a_tile[ALPHA_TILE];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int i = blockIdx.x * nt + tid;
  const bool valid = i < n;

  for (int k = 0; k < K; ++k) votes[k * nt + tid] = 0.f;

  for (int t0 = 0; t0 < T; t0 += ALPHA_TILE) {
    const int tn = min(ALPHA_TILE, T - t0);
    __syncthreads();  // the previous tile has been read by every thread
    for (int j = tid; j < tn; j += nt) a_tile[j] = alpha[t0 + j];
    __syncthreads();
    if (valid) {
      const int* p = preds + (long long)t0 * n + i;
      for (int j = 0; j < tn; ++j) {
        const int c = p[(long long)j * n];
        if ((unsigned)c < (unsigned)K) votes[c * nt + tid] += a_tile[j];
      }
    }
  }
  if (!valid) return;

  int best = 0;
  float top = votes[tid];
  for (int k = 1; k < K; ++k) {
    const float v = votes[k * nt + tid];
    if (v > top) {
      top = v;
      best = k;
    }
  }
  out[i] = best;
}

}  // namespace

// preds [T, n] i32, alpha [T] f32 -> out [n] i32.  threads a multiple of 32,
// at most 1024; n > 0.  Returns cudaGetLastError() after the launch.
extern "C" int repro_vote_argmax(const void* preds, const void* alpha, void* out,
                                 int T, int n, int K, int threads, void* stream) {
  const size_t smem = (size_t)K * threads * sizeof(float);
  if (smem > 48 * 1024) {
    // Opt in once to all the dynamic shared memory a block may have, less
    // the static alpha tile, so later launches make no attribute call.
    static int opted_in = 0;
    if (opted_in == 0) {
      int dev = 0, optin = 0;
      cudaError_t e = cudaGetDevice(&dev);
      if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      optin -= ALPHA_TILE * (int)sizeof(float);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(vote_argmax_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
      if (e != cudaSuccess) return (int)e;
      opted_in = optin;
    }
    if (smem > (size_t)opted_in) return (int)cudaErrorInvalidValue;
  }
  const int blocks = (n + threads - 1) / threads;
  vote_argmax_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const int*)preds, (const float*)alpha, (int*)out, T, n, K);
  return (int)cudaGetLastError();
}
