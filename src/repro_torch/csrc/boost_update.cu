// The AdaBoost.F inner loop (paper steps 3-4): the weighted error of every
// hypothesis on every shard, and the sample-weight update with its global
// renormalisation, in one launch each; and the update's product alone, which
// the interpreted round renormalises from a total taken on the host.
//
// weighted_errors:  eps[c, h] = sum_n w[c, n] * 1[preds[c, h, n] != y[c, n]]
//   Replaces: src/repro/kernels/boost_update.py:weighted_errors (Pallas body
//   _err_kernel), called there once per collaborator under vmap
//   (src/repro/core/scoring.py:error_matrix).  Here one launch covers the
//   whole [C, H, n] prediction tensor.
//   Bound on an H100: bytes.  C*H*n*4 (preds) + 2*C*n*4 (y, w) read once,
//   C*H*4 written, over 3.35 TB/s; one compare and one add per element is far
//   below any compute peak.  AdaBoost.F scores H = C rows a round (adult:
//   [8, 8, 4070], ~1.3 MB, well under a microsecond: a chain of latencies -
//   launch, one round of loads, the reduction).  PreWeak.F scores its whole
//   space, H = C*T rows (adult at T = 100: [8, 800, 4070], 104 MB, 31 us: the
//   bytes).
//   Design (launch plan: repro_torch/kernels/boost_update.py:errors_plan): a
//   warp per (row, sample slice).  A row's n samples split into cs balanced,
//   contiguous slices, one per CTA of a thread-block cluster; a CTA takes a
//   chunk of hc rows, a warp each, so the grid (cs, ceil(H / hc), C) splits
//   the rows as well as the samples.  A warp walks its slice with
//   coalesced 4-byte loads, 8 loads a lane in flight before the first add;
//   preds are read once (L1::no_allocate, so they do not evict y and w,
//   which every warp of the CTA reads again).  A row is only 4-byte aligned
//   when n is odd, so 16-byte loads would need a head and a tail per row and
//   per-lane gathers of y and w; the 4-byte loads issue 3 L1 wavefronts per
//   128 bytes of preds, ~3x what HBM feeds an SM.  A shuffle tree gives one
//   float per (row, slice), kept in shared memory: nothing there grows with
//   H, so H has no cap.  After one cluster barrier a thread of rank 0 adds a
//   row's cs slice sums in rank order through distributed shared memory and
//   stores it with a plain store, so the caller allocates `out`
//   uninitialised; a second barrier keeps every CTA's sums alive until they
//   are read.  The order of every sum depends only on (n, cs): two calls on
//   the same inputs give the same bits.  It is held to the plain row sum
//   (repro_torch/kernels/ref.py: weighted_errors_ref) at rtol 1e-4, not to
//   the Pallas matvec.
//
// weight_update, renormalised:
//   out[i] = p[i] / max(sum_j p[j], 1e-30),  p[i] = w[i] * expf(alpha * mis[i]) * mask[i]
//   Replaces: src/repro/kernels/boost_update.py:weight_update (Pallas body
//   _upd_kernel, the product p) together with the global renormalisation the
//   JAX package applies after it on the main path
//   (src/repro/core/scoring.py:update_weights, renormalize=True): one launch
//   where the round issued the kernel, a sum, a clamp and a division.
//   Bound on an H100: bytes.  3*N*4 read + 4 (alpha) + N*4 written over
//   3.35 TB/s (adult: N = 32560, 0.5 MB, 0.16 us): what is left is latency,
//   and the whole-vector sum is a reduction across blocks.
//   Design (launch plan: repro_torch/kernels/boost_update.py:update_plan):
//   one thread-block cluster of cs = 16 CTAs covers the vector, launched
//   with cudaLaunchKernelEx (16 is the non-portable size: at 260 480
//   elements 1.5x faster than 8 on an H100, the same at the main path's N).
//   Thread g of the cs * blockDim threads takes elements g, g + G, g + 2G,
//   ... (G = cs * blockDim: neighbouring threads on neighbouring elements);
//   it issues the loads of its first UPDATE_REGS elements before any
//   arithmetic and keeps their products in registers, which holds every
//   main-path N (forestcover, 50 000: 4 a thread at 16 x 1024 threads).
//   Past that a thread writes its products to out and reads them back
//   itself.  The sum runs in a fixed order: each thread over its elements
//   in index order, a warp shuffle, the warps' sums by a shuffle in warp 0,
//   then every CTA adds the cluster's CTA totals in rank order through
//   distributed shared memory, so every CTA holds the same total and two
//   calls give the same bits.  No global atomic, no memset, no second
//   launch.  alpha is read from device memory through a pointer, so the
//   round never copies it to the host; expf (not __expf) and a true
//   division keep it within rtol 1e-5 of the plain version (torch.sum adds
//   in another order).  An all-zero product gives zeros through the 1e-30
//   clamp, not NaN.
//
// weight_update, the product alone:
//   out[i] = w[i] * expf(alpha * mis[i]) * mask[i]
//   Replaces: src/repro/kernels/boost_update.py:weight_update (Pallas body
//   _upd_kernel) where the JAX package calls it with renormalize=False: the
//   interpreted round updates each collaborator's weights apart and divides
//   them by a total exchanged on the host (src/repro/fl/federation.py:650-663).
//   Bound on an H100: bytes.  3*N*4 read + 4 (alpha) + N*4 written over
//   3.35 TB/s (adult's shard: N = 4070, 65 KB, 0.02 us): latency again.
//   Design (launch plan: repro_torch/kernels/boost_update.py:product_plan): a
//   grid-stride elementwise pass, a thread an element, no reduction, no
//   cluster.  alpha is read from device memory; expf (not __expf) keeps it
//   within rtol 1e-6 of the plain version.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int ERR_UNROLL = 8;  // loads a lane keeps in flight

__device__ __forceinline__ int load_once(const int* p) {  // read once: not kept in L1
  int v;
  asm volatile("ld.global.nc.L1::no_allocate.b32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__global__ void __launch_bounds__(1024)
weighted_errors_kernel(const int* __restrict__ preds, const int* __restrict__ y,
                       const float* __restrict__ w, float* __restrict__ out, int H, int n) {
  extern __shared__ float part[];  // [hc] this CTA's slice sum of each row of the chunk
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int hc = blockDim.x >> 5;
  const int c = blockIdx.z;
  const int h0 = blockIdx.y * hc;
  const int rows = min(hc, H - h0);
  const int lane = threadIdx.x & 31;
  const int j = threadIdx.x >> 5;  // the warp's row of the chunk
  const int a0 = (int)((long long)rank * n / cs);
  const int a1 = (int)((long long)(rank + 1) * n / cs);
  const int* yc = y + (long long)c * n;
  const float* wc = w + (long long)c * n;

  if (j < rows) {
    const int* row = preds + ((long long)c * H + h0 + j) * n;
    float acc = 0.f;
    for (int s0 = a0; s0 < a1; s0 += 32 * ERR_UNROLL) {
      int p[ERR_UNROLL], ys[ERR_UNROLL];
      float ws[ERR_UNROLL];
#pragma unroll
      for (int u = 0; u < ERR_UNROLL; ++u) {  // every load in flight before the first add
        const int s = s0 + u * 32 + lane;
        const bool in = s < a1;
        p[u] = in ? load_once(row + s) : 0;
        ys[u] = in ? __ldg(yc + s) : 0;
        ws[u] = in ? __ldg(wc + s) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < ERR_UNROLL; ++u) acc += p[u] != ys[u] ? ws[u] : 0.f;
    }
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) part[j] = acc;
  }
  cluster.sync();  // every slice sum of the chunk is published
  if (rank == 0 && threadIdx.x < rows) {
    float v[8];  // every rank's load in flight before the first add
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (q < cs) v[q] = cluster.map_shared_rank(part, q)[threadIdx.x];
    float t = v[0];
#pragma unroll
    for (int q = 1; q < 8; ++q)
      if (q < cs) t += v[q];
    out[(long long)c * H + h0 + threadIdx.x] = t;
  }
  cluster.sync();  // no CTA's slice sums are read after it exits
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

constexpr int UPDATE_REGS = 8;  // products a thread keeps in registers (kernels/boost_update.py)

__global__ void __launch_bounds__(1024)
weight_update_kernel(const float* __restrict__ w, const float* __restrict__ mis,
                     const float* __restrict__ mask, const float* __restrict__ alpha,
                     float* __restrict__ out, long long N) {
  __shared__ float warp_sum[32];
  __shared__ float cta_total;
  __shared__ float scale;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const long long G = (long long)cs * blockDim.x;
  const long long g = (long long)rank * blockDim.x + threadIdx.x;
  const float a = *alpha;

  float wv[UPDATE_REGS], mv[UPDATE_REGS], kv[UPDATE_REGS];
#pragma unroll
  for (int j = 0; j < UPDATE_REGS; ++j) {  // every load in flight before the first product
    const long long i = g + j * G;
    const bool in = i < N;
    wv[j] = in ? w[i] : 0.f;
    mv[j] = in ? mis[i] : 0.f;
    kv[j] = in ? mask[i] : 0.f;
  }
  float p[UPDATE_REGS];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < UPDATE_REGS; ++j) {
    p[j] = wv[j] * expf(a * mv[j]) * kv[j];
    sum += p[j];
  }
#pragma unroll 4
  for (long long i = g + UPDATE_REGS * G; i < N; i += G) {  // past the registers: through out
    const float q = w[i] * expf(a * mis[i]) * mask[i];
    out[i] = q;
    sum += q;
  }

  for (int off = 16; off > 0; off >>= 1) sum += __shfl_down_sync(0xffffffffu, sum, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sum[warp] = sum;
  __syncthreads();
  if (warp == 0) {  // the warps' sums, by the same shuffle tree
    float t = lane < (int)(blockDim.x >> 5) ? warp_sum[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1) t += __shfl_down_sync(0xffffffffu, t, off);
    if (lane == 0) cta_total = t;
  }
  cluster.sync();  // every CTA's total is published
  if (warp == 0) {
    const float v = lane < cs ? *cluster.map_shared_rank(&cta_total, lane) : 0.f;
    float t = __shfl_sync(0xffffffffu, v, 0);
    for (int q = 1; q < cs; ++q) t += __shfl_sync(0xffffffffu, v, q);  // rank order
    if (lane == 0) scale = fmaxf(t, 1e-30f);
  }
  cluster_arrive();  // this CTA has read every total it needs
  __syncthreads();
  const float s = scale;
#pragma unroll
  for (int j = 0; j < UPDATE_REGS; ++j) {
    const long long i = g + j * G;
    if (i < N) out[i] = p[j] / s;
  }
#pragma unroll 4
  for (long long i = g + UPDATE_REGS * G; i < N; i += G) out[i] = out[i] / s;
  cluster_wait();  // no CTA's total is read after it exits
}

__global__ void __launch_bounds__(1024)
weight_product_kernel(const float* __restrict__ w, const float* __restrict__ mis,
                      const float* __restrict__ mask, const float* __restrict__ alpha,
                      float* __restrict__ out, long long N) {
  const float a = *alpha;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < N; i += stride)
    out[i] = w[i] * expf(a * mis[i]) * mask[i];
}

}  // namespace

// preds [C, H, n] i32, y [C, n] i32, w [C, n] f32 -> out [C, H] f32, every
// element written.  Clusters of cs CTAs (1, 2, 4 or 8) over each row's
// samples, hc rows (a warp each, 1 to 32) per CTA.  Returns the launch's
// cudaError_t; a refused cluster launch is returned, never retried.
extern "C" int repro_weighted_errors(const void* preds, const void* y, const void* w,
                                     void* out, int C, int H, int n, int cs, int hc,
                                     void* stream) {
  if (cs < 1 || cs > 8 || (cs & (cs - 1)) != 0 || hc < 1 || hc > 32 || C < 1 || C > 65535 ||
      H < 1 || n < 0 || (H + hc - 1) / hc > 65535)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, (H + hc - 1) / hc, C);
  cfg.blockDim = dim3(32 * hc);
  cfg.dynamicSmemBytes = hc * sizeof(float);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, weighted_errors_kernel, (const int*)preds,
                                           (const int*)y, (const float*)w, (float*)out, H, n);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// w, mis, mask, out [N] f32; alpha [1] f32 on the device; N > 0.  One
// cluster of cs CTAs (1, 2, 4 or 8; 16 with the non-portable size, allowed
// once per process before the first such launch) of `threads` threads (a
// multiple of 32, at most 1024).  out is written once per element (twice
// past the registers).  Returns the launch's cudaError_t.
extern "C" int repro_weight_update(const void* w, const void* mis, const void* mask,
                                   const void* alpha, void* out, long long N, int cs,
                                   int threads, void* stream) {
  if (cs < 1 || cs > 16 || (cs & (cs - 1)) != 0 || threads % 32 != 0 || threads < 32 ||
      threads > 1024 || N < 1)
    return (int)cudaErrorInvalidValue;
  if (cs > 8) {
    static bool allowed = false;
    if (!allowed) {
      const cudaError_t e = cudaFuncSetAttribute(
          weight_update_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (e != cudaSuccess) return (int)e;
      allowed = true;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, weight_update_kernel, (const float*)w,
                                           (const float*)mis, (const float*)mask,
                                           (const float*)alpha, (float*)out, N);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// w, mis, mask, out [N] f32; alpha [1] f32 on the device; N > 0.  `blocks`
// CTAs of `threads` threads (a multiple of 32, at most 1024) stride over the
// vector; out is written once per element.  Returns the launch's cudaError_t.
extern "C" int repro_weight_update_product(const void* w, const void* mis, const void* mask,
                                           const void* alpha, void* out, long long N,
                                           int blocks, int threads, void* stream) {
  if (blocks < 1 || threads % 32 != 0 || threads < 32 || threads > 1024 || N < 1)
    return (int)cudaErrorInvalidValue;
  weight_product_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)w, (const float*)mis, (const float*)mask, (const float*)alpha, (float*)out,
      N);
  return (int)cudaGetLastError();
}
