// tree_hist: weighted class histogram of one oblivious-tree level, for all
// C collaborators of a federated round in one launch.
//
//   out[h, l, f, b, k] = sum_n wy[h, n, k] * 1[leaf[h, n] == l && bin[h, n, f] == b]
//
// Replaces: src/repro/kernels/tree_hist.py:tree_hist (Pallas body _kernel),
// which turns the scatter into a one-hot matmul per feature for the TPU's
// matrix unit, because the TPU has no atomics.  On Hopper the scatter is a
// shared-memory atomic add.  Tensor cores do not pay here: K = 2 on the
// main path, below wgmma's smallest N of 8, and building the one-hot
// operand costs as many instructions as the scatter itself.
//
// What bounds it on an H100: bytes.  Each input is read once and the output
// written once: H*n*d*4 (bins) + H*n*4 (leaves) + H*n*K*4 (wy) +
// H*L*d*(B+1)*K*4 bytes (out) over 3.35 TB/s.  The arithmetic is one add per
// nonzero (sample, class) and feature, far below the f32 rate.  At the main
// path's shapes (adult: [8, 4070, 14], K = 2) that is ~2.3 MB, under a
// microsecond of memory traffic, so the kernel is a chain of latencies:
// launch, the loads of a thread's samples, the atomics, the reduction.
//
// Design (launch plan: repro_torch/kernels/tree_hist.py:launch_plan):
//  * grid = (H, feature blocks of dblk, cs), launched as thread-block
//    clusters of (1, 1, cs), cs <= 8.  The cs CTAs of a cluster split the
//    samples of one (collaborator, feature block) into cs balanced,
//    contiguous ranges; a CTA whose range is empty (n < cs) still takes
//    part in both cluster barriers and the reduction.
//  * each CTA zeroes a histogram [L][dblk][B+1][K] in its own dynamic
//    shared memory (padded to whole int4s; above 48 KB the entry point
//    opts in, up to 227 KB), and adds to it with shared-memory atomics.
//    A float atomicAdd on shared memory is a compare-and-swap loop on this
//    card (ATOMS.CAST.SPIN in the SASS), which serialises under the
//    contention of a histogram with a few dozen cells a feature; a 32-bit
//    integer atomicAdd is one instruction (ATOMS.ADD).  So the histogram
//    is int32 fixed point with a scale 2^-S per CTA: one coalesced pass
//    over the CTA's wy rows finds their largest |wy| = m, and S makes the
//    CTA's whole mass m * count < 2^30, so no cell can overflow.  Each
//    value is rounded once to a multiple of 2^-S, an absolute error of at
//    most 2^-31 of the bound m * count (a float32 sum near that bound
//    rounds by 2^-24 of it at every add); the integer sums are exact, and
//    each cell is rounded to float once.
//  * a thread takes one sample at a time: its leaf and dblk (<= 8) bins go
//    into registers, its wy row is read two classes at a time, and each
//    nonzero wy entry is added to the dblk cells (skipping zeros removes
//    K-1 of every K atomics of a one-hot wy).
//  * cluster.sync(); then CTA r owns every cs-th run of blockDim cells of
//    four, starting at run r.  For each, it loads the cs CTAs' values
//    through distributed shared memory (cluster.map_shared_rank), all in
//    flight at once, sums them in rank order 0..cs-1 and stores the result
//    to `out` with a plain store.  Every output cell belongs to exactly one
//    (h, feature block) cluster and one owner, so it is written exactly
//    once: the caller allocates `out` uninitialised, and there is no global
//    atomic and no memset.  Cells of features past d in the last feature
//    block are not stored.  A second cluster.sync() keeps every CTA's
//    shared memory alive until its cluster has read it.
//  * integer sums do not depend on the order of the atomics, and the
//    cross-CTA order is fixed: two launches on the same inputs give the
//    same bits.  The kernel is held to its plain version (a float32
//    index_add_) at atol 1e-4.
//
// Trusted ranges: bin in [0, B], leaf in [0, L) and finite wy (the scale
// comes from max |wy|).  The kernel does not check them;
// learners/binning.py:digitize and learners/tree.py's descend stage produce
// exactly those ranges (tests/test_torch_tree.py checks it), and wy is the
// normalised sample weights times a one-hot label.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxFeatures = 8;  // bins of one sample held in registers
constexpr int kMaxThreads = 1024;

__global__ void __launch_bounds__(kMaxThreads)
tree_hist_kernel(const int* __restrict__ bin_idx, const int* __restrict__ leaf,
                 const float* __restrict__ wy, float* __restrict__ out,
                 int n, int d, int L, int B1, int K, int dblk) {
  extern __shared__ int4 hist4[];  // [L][dblk][B1][K] int32 fixed point, padded to int4s,
                                   // then one float per warp
  int* hist = reinterpret_cast<int*>(hist4);
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int h = blockIdx.x;
  const int f0 = blockIdx.y * dblk;
  const int nf = min(dblk, d - f0);
  const int s0 = (int)((long long)rank * n / cs);
  const int s1 = (int)((long long)(rank + 1) * n / cs);
  const int B1K = B1 * K;
  const int cells = L * dblk * B1K;
  const int cells4 = (cells + 3) / 4;
  float* warp_max = reinterpret_cast<float*>(hist4 + cells4);

  for (int i = threadIdx.x; i < cells4; i += blockDim.x) hist4[i] = make_int4(0, 0, 0, 0);

  // The scale: this CTA's largest |wy|, from one coalesced pass over its
  // rows, so that no cell of its histogram can reach 2^30 once scaled.
  float m = 0.f;
  const float* slab = wy + ((long long)h * n + s0) * K;
  for (int i = threadIdx.x; i < (s1 - s0) * K; i += blockDim.x) m = fmaxf(m, fabsf(slab[i]));
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();  // also orders the zeroing before the atomics
  m = 0.f;
  for (int q = 0; q < (int)(blockDim.x >> 5); ++q) m = fmaxf(m, warp_max[q]);
  int e;
  frexpf(m * (float)max(s1 - s0, 1), &e);  // the CTA's mass m * count < 2^e
  const int scale = 30 - e;

  for (int s = s0 + threadIdx.x; s < s1; s += blockDim.x) {
    const long long row = (long long)h * n + s;
    const int l = leaf[row];
    const int* brow = bin_idx + row * d + f0;
    int b[kMaxFeatures];
#pragma unroll
    for (int f = 0; f < kMaxFeatures; ++f) b[f] = f < nf ? brow[f] : 0;
    const float* w = wy + row * K;
    int* base = hist + l * dblk * B1K;
    for (int k0 = 0; k0 < K; k0 += 2) {
      const float v[2] = {w[k0], k0 + 1 < K ? w[k0 + 1] : 0.f};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (v[j] == 0.f) continue;
        const int q = __float2int_rn(scalbnf(v[j], scale));
#pragma unroll
        for (int f = 0; f < kMaxFeatures; ++f)
          if (f < nf) atomicAdd(base + f * B1K + b[f] * K + k0 + j, q);
      }
    }
  }
  __syncthreads();

  // Each cell to float, in place: this CTA's exact fixed-point sum, rounded once.
  for (int i = threadIdx.x; i < cells4; i += blockDim.x) {
    const int4 t = hist4[i];
    reinterpret_cast<float4*>(hist4)[i] =
        make_float4(scalbnf((float)t.x, -scale), scalbnf((float)t.y, -scale),
                    scalbnf((float)t.z, -scale), scalbnf((float)t.w, -scale));
  }
  cluster.sync();

  const float4* part4 = reinterpret_cast<const float4*>(hist4);
  const long long out0 = (long long)h * L * d;  // (h, l = 0, f = 0) row of out
  for (int i4 = rank * blockDim.x + threadIdx.x; i4 < cells4; i4 += cs * blockDim.x) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q0 = 0; q0 < cs; q0 += 4) {
      float4 v[4];  // four ranks' loads in flight before their adds
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (q0 + j < cs) v[j] = cluster.map_shared_rank(part4, q0 + j)[i4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (q0 + j < cs) {
          acc.x += v[j].x; acc.y += v[j].y; acc.z += v[j].z; acc.w += v[j].w;
        }
      }
    }
    const float a[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = 4 * i4 + j;
      if (i >= cells) break;
      const int r = i / B1K;  // l * dblk + fl
      const int fl = r % dblk;
      if (fl >= nf) continue;
      const int l = r / dblk;
      out[(out0 + (long long)l * d + f0 + fl) * B1K + (i - r * B1K)] = a[j];
    }
  }
  cluster.sync();
}

// Dynamic shared memory of one CTA (the histogram and a float per warp);
// opts the kernel in, once, to all the shared memory a block may have, so
// that later launches (and launches captured in a CUDA graph) make no
// attribute call.
cudaError_t shared_bytes(int L, int B1, int K, int dblk, size_t* smem) {
  *smem = (((size_t)L * dblk * B1 * K + 3) / 4) * sizeof(int4) + kMaxThreads / 32 * sizeof(float);
  if (*smem <= 48 * 1024) return cudaSuccess;
  static int opted_in = 0;
  if (opted_in == 0) {
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(tree_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (e != cudaSuccess) return e;
    opted_in = optin;
  }
  return *smem <= (size_t)opted_in ? cudaSuccess : cudaErrorInvalidValue;
}

cudaLaunchConfig_t cluster_config(dim3 grid, int threads, size_t smem, int cs, void* stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = cs;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// bin_idx [H, n, d] i32, leaf [H, n] i32, wy [H, n, K] f32 -> out [H, L, d, B1, K]
// f32, every cell written (the caller need not initialise it).  dblk <= 8,
// cs in {1, 2, 4, 8}, threads a multiple of 32 up to 1024.  Returns the
// launch's cudaError_t; a refused cluster launch is returned, never retried.
extern "C" int repro_tree_hist(const void* bin_idx, const void* leaf, const void* wy,
                               void* out, int H, int n, int d, int L, int B1, int K,
                               int dblk, int cs, int threads, void* stream) {
  if (dblk < 1 || dblk > kMaxFeatures || cs < 1 || cs > 8) return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  cudaError_t e = shared_bytes(L, B1, K, dblk, &smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(dim3(H, (d + dblk - 1) / dblk, cs), threads, smem, cs, stream, &attr);
  e = cudaLaunchKernelEx(&cfg, tree_hist_kernel, (const int*)bin_idx, (const int*)leaf,
                         (const float*)wy, (float*)out, n, d, L, B1, K, dblk);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// The most clusters of cs CTAs (threads each, the shared histogram of
// (L, B1, K, dblk)) the card can hold at once, from
// cudaOccupancyMaxActiveClusters, into *clusters.  A launch plan fills at
// most one wave when its grid has no more clusters than this.
extern "C" int repro_tree_hist_max_clusters(int L, int B1, int K, int dblk, int cs, int threads,
                                            int* clusters) {
  size_t smem = 0;
  cudaError_t e = shared_bytes(L, B1, K, dblk, &smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(dim3(1, 1, cs), threads, smem, cs, nullptr, &attr);
  return (int)cudaOccupancyMaxActiveClusters(clusters, tree_hist_kernel, &cfg);
}

// The message for an error code returned by any entry point of the library.
extern "C" const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
