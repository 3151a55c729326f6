// tree_hist: weighted class histogram of one oblivious-tree level, for all
// C collaborators of a federated round in one launch.
//
//   out[h, l, f, b, k] = sum_n wy[h, n, k] * 1[leaf[h, n] == l && bin[h, n, f] == b]
//
// Replaces: src/repro/kernels/tree_hist.py:tree_hist (Pallas body _kernel),
// which turns the scatter into a one-hot matmul per feature for the TPU's
// matrix unit.  On Hopper the natural form is the one that file's docstring
// names: an atomic scatter-add into a histogram held in shared memory.
//
// What bounds it on an H100: bytes.  Each input is read once and the output
// written once: H*n*d*4 (bins) + H*n*4 (leaves) + H*n*K*4 (wy) +
// H*L*d*(B+1)*K*4 bytes (out) over 3.35 TB/s.  The arithmetic is one add per
// (sample, feature, class), far below the f32 rate.  At the main path's shapes
// (adult: [8, 4070, 14], K = 2) that is ~2.3 MB, under a microsecond of
// memory traffic, so launch latency and atomic contention dominate.
//
// Design:
//  * grid = (H, feature blocks of dblk, sample chunks).  The sample axis is
//    split so that a round's few collaborators and feature blocks still put
//    a few hundred blocks on 132 SMs; the wrapper chooses dblk and the
//    chunk count (repro_torch/kernels/tree_hist.py:launch_plan).
//  * each block zeroes a shared histogram [L][dblk][B+1][K] f32 (sized at
//    run time; above 48 KB the function opts in to more dynamic shared
//    memory, up to 227 KB), its threads stride over (sample, feature)
//    pairs with neighbouring threads on neighbouring features of one sample
//    (coalesced bin reads), and add each nonzero wy entry with a
//    shared-memory atomicAdd.
//  * the block then flushes its nonzero cells with atomicAdd into the
//    output, which the wrapper has zeroed.  wy is a weighted one-hot, so
//    skipping zeros removes K-1 of every K atomics at no cost in exactness.
//  * atomics make the order of the sum change from run to run: the kernel
//    is held to its plain version at atol 1e-4, never bit for bit.
//
// Trusted ranges: bin in [0, B] and leaf in [0, L).  The kernel does not
// check them; learners/binning.py:digitize and learners/tree.py's descend
// stage produce exactly those ranges (tests/test_torch_tree.py checks it).

#include <cuda_runtime.h>

namespace {

__global__ void tree_hist_kernel(const int* __restrict__ bin_idx,
                                 const int* __restrict__ leaf,
                                 const float* __restrict__ wy,
                                 float* __restrict__ out,
                                 int n, int d, int L, int B1, int K,
                                 int dblk, int chunk) {
  extern __shared__ float hist[];  // [L][dblk][B1][K]
  const int h = blockIdx.x;
  const int f0 = blockIdx.y * dblk;
  const int nf = min(dblk, d - f0);
  const int s0 = blockIdx.z * chunk;
  const int s1 = min(n, s0 + chunk);
  const int cells = L * dblk * B1 * K;

  for (int i = threadIdx.x; i < cells; i += blockDim.x) hist[i] = 0.f;
  __syncthreads();

  const long long row0 = (long long)h * n;
  const int pairs = (s1 - s0) * nf;  // <= 0 for a chunk past the end
  for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
    const long long row = row0 + s0 + p / nf;
    const int fl = p % nf;
    const int l = leaf[row];
    const int b = bin_idx[row * d + f0 + fl];
    const float* w = wy + row * K;
    float* cell = hist + ((l * dblk + fl) * B1 + b) * K;
    for (int k = 0; k < K; ++k) {
      const float v = w[k];
      if (v != 0.f) atomicAdd(cell + k, v);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const float v = hist[i];
    if (v == 0.f) continue;
    const int k = i % K;
    int r = i / K;
    const int b = r % B1;
    r /= B1;
    const int fl = r % dblk;
    const int l = r / dblk;
    if (fl >= nf) continue;
    atomicAdd(out + ((((long long)h * L + l) * d + f0 + fl) * B1 + b) * K + k, v);
  }
}

}  // namespace

// bin_idx [H, n, d] i32, leaf [H, n] i32, wy [H, n, K] f32, out [H, L, d, B1, K]
// f32 zeroed by the caller.  Returns cudaGetLastError() after the launch.
extern "C" int repro_tree_hist(const void* bin_idx, const void* leaf, const void* wy,
                               void* out, int H, int n, int d, int L, int B1, int K,
                               int dblk, int n_chunks, int threads, void* stream) {
  const size_t smem = (size_t)L * dblk * B1 * K * sizeof(float);
  if (smem > 48 * 1024) {
    // Opt in once, to all the shared memory a block may have, so that later
    // launches (and launches captured in a CUDA graph) make no attribute call.
    static int opted_in = 0;
    if (opted_in == 0) {
      int dev = 0, optin = 0;
      cudaError_t e = cudaGetDevice(&dev);
      if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(tree_hist_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
      if (e != cudaSuccess) return (int)e;
      opted_in = optin;
    }
    if (smem > (size_t)opted_in) return (int)cudaErrorInvalidValue;
  }
  const int chunk = (n + n_chunks - 1) / n_chunks;
  const dim3 grid(H, (d + dblk - 1) / dblk, n_chunks);
  tree_hist_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const int*)bin_idx, (const int*)leaf, (const float*)wy, (float*)out,
      n, d, L, B1, K, dblk, chunk);
  return (int)cudaGetLastError();
}

// The message for an error code returned by any entry point of the library.
extern "C" const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
