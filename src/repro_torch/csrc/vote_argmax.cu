// vote_argmax: the alpha-weighted majority vote of an ensemble's members,
// the one reduction between the members' predicts and a served response.
//
//   out[i] = argmax_k sum_t alpha[t] * 1[preds[t, i] == k]
//
// Replaces: src/repro/kernels/vote_argmax.py:vote_argmax (Pallas body
// _vote_kernel), whose grid walks the member axis in order while an
// [Nblk, K] vote tile stays resident in VMEM.  Hopper runs blocks in no
// order, so the member axis becomes a loop inside the block.
//
// What bounds it on an H100: bytes.  preds (T*n*4), alpha (T*4) read once and
// out (n*4) written once, over 3.35 TB/s; one compare and one add per (member,
// sample) is far below any compute peak.  At the serving batch (T = 10,
// n = 256) that is 11.3 KB, a few nanoseconds: what is left is latency.  A
// thread per sample walking the members (this kernel's first design) chains
// a global load and a shared read-modify-write per member on one SM; at
// T = 100 that chain was the whole time.
//
// Design (launch plan: repro_torch/kernels/vote_argmax.py:launch_plan):
//  * a block takes a strip of STRIP = 8 samples, so the serving batch of
//    256 runs on 32 SMs;
//  * the block stages its [MEMBER_TILE, STRIP] slice of preds and the
//    tile's alpha into shared memory with cp.async (16 bytes a copy where
//    every row of preds is 16-byte aligned, else 4), all of a tile's copies
//    in flight at once; past one tile the tiles are double-buffered, the
//    next tile's copies overlapping the current tile's walk;
//  * a thread owns one sample and CPT classes (CPT = 1 up to K = 128,
//    more past it, a template), each class's sum in a register: it walks
//    the staged tile in ascending t and adds alpha[t] * 1[preds[t] == k]
//    to each class, one fp32 fma a member (exact: the product is alpha,
//    +-0, or NaN for a NaN or infinite alpha, as alpha * one_hot gives).
//    No shared read-modify-write, no atomic; only the fma chain is serial;
//  * so each class's sum adds the members in ascending order, one add per
//    member, from +0: the same bits as a running tally built member by
//    member (repro_torch/core/scoring.py:tally_new_votes), which the vote
//    cache and serve_fl's check rely on;
//  * the argmax compares (value, class) pairs: NaN beats any number, a
//    larger value wins, and on equal values (or two NaNs) the lower class
//    wins.  That is torch.argmax's rule (a NaN counts as the maximum, the
//    first maximum wins), so a NaN vote, which only a NaN or infinite alpha
//    makes, gives the plain version's answer.  A total order with unique
//    classes has one maximum whatever the order of comparison: each thread
//    takes its classes, then the lanes of a warp that share a sample
//    (shuffles), then the warps through shared memory;
//  * a prediction outside [0, K) matches no class: it votes for nothing
//    (jax.nn.one_hot's and the Pallas kernel's behaviour) and is never used
//    as an index;
//  * the ragged edge of n is masked here (out-of-range copies fill zeros,
//    and only samples inside n are stored); T = 0, or alpha all zero, gives
//    class 0.  Every out[i] is written once, so the caller allocates it
//    uninitialised.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int STRIP = 8;           // samples per block (kernels/vote_argmax.py: STRIP)
constexpr int MEMBER_TILE = 128;   // members staged per tile (kernels/vote_argmax.py)
constexpr int MAX_WARPS = 32;

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// (v1, k1) ranks above (v2, k2): NaN first, then the larger value, then the lower class.
__device__ __forceinline__ bool better(float v1, int k1, float v2, int k2) {
  const bool n1 = v1 != v1, n2 = v2 != v2;
  if (n1 != n2) return n1;
  if (!n1 && v1 != v2) return v1 > v2;
  return k1 < k2;
}

struct Tiles {
  int preds[2][MEMBER_TILE * STRIP];  // [buffer][t][s]
  float alpha[2][MEMBER_TILE];
};

// Copies members [t0, t0 + tn) of the block's strip into buffer b.
__device__ __forceinline__ void stage(Tiles& tiles, int b, const int* __restrict__ preds,
                                      const float* __restrict__ alpha, int t0, int tn, int n,
                                      int s0, bool vec) {
  int* dst = tiles.preds[b];
  if (vec) {  // n % 4 == 0 and preds 16-byte aligned: a chunk of 4 samples is all in or all out
    constexpr int CHUNKS = STRIP / 4;
    for (int e = threadIdx.x; e < tn * CHUNKS; e += blockDim.x) {
      const int r = e / CHUNKS, c = 4 * (e % CHUNKS);
      const bool ok = s0 + c < n;
      cp_async16(dst + r * STRIP + c, ok ? preds + (long long)(t0 + r) * n + s0 + c : preds, ok);
    }
  } else {
    for (int e = threadIdx.x; e < tn * STRIP; e += blockDim.x) {
      const int r = e / STRIP, c = e % STRIP;
      const bool ok = s0 + c < n;
      cp_async4(dst + r * STRIP + c, ok ? preds + (long long)(t0 + r) * n + s0 + c : preds, ok);
    }
  }
  for (int e = threadIdx.x; e < tn; e += blockDim.x) cp_async4(tiles.alpha[b] + e, alpha + t0 + e, true);
  cp_async_commit();
}

template <int CPT>  // classes a thread sums, each in a register
__global__ void __launch_bounds__(1024)
vote_argmax_kernel(const int* __restrict__ preds, const float* __restrict__ alpha,
                   int* __restrict__ out, int T, int n, int K, bool vec) {
  __shared__ __align__(16) Tiles tiles;
  __shared__ float red_v[MAX_WARPS][STRIP];
  __shared__ int red_k[MAX_WARPS][STRIP];
  const int tid = threadIdx.x;
  const int s = tid % STRIP;
  const int slot = tid / STRIP;
  const int slots = blockDim.x / STRIP;
  const int s0 = blockIdx.x * STRIP;

  int cls[CPT];
  float acc[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    cls[j] = slot + j * slots;
    acc[j] = 0.f;
  }

  const int tiles_n = (T + MEMBER_TILE - 1) / MEMBER_TILE;
  if (tiles_n > 0) stage(tiles, 0, preds, alpha, 0, min(MEMBER_TILE, T), n, s0, vec);
  for (int i = 0; i < tiles_n; ++i) {
    const int b = i & 1;
    const int tn = min(MEMBER_TILE, T - i * MEMBER_TILE);
    if (i + 1 < tiles_n) {
      const int t1 = (i + 1) * MEMBER_TILE;
      stage(tiles, b ^ 1, preds, alpha, t1, min(MEMBER_TILE, T - t1), n, s0, vec);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile i is in shared memory for every thread
    const int* col = tiles.preds[b] + s;
    const float* al = tiles.alpha[b];
    int t = 0;
    for (; t + 4 <= tn; t += 4) {
      const float4 a4 = *reinterpret_cast<const float4*>(al + t);
      const int p0 = col[t * STRIP], p1 = col[(t + 1) * STRIP];
      const int p2 = col[(t + 2) * STRIP], p3 = col[(t + 3) * STRIP];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        float a = acc[j];
        a = fmaf(a4.x, p0 == cls[j] ? 1.f : 0.f, a);
        a = fmaf(a4.y, p1 == cls[j] ? 1.f : 0.f, a);
        a = fmaf(a4.z, p2 == cls[j] ? 1.f : 0.f, a);
        a = fmaf(a4.w, p3 == cls[j] ? 1.f : 0.f, a);
        acc[j] = a;
      }
    }
    for (; t < tn; ++t) {
      const float a = al[t];
      const int p = col[t * STRIP];
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[j] = fmaf(a, p == cls[j] ? 1.f : 0.f, acc[j]);
    }
    __syncthreads();  // buffer b is refilled by tile i + 2's copies
  }

  float bv = __int_as_float(0xff800000);  // -inf, with class INT_MAX: ranks below every
  int bk = INT_MAX;                        // class (a thread may own none)
#pragma unroll
  for (int j = 0; j < CPT; ++j)
    if (cls[j] < K && better(acc[j], cls[j], bv, bk)) {
      bv = acc[j];
      bk = cls[j];
    }
  for (int off = STRIP; off < 32; off <<= 1) {  // the warp's lanes of one sample
    const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
    const int ok = __shfl_xor_sync(0xffffffffu, bk, off);
    if (better(ov, ok, bv, bk)) {
      bv = ov;
      bk = ok;
    }
  }
  const int lane = tid & 31, warp = tid >> 5;
  if (lane < STRIP) {
    red_v[warp][lane] = bv;
    red_k[warp][lane] = bk;
  }
  __syncthreads();
  if (tid < STRIP && s0 + tid < n) {
    for (int q = 1; q < (int)(blockDim.x >> 5); ++q)
      if (better(red_v[q][tid], red_k[q][tid], bv, bk)) {
        bv = red_v[q][tid];
        bk = red_k[q][tid];
      }
    out[s0 + tid] = bk;
  }
}

}  // namespace

// preds [T, n] i32, alpha [T] f32 -> out [n] i32, every element written.
// cpt in {1, 2, 4, 8, 16}; threads a multiple of 32, at most 1024, with
// threads / 8 * cpt >= K; n > 0.  Returns cudaGetLastError() after the launch.
extern "C" int repro_vote_argmax(const void* preds, const void* alpha, void* out, int T, int n,
                                 int K, int cpt, int threads, void* stream) {
  if (threads % 32 != 0 || threads < 32 || threads > 1024 || (threads / STRIP) * cpt < K)
    return (int)cudaErrorInvalidValue;
  const bool vec = n % 4 == 0 && ((uintptr_t)preds & 15) == 0;
  const int blocks = (n + STRIP - 1) / STRIP;
  const int* p = (const int*)preds;
  const float* a = (const float*)alpha;
  int* o = (int*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (cpt) {
    case 1: vote_argmax_kernel<1><<<blocks, threads, 0, st>>>(p, a, o, T, n, K, vec); break;
    case 2: vote_argmax_kernel<2><<<blocks, threads, 0, st>>>(p, a, o, T, n, K, vec); break;
    case 4: vote_argmax_kernel<4><<<blocks, threads, 0, st>>>(p, a, o, T, n, K, vec); break;
    case 8: vote_argmax_kernel<8><<<blocks, threads, 0, st>>>(p, a, o, T, n, K, vec); break;
    case 16: vote_argmax_kernel<16><<<blocks, threads, 0, st>>>(p, a, o, T, n, K, vec); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
