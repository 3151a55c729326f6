// flash_attention, float32 route: blockwise online-softmax attention with
// grouped KV heads, causal masking, a sliding window and logit soft-capping,
// its two products on Hopper's tensor cores in 3xTF32.  bfloat16 inputs take
// flash_attention_sm90.cu (TMA and wgmma).
//
//   o[b, h, i] = softmax_j(mask(cap(scale * q[b, h, i] . k[b, h / g, j]))) v[b, h / g, j]
//
// Query row i sits at absolute position i + T - S (chunked prefill against a
// longer cache); key j at position j.  A key is visible when j < T, when
// j <= i + T - S if causal, and when (i + T - S) - j < window if windowed.
//
// Replaces: src/repro/kernels/flash_attention.py:flash_attention (Pallas body
// _kernel) for float32 inputs.  There the grid is (B, H, q block, kv block)
// with the kv axis the innermost *sequential* dimension, and VMEM scratch
// carries the running (m, l, acc) from one kv step to the next.  Hopper runs
// blocks in no order, so here a CTA owns BQ = 64 query rows of one (b, h)
// and walks its key tiles in a loop, with (m, l, acc) in registers.  It
// replaces the port's first float32 kernel, which ran both products as
// float32 FMAs on the CUDA cores from 4 x 4 register tiles: two shared-memory
// loads for every four FMAs held it near a third of the 67 TFLOP/s float32
// peak (2.18 ms at whisper's encoder, 21 TFLOP/s).
//
// What bounds it on an H100: the larger of 4·(|q| + |k| + |v| + |o|) bytes
// (each read or written once) over 3.35 TB/s, and the operations of three
// TF32 products, 3 · 4·D per visible (query, key) pair (2·D for q·k, 2·D for
// p·v), over 495 TFLOP/s.  At whisper's encoder (q, k, v [4, 20, 1500, 64],
// non-causal) that is operations, 0.279 ms (0.688 on the CUDA cores); at its
// cross-attention (q [4, 20, 64, 64] against 1500 keys) bytes, 64.1 MB in
// 0.0191 ms.
//
// What the design does about it:
//  * 3xTF32 on the tensor cores (the scheme of CUTLASS's
//    OpMultiplyAddFastF32).  Each float32 operand is split into two TF32
//    numbers, hi = cvt.rna.tf32.f32(x) (written as an integer add of half a
//    TF32 ulp and a mask, which is that instruction on every finite input)
//    and lo = x - hi (exact in float32) rounded toward zero to TF32, as
//    FastF32 rounds its small part.  A product takes lo·hi, hi·lo, then
//    hi·hi into a float32 accumulator (mma.sync m16n8k8 .tf32), the small
//    terms first; lo's rounding and the dropped lo·lo are below 2^-21 of
//    the product, so the error is near a float32 FMA chain's (at whisper's
//    encoder on an H100, 6.1e-6 from the plain version, where one TF32
//    product is 2.5e-4 off), at three times 1/495 the cost of 1/67;
//  * four warps of 16 query rows each, 128 threads held to 128 registers at
//    D <= 64, so that four CTAs share an SM: the kernel waits on the
//    latency of its dependent products more than on any unit's rate: at
//    whisper's encoder 16 warps an SM took 1.08 ms where 12 took 1.17 (an
//    H100 at 700 W, scripts/flash_f32_ab.py on variants of this file).
//    S = (scale·q)·kᵀ: q is scaled as the Pallas kernel scales it and
//    staged once; its A fragments are split as they are read, since
//    holding them split (64 registers at D = 64, or hi/lo planes of 17 KB)
//    would cost a CTA an SM (1.16 ms with the planes at three CTAs).  K is
//    split as its B fragments are read: a thread's logits are the
//    accumulator fragment, rows g and g + 8 of its warp's 16, keys 2t and
//    2t + 1 of each 8;
//  * the online softmax runs in float32 on that fragment: softcap·tanh(x /
//    softcap), the mask only on tiles that cross T, the causal diagonal or
//    the window's edge (masked logits -1e30, never -inf: a row masked so far
//    keeps m = -1e30 and gets corr = exp(0) = 1 and p = 0, where -inf would
//    give NaN), row maxima across the quad by two xor-shuffles, expf; l
//    sums per thread and across the quad once at the end;
//  * O += P·V with P split in registers.  The m16n8k8 A fragment wants keys
//    t and t + 4 of each 8 where the logits fragment holds 2t and 2t + 1, so
//    the product's k index is permuted instead of the registers: the V
//    fragment is read at rows 2t and 2t + 1.  Nothing is shuffled;
//  * K/V tiles of BK keys (32; 64 at D = 32) through a 2-stage ring of
//    16-byte cp.async copies, one commit group a tile: tile j + 1 is in
//    flight while tile j is computed.  Rows are padded by 4 floats, so every
//    fragment read (q and k at (g, t), v at (2t, g)) hits 32 banks;
//  * where B·H·ceil(S / 64) CTAs would not fill the 132 SMs (whisper's
//    cross-attention: 80), a cluster of c <= 8 CTAs shares one block of
//    query rows, each walking a contiguous share of its key tiles.  The
//    cluster then merges its partial (m, l, acc) through distributed shared
//    memory: CTA r finishes rows [64r / c, 64(r + 1) / c), weighing each
//    rank's partial by exp(m_r - max m) in rank order.  One launch, no
//    scratch in device memory, no atomics: two calls give the same bits.
//    The plan (c, BQ, BK) is computed here and by
//    repro_torch/kernels/flash_attention.py:f32_plan with one rule;
//  * tiles masked for every row of the block (beyond the causal diagonal, or
//    before the window of the block's first row) are never loaded; the
//    ragged edges of S and T are zero-filled by the copies and masked, so
//    the wrapper copies nothing; grouped query heads read KV head h / (H /
//    Hkv); every tensor is addressed through its element strides (the last
//    axis contiguous), so the model's transposed [B, S, H, D] views need no
//    copy;
//  * o = acc / max(l, 1e-30).  A row that sees no key at all gives 0 here
//    (the Pallas kernel's result) and the mean of v in attention_ref; the
//    wrapper refuses the one case that makes such rows, causal with S > T.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BQ = 64;         // query rows per CTA: four warps of 16
constexpr int THREADS = 128;
constexpr int PAD = 4;         // floats after each staged row
constexpr int STAGES = 2;      // K/V ring depth
constexpr int MAX_SPLIT = 8;   // CTAs per cluster along the keys (the portable size)
constexpr int SMS = 132;       // streaming multiprocessors of an H100 SXM
constexpr float NEG = -1e30f;  // the Pallas kernel's _NEG

template <int D>
__host__ __device__ constexpr int key_tile() {  // keys per staged tile
  return D == 32 ? 64 : 32;
}

template <int D>
constexpr int ctas_per_sm() {  // what the registers are held to: 128 a thread at D <= 64
  return D <= 64 ? 4 : D == 128 ? 2 : 1;
}

template <int D>
constexpr size_t shared_bytes() {  // q [BQ][D + PAD] and STAGES x (k, v) [BK][D + PAD]
  return (size_t)(BQ + STAGES * 2 * key_tile<D>()) * (D + PAD) * sizeof(float);
}

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  long long qs[3], ks[3], vs[3], os[3];  // element strides of axes b, h, s
  int B, H, Hkv, S, T;
  int causal, window;    // window <= 0: none
  float scale, softcap;  // softcap <= 0: none
  int splits;            // CTAs per cluster along the keys
};

__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// The key tiles [*first, *last) of bk keys that any row of the query block
// starting at q0 can see.
__host__ __device__ inline void visible_tiles(const Params& p, int q0, int bk, int* first, int* last) {
  const int off = p.T - p.S;
  const int pos_lo = q0 + off;
  const int pos_hi = imin(q0 + BQ, p.S) - 1 + off;
  const int k_end = p.causal ? imin(p.T, pos_hi + 1) : p.T;
  const int k_begin = p.window > 0 ? imax(0, pos_lo - p.window + 1) : 0;
  *first = k_begin / bk;
  *last = (k_end + bk - 1) / bk;
}

// c = 1 when B·H·ceil(S / BQ) CTAs fill the SMs; else as many as 8 CTAs a
// query block, each with at least two key tiles of the longest range.
int plan_splits(const Params& p, int bk) {
  const int nqb = (p.S + BQ - 1) / BQ;
  if ((long long)p.B * p.H * nqb >= SMS) return 1;
  int most = 0;
  for (int qb = 0; qb < nqb; ++qb) {
    int first, last;
    visible_tiles(p, qb * BQ, bk, &first, &last);
    most = imax(most, last - first);
  }
  return imax(1, imin(MAX_SPLIT, most / 2));
}

// x = hi + lo in TF32: hi = cvt.rna.tf32.f32(x) (exact for every finite x),
// lo = the rest rounded toward zero, the split of CUTLASS's FastF32
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a·b in 3xTF32: a = ah + al, b = (bh0, bh1) + (bl0, bl1)
__device__ __forceinline__ void mma3(float (&c)[4], const unsigned (&ah)[4], const unsigned (&al)[4],
                                     unsigned bh0, unsigned bh1, unsigned bl0, unsigned bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int D>
__global__ void __launch_bounds__(THREADS, ctas_per_sm<D>()) flash_attention_f32_kernel(Params p) {
  constexpr int BK = key_tile<D>();
  constexpr int RS = D + PAD;   // staged row stride, floats
  constexpr int KSTEPS = D / 8;  // k steps of q·kᵀ
  constexpr int NT = BK / 8;     // 8-key column tiles of the logits
  constexpr int NC = D / 8;      // 8-column tiles of the output
  extern __shared__ float4 smem4[];
  __shared__ float part_m[BQ], part_l[BQ], den[BQ], wgt[MAX_SPLIT][BQ];  // the cluster merge's
  float* q_s = reinterpret_cast<float*>(smem4);
  float* ring = q_s + BQ * RS;  // STAGES x (k [BK][RS], v [BK][RS])

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // the fragments' row group and lane in the quad
  const int c = p.splits;
  const int rank = blockIdx.x % c;
  const int q0 = blockIdx.x / c * BQ;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int off = p.T - p.S;

  const float* q = p.q + b * p.qs[0] + h * p.qs[1];
  const float* k = p.k + b * p.ks[0] + hk * p.ks[1];
  const float* v = p.v + b * p.vs[0] + hk * p.vs[1];
  float* o = p.o + b * p.os[0] + h * p.os[1];

  int first, last;
  visible_tiles(p, q0, BK, &first, &last);
  const int t_begin = first + (last - first) * rank / c;
  const int n = first + (last - first) * (rank + 1) / c - t_begin;  // this CTA's share

  // one commit group a tile: its k and v rows, zero past T
  auto stage = [&](int tile, int slot) {
    float* ks = ring + slot * 2 * BK * RS;
    float* vs = ks + BK * RS;
    const int k0 = tile * BK;
#pragma unroll
    for (int i = tid; i < BK * D / 4; i += THREADS) {
      const int r = i / (D / 4), d = i % (D / 4) * 4;
      const bool in = k0 + r < p.T;
      const long long row = in ? k0 + r : 0;
      cp_async16(ks + r * RS + d, k + row * p.ks[2] + d, in);
      cp_async16(vs + r * RS + d, v + row * p.vs[2] + d, in);
    }
    cp_async_commit();
  };
  if (n > 0) stage(t_begin, 0);

  // q scaled once (rows past S zero) while the first tile is in flight
#pragma unroll 4
  for (int i = tid; i < BQ * D / 4; i += THREADS) {
    const int r = i / (D / 4), d = i % (D / 4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < p.S) x = __ldg(reinterpret_cast<const float4*>(q + (long long)(q0 + r) * p.qs[2] + d));
    x.x *= p.scale;
    x.y *= p.scale;
    x.z *= p.scale;
    x.w *= p.scale;
    *reinterpret_cast<float4*>(q_s + r * RS + d) = x;
  }
  __syncthreads();

  const int row0 = warp * 16 + g;  // this thread's rows of the block: row0 and row0 + 8

  float acc[NC][4];
#pragma unroll
  for (int cc = 0; cc < NC; ++cc) acc[cc][0] = acc[cc][1] = acc[cc][2] = acc[cc][3] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};  // rows row0 and row0 + 8; l is this thread's share
  const int pos0 = q0 + warp * 16 + off;      // the warp's first row's position

  for (int it = 0; it < n; ++it) {
    const int k0 = (t_begin + it) * BK;
    if (it + 1 < n) {
      stage(t_begin + it + 1, (it + 1) % STAGES);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile it has landed for every thread
    const float* ks = ring + it % STAGES * 2 * BK * RS;
    const float* vs = ks + BK * RS;

    // s = (scale·q)·kᵀ: s[j] holds rows (row0, row0 + 8) x keys (8j + 2t, 8j + 2t + 1)
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      // q's A fragment: (row0, 8kk + t), (row0 + 8, ..), (row0, 8kk + t + 4), (row0 + 8, ..)
      const float* qr = q_s + row0 * RS + kk * 8 + t;
      unsigned ah[4], al[4];
      split(qr[0], ah[0], al[0]);
      split(qr[8 * RS], ah[1], al[1]);
      split(qr[4], ah[2], al[2]);
      split(qr[8 * RS + 4], ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* kr = ks + (j * 8 + g) * RS + kk * 8 + t;  // kᵀ's B fragment: (8kk + t, 8j + g), (+4, ..)
        unsigned bh0, bl0, bh1, bl1;
        split(kr[0], bh0, bl0);
        split(kr[4], bh1, bl1);
        mma3(s[j], ah, al, bh0, bh1, bl0, bl1);
      }
    }

    // the mask, only where the tile crosses T, the causal diagonal or the window's edge
    const bool edge = k0 + BK > p.T || (p.causal && k0 + BK - 1 > pos0) ||
                      (p.window > 0 && k0 <= pos0 + 15 - p.window);
    auto visible = [&](int j, int e) {
      const int kp = k0 + j * 8 + 2 * t + (e & 1);
      const int pos = pos0 + g + (e >> 1) * 8;
      return kp < p.T && (!p.causal || kp <= pos) && (p.window <= 0 || pos - kp < p.window);
    };
    float mt[2] = {NEG, NEG};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e];
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        if (edge && !visible(j, e)) x = NEG;
        s[j][e] = x;
        mt[e >> 1] = fmaxf(mt[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float m_new = fmaxf(m[r], mt[r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = edge && !visible(j, e) ? 0.f : expf(s[j][e] - m[e >> 1]);
        s[j][e] = pe;
        l[e >> 1] += pe;
      }
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      acc[cc][0] *= corr[0];
      acc[cc][1] *= corr[0];
      acc[cc][2] *= corr[1];
      acc[cc][3] *= corr[1];
    }

    // acc += p·v, the k index of each 8 keys permuted: k = t <-> key 2t, k = t + 4 <-> key 2t + 1
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      unsigned ah[4], al[4];
      split(s[j][0], ah[0], al[0]);
      split(s[j][2], ah[1], al[1]);
      split(s[j][1], ah[2], al[2]);
      split(s[j][3], ah[3], al[3]);
      const float* vr = vs + (j * 8 + 2 * t) * RS + g;  // v's B fragment: rows 8j + 2t, 8j + 2t + 1
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        unsigned bh0, bl0, bh1, bl1;
        split(vr[cc * 8], bh0, bl0);
        split(vr[RS + cc * 8], bh1, bl1);
        mma3(acc[cc], ah, al, bh0, bh1, bl0, bl1);
      }
    }
    __syncthreads();  // every warp is done with this slot before it is staged again
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }

  if (c == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + row0 + 8 * r;
      if (row >= p.S) continue;
      const float dn = fmaxf(l[r], 1e-30f);
      float* orow = o + (long long)row * p.os[2] + 2 * t;
#pragma unroll
      for (int cc = 0; cc < NC; ++cc)
        *reinterpret_cast<float2*>(orow + cc * 8) = make_float2(acc[cc][2 * r] / dn, acc[cc][2 * r + 1] / dn);
    }
    return;
  }

  // the cluster's merge: each CTA publishes its partial (m, l, acc), the ring
  // now free, then finishes its share of the rows over every rank's partial
  float* acc_s = ring;  // [BQ][RS]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (t == 0) {
      part_m[row] = m[r];
      part_l[row] = l[r];
    }
#pragma unroll
    for (int cc = 0; cc < NC; ++cc)
      *reinterpret_cast<float2*>(acc_s + row * RS + cc * 8 + 2 * t) = make_float2(acc[cc][2 * r], acc[cc][2 * r + 1]);
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every rank's partial is published
  const int lo = BQ * rank / c, hi = BQ * (rank + 1) / c;
  for (int i = lo + tid; i < hi; i += THREADS) {
    float mr[MAX_SPLIT], mx = NEG, sum = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_SPLIT; ++r)
      if (r < c) {
        mr[r] = *cluster.map_shared_rank(part_m + i, r);
        mx = fmaxf(mx, mr[r]);
      }
#pragma unroll
    for (int r = 0; r < MAX_SPLIT; ++r)
      if (r < c) {
        const float w = expf(mr[r] - mx);
        wgt[r][i] = w;
        sum += w * *cluster.map_shared_rank(part_l + i, r);
      }
    den[i] = fmaxf(sum, 1e-30f);
  }
  __syncthreads();
  for (int e = tid; e < (hi - lo) * D; e += THREADS) {
    const int i = lo + e / D, d = e % D;
    float a = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_SPLIT; ++r)
      if (r < c) a += wgt[r][i] * *cluster.map_shared_rank(acc_s + i * RS + d, r);
    if (q0 + i < p.S) o[(long long)(q0 + i) * p.os[2] + d] = a / den[i];
  }
  cluster.sync();  // no rank's partial is read after it exits
}

template <int D>
int launch(Params p, cudaStream_t stream) {
  constexpr size_t smem = shared_bytes<D>();
  if (smem > 48 * 1024) {
    // Opt in once per device to the dynamic shared memory this instance needs.
    static unsigned opted = 0;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= 32) return (int)cudaErrorInvalidDevice;
    if (!((opted >> dev) & 1u)) {
      e = cudaFuncSetAttribute(flash_attention_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
      if (e != cudaSuccess) return (int)e;
      opted |= 1u << dev;
    }
  }
  p.splits = plan_splits(p, key_tile<D>());
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.S + BQ - 1) / BQ * p.splits, p.B * p.H);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = p.splits;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, flash_attention_f32_kernel<D>, p);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

int key_tile_of(int D) {
  switch (D) {
    case 32: return key_tile<32>();
    case 64: return key_tile<64>();
    case 128: return key_tile<128>();
    case 256: return key_tile<256>();
    default: return 0;
  }
}

Params shape_params(int B, int H, int Hkv, int S, int T, int causal, int window) {
  Params p = {};
  p.B = B;
  p.H = H;
  p.Hkv = Hkv;
  p.S = S;
  p.T = T;
  p.causal = causal;
  p.window = window;
  return p;
}

}  // namespace

// q [B, H, S, D], k and v [B, Hkv, T, D], o like q; float32 throughout.
// strides: 12 element strides, axes b, h, s of q, k, v and o in that order;
// the d axis is contiguous, and q, k and v start on 16 bytes with strides
// of multiples of 4 elements (the wrapper checks both).  D in {32, 64, 128,
// 256}; H a multiple of Hkv; S, T >= 1; B·H <= 65535.  window <= 0 means
// none, softcap <= 0 none.  Returns the launch's cudaError_t.
extern "C" int repro_flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                                         const long long* strides, int B, int H, int Hkv, int S,
                                         int T, int D, int causal, int window, float scale,
                                         float softcap, void* stream) {
  Params p = shape_params(B, H, Hkv, S, T, causal, window);
  p.q = (const float*)q;
  p.k = (const float*)k;
  p.v = (const float*)v;
  p.o = (float*)o;
  for (int a = 0; a < 3; ++a) {
    p.qs[a] = strides[a];
    p.ks[a] = strides[3 + a];
    p.vs[a] = strides[6 + a];
    p.os[a] = strides[9 + a];
  }
  p.scale = scale;
  p.softcap = softcap;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 32: return launch<32>(p, st);
    case 64: return launch<64>(p, st);
    case 128: return launch<128>(p, st);
    case 256: return launch<256>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The launch plan repro_flash_attention_f32 takes for these shapes, into
// plan[0..2]: CTAs per cluster along the keys, query rows and keys per tile.
extern "C" int repro_flash_attention_f32_plan(int B, int H, int Hkv, int S, int T, int D, int causal,
                                              int window, int* plan) {
  const int bk = key_tile_of(D);
  if (bk == 0) return (int)cudaErrorInvalidValue;
  plan[0] = plan_splits(shape_params(B, H, Hkv, S, T, causal, window), bk);
  plan[1] = BQ;
  plan[2] = bk;
  return 0;
}
