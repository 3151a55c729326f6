// flash_attention, float32 route: blockwise online-softmax attention with
// grouped KV heads, causal masking, a sliding window and logit soft-capping.
// bfloat16 inputs take flash_attention_sm90.cu (TMA and wgmma); float32 stays
// on the CUDA cores, since TF32 tensor cores keep about three decimal digits.
//
//   o[b, h, i] = softmax_j(mask(cap(scale * q[b, h, i] . k[b, h / g, j]))) v[b, h / g, j]
//
// Query row i sits at absolute position i + T - S (chunked prefill against a
// longer cache); key j at position j.  A key is visible when j < T, when
// j <= i + T - S if causal, and when (i + T - S) - j < window if windowed.
//
// Replaces: src/repro/kernels/flash_attention.py:flash_attention (Pallas body
// _kernel) for float32 inputs.  There the grid is (B, H, q block, kv
// block) with the kv axis the innermost *sequential* dimension, and VMEM
// scratch carries the running (m, l, acc) from one kv step to the next.
// Hopper runs blocks in no order, so here one block owns BQ = 64 query rows
// of one (b, h) and walks the kv tiles in a loop inside the block, with
// (m, l, acc) in registers.
//
// What bounds it on an H100: the larger of 4·B·H·S·T·D flops (2·D for q·k
// and 2·D for p·v per (query, key) pair; about half of that when causal,
// since only the visible pairs count) over 67 TFLOP/s of float32 work on
// the CUDA cores, and 4·(|q| + |k| + |v| + |o|) bytes (each read or
// written once) over 3.35 TB/s.  Every multiply-add here waits on a
// shared-memory load, so the kernel sits well above that bound.  What the
// design does about the bound: it reads q once and each K/V tile once per
// block (grouped heads share no load yet), keeps logits, probabilities and
// the running softmax out of device memory, and writes o once.
//
// Design:
//  * 256 threads: 16 row groups of 16 lanes.  Group ty owns query rows
//    4·ty .. 4·ty+3 of the block in both products, so the running max, sum and
//    the output rows never leave the group: a group lives inside one warp and
//    reduces a row with four xor-shuffles;
//  * q is scaled as the Pallas kernel scales it and staged once; k and v
//    tiles (BK = 64 keys) are staged per tile.
//    Rows are padded by one float so that lanes reading different rows hit
//    different banks.  At D = 256 that is 209 KB of shared memory: the launch
//    opts in above 48 KB;
//  * logits: lane tx of a group computes keys tx, tx+16, tx+32, tx+48 for its
//    four rows; softcap·tanh(x / softcap) in float32; masked entries are
//    -1e30, never -inf: a tile wholly masked for a row then leaves m at -1e30
//    and gives corr = exp(0) = 1 and p = 0, where -inf would give
//    exp(-inf - -inf) = NaN;
//  * p = mask ? exp(s - m_new) : 0, as the Pallas kernel computes it; p goes
//    through shared memory (read back by the same group) into acc, which lane
//    tx holds for columns tx, tx+16, ... of its four rows (4·D/16 registers);
//  * tiles that are masked for every row of the block (beyond the causal
//    diagonal, or before the window of the block's first row) are skipped:
//    they would change nothing, as shown above;
//  * the ragged edges of S and T are masked here, so the wrapper copies
//    nothing: q rows past S are zero and never written, keys past T masked;
//  * the query head h reads KV head h / (H / Hkv): grouped heads share K/V
//    without a repeated copy;
//  * inputs and output are addressed through element strides (the last axis
//    contiguous), so the model's transposed [B, S, H, D] views need no copy;
//  * o = acc / max(l, 1e-30).  A row that sees no key at all gives 0 here
//    (the Pallas kernel's result) and the mean of v in attention_ref; the
//    wrapper refuses the one case that makes such rows, causal with S > T.

#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per tile
constexpr int THREADS = 256;   // 16 row groups x 16 lanes
constexpr float NEG = -1e30f;  // the Pallas kernel's _NEG

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long qs[3], ks[3], vs[3], os[3];  // element strides of axes b, h, s
  int B, H, Hkv, S, T;
  int causal, window;  // window <= 0: none
  float scale, softcap;  // softcap <= 0: none
};

template <int D>
constexpr size_t smem_floats() {
  // q [BQ][D+1], k [BK][D+1], v [BK][D], p [BQ][BK+1]
  return (size_t)BQ * (D + 1) + (size_t)BK * (D + 1) + (size_t)BK * D + (size_t)BQ * (BK + 1);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1) flash_attention_kernel(Params p) {
  constexpr int QS = D + 1, KS = D + 1, PS = BK + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + BQ * QS;
  float* v_s = k_s + BK * KS;
  float* p_s = v_s + BK * D;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // row group
  const int tx = tid & 15;  // lane in the group
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = blockIdx.x * BQ;
  const int off = p.T - p.S;

  const float* q = (const float*)p.q + b * p.qs[0] + h * p.qs[1];
  const float* k = (const float*)p.k + b * p.ks[0] + hk * p.ks[1];
  const float* v = (const float*)p.v + b * p.vs[0] + hk * p.vs[1];
  float* o = (float*)p.o + b * p.os[0] + h * p.os[1];

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    q_s[r * QS + d] = q0 + r < p.S ? q[(long long)(q0 + r) * p.qs[2] + d] * p.scale : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // the keys any row of this block can see
  const int pos_lo = q0 + off;
  const int pos_hi = min(q0 + BQ, p.S) - 1 + off;
  const int k_end = p.causal ? min(p.T, pos_hi + 1) : p.T;
  const int k_begin = p.window > 0 ? max(0, pos_lo - p.window + 1) : 0;

  for (int k0 = k_begin / BK * BK; k0 < k_end; k0 += BK) {
    __syncthreads();  // every group is done with the previous tile
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, d = i % D;
      const bool in = k0 + r < p.T;
      k_s[r * KS + d] = in ? k[(long long)(k0 + r) * p.ks[2] + d] : 0.f;
      v_s[r * D + d] = in ? v[(long long)(k0 + r) * p.vs[2] + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty * 4 + i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx + 16 * j) * KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pos = q0 + ty * 4 + i + off;
      bool ok[4];
      float mt = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        ok[j] = kp < p.T && (!p.causal || kp <= pos) && (p.window <= 0 || pos - kp < p.window);
        float x = s[i][j];
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        s[i][j] = ok[j] ? x : NEG;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int sh = 8; sh > 0; sh >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, sh));
      const float m_new = fmaxf(m[i], mt);
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        p_s[(ty * 4 + i) * PS + tx + 16 * j] = e;
        ps += e;
      }
#pragma unroll
      for (int sh = 8; sh > 0; sh >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, sh);
      l[i] = corr * l[i] + ps;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncwarp();  // the group's p rows are written; only the group reads them

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty * 4 + i) * PS + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = v_s[kk * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= p.S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* orow = o + (long long)r * p.os[2];
#pragma unroll
    for (int c = 0; c < NC; ++c) orow[tx + 16 * c] = acc[i][c] / den;
  }
}

template <int D>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  if (smem > 48 * 1024) {
    // Opt in once per device to the dynamic shared memory this instance needs.
    static unsigned opted = 0;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= 32) return (int)cudaErrorInvalidDevice;
    if (!((opted >> dev) & 1u)) {
      e = cudaFuncSetAttribute(flash_attention_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
      opted |= 1u << dev;
    }
  }
  const dim3 grid((p.S + BQ - 1) / BQ, p.B * p.H);
  flash_attention_kernel<D><<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, H, S, D], k and v [B, Hkv, T, D], o like q; float32 throughout.
// strides: 12 element strides, axes b, h, s
// of q, k, v and o in that order; the d axis is contiguous.  D in {32, 64,
// 128, 256}; H a multiple of Hkv; S, T >= 1; B·H <= 65535.  window <= 0 means
// none, softcap <= 0 none.  Returns cudaGetLastError() after the launch.
extern "C" int repro_flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                                         const long long* strides, int B, int H, int Hkv, int S,
                                         int T, int D, int causal, int window, float scale,
                                         float softcap, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  for (int a = 0; a < 3; ++a) {
    p.qs[a] = strides[a];
    p.ks[a] = strides[3 + a];
    p.vs[a] = strides[6 + a];
    p.os[a] = strides[9 + a];
  }
  p.B = B;
  p.H = H;
  p.Hkv = Hkv;
  p.S = S;
  p.T = T;
  p.causal = causal;
  p.window = window;
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
