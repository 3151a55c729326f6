// flash_attention, bfloat16 route: the same attention as flash_attention.cu
// (grouped KV heads, causal masking, a sliding window, logit soft-capping),
// rebuilt for Hopper's tensor cores.
//
//   o[b, h, i] = softmax_j(mask(cap(scale * q[b, h, i] . k[b, h / g, j]))) v[b, h / g, j]
//
// Query row i sits at absolute position i + T - S; key j at position j.  A
// key is visible when j < T, when j <= i + T - S if causal, and when
// (i + T - S) - j < window if windowed.
//
// Replaces: src/repro/kernels/flash_attention.py:flash_attention (Pallas body
// _kernel) for bfloat16 inputs; float32 inputs take flash_attention.cu.
//
// What bounds it on an H100: 4·D flops per visible (query, key) pair (2·D
// for q·k, 2·D for p·v) over 989 TFLOP/s of bf16 tensor-core work, against
// 2·(|q| + |k| + |v| + |o|) bytes over 3.35 TB/s.  At gemma-2b's serving
// prefill (q [4, 8, 64, 256], k and v [4, 1, 64, 256]) that is bytes,
// 0.0007 ms; at a 2048-token prompt (q [1, 8, 2048, 256]) operations,
// 0.017 ms.  Both products therefore run as wgmma on bf16 tiles with
// float32 accumulators, fed by TMA, and the softmax stays in registers.
//
// Design:
//  * one block per 64·nwg query rows of one (b, h): nwg = 2 consumer
//    warpgroups of 64 rows each (nwg = 1 when S <= 64, so that a short
//    prompt keeps all its (b, h) pairs on separate SMs).  A thread keeps
//    o's D / 2 floats beside s and p (217 registers at D = 256), so the
//    block has no producer warpgroup: this ptxas allocates a 384-thread
//    block no more than 168 registers, setmaxnreg or not.  The grid runs
//    (b, h) fastest and the query tiles in reverse order, so the tiles
//    that see the most keys under the causal mask start first;
//  * the block's first thread loads q once and K/V tiles of 64 keys into a
//    2-stage ring with cp.async.bulk.tensor (TMA), each stage guarded by a
//    "full" mbarrier (transaction bytes) and an "empty" one (one arrival
//    per consumer warp), so tile j + 1 arrives while tile j is computed.
//    It waits for a stage's release only when the tile it must compute
//    next is not yet loaded;
//  * the tensor maps are rank 4 over (d, s, h, b) and are encoded per call
//    from the element strides, so the model's transposed [B, S, H, D] views
//    need no copy.  TMA boxes are 64 bf16 values (one 128-byte row) by 64
//    rows with the 128-byte swizzle, so a row of D = 256 takes four boxes
//    and D = 32 is padded to 64 columns by the hardware's zero fill.  Rows
//    past S or T are zero-filled too, so ragged edges need no padding:
//    the mask drops those keys and those query rows are never stored;
//  * S = q·kᵀ: wgmma m64n64k16, both operands K-major from shared memory,
//    D / 16 steps.  The scale is applied to the float32 accumulator, as the
//    Pallas kernel applies it to q in float32; softcap·tanh(x / softcap) in
//    float32.  The mask is evaluated only on tiles that cross the causal
//    diagonal, the window's edge or T; masked logits are -1e30, never
//    -inf, so a tile wholly masked for a row gives corr = 1 and p = 0 where
//    -inf would give NaN;
//  * online softmax in registers on the accumulator layout: a row lives in
//    the 4 lanes of a quad, so its max needs two xor-shuffles; exp2 with
//    log2(e) folded into the scale;
//  * O += P·V: p is rounded to bf16 in registers and is wgmma's A operand
//    directly (the m64n64 accumulator fragment is the A fragment of four
//    k16 steps); V is the B operand from shared memory, MN-major (the
//    transpose bit).  l sums the rounded p, so o stays a convex combination
//    of rows of v;
//  * o = acc / max(l, 1e-30), cast to bf16 and stored through the output's
//    strides; a row that sees no key gives 0, as the Pallas kernel does.
//  * tiles a warpgroup's rows cannot see (beyond the causal diagonal or
//    before the window) are skipped by that warpgroup, which still releases
//    the stage; tiles no row of the block can see are never loaded.
//
// The caller guarantees what TMA needs: 16-byte aligned base addresses and
// strides (of axes with more than one element) that are multiples of 16
// bytes.  The wrapper checks it and raises; the entry point returns
// cudaErrorInvalidValue if a tensor map cannot be encoded.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;          // query rows per consumer warpgroup
constexpr int BN = 64;          // keys per K/V tile
constexpr int STAGES = 2;       // K/V ring depth
constexpr int CHUNK = 64;       // bf16 values per 128-byte swizzled row
constexpr int SUB = 64 * 128;   // bytes of one [64 rows][128 B] swizzled sub-tile
constexpr int MAX_WG = 2;       // consumer warpgroups per block, at most
constexpr float NEG = -1e30f;   // the Pallas kernel's _NEG
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  void* o;
  long long os[3];  // element strides of o's axes b, h, s
  int B, H, Hkv, S, T;
  int causal, window;    // window <= 0: none
  float scale, softcap;  // softcap <= 0: none
  int nwg;               // consumer warpgroups: 1 or 2
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers and TMA ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait for the completion of the barrier's phase of this parity.  A wait
// of more than 4 s can only be a transfer that never completes: trap, so
// that the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
    if (start == 0)
      start = now;
    else if (now - start > 4000000000ull)
      __trap();
  }
}

// Whether the barrier's phase of this parity has completed, without waiting.
__device__ __forceinline__ bool mbar_test(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// One box of the rank-4 tensor map at coordinates (d, row, head, batch).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int d,
                                         int row, int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(row), "r"(head), "r"(batch)
      : "memory");
}

// -- wgmma ----------------------------------------------------------------------

// Shared-memory matrix descriptor for the 128-byte swizzle: start address,
// leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[0:32] += A (64x16, K-major, shared) . B (64x16, K-major, shared)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d[0:32] += A (64x16, registers) . B (16x64, MN-major in shared memory)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[0:64] += A (64x16, registers) . B (16x128, MN-major in shared memory)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[0:128] += A (64x16, registers) . B (16x256, MN-major in shared memory)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "
      "%87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int DP>
__device__ __forceinline__ void wgmma_rs(float (&d)[DP / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (DP == 64) {
    wgmma_rs_n64(d, a, desc_b);
  } else if constexpr (DP == 128) {
    wgmma_rs_n128(d, a, desc_b);
  } else {
    wgmma_rs_n256(d, a, desc_b);
  }
}

// -- the kernel -------------------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi, float& sum) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  sum += __low2float(v) + __high2float(v);  // l sums what P·V multiplies
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One K/V tile of one warpgroup's online softmax.  s holds the tile's
// logits on wgmma's accumulator layout: s[4j + e] is row r0 + 8·(e / 2),
// key k0 + 8j + c0 + e % 2.  Returns p rounded to bf16 as the A fragments
// of the four k16 steps of P·V, updates m and l (this lane's share of the
// row sum) and rescales o.
template <bool MASK, int DP>
__device__ __forceinline__ void softmax_tile(float (&s)[BN / 2], uint32_t (&pa)[BN / 16][4],
                                             float (&m)[2], float (&l)[2], float (&o)[DP / 2],
                                             const Params& p, int k0, int pos0, int c0) {
  const bool cap = p.softcap > 0.f;
  const float c2 = cap ? LOG2E : p.scale * LOG2E;
  uint32_t ok = 0xffffffffu;
  float mx[2] = {NEG, NEG};
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    float x = s[i];
    if (cap) x = p.softcap * tanhf(x * p.scale / p.softcap);
    x *= c2;
    if (MASK) {
      const int kp = k0 + 8 * (i / 4) + c0 + (i & 1);
      const int pos = pos0 + 8 * ((i >> 1) & 1);
      const bool vis = kp < p.T && (!p.causal || kp <= pos) &&
                       (p.window <= 0 || pos - kp < p.window);
      if (!vis) {
        x = NEG;
        ok &= ~(1u << i);
      }
    }
    s[i] = x;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
  }
  float corr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    corr[r] = exp2f(m[r] - m_new);
    m[r] = m_new;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const float e = exp2f(s[i] - m[(i >> 1) & 1]);
    s[i] = MASK && !((ok >> i) & 1u) ? 0.f : e;
  }
  // k16 step t covers keys 16t .. 16t + 15: accumulator blocks j = 2t, 2t + 1
#pragma unroll
  for (int t = 0; t < BN / 16; ++t) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = 2 * t + half;
      pa[t][2 * half] = pack_bf16(s[4 * j], s[4 * j + 1], l[0]);
      pa[t][2 * half + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3], l[1]);
    }
  }
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] *= corr[(i >> 1) & 1];
}

// What one block works on: its shared-memory layout, its (b, h) and query
// rows, and the key tiles any of its rows can see.
struct Block {
  uint32_t q_s;   // q: [nwg][NC] sub-tiles
  uint32_t kv_s;  // the ring: [STAGES][k, v][NC] sub-tiles
  uint32_t bars;  // mbarriers: q, full[STAGES], empty[STAGES]
  int b, h, hk, q0, off, t0, n_tiles;
  __device__ uint32_t q_bar() const { return bars; }
  __device__ uint32_t full(int s) const { return bars + 8 * (1 + s); }
  __device__ uint32_t empty(int s) const { return bars + 8 * (1 + STAGES + s); }
};

// The loads, issued by the block's first thread: q once, then K/V tile i
// into stage i % STAGES once every consumer warp has released the tile the
// stage held before.  That thread computes too, so it waits for a release
// only where the next tile cannot start without it, and otherwise issues
// what is already free and goes on computing.
template <int NC>
struct Loader {
  const Block& blk;
  const CUtensorMap* tk;
  const CUtensorMap* tv;
  int issued;  // K/V tiles issued so far

  __device__ void q(const CUtensorMap* tq, int nwg) const {
    mbar_expect_tx(blk.q_bar(), nwg * NC * SUB);
    for (int w = 0; w < nwg; ++w)
      for (int c = 0; c < NC; ++c)
        tma_load(blk.q_s + (w * NC + c) * SUB, tq, blk.q_bar(), c * CHUNK, blk.q0 + w * BM,
                 blk.h, blk.b);
  }

  // Issue tiles up to (not including) `until`; wait for a stage's release
  // only if `wait`, else stop at the first stage still in use.
  __device__ void issue(int until, bool wait) {
    for (until = min(until, blk.n_tiles); issued < until; ++issued) {
      const int s = issued % STAGES;
      if (issued >= STAGES) {
        const uint32_t parity = (issued / STAGES - 1) & 1;
        if (wait)
          mbar_wait(blk.empty(s), parity);
        else if (!mbar_test(blk.empty(s), parity))
          return;
      }
      mbar_expect_tx(blk.full(s), 2 * NC * SUB);
      const int k0 = (blk.t0 + issued) * BN;
      for (int c = 0; c < NC; ++c) {
        tma_load(blk.kv_s + (s * 2 * NC + c) * SUB, tk, blk.full(s), c * CHUNK, k0, blk.hk,
                 blk.b);
        tma_load(blk.kv_s + (s * 2 * NC + NC + c) * SUB, tv, blk.full(s), c * CHUNK, k0,
                 blk.hk, blk.b);
      }
    }
  }
};

// A consumer warpgroup: 64 query rows.  Warp wl of it holds rows
// 16·wl .. 16·wl + 15; a lane holds rows r0 and r0 + 8 at columns c0, c0 + 1
// of each 8-column block of the accumulators.
template <int D>
__device__ __forceinline__ void consume(const Block& blk, const Params& p, int wg,
                                        const CUtensorMap* tq, const CUtensorMap* tk,
                                        const CUtensorMap* tv) {
  constexpr int DP = D < CHUNK ? CHUNK : D;  // columns of o, padded to one 128-byte row
  constexpr int NC = DP / CHUNK;              // 128-byte column chunks of a row
  constexpr int KSTEPS = D / 16;              // k16 steps of q·kᵀ
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = 16 * (warp % 4) + lane / 4;
  const int c0 = 2 * (lane % 4);
  const int qw = blk.q0 + wg * BM;           // the warpgroup's first query row
  const int n_rows = min(BM, p.S - qw);    // its rows inside S (may be <= 0)
  const int wpos_lo = qw + blk.off;
  const int wpos_hi = qw + max(n_rows, 1) - 1 + blk.off;

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};

  const bool loads = threadIdx.x == 0;
  Loader<NC> loader{blk, tk, tv, 0};
  if (loads) {
    loader.q(tq, p.nwg);
    loader.issue(STAGES, true);  // the ring starts empty: no wait
  }
  __syncwarp();
  mbar_wait(blk.q_bar(), 0);
  for (int i = 0; i < blk.n_tiles; ++i) {
    const int s = i % STAGES;
    const int k0 = (blk.t0 + i) * BN;
    if (loads) {
      loader.issue(i + 1, true);       // tile i is needed now
      loader.issue(i + STAGES, false);  // the next ones if their stage is free
    }
    __syncwarp();
    mbar_wait(blk.full(s), (i / STAGES) & 1);
    const bool seen = n_rows > 0 && (!p.causal || k0 <= wpos_hi) &&
                      (p.window <= 0 || k0 + BN - 1 > wpos_lo - p.window);
    if (seen) {
      const uint32_t k_tile = blk.kv_s + s * 2 * NC * SUB;
      const uint32_t v_tile = k_tile + NC * SUB;
      float sc[BN / 2];
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) sc[j] = 0.f;
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < KSTEPS; ++t) {
        const uint32_t q_at = blk.q_s + (wg * NC + t / 4) * SUB + (t % 4) * 32;
        const uint32_t k_at = k_tile + (t / 4) * SUB + (t % 4) * 32;
        wgmma_ss_n64(sc, smem_desc(q_at, 16, 1024), smem_desc(k_at, 16, 1024));
      }
      wgmma_commit_and_wait();
      fence_regs(sc);
      if (loads) loader.issue(i + STAGES, false);  // while the other warpgroup catches up
      __syncwarp();

      uint32_t pa[BN / 16][4];
      const bool edge = k0 + BN > p.T || (p.causal && k0 + BN - 1 > wpos_lo) ||
                        (p.window > 0 && wpos_hi - k0 >= p.window);
      if (edge)
        softmax_tile<true, DP>(sc, pa, m, l, o, p, k0, qw + r0 + blk.off, c0);
      else
        softmax_tile<false, DP>(sc, pa, m, l, o, p, k0, qw + r0 + blk.off, c0);

      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < BN / 16; ++t)  // keys 16t .. 16t + 15: two 8-row groups 1024 B apart
        wgmma_rs<DP>(o, pa[t], smem_desc(v_tile + t * 16 * 128, SUB, 1024));
      wgmma_commit_and_wait();
      fence_regs(o);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(blk.empty(s));  // this warp is done with the stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  __nv_bfloat16* out = (__nv_bfloat16*)p.o + blk.b * p.os[0] + blk.h * p.os[1];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + 8 * half;
    if (row >= n_rows) continue;
    __nv_bfloat16* orow = out + (long long)(qw + row) * p.os[2];
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + c0;
      if (col >= D) continue;
      *reinterpret_cast<__nv_bfloat162*>(orow + col) =
          __floats2bfloat162_rn(o[4 * j + 2 * half] / l[half], o[4 * j + 2 * half + 1] / l[half]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(MAX_WG * 128, 1)
    flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv, const Params p) {
  constexpr int NC = (D < CHUNK ? CHUNK : D) / CHUNK;
  extern __shared__ uint8_t smem_raw[];
  Block blk;
  // the 128-byte swizzle repeats every 8 rows (1024 bytes): tiles start on
  // a 1024-byte boundary, as the wgmma descriptors assume
  blk.q_s = (smem_u32(smem_raw) + 1023) & ~1023u;
  blk.kv_s = blk.q_s + p.nwg * NC * SUB;
  blk.bars = blk.kv_s + STAGES * 2 * NC * SUB;
  blk.b = blockIdx.x / p.H;
  blk.h = blockIdx.x % p.H;
  blk.hk = blk.h / (p.H / p.Hkv);
  const int rows = p.nwg * BM;
  blk.q0 = (gridDim.y - 1 - blockIdx.y) * rows;  // longest causal rows first
  blk.off = p.T - p.S;
  // the key tiles any row of this block can see
  const int pos_lo = blk.q0 + blk.off;
  const int pos_hi = min(blk.q0 + rows, p.S) - 1 + blk.off;
  const int k_end = p.causal ? min(p.T, pos_hi + 1) : p.T;
  const int k_begin = p.window > 0 ? max(0, pos_lo - p.window + 1) : 0;
  blk.t0 = k_begin / BN;
  blk.n_tiles = max(0, (k_end + BN - 1) / BN - blk.t0);

  if (threadIdx.x == 0) {
    mbar_init(blk.q_bar(), 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(blk.full(s), 1);
      mbar_init(blk.empty(s), 4 * p.nwg);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  consume<D>(blk, p, threadIdx.x / 128, &tq, &tk, &tv);
}

// -- host side --------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no link against libcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A rank-4 map over (d, row, head, batch) of a bf16 tensor with a
// contiguous d axis; st holds the element strides of axes batch, head, row.
// Boxes are 64 values by 64 rows, 128-byte swizzled.  An axis of one
// element gets a placeholder stride: TMA never steps along it.
bool encode(CUtensorMap* map, const void* ptr, int D, int n_rows, int n_heads, int n_batch,
            const long long* st) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const long long size[3] = {n_batch, n_heads, n_rows};
  cuuint64_t stride[3];  // bytes, axes row, head, batch
  for (int a = 0; a < 3; ++a)
    stride[2 - a] = (cuuint64_t)(size[a] > 1 ? st[a] : D) * sizeof(__nv_bfloat16);
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)n_rows, (cuuint64_t)n_heads,
                              (cuuint64_t)n_batch};
  const cuuint32_t box[4] = {CHUNK, 64, 1, 1};
  const cuuint32_t elem_stride[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, stride, box,
            elem_stride, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, const Params& p,
           cudaStream_t stream) {
  constexpr int NC = (D < CHUNK ? CHUNK : D) / CHUNK;
  auto smem_bytes = [](int nwg) {
    return 1024 + (nwg + 2 * STAGES) * NC * SUB + 8 * (1 + 2 * STAGES);
  };
  // Opt in once per device to the dynamic shared memory of the widest block.
  static unsigned opted = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 32) return (int)cudaErrorInvalidDevice;
  if (!((opted >> dev) & 1u)) {
    e = cudaFuncSetAttribute(flash_attention_sm90_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(MAX_WG));
    if (e != cudaSuccess) return (int)e;
    opted |= 1u << dev;
  }
  const int rows = p.nwg * BM;
  const dim3 grid(p.B * p.H, (p.S + rows - 1) / rows);
  flash_attention_sm90_kernel<D>
      <<<grid, p.nwg * 128, smem_bytes(p.nwg), stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, H, S, D], k and v [B, Hkv, T, D], o like q; bfloat16 throughout.
// strides: 12 element strides, axes b, h, s of q, k, v and o in that order;
// the d axis is contiguous.  D in {32, 64, 128, 256}; H a multiple of Hkv;
// S, T >= 1; base addresses and the strides of axes longer than 1 aligned
// to 16 bytes.  window <= 0 means none, softcap <= 0 none.  Returns
// cudaErrorInvalidValue if a tensor map cannot be encoded, else
// cudaGetLastError() after the launch.
extern "C" int repro_flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                          const long long* strides, int B, int H, int Hkv, int S,
                                          int T, int D, int causal, int window, float scale,
                                          float softcap, void* stream) {
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, q, D, S, H, B, strides) || !encode(&tk, k, D, T, Hkv, B, strides + 3) ||
      !encode(&tv, v, D, T, Hkv, B, strides + 6))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.o = o;
  for (int a = 0; a < 3; ++a) p.os[a] = strides[9 + a];
  p.B = B;
  p.H = H;
  p.Hkv = Hkv;
  p.S = S;
  p.T = T;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.softcap = softcap;
  p.nwg = S <= BM ? 1 : MAX_WG;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 32: return launch<32>(tq, tk, tv, p, st);
    case 64: return launch<64>(tq, tk, tv, p, st);
    case 128: return launch<128>(tq, tk, tv, p, st);
    case 256: return launch<256>(tq, tk, tv, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
