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
// 0.017 ms; at the D = 128 prefills of grok-1, llama4-scout, gemma2-27b and
// internvl2-26b operations, 0.06-2.8 ms.  Both products therefore run as
// wgmma on bf16 tiles with float32 accumulators, fed by TMA, and the
// softmax stays in registers.  Beside the tensor cores, each visible pair
// costs one exp2 on the SM's 16-lane MUFU pipe (three with the softcap):
// at D = 128 that is 0.06 clocks of an SM against the tensor cores' 0.12,
// so the two must run at once to approach the bound.
//
// Two kernels, picked by D:
//  * D = 64 and 128 (flash_attention_sm90_ws_kernel, below): warp-specialised
//    for that overlap.  128-key tiles, a producer warpgroup issuing TMA, two
//    consumer warpgroups taking turns at the tensor cores, and a softcap on
//    the MUFU pipe (ex2 and rcp, no tanhf).  At D = 128 its registers (o and
//    s at 64 floats each, p at 32) need setmaxnreg, which only a
//    producer/consumer split gives.  D = 64 moved to it after an A/B on the
//    card showed it faster at every D = 64 row (whisper's encoder,
//    cross- and self-attention: PERF.md);
//  * D = 32 and 256 (flash_attention_sm90_kernel): the first design, no
//    producer warpgroup.  At D = 256 a thread keeps 128 floats of o, which
//    leaves no room for s and p of a 128-key tile beside it; D = 32 is half
//    a 128-byte row, which the first design pads by TMA's zero fill.
//
// The first design (D = 32, 256):
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

// The warp-specialised kernel's parameters: Params and its folded
// constants, scale·log2(e) and, with a softcap c, 2·log2(e)·scale / c,
// c·log2(e) and -2·c·log2(e).  A type of its own, so that the first
// design's kernel keeps the parameter block and the code it was measured
// with (PERF.md: on an H100 its D = 256 rows ran 5-8% slower at 8192 tokens when it
// shared a larger block and block_tiles).
struct WsParams : Params {
  float scale_log2, cap_a, cap_c, cap_m2c;
};

__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// The key tiles [first, first + count) that any row of the query block of
// `rows` rows starting at q0 can see: the kernels walk exactly these (the
// first design computes the same inline), and
// repro_flash_attention_bf16_plan reports them.
struct TileRange {
  int first, count;
};

__host__ __device__ inline TileRange block_tiles(int S, int T, int causal, int window, int q0,
                                                 int rows, int bn) {
  const int off = T - S;
  const int pos_lo = q0 + off;
  const int pos_hi = imin(q0 + rows, S) - 1 + off;
  const int k_end = causal ? imin(T, pos_hi + 1) : T;
  const int k_begin = window > 0 ? imax(0, pos_lo - window + 1) : 0;
  const int first = k_begin / bn;
  return {first, imax(0, (k_end + bn - 1) / bn - first)};
}

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

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed wgmma groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The same for the A fragments of a register-sourced wgmma: they stay live,
// in their registers, until the wgmma that reads them has completed.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
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

// d[0:64] (+)= A (64x16, K-major, shared) . B (128x16, K-major, shared); d is
// overwritten where `accumulate` is 0, so it needs no zeroing first
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
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
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
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

// -- D = 64, 128: the warp-specialised kernel --------------------------------------
//
// Design (flash_attention_sm90_ws_kernel):
//  * a block of 384 threads per 128 query rows of one (b, h): consumer
//    warpgroups 0 and 1 (64 rows each) first, so that their wgmma stays
//    warpgroup-aligned, then one producer warpgroup.  The producer drops to
//    WS_PRODUCER_REGS registers (setmaxnreg.dec) and the consumers rise to
//    WS_CONSUMER_REGS (setmaxnreg.inc): the two roles are the two arms of
//    one if/else that never reconverge, which is what lets ptxas give a
//    consumer more than the 168 registers a 384-thread block averages;
//  * one thread of the producer issues every TMA load: q once (both
//    warpgroups' rows), then K and V tiles of 128 keys into two rings of
//    WS_STAGES stages each, in the order the consumers need them (K0, then
//    K(j), V(j - 1), then the last V).  Each stage has a "full" mbarrier
//    (transaction bytes) and an "empty" one (one arrival per consumer
//    warp), so a K stage is released as soon as q·kᵀ has read it and a V
//    stage when p·v has.  At D = 128 q is 32 KB, a K or V tile 32 KB:
//    160 KB in all;
//  * S = q·kᵀ as wgmma m64n128k16 (8 k-steps, both operands K-major in
//    shared memory); O += P·V as m64n128k16 with P from registers and V
//    MN-major (8 k-steps of 16 keys);
//  * within a warpgroup the products of tile j overlap the softmax: turn j
//    issues S(j) = q·k(j)ᵀ and then O += P(j - 1)·V(j - 1), waits for S(j)
//    alone (wgmma.wait_group 1) and runs tile j's softmax while P·V is on
//    the tensor cores; only then does it wait for P·V, rescale o and pack
//    P(j).  A thread holds o (64 floats), S (64) and P (32 registers);
//  * the two warpgroups take turns issuing (ping-pong), so that one's
//    softmax runs while the other's products do.  The turn passes through
//    a pair of mbarriers, as CUTLASS's ordered sequence barrier does.  On
//    the card the turns measured within the run-to-run spread of a variant
//    without them (PERF.md): the overlap inside a warpgroup does the work;
//  * the softcap on the MUFU pipe: c·tanh(t) = c - 2c / (1 + 2^(2·log2(e)·t)),
//    the constants folded on the host, one ex2 and one rcp (2^-22 relative
//    error each: about 1e-7 of c, 5e-6 in a logit at c = 50); then the
//    softmax's exp2 as ex2.approx;
//  * kept from the first design: the grid runs a KV head's query heads side
//    by side (its K/V tiles come from L2 for all but the first) and the
//    query blocks in reverse order; tiles no row of the block can see are
//    never loaded; the mask only on edge tiles, at -1e30, p forced to 0
//    where masked; l sums the rounded p; a row that sees no key gives 0;
//  * a warpgroup with no row inside S takes its turns without products.
//    One whose rows miss a tile at the block's edge computes it anyway,
//    fully masked: the products stay outside any condition on the tile,
//    since ptxas serialises wgmma it finds under such conditions.

constexpr int WS_BM = 64;                 // query rows per consumer warpgroup
constexpr int WS_CONSUMERS = 2;           // consumer warpgroups
constexpr int WS_ROWS = WS_BM * WS_CONSUMERS;
constexpr int WS_BN = 128;                // keys per K/V tile
constexpr int WS_STAGES = 2;              // depth of the K ring and of the V ring
constexpr int WS_THREADS = 128 * (WS_CONSUMERS + 1);
constexpr int WS_PRODUCER_REGS = 40;
constexpr int WS_CONSUMER_REGS = 232;     // 128·40 + 256·232 = 64 512 <= 65 536
constexpr int WS_Q_SUB = WS_BM * 128;     // bytes of a [64 rows][128 B] q sub-tile
constexpr int WS_KV_SUB = WS_BN * 128;    // bytes of a [128 rows][128 B] K or V sub-tile
constexpr int WS_BARS = 1 + 4 * WS_STAGES + 2;

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The warp-specialised kernel's waits spin without mbar_wait's 4 s trap: a
// trap anywhere in the kernel keeps ptxas from giving the consumers the
// registers setmaxnreg.inc grants (it holds them to the 168 a 384-thread
// block averages, and spills).  To debug a change to the barrier protocol,
// wait with mbar_wait here: a stuck wait then traps instead of hanging.
__device__ __forceinline__ void ws_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_test(bar, parity)) {
  }
}

// What one block of the warp-specialised kernel works on.
struct WsBlock {
  uint32_t q_s;   // q: [consumer][NC] sub-tiles
  uint32_t k_s;   // the K ring: [WS_STAGES][NC] sub-tiles
  uint32_t v_s;   // the V ring: the same
  uint32_t bars;  // q, full_k[], full_v[], empty_k[], empty_v[], turn[2]
  int b, h, hk, q0, off, t0, n_tiles;
  __device__ uint32_t q_bar() const { return bars; }
  __device__ uint32_t full_k(int s) const { return bars + 8 * (1 + s); }
  __device__ uint32_t full_v(int s) const { return bars + 8 * (1 + WS_STAGES + s); }
  __device__ uint32_t empty_k(int s) const { return bars + 8 * (1 + 2 * WS_STAGES + s); }
  __device__ uint32_t empty_v(int s) const { return bars + 8 * (1 + 3 * WS_STAGES + s); }
  // completes a phase each time the other consumer warpgroup hands over
  __device__ uint32_t turn(int wg) const { return bars + 8 * (1 + 4 * WS_STAGES + wg); }
};

// The producer's one thread: K or V tile i into its ring, once every
// consumer warp has released the tile the stage held before.
template <int NC>
__device__ __forceinline__ void ws_load_tile(const WsBlock& blk, const CUtensorMap* map,
                                             uint32_t ring, uint32_t full, uint32_t empty, int i) {
  const int s = i % WS_STAGES;
  if (i >= WS_STAGES) ws_wait(empty + 8 * s, (i / WS_STAGES - 1) & 1);
  mbar_expect_tx(full + 8 * s, NC * WS_KV_SUB);
  const int k0 = (blk.t0 + i) * WS_BN;
#pragma unroll
  for (int c = 0; c < NC; ++c)
    tma_load(ring + (s * NC + c) * WS_KV_SUB, map, full + 8 * s, c * CHUNK, k0, blk.hk, blk.b);
}

template <int D>
__device__ __forceinline__ void ws_produce(const WsBlock& blk, const CUtensorMap* tq,
                                           const CUtensorMap* tk, const CUtensorMap* tv) {
  constexpr int NC = D / CHUNK;
  const int n = blk.n_tiles;
  if (n == 0) return;
  mbar_expect_tx(blk.q_bar(), WS_CONSUMERS * NC * WS_Q_SUB);
#pragma unroll
  for (int w = 0; w < WS_CONSUMERS; ++w)
#pragma unroll
    for (int c = 0; c < NC; ++c)
      tma_load(blk.q_s + (w * NC + c) * WS_Q_SUB, tq, blk.q_bar(), c * CHUNK, blk.q0 + w * WS_BM,
               blk.h, blk.b);
  for (int i = 0; i <= n; ++i) {
    if (i < n) ws_load_tile<NC>(blk, tk, blk.k_s, blk.full_k(0), blk.empty_k(0), i);
    if (i > 0) ws_load_tile<NC>(blk, tv, blk.v_s, blk.full_v(0), blk.empty_v(0), i - 1);
  }
}

// Tile j's softmax on S's accumulator layout (s[4j + e]: row r0 + 8·(e / 2),
// key k0 + 8j + c0 + e % 2), while P(j - 1)·V(j - 1) may still run: o is not
// touched.  Leaves p = 2^(x - m) (unrounded) in s, updates m, scales l by
// corr and returns corr, the factor o must take before P(j)·V(j) adds to it.
// x is the logit in units of m: raw q·k without a softcap (scaled inside
// the exponent), c·tanh(...)·log2(e) with one.
template <bool MASK, bool CAP>
__device__ __forceinline__ void ws_softmax(float (&s)[WS_BN / 2], float (&m)[2], float (&l)[2],
                                           float (&corr)[2], const WsParams& p, int k0, int pos0,
                                           int c0) {
  constexpr int N = WS_BN / 2;
  uint32_t ok[2] = {0xffffffffu, 0xffffffffu};
  float mx[2] = {NEG, NEG};
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float x = s[i];
    if (CAP) x = fmaf(p.cap_m2c, rcp_approx(1.f + ex2_approx(x * p.cap_a)), p.cap_c);
    if (MASK) {
      const int kp = k0 + 8 * (i / 4) + c0 + (i & 1);
      const int pos = pos0 + 8 * ((i >> 1) & 1);
      const bool vis = kp < p.T && (!p.causal || kp <= pos) &&
                       (p.window <= 0 || pos - kp < p.window);
      if (!vis) {
        x = NEG;
        ok[i / 32] &= ~(1u << (i % 32));
      }
    }
    s[i] = x;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
  }
  const float c2 = CAP ? 1.f : p.scale_log2;
  float mb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    corr[r] = ex2_approx((m[r] - m_new) * c2);
    m[r] = m_new;
    l[r] *= corr[r];
    mb[r] = m_new * c2;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float e = ex2_approx(fmaf(s[i], c2, -mb[(i >> 1) & 1]));
    s[i] = MASK && !((ok[i / 32] >> (i % 32)) & 1u) ? 0.f : e;
  }
}

// q·k(j)ᵀ into s: 8 k-steps of m64n128k16, both operands K-major.
template <int NC, int KSTEPS>
__device__ __forceinline__ void ws_issue_s(float (&s)[WS_BN / 2], uint32_t q_base,
                                           uint32_t k_tile) {
#pragma unroll
  for (int t = 0; t < KSTEPS; ++t)
    wgmma_ss_n128(s, smem_desc(q_base + (t / 4) * WS_Q_SUB + (t % 4) * 32, 16, 1024),
                  smem_desc(k_tile + (t / 4) * WS_KV_SUB + (t % 4) * 32, 16, 1024), t > 0);
  wgmma_commit();
}

// o += p·v: keys 16t .. 16t + 15 at step t, two 8-row groups 1024 B apart.
template <int D>
__device__ __forceinline__ void ws_issue_pv(float (&o)[D / 2], const uint32_t (&pa)[WS_BN / 16][4],
                                            uint32_t v_tile) {
#pragma unroll
  for (int t = 0; t < WS_BN / 16; ++t)
    wgmma_rs<D>(o, pa[t], smem_desc(v_tile + t * 16 * 128, WS_KV_SUB, 1024));
  wgmma_commit();
}

// Tile j's softmax, the variant for the tile: masked only at an edge.
__device__ __forceinline__ void ws_softmax_tile(float (&s)[WS_BN / 2], float (&m)[2], float (&l)[2],
                                                float (&corr)[2], const WsParams& p, int k0,
                                                int pos0, int c0, int wpos_lo, int wpos_hi) {
  const bool edge = k0 + WS_BN > p.T || (p.causal && k0 + WS_BN - 1 > wpos_lo) ||
                    (p.window > 0 && wpos_hi - k0 >= p.window);
  if (p.softcap > 0.f) {
    if (edge)
      ws_softmax<true, true>(s, m, l, corr, p, k0, pos0, c0);
    else
      ws_softmax<false, true>(s, m, l, corr, p, k0, pos0, c0);
  } else {
    if (edge)
      ws_softmax<true, false>(s, m, l, corr, p, k0, pos0, c0);
    else
      ws_softmax<false, false>(s, m, l, corr, p, k0, pos0, c0);
  }
}

// p rounded to bf16 as the A fragments of p·v's k16 steps (step t: keys
// 16t .. 16t + 15, accumulator blocks 2t and 2t + 1); l sums what p·v
// multiplies.
__device__ __forceinline__ void ws_pack(const float (&s)[WS_BN / 2], uint32_t (&pa)[WS_BN / 16][4],
                                        float (&l)[2]) {
#pragma unroll
  for (int t = 0; t < WS_BN / 16; ++t) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int b = 2 * t + half;
      pa[t][2 * half] = pack_bf16(s[4 * b], s[4 * b + 1], l[0]);
      pa[t][2 * half + 1] = pack_bf16(s[4 * b + 2], s[4 * b + 3], l[1]);
    }
  }
}

// A consumer warpgroup: 64 query rows.  Warp wl of it holds rows
// 16·wl .. 16·wl + 15; a lane holds rows r0 and r0 + 8 at columns c0, c0 + 1
// of each 8-column block of the accumulators.  Turn j (in order with the
// other warpgroup) issues S(j) = q·k(j)ᵀ for j < n and O += P(j - 1)·V(j - 1)
// for j > 0.  Every tile of the block's range is computed: where none of
// this warpgroup's rows sees a tile (one at the block's edge, where the
// rows are not aligned to the tiles) the mask leaves p = 0 and m, l and o
// unchanged.  The products stay outside any condition on the tile, so that
// ptxas can follow which wgmma group each wait completes.
template <int D>
__device__ __forceinline__ void ws_consume(const WsBlock& blk, const WsParams& p, int wg) {
  constexpr int NC = D / CHUNK;
  constexpr int KSTEPS = D / 16;  // k16 steps of q·kᵀ
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int r0 = 16 * warp + lane / 4;
  const int c0 = 2 * (lane % 4);
  const int qw = blk.q0 + wg * WS_BM;  // the warpgroup's first query row
  const int n_rows = min(WS_BM, p.S - qw);
  const int wpos_lo = qw + blk.off;
  const int wpos_hi = qw + max(n_rows, 1) - 1 + blk.off;
  const int pos0 = qw + r0 + blk.off;
  const int n = blk.n_tiles;
  const int other = 1 - wg;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};

  // a stage is released by each warp once its wgmma have read it
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  // the turn passes to the other warpgroup (warpgroup 1 keeps its last)
  auto hand_over = [&](int j) {
    __syncwarp();
    if (lane == 0 && !(wg == 1 && j == n)) mbar_arrive(blk.turn(other));
  };

  if (n > 0 && n_rows <= 0) {
    // no row of this warpgroup lies inside S: take the turns, release the
    // stages, compute nothing
    if (wg == 1 && lane == 0) mbar_arrive(blk.turn(0));
    for (int j = 0; j <= n; ++j) {
      if (j < n) ws_wait(blk.full_k(j % WS_STAGES), (j / WS_STAGES) & 1);
      if (j > 0) ws_wait(blk.full_v((j - 1) % WS_STAGES), ((j - 1) / WS_STAGES) & 1);
      ws_wait(blk.turn(wg), j & 1);
      hand_over(j);
      if (j < n) release(blk.empty_k(j % WS_STAGES));
      if (j > 0) release(blk.empty_v((j - 1) % WS_STAGES));
    }
  } else if (n > 0) {
    if (wg == 1 && lane == 0) mbar_arrive(blk.turn(0));  // warpgroup 0 issues first
    const uint32_t q_base = blk.q_s + wg * NC * WS_Q_SUB;
    float sc[WS_BN / 2];
    uint32_t pa[WS_BN / 16][4];
    float corr[2];
    ws_wait(blk.q_bar(), 0);

    // turn 0: S(0)
    ws_wait(blk.full_k(0), 0);
    ws_wait(blk.turn(wg), 0);
    wgmma_fence();
    ws_issue_s<NC, KSTEPS>(sc, q_base, blk.k_s);
    hand_over(0);
    wgmma_wait<0>();
    fence_regs(sc);
    release(blk.empty_k(0));
    ws_softmax_tile(sc, m, l, corr, p, blk.t0 * WS_BN, pos0, c0, wpos_lo, wpos_hi);
    ws_pack(sc, pa, l);

    // turns 1 .. n - 1: S(j), then P(j - 1)·V(j - 1) under tile j's softmax
    for (int j = 1; j < n; ++j) {
      const int sk = j % WS_STAGES, sv = (j - 1) % WS_STAGES;
      ws_wait(blk.full_k(sk), (j / WS_STAGES) & 1);
      ws_wait(blk.full_v(sv), ((j - 1) / WS_STAGES) & 1);
      ws_wait(blk.turn(wg), j & 1);
      fence_regs(sc);
      fence_regs(o);
      wgmma_fence();
      ws_issue_s<NC, KSTEPS>(sc, q_base, blk.k_s + sk * NC * WS_KV_SUB);
      ws_issue_pv<D>(o, pa, blk.v_s + sv * NC * WS_KV_SUB);
      hand_over(j);
      wgmma_wait<1>();  // S(j) is done; P·V may still run
      fence_regs(sc);
      release(blk.empty_k(sk));
      ws_softmax_tile(sc, m, l, corr, p, (blk.t0 + j) * WS_BN, pos0, c0, wpos_lo, wpos_hi);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      release(blk.empty_v(sv));
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
      ws_pack(sc, pa, l);
    }

    // turn n: P(n - 1)·V(n - 1)
    const int sv = (n - 1) % WS_STAGES;
    ws_wait(blk.full_v(sv), ((n - 1) / WS_STAGES) & 1);
    ws_wait(blk.turn(wg), n & 1);
    fence_regs(o);
    wgmma_fence();
    ws_issue_pv<D>(o, pa, blk.v_s + sv * NC * WS_KV_SUB);
    hand_over(n);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    release(blk.empty_v(sv));
  }

  // 1 / l by rcp.approx: a division would call its slow-path subroutine
  float inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv_l[r] = rcp_approx(fmaxf(l[r], 1e-30f));
  }
  __nv_bfloat16* out = (__nv_bfloat16*)p.o + blk.b * p.os[0] + blk.h * p.os[1];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + 8 * half;
    if (row >= n_rows) continue;
    __nv_bfloat16* orow = out + (long long)(qw + row) * p.os[2];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + c0;
      *reinterpret_cast<__nv_bfloat162*>(orow + col) =
          __floats2bfloat162_rn(o[4 * j + 2 * half] * inv_l[half],
                                o[4 * j + 2 * half + 1] * inv_l[half]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(WS_THREADS, 1)
    flash_attention_sm90_ws_kernel(const __grid_constant__ CUtensorMap tq,
                                   const __grid_constant__ CUtensorMap tk,
                                   const __grid_constant__ CUtensorMap tv, const WsParams p) {
  constexpr int NC = D / CHUNK;
  extern __shared__ uint8_t smem_raw[];
  WsBlock blk;
  blk.q_s = (smem_u32(smem_raw) + 1023) & ~1023u;  // the 128-byte swizzle's 1024-byte period
  blk.k_s = blk.q_s + WS_CONSUMERS * NC * WS_Q_SUB;
  blk.v_s = blk.k_s + WS_STAGES * NC * WS_KV_SUB;
  blk.bars = blk.v_s + WS_STAGES * NC * WS_KV_SUB;
  blk.b = blockIdx.x / p.H;
  blk.h = blockIdx.x % p.H;
  blk.hk = blk.h / (p.H / p.Hkv);
  blk.q0 = (gridDim.y - 1 - blockIdx.y) * WS_ROWS;  // longest causal rows first
  blk.off = p.T - p.S;
  const TileRange tiles = block_tiles(p.S, p.T, p.causal, p.window, blk.q0, WS_ROWS, WS_BN);
  blk.t0 = tiles.first;
  blk.n_tiles = tiles.count;

  if (threadIdx.x == 0) {
    mbar_init(blk.q_bar(), 1);
    for (int s = 0; s < WS_STAGES; ++s) {
      mbar_init(blk.full_k(s), 1);
      mbar_init(blk.full_v(s), 1);
      mbar_init(blk.empty_k(s), 4 * WS_CONSUMERS);  // one arrival per consumer warp
      mbar_init(blk.empty_v(s), 4 * WS_CONSUMERS);
    }
    for (int w = 0; w < WS_CONSUMERS; ++w) mbar_init(blk.turn(w), 4);  // the other's warps
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the role by a shuffle: ptxas then knows it is the same in every lane, and
  // does not serialise the wgmma of branches it would otherwise see diverge
  const int role = __shfl_sync(0xffffffffu, (int)(threadIdx.x / 128), 0);
  if (role == WS_CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(WS_PRODUCER_REGS));
    if (threadIdx.x == WS_CONSUMERS * 128) ws_produce<D>(blk, &tq, &tk, &tv);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(WS_CONSUMER_REGS));
    ws_consume<D>(blk, p, role);
  }
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
// Boxes are 64 values by box_rows rows, 128-byte swizzled.  An axis of one
// element gets a placeholder stride: TMA never steps along it.
bool encode(CUtensorMap* map, const void* ptr, int D, int n_rows, int n_heads, int n_batch,
            const long long* st, int box_rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const long long size[3] = {n_batch, n_heads, n_rows};
  cuuint64_t stride[3];  // bytes, axes row, head, batch
  for (int a = 0; a < 3; ++a)
    stride[2 - a] = (cuuint64_t)(size[a] > 1 ? st[a] : D) * sizeof(__nv_bfloat16);
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)n_rows, (cuuint64_t)n_heads,
                              (cuuint64_t)n_batch};
  const cuuint32_t box[4] = {CHUNK, (cuuint32_t)box_rows, 1, 1};
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

template <int D>
int launch_ws(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
              const Params& base, cudaStream_t stream) {
  constexpr int NC = D / CHUNK;
  constexpr int smem_bytes =
      1024 + WS_CONSUMERS * NC * WS_Q_SUB + 2 * WS_STAGES * NC * WS_KV_SUB + 8 * WS_BARS;
  static unsigned opted = 0;  // devices that have opted in to smem_bytes
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 32) return (int)cudaErrorInvalidDevice;
  if (!((opted >> dev) & 1u)) {
    e = cudaFuncSetAttribute(flash_attention_sm90_ws_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    opted |= 1u << dev;
  }
  WsParams p;
  static_cast<Params&>(p) = base;
  const double log2e = 1.4426950408889634;
  p.scale_log2 = (float)(p.scale * log2e);
  p.cap_a = p.softcap > 0.f ? (float)(2.0 * log2e * p.scale / p.softcap) : 0.f;
  p.cap_c = (float)(p.softcap * log2e);
  p.cap_m2c = (float)(-2.0 * p.softcap * log2e);
  const dim3 grid(p.B * p.H, (p.S + WS_ROWS - 1) / WS_ROWS);
  flash_attention_sm90_ws_kernel<D><<<grid, WS_THREADS, smem_bytes, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

// Whether head dimension D takes the warp-specialised kernel: D a multiple of
// 64 (one 128-byte row of the swizzle a chunk) whose o fits beside s and p.
constexpr bool takes_ws(int D) { return D == 64 || D == 128; }

}  // namespace

// q [B, H, S, D], k and v [B, Hkv, T, D], o like q; bfloat16 throughout.
// strides: 12 element strides, axes b, h, s of q, k, v and o in that order;
// the d axis is contiguous.  D in {32, 64, 128, 256} (64 and 128: the
// warp-specialised kernel; 32 and 256: the first design); H a multiple of Hkv;
// S, T >= 1; base addresses and the strides of axes longer than 1 aligned
// to 16 bytes.  window <= 0 means none, softcap <= 0 none.  Returns
// cudaErrorInvalidValue if a tensor map cannot be encoded, else
// cudaGetLastError() after the launch.
extern "C" int repro_flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                          const long long* strides, int B, int H, int Hkv, int S,
                                          int T, int D, int causal, int window, float scale,
                                          float softcap, void* stream) {
  const int kv_rows = takes_ws(D) ? WS_BN : BN;  // rows of a K/V box: one tile
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, q, D, S, H, B, strides, BM) ||
      !encode(&tk, k, D, T, Hkv, B, strides + 3, kv_rows) ||
      !encode(&tv, v, D, T, Hkv, B, strides + 6, kv_rows))
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
    case 64: return launch_ws<64>(tq, tk, tv, p, st);
    case 128: return launch_ws<128>(tq, tk, tv, p, st);
    case 256: return launch<256>(tq, tk, tv, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The launch plan repro_flash_attention_bf16 takes for these shapes, into
// plan[0 .. cap): the kernel (1: the warp-specialised kernel, 0: the first
// design), query rows a block, keys a tile, the number of query
// blocks nq, then for each query block in ascending order of its first row
// the key tiles [first, last) its rows can see (the tiles it loads).
// Returns cudaErrorInvalidValue for a D the route does not take or a plan
// longer than cap.
extern "C" int repro_flash_attention_bf16_plan(int B, int H, int Hkv, int S, int T, int D,
                                               int causal, int window, int* plan, int cap) {
  if (D != 32 && D != 64 && D != 128 && D != 256) return (int)cudaErrorInvalidValue;
  const bool ws = takes_ws(D);
  const int rows = ws ? WS_ROWS : (S <= BM ? 1 : MAX_WG) * BM;
  const int bn = ws ? WS_BN : BN;
  const int nq = (S + rows - 1) / rows;
  if (cap < 4 + 2 * nq) return (int)cudaErrorInvalidValue;
  plan[0] = ws ? 1 : 0;
  plan[1] = rows;
  plan[2] = bn;
  plan[3] = nq;
  for (int i = 0; i < nq; ++i) {
    const TileRange r = block_tiles(S, T, causal, window, i * rows, rows, bn);
    plan[4 + 2 * i] = r.first;
    plan[5 + 2 * i] = r.first + r.count;
  }
  return 0;
}
