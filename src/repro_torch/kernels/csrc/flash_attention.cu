// Flash attention forward (causal or not, GQA, D != Dv allowed, a causal
// sliding window, a logit soft-cap, a query offset) for Hopper (sm_90a),
// bf16 in and out, f32 softmax state.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_tpu (body _flash_kernel), and with it the attention of
// src/repro/models/layers.py::flash_attention on the serving path.
//
// Layout (the JAX one): q (B, Sq, H, D), k (B, Skv, Hkv, D),
// v (B, Skv, Hkv, Dv), out (B, Sq, H, Dv), all C-contiguous; H = G * Hkv and
// query head h = hkv * G + g attends to kv head hkv.  Scores are scaled by
// 1 / sqrt(D) (the q/k width, not Dv); query i sits at position
// q_offset + i (the reference's q_offset: a prefill that continues a
// cache) and causal masking keeps key positions <= its position.  A window
// W > 0 (causal only) also masks keys at or below position - W: query i
// sees keys p - W + 1 .. p, p = q_offset + i, the reference's `local`
// layers' attention.  A soft-cap c > 0 replaces each scaled score s by
// c * tanh(s / c) before the mask (the logit soft-cap the reference's
// attention takes): tanhf in f32, in an instantiation of its own (kCap), so
// that the kernel without a soft-cap runs the instructions it ran before
// and gives the same bits (a branch on a runtime argument, uniform across
// the grid, slowed it measurably at (64, 64) on the card).
//
// Five widths are built: (D, Dv) = (192, 128), MLA's (deepseek-v2-lite),
// (64, 64), the GQA head width of llama3.2-1b and tinyllama-1.1b,
// (128, 128), grok-1's (48 query heads over 8 kv heads, G = 6),
// (256, 256), gemma3-12b's (16 query heads over 8 kv heads, G = 2) and
// recurrentgemma-2b's (10 query heads over 1 kv head, G = 10, under a
// window of 2048), and (80, 80), stablelm-3b's (32 heads, G = 1).
//
// What bounds it on this card: at the MLA serving prefill shape (8 x 512
// tokens, 16 heads, D 192, Dv 128) the causal work is about 10.7 GFLOP
// (11 us at 989 TFLOP/s) and the bytes that must move about 84 MB (25 us
// at 3.35 TB/s), so the bound is bytes; at llama's (8 x 512, 32 heads over
// 8 kv heads, D = Dv = 64) 8.6 GFLOP (8.7 us) against 41.9 MB (12.5 us),
// bytes again; at llama's training shape (2 x 2048) 34 GFLOP (35 us)
// against the same 41.9 MB, operations; at grok-1's prefill (8 x 512, 48
// heads over 8 kv heads, D = Dv = 128) 25.8 GFLOP (26 us) against 117 MB
// (35 us), bytes; at gemma3-12b's (8 x 2048, 16 heads over 8 kv heads,
// D = Dv = 256) 275 GFLOP (278 us) against 403 MB (120 us) in a global
// layer and, under the window of 1024, 206 GFLOP (209 us) against the same
// bytes in a local one: operations; at recurrentgemma-2b's (8 x 4096, 10
// heads over 1 kv head of 256, window 2048) 515 GFLOP (521 us) against 369
// MB (110 us), operations; at stablelm-3b's (8 x 512, 32 heads of 80)
// 10.7 GFLOP (11 us) against 84 MB (25 us), bytes, and at its training
// shape (1 x 2048) 21.5 GFLOP (22 us) against 42 MB, operations.
//
// A width that is not a multiple of the 64-column swizzle box (80) is
// padded up to one (128) inside the kernel: the tensor maps keep the real
// width, so TMA fills a box's columns past it with zeros (each box still
// delivers, and the barrier still counts, its whole bytes); shared memory,
// the wgmma k-steps of S = Q K^T and the n of O += P V run at the padded
// width, where the zero columns add nothing to the scores and give zero
// output columns; the store writes the real width's columns only.  At 80
// that is 1.6x the products the real width needs: simple and right first.
// What held the first (mma.sync)
// version at 7.6x that bound, and what this design does about each:
//   * synchronous K/V loads between two barriers, nothing in flight during
//     the products -> a producer warpgroup streams K and V tiles with TMA
//     into a ring of kStages stages under full/empty mbarriers, while the
//     consumer warpgroups compute on earlier stages;
//   * V gathered by 16-bit shared loads -> V stays in shared memory as
//     TMA wrote it and is read by the tensor cores as a transposed
//     (MN-major) wgmma operand;
//   * mma.sync m16n8k16 -> wgmma, asynchronous, from swizzled shared memory
//     (S = Q K^T, m64n64k16) and from registers (O += P V, m64nDVk16);
//   * 64 query rows a block -> 128 rows, two consumer warpgroups of 64.
// What still holds it back (chip_smoke.py times it; PERF.md): each
// warpgroup alternates between its products and its softmax (exp2 and
// some 5 other operations a score), and the two warpgroups are not
// scheduled against each other, so the tensor cores idle while both run
// softmax; the products' own issue also stalls.
//
// Design.  A work item is (batch, kv head, bq = 128 / G query positions,
// rounded down), bq * G query rows.  A row is a (query position, group)
// pair, row = position * G + g, so all G query heads of a kv head share
// each K/V tile.  Where G does not divide 128 (G = 6: bq = 21, 126 rows)
// rows bq * G .. 127 of the tile are not loaded: they hold whatever the Q
// buffer held before.  They are computed like the others (each row's
// scores, softmax and output are its own, so nothing of theirs reaches a
// loaded row) and never written.  The kernel is persistent: one
// CTA of 3 warpgroups per SM walks items blockIdx.x, + gridDim.x, ..., in
// an order that puts the last (longest, under the causal mask) query tiles
// first.  Warpgroups 0 and 1 (setmaxnreg 232) each own 64 rows of an item;
// warpgroup 2 (setmaxnreg 40) is the producer, of which one thread issues
// every copy.  For each item the producer loads the Q tile (D / 64
// 64-column boxes of (64, G, bq): 64 KB at D 256, 48 KB at D 192, 32 KB at
// D 128, 16 KB at D 64) into one of kQBufs Q buffers, and for each kv tile
// of kKv = 64 keys K (32, 24, 16 or 8 KB) and V (32, 16, 16 or 8 KB) into
// the next stage of a ring of kStages (Smem): up to D = 192 two Q buffers
// and 3 stages (216 KB of shared memory in all at (192, 128), 160 KB at
// (128, 128), 81 KB at (64, 64)); at (256, 256), where that plan would
// take 320 KB of the 227 a block has, one Q buffer and 2 stages (193 KB),
// so the next item's Q loads only once both warpgroups have issued their
// last scores, and a stage is refilled only after both are done with the
// tile two back.  All 128-byte
// swizzled, through 4-D tensor maps over (width, head, position, batch) so
// that rows past Sq or Skv are zero-filled.  Ring and Q buffers run on
// across items, so the next item's loads overlap the current one.  A
// consumer warpgroup computes S = Q K^T (D / 16 wgmma k-steps) and runs the
// online softmax on S in f32 registers (running max m and sum l in the
// log2 domain: one FFMA and one ex2 a score), which leaves P rounded to
// bf16 in registers: the S accumulator's fragment of each 16 keys is
// exactly wgmma's register A fragment.  Then, for each tile j, it issues
// O += P_j V_j (4 k-steps) together with S_{j+1} = Q K_{j+1}^T, waits for
// both, releases stage j (each consumer warp arrives on its empty
// barrier) and runs tile j + 1's softmax.  Between a product's issue and
// its wait no other instruction touches an accumulator, or ptxas would
// serialize every wgmma of the kernel (its warning C7514).  Registers: the
// O accumulator is DV / 2 f32 a thread, 128 at DV 256, beside S (32) and
// P (16); every width compiles to 168 registers with setmaxnreg 232 for
// the consumers and spills nothing (ptxas -v), so the overlap of S_{j+1}
// with O += P_j V_j is kept at D 256 too.  Causal: an item's kv tiles stop
// at its last query row; a warpgroup skips the products of a tile wholly
// above its own rows, and masks only a tile that crosses its diagonal or
// the end of Skv.  Window: an item's kv tiles start at the tile of its
// first position's first key, max(0, q0 - W + 1) / kKv (the producer loads
// none below); a warpgroup waits for and releases, without products, the
// item's tiles wholly below its own first row's window, and masks only a
// tile that also reaches down to its last row's window edge.  The items
// keep their order, the last query tiles first: under a window they cost
// nearly the same.  A row's first tiles may hold none of its keys; a
// masked score is -inf, so they add nothing.  The output is written from
// registers; rows past Sq are not.
//
// Host side: the tensor maps are encoded per call with the driver's
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint (no
// -lcuda), and passed as __grid_constant__ kernel parameters.

#include <cmath>
#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 128;           // query rows per CTA
constexpr int kKv = 64;              // keys per kv tile
constexpr int kConsumerThreads = 256;
constexpr int kThreads = kConsumerThreads + 128;
constexpr int kBox = 64;             // bf16 columns per 128-byte swizzle box
constexpr float kNeg = -1e30f;

// ---------------------------------------------------------------------------
// PTX wrappers: shared addresses, mbarriers, TMA, wgmma.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// 4-D tiled TMA load of one box at coordinates (c0, c1, c2, c3), completing
// on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout B128.
__device__ __forceinline__ uint64_t desc_b128(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (uint64_t{1} << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across a
// wgmma issue or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 64, f32) += A B^T: A (64 x 16) and B (64 x 16), bf16, both in
// shared memory, K-major; scale_d = 0 ignores D's old value.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}


// D (64 x 64, f32) += A B: A (64 x 16, bf16) in registers, B (16 x 64,
// bf16) in shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (64 x 128, f32) += A B: A (64 x 16, bf16) in registers, B (16 x 128,
// bf16) in shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (64 x 256, f32) += A B: A (64 x 16, bf16) in registers, B (16 x 256,
// bf16) in shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// 2^x on the special-function unit (one instruction; about 2 ulp).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Online softmax of one kv tile for this thread's two rows.  sc holds the
// tile's raw scores (element e of n8 tile nt: row gid + 8 * (e / 2), key
// kv0 + nt * 8 + tig * 2 + e % 2); with a soft-cap (kCap; cap_in = scale /
// c) each becomes tanh(score * cap_in) first, and scale_log2 is then
// c * log2(e) in place of scale * log2(e); masked where need_mask says so
// (past Skv, past the row's position under the causal mask, at or below the
// row's position - window under a window), they become P = 2^(score *
// scale_log2 - m), packed to bf16 as wgmma's register A fragments (the S
// fragment of keys 16 kk .. 16 kk + 15 is exactly the A fragment of k-step
// kk).  m (log2 domain) and l are the running max and sum; alpha the
// factor by which the output accumulated so far must shrink.  A masked
// score is -inf, whose 2^ is 0 whatever m is: under a window a row's first
// tiles may hold none of its keys, and m then stays finite (near kNeg)
// until a tile does.
template <bool kCap>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[kKv / 2], uint32_t (&pa)[kKv / 16][4], float (&m)[2],
    float (&l)[2], float (&alpha)[2], float scale_log2, float cap_in,
    bool need_mask, int kv0, int skv, bool causal, int window,
    const int (&qpos)[2], int tig) {
  if constexpr (kCap) {
#pragma unroll
    for (int k = 0; k < kKv / 2; ++k) sc[k] = tanhf(sc[k] * cap_in);
  }
  if (need_mask) {
#pragma unroll
    for (int k = 0; k < kKv / 2; ++k) {
      const int kp = kv0 + (k / 4) * 8 + tig * 2 + (k & 1);
      const int qp = qpos[(k >> 1) & 1];
      if (kp >= skv || (causal && kp > qp) ||
          (window > 0 && kp <= qp - window))
        sc[k] = -INFINITY;
    }
  }
  float row_max[2] = {kNeg, kNeg};
#pragma unroll
  for (int k = 0; k < kKv / 2; ++k)
    row_max[(k >> 1) & 1] = fmaxf(row_max[(k >> 1) & 1], sc[k]);
  float neg_m[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row_max[i] = fmaxf(row_max[i],
                       __shfl_xor_sync(0xffffffffu, row_max[i], 1));
    row_max[i] = fmaxf(row_max[i],
                       __shfl_xor_sync(0xffffffffu, row_max[i], 2));
    const float m_new = fmaxf(m[i], row_max[i] * scale_log2);
    alpha[i] = ex2(m[i] - m_new);
    m[i] = m_new;
    neg_m[i] = -m_new;
  }
  float row_sum[2] = {0.f, 0.f};
#pragma unroll
  for (int k = 0; k < kKv / 2; ++k) {
    const int i = (k >> 1) & 1;
    sc[k] = ex2(fmaf(sc[k], scale_log2, neg_m[i]));
    row_sum[i] += sc[k];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row_sum[i] += __shfl_xor_sync(0xffffffffu, row_sum[i], 1);
    row_sum[i] += __shfl_xor_sync(0xffffffffu, row_sum[i], 2);
    l[i] = l[i] * alpha[i] + row_sum[i];
  }
#pragma unroll
  for (int kk = 0; kk < kKv / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
  }
}

// A width rounded up to whole 64-column swizzle boxes: what shared memory
// and the products run at (80 -> 128).
__host__ __device__ constexpr int padded(int width) { return (width + kBox - 1) / kBox * kBox; }

// The shared-memory plan of a width (padded): kQBufs Q buffers of kRows
// rows and a ring of kStages K/V stages.  Two Q buffers and 3 stages up to
// D = 192; at D = 256 a Q tile is 64 KB and a K + V stage 64 KB, so one Q
// buffer and 2 stages (192 KB of buffers; the plan of the narrower widths
// would need 320).
template <int D, int DV>
struct Smem {
  static constexpr int kD = padded(D);
  static constexpr int kDV = padded(DV);
  static constexpr int kQBufs = kD > 192 ? 1 : 2;
  static constexpr int kStages = kD > 192 ? 2 : 3;
  static constexpr int kQBytes = kRows * kD * 2;         // kD / 64 boxes
  static constexpr int kKBytes = kKv * kD * 2;
  static constexpr int kVBytes = kKv * kDV * 2;
  static constexpr int kStageBytes = kKBytes + kVBytes;
  static constexpr int kKvOffset = kQBufs * kQBytes;
  static constexpr int kBarOffset = kKvOffset + kStages * kStageBytes;
  // q_full[kQBufs], q_empty[kQBufs], full[kStages], empty[kStages]; plus
  // 1 KB to align the base.
  static constexpr int kBytes =
      kBarOffset + 8 * (2 * kQBufs + 2 * kStages) + 1024;
  static_assert(kBytes <= 232448, "more shared memory than a block has");
};

template <int D, int DV, bool kCap>
__global__ void __launch_bounds__(kThreads, 1)
flash_kernel(const __grid_constant__ CUtensorMap tm_q,
             const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v,
             __nv_bfloat16* __restrict__ out, int batch, int sq, int skv,
             int h, int hkv, int causal, int window, int q_offset,
             float scale_log2, float cap_in) {
  using S = Smem<D, DV>;
  // D and DV are the tensors' widths; kD and kDV, whole boxes, the widths
  // shared memory and the products run at (columns past D or DV arrive as
  // zeros).
  constexpr int kD = S::kD;
  constexpr int kDV = S::kDV;
  static_assert(D % 8 == 0 && DV % 8 == 0,
                "16-byte rows for TMA and 8-column groups for the store");
  static_assert(kKv == 64 && (kDV == 64 || kDV == 128 || kDV == 256),
                "the wgmma wrappers are n64 (scores) and n64, n128 or n256 "
                "(output)");
  constexpr int kQBufs = S::kQBufs;
  constexpr int kStages = S::kStages;
  constexpr int kBoxBytes = kBox * 2;                    // 128-byte rows
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled tiles need 1024-byte-aligned addresses.
  unsigned char* smem =
      smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  unsigned char* q_s = smem;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::kBarOffset);
  uint64_t* q_full = bars;                  // per Q buffer
  uint64_t* q_empty = bars + kQBufs;
  uint64_t* full = bars + 2 * kQBufs;       // per stage
  uint64_t* empty = full + kStages;

  // Work item i: query tile n_q - 1 - i / (batch * hkv) (the last, longest
  // tiles first) of (batch, kv head) i % (batch * hkv).  The CTA takes
  // items blockIdx.x, blockIdx.x + gridDim.x, ...  Its kv tiles are
  // [first, last): under the causal mask they end at its last query
  // position's tile, under a window they start at the tile of its first
  // position's first key, q_offset + q0 - window + 1 (the launch checks
  // that every query sees a key, so first < last).
  const int g_count = h / hkv;
  const int bq = kRows / g_count;               // query positions per item
  const int q_rows = bq * g_count;              // rows loaded: 128 - 128 % G
  const int n_bh = batch * hkv;
  const int n_q = (sq + bq - 1) / bq;
  const int n_items = n_bh * n_q;
  const int n_tiles = (skv + kKv - 1) / kKv;
  struct Item {
    int kvh, b, q0, first, last;
  };
  auto item = [&](int i) {
    Item it;
    it.kvh = (i % n_bh) % hkv;
    it.b = (i % n_bh) / hkv;
    it.q0 = (n_q - 1 - i / n_bh) * bq;
    const int last_pos = q_offset + min(it.q0 + bq, sq) - 1;
    it.last = causal ? min(n_tiles, last_pos / kKv + 1) : n_tiles;
    it.first = window > 0 ? max(0, q_offset + it.q0 - window + 1) / kKv : 0;
    return it;
  };

  if (threadIdx.x == 0) {
    for (int qb = 0; qb < kQBufs; ++qb) {
      mbar_init(&q_full[qb], 1);
      mbar_init(&q_empty[qb], kConsumerThreads / 32);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {
    // Producer warpgroup: one thread issues every copy.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumerThreads) {
      // tc counts kv tiles over all of the CTA's items (the ring's
      // position), ic the items (Q buffer ic % kQBufs, its use
      // ic / kQBufs).
      int tc = 0, ic = 0;
      for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++ic) {
        const Item it = item(i);
        const int qb = ic % kQBufs;
        if (ic >= kQBufs)
          mbar_wait(&q_empty[qb], ((ic / kQBufs) - 1) & 1);
        // The boxes' bytes, which are the buffer's only where G divides 128.
        mbar_expect_tx(&q_full[qb], q_rows * kD * 2);
        for (int c = 0; c < kD / kBox; ++c)
          tma_load_4d(q_s + qb * S::kQBytes + c * kRows * kBoxBytes, &tm_q,
                      &q_full[qb], c * kBox, it.kvh * g_count, it.q0, it.b);
        for (int j = it.first; j < it.last; ++j, ++tc) {
          const int s = tc % kStages;
          if (tc >= kStages) mbar_wait(&empty[s], ((tc / kStages) - 1) & 1);
          unsigned char* k_s = smem + S::kKvOffset + s * S::kStageBytes;
          unsigned char* v_s = k_s + S::kKBytes;
          mbar_expect_tx(&full[s], S::kStageBytes);
          for (int c = 0; c < kD / kBox; ++c)
            tma_load_4d(k_s + c * kKv * kBoxBytes, &tm_k, &full[s],
                        c * kBox, it.kvh, j * kKv, it.b);
          for (int c = 0; c < kDV / kBox; ++c)
            tma_load_4d(v_s + c * kKv * kBoxBytes, &tm_v, &full[s],
                        c * kBox, it.kvh, j * kKv, it.b);
        }
      }
    }
    return;
  }

  // Consumer warpgroups.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int gid = lane / 4;                     // accumulator row group
  const int tig = lane % 4;                     // thread in group
  int row[2];
  for (int i = 0; i < 2; ++i) row[i] = wg * 64 + warp * 16 + gid + 8 * i;

  int tc = 0, ic = 0;   // kv tiles and items before this one, as the producer
  for (int item_i = blockIdx.x; item_i < n_items;
       item_i += gridDim.x, ++ic) {
    const Item it = item(item_i);
    const int qb = ic % kQBufs;
    const uint32_t q_base =
        smem_addr(q_s + qb * S::kQBytes) + wg * 64 * kBoxBytes;
    // The rows' query indices and their positions, q_offset + index.
    int qidx[2], qpos[2];
    for (int i = 0; i < 2; ++i) {
      qidx[i] = it.q0 + row[i] / g_count;
      qpos[i] = q_offset + qidx[i];
    }
    const int wg_first = it.q0 + (wg * 64) / g_count;
    const int wg_last =
        min(it.q0 + min(wg * 64 + 63, q_rows - 1) / g_count, sq - 1);
    const int wg_first_pos = q_offset + wg_first;
    const int wg_last_pos = q_offset + wg_last;
    // This warpgroup's tiles [w0, nw): under the causal mask, up to its
    // last row; under a window, from the tile of its first row's first
    // key.  The item's other tiles it only waits for and releases.
    const int nw = wg_first >= sq ? 0
                   : causal       ? min(it.last, wg_last_pos / kKv + 1)
                                  : it.last;
    const int w0 =
        nw == 0 || window == 0
            ? it.first
            : max(it.first, max(0, wg_first_pos - window + 1) / kKv);
    auto stage_of = [&](int j) { return (tc + j - it.first) % kStages; };
    auto wait_tile = [&](int j) {
      mbar_wait(&full[stage_of(j)], ((tc + j - it.first) / kStages) & 1);
    };
    auto release_tile = [&](int j) {   // this warp is done with tile j
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage_of(j)]);
    };
    auto release_q = [&] {   // this warp no longer reads the item's Q
      __syncwarp();
      if (lane == 0) mbar_arrive(&q_empty[qb]);
    };
    auto k_addr = [&](int j) {
      return smem_addr(smem + S::kKvOffset + stage_of(j) * S::kStageBytes);
    };
    // S = Q K^T for tile j into sc: kD / 16 k-steps, committed, not waited.
    auto issue_scores = [&](float (&sc)[kKv / 2], int j) {
      const uint32_t k_base = k_addr(j);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < kD / kBox; ++c) {
#pragma unroll
        for (int kk = 0; kk < kBox / 16; ++kk) {
          wgmma_ss(sc,
                   desc_b128(q_base + c * kRows * kBoxBytes + kk * 32, 16,
                             1024),
                   desc_b128(k_base + c * kKv * kBoxBytes + kk * 32, 16,
                             1024),
                   c + kk > 0);   // the first k-step overwrites sc
        }
      }
      wgmma_commit();
    };
    // Tile j needs the mask where it runs past Skv, crosses the diagonal
    // of this warpgroup's first row, or (under a window) reaches down to
    // the lower edge of its last row's window.
    auto need_mask = [&](int j) {
      return (j + 1) * kKv > skv ||
             (causal && (j + 1) * kKv - 1 > wg_first_pos) ||
             (window > 0 && j * kKv <= wg_last_pos - window);
    };

    float m[2] = {kNeg, kNeg};
    float l[2] = {0.f, 0.f};
    float alpha[2];
    float o[kDV / 2];   // the m64nkDV accumulator: kDV / 2 f32 a thread
#pragma unroll
    for (int i = 0; i < kDV / 2; ++i) o[i] = 0.f;
    float sc[kKv / 2];
    uint32_t pa[kKv / 16][4];

    mbar_wait(&q_full[qb], (ic / kQBufs) & 1);
    if (nw == 0) release_q();
    for (int j = it.first; j < w0; ++j) {   // wholly below the window
      wait_tile(j);
      release_tile(j);
    }
    if (nw > 0) {
      wait_tile(w0);
      issue_scores(sc, w0);
      wgmma_wait<0>();
      fence_regs(sc);
      if (nw == w0 + 1) release_q();
      softmax_tile<kCap>(sc, pa, m, l, alpha, scale_log2, cap_in,
                         need_mask(w0), w0 * kKv, skv, causal, window, qpos,
                         tig);
    }
    // Tile j's P V product and tile j + 1's scores go to the tensor cores
    // together; tile j + 1's softmax follows once both are done (and
    // overlaps the other warpgroup's products).
    for (int j = w0; j < nw; ++j) {
#pragma unroll
      for (int nt = 0; nt < kDV / 8; ++nt) {
        o[nt * 4 + 0] *= alpha[0];
        o[nt * 4 + 1] *= alpha[0];
        o[nt * 4 + 2] *= alpha[1];
        o[nt * 4 + 3] *= alpha[1];
      }
      fence_regs(o);
      if (j + 1 < nw) {
        wait_tile(j + 1);
        issue_scores(sc, j + 1);
      }
      // O += P V, V transposed from shared memory (at kDV 64 one swizzle
      // box, so the leading byte offset to the next box is not read).
      const uint32_t v_base = k_addr(j) + S::kKBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKv / 16; ++kk) {
        wgmma_rs(o, pa[kk],
                 desc_b128(v_base + kk * 16 * kBoxBytes, kKv * kBoxBytes,
                           1024));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      release_tile(j);
      if (j + 1 < nw) {
        fence_regs(sc);
        if (j + 2 == nw) release_q();
        softmax_tile<kCap>(sc, pa, m, l, alpha, scale_log2, cap_in,
                           need_mask(j + 1), (j + 1) * kKv, skv, causal,
                           window, qpos, tig);
      }
    }
    for (int j = nw > 0 ? nw : w0; j < it.last; ++j) {
      wait_tile(j);
      release_tile(j);
    }
    tc += it.last - it.first;

    // The real width's DV / 8 column groups of each row (the padded
    // columns past DV hold zeros and are not written).
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (row[i] >= q_rows || qidx[i] >= sq) continue;
      const int head = it.kvh * g_count + row[i] % g_count;
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
      __nv_bfloat16* op =
          out +
          ((static_cast<int64_t>(it.b) * sq + qidx[i]) * h + head) * DV;
#pragma unroll
      for (int nt = 0; nt < DV / 8; ++nt) {
        *reinterpret_cast<uint32_t*>(op + nt * 8 + tig * 2) =
            pack_bf16(o[nt * 4 + 2 * i] * inv, o[nt * 4 + 2 * i + 1] * inv);
      }
    }
  }
}

// The driver's cuTensorMapEncodeTiled, reached through the runtime.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault) == cudaSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Map over a (batch, seq, heads, width) bf16 tensor, as dimensions
// (width, heads, seq, batch), boxes of (64, box_heads, box_rows, 1) with
// 128-byte swizzle; coordinates past the tensor read as zero.
bool make_map(CUtensorMap* map, const void* ptr, int batch, int seq,
              int heads, int width, int box_heads, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(width),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(width) * 2,
      static_cast<cuuint64_t>(heads) * width * 2,
      static_cast<cuuint64_t>(seq) * heads * width * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kBox),
                             static_cast<cuuint32_t>(box_heads),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One instantiation's launch: kCap with a soft-cap, its own without.
template <int D, int DV, bool kCap>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int sq, int skv, int h, int hkv, int causal, int window,
           int q_offset, float scale, float softcap, cudaStream_t stream) {
  const int g_count = h / hkv;
  const int bq = kRows / g_count;   // the Q box: (64, G, bq), bq * G <= 128
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_map(&tm_q, q, b, sq, h, D, g_count, bq) ||
      !make_map(&tm_k, k, b, skv, hkv, D, 1, kKv) ||
      !make_map(&tm_v, v, b, skv, hkv, DV, 1, kKv)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int kSmem = Smem<D, DV>::kBytes;
  // Per device and instantiation, once: the shared-memory opt-in and the
  // SM count.
  static int sms[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms[device] == 0) {
    err = cudaFuncSetAttribute(flash_kernel<D, DV, kCap>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms[device],
                                 cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // Persistent: one CTA per SM (the shared memory admits one), each
  // walking its share of the work items.
  const int n_items = b * hkv * ((sq + bq - 1) / bq);
  const int grid = n_items < sms[device] ? n_items : sms[device];
  // Without a soft-cap the scores are scaled by scale * log2(e) inside the
  // exponent, as before; with one, tanh(score * scale / c) is scaled by
  // c * log2(e).
  const float log2e = 1.4426950408889634f;
  flash_kernel<D, DV, kCap><<<grid, kThreads, kSmem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(out), b, sq, skv, h, hkv,
      causal, window, q_offset, (kCap ? softcap : scale) * log2e,
      kCap ? scale / softcap : 0.f);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int DV>
int launch_width(const void* q, const void* k, const void* v, void* out,
                 int b, int sq, int skv, int h, int hkv, int causal,
                 int window, int q_offset, float scale, float softcap,
                 cudaStream_t stream) {
  return softcap > 0.f
             ? launch<D, DV, true>(q, k, v, out, b, sq, skv, h, hkv, causal,
                                   window, q_offset, scale, softcap, stream)
             : launch<D, DV, false>(q, k, v, out, b, sq, skv, h, hkv, causal,
                                    window, q_offset, scale, softcap, stream);
}

}  // namespace

// Plain C entry point, loaded with ctypes.  q (b, sq, h, d), k (b, skv, hkv,
// d), v (b, skv, hkv, dv), out (b, sq, h, dv): bf16, C-contiguous, 16-byte
// aligned, on the current device; hkv divides h and h / hkv <= 128.
// (d, dv) is (192, 128), the MLA widths, or (64, 64), (128, 128),
// (256, 256) or (80, 80), the dense GQA widths; another width is one more
// instantiation of the template (multiples of 8, padded to whole 64-column
// boxes, a wgmma wrapper of n = the padded dv, a shared-memory plan that
// fits), and until then returns cudaErrorInvalidValue.  Query i sits at
// position q_offset + i (q_offset >= 0).  window > 0 (causal only) keeps
// the keys of positions p - window + 1 .. p, and every query must see one;
// 0 keeps all.  softcap > 0 caps the scaled scores at softcap * tanh(s /
// softcap); 0 leaves them.  Returns the launch's cudaError_t.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int b, int sq,
                                      int skv, int h, int hkv, int d, int dv,
                                      int causal, int window, int q_offset,
                                      float scale, float softcap,
                                      cudaStream_t stream) {
  if (b == 0 || sq == 0) return 0;
  if (hkv < 1 || h % hkv || h / hkv > kRows || skv < 1 || window < 0 ||
      q_offset < 0 || softcap < 0.f || (window > 0 && !causal) ||
      (window > 0 && q_offset + sq - window >= skv)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (d == 192 && dv == 128)
    return launch_width<192, 128>(q, k, v, out, b, sq, skv, h, hkv, causal,
                                  window, q_offset, scale, softcap, stream);
  if (d == 64 && dv == 64)
    return launch_width<64, 64>(q, k, v, out, b, sq, skv, h, hkv, causal,
                                window, q_offset, scale, softcap, stream);
  if (d == 128 && dv == 128)
    return launch_width<128, 128>(q, k, v, out, b, sq, skv, h, hkv, causal,
                                  window, q_offset, scale, softcap, stream);
  if (d == 256 && dv == 256)
    return launch_width<256, 256>(q, k, v, out, b, sq, skv, h, hkv, causal,
                                  window, q_offset, scale, softcap, stream);
  if (d == 80 && dv == 80)
    return launch_width<80, 80>(q, k, v, out, b, sq, skv, h, hkv, causal,
                                window, q_offset, scale, softcap, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
