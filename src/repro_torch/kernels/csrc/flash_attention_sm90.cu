// Flash attention forward on Hopper's tensor cores (bf16), for sm_90a.
//
// Replaces the Pallas kernel of the reference package:
//   flash_fwd_sm90_kernel      <- repro/kernels/flash_attention.py
//                                 flash_attention (pallas_call at :94, body
//                                 _kernel), head dims 1 to 256
//   flash_fwd_sm90_wide_kernel <- the same, every head dim past 256
// for bfloat16 inputs; float32 runs csrc/flash_attention.cu (CUDA cores).
// kernels/flash_attention.py chooses between the two sources by dtype alone.
//
// What it computes: o = softmax(q k^T / sqrt(d)) v per (batch, query head),
// query head h reading kv head h / (Hq / Hkv), with the causal mask
// row >= col counted from position 0, or the prefix-LM mask
// row >= col || (row < P && col < P) when a prefix of P > 0 positions is
// given (head dims up to 256, causal only).  q (B, Sq, Hq, d), k and v
// (B, Sk, Hkv, d), o (B, Sq, Hq, d), all bfloat16 and contiguous; Sq and Sk
// multiples of 64.  The running max m, the running sum l and the
// accumulator stay in float32; the unnormalised probabilities are rounded
// to bfloat16 for the P.V product, as the reference's f32 dot at default
// precision does on the TPU's matrix unit; l sums them before rounding.
//
// What bounds it on the H100: at the serving shape (B 4, Hq 40, Hkv 8,
// S 512, d 128, causal) q, k, v and o are 50 MB, 15 us at 3.35 TB/s, and the
// causal q.k and p.v products are 10.8 GFLOP, 11 us at 989 TFLOP/s in bf16.
// Both bounds are a few microseconds per SM, so what decides the time is
// how soon the tensor cores are fed after a block starts and how little
// else they wait for.  At d 256 (the same shape) the bytes are 100.7 MB,
// 30 us, and the products 21.5 GFLOP, 22 us.
//
// What the design does about that (FlashAttention-3's shape):
// * A persistent grid of one block of three warpgroups per SM walks the
//   units of work (128 query rows of one head of one batch element) in
//   snake order, the longest causal loops in the first round.  Warpgroup 0
//   is the producer: it gives up its registers (setmaxnreg) and one thread
//   issues every load, running ahead into the next unit, so a unit's Q, K
//   and V arrive while the one before it computes.  Warpgroups 1 and 2
//   are consumers of 64 query rows each; while one computes its softmax
//   the other's products keep the tensor cores busy.  (Making them take
//   turns at issuing wgmma, with named barriers as FlashAttention-3 does,
//   did not help at these shapes.)
// * The Tensor Memory Accelerator moves the tiles.  q, k and v are mapped
//   as 4-D tensors (d, H, S, B), so the sequence edge is per batch element
//   and rows past it arrive as zeros.  A tile is d / 64 boxes of 64
//   columns (128 bytes, the 128-byte swizzle span).  K and V tiles of
//   Layout<D>::kBN rows (128; 64 at d 256) pass through a ring of kStages
//   stages, each with a full mbarrier for K, one for V (Q K^T starts
//   before V lands) and an empty one.  Q, read once from device memory, is
//   prefetched into L2 one unit ahead.  At d = 128 the block holds Q 32 KB,
//   the ring 2 x (32 + 32) KB and two 16 KB output tiles; at d = 256 Q
//   64 KB, the ring 2 x (32 + 32) KB and two 16 KB output half-tiles,
//   225 KB of the 227 KB a block may have.
// * A head dim d runs the smallest instantiation D >= d of 64, 128 and
//   256 (d 16 and 32 the d 64 one, zamba2-2.7b's d 80 the d 128 one), on
//   maps whose inner extent and row stride are the row width ld: d itself
//   where it is a multiple of 8, else d padded with zero columns by the
//   wrapper, since TMA takes rows 16 bytes apart.  A box of 64 columns
//   reads zeros past column ld, which add nothing to Q K^T or P V, and the
//   store writes nothing past it; the scale stays 1/sqrt(d).  At d 16 and
//   32 half or more of the tensor work is spent on the zeros, at d 80 three
//   eighths; a tile of 32- or 64-byte swizzle would not be.
// * S = Q K^T is wgmma m64nNk16 (N = kBN) with both operands in shared
//   memory, K read K-major as it lies.  The online softmax runs on the
//   accumulator fragment in registers; a row's max is reduced over the
//   four threads that hold it, its sum only once at the end.  The causal mask and the
//   key edge (keys at or past Sk arrive as zeros, not -inf) are applied
//   only on tiles that reach the diagonal or the edge; at 64-key tiles the
//   first consumer skips the block's last causal tile, which lies wholly
//   above its rows.
// * With a prefix of P positions a unit whose rows start below P walks the
//   kv tiles up to the later of its diagonal and the last tile that holds
//   a key below P; the mask keeps a key past the diagonal only for rows
//   and keys both below P (it masks col > max(row, P - 1)), and at 64-key
//   tiles a consumer skips a tile past its diagonal
//   only where its rows or the tile's keys all lie at or past P.  So a
//   tile is skipped by at most one of the two consumers, and the other
//   waits for its V before the stage is given back.  Rows at or past P
//   see the causal mask alone, and the units keep their order (the longest
//   causal loops first; the prefix lengthens the loops of the first P
//   rows).
// * O += P V is wgmma with P converted to bf16 in registers as the A
//   operand and V read MN-major from shared memory (the transpose flag);
//   at d 256 one m64n256k16 a k16 step, its 128 accumulators a thread
//   beside S's 32 within the consumers' 240 registers.
// * The epilogue divides by l and writes bf16 into the consumer's output
//   tile in shared memory, swizzled as the output's tensor map reads it;
//   one TMA store per box sends it out while the consumer starts its next
//   unit (at d 256 in two halves through one buffer of two boxes).  TMA
//   writes no row at or past Sq (the zero-filled half of a 64-row tail).
//
// Past head dim 256 (flash_fwd_sm90_wide_kernel, instantiations 320, 384,
// 448 and 512, the smallest D >= ld; past 512 the slices below):
// * Why not another instantiation of the kernel above: at d 256 it fills
//   225 KB of shared memory, and each consumer keeps O's 128 accumulators a
//   thread beside S's 32.  So a unit is 64 query rows, and its two
//   consumers split O's columns in whole boxes of 64 (d 320: 192 and 128,
//   at most 256 each, 128 accumulators a thread).  Both need all of P, and
//   each computes S = Q K^T itself: the tensor cores do 1.5 times the
//   products (at d 320, causal, 0.027 ms of them at 989 TFLOP/s against a
//   byte bound of 0.038 ms), where splitting the contraction would trade
//   the extra products for an exchange of partial scores through shared
//   memory under a named barrier on every kv tile.  The scores are still
//   computed once a unit, not once for each slice of the output.
// * Shared memory: Q 64 x D and a ring of two stages of K and V tiles.
//   64-key tiles at D 320 (Q 40 KB + 2 x (40 + 40) KB = 200 KB); 32-key
//   tiles past it, where two 64-key stages no longer fit (D 512: Q 64 KB +
//   2 x (32 + 32) KB).  sm90_tile in kernels/flash_attention.py says so.
// * The epilogue writes O / l in bf16 from the registers straight to device
//   memory (no staging buffer is left); columns at or past ld not at all.
// * Past 512 the output is cut into n = ceil(ld / 512) slices of a
//   multiple of 64 columns, each a unit of its own, the instantiation the
//   slice width; each computes S again over the whole row, reading q and k
//   in n chunks of D columns: Q's chunk is loaded again beside each K
//   tile's chunk, one ring stage a chunk, V with the last.  So S is
//   computed n times, not once for every 128 columns.
// * A row that is no multiple of 8 is padded by the wrapper to one that is
//   (a copy of q, k and v), as below 256.
// * What holds it (tools/attention_parts.py cuts parts out of its loop): the
//   TMA pipeline alone, consumers only waiting for each stage and giving it
//   back, takes most of its time; a second copy of S or the P V products add
//   little.  A unit of 64 rows reads each K and V tile for 64 rows only, and
//   the accumulators of 128 rows would not fit the registers past d 320.
//   Tried and dropped, no faster or slower on the H100 than the kept kernel
//   in one call: two Q slots (the next unit's Q loaded early), three or four
//   ring stages where they fit, and 32- or 16-key tiles at d 320.
//
// The C entry point builds the four tensor maps on the host on every call
// (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so the
// library links no driver library), launches on the given stream, does not
// synchronise, and returns cudaGetLastError() (cudaErrorInvalidValue for a
// shape it does not take).

#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;          // query rows per block (two warpgroups)
constexpr int kStages = 2;        // K/V ring depth
constexpr int kThreads = 384;     // producer + two consumer warpgroups
constexpr int kSpan = 128;        // bytes of one swizzled row: 64 bf16
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -----------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// ---- TMA -----------------------------------------------------------------
// One box of a 4-D tensor map into shared memory; completion is counted
// in bytes on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// A box of a 4-D tensor map from shared memory back to global memory, as a
// bulk group of this thread; rows past the tensor's edge are not written.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Brings a box of a 4-D tensor map into L2 ahead of its load.
__device__ __forceinline__ void tma_prefetch_4d(const CUtensorMap* map, int c0,
                                                int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.prefetch.tensor.4d.L2.global [%0, {%1, %2, %3, %4}];"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// This thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
// This thread's bulk stores are complete.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

// ---- wgmma ---------------------------------------------------------------
// Shared-memory matrix descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the fence, commit or wait around it.
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 128, f32) += A (64 x 16, shared) * B (16 x 128, shared), both
// K-major; the sum starts from d when scale_d is 1 and from 0 when it is 0.
__device__ __forceinline__ void wgmma_ss_n128(
    float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64, f32) += A (64 x 16, shared) * B (16 x 64, shared), both
// K-major; the sum starts from d when scale_d is 1 and from 0 when it is 0.
__device__ __forceinline__ void wgmma_ss_n64(
    float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 256, f32) += A (64 x 16, bf16 in registers) * B (16 x 256, shared,
// MN-major: the transpose flag is set), accumulating into d.
__device__ __forceinline__ void wgmma_rs_n256(
    float (&d)[128], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
    uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// d (64 x 128, f32) += A (64 x 16, bf16 in registers) * B (16 x 128, shared,
// MN-major: the transpose flag is set), accumulating into d.
__device__ __forceinline__ void wgmma_rs_n128(
    float (&d)[64], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
    uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// d (64 x 64, f32) += A (64 x 16, bf16 in registers) * B (16 x 64, shared,
// MN-major: the transpose flag is set), accumulating into d.
__device__ __forceinline__ void wgmma_rs_n64(
    float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
    uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// d (64 x 32, f32) += A (64 x 16, shared) * B (16 x 32, shared), both
// K-major; the sum starts from d when scale_d is 1 and from 0 when it is 0.
__device__ __forceinline__ void wgmma_ss_n32(
    float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 192, f32) += A (64 x 16, bf16 in registers) * B (16 x 192, shared,
// MN-major: the transpose flag is set), accumulating into d.
__device__ __forceinline__ void wgmma_rs_n192(
    float (&d)[96], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
    uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// Shared memory of one block: Q | K0 V0 | K1 V1 ... | O of each consumer |
// mbarriers.  Each tile is d / 64 boxes of kBM (Q), kBN (K, V) or 64 (O)
// rows x 128 bytes, each box 1024-byte aligned as the 128-byte swizzle
// requires.  At d 256, 128-row K/V tiles would need 384 KB and an S
// fragment of 64 registers beside the 128 of O, so K and V come in tiles
// of 64 rows, and O goes out in two halves of 128 columns through one
// buffer of two boxes per consumer.
template <int D>
struct Layout {
  static constexpr int kBoxes = D / 64;
  static constexpr int kBN = D > 128 ? 64 : 128;           // K/V rows a tile
  static constexpr int kOBoxes = kBoxes < 2 ? kBoxes : 2;  // O boxes a half
  static constexpr int kHalves = kBoxes / kOBoxes;         // O halves
  static constexpr int kQ = kBoxes * kBM * kSpan;          // Q tile bytes
  static constexpr int kTile = kBoxes * kBN * kSpan;       // K or V tile bytes
  static constexpr int kO = kOBoxes * (kBM / 2) * kSpan;   // one consumer's O
  static constexpr int kOut = kQ + kStages * 2 * kTile;    // O offset
  static constexpr int kBars = kOut + 2 * kO;              // mbarrier offset
  // full_k, full_v and empty per stage, q_full, q_empty; 1 KB of slack to
  // align the base
  static constexpr int kBytes = kBars + (3 * kStages + 2) * 8 + 1024;
  static_assert(kBytes <= 232448, "beyond the H100's shared-memory opt-in");
};

// The mbarriers, by address in shared memory.
struct Barriers {
  uint32_t base;
  __device__ uint32_t full_k(int st) const { return base + 8 * st; }
  __device__ uint32_t full_v(int st) const {
    return base + 8 * (kStages + st);
  }
  __device__ uint32_t empty(int st) const {
    return base + 8 * (2 * kStages + st);
  }
  __device__ uint32_t q_full() const { return base + 8 * (3 * kStages); }
  __device__ uint32_t q_empty() const {
    return base + 8 * (3 * kStages + 1);
  }
};

// One unit of work: 128 query rows of one head of one batch element.  Units
// are numbered so that the longest causal loops come first; block c takes
// unit c of the first round of gridDim.x units, unit gridDim.x - 1 - c of
// the second, and so on in snake order, which pairs long and short loops.
struct Unit {
  int q0, h, b, n_kt;
};

__device__ __forceinline__ int unit_index(int it) {
  return it * gridDim.x + (it & 1 ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}

// With a prefix of P > 0 positions, the kv loop of a unit whose rows start
// below P runs at least to the last tile that holds a key below P.
template <int kBN>
__device__ __forceinline__ Unit unit_of(int w, int n_qt, int hq, int batch,
                                        int sk, int causal, int prefix) {
  const int per_tile = hq * batch;
  Unit u;
  u.q0 = (n_qt - 1 - w / per_tile) * kBM;
  u.h = w % per_tile % hq;
  u.b = w % per_tile / hq;
  u.n_kt = (sk + kBN - 1) / kBN;
  if (causal) {
    int end = (u.q0 + kBM - 1) / kBN + 1;
    if (u.q0 < prefix) end = max(end, (prefix + kBN - 1) / kBN);
    u.n_kt = min(u.n_kt, end);
  }
  return u;
}

// Named barriers 1 and 2 each join the 128 threads of one consumer.
__device__ __forceinline__ void consumer_sync(int cw) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + cw) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Accumulator fragment of wgmma m64nNk16 (f32): value i of a thread of warp
// w, lane t lies at row 16 w + t / 4 + 8 ((i / 2) % 2) and column
// 8 (i / 4) + 2 (t % 4) + i % 2 of the 64 x N tile.  The bf16 A operand of
// a k16 step takes values 8 kk .. 8 kk + 7 of a 64 x 128 fragment, packed
// in pairs: the two layouts agree, so P needs no shuffle.
//
// The grid is persistent: each block walks its units (unit_index).  The
// producer runs ahead across units (the K/V ring's stage and phase count on
// from unit to unit), and loads the next unit's Q as soon as both
// consumers have issued their last Q K^T of the current one.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap to, int batch,
                          int hq,
                          int hkv, int sq, int sk, int causal, int prefix,
                          float scale_log2) {
  using L = Layout<D>;
  constexpr int kBN = L::kBN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const Barriers bar{base + L::kBars};
  const int n_qt = (sq + kBM - 1) / kBM;
  const int units = n_qt * hq * batch;
  const int group = hq / hkv;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar.full_k(st), 1);                  // the producer
      mbar_init(bar.full_v(st), 1);
      mbar_init(bar.empty(st), 2);                   // both consumers
    }
    mbar_init(bar.q_full(), 1);
    mbar_init(bar.q_empty(), 2);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      int g = 0;                                     // K/V tiles so far
      for (int it = 0; unit_index(it) < units; ++it) {
        const Unit u = unit_of<kBN>(unit_index(it), n_qt, hq, batch, sk, causal,
                                    prefix);
        const int hk = u.h / group;
        mbar_wait(bar.q_empty(), (it & 1) ^ 1);
        mbar_arrive_expect_tx(bar.q_full(), L::kQ);
        for (int c = 0; c < L::kBoxes; ++c)
          tma_load_4d(q_s + c * kBM * kSpan, &tq, bar.q_full(), 64 * c, u.h,
                      u.q0, u.b);
        // the next unit's Q, read once from device memory, into L2 now
        if (unit_index(it + 1) < units) {
          const Unit n = unit_of<kBN>(unit_index(it + 1), n_qt, hq, batch,
                                      sk, causal, prefix);
          for (int c = 0; c < L::kBoxes; ++c)
            tma_prefetch_4d(&tq, 64 * c, n.h, n.q0, n.b);
        }
        for (int j = 0; j < u.n_kt; ++j, ++g) {
          const int st = g % kStages;
          const uint32_t k_s = base + L::kQ + st * 2 * L::kTile;
          mbar_wait(bar.empty(st), ((g / kStages) & 1) ^ 1);
          mbar_arrive_expect_tx(bar.full_k(st), L::kTile);
          for (int c = 0; c < L::kBoxes; ++c)
            tma_load_4d(k_s + c * kBN * kSpan, &tk, bar.full_k(st), 64 * c,
                        hk, j * kBN, u.b);
          mbar_arrive_expect_tx(bar.full_v(st), L::kTile);
          for (int c = 0; c < L::kBoxes; ++c)
            tma_load_4d(k_s + L::kTile + c * kBN * kSpan, &tv, bar.full_v(st),
                        64 * c, hk, j * kBN, u.b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int cw = wg - 1;
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int col0 = 2 * (lane % 4);
    const uint32_t q_wg = q_s + 64 * cw * kSpan;
    const uint32_t o_wg = base + L::kOut + cw * L::kO;

    int g = 0;
    for (int it = 0; unit_index(it) < units; ++it) {
      const Unit u = unit_of<kBN>(unit_index(it), n_qt, hq, batch, sk, causal,
                                  prefix);
      const int first = u.q0 + 64 * cw;                // this consumer's rows
      const int row0 = first + 16 * warp + lane / 4;   // +8: odd pairs
      // a row's last key: col > max(row, P - 1) is col > row && (row >= P
      // || col >= P), one compare a score as without a prefix
      const int last[2] = {max(row0, prefix - 1), max(row0 + 8, prefix - 1)};
      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

      mbar_wait(bar.q_full(), it & 1);
      for (int j = 0; j < u.n_kt; ++j, ++g) {
        const int st = g % kStages;
        const uint32_t ph = (g / kStages) & 1;
        const uint32_t k_s = base + L::kQ + st * 2 * L::kTile;
        const uint32_t v_s = k_s + L::kTile;

        const int n0 = j * kBN;
        if constexpr (kBN < kBM) {
          // at 64-key tiles a tile past this consumer's diagonal that its
          // mask empties (the block's last causal tile above the first
          // consumer's rows; with a prefix, a tile past the diagonal where
          // the rows or the keys lie at or past P) only gives the stage
          // back, after the stage's load (so its arrival joins that tile's
          // phase); the other consumer never skips the same tile.  At
          // 128-key tiles no unit holds such a tile: its causal tiles end
          // on its diagonal, and a tile past it is there only for keys
          // below P, which both consumers' rows (below q0 + 64 < P) see.
          if (causal && n0 > first + 63 && (first >= prefix || n0 >= prefix)) {
            mbar_wait(bar.full_k(st), ph);
            if (t == 0) {
              if (j == u.n_kt - 1) mbar_arrive(bar.q_empty());
              mbar_arrive(bar.empty(st));
            }
            continue;
          }
        }

        // S = Q K^T over d in k16 steps; a step inside a box moves the
        // start address 32 bytes along the swizzled row.
        float s[kBN / 2];
        mbar_wait(bar.full_k(st), ph);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t q_box = (kk / 4) * kBM * kSpan + (kk % 4) * 32;
          const uint32_t k_box = (kk / 4) * kBN * kSpan + (kk % 4) * 32;
          if constexpr (kBN == 128)
            wgmma_ss_n128(s, smem_desc(q_wg + q_box, 16, 8 * kSpan),
                          smem_desc(k_s + k_box, 16, 8 * kSpan), kk > 0);
          else
            wgmma_ss_n64(s, smem_desc(q_wg + q_box, 16, 8 * kSpan),
                         smem_desc(k_s + k_box, 16, 8 * kSpan), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        hold(s);
        if (j == u.n_kt - 1 && t == 0) mbar_arrive(bar.q_empty());

        if (n0 + kBN > sk || (causal && n0 + kBN - 1 > first)) {
#pragma unroll
          for (int i = 0; i < kBN / 2; ++i) {
            const int col = n0 + 8 * (i / 4) + col0 + i % 2;
            if (col >= sk || (causal && col > last[(i / 2) % 2]))
              s[i] = -INFINITY;
          }
        }

        // online softmax in the log2 domain: m is kept scaled by scale_log2
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i)
          mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
        float mu[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m[r], mx[r] * scale_log2);
          mu[r] = m_new == -INFINITY ? 0.0f : m_new;
          const float alpha = ex2(m[r] - mu[r]);
          m[r] = m_new;
          l[r] *= alpha;
#pragma unroll
          for (int i = 0; i < D / 2; ++i)
            if ((i / 2) % 2 == r) acc[i] *= alpha;
        }
        uint32_t p[kBN / 4];
#pragma unroll
        for (int i = 0; i < kBN / 2; i += 2) {
          const int r = (i / 2) % 2;
          const float p0 = ex2(fmaf(s[i], scale_log2, -mu[r]));
          const float p1 = ex2(fmaf(s[i + 1], scale_log2, -mu[r]));
          l[r] += p0 + p1;
          p[i / 2] = pack_bf16(p0, p1);
        }

        // O += P V over the tile's keys in k16 steps: 16 rows of V lie
        // 2048 bytes apart; the next box of 64 columns is a box further.
        hold(acc);
        hold(p);
        mbar_wait(bar.full_v(st), ph);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk) {
          const uint64_t vd =
              smem_desc(v_s + kk * 16 * kSpan, kBN * kSpan, 8 * kSpan);
          if constexpr (D == 256)
            wgmma_rs_n256(acc, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                          p[4 * kk + 3], vd);
          else if constexpr (D == 128)
            wgmma_rs_n128(acc, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                          p[4 * kk + 3], vd);
          else
            wgmma_rs_n64(acc, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                         p[4 * kk + 3], vd);
        }
        wgmma_commit();
        wgmma_wait_all();
        hold(acc);
        if (t == 0) mbar_arrive(bar.empty(st));      // the stage is free
      }

      // epilogue: the row sums over the four threads of a row, then O / l
      // in bf16 into this consumer's buffer (swizzled as the O map reads
      // it), stored by TMA while the consumer goes on to its next unit; at
      // d 256 in two halves of 128 columns, the second written once the
      // store of the first has read the buffer
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        l[r] = 1.0f / l[r];
      }
      constexpr int kPerHalf = D / 2 / L::kHalves;   // acc values a half
#pragma unroll
      for (int hf = 0; hf < L::kHalves; ++hf) {
        if (t == 0) bulk_wait_read();               // the last store has read
        consumer_sync(cw);
#pragma unroll
        for (int i = hf * kPerHalf; i < (hf + 1) * kPerHalf; i += 2) {
          const int r = (i / 2) % 2;
          const int row = 16 * warp + lane / 4 + 8 * r;
          const int col = 8 * (i / 4) + col0 - 64 * L::kOBoxes * hf;
          st_shared(o_wg + (col / 64) * (kBM / 2) * kSpan + row * kSpan +
                        (((col % 64) / 8) ^ (row % 8)) * 16 + (col % 8) * 2,
                    pack_bf16(acc[i] * l[r], acc[i + 1] * l[r]));
        }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        consumer_sync(cw);
        if (t == 0) {
          for (int c = 0; c < L::kOBoxes; ++c)
            tma_store_4d(&to, o_wg + c * (kBM / 2) * kSpan,
                         64 * (L::kOBoxes * hf + c), u.h, u.q0 + 64 * cw,
                         u.b);
          bulk_commit();
        }
      }
    }
    if (t == 0) bulk_wait();
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A (batch, seq, heads, d) bf16 tensor as the 4-D map (d, heads, seq,
// batch), boxes of 64 columns x 1 head x `rows` rows x 1 batch element,
// 128-byte swizzle; loads read zeros past each edge, stores write nothing.
bool make_map(CUtensorMap* map, const void* ptr, int d, int heads, int seq,
              int batch, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t row = static_cast<cuuint64_t>(d) * sizeof(__nv_bfloat16);
  const cuuint64_t strides[3] = {row, row * heads, row * heads * seq};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// D is the instantiation, ld (<= D) the row width in memory and d (<= ld)
// the caller's head dim: the maps span ld columns, the boxes' columns past
// ld load as zeros, and the scale is 1/sqrt(d).
template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int d,
           int ld, int b, int hq, int hkv, int sq, int sk, int causal,
           int prefix, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mo;
  if (!make_map(&mq, q, ld, hq, sq, b, kBM) ||
      !make_map(&mk, k, ld, hkv, sk, b, Layout<D>::kBN) ||
      !make_map(&mv, v, ld, hkv, sk, b, Layout<D>::kBN) ||
      !make_map(&mo, o, ld, hq, sq, b, kBM / 2))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = Layout<D>::kBytes;
  // per device, set once: the shared-memory opt-in and the SM count
  static int sms[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms[device] == 0) {
    int count = 0;
    err = cudaFuncSetAttribute(flash_fwd_sm90_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err != cudaSuccess) return static_cast<int>(err);
    sms[device] = count;
  }
  const long long units =
      static_cast<long long>((sq + kBM - 1) / kBM) * hq * b;
  if (units > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(units < sms[device] ? units : sms[device]);
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(d));
  flash_fwd_sm90_kernel<D><<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, mo, b, hq, hkv, sq, sk, causal, prefix, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// ---- head dims past 256 --------------------------------------------------
// A unit is 64 query rows of one head of one batch element (and one slice of
// the output columns past kWidest).  Both consumers take the unit's 64 rows:
// each computes S = Q K^T itself and keeps its own softmax, and each owns
// half of the output columns, whole boxes of 64 (consumer 0 the larger half
// when the boxes are odd).  K and V tiles hold WideLayout<D>::kBN keys.
constexpr int kWideBM = 64;       // query rows a unit
constexpr int kWidest = 512;      // the widest instantiation

template <int D>
struct WideLayout {
  static constexpr int kBoxes = D / 64;
  static constexpr int kBN = D > 320 ? 32 : 64;            // K/V rows a tile
  static constexpr int kBoxes0 = (kBoxes + 1) / 2;         // consumer 0's O
  static constexpr int kBoxes1 = kBoxes - kBoxes0;         // consumer 1's O
  static constexpr int kQ = kBoxes * kWideBM * kSpan;      // Q chunk bytes
  static constexpr int kTile = kBoxes * kBN * kSpan;       // K or V tile bytes
  static constexpr int kBars = kQ + kStages * 2 * kTile;   // mbarrier offset
  static constexpr int kBytes = kBars + (3 * kStages + 2) * 8 + 1024;
  static_assert(kBytes <= 232448, "beyond the H100's shared-memory opt-in");
};

struct WideUnit {
  int q0, h, b, sl, n_kt;
};

// Units are numbered as unit_of's, the slices of one query tile and head
// side by side.
template <int kBN>
__device__ __forceinline__ WideUnit wide_unit_of(int w, int n_qt, int hq,
                                                 int batch, int n_sl, int sk,
                                                 int causal) {
  const int per_tile = hq * batch * n_sl;
  const int r = w % per_tile;
  WideUnit u;
  u.q0 = (n_qt - 1 - w / per_tile) * kWideBM;
  u.sl = r % n_sl;
  u.h = r / n_sl % hq;
  u.b = r / n_sl / hq;
  u.n_kt = (sk + kBN - 1) / kBN;
  if (causal) u.n_kt = min(u.n_kt, (u.q0 + kWideBM - 1) / kBN + 1);
  return u;
}

// O (64 x 64 NB, f32) += P (64 x 16, bf16 in registers) V (16 x 64 NB).
template <int NB>
__device__ __forceinline__ void wgmma_pv(float (&acc)[32 * NB], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t b) {
  if constexpr (NB == 4)
    wgmma_rs_n256(acc, a0, a1, a2, a3, b);
  else if constexpr (NB == 3)
    wgmma_rs_n192(acc, a0, a1, a2, a3, b);
  else if constexpr (NB == 2)
    wgmma_rs_n128(acc, a0, a1, a2, a3, b);
  else
    wgmma_rs_n64(acc, a0, a1, a2, a3, b);
}

// One consumer: output boxes B0 .. B0 + NB - 1 of each of its block's
// units.  The ring advances one stage per (kv tile, chunk of q and k); a
// stage of the last chunk also holds the tile's V.
template <int D, int B0, int NB>
__device__ __forceinline__ void wide_consume(uint32_t base, Barriers bar,
                                             __nv_bfloat16* __restrict__ o,
                                             int batch, int hq, int sq,
                                             int sk, int ld, int n_sl,
                                             int causal, float scale_log2) {
  using L = WideLayout<D>;
  constexpr int kBN = L::kBN;
  const int n_qt = sq / kWideBM;
  const int units = n_qt * hq * batch * n_sl;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int col0 = 2 * (lane % 4);
  int g = 0, nq = 0;                 // ring stages and Q chunks so far
  for (int it = 0; unit_index(it) < units; ++it) {
    const WideUnit u = wide_unit_of<kBN>(unit_index(it), n_qt, hq, batch,
                                         n_sl, sk, causal);
    const int row0 = u.q0 + 16 * warp + lane / 4;  // +8: odd pairs
    float acc[32 * NB];
#pragma unroll
    for (int i = 0; i < 32 * NB; ++i) acc[i] = 0.0f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

    for (int j = 0; j < u.n_kt; ++j) {
      // S = Q K^T, chunk by chunk of D columns (one chunk up to kWidest)
      float s[kBN / 2];
      int st = 0;
      uint32_t ph = 0, k_s = 0;
      for (int ch = 0; ch < n_sl; ++ch, ++g) {
        st = g % kStages;
        ph = (g / kStages) & 1;
        k_s = base + L::kQ + st * 2 * L::kTile;
        if (n_sl > 1 || j == 0) mbar_wait(bar.q_full(), nq & 1);
        mbar_wait(bar.full_k(st), ph);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t q_box = (kk / 4) * kWideBM * kSpan + (kk % 4) * 32;
          const uint32_t k_box = (kk / 4) * kBN * kSpan + (kk % 4) * 32;
          const uint64_t qd = smem_desc(base + q_box, 16, 8 * kSpan);
          const uint64_t kd = smem_desc(k_s + k_box, 16, 8 * kSpan);
          if constexpr (kBN == 64)
            wgmma_ss_n64(s, qd, kd, ch > 0 || kk > 0);
          else
            wgmma_ss_n32(s, qd, kd, ch > 0 || kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        hold(s);
        if (n_sl > 1 || j == u.n_kt - 1) {         // Q's chunk is read
          if (t == 0) mbar_arrive(bar.q_empty());
          ++nq;
        }
        if (ch < n_sl - 1 && t == 0) mbar_arrive(bar.empty(st));
      }

      const int n0 = j * kBN;
      if (n0 + kBN > sk || (causal && n0 + kBN - 1 > u.q0)) {
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i) {
          const int col = n0 + 8 * (i / 4) + col0 + i % 2;
          const int row = row0 + 8 * ((i / 2) % 2);
          if (col >= sk || (causal && col > row)) s[i] = -INFINITY;
        }
      }

      // online softmax in the log2 domain, as flash_fwd_sm90_kernel's
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i)
        mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
      float mu[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * scale_log2);
        mu[r] = m_new == -INFINITY ? 0.0f : m_new;
        const float alpha = ex2(m[r] - mu[r]);
        m[r] = m_new;
        l[r] *= alpha;
#pragma unroll
        for (int i = 0; i < 32 * NB; ++i)
          if ((i / 2) % 2 == r) acc[i] *= alpha;
      }
      uint32_t p[kBN / 4];
#pragma unroll
      for (int i = 0; i < kBN / 2; i += 2) {
        const int r = (i / 2) % 2;
        const float p0 = ex2(fmaf(s[i], scale_log2, -mu[r]));
        const float p1 = ex2(fmaf(s[i + 1], scale_log2, -mu[r]));
        l[r] += p0 + p1;
        p[i / 2] = pack_bf16(p0, p1);
      }

      // O += P V over this consumer's boxes of the tile's V
      const uint32_t v_s = k_s + L::kTile + B0 * kBN * kSpan;
      hold(acc);
      hold(p);
      mbar_wait(bar.full_v(st), ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_pv<NB>(acc, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                     p[4 * kk + 3],
                     smem_desc(v_s + kk * 16 * kSpan, kBN * kSpan, 8 * kSpan));
      wgmma_commit();
      wgmma_wait_all();
      hold(acc);
      if (t == 0) mbar_arrive(bar.empty(st));      // the stage is free
    }

    // epilogue: O / l in bf16, straight from the registers to device memory
    // (a row's four threads write 16 contiguous bytes a box column of 8)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = 1.0f / l[r];
    }
    const int c_base = u.sl * D + 64 * B0 + col0;
#pragma unroll
    for (int i = 0; i < 32 * NB; i += 2) {
      const int r = (i / 2) % 2;
      const int col = c_base + 8 * (i / 4);
      if (col < ld) {
        const size_t at = (static_cast<size_t>(u.b) * sq + row0 + 8 * r) *
                              hq * ld +
                          static_cast<size_t>(u.h) * ld + col;
        *reinterpret_cast<uint32_t*>(o + at) =
            pack_bf16(acc[i] * l[r], acc[i + 1] * l[r]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90_wide_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               __nv_bfloat16* __restrict__ o, int batch,
                               int hq, int hkv, int sq, int sk, int ld,
                               int n_sl, int causal, float scale_log2) {
  using L = WideLayout<D>;
  constexpr int kBN = L::kBN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const Barriers bar{base + L::kBars};
  const int n_qt = sq / kWideBM;
  const int units = n_qt * hq * batch * n_sl;
  const int group = hq / hkv;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar.full_k(st), 1);                  // the producer
      mbar_init(bar.full_v(st), 1);
      mbar_init(bar.empty(st), 2);                   // both consumers
    }
    mbar_init(bar.q_full(), 1);
    mbar_init(bar.q_empty(), 2);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every load.  Q stays for the whole
    // unit when it has one chunk (d <= kWidest); past kWidest each chunk of
    // Q is loaded again beside the same chunk of each K tile.  A stage
    // without V (a chunk before the last) completes full_v by a plain
    // arrival, so every barrier of a stage counts the stage's uses.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      int g = 0, nq = 0;
      for (int it = 0; unit_index(it) < units; ++it) {
        const WideUnit u = wide_unit_of<kBN>(unit_index(it), n_qt, hq, batch,
                                             n_sl, sk, causal);
        const int hk = u.h / group;
        for (int j = 0; j < u.n_kt; ++j) {
          for (int ch = 0; ch < n_sl; ++ch, ++g) {
            if (n_sl > 1 || j == 0) {
              mbar_wait(bar.q_empty(), (nq++ & 1) ^ 1);
              mbar_arrive_expect_tx(bar.q_full(), L::kQ);
              for (int c = 0; c < L::kBoxes; ++c)
                tma_load_4d(base + c * kWideBM * kSpan, &tq, bar.q_full(),
                            ch * D + 64 * c, u.h, u.q0, u.b);
              // the next unit's Q, read once from device memory, into L2
              if (n_sl == 1 && unit_index(it + 1) < units) {
                const WideUnit n = wide_unit_of<kBN>(
                    unit_index(it + 1), n_qt, hq, batch, n_sl, sk, causal);
                for (int c = 0; c < L::kBoxes; ++c)
                  tma_prefetch_4d(&tq, 64 * c, n.h, n.q0, n.b);
              }
            }
            const int st = g % kStages;
            const uint32_t k_s = base + L::kQ + st * 2 * L::kTile;
            mbar_wait(bar.empty(st), ((g / kStages) & 1) ^ 1);
            mbar_arrive_expect_tx(bar.full_k(st), L::kTile);
            for (int c = 0; c < L::kBoxes; ++c)
              tma_load_4d(k_s + c * kBN * kSpan, &tk, bar.full_k(st),
                          ch * D + 64 * c, hk, j * kBN, u.b);
            if (ch == n_sl - 1) {
              mbar_arrive_expect_tx(bar.full_v(st), L::kTile);
              for (int c = 0; c < L::kBoxes; ++c)
                tma_load_4d(k_s + L::kTile + c * kBN * kSpan, &tv,
                            bar.full_v(st), u.sl * D + 64 * c, hk, j * kBN,
                            u.b);
            } else {
              mbar_arrive(bar.full_v(st));
            }
          }
        }
      }
    }
  } else {
    // ---- consumers: the unit's 64 rows each, half of its columns each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    if (wg == 1)
      wide_consume<D, 0, L::kBoxes0>(base, bar, o, batch, hq, sq, sk, ld,
                                     n_sl, causal, scale_log2);
    else
      wide_consume<D, L::kBoxes0, L::kBoxes1>(base, bar, o, batch, hq, sq,
                                              sk, ld, n_sl, causal,
                                              scale_log2);
  }
}

// The output columns each unit takes: the row width up to kWidest, past it
// ld cut into n = ceil(ld / kWidest) slices of a multiple of 64 columns.
int slice_width(int ld) {
  if (ld <= kWidest) return ld;
  const int n = (ld + kWidest - 1) / kWidest;
  return ((ld + n - 1) / n + 63) / 64 * 64;
}

// D, a multiple of 64 past 256, is the instantiation, ld the row width in
// memory and d the caller's head dim: each of the ceil(ld / D) slices of
// the output reads q and k in as many chunks of D columns.
template <int D>
int launch_wide(const void* q, const void* k, const void* v, void* o, int d,
                int ld, int b, int hq, int hkv, int sq, int sk, int causal,
                cudaStream_t stream) {
  using L = WideLayout<D>;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, ld, hq, sq, b, kWideBM) ||
      !make_map(&mk, k, ld, hkv, sk, b, L::kBN) ||
      !make_map(&mv, v, ld, hkv, sk, b, L::kBN))
    return static_cast<int>(cudaErrorInvalidValue);
  static int sms[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms[device] == 0) {
    int count = 0;
    err = cudaFuncSetAttribute(flash_fwd_sm90_wide_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::kBytes);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err != cudaSuccess) return static_cast<int>(err);
    sms[device] = count;
  }
  const int n_sl = (ld + D - 1) / D;
  const long long units =
      static_cast<long long>(sq / kWideBM) * hq * b * n_sl;
  if (units > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(units < sms[device] ? units : sms[device]);
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(d));
  flash_fwd_sm90_wide_kernel<D><<<grid, kThreads, L::kBytes, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), b, hq, hkv, sq, sk, ld,
      n_sl, causal, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bfloat16 only.  q (b, sq, hq, ld); k, v (b, sk, hkv, ld); o (b, sq, hq,
// ld); d <= ld the head dim (the scale is 1/sqrt(d)), ld a multiple of 8 (TMA
// takes rows 16 bytes apart) whose columns past d are zeros; sq and sk
// multiples of 64; every pointer 16-byte aligned.  The instantiation is the
// smallest of 64, 128, 256, 320, 384, 448 and 512 that holds ld, past 512
// the one that holds slice_width(ld).  prefix_len, 0 for none, is the
// prefix-LM mask's P (0 <= P <= sq): only with causal and ld <= 256 (the
// wide kernel takes none).
extern "C" int flash_attention_sm90_fwd(const void* q, const void* k,
                                        const void* v, void* o, int b, int hq,
                                        int hkv, int sq, int sk, int d, int ld,
                                        int causal, int prefix_len,
                                        void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || sq % 64 != 0 || sk % 64 != 0 || d < 1 ||
      ld < d || ld % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (prefix_len < 0 || prefix_len > sq ||
      (prefix_len > 0 && (!causal || ld > 256)))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) %
          16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || hq == 0 || sq == 0) return static_cast<int>(cudaSuccess);
  if (sk == 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ld <= 64)
    return launch<64>(q, k, v, o, d, ld, b, hq, hkv, sq, sk, causal,
                       prefix_len, s);
  if (ld <= 128)
    return launch<128>(q, k, v, o, d, ld, b, hq, hkv, sq, sk, causal,
                       prefix_len, s);
  if (ld <= 256)
    return launch<256>(q, k, v, o, d, ld, b, hq, hkv, sq, sk, causal,
                       prefix_len, s);
  const int w = slice_width(ld);
  if (w <= 320)
    return launch_wide<320>(q, k, v, o, d, ld, b, hq, hkv, sq, sk, causal, s);
  if (w <= 384)
    return launch_wide<384>(q, k, v, o, d, ld, b, hq, hkv, sq, sk, causal, s);
  if (w <= 448)
    return launch_wide<448>(q, k, v, o, d, ld, b, hq, hkv, sq, sk, causal, s);
  if (w <= 512)
    return launch_wide<512>(q, k, v, o, d, ld, b, hq, hkv, sq, sk, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
