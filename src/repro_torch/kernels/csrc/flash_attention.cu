// Flash attention forward (causal or full, grouped-query) in float32 on the
// CUDA cores of NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel of the reference package:
//   flash_fwd_kernel      <- repro/kernels/flash_attention.py flash_attention
//                            (pallas_call at :94, body _kernel), head dims
//                            1 to 256
//   flash_fwd_wide_kernel <- the same, every head dim past 256
//
// What it computes: o = softmax(q k^T / sqrt(d)) v per (batch, query head),
// query head h reading kv head h / (Hq / Hkv), with the causal mask
// row >= col counted from position 0, or the prefix-LM mask
// row >= col || (row < P && col < P) when a prefix of P > 0 positions is
// given (head dims up to 256, causal only: a query tile that starts below
// P walks the kv tiles up to the later of its diagonal and the last tile
// that holds a key below P).  Inputs are float32 in the model
// layout (B, S, H, ld), contiguous, and so is the output; ld, the row width
// in memory, is the head dim d rounded up to a multiple of 4 by the
// wrapper, whose extra columns are zeros.  The kernel runs the smallest
// instantiation D >= d of 32, 64, 128, 256, 320, 384, 448 and 512 (past
// 512 in slices, below) and reads columns past ld as zeros, which add
// nothing to q k^T or p v; the scale is always 1/sqrt(d).
// The running max m, the running sums l and the accumulator stay in
// float32, as in the Pallas kernel: no TF32, whose 10-bit mantissa would
// put errors near 1e-3 against a tolerance of 2e-5.
// bfloat16 runs csrc/flash_attention_sm90.cu (the tensor cores);
// kernels/flash_attention.py kernel_for chooses by dtype.
//
// What bounds it on the H100: at the serving shape (B 4, Hq 40, Hkv 8,
// S 512, d 128, causal) q, k, v and o are 101 MB, 30 us at 3.35 TB/s; the
// causal products are 10.8 GFLOP, 161 us at the CUDA cores' 67 TFLOP/s.
// So the FFMA rate bounds it, and the kernel is built to issue FFMAs: an
// SM issues four warp-FFMAs a clock but serves about one shared-memory
// wavefront a clock, so every operand read from shared memory has to feed
// many FFMAs.
//
// What the design does:
// * One block of four warps per (query tile of 64 rows, query head, batch
//   element), two blocks on an SM; a warp owns 16 query rows (8 at
//   D = 256, whose tiles are 32 rows by 32 keys) for the whole kv loop, so
//   its softmax and its P tile never leave it.  The grid's slowest
//   dimension is the query tile, last tile first, so the longest causal
//   loops start first on the whole card.
// * Within a warp, lane = 16 ty + tx: ty picks half of the warp's rows
//   (8 a thread; 4 at D = 256), tx the score columns tx + 16 j and the
//   output columns 64 g + 4 tx .. + 3.  S = Q K^T reads q and k rows four
//   columns at a time (LDS.128): per four columns, 8 q loads (one address
//   across a quarter warp: a broadcast) and 4 k loads feed 128 FFMA.
//   O += P V reads four probabilities of a row (LDS.128, a broadcast) and
//   float4 rows of V: per four keys 8 + 8 loads feed 256 FFMA.
// * K is stored with its float4 slots XOR-swizzled by the row (slot
//   c ^ (row & 7)), so the eight rows a quarter warp reads at one column
//   lie in eight different bank groups; Q, V and P are read by broadcast or
//   along rows and need no pad.  At D = 128 a block holds Q, K and V
//   (32 KB each) and the warps' P tiles (16 KB): 112 KB, two blocks in the
//   SM's 228 KB.
// * Tiles arrive by cp.async (16-byte LDGSTS, zero-filled past the row
//   width), K and V one buffer each, refilled in turn: the next K tile
//   lands while P V runs, the next V tile while the next Q K^T runs.  Two
//   barriers a kv tile; the other block on the SM fills the gaps.
// * The online softmax runs in the registers of the 16 lanes that own a
//   row (max by four shuffles each tile, sum once at the end), in the log2
//   domain with log2(e)/sqrt(d) folded into one FFMA before ex2.approx.
//   The causal mask is applied only where a tile reaches past a warp's
//   first row.
// * Copies are cheap to issue: a thread copies one column slot of every
//   (128 / (D / 4))-th row, so its source steps by a fixed stride and its
//   destinations fold into constants.
//
// What holds it (chip_smoke.py prints its device time, registers, and the
// FFMAs per shared load of its innermost loops): in the two products'
// loops FFMAs are about nine instructions in ten and each shared load
// feeds 10.7 or 16 of them at D = 128, but an SM holds only two blocks of
// four warps (the registers and shared memory of 16-row warps), two warps
// a scheduler, to hide the shared loads' latency, the softmax's shuffles
// and the two barriers of each kv tile.
//
// Tried and dropped, each slower or no faster on the H100 than the kept
// kernel in one call: one block of eight warps with K and V two stages
// deep; eight warps of 8 rows in 128 registers; a warp skipping the column
// groups of the diagonal tile that lie wholly above its rows (its block
// waits for its last warp); other unrolls and FFMA orders.
// Sq and Sk must be multiples of 64: the wrapper pads a ragged causal
// prompt at its tail.
//
// Past head dim 256 (flash_fwd_wide_kernel): O's accumulators of 8-row
// warps would be 4 x D / 16 a thread, 128 at D 512, and Q, K and V of
// 32-row, 32-key tiles 192 KB, one block an SM.  So one block of eight
// warps takes 64 rows (D 320, 384) or 32 (D 448, 512): a pair of warps
// shares 16 or 8 rows, each computes the pair's scores over half of the
// head dim in a register tile of 8 or 4 rows by 2 keys, the halves are
// added through shared memory (one pair barrier), both run the same
// softmax, and each accumulates half of O's 64-column groups from the
// pair's P tile (8 or 4 rows x 4 G columns a thread; per four keys 8 P and
// 4 G V loads feed 128 G FFMA, 19.2 at G 3; at 4 rows 64 G FFMA, 10.7 at
// G 2 and 12.8 at G 4).  The scores are computed once a block.  Q's rows
// are padded by 4 floats and P's by 4, so the rows a warp reads at one
// column lie in other banks.  Shared memory at D 384: Q 97 KB, K and V
// 48 KB each, 18 KB of scores and probabilities; at D 512 (32 rows): Q
// 64.5 KB, K and V 64 KB each, 12.5 KB.  Past 512 the output is cut into
// n = ceil(ld / 512) slices of a multiple of 64 columns (the
// instantiation), a block each; each computes S again, over q and k in n
// chunks of D columns loaded in turn for every kv tile: S n times, not
// once for every 128 columns.  What holds it (tools/attention_parts.py
// cuts parts out of its loop): the S loop takes the largest share, more
// than its FFMAs or its shared-memory wavefronts alone would; then P V;
// the loads in the kv loop little.  With one block an SM, each barrier of
// a kv tile waits for all eight warps, and no other block fills the gap.
//
// The C entry point takes device pointers (16-byte aligned), sizes and a
// cudaStream_t, launches on that stream, does not synchronise, and returns
// cudaGetLastError() (cudaErrorInvalidValue for a shape it does not take).

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxDevices = 64;

// The tiles of the instantiation at head dim D, in floats.
template <int D>
struct Tile {
  static constexpr int kRowsW = D > 128 ? 8 : 16;  // query rows a warp
  static constexpr int kBM = kWarps * kRowsW;       // query rows a block
  static constexpr int kBN = D > 128 ? 32 : 64;     // keys a kv tile
  static constexpr int kTR = kRowsW / 2;            // rows a thread
  static constexpr int kTC = kBN / 16;              // score columns a thread
  static constexpr int kVec = D >= 64 ? 4 : 2;      // V columns a load
  static constexpr int kGroups = D / (16 * kVec);   // V loads a key
  static constexpr int kSlots = D / 4;              // float4 slots a row
  static constexpr int kUnroll = D >= 128 ? 4 : 2;  // of the S = Q K^T loop
  static constexpr int kQ = 0;                      // Q: kBM x D
  static constexpr int kK = kQ + kBM * D;           // K: kBN x D
  static constexpr int kV = kK + kBN * D;           // V: kBN x D
  static constexpr int kP = kV + kBN * D;           // P: kWarps x kRowsW x kBN
  static constexpr int kFloats = kP + kWarps * kRowsW * kBN;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
  static_assert(kSlots >= 8, "the K swizzle needs 8 slots a row");
  static_assert(64 % kBM == 0 && kBN % kRowsW == 0, "whole tiles");
  // two blocks an SM: 228 KB less 1 KB reserved for each
  static_assert(2 * (kBytes + 1024) <= 233472, "two blocks' shared memory");
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// 16 bytes from global to shared memory; zeros where !valid (nothing is
// read then, and `src` only has to be a valid address).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The float offset of K's float4 slot `c4` of row `j`: XOR-swizzled.
template <int D>
__device__ __forceinline__ int k_at(int j, int c4) {
  return j * D + ((c4 ^ (j & 7)) << 2);
}

// Copies kRows rows of ld floats (row i at src + i * stride) into a
// kRows x D tile of shared memory; columns at or past ld arrive as zeros.
// K's slots are swizzled.  A thread copies one column slot of every
// kThreads / (D / 4)-th row, so its source steps by a fixed stride and its
// destinations are constants past the first: a few instructions a copy.
template <int D, int kRows, bool kSwizzle>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          size_t stride, int ld) {
  constexpr int kSlots = D / 4;
  constexpr int kStep = kThreads / kSlots;         // rows between copies
  static_assert(kThreads % kSlots == 0 && kRows % kStep == 0, "copies");
  const int c4 = threadIdx.x % kSlots, r0 = threadIdx.x / kSlots;
  const bool valid = 4 * c4 < ld;
  const float* from = valid ? src + r0 * stride + 4 * c4 : src;
  const size_t step = valid ? kStep * stride : 0;
#pragma unroll
  for (int n = 0; n < kRows / kStep; ++n) {
    const int r = r0 + kStep * n;
    cp_async16(dst + (kSwizzle ? k_at<D>(r, c4) : r * D + 4 * c4),
               from + n * step, valid);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int hq, int hkv, int sq, int sk, int ld, int causal,
                     int prefix, float scale_log2) {
  using T = Tile<D>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const float* qs = smem + T::kQ;
  float* kst = smem + T::kK;
  float* vst = smem + T::kV;

  const int qt = gridDim.y - 1 - blockIdx.y;       // longest loops first
  const int h = blockIdx.x % hq, b = blockIdx.x / hq;
  const int hk = h / (hq / hkv);
  const int q0 = qt * T::kBM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ty = lane / 16, tx = lane % 16;
  const int trow = warp * T::kRowsW + ty * T::kTR; // thread's rows
  const int first_row = q0 + warp * T::kRowsW;     // warp's first row
  float* ps = smem + T::kP + warp * T::kRowsW * T::kBN;
  const float* pt = ps + ty * T::kTR * T::kBN;     // this thread's P rows

  const size_t q_stride = static_cast<size_t>(hq) * ld;
  const size_t kv_stride = static_cast<size_t>(hkv) * ld;
  const float* kbase = k + static_cast<size_t>(b) * sk * kv_stride +
                       static_cast<size_t>(hk) * ld;
  const float* vbase = v + static_cast<size_t>(b) * sk * kv_stride +
                       static_cast<size_t>(hk) * ld;
  const size_t tile_stride = static_cast<size_t>(T::kBN) * kv_stride;

  int n_kt = sk / T::kBN;
  if (causal) {
    int end = (q0 + T::kBM - 1) / T::kBN + 1;
    if (q0 < prefix) end = max(end, (prefix + T::kBN - 1) / T::kBN);
    n_kt = min(n_kt, end);
  }

  // Q with K's first tile, then V's: K and V each have one buffer, and
  // each is refilled while the other product runs
  load_tile<D, T::kBM, false>(smem + T::kQ,
                              q + (static_cast<size_t>(b) * sq + q0) *
                                      q_stride +
                                  static_cast<size_t>(h) * ld,
                              q_stride, ld);
  if (n_kt > 0) load_tile<D, T::kBN, true>(kst, kbase, kv_stride, ld);
  cp_async_commit();
  if (n_kt > 0) load_tile<D, T::kBN, false>(vst, vbase, kv_stride, ld);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  float acc[T::kTR][T::kGroups * T::kVec];
  float m[T::kTR], l[T::kTR];
#pragma unroll
  for (int i = 0; i < T::kTR; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < T::kGroups * T::kVec; ++c) acc[i][c] = 0.0f;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * T::kBN;
    // K's tile kt is here; every row attends to key 0 of tile 0, so its
    // running max is finite from the first tile on (a tile past the
    // diagonal that a prefix adds may hold no key a row attends to)
    {
      // S = Q K^T: rows trow + i, columns tx + 16 jj
      float s[T::kTR][T::kTC];
#pragma unroll
      for (int i = 0; i < T::kTR; ++i)
#pragma unroll
        for (int jj = 0; jj < T::kTC; ++jj) s[i][jj] = 0.0f;
#pragma unroll T::kUnroll
      for (int c4 = 0; c4 < T::kSlots; ++c4) {
        float4 kf[T::kTC];
#pragma unroll
        for (int jj = 0; jj < T::kTC; ++jj)
          kf[jj] = lds4(kst + k_at<D>(tx + 16 * jj, c4));
#pragma unroll
        for (int i = 0; i < T::kTR; ++i) {
          const float4 qf = lds4(qs + (trow + i) * D + 4 * c4);
#pragma unroll
          for (int jj = 0; jj < T::kTC; ++jj) {
            s[i][jj] = fmaf(qf.x, kf[jj].x, s[i][jj]);
            s[i][jj] = fmaf(qf.y, kf[jj].y, s[i][jj]);
            s[i][jj] = fmaf(qf.z, kf[jj].z, s[i][jj]);
            s[i][jj] = fmaf(qf.w, kf[jj].w, s[i][jj]);
          }
        }
      }
      if (causal && k0 + T::kBN - 1 > first_row) {
#pragma unroll
        for (int i = 0; i < T::kTR; ++i)
#pragma unroll
          for (int jj = 0; jj < T::kTC; ++jj) {
            // col > row && (row >= P || col >= P)
            const int col = k0 + tx + 16 * jj;
            if (col > max(q0 + trow + i, prefix - 1)) s[i][jj] = -INFINITY;
          }
      }

      // online softmax over the row's 16 lanes, in log2 units
#pragma unroll
      for (int i = 0; i < T::kTR; ++i) {
        float mx = s[i][0];
#pragma unroll
        for (int jj = 1; jj < T::kTC; ++jj) mx = fmaxf(mx, s[i][jj]);
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[i], mx);      // finite: key 0 was seen
        const float mc = m_new * scale_log2;
        const float alpha = ex2(m[i] * scale_log2 - mc);
        float sum = 0.0f;
#pragma unroll
        for (int jj = 0; jj < T::kTC; ++jj) {
          s[i][jj] = ex2(fmaf(s[i][jj], scale_log2, -mc));
          sum += s[i][jj];
        }
        l[i] = fmaf(l[i], alpha, sum);
        m[i] = m_new;
#pragma unroll
        for (int c = 0; c < T::kGroups * T::kVec; ++c) acc[i][c] *= alpha;
      }

#pragma unroll
      for (int i = 0; i < T::kTR; ++i)
#pragma unroll
        for (int jj = 0; jj < T::kTC; ++jj)
          ps[(ty * T::kTR + i) * T::kBN + tx + 16 * jj] = s[i][jj];
    }
    cp_async_wait<0>();                            // V's tile kt
    __syncthreads();                               // K's buffer is free
    if (kt + 1 < n_kt) {
      load_tile<D, T::kBN, true>(kst, kbase + (kt + 1) * tile_stride,
                                 kv_stride, ld);
      cp_async_commit();
    }
    {
      const float* vs = vst;

      // O += P V: rows trow + i, columns 64 g + kVec tx .. + kVec - 1
#pragma unroll 2
      for (int j4 = 0; j4 < T::kBN / 4; ++j4) {
        float4 pf[T::kTR];
#pragma unroll
        for (int i = 0; i < T::kTR; ++i)
          pf[i] = lds4(pt + i * T::kBN + 4 * j4);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float* vrow = vs + (4 * j4 + jj) * D + T::kVec * tx;
          float vf[T::kGroups * T::kVec];
#pragma unroll
          for (int g = 0; g < T::kGroups; ++g) {
            if constexpr (T::kVec == 4) {
              const float4 x = lds4(vrow + 16 * T::kVec * g);
              vf[4 * g] = x.x;
              vf[4 * g + 1] = x.y;
              vf[4 * g + 2] = x.z;
              vf[4 * g + 3] = x.w;
            } else {
              const float2 x =
                  *reinterpret_cast<const float2*>(vrow + 16 * T::kVec * g);
              vf[2 * g] = x.x;
              vf[2 * g + 1] = x.y;
            }
          }
#pragma unroll
          for (int i = 0; i < T::kTR; ++i) {
            const float p = jj == 0   ? pf[i].x
                            : jj == 1 ? pf[i].y
                            : jj == 2 ? pf[i].z
                                      : pf[i].w;
#pragma unroll
            for (int c = 0; c < T::kGroups * T::kVec; ++c)
              acc[i][c] = fmaf(p, vf[c], acc[i][c]);
          }
        }
      }
    }
    cp_async_wait<0>();                            // K's tile kt + 1
    __syncthreads();                               // V's and P's buffers
    if (kt + 1 < n_kt) {                           // are free
      load_tile<D, T::kBN, false>(vst, vbase + (kt + 1) * tile_stride,
                                  kv_stride, ld);
      cp_async_commit();
    }
  }

#pragma unroll
  for (int i = 0; i < T::kTR; ++i) {
    float sum = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float inv = 1.0f / fmaxf(sum, 1e-30f);
    float* orow = o + (static_cast<size_t>(b) * sq + q0 + trow + i) *
                          q_stride +
                  static_cast<size_t>(h) * ld;
#pragma unroll
    for (int g = 0; g < T::kGroups; ++g) {
      const int col = 16 * T::kVec * g + T::kVec * tx;
      if (col >= ld) continue;
      const float* a = acc[i] + T::kVec * g;
      if constexpr (T::kVec == 4) {
        *reinterpret_cast<float4*>(orow + col) =
            make_float4(a[0] * inv, a[1] * inv, a[2] * inv, a[3] * inv);
      } else {
        *reinterpret_cast<float2*>(orow + col) =
            make_float2(a[0] * inv, a[1] * inv);
      }
    }
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* o, int d,
           int ld, int b, int hq, int hkv, int sq, int sk, int causal,
           int prefix, cudaStream_t stream) {
  using T = Tile<D>;
  // per device, set once: the shared-memory opt-in above 48 KB, and the
  // whole of the SM's 228 KB as shared memory for two blocks
  static bool ready[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[device]) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(T::kBytes));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          flash_fwd_kernel<D>, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[device] = true;
  }
  const long long heads = static_cast<long long>(b) * hq;
  const int tiles = (sq + T::kBM - 1) / T::kBM;
  if (heads > 0x7fffffffLL || tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(d));
  const dim3 grid(static_cast<unsigned>(heads), tiles);
  flash_fwd_kernel<D><<<grid, kThreads, T::kBytes, stream>>>(
      q, k, v, o, hq, hkv, sq, sk, ld, causal, prefix, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// ---- head dims past 256 --------------------------------------------------
// One block of eight warps per (kBM query rows, query head and batch
// element, slice of the output columns past kWidest), one block an SM.
// Warps w and w + 4 are a pair that shares kBM / 4 rows: each computes the
// pair's scores over its half of the head dim, lane = 16 ty + tx holding
// the pair's rows ty, ty + 2, .. (kTR of them) and keys tx and tx + 16, the
// halves are summed through shared memory, both warps run the same softmax
// on the same sums (a + b == b + a, so they agree bit for bit).  Each then
// accumulates its own 64-column groups of O (warp w the first half, the
// larger when the groups are odd) from the pair's P tile.  Blocks take 64
// rows where Q fits beside K and V (D 320 and 384): a thread's 8 x 2
// scores then take 8 Q loads of one wavefront and 2 K loads of two per 64
// FFMA, and each kv tile serves twice the rows.
constexpr int kWideWarps = 8;
constexpr int kWideThreads = 32 * kWideWarps;
constexpr int kWidest = 512;      // the widest instantiation

template <int D>
struct WideTile {
  static constexpr int kBM = D > 384 ? 32 : 64;    // query rows a block
  static constexpr int kBN = 32;                   // keys a kv tile
  static constexpr int kTR = kBM / 8;              // rows a thread
  static constexpr int kTC = 2;                    // score columns a thread
  static constexpr int kSlots = D / 4;             // float4 slots a row
  static constexpr int kHalf = kSlots / 2;         // slots a warp's half
  static constexpr int kGroups = D / 64;           // 64-column groups of O
  static constexpr int kG0 = (kGroups + 1) / 2;    // warps 0-3's groups
  static constexpr int kG1 = kGroups - kG0;        // warps 4-7's groups
  static constexpr int kQLd = D + 4;               // Q's row stride (padded)
  static constexpr int kPLd = kBN + 4;             // P's row stride (padded)
  static constexpr int kQ = 0;                     // Q: kBM x kQLd
  static constexpr int kK = kQ + kBM * kQLd;       // K: kBN x D, swizzled
  static constexpr int kV = kK + kBN * D;          // V: kBN x D
  static constexpr int kX = kV + kBN * D;          // partial S: a warp's 8 x 32
  static constexpr int kP = kX + kWideWarps * kTR * kTC * 32;  // P: kBM x kPLd
  static constexpr int kFloats = kP + kBM * kPLd;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
  static_assert(kSlots % 8 == 0 && kHalf % 4 == 0, "the K swizzle, unroll");
  static_assert(kBytes <= 232448, "beyond the H100's shared-memory opt-in");
};

// Named barriers 1-4 each join the 64 threads of one pair of warps.
__device__ __forceinline__ void pair_sync(int pair) {
  asm volatile("bar.sync %0, 64;" ::"r"(1 + pair) : "memory");
}

// Copies kRows rows of D floats from column `col` on (row i at
// src + i * stride) into a tile of row stride kLd, or into K's swizzled
// layout; columns at or past ld arrive as zeros.  Thread t copies slots
// t % 16 + 16 n of rows t / 16 + 16 m: its sources are two pointers apart
// by a fixed stride and its destinations constants past the first (the
// swizzle flips only a slot's low three bits, by the row's, which are the
// same in all its rows), so a copy costs a few instructions and no
// registers held across the kv loop.
template <int D, int kRows, int kLd, bool kSwizzle>
__device__ __forceinline__ void load_wide_tile(float* dst, const float* src,
                                               size_t stride, int col,
                                               int ld) {
  constexpr int kSlots = D / 4;
  constexpr int kStep = kWideThreads / 16;         // rows between copies
  static_assert(kSlots % 16 == 0 && kRows % kStep == 0, "whole copies");
  const int r0 = threadIdx.x / 16, c = threadIdx.x % 16;
  const float* from = src + r0 * stride + col + 4 * c;
  float* to = dst + (kSwizzle ? k_at<D>(r0, c) : r0 * kLd + 4 * c);
#pragma unroll
  for (int n = 0; n < kSlots / 16; ++n) {
    const bool valid = col + 4 * (c + 16 * n) < ld;
#pragma unroll
    for (int m = 0; m < kRows / kStep; ++m)
      cp_async16(to + m * kStep * (kSwizzle ? D : kLd) + 64 * n,
                 valid ? from + m * kStep * stride + 64 * n : src, valid);
  }
}

// O (rows trow + 2 i, columns vs + 64 g + 0..3 of the warp's groups) += P V.
template <int D, int G, int N>
__device__ __forceinline__ void wide_pv(float (&acc)[WideTile<D>::kTR][N],
                                        const float* pt, const float* vs) {
  using T = WideTile<D>;
#pragma unroll 2
  for (int j4 = 0; j4 < T::kBN / 4; ++j4) {
    float4 pf[T::kTR];
#pragma unroll
    for (int i = 0; i < T::kTR; ++i)
      pf[i] = lds4(pt + 2 * i * T::kPLd + 4 * j4);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float* vrow = vs + (4 * j4 + jj) * D;
      float vf[4 * G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 x = lds4(vrow + 64 * g);
        vf[4 * g] = x.x;
        vf[4 * g + 1] = x.y;
        vf[4 * g + 2] = x.z;
        vf[4 * g + 3] = x.w;
      }
#pragma unroll
      for (int i = 0; i < T::kTR; ++i) {
        const float p = jj == 0   ? pf[i].x
                        : jj == 1 ? pf[i].y
                        : jj == 2 ? pf[i].z
                                  : pf[i].w;
#pragma unroll
        for (int c = 0; c < 4 * G; ++c) acc[i][c] = fmaf(p, vf[c], acc[i][c]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kWideThreads, 1)
    flash_fwd_wide_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          int hq, int hkv, int sq, int sk, int ld, int n_sl,
                          int causal, float scale_log2) {
  using T = WideTile<D>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qs = smem + T::kQ;
  float* kst = smem + T::kK;
  float* vst = smem + T::kV;
  float* ps = smem + T::kP;

  const int qt = gridDim.y - 1 - blockIdx.y;       // longest loops first
  const int sl = blockIdx.x % n_sl;                // the output slice
  const int h = blockIdx.x / n_sl % hq, b = blockIdx.x / n_sl / hq;
  const int hk = h / (hq / hkv);
  const int q0 = qt * T::kBM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int pair = warp % 4, half = warp / 4;
  const int ty = lane / 16, tx = lane % 16;
  // a thread's rows: trow + 2 i, so the two halves of a warp read rows 16
  // bytes apart in Q's and P's padded rows, other banks
  const int trow = 2 * T::kTR * pair + ty;
  const int first_row = q0 + 2 * T::kTR * pair;    // pair's first row
  float* x_mine = smem + T::kX + warp * T::kTR * T::kTC * 32 + lane;
  const float* x_theirs =
      smem + T::kX + (warp ^ 4) * T::kTR * T::kTC * 32 + lane;

  const size_t q_stride = static_cast<size_t>(hq) * ld;
  const size_t kv_stride = static_cast<size_t>(hkv) * ld;
  const float* qbase = q + (static_cast<size_t>(b) * sq + q0) * q_stride +
                       static_cast<size_t>(h) * ld;
  const float* kbase = k + static_cast<size_t>(b) * sk * kv_stride +
                       static_cast<size_t>(hk) * ld;
  const float* vbase = v + static_cast<size_t>(b) * sk * kv_stride +
                       static_cast<size_t>(hk) * ld;
  const size_t tile_stride = static_cast<size_t>(T::kBN) * kv_stride;

  int n_kt = sk / T::kBN;
  if (causal) n_kt = min(n_kt, (q0 + T::kBM - 1) / T::kBN + 1);

  // One chunk (ld <= D): Q stays, K's first tile comes with it, and K and
  // V are each refilled while the other product runs, as in
  // flash_fwd_kernel.  Past kWidest each chunk of Q and of the kv tile's K
  // is loaded in turn for each kv tile.
  if (n_sl == 1) {
    load_wide_tile<D, T::kBM, T::kQLd, false>(qs, qbase, q_stride, 0, ld);
    if (n_kt > 0)
      load_wide_tile<D, T::kBN, D, true>(kst, kbase, kv_stride, 0, ld);
  }
  cp_async_commit();
  if (n_kt > 0)
    load_wide_tile<D, T::kBN, D, false>(vst, vbase, kv_stride, sl * D, ld);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  float acc[T::kTR][4 * T::kG0];
  float m[T::kTR], l[T::kTR];
#pragma unroll
  for (int i = 0; i < T::kTR; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4 * T::kG0; ++c) acc[i][c] = 0.0f;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * T::kBN;
    // this warp's half of S = Q K^T: rows trow + 2 i, keys tx + 16 jj
    float s[T::kTR][T::kTC];
#pragma unroll
    for (int i = 0; i < T::kTR; ++i)
#pragma unroll
      for (int jj = 0; jj < T::kTC; ++jj) s[i][jj] = 0.0f;
    for (int ch = 0; ch < n_sl; ++ch) {
      if (n_sl > 1) {
        __syncthreads();                           // the last chunk is read
        load_wide_tile<D, T::kBM, T::kQLd, false>(qs, qbase, q_stride,
                                                  ch * D, ld);
        load_wide_tile<D, T::kBN, D, true>(kst, kbase + kt * tile_stride,
                                           kv_stride, ch * D, ld);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
      }
#pragma unroll 4
      for (int n = 0; n < T::kHalf; ++n) {
        const int c4 = half * T::kHalf + n;
        float4 kf[T::kTC];
#pragma unroll
        for (int jj = 0; jj < T::kTC; ++jj)
          kf[jj] = lds4(kst + k_at<D>(tx + 16 * jj, c4));
#pragma unroll
        for (int i = 0; i < T::kTR; ++i) {
          const float4 qf = lds4(qs + (trow + 2 * i) * T::kQLd + 4 * c4);
#pragma unroll
          for (int jj = 0; jj < T::kTC; ++jj) {
            s[i][jj] = fmaf(qf.x, kf[jj].x, s[i][jj]);
            s[i][jj] = fmaf(qf.y, kf[jj].y, s[i][jj]);
            s[i][jj] = fmaf(qf.z, kf[jj].z, s[i][jj]);
            s[i][jj] = fmaf(qf.w, kf[jj].w, s[i][jj]);
          }
        }
      }
    }
    // the pair's two halves summed, the same sum in both warps
#pragma unroll
    for (int i = 0; i < T::kTR; ++i)
#pragma unroll
      for (int jj = 0; jj < T::kTC; ++jj)
        x_mine[(i * T::kTC + jj) * 32] = s[i][jj];
    pair_sync(pair);
#pragma unroll
    for (int i = 0; i < T::kTR; ++i)
#pragma unroll
      for (int jj = 0; jj < T::kTC; ++jj)
        s[i][jj] += x_theirs[(i * T::kTC + jj) * 32];
    if (causal && k0 + T::kBN - 1 > first_row) {
#pragma unroll
      for (int i = 0; i < T::kTR; ++i)
#pragma unroll
        for (int jj = 0; jj < T::kTC; ++jj)
          if (k0 + tx + 16 * jj > q0 + trow + 2 * i) s[i][jj] = -INFINITY;
    }

    // online softmax over the row's 16 lanes, in log2 units
#pragma unroll
    for (int i = 0; i < T::kTR; ++i) {
      float mx = fmaxf(s[i][0], s[i][1]);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // finite: every row sees key 0 in tile 0 (a later tile may lie
      // wholly above a pair's rows when blocks take 64)
      const float m_new = fmaxf(m[i], mx);
      const float mc = m_new * scale_log2;
      const float alpha = ex2(m[i] * scale_log2 - mc);
      float sum = 0.0f;
#pragma unroll
      for (int jj = 0; jj < T::kTC; ++jj) {
        s[i][jj] = ex2(fmaf(s[i][jj], scale_log2, -mc));
        sum += s[i][jj];
      }
      l[i] = fmaf(l[i], alpha, sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * T::kG0; ++c) acc[i][c] *= alpha;
      // the pair's P tile: warp w writes keys tx, warp w + 4 keys tx + 16
      ps[(trow + 2 * i) * T::kPLd + tx + 16 * half] =
          half ? s[i][1] : s[i][0];
    }
    cp_async_wait<0>();                            // V's tile kt
    __syncthreads();                               // K's buffer is free
    if (n_sl == 1 && kt + 1 < n_kt) {
      load_wide_tile<D, T::kBN, D, true>(kst, kbase + (kt + 1) * tile_stride,
                                         kv_stride, 0, ld);
      cp_async_commit();
    }
    if (half == 0)
      wide_pv<D, T::kG0>(acc, ps + trow * T::kPLd, vst + 4 * tx);
    else
      wide_pv<D, T::kG1>(acc, ps + trow * T::kPLd, vst + 64 * T::kG0 + 4 * tx);
    cp_async_wait<0>();                            // K's tile kt + 1
    __syncthreads();                               // V's and P's buffers
    if (kt + 1 < n_kt) {                           // are free
      load_wide_tile<D, T::kBN, D, false>(vst, vbase + (kt + 1) * tile_stride,
                                          kv_stride, sl * D, ld);
      cp_async_commit();
    }
  }

  const int groups = half ? T::kG1 : T::kG0;
  const int col0 = sl * D + 64 * (half ? T::kG0 : 0) + 4 * tx;
#pragma unroll
  for (int i = 0; i < T::kTR; ++i) {
    float sum = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float inv = 1.0f / fmaxf(sum, 1e-30f);
    float* orow = o + (static_cast<size_t>(b) * sq + q0 + trow + 2 * i) *
                          q_stride +
                  static_cast<size_t>(h) * ld;
#pragma unroll
    for (int g = 0; g < T::kG0; ++g) {
      const int col = col0 + 64 * g;
      if (g >= groups || col >= ld) continue;
      const float* a = acc[i] + 4 * g;
      *reinterpret_cast<float4*>(orow + col) =
          make_float4(a[0] * inv, a[1] * inv, a[2] * inv, a[3] * inv);
    }
  }
}

// The output columns each block takes: the row width up to kWidest, past
// it ld cut into n = ceil(ld / kWidest) slices of a multiple of 64 columns.
int slice_width(int ld) {
  if (ld <= kWidest) return ld;
  const int n = (ld + kWidest - 1) / kWidest;
  return ((ld + n - 1) / n + 63) / 64 * 64;
}

// D, a multiple of 64 past 256, is the instantiation: each of the
// ceil(ld / D) slices of the output reads q and k in as many chunks.
template <int D>
int launch_wide(const float* q, const float* k, const float* v, float* o,
                int d, int ld, int b, int hq, int hkv, int sq, int sk,
                int causal, cudaStream_t stream) {
  using T = WideTile<D>;
  static bool ready[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[device]) {
    err = cudaFuncSetAttribute(flash_fwd_wide_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(T::kBytes));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          flash_fwd_wide_kernel<D>,
          cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[device] = true;
  }
  const int n_sl = (ld + D - 1) / D;
  const long long blocks = static_cast<long long>(b) * hq * n_sl;
  const int tiles = sq / T::kBM;
  if (blocks > 0x7fffffffLL || tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(d));
  const dim3 grid(static_cast<unsigned>(blocks), tiles);
  flash_fwd_wide_kernel<D><<<grid, kWideThreads, T::kBytes, stream>>>(
      q, k, v, o, hq, hkv, sq, sk, ld, n_sl, causal, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// float32 only.  q (b, sq, hq, ld); k, v (b, sk, hkv, ld); o (b, sq, hq,
// ld); d <= ld the head dim (the scale is 1/sqrt(d)), ld a multiple of 4
// whose columns past d are zeros; sq and sk multiples of 64; every pointer
// 16-byte aligned.  The instantiation is the smallest of 32, 64, 128, 256,
// 320, 384, 448 and 512 that holds ld, past 512 the one that holds
// slice_width(ld).  prefix_len, 0 for none, is the prefix-LM mask's P
// (0 <= P <= sq): only with causal and ld <= 256 (the wide kernel takes
// none).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int b, int hq,
                                   int hkv, int sq, int sk, int d, int ld,
                                   int causal, int prefix_len, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || sq % 64 != 0 || sk % 64 != 0 || d < 1 ||
      ld < d || ld % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (prefix_len < 0 || prefix_len > sq ||
      (prefix_len > 0 && (!causal || ld > 256)))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) %
          16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || hq == 0 || sq == 0) return static_cast<int>(cudaSuccess);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(o);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ld <= 32)
    return launch<32>(qf, kf, vf, of, d, ld, b, hq, hkv, sq, sk, causal,
                       prefix_len, s);
  if (ld <= 64)
    return launch<64>(qf, kf, vf, of, d, ld, b, hq, hkv, sq, sk, causal,
                       prefix_len, s);
  if (ld <= 128)
    return launch<128>(qf, kf, vf, of, d, ld, b, hq, hkv, sq, sk, causal,
                       prefix_len, s);
  if (ld <= 256)
    return launch<256>(qf, kf, vf, of, d, ld, b, hq, hkv, sq, sk, causal,
                       prefix_len, s);
  const int w = slice_width(ld);
  if (w <= 320)
    return launch_wide<320>(qf, kf, vf, of, d, ld, b, hq, hkv, sq, sk,
                            causal, s);
  if (w <= 384)
    return launch_wide<384>(qf, kf, vf, of, d, ld, b, hq, hkv, sq, sk,
                            causal, s);
  if (w <= 448)
    return launch_wide<448>(qf, kf, vf, of, d, ld, b, hq, hkv, sq, sk,
                            causal, s);
  if (w <= 512)
    return launch_wide<512>(qf, kf, vf, of, d, ld, b, hq, hkv, sq, sk,
                            causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
