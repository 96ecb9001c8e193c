// Flash attention forward (causal or full, grouped-query) at head dims past
// 256, in float32 or bfloat16, on the CUDA cores of NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel of the reference package at the head dims the
// two tiled kernels of this directory do not instantiate:
//   flash_wide_kernel <- repro/kernels/flash_attention.py flash_attention
//                        (pallas_call at :94, body _kernel), any d
// kernels/flash_attention.py kernel_for routes every d > 256 here, in both
// dtypes; d <= 256 runs flash_attention_sm90.cu (bf16) or
// flash_attention.cu (f32).
//
// What it computes: o = softmax(q k^T / sqrt(d)) v per (batch, query head),
// query head h reading kv head h / (Hq / Hkv), with the causal mask
// row >= col counted from position 0.  Inputs are in the model layout
// (B, S, H, ld), contiguous, and so is the output; ld >= d is the row
// width in memory and columns past d are never read (they are staged as
// zeros) or written.  The scores, the running max m, the running sums l
// and the accumulator are float32.  In bfloat16 the numerics follow the
// tensor-core kernel: each unnormalised probability p = exp2(s - m) is
// rounded to bfloat16 before P.V (l is summed before rounding), keys are
// taken 64 at a time as that kernel takes them at head dims past 128, and
// the output is rounded once; flash_attention_sm90_plain is its plain
// version there, flash_attention_plain in float32.
//
// What bounds it on the H100: no model of this repository runs d > 256, so
// the design is the simple one, and its cost is written down, not tuned.
// At B 4, Hq 40, Hkv 8, S 512, d 320, causal the products are 26.8 GFLOP;
// the kernel recomputes the scores once for each 128-wide output slice
// (three slices at d 320), so it does about twice the work of one pass,
// all of it in FFMAs fed from shared memory at eight or sixteen FFMAs a
// shared load.
//
// What the design does:
// * One block of 128 threads per (16 query rows, query head and batch
//   element, 128-wide slice of the output columns); the query tiles are
//   walked last first, so the longest causal loops start first.
// * Thread t owns query row t / 8 of the tile.  For each kv tile of 64
//   keys it accumulates 8 scores (keys t % 8 + 8 j) over d in 64-wide
//   chunks of Q and K staged through shared memory (rows padded to 65
//   floats, so the rows a warp reads at one column lie in distinct banks),
//   then runs the online softmax for its row with the row's other seven
//   threads (three shuffles each for the max and the sum), keeps m and l
//   in registers, writes its probabilities to shared memory, and
//   accumulates its 16 output columns (t % 8 + 8 j of the slice) from P
//   and the kv tile's slice of V, which reuses the K buffer.
// * Sq and Sk must be multiples of 64: the wrapper pads a ragged causal
//   prompt at its tail.  A causal tile visits only the kv tiles up to its
//   last row; each row then sees at least one key in every tile it visits
//   (the tile's first key lies at or before the query tile's first row),
//   so m is finite after the first tile.
//
// The C entry point takes device pointers, sizes and a cudaStream_t,
// launches on that stream, does not synchronise, and returns
// cudaGetLastError() (cudaErrorInvalidValue for a shape it does not take).

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBM = 16;           // query rows a block
constexpr int kBN = 64;           // keys a kv tile
constexpr int kChunk = 64;        // head-dim columns a staged chunk of Q, K
constexpr int kSlice = 128;       // output columns a block
constexpr int kPad = kChunk + 1;  // row stride of the Q, K and P buffers
constexpr int kRowThreads = kThreads / kBM;      // 8 threads a query row
constexpr int kScores = kBN / kRowThreads;       // 8 scores a thread
constexpr int kCols = kSlice / kRowThreads;      // 16 output columns a thread
// shared memory, in floats: Q chunk, P, and one buffer for a K chunk or
// the kv tile's V slice
constexpr int kQ = 0;
constexpr int kP = kQ + kBM * kPad;
constexpr int kKV = kP + kBM * kPad;
constexpr int kKVFloats = kBN * kSlice > kBN * kPad ? kBN * kSlice
                                                    : kBN * kPad;
constexpr int kFloats = kKV + kKVFloats;
static_assert(sizeof(float) * kFloats <= 48 * 1024, "static shared memory");

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// The probability P.V takes: as it is in float32, rounded in bfloat16.
__device__ __forceinline__ float pv_weight(float p, float) { return p; }
__device__ __forceinline__ float pv_weight(float p, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(p));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, int hq,
                  int hkv, int sq, int sk, int d, int ld, int causal,
                  float scale_log2) {
  __shared__ float smem[kFloats];
  float* qs = smem + kQ;
  float* ps = smem + kP;
  float* kv = smem + kKV;

  const int tid = threadIdx.x;
  const int row = tid / kRowThreads;             // of the query tile
  const int lane = tid % kRowThreads;
  const int head = blockIdx.x % hq;
  const int batch = blockIdx.x / hq;
  const int kv_head = head / (hq / hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;
  const int col0 = blockIdx.z * kSlice;          // the block's output slice
  const long long q_stride = static_cast<long long>(hq) * ld;
  const long long kv_stride = static_cast<long long>(hkv) * ld;
  const T* qb = q + static_cast<long long>(batch) * sq * q_stride +
                static_cast<long long>(head) * ld;
  const T* kb = k + static_cast<long long>(batch) * sk * kv_stride +
                static_cast<long long>(kv_head) * ld;
  const T* vb = v + static_cast<long long>(batch) * sk * kv_stride +
                static_cast<long long>(kv_head) * ld;
  const int my_row = q0 + row;

  float m = -INFINITY, l = 0.f;
  float acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.f;

  const int kv_end = causal ? min(sk, q0 + kBM) : sk;
  for (int n0 = 0; n0 < kv_end; n0 += kBN) {
    // ---- S = Q K^T for this kv tile, over d in 64-wide chunks
    float s[kScores];
#pragma unroll
    for (int j = 0; j < kScores; ++j) s[j] = 0.f;
    for (int c0 = 0; c0 < d; c0 += kChunk) {
      __syncthreads();                 // the buffers' last readers are done
      for (int i = tid; i < kBM * kChunk; i += kThreads) {
        const int r = i / kChunk, c = i % kChunk;
        qs[r * kPad + c] =
            c0 + c < d ? load(qb + (q0 + r) * q_stride + c0 + c) : 0.f;
      }
      for (int i = tid; i < kBN * kChunk; i += kThreads) {
        const int r = i / kChunk, c = i % kChunk;
        kv[r * kPad + c] =
            c0 + c < d ? load(kb + (n0 + r) * kv_stride + c0 + c) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < kChunk; ++c) {
        const float qv = qs[row * kPad + c];
#pragma unroll
        for (int j = 0; j < kScores; ++j)
          s[j] = fmaf(qv, kv[(lane + kRowThreads * j) * kPad + c], s[j]);
      }
    }
    __syncthreads();                   // K is read; V may replace it

    // ---- online softmax of the row, in log2 units
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kScores; ++j) {
      s[j] *= scale_log2;
      if (causal && n0 + lane + kRowThreads * j > my_row) s[j] = -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
#pragma unroll
    for (int off = 1; off < kRowThreads; off <<= 1)
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
    const float m_new = fmaxf(m, tile_max);
    const float alpha = exp2f(m - m_new);
    float row_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kScores; ++j) {
      const float p = exp2f(s[j] - m_new);
      row_sum += p;
      ps[row * kPad + lane + kRowThreads * j] = pv_weight(p, T());
    }
#pragma unroll
    for (int off = 1; off < kRowThreads; off <<= 1)
      row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
    l = l * alpha + row_sum;
    m = m_new;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[j] *= alpha;

    // ---- O += P V over the block's output slice
    for (int i = tid; i < kBN * kSlice; i += kThreads) {
      const int r = i / kSlice, c = i % kSlice;
      kv[i] = col0 + c < d ? load(vb + (n0 + r) * kv_stride + col0 + c)
                           : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int key = 0; key < kBN; ++key) {
      const float p = ps[row * kPad + key];
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        acc[j] = fmaf(p, kv[key * kSlice + lane + kRowThreads * j], acc[j]);
    }
  }

  T* ob = o + static_cast<long long>(batch) * sq * q_stride +
          static_cast<long long>(head) * ld + my_row * q_stride;
  const float inv_l = 1.f / l;
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int c = col0 + lane + kRowThreads * j;
    if (c < d) store(ob + c, acc[j] * inv_l);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int sq, int sk, int d, int ld, int causal,
           cudaStream_t stream) {
  const long long heads = static_cast<long long>(b) * hq;
  const int tiles = sq / kBM;
  const int slices = (d + kSlice - 1) / kSlice;
  if (heads > 0x7fffffffLL || tiles > 65535 || slices > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(d));
  const dim3 grid(static_cast<unsigned>(heads), tiles, slices);
  flash_wide_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, hkv, sq, sk, d, ld,
      causal, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// float32 (bf16 = 0) or bfloat16 (bf16 = 1).  q (b, sq, hq, ld); k, v
// (b, sk, hkv, ld); o (b, sq, hq, ld), of which only columns below d are
// written; 1 <= d <= ld; sq and sk multiples of 64.
extern "C" int flash_attention_wide_fwd(const void* q, const void* k,
                                        const void* v, void* o, int b,
                                        int hq, int hkv, int sq, int sk,
                                        int d, int ld, int causal, int bf16,
                                        void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || sq % 64 != 0 || sk % 64 != 0 || d < 1 ||
      ld < d)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || hq == 0 || sq == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, o, b, hq, hkv, sq, sk, d, ld,
                                 causal, s);
  return launch<float>(q, k, v, o, b, hq, hkv, sq, sk, d, ld, causal, s);
}
