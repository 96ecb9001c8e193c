// Flash attention forward (causal or full, grouped-query) for NVIDIA
// Hopper (sm_90a).
//
// Replaces the Pallas kernel of the reference package:
//   flash_fwd_kernel <- repro/kernels/flash_attention.py flash_attention
//                       (pallas_call at :94, body _kernel)
//
// What it computes: o = softmax(q k^T / sqrt(d)) v per (batch, query head),
// query head h reading kv head h / (Hq / Hkv), with the causal mask
// row >= col counted from position 0.  Inputs are float32 in the model
// layout (B, S, H, d), contiguous, and so is the output.  The running max
// m, the running sum l and the accumulator stay in float32, as in the
// Pallas kernel.
//
// Which inputs it takes: float32 at every head dim; bfloat16 runs
// csrc/flash_attention_sm90.cu (the tensor cores, wgmma fed by TMA) at
// every head dim.  kernels/flash_attention.py kernel_for chooses by dtype.
//
// What bounds it on the H100: at the serving shapes (S = 512, d = 128) the
// bytes bound (q, k, v read once, o written once) is some 30 us; the
// float32 operations bound is 160 us.  This kernel
// runs on the CUDA cores in float32, so the float32 rate (67 TFLOP/s) and
// the shared-memory traffic of its inner products bound it.
//
// What the design does: one block of 256 threads per (query tile of 64
// rows, query head, batch).  The Pallas grid's sequential kv dimension is a
// loop inside the block that stops at the diagonal when causal, which
// replaces the pl.when skip of fully masked kv tiles; the tiles nearest the
// end of the sequence, which loop longest, are scheduled first.  Q, K and V
// tiles are held in shared memory as float32 at a row stride of d + 1 (so
// the 16 threads that read 16 rows at one column hit 16 banks), which is
// 113.5 KB at d = 128 and needs the opt-in above 48 KB.  Each thread owns a
// 4 x 4 patch of the 64 x 64 score tile and a 4 x (d / 16) patch of the
// accumulator; each warp owns 8 rows of the online softmax and reduces them
// with shuffles.  Sq and Sk must be multiples of 64: the wrapper pads a
// ragged causal prompt at its tail.
//
// The C entry point takes device pointers, sizes and a cudaStream_t,
// launches on that stream, does not synchronise, and returns
// cudaGetLastError() (cudaErrorInvalidValue for a shape it does not take).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 64;      // query rows and kv rows per tile
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

// Copies a kBlock x D tile, whose rows lie `row_stride` elements apart
// starting at `src`, into shared memory at row stride D + 1.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          size_t row_stride) {
  for (int e = threadIdx.x; e < kBlock * D; e += kThreads) {
    const int r = e / D, c = e % D;
    dst[r * (D + 1) + c] = src[r * row_stride + c];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* q, const float* k, const float* v,
                     float* o, int hq, int hkv, int sq, int sk, int causal) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kCols = D / 16;              // accumulator columns a thread
  extern __shared__ float smem[];
  float* qs = smem;                          // kBlock x (D + 1)
  float* ks = qs + kBlock * (D + 1);         // kBlock x (D + 1)
  float* vs = ks + kBlock * (D + 1);         // kBlock x (D + 1)
  float* ps = vs + kBlock * (D + 1);         // kBlock x (kBlock + 1)
  float* alpha_s = ps + kBlock * (kBlock + 1);
  float* l_s = alpha_s + kBlock;

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal loops first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int q0 = qt * kBlock;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));

  const size_t q_row = static_cast<size_t>(hq) * D;
  const size_t kv_row = static_cast<size_t>(hkv) * D;
  load_tile<D>(qs, q + (static_cast<size_t>(b) * sq + q0) * q_row +
                          static_cast<size_t>(h) * D, q_row);

  float m_run[8], l_run[8];                  // rows warp * 8 + i
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.0f;
  }
  float acc[4][kCols];                       // rows ty + 16 i, cols tx + 16 j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.0f;

  int n_kt = sk / kBlock;
  if (causal) n_kt = min(n_kt, (q0 + kBlock - 1) / kBlock + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBlock;
    __syncthreads();                         // last tile's P.V is done
    const size_t kv_off = (static_cast<size_t>(b) * sk + k0) * kv_row +
                          static_cast<size_t>(hk) * D;
    load_tile<D>(ks, k + kv_off, kv_row);
    load_tile<D>(vs, v + kv_off, kv_row);
    __syncthreads();

    // scores: this thread's 4 x 4 patch of q k^T
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * (D + 1) + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * (D + 1) + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = ty + 16 * i, col = tx + 16 * j;
        float x = s[i][j] * scale;
        if (causal && q0 + row < k0 + col) x = kNegInf;
        ps[row * (kBlock + 1) + col] = x;
      }
    __syncthreads();

    // online softmax: each warp updates m and l of its 8 rows and turns
    // their scores into probabilities, two columns a lane
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = warp * 8 + i;
      float* pr = ps + row * (kBlock + 1);
      const float a = pr[lane], c = pr[lane + 32];
      float mx = fmaxf(a, c);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      const float pa = expf(a - m_new), pc = expf(c - m_new);
      float sum = pa + pc;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m_run[i] - m_new);
      l_run[i] = alpha * l_run[i] + sum;
      m_run[i] = m_new;
      pr[lane] = pa;
      pr[lane + 32] = pc;
      if (lane == 0) alpha_s[row] = alpha;
    }
    __syncthreads();

    // acc = alpha * acc + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = alpha_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int c = 0; c < kBlock; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * (kBlock + 1) + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float vv = vs[c * (D + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += pv[i] * vv;
      }
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) l_s[warp * 8 + i] = fmaxf(l_run[i], 1e-30f);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty + 16 * i;
    const float l = l_s[row];
    float* orow = o + ((static_cast<size_t>(b) * sq + q0 + row) * hq + h) * D;
#pragma unroll
    for (int j = 0; j < kCols; ++j) orow[tx + 16 * j] = acc[i][j] / l;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int sq, int sk, int causal, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (3 * kBlock * (D + 1) + kBlock * (kBlock + 1) +
                       2 * kBlock);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(sq / kBlock, hq, b);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), hq, hkv, sq, sk,
      causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// float32 only.  q (b, sq, hq, d); k, v (b, sk, hkv, d); o (b, sq, hq, d).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int b, int hq,
                                   int hkv, int sq, int sk, int d, int causal,
                                   void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || sq % kBlock != 0 || sk % kBlock != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || hq == 0 || sq == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(q, k, v, o, b, hq, hkv, sq, sk, causal, s);
    case 32: return launch<32>(q, k, v, o, b, hq, hkv, sq, sk, causal, s);
    case 64: return launch<64>(q, k, v, o, b, hq, hkv, sq, sk, causal, s);
    case 128: return launch<128>(q, k, v, o, b, hq, hkv, sq, sk, causal, s);
    case 256: return launch<256>(q, k, v, o, b, hq, hkv, sq, sk, causal, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
