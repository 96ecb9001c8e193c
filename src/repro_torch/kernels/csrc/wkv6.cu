// Chunked RWKV6 ("Finch") WKV recurrence from a zero state, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the Pallas kernel of the reference package:
//   wkv6_kernel <- repro/kernels/rwkv6_scan.py wkv6_chunked_kernel
//                  (pallas_call at :91, body _kernel)
//
// What it computes, per (batch, head) and chunk of C steps, with
// L_j = sum_{i <= j} log w_i per channel (inclusive, within the chunk):
//   y_j  = (r_j exp(L_{j-1})) . S
//        + sum_{i < j} [sum_k r_jk k_ik exp(L_{j-1,k} - L_ik)] v_i
//        + (sum_k r_jk u_k k_jk) v_j
//   S   <- diag(exp(L_C)) S + sum_i (k_i exp(L_C - L_i))^T v_i
// from S = 0; y (B, T, H, V) and the final S (B, H, K, V) in float32.
// Inputs are float32, r, k, w (B, T, H, K) and v (B, T, H, V) in the
// model's layout, u (H, K); T must be a multiple of C (the wrapper pads a
// ragged tail with r = k = v = 0 and w = 1, which leaves y and S exact).
//
// What bounds it on the H100: at the serving shapes (B 4, T 512, H 40,
// K = V = 64, C = 32) the bytes bound (inputs read once, y and S written
// once, about 108 MB) is some 30 us and the float32 operations about the
// same.  The kernel is latency-bound instead: the chunks of one head are a
// serial chain, and B x H = 160 blocks barely fill 132 SMs.
//
// What the design does: one block of 256 threads per (b, h) loops over the
// chunks; the (K, V) state stays in shared memory the whole way (16 KB at
// K = V = 64) and never goes to device memory between chunks.  The Pallas
// kernel materialises a (C, C, K) pairwise-decay tensor, 256 KB at C = 32,
// K = 64 and beyond a block's 227 KB; here each pairwise weight
// att[j][i] is accumulated over k with the decay exp(L_{j-1} - L_i)
// computed in place, which is <= 1 for i < j, so nothing overflows.  The
// (C, K) rows sit at a stride of K + 1, so the 32 threads of a warp that
// read 32 rows at one channel hit 32 banks.
//
// The C entry point takes device pointers, sizes and a cudaStream_t,
// launches on that stream, does not synchronise, and returns
// cudaGetLastError() (cudaErrorInvalidValue for a shape it does not take).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 232448;        // a block's opt-in maximum

size_t smem_floats(int kd, int vd, int chunk) {
  const size_t kp = static_cast<size_t>(kd) + 1;
  return static_cast<size_t>(kd) * vd + 6 * chunk * kp +
         static_cast<size_t>(chunk) * vd +
         static_cast<size_t>(chunk) * (chunk + 1) + chunk + kd;
}

__global__ void __launch_bounds__(kThreads)
    wkv6_kernel(const float* r, const float* k, const float* v,
                const float* w, const float* u, float* y, float* state_out,
                int t_len, int heads, int kd, int vd, int chunk) {
  extern __shared__ float smem[];
  const int kp = kd + 1;
  float* S = smem;                            // kd x vd state
  float* rs = S + kd * vd;                    // C x kp  r
  float* ks = rs + chunk * kp;                // C x kp  k
  float* lp = ks + chunk * kp;                // C x kp  L_{j-1}
  float* cs = lp + chunk * kp;                // C x kp  L_j
  float* rd = cs + chunk * kp;                // C x kp  r_j exp(L_{j-1})
  float* kdec = rd + chunk * kp;              // C x kp  k_i exp(L_C - L_i)
  float* vs = kdec + chunk * kp;              // C x vd  v
  float* att = vs + chunk * vd;               // C x (C + 1)
  float* diag = att + chunk * (chunk + 1);    // C
  float* us = diag + chunk;                   // kd

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const size_t row_k = static_cast<size_t>(heads) * kd;
  const size_t row_v = static_cast<size_t>(heads) * vd;
  const size_t base_k = static_cast<size_t>(b) * t_len * row_k +
                        static_cast<size_t>(h) * kd;
  const size_t base_v = static_cast<size_t>(b) * t_len * row_v +
                        static_cast<size_t>(h) * vd;
  const int tid = threadIdx.x;

  for (int e = tid; e < kd * vd; e += kThreads) S[e] = 0.0f;
  for (int e = tid; e < kd; e += kThreads) us[e] = u[h * kd + e];

  for (int t0 = 0; t0 < t_len; t0 += chunk) {
    __syncthreads();                          // last chunk's update is done
    for (int e = tid; e < chunk * kd; e += kThreads) {
      const int j = e / kd, c = e % kd;
      const size_t off = base_k + (t0 + j) * row_k + c;
      rs[j * kp + c] = r[off];
      ks[j * kp + c] = k[off];
      cs[j * kp + c] = logf(w[off]);          // log w, summed below
    }
    for (int e = tid; e < chunk * vd; e += kThreads) {
      const int j = e / vd, c = e % vd;
      vs[j * vd + c] = v[base_v + (t0 + j) * row_v + c];
    }
    __syncthreads();

    for (int c = tid; c < kd; c += kThreads) {
      float total = 0.0f;
      for (int j = 0; j < chunk; ++j) {
        const float lw = cs[j * kp + c];
        total += lw;
        cs[j * kp + c] = total;
        lp[j * kp + c] = total - lw;
      }
    }
    __syncthreads();

    const float* last = cs + (chunk - 1) * kp;  // L_C per channel
    for (int e = tid; e < chunk * kd; e += kThreads) {
      const int j = e / kd, c = e % kd;
      rd[j * kp + c] = rs[j * kp + c] * expf(lp[j * kp + c]);
      kdec[j * kp + c] = ks[j * kp + c] * expf(last[c] - cs[j * kp + c]);
    }
    for (int j = tid; j < chunk; j += kThreads) {
      float d = 0.0f;
      for (int c = 0; c < kd; ++c)
        d += rs[j * kp + c] * us[c] * ks[j * kp + c];
      diag[j] = d;
    }
    for (int e = tid; e < chunk * chunk; e += kThreads) {
      const int j = e / chunk, i = e % chunk;
      float a = 0.0f;
      if (i < j) {
        for (int c = 0; c < kd; ++c)
          a += rs[j * kp + c] * ks[i * kp + c] *
               expf(lp[j * kp + c] - cs[i * kp + c]);
      }
      att[j * (chunk + 1) + i] = a;
    }
    __syncthreads();

    for (int e = tid; e < chunk * vd; e += kThreads) {
      const int j = e / vd, c = e % vd;
      float acc = 0.0f;
      for (int kk = 0; kk < kd; ++kk) acc += rd[j * kp + kk] * S[kk * vd + c];
      float intra = 0.0f;
      for (int i = 0; i < j; ++i)
        intra += att[j * (chunk + 1) + i] * vs[i * vd + c];
      acc += intra;
      acc += diag[j] * vs[j * vd + c];
      y[base_v + (t0 + j) * row_v + c] = acc;
    }
    __syncthreads();                          // y has read the old state

    for (int e = tid; e < kd * vd; e += kThreads) {
      const int kk = e / vd, c = e % vd;
      float carry = 0.0f;
      for (int i = 0; i < chunk; ++i)
        carry += kdec[i * kp + kk] * vs[i * vd + c];
      S[e] = expf(last[kk]) * S[e] + carry;
    }
  }
  __syncthreads();
  float* out = state_out + static_cast<size_t>(bh) * kd * vd;
  for (int e = tid; e < kd * vd; e += kThreads) out[e] = S[e];
}

}  // namespace

// r, k, w (b, t, h, kd); v (b, t, h, vd); u (h, kd); all float32.
// y (b, t, h, vd) and state (b, h, kd, vd) float32.
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v,
                        const void* w, const void* u, void* y, void* state,
                        int b, int t, int h, int kd, int vd, int chunk,
                        void* stream) {
  if (chunk <= 0 || kd <= 0 || vd <= 0 || t % chunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * smem_floats(kd, vd, chunk);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || h == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_kernel<<<b * h, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<float*>(y),
      static_cast<float*>(state), t, h, kd, vd, chunk);
  return static_cast<int>(cudaGetLastError());
}
