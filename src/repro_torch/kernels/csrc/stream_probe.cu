// Stream bandwidth probes (read and write) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernels of the reference package:
//   stream_read_kernel  <- repro/kernels/stream_probe.py stream_read_kernel
//                          (pallas_call at :42, body _read_kernel)
//   stream_write_kernel <- repro/kernels/stream_probe.py stream_write_kernel
//                          (pallas_call at :59, body _write_kernel)
//
// What they compute: the read, the float32 sum of each `block` consecutive
// elements of x (N,), for any block that divides N; the write, y = x + 1
// in float32 (the reference's tile copy: bytes in == bytes out; its
// `block` only cuts the grid, so the kernel takes any N).
//
// The write is elementwise, so its bound is 8 N bytes over the memory rate
// (4 MiB, 1.3 us at the probe's 2 MiB): like the read's, its time is
// decided by how many SMs move bytes at once and what one launch costs.
// It is cut the same way, into slices of kWriteSlice elements, one CTA
// each (256 CTAs at 2 MiB), each thread moving 16 bytes at a time where x
// and y lie equally far from a 16-byte boundary (as any allocation and its
// output do), and scalars before and after that (and everywhere else); the
// result is bit-equal to x + 1.
//
// What bounds the read: bytes.  Each element is read once with one add,
// far below the card's arithmetic rate, so the least time is 4 N bytes
// over the memory rate (from L2 when the data sits there, as the probe's
// 2 MiB does).  At that size the bound is well under a microsecond, so what
// decides the time is how many SMs read at once and what one launch costs.
//
// What the read's design does: each block of x is cut into slices of kSlice
// elements and each slice is one CTA, so the probe's 2 MiB (8 blocks of
// 64 Ki) is 256 CTAs over all 132 SMs, not 8 programs on 8 of them.  A CTA
// reads its slice with 16-byte loads from its first 16-byte-aligned element
// on and with scalar loads before and after that (a block of 1001 elements
// is legal), reduces in registers, shuffles and shared memory, and writes
// one partial.  The last CTA of each block to finish, which it learns from
// an atomicAdd on the block's counter after a __threadfence(), sums that
// block's partials in a fixed order and resets the counter for the next
// launch.  So a call is one launch, and its result is the same from run to
// run.  The counters are zero-initialised scratch that the wrapper keeps
// for each stream, so no two launches use them at once.
//
// Each C entry point takes device pointers, sizes and a cudaStream_t,
// launches on that stream, does not synchronise, and returns
// cudaGetLastError() (cudaErrorInvalidValue for a shape it does not take).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlice = 2048;          // elements of x per CTA of the read
constexpr int kWriteSlice = 2048;     // elements of x per CTA of the write
constexpr int kWriteVec = kWriteSlice / 4 / kThreads;  // float4s a thread
static_assert(kWriteSlice % (4 * kThreads) == 0, "whole float4s a thread");

// Sum of v over the CTA, valid in thread 0; the order is fixed.
__device__ __forceinline__ float cta_sum(float v, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? red[lane] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
    stream_write_kernel(const float* __restrict__ x, float* __restrict__ y,
                        long long n) {
  const long long lo = static_cast<long long>(blockIdx.x) * kWriteSlice;
  const long long len = min(static_cast<long long>(kWriteSlice), n - lo);
  const float* p = x + lo;
  float* q = y + lo;
  const uintptr_t pa = reinterpret_cast<uintptr_t>(p);
  // 16-byte body only where x and y share their offset from a 16-byte
  // boundary; otherwise every element is a scalar head
  const long long head =
      (pa ^ reinterpret_cast<uintptr_t>(q)) % 16 != 0
          ? len
          : min(len, static_cast<long long>((16 - pa % 16) % 16 / 4));
  const long long n4 = (len - head) / 4;
  const float4* src = reinterpret_cast<const float4*>(p + head);
  float4* dst = reinterpret_cast<float4*>(q + head);
  if (head == 0 && len == kWriteSlice) {
    // a whole aligned slice: every load of the thread issued before its
    // first store, so the whole slice is in flight at once
    float4 f[kWriteVec];
#pragma unroll
    for (int v = 0; v < kWriteVec; ++v) f[v] = src[threadIdx.x + v * kThreads];
#pragma unroll
    for (int v = 0; v < kWriteVec; ++v)
      dst[threadIdx.x + v * kThreads] = make_float4(
          f[v].x + 1.0f, f[v].y + 1.0f, f[v].z + 1.0f, f[v].w + 1.0f);
    return;
  }
  for (long long i = threadIdx.x; i < head; i += kThreads) q[i] = p[i] + 1.0f;
  for (long long i = threadIdx.x; i < n4; i += kThreads) {
    const float4 f = src[i];
    dst[i] = make_float4(f.x + 1.0f, f.y + 1.0f, f.z + 1.0f, f.w + 1.0f);
  }
  for (long long i = head + 4 * n4 + threadIdx.x; i < len; i += kThreads)
    q[i] = p[i] + 1.0f;
}

__global__ void __launch_bounds__(kThreads)
    stream_read_kernel(const float* __restrict__ x, float* __restrict__ out,
                       float* partial, unsigned int* counter,
                       long long block, int slices) {
  __shared__ float red[kThreads / 32];
  __shared__ bool last;
  const long long blk = blockIdx.x / slices;
  const int slice = blockIdx.x % slices;
  const long long lo = static_cast<long long>(slice) * kSlice;
  const long long len = min(static_cast<long long>(kSlice), block - lo);
  const float* p = x + blk * block + lo;

  // scalar head up to the first 16-byte boundary, 16-byte body, scalar tail
  const long long head =
      min(len, static_cast<long long>(
                   (16 - reinterpret_cast<uintptr_t>(p) % 16) % 16 / 4));
  const long long n4 = (len - head) / 4;
  const float4* body = reinterpret_cast<const float4*>(p + head);
  float acc = 0.0f;
  if (threadIdx.x < head) acc += p[threadIdx.x];
  for (long long i = threadIdx.x; i < n4; i += kThreads) {
    const float4 f = body[i];
    acc += (f.x + f.y) + (f.z + f.w);
  }
  for (long long i = head + 4 * n4 + threadIdx.x; i < len; i += kThreads)
    acc += p[i];
  acc = cta_sum(acc, red);

  if (threadIdx.x == 0) {
    partial[blockIdx.x] = acc;
    __threadfence();                   // the partial before the count
    last = atomicAdd(&counter[blk], 1u) == static_cast<unsigned>(slices - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();                     // the count before the partials
  float sum = 0.0f;
  for (int i = threadIdx.x; i < slices; i += kThreads)
    sum += __ldcg(&partial[blk * slices + i]);
  sum = cta_sum(sum, red);
  if (threadIdx.x == 0) {
    out[blk] = sum;
    counter[blk] = 0u;                 // ready for the next launch
  }
}

}  // namespace

// x (n,) float32 -> out (n / block,) float32 block sums.  partial holds
// (n / block) * ceil(block / 2048) floats; counter holds n / block zeroed
// unsigned ints and is left zeroed.
extern "C" int stream_read_fwd(const void* x, void* out, void* partial,
                               void* counter, long long n, long long block,
                               void* stream) {
  if (block <= 0 || n < 0 || n % block != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const long long slices = (block + kSlice - 1) / kSlice;
  const long long ctas = n / block * slices;
  if (ctas > INT_MAX || slices > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  stream_read_kernel<<<static_cast<unsigned>(ctas), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out),
      static_cast<float*>(partial), static_cast<unsigned int*>(counter),
      block, static_cast<int>(slices));
  return static_cast<int>(cudaGetLastError());
}

// x (n,) float32 -> y (n,) float32, y = x + 1.
extern "C" int stream_write_fwd(const void* x, void* y, long long n,
                                void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const long long ctas = (n + kWriteSlice - 1) / kWriteSlice;
  if (ctas > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  stream_write_kernel<<<static_cast<unsigned>(ctas), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), n);
  return static_cast<int>(cudaGetLastError());
}
