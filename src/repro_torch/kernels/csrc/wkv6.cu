// Chunked RWKV6 ("Finch") WKV recurrence from a zero state, for NVIDIA
// Hopper (sm_90a), in two kernels.
//
// Replaces the Pallas kernel of the reference package:
//   wkv6_chunk_kernel + wkv6_state_kernel
//       <- repro/kernels/rwkv6_scan.py wkv6_chunked_kernel
//          (pallas_call at :91, body _kernel)
//
// What it computes, per (batch, head) and chunk of C = 32 steps, with
// L_j = sum_{i <= j} log w_i per channel (inclusive, within the chunk):
//   y_j  = (r_j exp(L_{j-1})) . S
//        + sum_{i < j} [sum_k r_jk k_ik exp(L_{j-1,k} - L_ik)] v_i
//        + (sum_k r_jk u_k k_jk) v_j
//   S   <- diag(exp(L_C)) S + sum_i (k_i exp(L_C - L_i))^T v_i
// from S = 0; y (B, T, H, V) and the final S (B, H, K, V) in float32.
// Inputs are float32, r, k, w (B, T, H, K) and v (B, T, H, V) in the
// model's layout, u (H, K), with K = V in {8, 16, 32, 64, 128}; T must be a
// multiple of C (the wrapper pads a ragged tail with r = k = v = 0 and
// w = 1, which leaves y and S exact).
//
// What bounds it on the H100: at the serving shape (B 4, T 512, H 40,
// K = V = 64) the inputs read once and y and S written once are 108 MB,
// 32 us at 3.35 TB/s; the float32 operations are fewer (about 22 us at
// 67 TFLOP/s).  Only the state carries from one chunk to the next, so only
// the state has to be walked in order.
//
// What the design does:
// * wkv6_chunk_kernel, one block of 256 threads per (b, h, chunk) (2560
//   blocks at the serving shape, three to an SM), computes everything that
//   depends on its chunk alone.  A warp takes one channel at a time with a
//   lane per step: log2 w (lg2.approx: its absolute error, 2^-22 a step, is
//   what the sums need), its prefix sums (L_j, L_{j-1}) and suffix sums
//   (L_C - L_j, summed from the end so that its rounding is that of its own
//   size, not of L) by shuffles; from them r_j exp(L_{j-1}), k_j
//   exp(L_C - L_j), exp(L_C) and the diagonal bonus.  The pairwise weights
//   att[j][i] (i < j) are exp2 of L_{j-1} - L_i, a difference <= 0 as the
//   reference computes it (never e^{L_{j-1}} e^{-L_i}: -L over a chunk
//   reaches the hundreds at the model's decays, and e^{-L} overflows past
//   88), summed over k by 4 x 4 register tiles of (j, i) in four k-quarters
//   (144 threads), whose float4 reads of the (K, C) arrays feed 16 terms,
//   and whose partial sums are stored element-major, a bank a tile.
//   Then y_intra = att v + diag v goes to y, and the chunk's record
//   (r exp(L_{j-1}) by channel, k exp(L_C - L) by step, exp(L_C)) to
//   scratch: 16.25 KB a chunk at K = 64, laid out as the second kernel
//   reads it.
// * wkv6_state_kernel, one block per (b, h, 16 V columns) (640 blocks at
//   the serving shape, five to an SM), walks the chunks with its (K, 16)
//   slice of S:
//     y_c += (r exp(L_{j-1})) S;   S <- diag(exp(L_C)) S + (k exp(L_C - L))^T v
//   Two warps take the first product (the sum over k in two halves, 4 x 4
//   register tiles), two warps the second (the state slice in registers,
//   4 x 4 a thread); each k or i step is two float4 reads from shared
//   memory for 16 FMAs.  The next chunk's record and v slice arrive by
//   cp.async while this one computes; y_intra is loaded into registers
//   before the chunk's products and added with the partial sums at the end.
// * All in float32 on the CUDA cores.  No TF32: it keeps three digits, and
//   the tolerance is 1e-4.
//
// What holds it back (H100 80GB HBM3, 700 W; chip_smoke.py's device
// times): the pair takes 0.17 ms at the serving shape, the chunk kernel
// 0.11 and the state kernel 0.065.  The chunk kernel's memory traffic and
// its arithmetic add up instead of overlapping, whether the next chunk's
// inputs are loaded ahead, the blocks are staggered or an SM holds four;
// the state kernel's walk spends most of each chunk step on its two
// products.  Prefetching either kernel's data further ahead into L2 made
// it slower.
//
// The C entry point takes device pointers, sizes, the scratch (its float
// count must be scratch_floats's) and a cudaStream_t, launches both
// kernels on that stream, does not synchronise, and returns
// cudaGetLastError() (cudaErrorInvalidValue for a shape it does not take).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kC = 32;                 // chunk: one step a lane
constexpr int kCP = kC + 4;            // row stride of the (K, C) arrays
constexpr int kThreads1 = 256;         // wkv6_chunk_kernel
constexpr int kWarps1 = kThreads1 / 32;
constexpr int kTiles = 36;             // 4 x 4 tiles of the lower triangle
constexpr int kSplits = 4;             // k-quarters of the pairwise sums
constexpr size_t kMaxSmem = 232448;    // a block's opt-in maximum
constexpr int kMaxDevices = 64;

static_assert(kTiles * kSplits <= kThreads1, "pairwise tiles");

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The record the first kernel leaves for the second, per (b, h, chunk), in
// floats: rd (K x C), r_j exp(L_{j-1}) by channel; kd (C x K),
// k_i exp(L_C - L_i) by step; el (K), exp(L_C).
template <int K>
struct Rec {
  static constexpr int kRd = 0;
  static constexpr int kKd = K * kC;
  static constexpr int kEl = 2 * K * kC;
  static constexpr int kFloats = 2 * K * kC + K;
};

// wkv6_chunk_kernel's shared memory, in floats.
template <int K>
struct Chunk {
  static constexpr int kR = 0;                    // r^T  (K x kCP)
  static constexpr int kK = kR + K * kCP;         // k^T
  static constexpr int kL = kK + K * kCP;         // L_j^T, log2 units
  static constexpr int kLp = kL + K * kCP;        // L_{j-1}^T
  static constexpr int kV = kLp + K * kCP;        // v (C x K)
  static constexpr int kA = kV + kC * K;          // att + diag (C x (C+1))
  static constexpr int kDiag = kA + kC * (kC + 1);
  static constexpr int kU = kDiag + kWarps1 * kC;
  static constexpr int kUnion = kU + K;           // kd staging, then partials
  static constexpr int kKdStage = kC * (K + 1);
  static constexpr int kPart = kSplits * kTiles * 16;
  static constexpr int kFloats =
      kUnion + (kKdStage > kPart ? kKdStage : kPart);
  static_assert(kFloats * 4 <= kMaxSmem, "beyond the shared-memory opt-in");
};

template <int K>
__global__ void __launch_bounds__(kThreads1)
    wkv6_chunk_kernel(const float* __restrict__ r, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ w,
                      const float* __restrict__ u, float* __restrict__ y,
                      float* __restrict__ rec, int t_len, int heads) {
  using S = Chunk<K>;
  using R = Rec<K>;
  extern __shared__ __align__(16) float smem[];
  float* rT = smem + S::kR;
  float* kT = smem + S::kK;
  float* lT = smem + S::kL;
  float* lpT = smem + S::kLp;
  float* vs = smem + S::kV;
  float* att = smem + S::kA;
  float* diagp = smem + S::kDiag;
  float* us = smem + S::kU;
  float* kd_stage = smem + S::kUnion;
  float* part = smem + S::kUnion;

  const int n_chunks = t_len / kC;
  const int c = blockIdx.x % n_chunks;
  const int bh = blockIdx.x / n_chunks;
  const int b = bh / heads, h = bh % heads;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t row = static_cast<size_t>(heads) * K;   // floats a step
  const size_t base = (static_cast<size_t>(b) * t_len +
                       static_cast<size_t>(c) * kC) * row +
                      static_cast<size_t>(h) * K;
  float* out = rec + static_cast<size_t>(blockIdx.x) * R::kFloats;

  // r, k and log2 w transposed to (K, C), a lane a step, so the stores hit
  // 32 banks; v as it lies
  for (int e = tid; e < kC * K / 4; e += kThreads1) {
    const int j = e % kC, q = e / kC;
    const size_t off = base + j * row + 4 * q;
    const float4 r4 = ldg4(r + off), k4 = ldg4(k + off), w4 = ldg4(w + off);
    const float ra[4] = {r4.x, r4.y, r4.z, r4.w};
    const float ka[4] = {k4.x, k4.y, k4.z, k4.w};
    const float wa[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      rT[(4 * q + a) * kCP + j] = ra[a];
      kT[(4 * q + a) * kCP + j] = ka[a];
      lT[(4 * q + a) * kCP + j] = __log2f(wa[a]);
    }
  }
  for (int e = tid; e < kC * K / 4; e += kThreads1) {
    const int j = e / (K / 4), q = e % (K / 4);
    *reinterpret_cast<float4*>(vs + j * K + 4 * q) =
        ldg4(v + base + j * row + 4 * q);
  }
  for (int e = tid; e < K; e += kThreads1) us[e] = u[h * K + e];
  __syncthreads();

  // per channel: prefix and suffix sums of log2 w over the chunk's steps
  float dj = 0.0f;                             // this warp's share of diag_j
  for (int ch = warp; ch < K; ch += kWarps1) {
    const float x = lT[ch * kCP + lane];
    float incl = x, tail = x;                  // sums over <= j and >= j
#pragma unroll
    for (int off = 1; off < kC; off <<= 1) {
      const float lo = __shfl_up_sync(0xffffffffu, incl, off);
      const float hi = __shfl_down_sync(0xffffffffu, tail, off);
      if (lane >= off) incl += lo;
      if (lane + off < kC) tail += hi;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);     // L_{j-1}
    float after = __shfl_down_sync(0xffffffffu, tail, 1);  // L_C - L_j
    if (lane == 0) excl = 0.0f;
    if (lane == kC - 1) after = 0.0f;
    const float total = __shfl_sync(0xffffffffu, tail, 0);  // L_C
    lT[ch * kCP + lane] = incl;
    lpT[ch * kCP + lane] = excl;
    const float rv = rT[ch * kCP + lane], kv = kT[ch * kCP + lane];
    out[R::kRd + ch * kC + lane] = rv * ex2(excl);
    kd_stage[lane * (K + 1) + ch] = kv * ex2(after);
    if (lane == 0) out[R::kEl + ch] = ex2(total);
    dj += rv * us[ch] * kv;
  }
  diagp[warp * kC + lane] = dj;
  __syncthreads();
  for (int e = tid; e < kC * K; e += kThreads1)
    out[R::kKd + e] = kd_stage[(e / K) * (K + 1) + e % K];
  __syncthreads();                             // the staging becomes `part`

  // pairwise weights: 4 x 4 tiles (j block >= i block) in k-quarters
  if (tid < kTiles * kSplits) {
    const int tile = tid % kTiles, s = tid / kTiles;
    int jb = 0;
    while ((jb + 1) * (jb + 2) / 2 <= tile) ++jb;
    const int ib = tile - jb * (jb + 1) / 2;
    float acc[4][4] = {};
    constexpr int kPer = K / kSplits;
    for (int ch = s * kPer; ch < (s + 1) * kPer; ++ch) {
      const float4 r4 = lds4(rT + ch * kCP + 4 * jb);
      const float4 p4 = lds4(lpT + ch * kCP + 4 * jb);
      const float4 k4 = lds4(kT + ch * kCP + 4 * ib);
      const float4 l4 = lds4(lT + ch * kCP + 4 * ib);
      const float ra[4] = {r4.x, r4.y, r4.z, r4.w};
      const float pa[4] = {p4.x, p4.y, p4.z, p4.w};
      const float ka[4] = {k4.x, k4.y, k4.z, k4.w};
      const float la[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb)
          // <= 0 wherever i < j; the clamp only keeps the discarded
          // (i >= j) half of a diagonal tile finite
          acc[a][bb] += ra[a] * ka[bb] * ex2(fminf(pa[a] - la[bb], 0.0f));
    }
    // element-major, so a warp's 32 tiles store to 32 banks
    float* dst = part + s * 16 * kTiles + tile;
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) dst[(a * 4 + bb) * kTiles] = acc[a][bb];
  }
  __syncthreads();

  // att[j][i] by (element, tile): the quarters' sum below the diagonal,
  // diag_j on it, 0 above it in the diagonal tiles (the tiles above those
  // are never read)
  for (int e = tid; e < 16 * kTiles; e += kThreads1) {
    const int tile = e % kTiles, el = e / kTiles;
    int jb = 0;
    while ((jb + 1) * (jb + 2) / 2 <= tile) ++jb;
    const int ib = tile - jb * (jb + 1) / 2;
    const int j = 4 * jb + el / 4, i = 4 * ib + el % 4;
    float a = 0.0f;
    if (i < j) {
#pragma unroll
      for (int s = 0; s < kSplits; ++s) a += part[(s * 16 + el) * kTiles + tile];
    } else if (i == j) {
#pragma unroll
      for (int wp = 0; wp < kWarps1; ++wp) a += diagp[wp * kC + j];
    }
    att[j * (kC + 1) + i] = a;
  }
  __syncthreads();

  // y_intra = att v, two steps by four columns a thread, into y
  for (int e = tid; e < (kC / 2) * (K / 4); e += kThreads1) {
    const int j0 = 2 * (e / (K / 4)), q = e % (K / 4);
    float4 a0 = make_float4(0.f, 0.f, 0.f, 0.f), a1 = a0;
    for (int i = 0; i <= j0 + 1; ++i) {
      const float4 v4 = lds4(vs + i * K + 4 * q);
      const float x0 = att[j0 * (kC + 1) + i];
      const float x1 = att[(j0 + 1) * (kC + 1) + i];
      a0.x += x0 * v4.x; a0.y += x0 * v4.y; a0.z += x0 * v4.z;
      a0.w += x0 * v4.w;
      a1.x += x1 * v4.x; a1.y += x1 * v4.y; a1.z += x1 * v4.z;
      a1.w += x1 * v4.w;
    }
    *reinterpret_cast<float4*>(y + base + j0 * row + 4 * q) = a0;
    *reinterpret_cast<float4*>(y + base + (j0 + 1) * row + 4 * q) = a1;
  }
}

// wkv6_state_kernel's shape and shared memory (floats), by head size.
template <int K>
struct State {
  static constexpr int kVS = K < 16 ? K : 16;      // V columns a block
  static constexpr int kCB = kVS / 4;              // their float4s
  static constexpr int kKH = K > 32 ? K / 32 : 1;  // parts of y's k sum
  static constexpr int kKPart = K / kKH;
  static constexpr int kNY = kKH * (kC / 4) * kCB;  // threads on y
  static constexpr int kNS = (K / 4) * kCB;          // threads on S
  static constexpr int kThreads = (kNY + kNS + 31) / 32 * 32;
  // blocks an SM must hold: 640 of 128 threads at K = 64 fill 132 SMs at
  // five, which caps the registers at 96
  static constexpr int kMinBlocks = K <= 64 ? 5 : 2;
  static constexpr int kStage = Rec<K>::kFloats + kC * kVS;   // record, v
  static constexpr int kS = 2 * kStage;            // S slice (K x kVS)
  static constexpr int kYp = kS + K * kVS;         // y parts 1.. (C x kVS)
  static constexpr int kFloats = kYp + (kKH - 1) * kC * kVS;
  static_assert(kFloats * 4 <= kMaxSmem, "beyond the shared-memory opt-in");
  static_assert(kStage % 4 == 0 && Rec<K>::kFloats % 4 == 0, "float4s");
};

template <int K>
__global__ void __launch_bounds__(State<K>::kThreads, State<K>::kMinBlocks)
    wkv6_state_kernel(const float* __restrict__ v,
                      const float* __restrict__ rec, float* __restrict__ y,
                      float* __restrict__ state_out, int t_len, int heads) {
  using S = State<K>;
  using R = Rec<K>;
  constexpr int kVS = S::kVS, kCB = S::kCB;
  extern __shared__ __align__(16) float smem[];
  float* s_sh = smem + S::kS;
  float* yp = smem + S::kYp;

  const int n_chunks = t_len / kC;
  constexpr int kSlices = K / kVS;
  const int slice = blockIdx.x % kSlices;
  const int bh = blockIdx.x / kSlices;
  const int b = bh / heads, h = bh % heads;
  const int col0 = slice * kVS;
  const int tid = threadIdx.x;
  const size_t row = static_cast<size_t>(heads) * K;
  const size_t base = static_cast<size_t>(b) * t_len * row +
                      static_cast<size_t>(h) * K + col0;    // (b, 0, h, col0)
  const float* rec_bh = rec + static_cast<size_t>(bh) * n_chunks * R::kFloats;

  auto stage_in = [&](int c) {
    float* dst = smem + (c & 1) * S::kStage;
    const float* src = rec_bh + static_cast<size_t>(c) * R::kFloats;
    for (int e = tid; e < R::kFloats / 4; e += S::kThreads)
      cp_async16(dst + 4 * e, src + 4 * e);
    for (int e = tid; e < kC * kCB; e += S::kThreads) {
      const int j = e / kCB, q = e % kCB;
      cp_async16(dst + R::kFloats + j * kVS + 4 * q,
                 v + base + (static_cast<size_t>(c) * kC + j) * row + 4 * q);
    }
  };

  // roles: y threads (kh, jb, cb), then S threads (kb, cb)
  const bool on_y = tid < S::kNY;
  const bool on_s = !on_y && tid < S::kNY + S::kNS;
  const int yi = tid, si = tid - S::kNY;
  const int cb = on_y ? yi % kCB : si % kCB;
  const int jb = (yi / kCB) % (kC / 4);
  const int kh = yi / (kCB * (kC / 4));
  const int kb = si / kCB;

  float st[4][4] = {};                         // S rows 4kb.., cols 4cb..
  for (int e = tid; e < K * kVS; e += S::kThreads) s_sh[e] = 0.0f;
  if (n_chunks > 0) stage_in(0);
  cp_async_commit();

  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) stage_in(c + 1);
    cp_async_commit();
    float4 y_in[4];                            // y_intra of this thread's tile
    const size_t y0 = base + (static_cast<size_t>(c) * kC + 4 * jb) * row +
                      4 * cb;
    if (on_y && kh == 0) {
#pragma unroll
      for (int a = 0; a < 4; ++a)
        y_in[a] = *reinterpret_cast<const float4*>(y + y0 + a * row);
    }
    cp_async_wait<1>();
    __syncthreads();                           // chunk c's record is here

    const float* stage = smem + (c & 1) * S::kStage;
    float acc[4][4] = {};
    if (on_y) {
      const float* rd = stage + R::kRd;
      for (int ch = kh * S::kKPart; ch < (kh + 1) * S::kKPart; ++ch) {
        const float4 r4 = lds4(rd + ch * kC + 4 * jb);
        const float4 s4 = lds4(s_sh + ch * kVS + 4 * cb);
        const float ra[4] = {r4.x, r4.y, r4.z, r4.w};
        const float sa[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) acc[a][bb] += ra[a] * sa[bb];
      }
      if (kh > 0) {
        float* dst = yp + (kh - 1) * kC * kVS;
#pragma unroll
        for (int a = 0; a < 4; ++a)
          *reinterpret_cast<float4*>(dst + (4 * jb + a) * kVS + 4 * cb) =
              make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
      }
    } else if (on_s) {
      const float* kd = stage + R::kKd;
      const float* el = stage + R::kEl;
      const float* vc = stage + R::kFloats;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float d = el[4 * kb + a];
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) st[a][bb] *= d;
      }
#pragma unroll 4
      for (int i = 0; i < kC; ++i) {
        const float4 k4 = lds4(kd + i * K + 4 * kb);
        const float4 v4 = lds4(vc + i * kVS + 4 * cb);
        const float ka[4] = {k4.x, k4.y, k4.z, k4.w};
        const float va[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) st[a][bb] += ka[a] * va[bb];
      }
    }
    __syncthreads();                           // S and the y parts are read

    if (on_s) {
#pragma unroll
      for (int a = 0; a < 4; ++a)
        *reinterpret_cast<float4*>(s_sh + (4 * kb + a) * kVS + 4 * cb) =
            make_float4(st[a][0], st[a][1], st[a][2], st[a][3]);
    } else if (on_y && kh == 0) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        float4 o = y_in[a];
        o.x += acc[a][0]; o.y += acc[a][1]; o.z += acc[a][2];
        o.w += acc[a][3];
#pragma unroll
        for (int p = 1; p < S::kKH; ++p) {
          const float4 q4 = lds4(yp + (p - 1) * kC * kVS +
                                 (4 * jb + a) * kVS + 4 * cb);
          o.x += q4.x; o.y += q4.y; o.z += q4.z; o.w += q4.w;
        }
        *reinterpret_cast<float4*>(y + y0 + a * row) = o;
      }
    }
  }
  cp_async_wait<0>();
  if (on_s) {
    float* dst = state_out + (static_cast<size_t>(bh) * K + 4 * kb) * K +
                 col0 + 4 * cb;
#pragma unroll
    for (int a = 0; a < 4; ++a)
      *reinterpret_cast<float4*>(dst + a * K) =
          make_float4(st[a][0], st[a][1], st[a][2], st[a][3]);
  }
}

template <int K>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, float* y, float* state, float* rec, int b, int t,
           int h, cudaStream_t stream) {
  const size_t smem1 = sizeof(float) * Chunk<K>::kFloats;
  const size_t smem2 = sizeof(float) * State<K>::kFloats;
  // per device, set once: the shared-memory opt-in of both kernels, and the
  // whole of the SM's 228 KB as shared memory for five state blocks
  static bool ready[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[device]) {
    err = cudaFuncSetAttribute(wkv6_chunk_kernel<K>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem1));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(wkv6_state_kernel<K>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem2));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          wkv6_state_kernel<K>, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[device] = true;
  }
  const long long chunks = static_cast<long long>(b) * h * (t / kC);
  if (chunks > 0)
    wkv6_chunk_kernel<K><<<static_cast<unsigned>(chunks), kThreads1, smem1,
                           stream>>>(r, k, v, w, u, y, rec, t, h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_state_kernel<K><<<b * h * (K / State<K>::kVS), State<K>::kThreads,
                         smem2, stream>>>(v, rec, y, state, t, h);
  return static_cast<int>(cudaGetLastError());
}

// Floats of scratch that wkv6_fwd needs: one record per (b, h, chunk).
long long scratch_floats(int b, int t, int h, int kd) {
  return static_cast<long long>(b) * h * (t / kC) * (2LL * kd * kC + kd);
}

}  // namespace

// r, k, w (b, t, h, kd); v (b, t, h, vd); u (h, kd); all float32, every
// pointer 16-byte aligned.  y (b, t, h, vd) and state (b, h, kd, vd)
// float32; scratch of scratch_floats(b, t, h, kd) floats.  chunk 32,
// kd = vd in {8, 16, 32, 64, 128}, t a multiple of 32.
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v,
                        const void* w, const void* u, void* y, void* state,
                        void* scratch, long long n_scratch, int b, int t,
                        int h, int kd, int vd, int chunk, void* stream) {
  if (chunk != kC || kd != vd || t < 0 || t % kC != 0 || b < 0 || h < 0 ||
      n_scratch != scratch_floats(b, t, h, kd))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(r) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(state) |
       reinterpret_cast<uintptr_t>(scratch)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || h == 0) return static_cast<int>(cudaSuccess);
  const auto* rf = static_cast<const float*>(r);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* wf = static_cast<const float*>(w);
  const auto* uf = static_cast<const float*>(u);
  auto* yf = static_cast<float*>(y);
  auto* sf = static_cast<float*>(state);
  auto* rec = static_cast<float*>(scratch);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kd) {
    case 8: return launch<8>(rf, kf, vf, wf, uf, yf, sf, rec, b, t, h, s);
    case 16: return launch<16>(rf, kf, vf, wf, uf, yf, sf, rec, b, t, h, s);
    case 32: return launch<32>(rf, kf, vf, wf, uf, yf, sf, rec, b, t, h, s);
    case 64: return launch<64>(rf, kf, vf, wf, uf, yf, sf, rec, b, t, h, s);
    case 128: return launch<128>(rf, kf, vf, wf, uf, yf, sf, rec, b, t, h, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
