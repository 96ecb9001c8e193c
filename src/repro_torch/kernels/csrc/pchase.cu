// Pointer-chase probe kernels for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernels of the reference package:
//   pchase_batch_kernel   <- repro/kernels/pchase_probe.py pchase_kernel_batch
//                            (body _batch_kernel)
//   eviction_batch_kernel <- repro/kernels/pchase_probe.py eviction_kernel_batch
//                            (body _evict_kernel)
// and holds one yardstick of its own, chase_floor_kernel, which no path
// launches (chip_smoke.py alone) and which has no counterpart there.
//
// What bounds them: the dependent-load latency.  Every load's address is the
// previous load's value, so a row costs steps x (latency of the level its
// footprint lives in) and no amount of bandwidth or arithmetic shortens it.
// A row moves 4 bytes per step; the card's memory rate and issue rate are
// both orders of magnitude beyond what one serial chain can use.  The
// latency of each level is not a data-sheet number, so chase_floor measures
// it on the card: one thread, a chain warmed by one full pass, then an
// unrolled run of dependent ld.global loads with nothing else on the chain
// (no check, no checksum, a base pointer held in a register), timed by
// clock64() and %globaltimer.  Its cycles and ns per load at a footprint
// are the floor of that level; a chase row's bound is its steps times the
// floor of the level its footprint lives in (chip_smoke.py).
//
// What the design does about it: nothing may overlap the loads of one row,
// so one thread walks one row (<<<rows, 1>>>) and the rows of a launch run
// at once on different SMs; a launch costs about its longest row.  Between
// two loads of a row sits only what forms the next address: one unsigned
// min that clamps the loaded value into [0, n), so that no read leaves the
// row, and one wide multiply-add of that 32-bit index onto the row's base.
// Everything else is off the chain: the checksum (summed in uint32_t,
// where overflow wraps by definition, stored as int32_t: the reference's
// int32 wrap-around without C++'s undefined signed overflow) and the range
// check, kept as a running unsigned max of the loaded values and read once
// at the end of the walk.  There is no branch on a loaded value.  The walk
// is unrolled by 8 with a remainder loop; the chain length stays kernel
// data, read from device memory per row (the chain-lengths-as-data
// contract), so one compiled kernel serves every sweep.  The loads are
// plain ld.global (no const __restrict__, no __ldg, no .cg, no shared
// memory, no prefetch), so the chain takes the ordinary L1 -> L2 -> HBM
// path the probes are meant to time.
//
// The contract: a row whose loaded values all lie in [0, n) gives exactly
// the reference's final cursor and wrapped checksum.  A row that loads a
// value outside [0, n) walks on from the clamped slot and ends with cursor
// -1; its checksum is then unspecified.  An eviction row is -1 when either
// of its phases left its range.
//
// The C entry points take device pointers, sizes and a cudaStream_t, launch
// on that stream, do not synchronise, and return cudaGetLastError();
// probe_error_string names such a code.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kUnroll = 8;        // loads of the walk's unrolled body

// The global address of `row`, from an instruction the compiler cannot see
// through: with the row's base in a register of its own, each address on
// the chain is one wide multiply-add of the 32-bit index onto it.  (Left
// visible, the row offset is folded into every address: r n + j, shifted
// and added in 64 bits, four instructions on the chain instead of one.)
__device__ __forceinline__ uint64_t global_base(const int32_t* row) {
  uint64_t base;
  asm("cvta.to.global.u64 %0, %1;" : "=l"(base) : "l"(row));
  return base;
}

// A plain ld.global (the default .ca: L1, then L2, then HBM) of slot j.
__device__ __forceinline__ uint32_t load(uint64_t base, uint32_t j) {
  uint32_t v;
  asm volatile("ld.global.u32 %0, [%1];" : "=r"(v) : "l"(base + 4ull * j));
  return v;
}

// Walks the row at `base` from slot 0 for `steps` loads, adding every
// loaded value to `checksum`.  Returns the final cursor; `left` becomes
// true when a loaded value fell outside [0, n).  n >= 1.
__device__ __forceinline__ uint32_t walk(uint64_t base, uint32_t n,
                                         int32_t steps, uint32_t& checksum,
                                         bool& left) {
  const uint32_t top = n - 1;
  uint32_t j = 0, sum = checksum, high = 0;
  int32_t rest = steps;
  for (; rest >= kUnroll; rest -= kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t v = load(base, j);
      j = min(v, top);
      sum += v;
      high = max(high, v);
    }
  }
  for (; rest > 0; --rest) {
    const uint32_t v = load(base, j);
    j = min(v, top);
    sum += v;
    high = max(high, v);
  }
  checksum = sum;
  left = left || high > top;
  return j;
}

// One row of `n` slots walked for `steps` loads into (cursor, checksum);
// a row of no slots has nothing to load and is -1 if asked to.
__device__ __forceinline__ uint32_t walk_row(const int32_t* row, int n,
                                             int32_t steps, uint32_t& checksum,
                                             bool& left) {
  if (n <= 0) {
    left = left || steps > 0;
    return 0;
  }
  return walk(global_base(row), static_cast<uint32_t>(n), steps, checksum,
              left);
}

__global__ void pchase_batch_kernel(const int32_t* perms, const int32_t* steps,
                                    int32_t* out, int n) {
  const int r = blockIdx.x;
  uint32_t checksum = 0;
  bool left = false;
  const uint32_t cursor = walk_row(perms + static_cast<size_t>(r) * n, n,
                                   steps[r], checksum, left);
  out[2 * r] = left ? -1 : static_cast<int32_t>(cursor);
  out[2 * r + 1] = static_cast<int32_t>(checksum);
}

__global__ void eviction_batch_kernel(const int32_t* perms,
                                      const int32_t* evictors,
                                      const int32_t* warm,
                                      const int32_t* probe, int32_t* out,
                                      int n, int m) {
  const int r = blockIdx.x;
  uint32_t checksum = 0;
  bool left = false;
  walk_row(evictors + static_cast<size_t>(r) * m, m, warm[r], checksum, left);
  const uint32_t cursor = walk_row(perms + static_cast<size_t>(r) * n, n,
                                   probe[r], checksum, left);
  out[2 * r] = left ? -1 : static_cast<int32_t>(cursor);
  out[2 * r + 1] = static_cast<int32_t>(checksum);
}

// ---------------------------------------------------------------------------
// The floor: dependent-load latency with nothing else on the chain.
// ---------------------------------------------------------------------------
constexpr int kFloorUnroll = 256;   // loads of one straight-line run

__device__ __forceinline__ uint64_t globaltimer() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// One thread: `warm` loads from slot 0, then `rounds` runs of kFloorUnroll
// dependent loads between two readings of clock64() and %globaltimer.
// What sits on the chain besides the load, by variant:
//   0 "load"  - the address alone: j = base[j];
//   1 "clamp" - walk()'s chain: j = min(base[j], n - 1);
//   2 "check" - a walk that returns on a bad value: a signed index, a
//               compare and an early exit on the loaded value, and the
//               checksum.
// out: [SM cycles, ns, loads timed (-1 if the chain left [0, n)), the
// final cursor plus the checksum, which keeps the chain live].
template <int kVariant>
__global__ void chase_floor_kernel(const uint32_t* base, uint32_t n, int warm,
                                   int rounds, long long* out) {
  const uint32_t top = n - 1;
  const int32_t* signed_base = reinterpret_cast<const int32_t*>(base);
  uint32_t j = 0, sum = 0;
  long long loads = static_cast<long long>(rounds) * kFloorUnroll;
  for (int i = 0; i < warm; ++i) j = min(base[j], top);
  const long long c0 = clock64();
  const uint64_t t0 = globaltimer();
  for (int r = 0; r < rounds; ++r) {
#pragma unroll
    for (int u = 0; u < kFloorUnroll; ++u) {
      if constexpr (kVariant == 0) {
        j = base[j];
      } else if constexpr (kVariant == 1) {
        j = min(base[j], top);
      } else {
        const int32_t nxt = signed_base[static_cast<int32_t>(j)];
        if (static_cast<uint32_t>(nxt) > top) {
          loads = -1;
          goto done;
        }
        j = static_cast<uint32_t>(nxt);
        sum += j;
      }
    }
  }
done:
  const long long c1 = clock64();
  const uint64_t t1 = globaltimer();
  out[0] = c1 - c0;
  out[1] = static_cast<long long>(t1 - t0);
  out[2] = loads;
  out[3] = static_cast<long long>(j) + sum;
}

}  // namespace

extern "C" int pchase_batch(const void* perms, const void* steps, void* out,
                            int rows, int n, void* stream) {
  if (rows > 0)
    pchase_batch_kernel<<<rows, 1, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(perms), static_cast<const int32_t*>(steps),
        static_cast<int32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int eviction_batch(const void* perms, const void* evictors,
                              const void* warm, const void* probe, void* out,
                              int rows, int n, int m, void* stream) {
  if (rows > 0)
    eviction_batch_kernel<<<rows, 1, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(perms),
        static_cast<const int32_t*>(evictors),
        static_cast<const int32_t*>(warm), static_cast<const int32_t*>(probe),
        static_cast<int32_t*>(out), n, m);
  return static_cast<int>(cudaGetLastError());
}

// chain: n int32 slots, each holding the next slot of the chain (values in
// [0, n)); out: four int64 (see chase_floor_kernel); variant 0, 1 or 2.
extern "C" int chase_floor(const void* chain, int n, int warm, int rounds,
                           int variant, void* out, void* stream) {
  if (n <= 0 || warm < 0 || rounds <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* base = static_cast<const uint32_t*>(chain);
  auto* o = static_cast<long long*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t slots = static_cast<uint32_t>(n);
  switch (variant) {
    case 0: chase_floor_kernel<0><<<1, 1, 0, s>>>(base, slots, warm, rounds, o);
      break;
    case 1: chase_floor_kernel<1><<<1, 1, 0, s>>>(base, slots, warm, rounds, o);
      break;
    case 2: chase_floor_kernel<2><<<1, 1, 0, s>>>(base, slots, warm, rounds, o);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* probe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
