// Device helpers shared by K1 fused_lookup, K3 overlay_probe and K5
// inner_probe (csrc/fused_lookup.cu, overlay_probe.cu, inner_probe.cu).
// Each source includes this header and builds into its own library; the
// build tag hashes every csrc/*.cuh beside the source, so an edited header
// never loads a stale build (kernels/_build.py).
#pragma once

#include <cstdint>

constexpr unsigned FULL_MASK = 0xffffffffu;

// global loads nvcc may not move (asm volatile, through the read-only
// path): a record's fields issue back to back, one round trip, and none is
// sunk below a loop's exit, as nvcc does to a plain load whose value is
// used only after the loop (it split the slot record into two trips)
__device__ __forceinline__ int ld_i32(const int32_t* p) {
  int v;
  asm volatile("ld.global.nc.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ int64_t ld_i64(const int64_t* p) {
  int64_t v;
  asm volatile("ld.global.nc.s64 %0, [%1];" : "=l"(v) : "l"(p));
  return v;
}

// count(ok[0..n) < q) over a sorted pack (padding sorts last) by a
// (G + 1)-way lower bound run by a group of G lanes (G a power of two up to
// 32, the group aligned in its warp, `mask` its lanes): the count lies in
// [lo, lo + n]; lane l of the group reads the splitter closing the l-th of
// G + 1 parts of `step` candidates, the group's bits of the warp's ballot
// of those below q are a prefix of c lanes, and the count lies in part c.
// n becomes floor(n / (G + 1)): floor(log_{G+1}(n)) + 1 dependent rounds,
// 5 at 2^24 for a warp.  Groups of 2-16 lanes run every round with the
// whole warp, so the ballot is the warp's (groups that pass different
// masks to one vote are run one after another): a lane whose group is
// done, or that has no query (n = 0), loads nothing.  A lane alone (G = 1)
// votes with no one: a binary search.
template <int G>
__device__ __forceinline__ int group_lower_bound(const int64_t* ok, int n,
                                                 int64_t q, int l,
                                                 unsigned mask) {
  int lo = 0;
  while (G == 32 || G == 1 ? n > 0 : __any_sync(FULL_MASK, n > 0)) {
    const int step = n / (G + 1) + 1;
    const int j = (l + 1) * step - 1;
    const bool below = j < n && ok[lo + j] < q;
    const int c = G == 1 ? below
                         : __popc(__ballot_sync(FULL_MASK, below) & mask);
    lo += c * step;
    n = min(step - 1, n - c * step);
  }
  return lo;
}

// the 33-way search of a whole warp (K1's overlay probe)
__device__ __forceinline__ int warp_lower_bound(const int64_t* ok, int cap,
                                                int64_t q, int lane) {
  return group_lower_bound<32>(ok, cap, q, lane, FULL_MASK);
}
