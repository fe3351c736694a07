// K3 overlay_probe: per query, the rank in the sorted delta-overlay pack
// and the overlay's verdict at that rank.
//
// Replaces the TPU kernel src/repro/kernels/overlay_probe/overlay_probe.py:
// overlay_probe_planes (body _kernel).  Per query: pos = count of overlay
// keys < q; hit = pos < cap and key[pos] == q; tomb = hit and the entry is
// a tombstone; payload = pay[pos] when pos < cap (whether or not it hit),
// else 0.  Output equals the TPU kernel's bit for bit.
//
// What bounds it on the H100: latency.  The TPU kernel keeps the whole
// overlay resident in VMEM and compares every key against every query: at
// the served pack's cap = 2^24 that is 1.4e11 compares for 8192 queries.
// The pack is sorted with its u64-max padding last, so count(key < q) is
// the lower bound of q, and a query's time is the chain of dependent loads
// that finds it.  A binary search, a thread a query, made 24-25 of them at
// cap = 2^24.  Here a group of G lanes takes a query and runs the
// (G + 1)-way lower bound K1 runs with a whole warp (group_lower_bound,
// device_common.cuh): each round the G lanes load the splitters of G + 1
// equal parts and a ballot picks the part, so 2^24 slots take 5 dependent
// rounds at G = 32.  The group's first lane then loads key, payload and
// tombstone at the rank together (ld_i64), one more trip: 7 a query with
// its key.  A query past the batch keeps its lanes to the search's end, as
// every ballot is the whole warp's.  A query of u64 max meets the
// padding: hit, not a tombstone, the padding's payload (0), as in the TPU
// kernel.
//
// G comes from the batch (ops.k3_lanes): the most lanes, up to a warp, for
// which the batch's Q * G threads still fit on the card at once.  A warp a
// query is fastest while the batch is one wave; past it, Q warps run in
// waves, each as long as the whole chain, and a group of fewer lanes makes
// more rounds in one wave instead (G = 1 is a binary search).
//
// The pack is the port's overlay layout, one (3, cap) int64 tensor: biased
// keys (u64 ^ 2^63, so signed order is key order), payload bits,
// tombstones 0/1.
#include <cstdint>
#include <cuda_runtime.h>

#include "device_common.cuh"

namespace {

constexpr int THREADS = 256;

template <int G>
__global__ void __launch_bounds__(THREADS)
overlay_probe_kernel(const int64_t* __restrict__ pack, int cap,
                     const int64_t* __restrict__ queries, int nq,
                     int64_t* __restrict__ out_pay,
                     bool* __restrict__ out_hit,
                     bool* __restrict__ out_tomb) {
  const int lane = threadIdx.x & 31;
  const int l = lane & (G - 1);
  const unsigned mask = (((1u << (G - 1)) << 1) - 1u) << (lane & ~(G - 1));
  const int qi = blockIdx.x * (THREADS / G) + threadIdx.x / G;
  // a query past the batch searches nothing (n = 0) but keeps its lanes
  // in the warp's ballots
  const bool live = qi < nq;
  const int64_t q = live ? queries[qi] : 0;
  const int pos = group_lower_bound<G>(pack, live ? cap : 0, q, l, mask);
  if (!live || l != 0) return;
  bool hit = false, tomb = false;
  int64_t pay = 0;
  if (pos < cap) {
    const int64_t key = ld_i64(pack + pos);
    pay = ld_i64(pack + static_cast<size_t>(cap) + pos);
    const int64_t t = ld_i64(pack + 2 * static_cast<size_t>(cap) + pos);
    hit = key == q;
    tomb = hit && t != 0;
  }
  out_pay[qi] = pay;
  out_hit[qi] = hit;
  out_tomb[qi] = tomb;
}

template <int G>
void launch(const void* pack, int cap, const void* queries, int nq,
            void* out_pay, void* out_hit, void* out_tomb,
            cudaStream_t stream) {
  const long long threads = static_cast<long long>(nq) * G;
  const int blocks = static_cast<int>((threads + THREADS - 1) / THREADS);
  overlay_probe_kernel<G><<<blocks, THREADS, 0, stream>>>(
      static_cast<const int64_t*>(pack), cap,
      static_cast<const int64_t*>(queries), nq,
      static_cast<int64_t*>(out_pay), static_cast<bool*>(out_hit),
      static_cast<bool*>(out_tomb));
}

}  // namespace

// lanes: the group size G, a power of two up to 32 (ops.k3_lanes)
extern "C" int overlay_probe_launch(const void* pack, int cap,
                                    const void* queries, int nq,
                                    void* out_pay, void* out_hit,
                                    void* out_tomb, int lanes, void* stream) {
  if (nq > 0) {
    const auto st = static_cast<cudaStream_t>(stream);
    void (*fn)(const void*, int, const void*, int, void*, void*, void*,
               cudaStream_t);
    switch (lanes) {
      case 32: fn = launch<32>; break;
      case 16: fn = launch<16>; break;
      case 8: fn = launch<8>; break;
      case 4: fn = launch<4>; break;
      case 2: fn = launch<2>; break;
      case 1: fn = launch<1>; break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
    fn(pack, cap, queries, nq, out_pay, out_hit, out_tomb,
       static_cast<cudaStream_t>(stream));
  }
  return static_cast<int>(cudaGetLastError());
}
