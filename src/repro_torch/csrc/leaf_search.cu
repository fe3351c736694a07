// K4 leaf_search: per query, search one row of a sorted key pool: the rank
// of the query in the row (count of keys < q), found, and the payload at
// that rank.
//
// Replaces the TPU kernel src/repro/kernels/leaf_search/leaf_search.py:
// leaf_search_planes (body _kernel).  Output equals it bit for bit: the
// payload at the rank is returned whether or not the key matches, and 0
// when the rank equals the row width C (the query is above every key of
// the row); found = rank < C and row[rank] == q.  The staged read uses it
// twice: on PA/BT rows (payload = the leaf row id, C <= 64 and up to 1020)
// and on the leaf row (payload = the value, C = 256).  Rows are clamped
// into [0, n_rows), as the plain version does.
//
// What bounds it on the H100: bytes, then latency.  The TPU kernel DMAs
// the whole row into VMEM and reduces a whole-row compare on the VPU; a
// warp a query doing the same here (the first port: lane l counted keys
// l, l + 32, ...) read every query's whole row, 2 KB at C = 256, at about
// half of HBM's rate on random rows.  K1's redesign put a whole row in
// flight at once (cp.async) and its rate stayed at half, so reading the
// row faster is not the lever; reading less of it is.  The row is sorted
// (padding, u64 max, last), so count(key < q) is its lower bound, and a
// search touches only the sectors its probes land in.
//
// Design: a group of G lanes takes a query and runs the (G + 1)-way lower
// bound K1 and K3 run (group_lower_bound, device_common.cuh) over the
// query's row: each round the G lanes load the splitters of G + 1 equal
// parts together and a ballot picks the part, floor(log_{G+1} C) + 1
// dependent rounds (2 at C = 256 for G = 16).  The group's first
// lane then loads the key and the payload at the rank together (ld_i64),
// one trip: query and row id, the rounds, the record.  A query past the
// batch keeps its lanes in the warp's ballots with nothing to search.
// Rows of odd C are not 16-byte aligned, so every load is a scalar 8-byte
// one.  Keys arrive biased (u64 ^ 2^63 as int64, so signed order is key
// order).
//
// G comes from the batch (ops.k4_lanes): 16 lanes, no more than cover the
// row, halved while the batch's Q * G threads pass one 256-thread block an
// SM.  Measured, the time follows the sectors the batch touches once a few
// thousand queries are in flight, and a narrower group touches fewer (at
// C = 256 about 6 sectors a query at G = 1, 7 at 2, 10 at 4, 14 at 8, 19
// at 16), at more dependent rounds (9, 6, 4, 3, 2): at 8192 queries G = 2
// and 4 are fastest, 16 was predicted and is 20% slower; at 256-1024
// queries the rounds rule and 8 or 16 lanes are fastest.
//
// Tried and dropped: the first port's warp a query over the whole row (its
// 8 row loads a lane are 7 in flight, then one more trip, as its SASS
// shows); G = 32 (its splitters, 64 B apart, touch about half the row's
// sectors, 33 of 64 a query); G = 16 at every batch.  Not taken: staging
// the row in shared memory (K1's staged rank) reads the whole row and, in
// K1, was 2.5-4.5% slower than ranking from global memory; K4 has no
// overlay probe for the copies to overlap.
#include <cstdint>
#include <cuda_runtime.h>

#include "device_common.cuh"

namespace {

constexpr int THREADS = 256;

template <int G>
__global__ void __launch_bounds__(THREADS)
leaf_search_kernel(const int64_t* __restrict__ keys,
                   const int64_t* __restrict__ pay, int n_rows, int cap,
                   const int32_t* __restrict__ rows,
                   const int64_t* __restrict__ queries, int nq,
                   int64_t* __restrict__ out_pay,
                   bool* __restrict__ out_found) {
  const LaneGroup<G, THREADS> g;
  const int qi = g.qi;
  // a query past the batch searches nothing (n = 0) but keeps its lanes
  // in the warp's ballots
  const bool live = qi < nq;
  int64_t q = 0;
  size_t base = 0;
  if (live) {
    q = queries[qi];
    base = static_cast<size_t>(min(max(rows[qi], 0), n_rows - 1)) * cap;
  }
  const int pos = group_lower_bound<G>(keys + base, live ? cap : 0, q, g.l,
                                       g.mask);
  if (!live || g.l != 0) return;
  bool found = false;
  int64_t p = 0;
  if (pos < cap) {
    const int64_t key = ld_i64(keys + base + pos);
    p = ld_i64(pay + base + pos);
    found = key == q;
  }
  out_pay[qi] = p;
  out_found[qi] = found;
}

}  // namespace

// lanes: the group size G, a power of two up to 16 (ops.k4_lanes)
extern "C" int leaf_search_launch(const void* keys, const void* pay,
                                  int n_rows, int cap, const void* rows,
                                  const void* queries, int nq, void* out_pay,
                                  void* out_found, int lanes, void* stream) {
  if (nq > 0) {
    const auto st = static_cast<cudaStream_t>(stream);
    const bool ok = dispatch_lanes<16>(lanes, [&](auto lanes_c) {
      constexpr int G = decltype(lanes_c)::value;
      leaf_search_kernel<G><<<LaneGroup<G, THREADS>::blocks(nq), THREADS, 0,
                              st>>>(
          static_cast<const int64_t*>(keys), static_cast<const int64_t*>(pay),
          n_rows, cap, static_cast<const int32_t*>(rows),
          static_cast<const int64_t*>(queries), nq,
          static_cast<int64_t*>(out_pay), static_cast<bool*>(out_found));
    });
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
