// K1 fused_lookup: the batched AULID point read in one launch.
//
// Replaces the TPU kernel src/repro/kernels/fused_lookup/fused_lookup.py:
// fused_lookup_planes (body _make_kernel) at S=1: per query the metanode
// shortcut, `height` rounds of FMCD slot prediction -> next_occ/overflow ->
// successor-chain walk -> DATA/PA/BT/MIXED dispatch, the leaf-row rank
// search and the overlay merge.  Output equals lookup_batch_overlay of
// src/repro/core/lookup.py bit for bit: payload, found and leaf row.
//
// What bounds it on the H100: bytes and, at real sizes, latency.  Each
// query must read one leaf row (256 keys = 2 KB at the default geometry)
// plus a few dozen scattered bytes per inner level, and those reads form a
// dependent chain (node -> slot -> successor -> row).  The TPU kernel keeps
// every pool resident in VMEM; here the leaf pool (3.2 GB at 200M keys)
// stays in HBM and the inner pools fall to L2 when they fit.
//
// Design: one warp per query, no shared memory.  The scalar traversal runs
// redundantly on all 32 lanes (equal addresses: one transaction per warp),
// so the query never leaves registers.  Row searches are warp-cooperative:
// lane l reads keys l, l+32, ... (coalesced 256-byte segments), counts
// key < q, and __reduce_add_sync sums the counts: the TPU kernel's
// whole-row compare-and-reduce.  The overlay probe is a lower-bound binary
// search over the sorted pack (padding sorts last, so it equals the TPU
// kernel's count(ok < q)).  The slot prediction rounds exactly like the
// reference: __dmul_rn/__dadd_rn keep nvcc from contracting into an FMA.
// Keys arrive biased (u64 ^ 2^63 as int64, so signed order is key order);
// only the f64 prediction un-biases them.  Making it fast (staging rows in
// shared memory, several queries per warp, L2 persistence of the inner
// pools) is later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TAG_DATA = 1, TAG_PA = 2, TAG_BT = 3, TAG_MIXED = 4;
constexpr int WARPS_PER_BLOCK = 8;
constexpr unsigned FULL_MASK = 0xffffffffu;

struct Mirror {
  const int32_t* slot_tag;
  const int64_t* slot_key;
  const int32_t* slot_ptr;
  const int32_t* next_occ;
  const int32_t* succ_slot;
  const int32_t* node_base;
  const int32_t* node_fanout;
  const double* node_slope;
  const double* node_intercept;
  const int32_t* node_overflow;
  const int64_t* pa_keys;
  const int32_t* pa_ptrs;
  const int64_t* bt_keys;
  const int32_t* bt_ptrs;
  const int64_t* leaf_keys;
  const int64_t* leaf_pay;
  const int32_t* meta;           // root node, last leaf row
  const int64_t* last_leaf_min;  // one biased key
  const int64_t* ov;             // (3, ov_cap) overlay pack or nullptr
  int n_slots, n_nodes, n_pa, pa_cap, n_bt, bt_cap, n_leaf, leaf_cap;
  int ov_cap, height, stale_steps;
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// count of row[0..n) < q, summed over the warp
__device__ __forceinline__ int warp_rank(const int64_t* row, int n,
                                         int64_t q, int lane) {
  int c = 0;
  for (int j = lane; j < n; j += 32) c += row[j] < q;
  return __reduce_add_sync(FULL_MASK, c);
}

__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
fused_lookup_kernel(Mirror m, const int64_t* __restrict__ queries, int nq,
                    int64_t* __restrict__ out_pay,
                    bool* __restrict__ out_found,
                    int32_t* __restrict__ out_leaf) {
  const int qi = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (qi >= nq) return;  // warp-uniform
  const int64_t q = queries[qi];
  const double qf =
      __ull2double_rn(static_cast<uint64_t>(q) ^ 0x8000000000000000ull);
  const int root = m.meta[0];
  const int last_row = m.meta[1];

  bool done = q >= m.last_leaf_min[0] || root < 0;
  int leaf = done ? last_row : -1;
  int node = max(root, 0);
  for (int level = 0; level < m.height && !done; ++level) {
    const int nd = clampi(node, 0, m.n_nodes - 1);
    const int fanout = m.node_fanout[nd];
    const double x =
        floor(__dadd_rn(__dmul_rn(m.node_slope[nd], qf),
                        m.node_intercept[nd])) - 1.0;
    const int pred = static_cast<int>(
        fmin(fmax(x, 0.0), static_cast<double>(fanout - 1)));
    int s = m.next_occ[clampi(m.node_base[nd] + pred, 0, m.n_slots - 1)];
    if (s < 0) s = m.node_overflow[nd];
    for (int k = 0; k < m.stale_steps; ++k) {
      const int sc = clampi(s, 0, m.n_slots - 1);
      if (s >= 0 && m.slot_key[sc] < q) s = m.succ_slot[sc];
    }
    const bool ended = s < 0;
    const int sc = clampi(s, 0, m.n_slots - 1);
    const int tag = m.slot_tag[sc];
    const int ptr = m.slot_ptr[sc];
    if (!ended && tag == TAG_MIXED) {  // descend
      node = ptr;
      continue;
    }
    if (ended) {
      leaf = last_row;
    } else if (tag == TAG_DATA) {
      leaf = ptr;
    } else if (tag == TAG_PA || tag == TAG_BT) {
      const bool pa = tag == TAG_PA;
      const int cap = pa ? m.pa_cap : m.bt_cap;
      const size_t row = static_cast<size_t>(
          clampi(max(ptr, 0), 0, (pa ? m.n_pa : m.n_bt) - 1)) * cap;
      const int pos = warp_rank((pa ? m.pa_keys : m.bt_keys) + row, cap,
                                q, lane);
      leaf = (pa ? m.pa_ptrs : m.bt_ptrs)[row + pos % cap];
    } else {
      leaf = -1;
    }
    done = true;
  }

  leaf = max(leaf, 0);
  const size_t row =
      static_cast<size_t>(clampi(leaf, 0, m.n_leaf - 1)) * m.leaf_cap;
  const int pos = warp_rank(m.leaf_keys + row, m.leaf_cap, q, lane);
  const int posm = pos % m.leaf_cap;
  bool found = pos < m.leaf_cap && m.leaf_keys[row + posm] == q;
  int64_t pay = found ? m.leaf_pay[row + posm] : 0;

  if (m.ov != nullptr) {
    const int64_t* ok = m.ov;
    int lo = 0, hi = m.ov_cap;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (ok[mid] < q) lo = mid + 1; else hi = mid;
    }
    const int pc = min(lo, m.ov_cap - 1);
    const bool hit = lo < m.ov_cap && ok[pc] == q;
    const bool tomb = hit && m.ov[2 * static_cast<size_t>(m.ov_cap) + pc] != 0;
    if (hit && !tomb) pay = m.ov[static_cast<size_t>(m.ov_cap) + pc];
    if (hit) found = !tomb;
    if (!found) pay = 0;
  }
  if (lane == 0) {
    out_pay[qi] = pay;
    out_found[qi] = found;
    out_leaf[qi] = leaf;
  }
}

}  // namespace

extern "C" int fused_lookup_launch(
    const void* slot_tag, const void* slot_key, const void* slot_ptr,
    const void* next_occ, const void* succ_slot, const void* node_base,
    const void* node_fanout, const void* node_slope,
    const void* node_intercept, const void* node_overflow,
    const void* pa_keys, const void* pa_ptrs, const void* bt_keys,
    const void* bt_ptrs, const void* leaf_keys, const void* leaf_pay,
    const void* meta, const void* last_leaf_min,
    int n_slots, int n_nodes, int n_pa, int pa_cap, int n_bt, int bt_cap,
    int n_leaf, int leaf_cap,
    const void* ov, int ov_cap,
    const void* queries, int nq,
    void* out_pay, void* out_found, void* out_leaf,
    int height, int stale_steps, void* stream) {
  Mirror m;
  m.slot_tag = static_cast<const int32_t*>(slot_tag);
  m.slot_key = static_cast<const int64_t*>(slot_key);
  m.slot_ptr = static_cast<const int32_t*>(slot_ptr);
  m.next_occ = static_cast<const int32_t*>(next_occ);
  m.succ_slot = static_cast<const int32_t*>(succ_slot);
  m.node_base = static_cast<const int32_t*>(node_base);
  m.node_fanout = static_cast<const int32_t*>(node_fanout);
  m.node_slope = static_cast<const double*>(node_slope);
  m.node_intercept = static_cast<const double*>(node_intercept);
  m.node_overflow = static_cast<const int32_t*>(node_overflow);
  m.pa_keys = static_cast<const int64_t*>(pa_keys);
  m.pa_ptrs = static_cast<const int32_t*>(pa_ptrs);
  m.bt_keys = static_cast<const int64_t*>(bt_keys);
  m.bt_ptrs = static_cast<const int32_t*>(bt_ptrs);
  m.leaf_keys = static_cast<const int64_t*>(leaf_keys);
  m.leaf_pay = static_cast<const int64_t*>(leaf_pay);
  m.meta = static_cast<const int32_t*>(meta);
  m.last_leaf_min = static_cast<const int64_t*>(last_leaf_min);
  m.ov = ov_cap > 0 ? static_cast<const int64_t*>(ov) : nullptr;
  m.n_slots = n_slots;
  m.n_nodes = n_nodes;
  m.n_pa = n_pa;
  m.pa_cap = pa_cap;
  m.n_bt = n_bt;
  m.bt_cap = bt_cap;
  m.n_leaf = n_leaf;
  m.leaf_cap = leaf_cap;
  m.ov_cap = ov_cap;
  m.height = height;
  m.stale_steps = stale_steps;
  if (nq > 0) {
    const int blocks = (nq + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
    fused_lookup_kernel<<<blocks, WARPS_PER_BLOCK * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        m, static_cast<const int64_t*>(queries), nq,
        static_cast<int64_t*>(out_pay), static_cast<bool*>(out_found),
        static_cast<int32_t*>(out_leaf));
  }
  return static_cast<int>(cudaGetLastError());
}
