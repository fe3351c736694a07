// K1 fused_lookup: the batched AULID point read in one launch.
//
// Replaces the TPU kernel src/repro/kernels/fused_lookup/fused_lookup.py:
// fused_lookup_planes (body _make_kernel), both of its forms: per query the
// shard route, the metanode shortcut, `height` rounds of FMCD slot
// prediction -> next_occ/overflow -> successor-chain walk ->
// DATA/PA/BT/MIXED dispatch, the leaf-row rank search and the overlay
// merge.  Output equals lookup_batch_overlay (one shard) and
// lookup_batch_sharded(_overlay) (S shards) of src/repro/core/lookup.py
// bit for bit: payload, found, global leaf row and shard id.
//
// The shard route replaces the TPU kernel's cfg.sharded branch (l.140-153,
// 170-219): sid = count(bounds < q) over the S-1 inclusive upper bounds,
// each shard's root, last row and last-leaf-min read at sid, and every
// pool index sid * pool_len + clamp(local, 0, pool_len - 1), the
// reference's per-shard mode="clip".  The route is a warp count (lane l
// compares bounds l, l+32, ...; __reduce_add_sync sums), and every clamped
// index adds shard sid's start in its pool (two offsets kept, for the slot
// and node pools, not a pointer a pool).  A monolithic mirror is the S = 1
// stack with no bounds: the count loop runs zero times and reads nothing.
//
// What bounds it on the H100.  One warp a query; up to 8,448 queries (64
// warps on each of 132 SMs) the launch is a single wave, so its time is
// the length of each query's chain of dependent loads, an L2 or HBM round
// trip a link (the TPU kernel keeps every pool resident in VMEM; here the
// leaf pool, 3.2 GB at 200M keys, stays in HBM), and then the leaf stage's
// bytes: one 2 KB row a query at the default geometry, 16 MB at the served
// 8192 queries, nearly all of the bytes bound, which random rows read at
// about half of HBM's rate.  The design shortens the chain three ways:
//
// 1. The overlay probe is a warp-cooperative 33-way lower bound
//    (warp_lower_bound, device_common.cuh, shared with K3): each round
//    lane l loads the splitter that closes the l-th of 33 equal parts of the
//    window, __ballot_sync marks those below q (a prefix: the pack is
//    sorted, padding last) and __popc picks the part.  n candidates
//    become floor(n / 33), so a pack of 2^24 slots takes 5 dependent
//    rounds where a binary search took 24-25.  It returns exactly
//    count(ok < q), the TPU kernel's compare-and-sum.
// 2. One round trip for each visited slot: the stale walk loads a slot's
//    key, successor, tag and pointer together at one clamped index and
//    leaves as soon as the slot is not stale (the walk is idempotent from
//    there), so a level costs three dependent trips (node fields, next_occ,
//    slot record) where it cost four.  The record's (and a node's, and an
//    overlay hit's) loads are asm volatile (ld_*, device_common.cuh,
//    shared with K5): as plain loads, nvcc sank the tag and pointer below
//    the walk's exit, a second trip.
// 3. Rows are staged into shared memory with cp.async (staged_rank): each
//    warp copies its leaf row (and a PA/BT row on the way) into its own
//    slice of dynamic shared memory in one batch of asynchronous copies,
//    16 bytes at a time where the pool's rows are 16-byte aligned (an even
//    cap), 8 otherwise, then waits once: one round trip for the whole row,
//    and no registers hold the loads in flight, so the leaf row's copies
//    are issued before the overlay probe and waited for after it: the
//    row's trip overlaps the probe's rounds.  The rank and the found check
//    read shared memory; only the payload word comes from global memory.
//    Inner rows longer than a slice go through it in slice-sized chunks.
//    ops._stage_plan sizes the slices (a leaf row each, 8 warps a block:
//    16 KB at the default geometry, 8 blocks an SM) and picks the widths.
//    Staging speeds up no served shape (PERF.md §6): its shared memory
//    takes L1 from the overlay probe, whose live keys (225 KB at the
//    served pack) an SM's L1 holds without it, so with the pack it is
//    2.5-4.5% slower than ranking the row from global memory; the unstaged
//    kernel given the same idle shared memory is as slow, and a carveout
//    hint changes nothing.  At the LM shape (every query on one row) it
//    costs 0.1-0.3 us, not through L1's size (the unstaged kernel with the
//    idle shared memory is as fast); that cp.async.cg skips L1, where
//    plain loads share the row, is the likely cause, not measured.
//
// At most 32 registers a thread (__launch_bounds__(256, 8)), no spills:
// fewer resident warps lengthen the served batch past one wave.  Tried and
// dropped (PERF.md §6): the staging loops unrolled (52 bytes of spills);
// the same without the 32-register cap (48 registers, 5 blocks an SM);
// the overlay's first round issued before the traversal (16 bytes of
// spills); each was slower at 8192 queries.  The leaf row's wait moved
// after the overlay probe changed nothing at 8192 (the leaf stage's bytes
// bound it there) and took 2% off at 256 with the pack; it stays.  Not
// taken: several queries a warp (the batch already fits one wave, and it
// shortens no chain); L2 persistence of the inner pools (K2 rewrites the
// pack between launches, an engine-level change).  The scalar traversal
// runs redundantly on all 32 lanes (equal addresses: one transaction a
// warp), so the query never leaves registers.  The slot prediction rounds
// exactly like the reference: __dmul_rn/__dadd_rn keep nvcc from
// contracting into an FMA.
// Keys arrive biased (u64 ^ 2^63 as int64, so signed order is key order);
// only the f64 prediction un-biases them.
#include <cstdint>
#include <cuda_runtime.h>

#include "device_common.cuh"

namespace {

constexpr int TAG_DATA = 1, TAG_PA = 2, TAG_BT = 3, TAG_MIXED = 4;
constexpr int MAX_WARPS = 8;
// bits of Mirror::wide: that pool's rows are copied 16 bytes at a time
constexpr int WIDE_LEAF = 1, WIDE_PA = 2, WIDE_BT = 4;

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
  const int32_t* meta;           // (S, 2): root node, last leaf row
  const int64_t* last_leaf_min;  // (S,) biased keys
  const int64_t* bounds;         // (S - 1,) biased inclusive upper keys
  const int64_t* ov;             // (3, ov_cap) overlay pack or nullptr
  // per-shard pool lengths: shard s's pools start at s * length
  int n_slots, n_nodes, n_pa, pa_cap, n_bt, bt_cap, n_leaf, leaf_cap;
  int n_shards, ov_cap, height, stale_steps;
  int slice_keys;                // keys of a warp's shared slice (even)
  int wide;                      // WIDE_* bits
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// a node's f64 fields, loaded as ld_i32 / ld_i64 are (device_common.cuh)
__device__ __forceinline__ double ld_f64(const double* p) {
  double v;
  asm volatile("ld.global.nc.f64 %0, [%1];" : "=d"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(int64_t* dst, const int64_t* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async8(int64_t* dst, const int64_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// one batch of cp.async copies of row[0..len) into the warp's shared slice
// (len <= the slice's keys); `wide`: the row starts 16-byte aligned and len
// is even, so every copy moves 16 bytes.  The loops stay rolled: unrolled,
// they pushed the kernel past 32 registers into spills (ptxas -v).
__device__ __forceinline__ void stage_copy(int64_t* slice, const int64_t* row,
                                           int len, bool wide, int lane) {
  __syncwarp();  // every lane is done with the slice's last contents
  if (wide) {
#pragma unroll 1
    for (int j = 2 * lane; j < len; j += 64) cp_async16(slice + j, row + j);
  } else {
#pragma unroll 1
    for (int j = lane; j < len; j += 32) cp_async8(slice + j, row + j);
  }
}

// wait for the warp's copies, then this lane's share of count(slice[0..len)
// < q), two keys a 16-byte read; slice[len] past an odd len lies inside the
// slice (its keys are even) and is not counted
__device__ __forceinline__ int stage_count(const int64_t* slice, int len,
                                           int64_t q, int lane) {
  cp_async_wait_all();
  __syncwarp();  // every lane's copies are visible to the warp
  int c = 0;
#pragma unroll 1
  for (int j = 2 * lane; j < len; j += 64) {
    const longlong2 v = *reinterpret_cast<const longlong2*>(slice + j);
    c += (v.x < q) + (j + 1 < len && v.y < q);
  }
  return c;
}

// count of row[0..n) < q, summed over the warp: the row goes through the
// slice in chunks of `chunk` keys, a batch of copies and one wait a chunk
__device__ __forceinline__ int staged_rank(int64_t* slice, const int64_t* row,
                                           int n, int chunk, bool wide,
                                           int64_t q, int lane) {
  int c = 0;
  for (int off = 0; off < n; off += chunk) {
    const int len = min(chunk, n - off);
    stage_copy(slice, row + off, len, wide, lane);
    c += stage_count(slice, len, q, lane);
  }
  return __reduce_add_sync(FULL_MASK, c);
}

// at most 32 registers a thread, so 8 blocks (64 warps) fit an SM: the
// dependent-load chain is latency-bound and wants every warp it can get
__global__ void __launch_bounds__(MAX_WARPS * 32, 8)
fused_lookup_kernel(Mirror m, const int64_t* __restrict__ queries, int nq,
                    int64_t* __restrict__ out_pay,
                    bool* __restrict__ out_found,
                    int32_t* __restrict__ out_leaf,
                    int32_t* __restrict__ out_sid) {
  extern __shared__ __align__(16) int64_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * (blockDim.x >> 5) + warp;
  if (qi >= nq) return;  // warp-uniform
  const int64_t q = queries[qi];

  // route: sid = count(bounds < q); at most S - 1, so always a real slot
  int below = 0;
  for (int j = lane; j < m.n_shards - 1; j += 32) below += m.bounds[j] < q;
  const int sid = __reduce_add_sync(FULL_MASK, below);
  // shard sid's slot and node pools start at these offsets (one register
  // each, not a pointer a pool: the base pointers stay in the parameter
  // bank; the wrapper checks S * pool length < 2^31)
  const int so = sid * m.n_slots, no = sid * m.n_nodes;
  const int root = m.meta[2 * sid];
  const int last_row = m.meta[2 * sid + 1];

  bool done = q >= m.last_leaf_min[sid] || root < 0;
  int leaf = done ? last_row : -1;
  int node = max(root, 0);
  for (int level = 0; level < m.height && !done; ++level) {
    // the node's fields, one round trip
    const int nd = no + clampi(node, 0, m.n_nodes - 1);
    const double slope = ld_f64(m.node_slope + nd);
    const double icpt = ld_f64(m.node_intercept + nd);
    const int fanout = ld_i32(m.node_fanout + nd);
    const int base = ld_i32(m.node_base + nd);
    const int overflow = ld_i32(m.node_overflow + nd);
    // the exact f64 key, made again each level rather than held
    const double qf =
        __ull2double_rn(static_cast<uint64_t>(q) ^ 0x8000000000000000ull);
    const double x = floor(__dadd_rn(__dmul_rn(slope, qf), icpt)) - 1.0;
    const int pred = static_cast<int>(
        fmin(fmax(x, 0.0), static_cast<double>(fanout - 1)));
    int s = m.next_occ[so + clampi(base + pred, 0, m.n_slots - 1)];
    if (s < 0) s = overflow;
    // the stale walk, a slot record (key, successor, tag, pointer) a
    // round trip; the record of the slot the walk stops at is the one read
    int tag, ptr;
    for (int k = 0;; ++k) {
      const int sc = so + clampi(s, 0, m.n_slots - 1);
      const int64_t key = ld_i64(m.slot_key + sc);
      const int succ = ld_i32(m.succ_slot + sc);
      tag = ld_i32(m.slot_tag + sc);
      ptr = ld_i32(m.slot_ptr + sc);
      if (k == m.stale_steps || s < 0 || key >= q) break;
      s = succ;
    }
    const bool ended = s < 0;
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
      const int rows = pa ? m.n_pa : m.n_bt;
      const size_t row = (static_cast<size_t>(sid) * rows +
                          clampi(max(ptr, 0), 0, rows - 1)) * cap;
      const int pos = staged_rank(
          smem + warp * m.slice_keys, (pa ? m.pa_keys : m.bt_keys) + row,
          cap, m.slice_keys, m.wide & (pa ? WIDE_PA : WIDE_BT), q, lane);
      leaf = (pa ? m.pa_ptrs : m.bt_ptrs)[row + pos % cap];
    } else {
      leaf = -1;
    }
    done = true;
  }

  leaf = max(leaf, 0);
  const size_t row = (static_cast<size_t>(sid) * m.n_leaf +
                      clampi(leaf, 0, m.n_leaf - 1)) * m.leaf_cap;
  // the slice holds a whole leaf row (slice_keys >= leaf_cap): one batch,
  // in flight through the overlay probe (cp.async holds no registers)
  int64_t* const slice = smem + warp * m.slice_keys;
  stage_copy(slice, m.leaf_keys + row, m.leaf_cap, m.wide & WIDE_LEAF, lane);
  int lo = 0;
  int64_t okp = 0, opay = 0, otomb = 0;
  if (m.ov != nullptr) {
    lo = warp_lower_bound(m.ov, m.ov_cap, q, lane);
    // the hit's record, in flight through the row's rank
    const int pc = min(lo, m.ov_cap - 1);
    okp = ld_i64(m.ov + pc);
    opay = ld_i64(m.ov + static_cast<size_t>(m.ov_cap) + pc);
    otomb = ld_i64(m.ov + 2 * static_cast<size_t>(m.ov_cap) + pc);
  }
  const int pos = __reduce_add_sync(
      FULL_MASK, stage_count(slice, m.leaf_cap, q, lane));
  const int posm = pos % m.leaf_cap;
  bool found = pos < m.leaf_cap && slice[posm] == q;
  int64_t pay = m.leaf_pay[row + posm];
  if (m.ov != nullptr) {
    const bool hit = lo < m.ov_cap && okp == q;
    const bool tomb = hit && otomb != 0;
    if (hit && !tomb) pay = opay;
    if (hit) found = !tomb;
  }
  if (!found) pay = 0;
  if (lane == 0) {
    out_pay[qi] = pay;
    out_found[qi] = found;
    out_leaf[qi] = sid * m.n_leaf + leaf;
    if (out_sid != nullptr) out_sid[qi] = sid;
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
    int n_leaf, int leaf_cap, int n_shards, const void* bounds,
    const void* ov, int ov_cap,
    const void* queries, int nq,
    void* out_pay, void* out_found, void* out_leaf, void* out_sid,
    int height, int stale_steps, int warps, int smem_bytes, int slice_keys,
    int wide, void* stream) {
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
  m.bounds = static_cast<const int64_t*>(bounds);
  m.ov = ov_cap > 0 ? static_cast<const int64_t*>(ov) : nullptr;
  m.n_slots = n_slots;
  m.n_nodes = n_nodes;
  m.n_pa = n_pa;
  m.pa_cap = pa_cap;
  m.n_bt = n_bt;
  m.bt_cap = bt_cap;
  m.n_leaf = n_leaf;
  m.leaf_cap = leaf_cap;
  m.n_shards = n_shards;
  m.ov_cap = ov_cap;
  m.height = height;
  m.stale_steps = stale_steps;
  m.slice_keys = slice_keys;
  m.wide = wide;
  if (warps < 1 || warps > MAX_WARPS || slice_keys < leaf_cap ||
      smem_bytes < warps * slice_keys * 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nq > 0) {
    if (smem_bytes > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          fused_lookup_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem_bytes);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int blocks = (nq + warps - 1) / warps;
    fused_lookup_kernel<<<blocks, warps * 32, smem_bytes,
                          static_cast<cudaStream_t>(stream)>>>(
        m, static_cast<const int64_t*>(queries), nq,
        static_cast<int64_t*>(out_pay), static_cast<bool*>(out_found),
        static_cast<int32_t*>(out_leaf), static_cast<int32_t*>(out_sid));
  }
  return static_cast<int>(cudaGetLastError());
}
