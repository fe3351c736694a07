// K2 overlay_merge: sorted-merge upsert of one write batch into the
// device-resident overlay pack, written into a target pack the caller owns.
//
// Replaces the TPU kernel src/repro/kernels/overlay_merge/overlay_merge.py:
// overlay_merge_planes (body _kernel) over its whole (S, cap_out // ob)
// grid.  Each of the S rows merges on its own: output row s equals
// merge_overlay_pack_jnp of src/repro/core/lookup.py on pack row s
// (3, Ca) and batch row s (3, Cb) bit for bit (overlay_merge_pack_stacked
// of src/repro/kernels/overlay_merge/ops.py): the sorted union, the batch
// winning key collisions, tombstones kept as entries, INT64_MAX (biased
// UINT64_MAX) key padding after the last live entry.  The flat merge of
// the serving engines is the S = 1 case.
//
// What bounds it on the H100: at the main path's size (Ca = cap_out =
// 2^24, Cb = 512, about 28K live entries) the live entries are about 1.4
// MB a step, far under a launch, so the two launches and their few
// dependent trips bound it; from about 2^22 live entries, their bytes.  A
// merge that wrote all cap_out slots would move 400 MB a step, almost all
// of it padding.
//
// Design: the caller keeps two packs and merges from the served one into
// the other (core/lookup.py merge_overlay_pack), and every pack buffer
// holds padding in every slot from its fill (the live count it last held)
// to its capacity.  A merge into a target whose fill is at most out_fill
// writes the merged entries into [0, n_out) and pads only [n_out,
// out_fill): empty in steady state, where entries only accumulate.  A
// fresh target is passed with out_fill = cap_out and padded whole.  Padding
// sorts last, so live entries are a prefix of both inputs, and output
// positions follow from ranks; fill_a, a host bound on the pack's live
// count, sizes the grids (slots it over-covers hold padding and are
// skipped); a grid takes at most one wave of blocks (as many as the SMs
// hold at once) and strides past it, so that a large fill stages the
// batch once a resident block and leaves no second, thin wave:
//   rank_kernel (warps over chunks of V * 32 pack slots in [0, fill_a],
//     S rows in y; V = RANK_V where one wave of warps would take RANK_V
//     runs of 32 each, else 1): the batch sits in shared memory (up to
//     SMEM_KEYS keys; a larger one is searched in global memory, where it
//     stays in L2); slot i owns the batch keys in (key[i-1], key[i]] and,
//     with its warp, writes their posa (= i, the count of pack keys below
//     them) and their flag (the key is in the pack: an overwrite); the
//     slot at the first padding writes n_live_a.  With V > 1 a chunk that
//     owns no batch key and holds no padding, as most of a large pack's
//     do, costs one search by two lanes; a warp's 32 sorted keys share
//     one search (warp_rank: two lanes search, the rest only between
//     their ranks).  The next chunk's keys load while one is ranked.
//   scatter_kernel (a thread an item, S rows in y; items t < span are pack
//     entry / output slot t, then the Cb batch entries): each block ballots
//     the Cb flags into words and scans their counts in shared memory (C,
//     the overwrites below a batch index), then a surviving pack entry i
//     goes to i - C[posb] + posb (posb its rank in the batch, by the
//     warp's shared search), a live batch entry j to j + posa[j] - C[j],
//     and slots in [n_out, max(n_out, out_fill)) get padding.  A thread's
//     first item's loads issue before the block's scan, each next item's
//     before the current one is placed.
// n_out (clamped to cap_out: entries past it are dropped, as in the
// reference) is reported in the row's scratch.
#include <cstdint>
#include <cuda_runtime.h>

#include "device_common.cuh"

namespace {

constexpr int64_t PAD = INT64_MAX;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// a batch of at most SMEM_KEYS keys is searched in shared memory (32 KB)
constexpr int SMEM_KEYS = 4096;
// the most dynamic shared memory a block may take on an H100
constexpr int MAX_SMEM = 232448;
// a rank warp takes chunks of RANK_V runs of 32 pack slots where one wave
// of warps would take at least RANK_V runs each, else runs of one
constexpr int RANK_V = 4;

// scratch of a row (int32): posa[0..cb) | flag[0..cb) | n_live_a | n_out
__host__ __device__ constexpr int64_t scratch_len(int cb) {
  return 2 * static_cast<int64_t>(cb) + 2;
}

// first index in keys[0..n) whose key is >= q
__device__ __forceinline__ int lower_bound(const int64_t* keys, int n,
                                           int64_t q) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < q) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// first index in keys[0..n) whose key is > q
__device__ __forceinline__ int upper_bound(const int64_t* keys, int n,
                                           int64_t q) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] <= q) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// the rank of each lane's q in keys[0..n) (its upper bound with UPPER,
// else its lower bound), for a warp whose q do not decrease from lane 0 to
// lane `last` (the lanes past it get no rank that means anything): lanes
// 0 and `last` search all n keys, the others only the keys between those
// two ranks, none where the two agree, as they do for most warps of a
// large pack (its 32 keys fall between two batch keys)
template <bool UPPER>
__device__ __forceinline__ int warp_rank(const int64_t* keys, int n,
                                         int64_t q, int lane, int last) {
  int r = 0;
  if (lane == 0 || lane == last)
    r = UPPER ? upper_bound(keys, n, q) : lower_bound(keys, n, q);
  const int lo = __shfl_sync(FULL_MASK, r, 0);
  const int hi = __shfl_sync(FULL_MASK, r, last);
  if (lo == hi) return lo;
  return lo + (UPPER ? upper_bound(keys + lo, hi - lo, q)
                     : lower_bound(keys + lo, hi - lo, q));
}

// the batch keys to search: copied into shared memory when they fit
__device__ __forceinline__ const int64_t* stage_batch(int64_t* sb,
                                                      const int64_t* bk,
                                                      int cb) {
  if (cb > SMEM_KEYS) return bk;
  for (int j = threadIdx.x; j < cb; j += THREADS) sb[j] = bk[j];
  return sb;
}

// one warp's 32 consecutive pack slots i (lane order), their keys, and in
// lane 0 the key before them: each lane owns the batch keys in (its
// previous key, its key], indices [lo, hi), and the warp writes their posa
// and flags, 32 at a time (key j's owner is the first lane whose hi
// exceeds j); the lane at the first padding slot writes n_live_a
__device__ __forceinline__ void rank_slots(const int64_t* bk, int cb,
                                           int32_t* posa, int32_t* flag,
                                           int64_t i, int64_t key,
                                           int64_t before, int lane) {
  const int64_t up = __shfl_up_sync(FULL_MASK, key, 1);
  const int64_t prev = lane == 0 ? before : up;
  // lane 0's lo lies at or below its hi, and equals it unless a batch key
  // falls in (before, key]
  const int hi = warp_rank<true>(bk, cb, key, lane, 31);
  int lo = __shfl_up_sync(FULL_MASK, hi, 1);
  if (lane == 0)
    lo = i == 0 ? 0 : hi == 0 || bk[hi - 1] <= before
                          ? hi : upper_bound(bk, hi, before);
  if (key == PAD && (i == 0 || prev != PAD))
    posa[2 * cb] = static_cast<int32_t>(i);          // n_live_a
  const int w0 = __shfl_sync(FULL_MASK, lo, 0);
  const int w1 = __shfl_sync(FULL_MASK, hi, 31);
  for (int j0 = w0; j0 < w1; j0 += 32) {
    const int j = j0 + lane;
    int k = 0;
#pragma unroll
    for (int step = 16; step >= 1; step >>= 1)
      if (__shfl_sync(FULL_MASK, hi, k + step - 1) <= j) k += step;
    const int64_t owner = __shfl_sync(FULL_MASK, key, k);
    if (j < w1) {
      posa[j] = static_cast<int32_t>(i - lane + k);
      flag[j] = owner != PAD && bk[j] == owner;
    }
  }
}

// a warp's chunk: V runs of 32 slots, loaded at once
template <int V>
struct Chunk {
  int64_t key[V];
  int64_t before;        // lane 0: the key before the chunk
};

template <int V>
__device__ __forceinline__ Chunk<V> load_chunk(const int64_t* ak,
                                               int64_t lim, int64_t base,
                                               int lane) {
  Chunk<V> c;
#pragma unroll
  for (int s = 0; s < V; ++s) {
    const int64_t i = base + 32 * s + lane;
    c.key[s] = i < lim ? ld_i64(ak + i) : PAD;
  }
  c.before = lane == 0 && base > 0 && base - 1 < lim ? ld_i64(ak + base - 1)
                                                     : PAD;
  return c;
}

// grid (min(ceil(span_a / V / THREADS), one wave), rows): each warp
// strides over chunks of V * 32 pack slots in [0, span_a), span_a = fill_a
// + 1; with V > 1 a chunk with no batch key in (its key before, its last
// key] and no padding, as most are where the pack is much larger than the
// batch, costs one search of two lanes
template <int V>
__global__ void __launch_bounds__(THREADS)
rank_kernel(const int64_t* __restrict__ packs, int ca,
            const int64_t* __restrict__ batches, int cb,
            int32_t* __restrict__ scratch_all, int64_t span_a) {
  extern __shared__ int64_t sb[];
  const int64_t r = blockIdx.y;
  const int64_t* ak = packs + r * 3 * static_cast<int64_t>(ca);
  int32_t* posa = scratch_all + r * scratch_len(cb);
  int32_t* flag = posa + cb;
  const int lane = threadIdx.x & 31;
  constexpr int64_t W = 32 * V;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * WARPS * W;
  const int64_t lim = span_a < ca ? span_a : ca;   // slots past it: padding
  int64_t base = (static_cast<int64_t>(blockIdx.x) * WARPS
                  + (threadIdx.x >> 5)) * W;
  // the first chunk loads before the batch is staged
  Chunk<V> c = load_chunk<V>(ak, lim, base, lane);
  const int64_t* bk = stage_batch(
      sb, batches + r * 3 * static_cast<int64_t>(cb), cb);
  __syncthreads();
  while (base < span_a) {
    // a warp past the live prefix owns nothing, nor do the later ones
    if (__shfl_sync(FULL_MASK, base > 0 && c.before == PAD, 0)) break;
    // the next chunk loads while this one is ranked
    const int64_t next_base = base + stride;
    const Chunk<V> next = next_base < span_a
                              ? load_chunk<V>(ak, lim, next_base, lane)
                              : Chunk<V>{};
    bool quiet = false;
    if (V > 1) {
      const int64_t last = __shfl_sync(FULL_MASK, c.key[V - 1], 31);
      int u = 0;
      if (lane == 0) u = upper_bound(bk, cb, c.before);
      if (lane == 31) u = upper_bound(bk, cb, last);
      quiet = base > 0 && last != PAD
          && __shfl_sync(FULL_MASK, u, 0) == __shfl_sync(FULL_MASK, u, 31);
    }
    if (!quiet) {
      int64_t before = c.before;
#pragma unroll
      for (int s = 0; s < V; ++s) {
        const int64_t i = base + 32 * s + lane;
        if (__shfl_sync(FULL_MASK, i > 0 && before == PAD, 0)) break;
        rank_slots(bk, cb, posa, flag, i, c.key[s], before, lane);
        before = __shfl_sync(FULL_MASK, c.key[s], 31);
      }
    }
    base = next_base;
    c = next;
  }
}

// the count of flags below j, from the ballot words and their scan
__device__ __forceinline__ int flags_below(const uint32_t* words,
                                           const int32_t* pre, int j) {
  return pre[j >> 5] + __popc(words[j >> 5] & ((1u << (j & 31)) - 1u));
}

// one item's inputs: pack entry t (t < span, loaded while t < fill_a) or
// batch entry t - span, with its posa
struct Item {
  int64_t key = PAD, pay = 0, tomb = 0;
  int pj = 0;
};

__device__ __forceinline__ Item load_item(const int64_t* a, int ca,
                                          int64_t fill_a, const int64_t* b,
                                          int cb, const int32_t* posa,
                                          int64_t span, int64_t t) {
  Item it;
  if (t < span) {
    if (t < fill_a) {
      it.key = ld_i64(a + t);
      it.pay = ld_i64(a + ca + t);
      it.tomb = ld_i64(a + 2 * static_cast<int64_t>(ca) + t);
    }
  } else if (t < span + cb) {
    const int j = static_cast<int>(t - span);
    it.key = ld_i64(b + j);
    it.pay = ld_i64(b + cb + j);
    it.tomb = ld_i64(b + 2 * cb + j);
    it.pj = ld_i32(posa + j);
  }
  return it;
}

// grid (min(ceil((span + cb) / THREADS), max_blocks), rows), striding over
// the items
__global__ void __launch_bounds__(THREADS)
scatter_kernel(const int64_t* __restrict__ packs, int ca, int64_t fill_a,
               const int64_t* __restrict__ batches, int cb,
               int64_t* __restrict__ outs, int cap_out,
               const int32_t* __restrict__ out_fills, int out_fill,
               int32_t* __restrict__ scratch_all, int64_t span) {
  extern __shared__ int64_t smem[];
  const int64_t r = blockIdx.y;
  const int64_t* a = packs + r * 3 * static_cast<int64_t>(ca);
  const int64_t* b = batches + r * 3 * static_cast<int64_t>(cb);
  int64_t* out = outs + r * 3 * static_cast<int64_t>(cap_out);
  int32_t* scratch = scratch_all + r * scratch_len(cb);
  const int32_t* posa = scratch;
  const int32_t* flag = scratch + cb;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
  const int64_t total = span + cb;
  int64_t t = static_cast<int64_t>(blockIdx.x) * THREADS + tid;
  // the first item's loads issue before the block's scan: one trip
  Item it = load_item(a, ca, fill_a, b, cb, posa, span, t);
  const int n_live_a = ld_i32(scratch + 2 * cb);
  const int f_t = out_fills != nullptr ? ld_i32(out_fills + r) : out_fill;
  // shared memory: the batch keys (when they fit) | ballot words | scan;
  // a lane loads flag j and key j together
  const int nw = (cb + 31) >> 5;
  const bool staged = cb <= SMEM_KEYS;
  const int64_t* bk = staged ? smem : b;
  uint32_t* words = reinterpret_cast<uint32_t*>(smem + (staged ? cb : 0));
  int32_t* pre = reinterpret_cast<int32_t*>(words + nw + 1);
  for (int v = w; v < nw; v += WARPS) {
    const int j = (v << 5) + lane;
    int f = 0;
    if (j < cb) {
      f = ld_i32(flag + j);
      if (staged) smem[j] = b[j];
    }
    const unsigned m = __ballot_sync(FULL_MASK, f != 0);
    if (lane == 0) words[v] = m;
  }
  if (tid == 0) words[nw] = 0;
  __syncthreads();
  if (w == 0) {        // exclusive scan of the words' counts, pre[0..nw]
    const int chunk = (nw + 1 + 31) >> 5;
    const int c0 = lane * chunk;
    const int c1 = min(c0 + chunk, nw + 1);
    int s = 0;
    for (int c = c0; c < c1; ++c) s += __popc(words[c]);
    int incl = s;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(FULL_MASK, incl, o);
      if (lane >= o) incl += v;
    }
    int run = incl - s;
    for (int c = c0; c < c1; ++c) {
      pre[c] = run;
      run += __popc(words[c]);
    }
  }
  __syncthreads();
  const int n_live_b = lower_bound(bk, cb, PAD);
  const int overlap = flags_below(words, pre, cb);
  const int64_t merged = static_cast<int64_t>(n_live_a) - overlap + n_live_b;
  const int n_out = merged < cap_out ? static_cast<int>(merged) : cap_out;
  if (blockIdx.x == 0 && tid == 0) scratch[2 * cb + 1] = n_out;
  const int pad_end = max(n_out, min(f_t, cap_out));
  int64_t* ok = out;
  int64_t* op = out + cap_out;
  int64_t* ot = out + 2 * static_cast<int64_t>(cap_out);
  // the warp steps together (t - lane is its first item), so that its
  // live pack entries, a prefix of its lanes in key order, share a search
  while (t - lane < total) {
    // the next item's loads issue before this one is placed
    const int64_t nt = t + stride;
    const Item next = load_item(a, ca, fill_a, b, cb, posa, span, nt);
    int64_t pos = -1;
    const bool live = t < n_live_a;          // a live pack entry
    const unsigned m = __ballot_sync(FULL_MASK, live);
    if (m != 0) {
      const int pb = warp_rank<false>(bk, cb, it.key, lane, 31 - __clz(m));
      if (live && !(pb < cb && bk[pb] == it.key))   // not overwritten
        pos = t - flags_below(words, pre, pb) + pb;
    }
    if (t < span) {
      if (t >= n_out && t < pad_end) {
        ok[t] = PAD;
        op[t] = 0;
        ot[t] = 0;
      }
    } else if (t < total && it.key != PAD) {   // a live batch entry
      const int j = static_cast<int>(t - span);
      pos = static_cast<int64_t>(j) + it.pj - flags_below(words, pre, j);
    }
    if (pos >= 0 && pos < cap_out) {
      ok[pos] = it.key;
      op[pos] = it.pay;
      ot[pos] = it.tomb;
    }
    t = nt;
    it = next;
  }
}

// the blocks of one wave of `kernel` in x for each of `rows` rows: as many
// as the current device's SMs hold at once with `smem` bytes each
template <typename Kernel>
int64_t wave_x(Kernel kernel, int smem, int rows) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                smem);
  const int64_t wave = static_cast<int64_t>(sms) * per_sm / rows;
  return wave > 1 ? wave : 1;
}

// enough blocks for `items` threads, at most `wave`: past it they stride
int grid_x(int64_t items, int64_t wave) {
  const int64_t need = (items + THREADS - 1) / THREADS;
  return static_cast<int>(need < 1 ? 1 : need < wave ? need : wave);
}

}  // namespace

// packs (rows, 3, ca) with at most fill_a live entries a row, batches
// (rows, 3, cb), out (rows, 3, cap_out) whose row r holds padding from
// out_fills[r] (out_fill for every row when out_fills is null) to cap_out;
// out_fill_max bounds those fills; scratch rows * scratch_len(cb) int32.
// Returns cudaErrorInvalidValue for a batch whose scan does not fit in a
// block's shared memory (cb above 2^19).
extern "C" int overlay_merge_launch(const void* packs, int ca, int fill_a,
                                    const void* batches, int cb, void* out,
                                    int cap_out, const void* out_fills,
                                    int out_fill, int out_fill_max,
                                    void* scratch, int rows, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const int64_t*>(packs);
  const auto* b = static_cast<const int64_t*>(batches);
  auto* sc = static_cast<int32_t*>(scratch);
  const int keys_smem = cb <= SMEM_KEYS ? cb * 8 : 0;
  const int nw = (cb + 31) >> 5;
  const int64_t scan_smem = keys_smem + 8 * static_cast<int64_t>(nw + 1);
  if (scan_smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  if (scan_smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(scan_smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int64_t span_a = static_cast<int64_t>(fill_a) + 1;
  const int64_t wave = wave_x(rank_kernel<1>, keys_smem, rows);
  if ((span_a + 31) / 32 >= RANK_V * wave * WARPS)
    rank_kernel<RANK_V><<<dim3(grid_x((span_a + RANK_V - 1) / RANK_V,
                                      wave_x(rank_kernel<RANK_V>, keys_smem,
                                             rows)),
                               static_cast<unsigned>(rows)),
                          THREADS, keys_smem, s>>>(a, ca, b, cb, sc, span_a);
  else
    rank_kernel<1><<<dim3(grid_x(span_a, wave), static_cast<unsigned>(rows)),
                     THREADS, keys_smem, s>>>(a, ca, b, cb, sc, span_a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t f_max = out_fill_max < cap_out ? out_fill_max : cap_out;
  const int64_t span = f_max > fill_a ? f_max : fill_a;
  scatter_kernel<<<dim3(grid_x(span + cb,
                              wave_x(scatter_kernel,
                                     static_cast<int>(scan_smem), rows)),
                       static_cast<unsigned>(rows)),
                   THREADS, static_cast<int>(scan_smem), s>>>(
      a, ca, fill_a, b, cb, static_cast<int64_t*>(out), cap_out,
      static_cast<const int32_t*>(out_fills), out_fill, sc, span);
  return static_cast<int>(cudaGetLastError());
}
