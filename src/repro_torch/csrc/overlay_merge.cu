// K2 overlay_merge: sorted-merge upsert of one write batch into the
// device-resident overlay pack.
//
// Replaces the TPU kernel src/repro/kernels/overlay_merge/overlay_merge.py:
// overlay_merge_planes (body _kernel) at S=1.  Output equals
// merge_overlay_pack_jnp of src/repro/core/lookup.py bit for bit: the
// sorted union of pack (3, Ca) and batch (3, Cb), the batch winning key
// collisions, tombstones kept as entries, INT64_MAX (biased UINT64_MAX)
// key padding after the last live entry.
//
// What bounds it on the H100: bytes.  The merge must write all cap_out
// output slots (3 x 8 bytes each) and read every live entry once; at the
// main path's size (Ca = cap_out = 2^24, Cb = 512) that is 400 MB of
// writes per step against a few hundred KB of live data.
//
// Design: linear work, no (Ca, Cb) compare matrices (the TPU kernel's
// rank pass would be 8.6e9 compares at Ca = 2^24).  Padding sorts last, so
// the live entries are a prefix of both inputs, and output positions
// follow from ranks:
//   rank_kernel (one block): for each batch key j, posa[j] = its lower
//     bound in the pack, and the exclusive scan C over j of
//     (live_b & key in pack); also n_live_a and n_out, the merged count.
//   scatter_kernel (grid over max(Ca, cap_out) + Cb): a surviving pack
//     entry i (live, not in the batch) goes to i - C[posb] + posb, with
//     posb its lower bound in the batch; a live batch entry j goes to
//     j + posa[j] - C[j]; slots in [n_out, cap_out) get padding.
// Pack padding is never read (the live prefix ends at n_live_a), so the
// kernel moves what the bound counts.  Rewriting only the suffix that the
// batch disturbs, in place, is later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int64_t PAD = INT64_MAX;
constexpr int RANK_THREADS = 1024;
constexpr int SCATTER_THREADS = 256;
constexpr unsigned FULL_MASK = 0xffffffffu;

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

// scratch layout: posa[0..cb) | C[0..cb] | n_out | n_live_a
__global__ void __launch_bounds__(RANK_THREADS)
rank_kernel(const int64_t* __restrict__ ak, int ca,
            const int64_t* __restrict__ bk, int cb,
            int32_t* __restrict__ scratch) {
  int32_t* posa = scratch;
  int32_t* C = scratch + cb;
  __shared__ int warp_sums[RANK_THREADS / 32];
  __shared__ int carry;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  if (tid == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < cb; base += RANK_THREADS) {
    const int j = base + tid;
    int flag = 0;
    if (j < cb) {
      const int64_t key = bk[j];
      const int p = lower_bound(ak, ca, key);
      posa[j] = p;
      flag = key != PAD && p < ca && ak[p] == key;
    }
    int incl = flag;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(FULL_MASK, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) warp_sums[w] = incl;
    __syncthreads();
    if (w == 0) {
      int v = warp_sums[lane];
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(FULL_MASK, v, o);
        if (lane >= o) v += u;
      }
      warp_sums[lane] = v;  // inclusive over warps
    }
    __syncthreads();
    const int excl = carry + (w > 0 ? warp_sums[w - 1] : 0) + incl - flag;
    if (j < cb) C[j] = excl;
    __syncthreads();
    if (tid == RANK_THREADS - 1) carry = excl + flag;
    __syncthreads();
  }
  if (tid == 0) {
    const int n_live_a = lower_bound(ak, ca, PAD);
    const int n_live_b = lower_bound(bk, cb, PAD);
    C[cb] = carry;
    scratch[2 * cb + 1] = n_live_a - carry + n_live_b;  // n_out
    scratch[2 * cb + 2] = n_live_a;
  }
}

__global__ void __launch_bounds__(SCATTER_THREADS)
scatter_kernel(const int64_t* __restrict__ a, int ca,
               const int64_t* __restrict__ b, int cb,
               int64_t* __restrict__ out, int cap_out,
               const int32_t* __restrict__ scratch, int64_t span) {
  const int32_t* posa = scratch;
  const int32_t* C = scratch + cb;
  const int n_out = scratch[2 * cb + 1];
  const int n_live_a = scratch[2 * cb + 2];
  const int64_t t = static_cast<int64_t>(blockIdx.x) * SCATTER_THREADS +
                    threadIdx.x;
  int64_t* ok = out;
  int64_t* op = out + cap_out;
  int64_t* ot = out + 2 * static_cast<int64_t>(cap_out);
  if (t < span) {
    if (t < n_live_a) {
      const int i = static_cast<int>(t);
      const int64_t key = a[i];
      const int pb = lower_bound(b, cb, key);
      if (!(pb < cb && b[pb] == key)) {  // survives: not overwritten
        const int64_t pos = static_cast<int64_t>(i) - C[pb] + pb;
        if (pos < cap_out) {
          ok[pos] = key;
          op[pos] = a[ca + i];
          ot[pos] = a[2 * static_cast<int64_t>(ca) + i];
        }
      }
    }
    if (t < cap_out && t >= n_out) {
      ok[t] = PAD;
      op[t] = 0;
      ot[t] = 0;
    }
  } else if (t < span + cb) {
    const int j = static_cast<int>(t - span);
    const int64_t key = b[j];
    if (key != PAD) {
      const int64_t pos = static_cast<int64_t>(j) + posa[j] - C[j];
      if (pos < cap_out) {
        ok[pos] = key;
        op[pos] = b[cb + j];
        ot[pos] = b[2 * cb + j];
      }
    }
  }
}

}  // namespace

extern "C" int overlay_merge_launch(const void* pack, int ca,
                                    const void* batch, int cb, void* out,
                                    int cap_out, void* scratch,
                                    void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const int64_t*>(pack);
  const auto* b = static_cast<const int64_t*>(batch);
  auto* sc = static_cast<int32_t*>(scratch);
  rank_kernel<<<1, RANK_THREADS, 0, s>>>(a, ca, b, cb, sc);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t span = ca > cap_out ? ca : cap_out;
  const int64_t total = span + cb;
  const int64_t blocks = (total + SCATTER_THREADS - 1) / SCATTER_THREADS;
  scatter_kernel<<<static_cast<unsigned>(blocks), SCATTER_THREADS, 0, s>>>(
      a, ca, b, cb, static_cast<int64_t*>(out), cap_out, sc, span);
  return static_cast<int>(cudaGetLastError());
}
