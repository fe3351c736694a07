// K4 leaf_search: per query, fetch one row of a sorted key pool and search
// it: the rank of the query in the row (count of keys < q), found, and the
// payload at that rank.
//
// Replaces the TPU kernel src/repro/kernels/leaf_search/leaf_search.py:
// leaf_search_planes (body _kernel).  Output equals it bit for bit: the
// payload at the rank is returned whether or not the key matches, and 0
// when the rank equals the row width C (the query is above every key of
// the row).  The staged read uses it twice: on PA/BT rows (payload = the
// leaf row id) and on the leaf row (payload = the value).
//
// What bounds it on the H100: bytes and latency.  Each query reads one row
// (C keys, 2 KB at the default leaf geometry) scattered in HBM; the work
// per byte is one 64-bit compare.  The TPU kernel DMAs the row into VMEM
// and reduces the whole-row compare on the VPU; here one warp takes one
// query: lane l reads keys l, l+32, ... (coalesced 256-byte segments),
// counts key < q, and __reduce_add_sync gives the rank, as K1's leaf step
// does.  Lane 0 then reads the key and payload at the rank.  Keys arrive
// biased (u64 ^ 2^63 as int64, so signed order is key order).  Rows are
// clamped into [0, n_rows), as the plain version does.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS_PER_BLOCK = 8;
constexpr unsigned FULL_MASK = 0xffffffffu;

__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
leaf_search_kernel(const int64_t* __restrict__ keys,
                   const int64_t* __restrict__ pay, int n_rows, int cap,
                   const int32_t* __restrict__ rows,
                   const int64_t* __restrict__ queries, int nq,
                   int64_t* __restrict__ out_pay,
                   bool* __restrict__ out_found) {
  const int qi = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (qi >= nq) return;  // warp-uniform
  const int64_t q = queries[qi];
  const int r = min(max(rows[qi], 0), n_rows - 1);
  const size_t base = static_cast<size_t>(r) * cap;
  int c = 0;
  for (int j = lane; j < cap; j += 32) c += keys[base + j] < q;
  const int pos = __reduce_add_sync(FULL_MASK, c);
  if (lane == 0) {
    const bool in_row = pos < cap;
    out_found[qi] = in_row && keys[base + pos] == q;
    out_pay[qi] = in_row ? pay[base + pos] : 0;
  }
}

}  // namespace

extern "C" int leaf_search_launch(const void* keys, const void* pay,
                                  int n_rows, int cap, const void* rows,
                                  const void* queries, int nq, void* out_pay,
                                  void* out_found, void* stream) {
  if (nq > 0) {
    const int blocks = (nq + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
    leaf_search_kernel<<<blocks, WARPS_PER_BLOCK * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(keys), static_cast<const int64_t*>(pay),
        n_rows, cap, static_cast<const int32_t*>(rows),
        static_cast<const int64_t*>(queries), nq,
        static_cast<int64_t*>(out_pay), static_cast<bool*>(out_found));
  }
  return static_cast<int>(cudaGetLastError());
}
