// K5 inner_probe: one inner-level resolve of the AULID mirror inside the
// 128-slot block that holds the predicted slot.
//
// Replaces the TPU kernel src/repro/kernels/inner_probe/inner_probe.py:
// probe_level (body _kernel).  Per query: enter at next_occ[s]; up to 3
// hops along succ_slot while the entry lies in s's block and its max key
// is < q (a stale entry); then emit (kind, val): (slot tag, slot ptr) when
// the entry lies in the block, (KIND_CONT = 7, slot) when the walk left the
// block (the host loop fetches that block next round), (KIND_END = 6, slot)
// when the chain ended (slot < 0).  Output equals the TPU kernel's bit for
// bit.
//
// What bounds it on the H100: latency.  A query's bytes are a few dozen
// (its slot and key, next_occ, a slot record a visited slot, kind and val
// out), so its time is its chain of dependent loads, an L2 or HBM round
// trip a link.  The TPU kernel DMAs the whole 128-slot block of six pools
// into VMEM and gathers from it with one-hot reduces.  Here one thread
// takes one query and loads only the slots the walk visits, straight from
// the flat pools: no blocked copy of the pools exists, because the block
// is only a bound test against [base, base + 128).  Slots come from
// predictions (< S), next_occ or succ_slot, so the padding the TPU's
// blocked pools carry is never read.  The query slot is clamped into
// [0, n_slots), as the plain version does.
//
// The design: one round trip for each visited slot.  A visited in-block
// slot's whole record (key, successor, tag, pointer) is loaded together
// with ld_* (device_common.cuh, shared with K1): asm volatile loads that
// nvcc cannot sink below the walk's exit, so the walk decides from
// registers and the stopping slot's tag and pointer are already held.  A
// query makes 3 + h dependent trips at h stale hops (its slot and key,
// next_occ, h + 1 records) where a thread that loaded the key, then the
// successor after the compare, then the tag and pointer after the loop
// made 4 + 2h.  No record is loaded unless its slot lies in the block.
// Blocks of 64 threads spread the served 8192 queries over 128 SMs, not 32
// as 256-thread blocks did (the two timed equal on the card, PERF.md §6).
// Keys arrive biased (signed order is key order).
#include <cstdint>
#include <cuda_runtime.h>

#include "device_common.cuh"

namespace {

constexpr int SPB = 128;          // slots per inner block
constexpr int STALE_HOPS = 3;     // the mirror's bound on stale entries
constexpr int KIND_END = 6, KIND_CONT = 7;
constexpr int THREADS = 64;

__global__ void __launch_bounds__(THREADS)
inner_probe_kernel(const int32_t* __restrict__ slot_tag,
                   const int64_t* __restrict__ slot_key,
                   const int32_t* __restrict__ slot_ptr,
                   const int32_t* __restrict__ succ_slot,
                   const int32_t* __restrict__ next_occ, int n_slots,
                   const int32_t* __restrict__ slots,
                   const int64_t* __restrict__ queries, int nq,
                   int32_t* __restrict__ out_kind,
                   int32_t* __restrict__ out_val) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= nq) return;
  const int s = min(max(slots[i], 0), n_slots - 1);
  const int base = (s / SPB) * SPB;
  const int64_t q = queries[i];
  int cur = next_occ[s];
  // cur < 0 (the chain ended) lies outside every block: base >= 0
  int kind = cur < 0 ? KIND_END : KIND_CONT, val = cur;
  for (int k = 0; cur >= base && cur < base + SPB; ++k) {
    const int64_t key = ld_i64(slot_key + cur);
    const int succ = ld_i32(succ_slot + cur);
    const int tag = ld_i32(slot_tag + cur);
    const int ptr = ld_i32(slot_ptr + cur);
    if (k == STALE_HOPS || !(key < q)) {
      kind = tag;
      val = ptr;
      break;
    }
    cur = succ;
    kind = cur < 0 ? KIND_END : KIND_CONT;
    val = cur;
  }
  out_kind[i] = kind;
  out_val[i] = val;
}

}  // namespace

extern "C" int inner_probe_launch(const void* slot_tag, const void* slot_key,
                                  const void* slot_ptr, const void* succ_slot,
                                  const void* next_occ, int n_slots,
                                  const void* slots, const void* queries,
                                  int nq, void* out_kind, void* out_val,
                                  void* stream) {
  if (nq > 0) {
    const int blocks = (nq + THREADS - 1) / THREADS;
    inner_probe_kernel<<<blocks, THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(slot_tag),
        static_cast<const int64_t*>(slot_key),
        static_cast<const int32_t*>(slot_ptr),
        static_cast<const int32_t*>(succ_slot),
        static_cast<const int32_t*>(next_occ), n_slots,
        static_cast<const int32_t*>(slots),
        static_cast<const int64_t*>(queries), nq,
        static_cast<int32_t*>(out_kind), static_cast<int32_t*>(out_val));
  }
  return static_cast<int>(cudaGetLastError());
}
