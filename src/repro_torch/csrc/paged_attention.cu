// K6 paged_attention: one GQA decode step over a paged KV pool, as split-K
// flash-decoding for Hopper.  Per batch row b, the row's page table names
// the physical page of each logical page; the output is (B, H, Dh) in q's
// dtype.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/
// paged_attention.py: paged_attention_call (body _kernel).  It keeps that
// kernel's numerics: f32 accumulation, scale 1/sqrt(f32(Dh)), dead logits
// (token p*page + i >= lengths[b]) set to -1e30, the running max starting
// at -1e30, the final divide by max(l, 1e-30).  Query head h reads kv head
// h / (H / Hkv).  Page ids are clamped into [0, P).
//
// What bounds it on the H100: bytes.  A decode step does 2 flops per K/V
// element it reads (about 0.5 flop a byte in f32, 1 in bf16), far below the
// card's ridge, so the least time is the live tokens' K and V over HBM
// bandwidth.  The TPU kernel walks a row's pages in order on one core with
// the next page's DMA behind the current one.  On 132 SMs that order is the
// problem: one block per (row, kv head) is too few blocks, and a walk with
// one page in flight is a chain of memory latencies.  The design, in four
// points:
//
// 1. Split a row's pages over blocks.  The grid is (H / G, B, n_splits):
//    each block takes pages_per_split consecutive logical pages of one
//    (row, group of G query heads of one kv head), and the split index is
//    the slowest, so every row's first splits are dispatched first.  The
//    plan comes from the static shapes (ops.py: _split_plan), so the host
//    never reads lengths.  A row's walk is its pages up to the last live
//    token (every page when its length is 0, as the TPU kernel does):
//    exact, since once a live logit has been seen every later dead one
//    gives exp(-1e30 - m) = 0.  A block whose first page lies past the walk
//    marks its partial empty (m = -inf) and exits.
// 2. Keep loads in flight.  The block reads its page ids into shared memory
//    first (together with the row's length).  Each warp then streams chunks
//    of its tokens' K and V rows (2 KB of each) into its own ring of up to
//    STAGES chunks with 16-byte cp.async copies, STAGES - 1 chunks ahead of
//    the one it computes on; in a copy, neighbouring lanes read neighbouring
//    16 bytes of a token's Dh row.  Each lane later reads back exactly the
//    pieces it copied, so a chunk needs only the lane's own
//    cp.async.wait_group (and a __syncwarp before its slot is refilled).
// 3. No block-wide barrier per page.  Each warp keeps its own online softmax
//    over its chunks: m and l per query head and the G x Dh accumulator in
//    registers, spread over the lanes (L lanes share a token, each holding
//    Dh / L of its values).  The warps merge once, in shared memory, at the
//    end of the block.  Everything is f32 on the CUDA cores (exp2 on the
//    log2(e)-scaled logits): at 0.5-1 flop a byte the FMA pipe is not what
//    the H100 runs out of first, so no tensor-core path (mma.sync) is used.
// 4. Combine the splits.  Each block writes its (m, l, acc) partial; a second
//    small kernel, launched by the same C call as a programmatic dependent
//    launch (it is scheduled while the split kernel's last blocks run, and
//    waits for their partials), lists the non-empty splits of each (row,
//    query head), weighs them by exp(m_i - M), M = max m_i, and divides by
//    max(sum of weighted l, 1e-30).  Dead tokens inside a split give 0; a
//    row of length 0 has m = -1e30 in every split, so every weight is 1 and
//    the result is the mean of v over all NP * page tokens of its table.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int STAGES = 4;        // chunks a warp keeps in its ring
constexpr int PIECES = 4;        // 16-byte pieces of K (and of V) a lane
                                 // copies per chunk
constexpr int CHUNK_BYTES = 32 * PIECES * 16;  // of K (and of V), per chunk
constexpr int QMAX = 32;         // the most query values a lane holds
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr float DEAD = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// One 16-byte piece as f32 values: 4 floats, or 8 bfloat16 (exact widening).
__device__ __forceinline__ void widen(const uint4 r, float* o, float) {
  o[0] = __uint_as_float(r.x);
  o[1] = __uint_as_float(r.y);
  o[2] = __uint_as_float(r.z);
  o[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void widen(const uint4 r, float* o, __nv_bfloat16) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// 16 bytes global -> shared; ok == false writes 16 zero bytes instead.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// How a warp's lanes share a chunk of tokens, for values of type T, head
// dim DH and G query heads a block.
template <typename T, int DH, int G>
struct Tile {
  static constexpr int VEC = 16 / sizeof(T);  // values in a piece
  static constexpr int PPT = DH / VEC;        // pieces in a token's Dh row
  static constexpr int LQ = G * DH / QMAX;    // lanes that keep q small
  static constexpr int L0 = LQ > PPT / PIECES ? LQ : PPT / PIECES;
  static constexpr int L1 = L0 < PPT ? L0 : PPT;
  static constexpr int L = L1 < 32 ? L1 : 32;  // lanes that share a token
  static constexpr int NS = PPT / L;           // pieces of a token a lane holds
  static constexpr int NT = PIECES / NS;       // tokens a lane holds per chunk
  static constexpr int TPI = 32 / L;           // tokens side by side in the warp
  static constexpr int CH = NT * TPI;          // tokens in a chunk
  static_assert(DH % VEC == 0 && PPT % L == 0 && PIECES % NS == 0, "shape");
  static_assert(CH * PPT == 32 * PIECES, "a chunk is 32 * PIECES pieces");
};

// One block: pages [p0, p0 + npg) of row b for query heads h0 .. h0 + G - 1
// (all of kv head hk).  Partials: part_acc (B, H, n_splits, DH), part_m and
// part_l (B, H, n_splits), all f32.  Shared memory: each warp's ring of
// `slots` chunks (the merge reuses it), then the split's page ids at pid_at.
template <typename T, int DH, int G>
__global__ void __launch_bounds__(THREADS)
paged_attention_split(const int32_t* __restrict__ table,
                      const int32_t* __restrict__ lengths,
                      const T* __restrict__ q, const T* __restrict__ kp,
                      const T* __restrict__ vp, float* __restrict__ part_acc,
                      float* __restrict__ part_m, float* __restrict__ part_l,
                      int NP, int P, int page, int H, int Hkv,
                      long long k_stride, long long v_stride, int pps,
                      int n_splits, int slots, int pid_at, float scale2) {
  using Lt = Tile<T, DH, G>;
  constexpr int VEC = Lt::VEC, L = Lt::L, NS = Lt::NS, NT = Lt::NT;
  constexpr int TPI = Lt::TPI, CH = Lt::CH;

  // the combine kernel may start launching; it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  extern __shared__ __align__(16) unsigned char smem[];
  const int h0 = blockIdx.x * G;
  const int b = blockIdx.y;
  const int split = blockIdx.z;  // slowest: every row's first splits go first
  const int hk = h0 / (H / Hkv);
  const size_t ph = (static_cast<size_t>(b) * H + h0) * n_splits + split;
  const int p0 = split * pps;
  // the page ids do not depend on the length: ask for both at once
  int* s_pid = reinterpret_cast<int*>(smem + pid_at);
  for (int i = threadIdx.x; i < pps && p0 + i < NP; i += THREADS)
    s_pid[i] = min(max(table[static_cast<size_t>(b) * NP + p0 + i], 0), P - 1);
  const int len = lengths[b];
  const int walk = len >= 1 ? min((len - 1) / page + 1, NP) : NP;
  if (p0 >= walk) {  // past the row's walk: an empty partial
    if (threadIdx.x < G)
      part_m[ph + static_cast<size_t>(threadIdx.x) * n_splits] = -INFINITY;
    return;
  }
  const int npg = min(pps, walk - p0);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int sub = lane % L;  // the lane's place in its token's row
  const int grp = lane / L;  // the lane's token among TPI side by side

  float qr[G][NS][VEC];  // the lane's query values, d = (s * L + sub) * VEC + v
  float acc[G][NS][VEC];
  float m[G], l[G];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const T* qs = q + (static_cast<size_t>(b) * H + h0 + gi) * DH +
                    (s * L + sub) * VEC;
      widen(*reinterpret_cast<const uint4*>(qs), qr[gi][s], T());
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[gi][s][v] = 0.f;
    }
    m[gi] = DEAD;
    l[gi] = 0.f;
  }
  __syncthreads();  // s_pid written

  // Chunk c of the split holds its tokens [c * CH, (c + 1) * CH); warp w
  // takes chunks w, w + WARPS, ...  Lane token j of a chunk is token
  // j * TPI + grp of it; its piece s (d-piece s * L + sub) sits at
  // (j * NS + s) * 32 + lane of the chunk's buffer.
  const int ntok = npg * page;
  const int nchunk = (ntok + CH - 1) / CH;
  const int mine = warp < nchunk ? (nchunk - 1 - warp) / WARPS + 1 : 0;
  const size_t tok_stride = static_cast<size_t>(Hkv) * DH;
  const T* kh = kp + static_cast<size_t>(hk) * DH;
  const T* vh = vp + static_cast<size_t>(hk) * DH;
  const int step = WARPS * CH;  // tokens between a warp's chunks
  const int dslot = step / page, doff = step - dslot * page;
  int islot[NT], ioff[NT];  // page slot and row in it of the next copy
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int t = warp * CH + j * TPI + grp;
    islot[j] = t / page;
    ioff[j] = t - islot[j] * page;
  }
  // slots = min(STAGES, the most chunks a warp of any block takes), so
  // chunk i's slot i % STAGES always lies in the ring
  unsigned char* ring = smem + warp * slots * 2 * CHUNK_BYTES;

  auto fetch = [&](int stage) {
    unsigned char* kb = ring + stage * 2 * CHUNK_BYTES;
    unsigned char* vb = kb + CHUNK_BYTES;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const bool ok = islot[j] < npg;
      const long long pid = s_pid[ok ? islot[j] : 0];
      const size_t row = static_cast<size_t>(ioff[j]) * tok_stride;
      const T* kr = kh + pid * k_stride + row;
      const T* vr = vh + pid * v_stride + row;
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const int at = ((j * NS + s) * 32 + lane) * 16;
        const int pc = (s * L + sub) * VEC;
        cp_async16(kb + at, kr + pc, ok);
        cp_async16(vb + at, vr + pc, ok);
      }
      ioff[j] += doff;
      islot[j] += dslot;
      if (ioff[j] >= page) {
        ioff[j] -= page;
        ++islot[j];
      }
    }
  };

  int fetched = 0;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (fetched < mine) fetch(fetched++ % STAGES);
    cp_async_commit();
  }
  const int live0 = p0 * page;  // the split's first token in the row
  for (int i = 0; i < mine; ++i) {
    cp_async_wait<STAGES - 2>();  // this lane's copies of chunk i landed
    __syncwarp();                 // every lane is done with chunk i - 1's slot
    if (fetched < mine) fetch(fetched++ % STAGES);
    cp_async_commit();

    const unsigned char* kb = ring + (i % STAGES) * 2 * CHUNK_BYTES;
    const unsigned char* vb = kb + CHUNK_BYTES;
    const int t0 = (warp + i * WARPS) * CH + grp;
    float sc[NT][G];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float kv[NS][VEC];
#pragma unroll
      for (int s = 0; s < NS; ++s)
        widen(*reinterpret_cast<const uint4*>(
                  kb + ((j * NS + s) * 32 + lane) * 16),
              kv[s], T());
      const int t = t0 + j * TPI;
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        float d = 0.f;
#pragma unroll
        for (int s = 0; s < NS; ++s)
#pragma unroll
          for (int v = 0; v < VEC; ++v) d = fmaf(qr[gi][s][v], kv[s][v], d);
#pragma unroll
        for (int o = L / 2; o > 0; o >>= 1)
          d += __shfl_xor_sync(FULL_MASK, d, o);
        // past the split: no token (weight 0); past the length: -1e30
        sc[j][gi] = t >= ntok ? -INFINITY
                    : live0 + t < len ? d * scale2 : DEAD;
      }
    }
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      float cm = sc[0][gi];
#pragma unroll
      for (int j = 1; j < NT; ++j) cm = fmaxf(cm, sc[j][gi]);
#pragma unroll
      for (int o = L; o < 32; o <<= 1)
        cm = fmaxf(cm, __shfl_xor_sync(FULL_MASK, cm, o));
      const float mn = fmaxf(m[gi], cm);
      const float alpha = exp2f(m[gi] - mn);
      m[gi] = mn;
      l[gi] *= alpha;
#pragma unroll
      for (int s = 0; s < NS; ++s)
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[gi][s][v] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float vv[NS][VEC];
#pragma unroll
      for (int s = 0; s < NS; ++s)
        widen(*reinterpret_cast<const uint4*>(
                  vb + ((j * NS + s) * 32 + lane) * 16),
              vv[s], T());
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const float p = exp2f(sc[j][gi] - m[gi]);
        l[gi] += p;
#pragma unroll
        for (int s = 0; s < NS; ++s)
#pragma unroll
          for (int v = 0; v < VEC; ++v)
            acc[gi][s][v] = fmaf(p, vv[s][v], acc[gi][s][v]);
      }
    }
  }
  cp_async_wait<0>();

  // sum the warp's TPI token groups (m is already the warp's own)
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
#pragma unroll
    for (int o = L; o < 32; o <<= 1) {
      l[gi] += __shfl_xor_sync(FULL_MASK, l[gi], o);
#pragma unroll
      for (int s = 0; s < NS; ++s)
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          acc[gi][s][v] += __shfl_xor_sync(FULL_MASK, acc[gi][s][v], o);
    }
  }

  // merge the warps once, in shared memory (the ring is free now)
  __syncthreads();
  float* s_acc = reinterpret_cast<float*>(smem);  // (WARPS, G, DH)
  float* s_m = s_acc + WARPS * G * DH;             // (WARPS, G), then s_l
  float* s_l = s_m + WARPS * G;
  if (lane < L) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
#pragma unroll
      for (int s = 0; s < NS; ++s)
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          s_acc[(warp * G + gi) * DH + (s * L + lane) * VEC + v] =
              acc[gi][s][v];
  }
  if (lane == 0) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      s_m[warp * G + gi] = m[gi];
      s_l[warp * G + gi] = l[gi];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * DH; i += THREADS) {
    const int gi = i / DH;
    const int d = i - gi * DH;
    float mx = s_m[gi];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) mx = fmaxf(mx, s_m[w * G + gi]);
    float a = 0.f, z = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float e = exp2f(s_m[w * G + gi] - mx);
      a = fmaf(e, s_acc[(w * G + gi) * DH + d], a);
      z = fmaf(e, s_l[w * G + gi], z);
    }
    const size_t at = ph + static_cast<size_t>(gi) * n_splits;
    part_acc[at * DH + d] = a;
    if (d == 0) {
      part_m[at] = mx;
      part_l[at] = z;
    }
  }
}

// One block per (row, query head), one thread per d.  Warp 0 lists the
// non-empty splits (m != -inf) with their weights exp(m_i - M) in shared
// memory and sums the weighted l; then every thread sums its d over that
// list, with no branch between its loads, and divides by max(l, 1e-30).
template <typename T>
__global__ void paged_attention_combine(const float* __restrict__ part_acc,
                                        const float* __restrict__ part_m,
                                        const float* __restrict__ part_l,
                                        T* __restrict__ out, int DH,
                                        int n_splits) {
  extern __shared__ float s_w[];  // (n_splits) weights, then split ids
  int* s_at = reinterpret_cast<int*>(s_w + n_splits);
  __shared__ int s_n;
  __shared__ float s_z;
  const size_t bh = blockIdx.x;
  // launched early (programmatic dependent launch): wait until the split
  // kernel has finished and its partials are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const float* pm = part_m + bh * n_splits;
    float mx = -INFINITY;
    for (int i = lane; i < n_splits; i += 32) mx = fmaxf(mx, pm[i]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, o));
    int n = 0;
    float z = 0.f;
    for (int i0 = 0; i0 < n_splits; i0 += 32) {
      const int i = i0 + lane;
      const float mi = i < n_splits ? pm[i] : -INFINITY;
      const bool live = mi != -INFINITY;  // an empty split is skipped
      const unsigned ballot = __ballot_sync(FULL_MASK, live);
      if (live) {
        const int k = n + __popc(ballot & ((1u << lane) - 1u));
        const float w = exp2f(mi - mx);
        s_w[k] = w;
        s_at[k] = i;
        z = fmaf(w, part_l[bh * n_splits + i], z);
      }
      n += __popc(ballot);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) z += __shfl_xor_sync(FULL_MASK, z, o);
    if (lane == 0) {
      s_n = n;
      s_z = fmaxf(z, 1e-30f);
    }
  }
  __syncthreads();
  const float* pa = part_acc + bh * n_splits * DH;
  const int n = s_n;
  for (int d = threadIdx.x; d < DH; d += blockDim.x) {
    float a = 0.f;
#pragma unroll 4
    for (int k = 0; k < n; ++k)
      a = fmaf(s_w[k], pa[static_cast<size_t>(s_at[k]) * DH + d], a);
    store(out + bh * DH + d, a / s_z);
  }
}

template <typename T, int DH, int G>
int launch(const void* table, const void* lengths, const void* q,
           const void* k, const void* v, void* out, float* part, int B,
           int NP, int P, int page, int H, int Hkv, long long k_stride,
           long long v_stride, int pps, int n_splits, cudaStream_t stream) {
  using Lt = Tile<T, DH, G>;
  const int chunks = (pps * page + Lt::CH - 1) / Lt::CH;
  const int per_warp = (chunks + WARPS - 1) / WARPS;
  const int slots = per_warp < STAGES ? per_warp : STAGES;
  const int ring = WARPS * slots * 2 * CHUNK_BYTES;
  const int merge = (WARPS * G * DH + 2 * WARPS * G) * sizeof(float);
  const int pid_at = ring > merge ? ring : merge;
  const size_t smem = pid_at + sizeof(int) * static_cast<size_t>(pps);
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(paged_attention_split<T, DH, G>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const size_t heads = static_cast<size_t>(B) * H * n_splits;
  float* part_m = part + heads * DH;
  float* part_l = part_m + heads;
  // logits in log2 units, so exp2 of a difference is exp of the original's
  const float scale2 =
      static_cast<float>(LOG2E / std::sqrt(static_cast<double>(DH)));
  paged_attention_split<T, DH, G><<<dim3(H / G, B, n_splits), THREADS, smem,
                                    stream>>>(
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(lengths),
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), part, part_m, part_l, NP, P, page, H, Hkv,
      k_stride, v_stride, pps, n_splits, slots, pid_at, scale2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  // the combine as a programmatic dependent launch: its blocks may be
  // scheduled while the split kernel's last blocks run
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * H);
  cfg.blockDim = dim3(DH);
  cfg.dynamicSmemBytes = 2 * sizeof(float) * n_splits;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, paged_attention_combine<T>,
                         static_cast<const float*>(part),
                         static_cast<const float*>(part_m),
                         static_cast<const float*>(part_l),
                         static_cast<T*>(out), DH, n_splits);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH>
int by_group(int G, const void* table, const void* lengths, const void* q,
             const void* k, const void* v, void* out, float* part, int B,
             int NP, int P, int page, int H, int Hkv, long long k_stride,
             long long v_stride, int pps, int n_splits, cudaStream_t s) {
#define K6_CASE(g)                                                          \
  case g:                                                                   \
    return launch<T, DH, g>(table, lengths, q, k, v, out, part, B, NP, P,   \
                            page, H, Hkv, k_stride, v_stride, pps, n_splits, \
                            s);
  switch (G) {
    K6_CASE(1)
    K6_CASE(2)
    K6_CASE(4)
    K6_CASE(8)
  }
#undef K6_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int by_dim(int Dh, int G, const void* table, const void* lengths,
           const void* q, const void* k, const void* v, void* out,
           float* part, int B, int NP, int P, int page, int H, int Hkv,
           long long k_stride, long long v_stride, int pps, int n_splits,
           cudaStream_t s) {
#define K6_CASE(dh)                                                          \
  case dh:                                                                   \
    return by_group<T, dh>(G, table, lengths, q, k, v, out, part, B, NP, P,  \
                           page, H, Hkv, k_stride, v_stride, pps, n_splits, \
                           s);
  switch (Dh) {
    K6_CASE(32)
    K6_CASE(64)
    K6_CASE(128)
    K6_CASE(256)
  }
#undef K6_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, the pages and out share it).
// k_stride / v_stride: elements between pages; each page's (page, Hkv, Dh)
// block is contiguous.  Dh is 32, 64, 128 or 256; G (query heads a block
// takes, all of one kv head) is 1, 2, 4 or 8 and divides H / Hkv.  part:
// B * H * n_splits * (Dh + 2) floats of scratch.  Launches the split kernel
// and then the combine kernel on the stream.
extern "C" int paged_attention_launch(const void* table, const void* lengths,
                                      const void* q, const void* k,
                                      const void* v, void* out, void* part,
                                      int B, int NP, int P, int page, int H,
                                      int Hkv, int Dh, int G,
                                      long long k_stride, long long v_stride,
                                      int pps, int n_splits, int dtype,
                                      void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto f = static_cast<float*>(part);
  if (dtype == 1)
    return by_dim<__nv_bfloat16>(Dh, G, table, lengths, q, k, v, out, f, B,
                                 NP, P, page, H, Hkv, k_stride, v_stride, pps,
                                 n_splits, s);
  return by_dim<float>(Dh, G, table, lengths, q, k, v, out, f, B, NP, P, page,
                       H, Hkv, k_stride, v_stride, pps, n_splits, s);
}
