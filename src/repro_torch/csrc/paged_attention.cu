// K6 paged_attention: one GQA decode step over a paged KV pool.  Per batch
// row b, walk the row's page table, fetch each (page, Hkv, Dh) K/V tile of
// one kv head, and run an online softmax over the pages; the output is
// (B, H, Dh) in q's dtype.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/
// paged_attention.py: paged_attention_call (body _kernel).  It keeps that
// kernel's numerics: f32 accumulation, scale 1/sqrt(f32(Dh)), dead logits
// (token p*page + i >= lengths[b]) set to -1e30, the running max starting
// at -1e30, the final divide by max(l, 1e-30).  Query head h reads kv head
// h / (H / Hkv).  Page ids are clamped into [0, P).
//
// What bounds it on the H100: bytes.  A decode step does 2 flops per K/V
// element it reads (about 0.5 flop a byte in f32), far below the card's
// ridge, so the least time is the live tokens' K and V over HBM bandwidth.
// The TPU kernel walks every page of the table (its grid is (B, NP)) with
// the tile DMA'd by a scalar-prefetched BlockSpec.  Here one block takes
// one (b, kv head): the group's g query rows sit in shared memory, and the
// block walks only the pages up to the last live token.  That is exact:
// once a live logit has been seen the running max is finite and every later
// dead logit gives exp(-1e30 - m) = 0.  A row of length 0 has no live
// token, so the block walks every page, as the TPU kernel does (each logit
// -1e30, each prob exp(0) = 1: the mean of v).  Per page: one warp per
// token computes its g logits (lane l holds K elements l, l+32, ...: one
// coalesced read of the token's Dh-vector, warp-shuffle sums); one thread
// per query row updates max and sum; then each thread owns (row, d)
// entries of the accumulator and adds sum_t p[t] * V[t, d], coalesced over
// d.  This first version keeps no tiles in flight and uses no tensor cores:
// it is right and simple; splitting a row's pages over several blocks
// (flash-decoding's split-K) is later work.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_PER_LANE = 8;  // Dh <= 256
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr float DEAD = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const int32_t* __restrict__ table,
                       const int32_t* __restrict__ lengths,
                       const T* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp, T* __restrict__ out, int NP,
                       int P, int page, int H, int Hkv, int Dh,
                       long long k_stride, long long v_stride, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / Hkv;
  const int hk = blockIdx.x - b * Hkv;
  const int g = H / Hkv;
  const int gd = g * Dh;
  float* s_q = smem;              // (g, Dh) the group's query rows
  float* s_acc = s_q + gd;        // (g, Dh) running numerator
  float* s_p = s_acc + gd;        // (g, page) logits, then probs
  float* s_m = s_p + g * page;    // (g) running max
  float* s_l = s_m + g;           // (g) running denominator
  float* s_alpha = s_l + g;       // (g) this page's rescale
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const size_t head0 = (static_cast<size_t>(b) * H +
                        static_cast<size_t>(hk) * g) * Dh;
  for (int i = tid; i < gd; i += THREADS) {
    s_q[i] = to_f32(q[head0 + i]);
    s_acc[i] = 0.f;
  }
  for (int i = tid; i < g; i += THREADS) {
    s_m[i] = DEAD;
    s_l[i] = 0.f;
  }
  __syncthreads();

  const int len = lengths[b];
  const int walk = len >= 1 ? min((len - 1) / page + 1, NP) : NP;
  const size_t tok = static_cast<size_t>(Hkv) * Dh;  // between a page's tokens
  for (int p = 0; p < walk; ++p) {
    const int pid = min(max(table[static_cast<size_t>(b) * NP + p], 0), P - 1);
    const T* kb = kp + pid * k_stride + hk * Dh;
    const T* vb = vp + pid * v_stride + hk * Dh;
    for (int t = warp; t < page; t += WARPS) {
      const T* kt = kb + t * tok;
      float kr[MAX_PER_LANE];
#pragma unroll
      for (int j = 0; j < MAX_PER_LANE; ++j) {
        const int d = lane + 32 * j;
        kr[j] = d < Dh ? to_f32(kt[d]) : 0.f;
      }
      const bool live = static_cast<long long>(p) * page + t < len;
      for (int gi = 0; gi < g; ++gi) {
        const float* qg = s_q + gi * Dh;
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < MAX_PER_LANE; ++j) {
          const int d = lane + 32 * j;
          if (d < Dh) s += qg[d] * kr[j];
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL_MASK, s, o);
        if (lane == 0) s_p[gi * page + t] = live ? s * scale : DEAD;
      }
    }
    __syncthreads();
    for (int gi = tid; gi < g; gi += THREADS) {
      float* pr = s_p + gi * page;
      float mx = DEAD;
      for (int t = 0; t < page; ++t) mx = fmaxf(mx, pr[t]);
      const float m_old = s_m[gi];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = 0; t < page; ++t) {
        const float e = expf(pr[t] - m_new);
        pr[t] = e;
        sum += e;
      }
      const float alpha = expf(m_old - m_new);
      s_l[gi] = alpha * s_l[gi] + sum;
      s_m[gi] = m_new;
      s_alpha[gi] = alpha;
    }
    __syncthreads();
    for (int i = tid; i < gd; i += THREADS) {
      const int gi = i / Dh;
      const int d = i - gi * Dh;
      const float* pr = s_p + gi * page;
      float pv = 0.f;
      for (int t = 0; t < page; ++t) pv += pr[t] * to_f32(vb[t * tok + d]);
      s_acc[i] = s_alpha[gi] * s_acc[i] + pv;
    }
    __syncthreads();
  }
  for (int i = tid; i < gd; i += THREADS)
    store(out + head0 + i, s_acc[i] / fmaxf(s_l[i / Dh], 1e-30f));
}

template <typename T>
int launch(const void* table, const void* lengths, const void* q,
           const void* k, const void* v, void* out, int B, int NP, int P,
           int page, int H, int Hkv, int Dh, long long k_stride,
           long long v_stride, cudaStream_t stream) {
  const int g = H / Hkv;
  const size_t smem = sizeof(float) *
      (2 * static_cast<size_t>(g) * Dh + static_cast<size_t>(g) * page +
       3 * static_cast<size_t>(g));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const float scale = 1.0f / std::sqrt(static_cast<float>(Dh));
  paged_attention_kernel<T><<<B * Hkv, THREADS, smem, stream>>>(
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(lengths),
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), NP, P, page, H, Hkv,
      Dh, k_stride, v_stride, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, the pages and out share it).
// k_stride / v_stride: elements between pages; each page's (page, Hkv, Dh)
// block is contiguous.
extern "C" int paged_attention_launch(const void* table, const void* lengths,
                                      const void* q, const void* k,
                                      const void* v, void* out, int B, int NP,
                                      int P, int page, int H, int Hkv, int Dh,
                                      long long k_stride, long long v_stride,
                                      int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(table, lengths, q, k, v, out, B, NP, P, page,
                                 H, Hkv, Dh, k_stride, v_stride, s);
  return launch<float>(table, lengths, q, k, v, out, B, NP, P, page, H, Hkv,
                       Dh, k_stride, v_stride, s);
}
