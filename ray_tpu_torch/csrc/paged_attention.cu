// Paged decode attention for Hopper (sm_90a), fp32 or bf16 inputs.
//
// Replaces: ray_tpu/ops/paged_attention.py::_paged_kernel (launched by
// paged_attention, pallas_call at paged_attention.py:172). Same function:
// history-only attention of each slot's G query rows per kv head over the
// pages its block table lists, positions < ctx_len only, folded page by
// page into an online softmax. Returns the un-normalised triple
// acc f32 [S, KVH, G, hd], m f32 [S, KVH, G], l f32 [S, KVH, G]; a slot
// with ctx 0 returns acc 0, l 0, m -1e30. The caller merges the
// in-flight token's self term (models/llama_paged.py).
//
// Layout: q [S, KVH, G, hd]; k/v pools [P, KVH, page, hd] (one page of one
// kv head is a contiguous page*hd run); block_table [S, MAXP] int32;
// ctx_len [S] int32.
//
// What bounds it: every K/V byte of the history is used by only G (= 4 at
// Llama-3-8B) query rows, ~2 FLOPs per byte, far below the card's ridge:
// the bound is memory bandwidth over the ctx tokens' pages. Design: one
// block per (slot, kv head) serves all G rows of the group, so each page
// is read from device memory exactly once; the block reads its own
// ctx_len and block-table entries (the TPU used scalar prefetch) and
// walks only pages < ceil(ctx/page), never touching a table entry at or
// past ctx, which may hold any id. An entry below ctx that lies outside
// the pool is read as a JAX gather reads it (negative ids count from the
// end, the rest clamp into [0, P-1]), like clamp_page_ids in
// ops/paged_attention.py, so no id reads outside the pool. Each page is
// staged once in shared memory; scores, the softmax fold and the fp32
// accumulator stay on chip.
// Not yet done: splitting long contexts across blocks (the (acc, m, l)
// contract allows a split-K merge) and async copies of the next page.

#include "common.cuh"

namespace {

constexpr int NT = 128;

size_t paged_smem_bytes(int G, int hd, int page) {
  // Qs [G][hd] + Ks [page][hd+1] + Vs [page][hd] + Ps [G][page]
  // + Acc [G][hd] + m, l, alpha [G], fp32
  return sizeof(float) * (static_cast<size_t>(G) * hd +
                          static_cast<size_t>(page) * (hd + 1) +
                          static_cast<size_t>(page) * hd +
                          static_cast<size_t>(G) * page +
                          static_cast<size_t>(G) * hd + 3 * G);
}

template <typename T>
__global__ void __launch_bounds__(NT)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp,
                       const int* __restrict__ block_table,
                       const int* __restrict__ ctx_len,
                       float* __restrict__ acc_out,
                       float* __restrict__ m_out, float* __restrict__ l_out,
                       int KVH, int G, int hd, int page, int num_pages,
                       int maxp, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + G * hd;
  float* Vs = Ks + page * (hd + 1);
  float* Ps = Vs + page * hd;
  float* Acc = Ps + G * page;
  float* Ms = Acc + G * hd;
  float* Ls = Ms + G;
  float* Al = Ls + G;

  const int slot = blockIdx.x;
  const int kh = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int NW = NT / 32;

  const int ctx = ctx_len[slot];
  const int n_pages = ctx <= 0 ? 0 : min((ctx + page - 1) / page, maxp);
  const long row0 = (static_cast<long>(slot) * KVH + kh) * G;  // first q row

  for (int e = tid; e < G * hd; e += NT) {
    Qs[e] = rtt::to_float(q[row0 * hd + e]) * scale;
    Acc[e] = 0.f;
  }
  for (int g = tid; g < G; g += NT) {
    Ms[g] = rtt::kNegInf;
    Ls[g] = 0.f;
  }

  for (int p = 0; p < n_pages; ++p) {
    long pid = block_table[static_cast<long>(slot) * maxp + p];
    if (pid < 0) pid += num_pages;
    pid = pid < 0 ? 0 : (pid >= num_pages ? num_pages - 1 : pid);
    const long page_off = (pid * KVH + kh) * static_cast<long>(page) * hd;
    __syncthreads();  // previous page's readers are done; Qs/Acc written
    for (int e = tid; e < page * hd; e += NT) {
      const int r = e / hd, c = e % hd;
      Ks[r * (hd + 1) + c] = rtt::to_float(kp[page_off + e]);
      Vs[e] = rtt::to_float(vp[page_off + e]);
    }
    __syncthreads();

    const int base = p * page;
    for (int e = tid; e < G * page; e += NT) {
      const int g = e / page, c = e % page;
      const float* qr = Qs + g * hd;
      const float* kr = Ks + c * (hd + 1);
      float s = 0.f;
      for (int dd = 0; dd < hd; ++dd) s = fmaf(qr[dd], kr[dd], s);
      Ps[e] = base + c < ctx ? s : rtt::kNegInf;
    }
    __syncthreads();

    for (int g = warp; g < G; g += NW) {
      float* pr = Ps + g * page;
      float mx = rtt::kNegInf;
      for (int c = lane; c < page; c += 32) mx = fmaxf(mx, pr[c]);
      mx = rtt::group_max<32>(mx);
      const float m_old = Ms[g];
      const float m_new = fmaxf(m_old, mx);
      float rs = 0.f;
      for (int c = lane; c < page; c += 32) {
        const float w = base + c < ctx ? expf(pr[c] - m_new) : 0.f;
        pr[c] = w;
        rs += w;
      }
      rs = rtt::group_sum<32>(rs);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        Ls[g] = Ls[g] * alpha + rs;
        Ms[g] = m_new;
        Al[g] = alpha;
      }
    }
    __syncthreads();

    for (int e = tid; e < G * hd; e += NT) {
      const int g = e / hd, dd = e % hd;
      const float* pr = Ps + g * page;
      float a = Acc[e] * Al[g];
      for (int c = 0; c < page; ++c) a = fmaf(pr[c], Vs[c * hd + dd], a);
      Acc[e] = a;
    }
  }
  __syncthreads();

  for (int e = tid; e < G * hd; e += NT) acc_out[row0 * hd + e] = Acc[e];
  for (int g = tid; g < G; g += NT) {
    m_out[row0 + g] = Ms[g];
    l_out[row0 + g] = Ls[g];
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* bt, const void* ctx, void* acc, void* m,
                   void* l, int S, int KVH, int G, int hd, int page,
                   int num_pages, int maxp, float scale,
                   cudaStream_t stream) {
  const size_t smem = paged_smem_bytes(G, hd, page);
  cudaError_t err = cudaFuncSetAttribute(
      paged_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(S, KVH);
  paged_attention_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(bt),
      static_cast<const int*>(ctx), static_cast<float*>(acc),
      static_cast<float*>(m), static_cast<float*>(l), KVH, G, hd, page,
      num_pages, maxp, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rtt_paged_attention(const void* q, const void* kp,
                                   const void* vp, const void* block_table,
                                   const void* ctx_len, void* acc, void* m,
                                   void* l, int dtype, int S, int KVH, int G,
                                   int hd, int page, int num_pages, int maxp,
                                   float scale, void* stream) {
  if (S <= 0 || KVH <= 0 || G <= 0 || hd <= 0 || page <= 0 ||
      num_pages <= 0 || maxp <= 0 || KVH > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rtt::kFloat32)
    return static_cast<int>(launch<float>(q, kp, vp, block_table, ctx_len,
                                          acc, m, l, S, KVH, G, hd, page,
                                          num_pages, maxp, scale, st));
  if (dtype == rtt::kBFloat16)
    return static_cast<int>(launch<__nv_bfloat16>(
        q, kp, vp, block_table, ctx_len, acc, m, l, S, KVH, G, hd, page,
        num_pages, maxp, scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
