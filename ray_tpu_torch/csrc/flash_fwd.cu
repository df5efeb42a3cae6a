// Flash-attention forward for Hopper (sm_90a), the scalar kernel: bf16
// inputs at head dim 16 and 32 (bf16 storage, fp32 arithmetic), the tiny
// presets' widths, below a wgmma tile's 64-column box. bf16 at head dim
// 64 and 128 takes flash_fwd_sm90.cu, at head dim 256
// flash_fwd_sm90_d256.cu (wgmma fed by TMA); fp32 at every head dim takes
// flash_fwd_tf32x3.cu (3xTF32 on the tensor cores).
//
// Replaces: ray_tpu/ops/attention.py::_flash_kernel (launched by
// _flash_forward, pallas_call at attention.py:178) at those widths. Same
// function: blocked causal or non-causal attention with an fp32 online
// softmax, the scale applied to q, the causal mask offset by sk - sq, GQA
// head h reading kv head h / (H / KVH), outputs O in q's dtype and the
// fp32 row logsumexp lse = m + log(max(l, 1e-30)) that the backward
// kernels consume.
//
// Layout: q [b, sq, H, d], k/v [b, sk, KVH, d] (the port's public layout,
// read in place through row strides: no transposed or repeated-KV copy),
// o [b, sq, H, d], lse [b*H, sq].
//
// What bounds it: at d 16 and 32 a tile's products are short and the
// kernel is small next to the layers around it (the tiny presets), so it
// stays simple: scalar fp32 FMAs out of shared memory. One block per
// (b*H, 64-row query tile) keeps the whole online softmax (m, l, and a
// 64 x d fp32 accumulator) in registers, stages each 64-key K/V tile once
// in shared memory for all 64 query rows, never writes the score matrix
// to device memory, and stops at the causal bound.

#include "common.cuh"

namespace {

constexpr int BK = 64;   // keys per tile
constexpr int BQ = 64;   // query rows per block
constexpr int NT = 128;  // threads per block: 8 row groups x 16 col groups

template <int D>
constexpr size_t flash_smem_bytes() {
  // Qs [BQ][D+1] + Ks [BK][D+1] + Vs [BK][D] + Ps [BQ][BK+1], fp32; the
  // +1 pads keep the column walks of the two products bank-conflict free
  return sizeof(float) *
         (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int sq, int sk, int H, int KVH,
                 int causal, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * (D + 1);
  float* Vs = Ks + BK * (D + 1);
  float* Ps = Vs + BK * D;

  constexpr int RI = BQ / 8;   // rows per thread: rg + 8*i
  constexpr int CJ = BK / 16;  // score columns per thread: cg + 16*j
  constexpr int DJ = D / 16;   // output columns per thread: cg + 16*j

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int hh = bh % H;
  const int kh = hh / (H / KVH);
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int rg = tid / 16;
  const int cg = tid % 16;

  const long q_stride = static_cast<long>(H) * D;
  const long kv_stride = static_cast<long>(KVH) * D;
  const T* qb = q + static_cast<long>(b) * sq * q_stride + hh * D;
  const T* kb = k + static_cast<long>(b) * sk * kv_stride + kh * D;
  const T* vb = v + static_cast<long>(b) * sk * kv_stride + kh * D;

  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, c = e % D, qi = q0 + r;
    Qs[r * (D + 1) + c] =
        qi < sq ? rtt::to_float(qb[qi * q_stride + c]) * scale : 0.f;
  }

  float acc[RI][DJ];
  float m[RI], l[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = rtt::kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int offset = sk - sq;  // query row i sits at key position offset+i
  int n_kt = (sk + BK - 1) / BK;
  if (causal) {
    const int last_q = offset + min(q0 + BQ, sq) - 1;
    n_kt = min(n_kt, last_q < 0 ? 0 : last_q / BK + 1);
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < BK * D; e += NT) {
      const int r = e / D, c = e % D, kj = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (kj < sk) {
        kv = rtt::to_float(kb[kj * kv_stride + c]);
        vv = rtt::to_float(vb[kj * kv_stride + c]);
      }
      Ks[r * (D + 1) + c] = kv;
      Vs[r * D + c] = vv;
    }
    __syncthreads();

    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < D; ++dd) {
      float a[RI], bk[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) a[i] = Qs[(rg + 8 * i) * (D + 1) + dd];
#pragma unroll
      for (int j = 0; j < CJ; ++j) bk[j] = Ks[(cg + 16 * j) * (D + 1) + dd];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = rg + 8 * i;
      const int qi = q0 + r;
      float mx = rtt::kNegInf;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int kj = k0 + cg + 16 * j;
        if (kj >= sk)
          s[i][j] = -__int_as_float(0x7f800000);  // past the keys: -inf
        else if (causal && offset + qi < kj)
          s[i][j] = rtt::kNegInf;  // masked like the reference
        mx = fmaxf(mx, s[i][j]);
      }
      mx = rtt::group_max<16>(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[r * (BK + 1) + cg + 16 * j] = p;
        rs += p;
      }
      rs = rtt::group_sum<16>(rs);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // Ps complete

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[RI], vv[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) p[i] = Ps[(rg + 8 * i) * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[kk * D + cg + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

  T* ob = o + static_cast<long>(b) * sq * q_stride + hh * D;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qi = q0 + rg + 8 * i;
    if (qi >= sq) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      ob[qi * q_stride + cg + 16 * j] =
          rtt::from_float<T>(acc[i][j] / l_safe);
    if (cg == 0) lse[static_cast<long>(bh) * sq + qi] = m[i] + logf(l_safe);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int b, int sq, int sk, int H, int KVH,
                   int causal, float scale, cudaStream_t stream) {
  const size_t smem = flash_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((sq + BQ - 1) / BQ, b * H);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), sq, sk, H, KVH, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// bf16 at d 16 or 32.
extern "C" int rtt_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int b, int sq, int sk,
                             int H, int KVH, int d, int causal, float scale,
                             void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || KVH <= 0 || H % KVH != 0 ||
      b * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (d) {
    case 16:
      err = launch<__nv_bfloat16, 16>(q, k, v, o, lse, b, sq, sk, H, KVH,
                                      causal, scale, st);
      break;
    case 32:
      err = launch<__nv_bfloat16, 32>(q, k, v, o, lse, b, sq, sk, H, KVH,
                                      causal, scale, st);
      break;
  }
  return static_cast<int>(err);
}
