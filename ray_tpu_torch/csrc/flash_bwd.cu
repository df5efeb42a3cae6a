// Flash-attention backward for Hopper (sm_90a), the scalar kernels: dQ
// and dK/dV for bf16 inputs at head dim 16 and 32 (bf16 storage, fp32
// arithmetic; the tiny presets' widths, below a wgmma tile's 64-column
// box). fp32 takes flash_bwd_dq_tf32x3.cu and flash_bwd_dkv_tf32x3.cu
// (3xTF32 on the tensor cores); bf16 at head dim 64 and 128 takes the
// wgmma kernels fed by TMA (flash_bwd_dq_sm90.cu, flash_bwd_dkv_sm90.cu),
// and at head dim 256 flash_bwd_dq_sm90_d256.cu and
// flash_bwd_dkv_sm90_d256.cu.
//
// Replaces: ray_tpu/ops/attention.py::_flash_bwd_dq_kernel (pallas_call at
// attention.py:346) and ::_flash_bwd_dkv_kernel (pallas_call at :368) at
// those bf16 widths. Same function: both recompute P = exp(S*scale - lse)
// tile by tile from the forward's fp32 row logsumexp, with masked scores
// at -1e30 under the causal offset sk - sq, then dP = dO V^T and dS =
// P * (dP - delta), where delta = rowsum(dO * O) comes from the wrapper
// (XLA computes it outside the Pallas kernels too). dQ = scale * dS K;
// dK = scale * dS^T Q; dV = P^T dO.
//
// Layout: q, o, dO [b, sq, H, d]; k, v [b, sk, KVH, d] (the port's public
// layout, read in place through row strides; query head h reads kv head
// h / (H / KVH)); lse, delta [b*H, sq] fp32; dq [b, sq, H, d]; dk, dv
// [b, sk, KVH, d].
//
// What bounds it: dQ does 6*d FLOPs and dK/dV 8*d FLOPs per visible
// (q, k) pair and query head, far above the card's FLOP/byte ridge, so
// the bound is the compute rate. These kernels are scalar fp32 FMAs out
// of shared memory, at widths too narrow for a wgmma tile; no main path
// at full width launches them.
// What the design does do:
// - dQ: one block per (b*H, 64 query rows) stages Q and dO once, walks the
//   64-key K/V tiles up to the causal bound, and keeps the 64 x d fp32 dQ
//   accumulator in registers; the dS tile lives only in shared memory.
// - dK/dV: one block per (b, kv head, 64-key tile) stages its K and V tile
//   once and loops over the G query heads of its GQA group and the q tiles
//   from the causal lower bound, so the group sum happens inside the block:
//   no per-query-head [b*H, sk, d] intermediates, no second reduction pass
//   and no atomics. Both 64 x d fp32 accumulators stay in registers
//   (256 threads: 4 key rows x d/16 columns each per accumulator).
// Neither kernel writes a score-sized tensor to device memory.

#include "common.cuh"

namespace {

constexpr int NT = 256;  // threads per block: 16 row groups x 16 col groups

// The tiles: BQ query rows and BK keys; each thread holds rows rg + 16*i
// (i < RI) and columns cg + 16*j (j < CJ) of a score tile.
constexpr int BQ = 64, BK = 64;
constexpr int RI = BQ / 16, CJ = BK / 16;

template <int D>
constexpr size_t dq_smem_bytes() {
  // Qs, dOs [BQ][D+1] + Ks, Vs [BK][D+1] + dSs [BQ][BK+1], fp32; the +1
  // pads keep the column walks of the products bank-conflict free
  return sizeof(float) * (2 * BQ * (D + 1) + 2 * BK * (D + 1) +
                          BQ * (BK + 1));
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // Ks, Vs [BK][D+1] + Qs, dOs [BQ][D+1] + Ps, dSs [BQ][BK+1], fp32
  return sizeof(float) * (2 * BK * (D + 1) + 2 * BQ * (D + 1) +
                          2 * BQ * (BK + 1));
}

// Stage rows [r0, r0 + ROWS) of a [rows, stride] matrix (d columns from
// base) as fp32 into S [ROWS][D+1]; rows past n read as zeros.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void stage(float* S, const T* __restrict__ base,
                                      long stride, int r0, int n) {
  for (int e = threadIdx.x; e < ROWS * D; e += NT) {
    const int r = e / D, c = e % D, row = r0 + r;
    S[r * (D + 1) + c] = row < n ? rtt::to_float(base[row * stride + c]) : 0.f;
  }
}

// The score and dP tiles of one (BQ query rows) x (BK keys) pair, for this
// thread's rows rg + 16*i and keys cg + 16*j: s = Q K^T, dp = dO V^T.
template <int D>
__device__ __forceinline__ void score_tiles(const float* Qs, const float* dOs,
                                            const float* Ks, const float* Vs,
                                            int rg, int cg, float (&s)[RI][CJ],
                                            float (&dp)[RI][CJ]) {
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int dd = 0; dd < D; ++dd) {
    float a[RI], g[RI], kk[CJ], vv[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      a[i] = Qs[(rg + 16 * i) * (D + 1) + dd];
      g[i] = dOs[(rg + 16 * i) * (D + 1) + dd];
    }
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      kk[j] = Ks[(cg + 16 * j) * (D + 1) + dd];
      vv[j] = Vs[(cg + 16 * j) * (D + 1) + dd];
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        s[i][j] = fmaf(a[i], kk[j], s[i][j]);
        dp[i][j] = fmaf(g[i], vv[j], dp[i][j]);
      }
  }
}

// P = exp(S*scale - lse) with masked scores at -1e30 (keys past sk, or
// padded query rows, give 0); returns P and dS = P * (dP - delta).
__device__ __forceinline__ float2 probs(float s, float dp, float lse_r,
                                        float delta_r, int qi, int kj, int sq,
                                        int sk, int offset, int causal,
                                        float scale) {
  if (qi >= sq || kj >= sk) return make_float2(0.f, 0.f);
  float x = s * scale;
  if (causal && offset + qi < kj) x = rtt::kNegInf;
  const float p = expf(x - lse_r);
  return make_float2(p, p * (dp - delta_r));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int sq, int sk, int H, int KVH, int causal, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * (D + 1);
  float* Ks = dOs + BQ * (D + 1);
  float* Vs = Ks + BK * (D + 1);
  float* dSs = Vs + BK * (D + 1);

  constexpr int DJ = D / 16;  // dQ columns per thread: cg + 16*j

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
  const long q_off = static_cast<long>(b) * sq * q_stride + hh * D;
  const T* kb = k + static_cast<long>(b) * sk * kv_stride + kh * D;
  const T* vb = v + static_cast<long>(b) * sk * kv_stride + kh * D;

  stage<T, D, BQ>(Qs, q + q_off, q_stride, q0, sq);
  stage<T, D, BQ>(dOs, dout + q_off, q_stride, q0, sq);

  float lse_r[RI], delta_r[RI], acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qi = q0 + rg + 16 * i;
    lse_r[i] = qi < sq ? lse[static_cast<long>(bh) * sq + qi] : 0.f;
    delta_r[i] = qi < sq ? delta[static_cast<long>(bh) * sq + qi] : 0.f;
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
    __syncthreads();  // the previous tile's readers of Ks, Vs, dSs are done
    stage<T, D, BK>(Ks, kb, kv_stride, k0, sk);
    stage<T, D, BK>(Vs, vb, kv_stride, k0, sk);
    __syncthreads();

    float s[RI][CJ], dp[RI][CJ];
    score_tiles<D>(Qs, dOs, Ks, Vs, rg, cg, s, dp);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int r = rg + 16 * i, c = cg + 16 * j;
        dSs[r * (BK + 1) + c] =
            probs(s[i][j], dp[i][j], lse_r[i], delta_r[i], q0 + r, k0 + c,
                  sq, sk, offset, causal, scale).y;
      }
    __syncthreads();  // dSs complete

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float ds[RI], kv[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) ds[i] = dSs[(rg + 16 * i) * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = Ks[kk * (D + 1) + cg + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(ds[i], kv[j], acc[i][j]);
    }
  }

  T* dqb = dq + q_off;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qi = q0 + rg + 16 * i;
    if (qi >= sq) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      dqb[qi * q_stride + cg + 16 * j] = rtt::from_float<T>(acc[i][j] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int sq, int sk, int H, int KVH,
                     int causal, float scale) {
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * (D + 1);
  float* Qs = Vs + BK * (D + 1);
  float* dOs = Qs + BQ * (D + 1);
  float* Ps = dOs + BQ * (D + 1);
  float* dSs = Ps + BQ * (BK + 1);

  constexpr int DJ = D / 16;  // dK/dV columns per thread: cg + 16*j

  const int bkh = blockIdx.y;
  const int b = bkh / KVH;
  const int kh = bkh % KVH;
  const int G = H / KVH;
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x;
  const int rg = tid / 16;
  const int cg = tid % 16;

  const long q_stride = static_cast<long>(H) * D;
  const long kv_stride = static_cast<long>(KVH) * D;
  const long kv_off = static_cast<long>(b) * sk * kv_stride + kh * D;

  stage<T, D, BK>(Ks, k + kv_off, kv_stride, k0, sk);
  stage<T, D, BK>(Vs, v + kv_off, kv_stride, k0, sk);

  // rows of the accumulators are this tile's keys k0 + rg + 16*i
  float dk_acc[RI][DJ], dv_acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int offset = sk - sq;
  // first query tile with a row that sees key k0: q row >= k0 - offset
  const int first = causal ? k0 - offset : 0;
  const int qt_lo = first <= 0 ? 0 : first / BQ;
  const int n_qt = (sq + BQ - 1) / BQ;

  for (int g = 0; g < G; ++g) {
    const int hh = kh * G + g;
    const long bh = static_cast<long>(b) * H + hh;
    const long q_off = static_cast<long>(b) * sq * q_stride + hh * D;
    for (int qt = qt_lo; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous tile's readers are done
      stage<T, D, BQ>(Qs, q + q_off, q_stride, q0, sq);
      stage<T, D, BQ>(dOs, dout + q_off, q_stride, q0, sq);
      __syncthreads();

      float s[RI][CJ], dp[RI][CJ];
      score_tiles<D>(Qs, dOs, Ks, Vs, rg, cg, s, dp);
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int r = rg + 16 * i, qi = q0 + r;
        const float lse_r = qi < sq ? lse[bh * sq + qi] : 0.f;
        const float delta_r = qi < sq ? delta[bh * sq + qi] : 0.f;
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          const int c = cg + 16 * j;
          const float2 pd = probs(s[i][j], dp[i][j], lse_r, delta_r, qi,
                                  k0 + c, sq, sk, offset, causal, scale);
          Ps[r * (BK + 1) + c] = pd.x;
          dSs[r * (BK + 1) + c] = pd.y;
        }
      }
      __syncthreads();  // Ps, dSs complete

#pragma unroll 4
      for (int qq = 0; qq < BQ; ++qq) {
        float p[RI], ds[RI], gq[DJ], qv[DJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          p[i] = Ps[qq * (BK + 1) + rg + 16 * i];
          ds[i] = dSs[qq * (BK + 1) + rg + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          gq[j] = dOs[qq * (D + 1) + cg + 16 * j];
          qv[j] = Qs[qq * (D + 1) + cg + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            dv_acc[i][j] = fmaf(p[i], gq[j], dv_acc[i][j]);
            dk_acc[i][j] = fmaf(ds[i], qv[j], dk_acc[i][j]);
          }
      }
    }
  }

  T* dkb = dk + kv_off;
  T* dvb = dv + kv_off;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int kj = k0 + rg + 16 * i;
    if (kj >= sk) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const long idx = kj * kv_stride + cg + 16 * j;
      dkb[idx] = rtt::from_float<T>(dk_acc[i][j] * scale);
      dvb[idx] = rtt::from_float<T>(dv_acc[i][j]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int b, int sq, int sk, int H, int KVH,
                      int causal, float scale, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((sq + BQ - 1) / BQ, b * H);
  flash_bwd_dq_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), sq, sk, H, KVH, causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int b, int sq, int sk, int H,
                       int KVH, int causal, float scale,
                       cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((sk + BK - 1) / BK, b * KVH);
  flash_bwd_dkv_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), sq, sk, H, KVH, causal,
      scale);
  return cudaGetLastError();
}

bool bad_shape(int b, int sq, int sk, int H, int KVH) {
  return b <= 0 || sq <= 0 || sk <= 0 || KVH <= 0 || H % KVH != 0 ||
         b * H > 65535;
}

}  // namespace

// bf16 at d 16 or 32 (fp32 takes flash_bwd_dq_tf32x3.cu).
extern "C" int rtt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int b, int sq,
                                int sk, int H, int KVH, int d, int causal,
                                float scale, void* stream) {
  if (bad_shape(b, sq, sk, H, KVH))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16:
      return static_cast<int>(launch_dq<__nv_bfloat16, 16>(
          q, k, v, dout, lse, delta, dq, b, sq, sk, H, KVH, causal, scale,
          st));
    case 32:
      return static_cast<int>(launch_dq<__nv_bfloat16, 32>(
          q, k, v, dout, lse, delta, dq, b, sq, sk, H, KVH, causal, scale,
          st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// bf16 at d 16 or 32 (fp32 takes flash_bwd_dkv_tf32x3.cu).
extern "C" int rtt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv, int b,
                                 int sq, int sk, int H, int KVH, int d,
                                 int causal, float scale, void* stream) {
  if (bad_shape(b, sq, sk, H, KVH))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16:
      return static_cast<int>(launch_dkv<__nv_bfloat16, 16>(
          q, k, v, dout, lse, delta, dk, dv, b, sq, sk, H, KVH, causal, scale,
          st));
    case 32:
      return static_cast<int>(launch_dkv<__nv_bfloat16, 32>(
          q, k, v, dout, lse, delta, dk, dv, b, sq, sk, H, KVH, causal, scale,
          st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
