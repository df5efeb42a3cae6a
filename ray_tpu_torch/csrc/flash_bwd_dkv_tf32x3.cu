// Flash-attention dK/dV backward for Hopper (sm_90a) on fp32 inputs, on
// the tensor cores in 3xTF32 (tf32x3.cuh): head dim 16, 32, 64, 128 and
// 256.
//
// Replaces: ray_tpu/ops/attention.py::_flash_bwd_dkv_kernel (pallas_call
// at attention.py:368) on the fp32 path. Same function and contract as
// the scalar kernel's rtt_flash_bwd_dkv: P = exp(S*scale - lse) recomputed
// tile by tile from the forward's row logsumexp (masked scores at -1e30
// under the causal offset sk - sq; padded query rows and keys give 0),
// dP = dO V^T, dS = P * (dP - delta) with delta = rowsum(dO * O) from the
// wrapper; dV = P^T dO and dK = scale * dS^T Q, each summed over the GQA
// group inside the block: no per-query-head intermediates.
//
// Layout: q, dO [b, sq, H, d]; k, v [b, sk, KVH, d]; lse, delta [b*H, sq];
// dk, dv [b, sk, KVH, d]; all fp32, every pointer 16-byte aligned.
//
// What bounds it: 8*d FLOPs per visible (q, k) pair and query head, far
// above the card's FLOP/byte ridge, so the product rate: 3xTF32 on the
// tensor cores. The design:
// - One block per (b, kv head, key tile), the key tiles in order so the
//   ones with the most causal query rows start first. It loops over the G
//   query heads of its group and, for each, the query tiles (64 rows; 32
//   at d 256) from the causal lower bound, as one flat sequence whose Q,
//   dO, lse and delta tiles go through a two-stage cp.async ring (the next
//   tile's copy in flight during this one's products); K and V are staged
//   once.
// - Two warps share 16 keys, each holding one accumulator of 16 keys x d
//   (64 registers at d 128, 128 at d 256; both would not fit in one
//   warp's 255 at d 256). The P warp computes S^T = K Q^T, then P^T =
//   exp(S^T * scale - lse) in its registers (lse indexed by column),
//   hands P^T to its partner through shared memory and accumulates dV +=
//   P^T dO; the dS warp computes dP^T = V dO^T, takes P^T, forms dS^T =
//   P^T (dP^T - delta) and accumulates dK += dS^T Q. Each product's
//   accumulator is, as it stands, the A fragment of the next
//   (tf32x3.cuh). 8 warps (64 keys) a block at d <= 128, 4 (32 keys) at
//   d 256, where the 264-float rows fill shared memory. A pair waits
//   only for itself between the two products (a named barrier).
// - The tensor core truncates as it adds into an accumulator, a bias that
//   grows with the adds: dK and dV take three for each 8 queries of a GQA
//   group (~3,000 at s 2048, G 4), which moved dV by 6.7e-4 against its
//   plain version there. So each warp restarts its accumulator every 512
//   queries and adds it into its output rows in fp32 (round to nearest),
//   by float4 reductions in L2 that return nothing to wait for; each
//   output element is one thread's, so nothing races and the sum is in
//   program order.
// - Row strides pad to d + 8 floats, which makes the fragment loads of
//   K, V and of the S^T / dP^T products conflict-free (the dV / dK
//   products' B loads are 2-way).
// - Causal: a pair skips a query tile that masks every one of its keys
//   (an exact skip: P = exp(-1e30 - lse) = 0), and only tiles that cross
//   the diagonal or a ragged end are masked element by element.

#include "common.cuh"
#include "tf32x3.cuh"

namespace {

using rtt::tf32x3::FragA;
using rtt::tf32x3::FragB;

template <int D>
struct Tiles {
  static constexpr int NW = D > 128 ? 4 : 8;   // warps a block: NW / 2 pairs
  static constexpr int NT = NW * 32;
  static constexpr int BKV = NW / 2 * 16;      // keys a block: 64 or 32
  static constexpr int BQ = D > 128 ? 32 : 64;  // query rows a tile
  static constexpr int S = D + 8;              // row stride, floats
  // K, V [BKV][S]; 2 stages of Q, dO [BQ][S] and lse, delta [BQ]; the P^T
  // hand-off [NW/2][BQ/8][32 lanes][4]: 226,304 bytes at d 128, 207,360
  // at d 256
  static constexpr int STAGE = 2 * BQ * S + 2 * BQ;
  static constexpr int SWAP = NW / 2 * 16 * BQ;
  static constexpr size_t smem_bytes =
      sizeof(float) * (2 * BKV * S + 2 * STAGE + SWAP);
  // query tiles between two adds of a warp's accumulator into the output
  // (512 queries: ~200 truncating adds into one accumulator)
  static constexpr int FLUSH = 512 / BQ;
};

template <int D>
__global__ void __launch_bounds__(Tiles<D>::NT, 1)
flash_bwd_dkv_tf32x3_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dk, float* __restrict__ dv,
                            int sq, int sk, int H, int KVH, int causal,
                            float scale) {
  using T = Tiles<D>;
  constexpr int NT = T::NT, BKV = T::BKV, BQ = T::BQ, S = T::S;
  constexpr int NN = BQ / 8;   // 8-query tiles of S^T and dP^T
  constexpr int NC = D / 16;   // 16-column groups of dK / dV
  constexpr int CH = D / 4;    // 16-byte chunks a row
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + BKV * S;
  float* ring = Vs + BKV * S;  // stage st: Q, dO, lse, delta
  float* swap = ring + 2 * T::STAGE;

  const int bkh = blockIdx.y;
  const int b = bkh / KVH;
  const int kh = bkh % KVH;
  const int G = H / KVH;
  const int k0 = blockIdx.x * BKV;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int pair = warp / 2;
  const bool p_warp = warp % 2 == 0;  // P and dV; else dS and dK
  const int kw = k0 + pair * 16;      // the pair's first key

  const long q_stride = static_cast<long>(H) * D;
  const long kv_stride = static_cast<long>(KVH) * D;
  const long kv_off = static_cast<long>(b) * sk * kv_stride + kh * D;

  const int offset = sk - sq;
  // first query tile with a row that sees key k0: q row >= k0 - offset
  const int first = causal ? k0 - offset : 0;
  const int qt_lo = first <= 0 ? 0 : first / BQ;
  const int per_head = max((sq + BQ - 1) / BQ - qt_lo, 0);
  const int n_it = G * per_head;

  // K and V rows of the block; rows past sk read as zeros
  for (int e = tid; e < BKV * CH; e += NT) {
    const int r = e / CH, c = (e % CH) * 4, kj = k0 + r;
    const bool in = kj < sk;
    const long off = kv_off + (in ? kj * kv_stride + c : 0);
    rtt::tf32x3::cp_async16(Ks + r * S + c, k + off, in);
    rtt::tf32x3::cp_async16(Vs + r * S + c, v + off, in);
  }
  // iteration it's Q, dO, lse and delta into ring stage it % 2
  auto load_q = [&](int it) {
    const int hh = kh * G + it / per_head;
    const int q0 = (qt_lo + it % per_head) * BQ;
    const long bh = static_cast<long>(b) * H + hh;
    const long q_off = static_cast<long>(b) * sq * q_stride + hh * D;
    float* Qs = ring + (it & 1) * T::STAGE;
    float* dOs = Qs + BQ * S;
    float* Ls = dOs + BQ * S;
    for (int e = tid; e < BQ * CH; e += NT) {
      const int r = e / CH, c = (e % CH) * 4, qi = q0 + r;
      const bool in = qi < sq;
      const long off = q_off + (in ? qi * q_stride + c : 0);
      rtt::tf32x3::cp_async16(Qs + r * S + c, q + off, in);
      rtt::tf32x3::cp_async16(dOs + r * S + c, dout + off, in);
    }
    if (tid < 2 * BQ) {
      const int r = tid % BQ, qi = q0 + r;
      const bool in = qi < sq;
      const float* src = (tid < BQ ? lse : delta) + (in ? bh * sq + qi : 0);
      rtt::tf32x3::cp_async4(Ls + tid, src, in);
    }
  };
  if (n_it > 0) load_q(0);
  rtt::tf32x3::cp_async_commit();  // with K and V

  // the warp's dV (P warp) or unscaled dK (dS warp): keys kw + g (c0/c1)
  // and + 8 (c2/c3); columns: tile 2c holds 16c + 4t and +2, tile 2c + 1
  // 16c + 4t + 1 and +3
  float acc[2 * NC][4];
#pragma unroll
  for (int n = 0; n < 2 * NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // The warp's output rows start at zero, stored before the loop; each
  // flush adds acc (dK scaled) into them and restarts it.
  float* out = (p_warp ? dv : dk) + kv_off + (kw + g) * kv_stride + 4 * t;
  const float f = p_warp ? 1.f : scale;
  auto for_rows = [&](auto&& fn) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (kw + g + 8 * r >= sk) continue;
#pragma unroll
      for (int c = 0; c < NC; ++c)
        fn(r, c, reinterpret_cast<float4*>(out + 8 * r * kv_stride + 16 * c));
    }
  };
  for_rows([&](int, int, float4* dst) {
    *dst = make_float4(0.f, 0.f, 0.f, 0.f);
  });
  auto flush = [&]() {
    for_rows([&](int r, int c, float4* dst) {
      atomicAdd(dst, make_float4(acc[2 * c][2 * r] * f,
                                 acc[2 * c + 1][2 * r] * f,
                                 acc[2 * c][2 * r + 1] * f,
                                 acc[2 * c + 1][2 * r + 1] * f));
    });
#pragma unroll
    for (int n = 0; n < 2 * NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  };

  // the first product's A rows (K or V) and the pair's hand-off slots
  const float* Aw = (p_warp ? Ks : Vs) + (kw - k0 + g) * S + 2 * t;
  float4* hand = reinterpret_cast<float4*>(swap) + pair * NN * 32 + lane;

  for (int it = 0; it < n_it; ++it) {
    rtt::tf32x3::cp_async_wait<0>();
    // stage it % 2 visible to every warp, and every warp done with
    // iteration it - 1 (its stage and the hand-off slots free again)
    __syncthreads();
    if (it + 1 < n_it) load_q(it + 1);
    rtt::tf32x3::cp_async_commit();
    const int q0 = (qt_lo + it % per_head) * BQ;
    const float* Qs = ring + (it & 1) * T::STAGE;
    const float* dOs = Qs + BQ * S;
    const float* Ls = dOs + BQ * S;  // lse [BQ], then delta [BQ]
    // every key of the pair masked for every row of the tile
    const bool skip =
        causal && offset + q0 >= 0 && offset + q0 + BQ - 1 < kw;
    const bool masked = q0 + BQ > sq || kw + 16 > sk ||
                        (causal && offset + q0 < kw + 15);

    // S^T (P warp) or dP^T (dS warp): keys x queries
    float x[NN][4];
#pragma unroll
    for (int j = 0; j < NN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
    if (!skip) {
      const float* Bt = (p_warp ? Qs : dOs) + g * S + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D; kk += 8) {
        const FragA a = rtt::tf32x3::load_a(Aw + kk, S);
#pragma unroll
        for (int j = 0; j < NN; ++j)
          rtt::tf32x3::mma3(x[j], a,
                            rtt::tf32x3::load_bt(Bt + j * 8 * S + kk));
      }
      if (p_warp) {
        // P^T: key kw + g + 8*(e >> 1), query q0 + 8j + 2t + (e & 1).
        // __expf (ex2.approx of x log2(e)): within ~1e-6 relative at these
        // arguments, and the dS warp waits for these exponentials

#pragma unroll
        for (int j = 0; j < NN; ++j) {
          const float2 lj =
              *reinterpret_cast<const float2*>(Ls + 8 * j + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float lse_q = (e & 1) ? lj.y : lj.x;
            float y = x[j][e] * scale;
            if (masked) {
              const int qi = q0 + 8 * j + 2 * t + (e & 1);
              const int kj = kw + g + 8 * (e >> 1);
              if (causal && offset + qi < kj) y = rtt::kNegInf;
              x[j][e] = (qi < sq && kj < sk) ? __expf(y - lse_q) : 0.f;
            } else {
              x[j][e] = __expf(y - lse_q);
            }
          }
          hand[j * 32] = make_float4(x[j][0], x[j][1], x[j][2], x[j][3]);
        }
      }
    }
    // P^T handed over: the pair's own barrier (ids 1-4; 0 is the block's)
    asm volatile("bar.sync %0, 64;\n" ::"r"(1 + pair) : "memory");
    if (!skip) {
      if (!p_warp) {
        // dS^T = P^T (dP^T - delta), delta indexed by column
#pragma unroll
        for (int j = 0; j < NN; ++j) {
          const float2 dj =
              *reinterpret_cast<const float2*>(Ls + BQ + 8 * j + 2 * t);
          const float4 p = hand[j * 32];
          x[j][0] = p.x * (x[j][0] - dj.x);
          x[j][1] = p.y * (x[j][1] - dj.y);
          x[j][2] = p.z * (x[j][2] - dj.x);
          x[j][3] = p.w * (x[j][3] - dj.y);
        }
      }
      // dV += P^T dO (P warp), dK += dS^T Q (dS warp): 8-query step j is
      // tile j of x; dO or Q rows 8j + 2t and 8j + 2t + 1
      const float* Br = (p_warp ? dOs : Qs) + 2 * t * S + 2 * g;
#pragma unroll
      for (int j = 0; j < NN; ++j) {
        const FragA a = rtt::tf32x3::acc_to_a(x[j]);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          FragB be, bo;
          rtt::tf32x3::load_b_pair(Br + 8 * j * S + 16 * c, S, be, bo);
          rtt::tf32x3::mma3(acc[2 * c], a, be);
          rtt::tf32x3::mma3(acc[2 * c + 1], a, bo);
        }
      }
    }
    if ((it + 1) % T::FLUSH == 0) flush();
  }
  if (n_it % T::FLUSH) flush();
  rtt::tf32x3::cp_async_wait<0>();  // K and V, when no query tile came
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, int b, int sq, int sk, int H, int KVH,
                   int causal, float scale, cudaStream_t stream) {
  using T = Tiles<D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_tf32x3_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(T::smem_bytes));
  if (err != cudaSuccess) return err;
  dim3 grid((sk + T::BKV - 1) / T::BKV, b * KVH);
  flash_bwd_dkv_tf32x3_kernel<D><<<grid, T::NT, T::smem_bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), sq, sk, H, KVH,
      causal, scale);
  return cudaGetLastError();
}

}  // namespace

// fp32 at d 16, 32, 64, 128 or 256.
extern "C" int rtt_flash_bwd_dkv_tf32x3(const void* q, const void* k,
                                        const void* v, const void* dout,
                                        const void* lse, const void* delta,
                                        void* dk, void* dv, int b, int sq,
                                        int sk, int H, int KVH, int d,
                                        int causal, float scale,
                                        void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || KVH <= 0 || H % KVH != 0 ||
      b * KVH > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16:
      return static_cast<int>(launch<16>(q, k, v, dout, lse, delta, dk, dv,
                                         b, sq, sk, H, KVH, causal, scale,
                                         st));
    case 32:
      return static_cast<int>(launch<32>(q, k, v, dout, lse, delta, dk, dv,
                                         b, sq, sk, H, KVH, causal, scale,
                                         st));
    case 64:
      return static_cast<int>(launch<64>(q, k, v, dout, lse, delta, dk, dv,
                                         b, sq, sk, H, KVH, causal, scale,
                                         st));
    case 128:
      return static_cast<int>(launch<128>(q, k, v, dout, lse, delta, dk, dv,
                                          b, sq, sk, H, KVH, causal, scale,
                                          st));
    case 256:
      return static_cast<int>(launch<256>(q, k, v, dout, lse, delta, dk, dv,
                                          b, sq, sk, H, KVH, causal, scale,
                                          st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
