// Flash-attention dQ backward for Hopper (sm_90a) on fp32 inputs, on the
// tensor cores in 3xTF32 (tf32x3.cuh): head dim 16, 32, 64, 128 and 256.
//
// Replaces: ray_tpu/ops/attention.py::_flash_bwd_dq_kernel (pallas_call
// at attention.py:346) on the fp32 path. Same function and contract as
// the scalar kernel's rtt_flash_bwd_dq: P = exp(S*scale - lse) recomputed
// tile by tile from the forward's row logsumexp (masked scores at -1e30
// under the causal offset sk - sq; keys past sk give 0), dP = dO V^T,
// dS = P * (dP - delta) with delta = rowsum(dO * O) from the wrapper, and
// dQ = scale * dS K; query head h reads kv head h / (H / KVH).
//
// Layout: q, dO, dq [b, sq, H, d]; k, v [b, sk, KVH, d] (read in place
// through row strides); lse, delta [b*H, sq]; all fp32, every pointer
// 16-byte aligned.
//
// What bounds it: 6*d FLOPs per visible (q, k) pair and query head (S,
// dP and dS K) against a few bytes a pair, far above the card's FLOP/byte
// ridge, so the product rate: 3xTF32 on the tensor cores (3 TF32 FLOPs an
// fp32 one at 495 TFLOP/s), not the 67 TFLOP/s of fp32 FMAs. The design:
// - One block per (b*H, 64 query rows), the query tiles of a head in
//   reverse so that the longest causal rows start first. Each warp owns
//   16 rows and keeps in its registers their lse and delta, S and dP of
//   the current key tile (mma.sync m16n8k8 accumulators) and its dQ
//   accumulator. dS = P * (dP - delta) is formed in place in S's
//   registers, which are, as they stand, the A fragment of dQ += dS K
//   (tf32x3.cuh): neither P nor dS touches shared memory.
// - Q (scaled, as the forward stages it) and dO are staged once; K/V
//   tiles of BK keys go through a two-stage cp.async ring, the next
//   tile's copy in flight during this tile's products, one barrier a
//   tile. BK is 64 at d <= 32, 32 at d 64 and 16 above: S and dP take BK
//   registers a thread together (64 of them at d 64 spilled beside dQ's
//   32), and at d 128 16-key tiles keep the block at 104,448 bytes of
//   shared memory (Q, dO 2 x 64 x 136 floats, K, V 2 stages x 2 x 16 x
//   136), two blocks an SM; 32-key tiles (139,264 bytes) would leave
//   one, a warp a scheduler.
// - K is read two ways: as B^T at rows g for S (load_bt) and as B at
//   rows 2t, 2t + 1 for dS K (load_b_pair). A row stride of d + 8 floats
//   makes the first conflict-free and the second 2-way; d + 4 the reverse.
//   Both products load the same number of K fragments a tile, so neither
//   stride wins on count; d + 8 is the conflict-free stride of Q, dO and
//   V (all read at rows g), and one stride serves the four tiles.
// - At d 256 a warp's dQ alone would take 128 registers. There 8 warps
//   share the 16-row groups in pairs, as in flash_fwd_tf32x3.cu: each sums
//   S and dP over half of d, the pair adds the two halves through shared
//   memory behind a barrier of its own, both form the same dS, and each
//   owns half of dQ's columns. Q and dO at 64 rows x 264 floats take
//   135,168 bytes, so the K/V ring takes 16-key tiles (67,584 bytes) and
//   the halves' swap 16,384: 219,136 bytes against the 232,448 a block may
//   take (32-key tiles would need 286,720).
// - The tensor core truncates as it adds into an accumulator, a bias that
//   grows with the adds: dQ takes three for each 8 keys (768 at s 2048).
//   So each warp restarts its accumulator every 512 keys (192 adds) and
//   adds it, scaled, into its dQ rows in fp32 (round to nearest): each dQ
//   element is one thread's for the block's life, so a plain load, add
//   and store keeps program order and needs no atomics.
// - Causal: the loop stops at the block's causal bound; only tiles that
//   cross a warp's diagonal (or the ragged end of the keys) are masked
//   element by element, and a warp skips a tile that masks every one of
//   its rows (an exact skip: P = exp(-1e30 - lse) = 0). Keys past sk are
//   zero-filled by the copies and give P = 0.

#include "common.cuh"
#include "tf32x3.cuh"

namespace {

using rtt::tf32x3::FragA;
using rtt::tf32x3::FragB;

template <int D>
struct Tiles {
  // at d 256 two warps share a row group, each holding half of dQ's
  // columns (and summing half of S's and dP's reduction); else one warp
  // a group
  static constexpr bool kSplit = D > 128;
  static constexpr int NW = kSplit ? 8 : 4;      // warps a block
  static constexpr int NT = NW * 32;
  static constexpr int BQ = 64;                  // query rows a block
  static constexpr int DW = kSplit ? D / 2 : D;  // dQ columns a warp
  static constexpr int BK = D <= 32 ? 64 : D == 64 ? 32 : 16;  // K/V keys
  static constexpr int NN = BK / 8;              // 8-key tiles of S, dP
  static constexpr int S = D + 8;                // row stride, floats
  // Q, dO [BQ][S] + K, V [2][BK][S] (+ at d 256 the swap of the partial
  // S and dP [NW][2][NN][32 lanes][4])
  static constexpr int SWAP = kSplit ? NW * 2 * NN * 32 * 4 : 0;
  static constexpr size_t smem_bytes =
      sizeof(float) * (2 * BQ * S + 4 * BK * S + SWAP);
  // key tiles between two adds of the accumulator into dQ (512 keys)
  static constexpr int FLUSH = 512 / BK;
};

template <int D>
__global__ void __launch_bounds__(Tiles<D>::NT)
flash_bwd_dq_tf32x3_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dq, int sq, int sk, int H,
                           int KVH, int causal, float scale) {
  using T = Tiles<D>;
  constexpr int NT = T::NT, BQ = T::BQ, BK = T::BK, NN = T::NN, S = T::S;
  constexpr int NC = T::DW / 16;   // 16-column groups of the warp's dQ
  constexpr int CH = D / 4;        // 16-byte chunks a row
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * S;
  float* Ks = dOs + BQ * S;
  float* Vs = Ks + 2 * BK * S;
  float* swap = Vs + 2 * BK * S;

  const int n_qt = (sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int hh = bh % H;
  const int kh = hh / (H / KVH);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int grp = T::kSplit ? warp / 2 : warp;        // the warp's rows
  const int col0 = T::kSplit ? warp % 2 * T::DW : 0;  // and its columns
  const int r0 = grp * 16;  // the warp's first row in the tile

  const long q_stride = static_cast<long>(H) * D;
  const long kv_stride = static_cast<long>(KVH) * D;
  const long q_off = static_cast<long>(b) * sq * q_stride + hh * D;
  const float* kb = k + static_cast<long>(b) * sk * kv_stride + kh * D;
  const float* vb = v + static_cast<long>(b) * sk * kv_stride + kh * D;

  const int offset = sk - sq;  // query row i sits at key position offset+i
  int n_kt = (sk + BK - 1) / BK;
  if (causal) {
    const int last_q = offset + min(q0 + BQ, sq) - 1;
    n_kt = min(n_kt, last_q < 0 ? 0 : last_q / BK + 1);
  }

  // K/V tile kt into ring stage st; rows past sk read as zeros
  auto load_kv = [&](int kt, int st) {
    for (int e = tid; e < BK * CH; e += NT) {
      const int r = e / CH, c = (e % CH) * 4, kj = kt * BK + r;
      const bool in = kj < sk;
      const long off = in ? kj * kv_stride + c : 0;
      rtt::tf32x3::cp_async16(Ks + (st * BK + r) * S + c, kb + off, in);
      rtt::tf32x3::cp_async16(Vs + (st * BK + r) * S + c, vb + off, in);
    }
    rtt::tf32x3::cp_async_commit();
  };

  if (n_kt > 0) load_kv(0, 0);
  // Q scaled and dO; rows past sq read as zeros (their dS is then 0)
  for (int e = tid; e < BQ * CH; e += NT) {
    const int r = e / CH, c = (e % CH) * 4, qi = q0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
    if (qi < sq) {
      const long off = q_off + qi * q_stride + c;
      x = *reinterpret_cast<const float4*>(q + off);
      y = *reinterpret_cast<const float4*>(dout + off);
    }
    x.x *= scale;
    x.y *= scale;
    x.z *= scale;
    x.w *= scale;
    *reinterpret_cast<float4*>(Qs + r * S + c) = x;
    *reinterpret_cast<float4*>(dOs + r * S + c) = y;
  }
  // lse and delta of the warp's rows g (c0/c1) and g + 8 (c2/c3)
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r0 + g + 8 * r;
    const long i = static_cast<long>(bh) * sq + qi;
    lse_r[r] = qi < sq ? lse[i] : 0.f;
    delta_r[r] = qi < sq ? delta[i] : 0.f;
  }

  // dQ columns: tile 2c holds col0 + 16c + 4t and +2, tile 2c + 1 +1 and
  // +3 (rows g and g + 8: c0/c1 and c2/c3)
  float acc[2 * NC][4];
#pragma unroll
  for (int n = 0; n < 2 * NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // Adds scale * acc into the warp's dQ rows (stores it, the first time)
  // and restarts acc.
  float* dqw = dq + q_off + col0 + 4 * t;
  auto flush = [&](bool first) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q0 + r0 + g + 8 * r;
      if (qi >= sq) continue;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float4* dst = reinterpret_cast<float4*>(dqw + qi * q_stride + 16 * c);
        float4 x = make_float4(
            acc[2 * c][2 * r] * scale, acc[2 * c + 1][2 * r] * scale,
            acc[2 * c][2 * r + 1] * scale, acc[2 * c + 1][2 * r + 1] * scale);
        if (!first) {
          const float4 y = *dst;
          x.x += y.x;
          x.y += y.y;
          x.z += y.z;
          x.w += y.w;
        }
        *dst = x;
      }
    }
#pragma unroll
    for (int n = 0; n < 2 * NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  };

  const float* Qw = Qs + (r0 + g) * S + 2 * t + col0;
  const float* dOw = dOs + (r0 + g) * S + 2 * t + col0;
  const int row_lo = offset + q0 + r0;  // the warp's first key position

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1;
    rtt::tf32x3::cp_async_wait<0>();
    // tile kt (and Q, dO) visible to every warp, and every warp done with
    // tile kt - 1: its stage takes tile kt + 1's copy during this tile
    __syncthreads();
    if (kt + 1 < n_kt) load_kv(kt + 1, st ^ 1);
    const int k0 = kt * BK;
    const bool skip = causal && row_lo >= 0 && row_lo + 15 < k0;
    if (!skip) {
      float s[NN][4], dp[NN][4];
#pragma unroll
      for (int j = 0; j < NN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      // S = Q K^T and dP = dO V^T over the warp's share of d: all of it,
      // or (d 256) half
      const float* Kt = Ks + (st * BK + g) * S + 2 * t + col0;
      const float* Vt = Vs + (st * BK + g) * S + 2 * t + col0;
#pragma unroll
      for (int kk = 0; kk < T::DW; kk += 8) {
        const FragA a = rtt::tf32x3::load_a(Qw + kk, S);
#pragma unroll
        for (int j = 0; j < NN; ++j)
          rtt::tf32x3::mma3(s[j], a,
                            rtt::tf32x3::load_bt(Kt + j * 8 * S + kk));
        const FragA ad = rtt::tf32x3::load_a(dOw + kk, S);
#pragma unroll
        for (int j = 0; j < NN; ++j)
          rtt::tf32x3::mma3(dp[j], ad,
                            rtt::tf32x3::load_bt(Vt + j * 8 * S + kk));
      }
      if constexpr (T::kSplit) {
        // the two warps of the group add each other's halves: the same S
        // and dP in both (a + b == b + a), then the same dS
        float4* mine = reinterpret_cast<float4*>(swap) + warp * 2 * NN * 32;
        const float4* theirs =
            reinterpret_cast<const float4*>(swap) + (warp ^ 1) * 2 * NN * 32;
#pragma unroll
        for (int j = 0; j < NN; ++j) {
          mine[j * 32 + lane] = make_float4(s[j][0], s[j][1], s[j][2],
                                            s[j][3]);
          mine[(NN + j) * 32 + lane] = make_float4(dp[j][0], dp[j][1],
                                                   dp[j][2], dp[j][3]);
        }
        // the pair's own barrier (ids 1-4; __syncthreads is 0)
        asm volatile("bar.sync %0, 64;\n" ::"r"(1 + grp) : "memory");
#pragma unroll
        for (int j = 0; j < NN; ++j) {
          const float4 y = theirs[j * 32 + lane];
          const float4 z = theirs[(NN + j) * 32 + lane];
          s[j][0] += y.x;
          s[j][1] += y.y;
          s[j][2] += y.z;
          s[j][3] += y.w;
          dp[j][0] += z.x;
          dp[j][1] += z.y;
          dp[j][2] += z.z;
          dp[j][3] += z.w;
        }
      }
      // P = exp(S - lse), then dS = P * (dP - delta) in S's registers:
      // element e of tile j is row g + 8 * (e >> 1), key k0 + 8j + 2t +
      // (e & 1). __expf (ex2.approx of x log2(e)): within ~1e-6 relative
      // at these arguments, several times cheaper than expf
      const bool edge = k0 + BK > sk || (causal && row_lo < k0 + BK - 1);
#pragma unroll
      for (int j = 0; j < NN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float p;
          if (edge) {
            const int kj = k0 + 8 * j + 2 * t + (e & 1);
            const float x = causal && row_lo + g + 8 * r < kj
                                ? rtt::kNegInf  // masked like the reference
                                : s[j][e];
            p = kj < sk ? __expf(x - lse_r[r]) : 0.f;
          } else {
            p = __expf(s[j][e] - lse_r[r]);
          }
          s[j][e] = p * (dp[j][e] - delta_r[r]);
        }
      // dQ += dS K: 8-key step j is dS's tile j; K rows 8j + 2t and
      // 8j + 2t + 1, the warp's columns
      const float* Kb = Ks + (st * BK + 2 * t) * S + 2 * g + col0;
#pragma unroll
      for (int j = 0; j < NN; ++j) {
        const FragA a = rtt::tf32x3::acc_to_a(s[j]);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          FragB be, bo;
          rtt::tf32x3::load_b_pair(Kb + 8 * j * S + 16 * c, S, be, bo);
          rtt::tf32x3::mma3(acc[2 * c], a, be);
          rtt::tf32x3::mma3(acc[2 * c + 1], a, bo);
        }
      }
    }
    if ((kt + 1) % T::FLUSH == 0) flush(kt + 1 == T::FLUSH);
  }
  // the rest of the keys; rows that saw no tile get zeros
  if (n_kt % T::FLUSH || n_kt == 0) flush(n_kt < T::FLUSH);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int b, int sq, int sk, int H, int KVH,
                   int causal, float scale, cudaStream_t stream) {
  using T = Tiles<D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_tf32x3_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(T::smem_bytes));
  if (err != cudaSuccess) return err;
  dim3 grid((sq + T::BQ - 1) / T::BQ, b * H);
  flash_bwd_dq_tf32x3_kernel<D><<<grid, T::NT, T::smem_bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), sq, sk, H, KVH, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// fp32 at d 16, 32, 64, 128 or 256.
extern "C" int rtt_flash_bwd_dq_tf32x3(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dq, int b, int sq, int sk, int H,
                                       int KVH, int d, int causal,
                                       float scale, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || KVH <= 0 || H % KVH != 0 ||
      b * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16:
      return static_cast<int>(launch<16>(q, k, v, dout, lse, delta, dq, b,
                                         sq, sk, H, KVH, causal, scale, st));
    case 32:
      return static_cast<int>(launch<32>(q, k, v, dout, lse, delta, dq, b,
                                         sq, sk, H, KVH, causal, scale, st));
    case 64:
      return static_cast<int>(launch<64>(q, k, v, dout, lse, delta, dq, b,
                                         sq, sk, H, KVH, causal, scale, st));
    case 128:
      return static_cast<int>(launch<128>(q, k, v, dout, lse, delta, dq, b,
                                          sq, sk, H, KVH, causal, scale, st));
    case 256:
      return static_cast<int>(launch<256>(q, k, v, dout, lse, delta, dq, b,
                                          sq, sk, H, KVH, causal, scale, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
