// Flash-attention forward for Hopper (sm_90a) on fp32 inputs, on the
// tensor cores in 3xTF32 (tf32x3.cuh): head dim 16, 32, 64, 128 and 256.
//
// Replaces: ray_tpu/ops/attention.py::_flash_kernel (launched by
// _flash_forward, pallas_call at attention.py:178) on the fp32 path.
// Same function and contract as the scalar kernel's rtt_flash_fwd:
// blocked causal or non-causal attention with an fp32 online softmax, the
// scale applied to q, the causal mask offset by sk - sq (masked scores at
// -1e30, keys past sk excluded), GQA head h reading kv head h / (H / KVH),
// O in fp32 and the row logsumexp lse = m + log(max(l, 1e-30)) that the
// backward kernels consume.
//
// Layout: q [b, sq, H, d], k/v [b, sk, KVH, d] (read in place through row
// strides), o [b, sq, H, d], lse [b*H, sq]; every pointer 16-byte aligned.
//
// What bounds it: at the serving shapes (b 8, s 512) the work is
// 4*b*H*(visible pairs)*d FLOPs against a few bytes a pair, far above the
// card's FLOP/byte ridge, so the bound is the product rate. At fp32
// accuracy that is 3xTF32 on the tensor cores (3 TF32 FLOPs an fp32 one
// at 495 TFLOP/s), not the 67 TFLOP/s of fp32 FMAs. The design:
// - One block per (b*H, 64 query rows), the query tiles of a head in
//   reverse so that the longest causal rows start first; 4 warps, each
//   owning 16 rows: S = Q K^T, the online softmax (m, l) and the O
//   accumulator stay in its registers (mma.sync m16n8k8 fragments), and
//   S's accumulator is P's A fragment for P V as it stands (tf32x3.cuh),
//   so P never touches shared memory.
// - At d 256 a warp's O alone would take 128 registers and Q 67 KB of
//   shared memory, leaving one block of 4 warps an SM, too few to hide the
//   latencies. There 8 warps share the 16-row groups in pairs: each sums
//   S over half of d and owns half of O's columns, and the pair adds the
//   two halves of S through shared memory (a barrier of its own) before
//   the softmax, which both run on the same S.
// - Q, scaled, is staged once; K/V tiles of BK keys (64 at d <= 64, else
//   32) go through a two-stage cp.async ring, the next tile's copy in
//   flight during this tile's products.
// - Operands are split into TF32 halves at fragment load, not at staging:
//   a staged split would double the tiles' shared memory (at d 128 from
//   103 KB, two blocks an SM, to 206 KB, one) and the bytes of every
//   fragment load, while the split costs three operations a loaded value
//   (tf32x3.cuh) against three tensor-core products a fragment.
// - Row strides pad to d + 8 floats for Q and K (fragment rows g: eight
//   rows at 32-byte offsets, conflict-free 8-byte loads) and d + 4 for V
//   (rows 2t and 2t + 1), the bank-conflict-free strides of each pattern.
// - Causal: the loop stops at the block's causal bound (as the scalar
//   kernel did); only tiles that cross a warp's diagonal (or the ragged
//   end of the keys) are masked, and a warp skips a tile that every one of
//   its rows masks whole (an exact skip: those rows saw key 0 already, so
//   the masked scores add exp(-1e30 - m) = 0).

#include "common.cuh"
#include "tf32x3.cuh"

namespace {

using rtt::tf32x3::FragA;
using rtt::tf32x3::FragB;

constexpr int BQ = 64;  // query rows a block: 4 row groups of 16

template <int D>
struct Tiles {
  // at d 256 two warps share a row group, each holding half of O's
  // columns (and summing half of S's reduction); else one warp a group
  static constexpr bool kSplit = D > 128;
  static constexpr int NW = kSplit ? 8 : 4;     // warps a block
  static constexpr int NT = NW * 32;
  static constexpr int DW = kSplit ? D / 2 : D;  // O columns a warp
  static constexpr int BK = D <= 64 ? 64 : 32;  // keys a K/V tile
  static constexpr int QS = D + 8;              // row strides, floats
  static constexpr int KS = D + 8;
  static constexpr int VS = D + 4;
  // Q [BQ][QS] + K [2][BK][KS] + V [2][BK][VS] (+ at d 256 the partial S
  // swap [NW][BK/8][32 lanes][4]): 103,424 bytes at d 128 (two blocks an
  // SM), 218,112 at d 256
  static constexpr int SWAP = kSplit ? NW * BK * 16 : 0;
  static constexpr size_t smem_bytes =
      sizeof(float) * (BQ * QS + 2 * BK * (KS + VS) + SWAP);
};

template <int D>
__global__ void __launch_bounds__(Tiles<D>::NT, 1)
flash_fwd_tf32x3_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        float* __restrict__ lse, int sq, int sk, int H,
                        int KVH, int causal, float scale) {
  using T = Tiles<D>;
  constexpr int NT = T::NT, BK = T::BK, QS = T::QS, KS = T::KS, VS = T::VS;
  constexpr int NN = BK / 8;       // 8-key tiles of S
  constexpr int NC = T::DW / 16;   // 16-column groups of the warp's O
  constexpr int CH = D / 4;        // 16-byte chunks a row
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * QS;
  float* Vs = Ks + 2 * BK * KS;
  float* swap = Vs + 2 * BK * VS;

  const int n_qt = (sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int hh = bh % H;
  const int kh = hh / (H / KVH);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int grp = T::kSplit ? warp / 2 : warp;  // the warp's row group
  const int col0 = T::kSplit ? warp % 2 * T::DW : 0;  // and its columns
  const int r0 = grp * 16;  // the warp's first row in the tile

  const long q_stride = static_cast<long>(H) * D;
  const long kv_stride = static_cast<long>(KVH) * D;
  const float* qb = q + static_cast<long>(b) * sq * q_stride + hh * D;
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
      rtt::tf32x3::cp_async16(Ks + (st * BK + r) * KS + c, kb + off, in);
      rtt::tf32x3::cp_async16(Vs + (st * BK + r) * VS + c, vb + off, in);
    }
    rtt::tf32x3::cp_async_commit();
  };

  if (n_kt > 0) load_kv(0, 0);
  for (int e = tid; e < BQ * CH; e += NT) {
    const int r = e / CH, c = (e % CH) * 4, qi = q0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (qi < sq) x = *reinterpret_cast<const float4*>(qb + qi * q_stride + c);
    x.x *= scale;
    x.y *= scale;
    x.z *= scale;
    x.w *= scale;
    *reinterpret_cast<float4*>(Qs + r * QS + c) = x;
  }

  // O columns: tile 2c holds 16c + 4t and +2, tile 2c + 1 16c + 4t + 1
  // and +3 (rows g and g + 8: c0/c1 and c2/c3)
  float acc[2 * NC][4];
#pragma unroll
  for (int n = 0; n < 2 * NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_r[2] = {rtt::kNegInf, rtt::kNegInf};  // rows g, g + 8
  float l_r[2] = {0.f, 0.f};

  const float* Qw = Qs + (r0 + g) * QS + 2 * t + col0;
  const int row_lo = offset + q0 + r0;  // the warp's first key position

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1;
    rtt::tf32x3::cp_async_wait<0>();
    // tile kt (and Q) visible to every warp, and every warp done with
    // tile kt - 1: its stage takes tile kt + 1's copy during this tile
    __syncthreads();
    if (kt + 1 < n_kt) load_kv(kt + 1, st ^ 1);
    const int k0 = kt * BK;
    const bool skip = causal && row_lo >= 0 && row_lo + 15 < k0;
    if (!skip) {
      float s[NN][4];
#pragma unroll
      for (int j = 0; j < NN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      // S over the warp's share of d: all of it, or (d 256) half
      const float* Kt = Ks + (st * BK + g) * KS + 2 * t + col0;
#pragma unroll
      for (int kk = 0; kk < T::DW; kk += 8) {
        const FragA a = rtt::tf32x3::load_a(Qw + kk, QS);
#pragma unroll
        for (int j = 0; j < NN; ++j) {
          const FragB bf = rtt::tf32x3::load_bt(Kt + j * 8 * KS + kk);
          rtt::tf32x3::mma3(s[j], a, bf);
        }
      }
      if constexpr (T::kSplit) {
        // the two warps of the group add each other's half: the same S in
        // both (a + b == b + a), then the same softmax
        float4* mine = reinterpret_cast<float4*>(swap) + warp * NN * 32;
        const float4* theirs =
            reinterpret_cast<const float4*>(swap) + (warp ^ 1) * NN * 32;
#pragma unroll
        for (int j = 0; j < NN; ++j)
          mine[j * 32 + lane] = make_float4(s[j][0], s[j][1], s[j][2],
                                            s[j][3]);
        // the pair's own barrier (ids 1-4; __syncthreads is 0)
        asm volatile("bar.sync %0, 64;\n" ::"r"(1 + grp) : "memory");
#pragma unroll
        for (int j = 0; j < NN; ++j) {
          const float4 y = theirs[j * 32 + lane];
          s[j][0] += y.x;
          s[j][1] += y.y;
          s[j][2] += y.z;
          s[j][3] += y.w;
        }
      }
      if (k0 + BK > sk || (causal && row_lo < k0 + BK - 1)) {
#pragma unroll
        for (int j = 0; j < NN; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kj = k0 + 8 * j + 2 * t + (e & 1);
            const int qpos = row_lo + g + 8 * (e >> 1);
            if (kj >= sk)
              s[j][e] = -__int_as_float(0x7f800000);  // past the keys: -inf
            else if (causal && qpos < kj)
              s[j][e] = rtt::kNegInf;  // masked like the reference
          }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = rtt::kNegInf;
#pragma unroll
        for (int j = 0; j < NN; ++j)
          mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        mx = rtt::group_max<4>(mx);
        const float m_new = fmaxf(m_r[r], mx);
        // __expf (ex2.approx of x log2(e)): within ~1e-6 relative at
        // these arguments, several times cheaper than expf
        const float alpha = __expf(m_r[r] - m_new);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < NN; ++j)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            s[j][e] = __expf(s[j][e] - m_new);
            rs += s[j][e];
          }
        rs = rtt::group_sum<4>(rs);
        l_r[r] = l_r[r] * alpha + rs;
        m_r[r] = m_new;
#pragma unroll
        for (int n = 0; n < 2 * NC; ++n) {
          acc[n][2 * r] *= alpha;
          acc[n][2 * r + 1] *= alpha;
        }
      }
      // O += P V: 8-key step j is S's tile j; V rows 8j + 2t, 8j + 2t + 1
      const float* Vt = Vs + (st * BK + 2 * t) * VS + 2 * g + col0;
#pragma unroll
      for (int j = 0; j < NN; ++j) {
        const FragA a = rtt::tf32x3::acc_to_a(s[j]);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          FragB be, bo;
          rtt::tf32x3::load_b_pair(Vt + 8 * j * VS + 16 * c, VS, be, bo);
          rtt::tf32x3::mma3(acc[2 * c], a, be);
          rtt::tf32x3::mma3(acc[2 * c + 1], a, bo);
        }
      }
    }
  }

  float* ob = o + static_cast<long>(b) * sq * q_stride + hh * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r0 + g + 8 * r;
    if (qi >= sq) continue;
    const float l_safe = fmaxf(l_r[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float4 out = make_float4(
          acc[2 * c][2 * r] / l_safe, acc[2 * c + 1][2 * r] / l_safe,
          acc[2 * c][2 * r + 1] / l_safe, acc[2 * c + 1][2 * r + 1] / l_safe);
      *reinterpret_cast<float4*>(ob + qi * q_stride + col0 + 16 * c + 4 * t) =
          out;
    }
    if (t == 0 && col0 == 0)
      lse[static_cast<long>(bh) * sq + qi] = m_r[r] + logf(l_safe);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int b, int sq, int sk, int H, int KVH,
                   int causal, float scale, cudaStream_t stream) {
  const size_t smem = Tiles<D>::smem_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tf32x3_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((sq + BQ - 1) / BQ, b * H);
  flash_fwd_tf32x3_kernel<D><<<grid, Tiles<D>::NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), sq, sk, H, KVH, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// fp32 at d 16, 32, 64, 128 or 256.
extern "C" int rtt_flash_fwd_tf32x3(const void* q, const void* k,
                                    const void* v, void* o, void* lse, int b,
                                    int sq, int sk, int H, int KVH, int d,
                                    int causal, float scale, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || KVH <= 0 || H % KVH != 0 ||
      b * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16:
      return static_cast<int>(launch<16>(q, k, v, o, lse, b, sq, sk, H, KVH,
                                         causal, scale, st));
    case 32:
      return static_cast<int>(launch<32>(q, k, v, o, lse, b, sq, sk, H, KVH,
                                         causal, scale, st));
    case 64:
      return static_cast<int>(launch<64>(q, k, v, o, lse, b, sq, sk, H, KVH,
                                         causal, scale, st));
    case 128:
      return static_cast<int>(launch<128>(q, k, v, o, lse, b, sq, sk, H,
                                          KVH, causal, scale, st));
    case 256:
      return static_cast<int>(launch<256>(q, k, v, o, lse, b, sq, sk, H,
                                          KVH, causal, scale, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
