// Flash-attention dK/dV backward for Hopper (sm_90a) at head dim 256, bf16
// inputs: wgmma on bf16 tiles that TMA loads into shared memory behind
// mbarriers.
//
// Replaces: ray_tpu/ops/attention.py::_flash_bwd_dkv_kernel (pallas_call
// at attention.py:368), on the bf16 path at Gemma's head dim 256; head dims
// 64 and 128 take flash_bwd_dkv_sm90.cu, fp32 the scalar kernel of
// flash_bwd.cu. Same function: P = exp(S*scale - lse) recomputed tile by
// tile from the forward's fp32 row logsumexp (masked under the causal
// offset sk - sq), dS = P * (dO V^T - delta) with delta = rowsum(dO * O)
// from the wrapper, dV = P^T dO and dK = scale * dS^T Q, summed over the G
// query heads of each kv head's GQA group.
//
// Layout: q, dO [b, sq, H, 256]; k, v [b, sk, KVH, 256], read in place
// through 4-D TMA maps; lse, delta [b*H, sq] fp32; dk, dv [b, sk, KVH, 256]
// bf16.
//
// Precision, as flash_bwd_dkv_sm90.cu: S^T = K Q^T and dP^T = V dO^T
// accumulate in fp32 from bf16; the scale is applied to S^T in fp32
// (folded with log2 e into an exp2); P^T and dS^T are rounded to bf16 as
// the A operands of dV += P^T dO and dK += dS^T Q, which accumulate in
// fp32.
//
// What bounds it: 8*256 FLOPs per visible (q, k) pair and query head
// against ~b*s*(2H + 4KVH)*256*2 bytes: the bf16 tensor-core rate. The
// d-128 kernel gives each consumer warpgroup its own 64 keys and both
// 64 x d fp32 accumulators, 256 registers a thread at d 256, over the
// 240 that setmaxnreg can give. So here the two consumers split d instead:
// - One block per (b, kv head, 64 keys); K and V (2 x 32 KB) are loaded
//   once by TMA. Three warpgroups: two consumers, one producer
//   (setmaxnreg 24 / 240 / 240).
// - The producer's first thread streams 64-row Q and dO tiles through a
//   2-stage ring (2 x 2 x 32 KB) over the G heads of the group and the q
//   tiles from the causal lower bound; its second warp stages the tiles'
//   lse (times log2 e) and delta and arrives on the same barrier. ~194 KB
//   of shared memory, one block an SM.
// - Both consumers compute the whole S^T and dP^T of the block's 64 keys
//   (wgmma m64n64k16 over all 256 of d, SS: K, V, Q and dO K-major as laid
//   out) and form P^T and dS^T in registers; consumer w then accumulates
//   only its half of d: dV[:, 128w:] += P^T dO[:, 128w:] and dK[:, 128w:]
//   += dS^T Q[:, 128w:] (wgmma m64n128k16 RS, dO and Q MN-major, the half
//   starting 2 boxes on). The accumulators are 64 + 64 fp32 registers a
//   thread.
// - The cost of the split: S^T and dP^T are computed twice, 12*256 FLOPs a
//   visible pair instead of 8*256, in exchange for no exchange through
//   shared memory and no extra barrier.
// - The GQA group sum happens in the consumers' registers across the
//   whole loop: no per-head intermediate, no atomics. Tiles fully masked
//   for the block's keys are skipped.

#include "sm90.cuh"

namespace {

using namespace rtt::sm90;

constexpr int D = 256;      // head dim
constexpr int NB = D / 64;  // 64-column boxes per row
constexpr int BN = 64;      // keys per block
constexpr int BM = 64;      // query rows per tile
constexpr int STAGES = 2;   // Q/dO ring depth
constexpr int NT = 384;     // 2 consumer warpgroups + 1 producer warpgroup

constexpr uint32_t kKV = BN * D * 2;  // the K or the V tile
constexpr uint32_t kT = BM * D * 2;   // one Q or dO tile
constexpr uint32_t kOffV = kKV;
constexpr uint32_t kOffQ = 2 * kKV;
constexpr uint32_t kOffDO = kOffQ + STAGES * kT;
constexpr uint32_t kOffRow = kOffDO + STAGES * kT;  // lse, delta
constexpr uint32_t kOffBar = kOffRow + STAGES * 2 * BM * 4;
// barriers: kv_full, full[STAGES], empty[STAGES]; +1024 for alignment
constexpr uint32_t kSmemBytes = kOffBar + 8 * (1 + 2 * STAGES) + 1024;

__global__ void __launch_bounds__(NT, 1)
flash_bwd_dkv_sm90_d256_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tdo,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv, int sq, int sk,
                               int H, int KVH, int causal, float scale,
                               float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sK = base, sV = base + kOffV;
  const uint32_t sQ = base + kOffQ, sDO = base + kOffDO;
  // lse (log2 units) and delta of stage s: rows [s][0][BM], [s][1][BM]
  float* const rows =
      reinterpret_cast<float*>(smem_raw + (base - raw) + kOffRow);
  const uint32_t bar_kv = base + kOffBar;
  auto bar_full = [&](int s) { return bar_kv + 8u * (1 + s); };
  auto bar_empty = [&](int s) { return bar_kv + 8u * (1 + STAGES + s); };

  const int bkh = blockIdx.y;
  const int b = bkh / KVH;
  const int kh = bkh % KVH;
  const int G = H / KVH;
  const int k0 = blockIdx.x * BN;
  const int offset = sk - sq;
  // first q tile with a row that sees key k0: q row >= k0 - offset
  const int first = causal ? k0 - offset : 0;
  const int qt_lo = first <= 0 ? 0 : first / BM;
  const int n_qt = (sq + BM - 1) / BM;
  // the tiles, in one flat loop for every role: the q tiles from qt_lo,
  // once for each of the G heads of the group
  const int n_it = G * (n_qt - qt_lo);

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full(s), 1 + 32);    // the TMA thread + the row warp
      mbar_init(bar_empty(s), 2 * 128);  // every consumer thread arrives
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 2) {
    // ---------------------------------------------------------- producer
    reg_dealloc<24>();
    const int pw = (tid - 256) / 32;
    const int lane = tid % 32;
    if (pw == 0 && lane == 0) {
      mbar_expect_tx(bar_kv, 2 * kKV);
      for (int h = 0; h < NB; ++h) {
        tma_load_4d(sK + h * BN * 128, &tk, bar_kv, 64 * h, kh, k0, b);
        tma_load_4d(sV + h * BN * 128, &tv, bar_kv, 64 * h, kh, k0, b);
      }
      for (int it = 0, qt = qt_lo, hh = kh * G; it < n_it; ++it) {
        const int s = it % STAGES;
        mbar_wait(bar_empty(s), ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(bar_full(s), 2 * kT);
        for (int h = 0; h < NB; ++h) {
          tma_load_4d(sQ + s * kT + h * BM * 128, &tq, bar_full(s), 64 * h,
                      hh, qt * BM, b);
          tma_load_4d(sDO + s * kT + h * BM * 128, &tdo, bar_full(s),
                      64 * h, hh, qt * BM, b);
        }
        if (++qt == n_qt) qt = qt_lo, ++hh;
      }
    } else if (pw == 1) {
      // rows past sq read as 0: their P is masked
      const long row0 = (static_cast<long>(b) * H + kh * G) * sq;
      const float* lrow = lse + row0;
      const float* drow = delta + row0;
      for (int it = 0, qt = qt_lo; it < n_it; ++it) {
        const int s = it % STAGES;
        mbar_wait(bar_empty(s), ((it / STAGES) & 1) ^ 1);
        float* r = rows + s * 2 * BM;
#pragma unroll
        for (int e = 0; e < BM / 32; ++e) {
          const int i = lane + 32 * e;
          const int qi = qt * BM + i;
          r[i] = qi < sq ? lrow[qi] * kLog2e : 0.f;
          r[BM + i] = qi < sq ? drow[qi] : 0.f;
        }
        mbar_arrive(bar_full(s));
        if (++qt == n_qt) qt = qt_lo, lrow += sq, drow += sq;
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    reg_alloc<240>();
    const int lt = tid % 128;
    const int warp = lt / 32, lane = lt % 32;
    const int r_lo = 16 * warp + lane / 4;  // key rows r_lo, r_lo + 8 of 64
    const int cq = 2 * (lane % 4);          // column pair in each 8 columns
    const int kj0 = k0 + r_lo;              // this thread's keys: kj0, +8
    const uint32_t half = 2 * wg * BM * 128;  // this consumer's d half

    float dk_acc[64], dv_acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    mbar_wait(bar_kv, 0);
    for (int it = 0, qt = qt_lo; it < n_it;
         ++it, qt = qt + 1 == n_qt ? qt_lo : qt + 1) {
      const int s = it % STAGES;
      const int q0 = qt * BM;
      mbar_wait(bar_full(s), (it / STAGES) & 1);
      // a tile whose last row is before all 64 keys contributes nothing
      if (!(causal && offset + q0 + BM - 1 < k0)) {
        const uint32_t sQs = sQ + s * kT;
        const uint32_t sDOs = sDO + s * kT;
        float st[BM / 2], dpt[BM / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t koff = (kk % 4) * 32;
          wgmma_ss_n64(st,
                       desc_sw128(sK + (kk / 4) * BN * 128 + koff, 16, 1024),
                       desc_sw128(sQs + (kk / 4) * BM * 128 + koff, 16, 1024),
                       kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t koff = (kk % 4) * 32;
          wgmma_ss_n64(
              dpt, desc_sw128(sV + (kk / 4) * BN * 128 + koff, 16, 1024),
              desc_sw128(sDOs + (kk / 4) * BM * 128 + koff, 16, 1024),
              kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(st);
        fence_regs(dpt);

        // P^T and dS^T: rows are keys kj0 (+8), columns q rows
        const float* r = rows + s * 2 * BM;
        const bool mask = (causal && offset + q0 < k0 + BN - 1) ||
                          q0 + BM > sq || k0 + BN > sk;
#pragma unroll
        for (int j = 0; j < BM / 8; ++j) {
          const int c = 8 * j + cq;
          const float2 lse2 = *reinterpret_cast<const float2*>(r + c);
          const float2 del2 = *reinterpret_cast<const float2*>(r + BM + c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            float p = exp2_approx(st[i] * scale_log2 -
                                  ((e & 1) ? lse2.y : lse2.x));
            if (mask) {
              const int qi = q0 + c + (e & 1);
              const int kj = kj0 + 8 * (e / 2);
              if (qi >= sq || kj >= sk || (causal && offset + qi < kj))
                p = 0.f;
            }
            st[i] = p;
            dpt[i] = p * (dpt[i] - ((e & 1) ? del2.y : del2.x));
          }
        }
        uint32_t pa[BM / 16][4], dsa[BM / 16][4];
#pragma unroll
        for (int kk = 0; kk < BM / 16; ++kk)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            pa[kk][q] = pack_bf16(st[8 * kk + 2 * q], st[8 * kk + 2 * q + 1]);
            dsa[kk][q] =
                pack_bf16(dpt[8 * kk + 2 * q], dpt[8 * kk + 2 * q + 1]);
          }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BM / 16; ++kk)
          wgmma_rs_n128(dv_acc, pa[kk],
                        desc_sw128(sDOs + half + kk * 16 * 128, BM * 128,
                                   1024));
#pragma unroll
        for (int kk = 0; kk < BM / 16; ++kk)
          wgmma_rs_n128(dk_acc, dsa[kk],
                        desc_sw128(sQs + half + kk * 16 * 128, BM * 128,
                                   1024));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(dv_acc);
        fence_regs(dk_acc);
        fence_regs(pa);
        fence_regs(dsa);
      }
      mbar_arrive(bar_empty(s));
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kj = kj0 + 8 * h;
      if (kj >= sk) continue;
      const long off =
          ((static_cast<long>(b) * sk + kj) * KVH + kh) * D + 128 * wg;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int i = 4 * j + 2 * h;
        *reinterpret_cast<uint32_t*>(dk + off + 8 * j + cq) =
            pack_bf16(dk_acc[i] * scale, dk_acc[i + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + off + 8 * j + cq) =
            pack_bf16(dv_acc[i], dv_acc[i + 1]);
      }
    }
  }
}

}  // namespace

extern "C" int rtt_flash_bwd_dkv_sm90_d256(const void* q, const void* k,
                                           const void* v, const void* dout,
                                           const void* lse, const void* delta,
                                           void* dk, void* dv, int b, int sq,
                                           int sk, int H, int KVH, int causal,
                                           float scale, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || KVH <= 0 || H % KVH != 0 ||
      b * KVH > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv, tdo;
  if (!encode_map(&tq, q, D, H, sq, b, BM) ||
      !encode_map(&tk, k, D, KVH, sk, b, BN) ||
      !encode_map(&tv, v, D, KVH, sk, b, BN) ||
      !encode_map(&tdo, dout, D, H, sq, b, BM))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(kSmemBytes);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_sm90_d256_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((sk + BN - 1) / BN, b * KVH);
  flash_bwd_dkv_sm90_d256_kernel<<<grid, NT, smem,
                                   static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), sq, sk, H, KVH, causal, scale,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}
