// Flash-attention dK/dV backward for Hopper (sm_90a), bf16 inputs: wgmma
// on bf16 tiles that TMA loads into shared memory behind mbarriers.
//
// Replaces: ray_tpu/ops/attention.py::_flash_bwd_dkv_kernel (pallas_call
// at attention.py:368), on the bf16 path that training runs; fp32 inputs
// keep the scalar kernel of flash_bwd.cu (bf16 dQ is flash_bwd_dq_sm90.cu).
// Same function: P = exp(S*scale - lse) recomputed
// tile by tile from the forward's fp32 row logsumexp (masked under the
// causal offset sk - sq), dS = P * (dO V^T - delta) with delta =
// rowsum(dO * O) from the wrapper, dV = P^T dO and dK = scale * dS^T Q,
// summed over the G query heads of each kv head's GQA group.
//
// Layout: q, dO [b, sq, H, d]; k, v [b, sk, KVH, d], read in place through
// 4-D TMA maps; lse, delta [b*H, sq] fp32; dk, dv [b, sk, KVH, d] bf16.
//
// Precision: S^T = K Q^T and dP^T = V dO^T accumulate in fp32 from bf16;
// the scale is applied to S^T in fp32 (folded with log2 e into an exp2);
// P^T and dS^T are rounded to bf16 as the A operands of dV += P^T dO and
// dK += dS^T Q, which accumulate in fp32.
//
// What bounds it: 8*d FLOPs per visible (q, k) pair and query head
// (~2.8e11 at b 4, s 2048, 32/8 heads, d 128, causal) against ~0.1 GB of
// inputs and outputs: the bf16 tensor-core rate. Design:
// - One block per (b, kv head, 128 keys); three warpgroups: two consumers
//   of 64 keys each, one producer (setmaxnreg: at d 128 producer 24
//   registers, consumers 240). K and V are loaded once by TMA.
// - The producer's first thread streams 64-row Q and dO tiles through a
//   2-stage TMA ring over the G heads of the group and the q tiles from
//   the causal lower bound; its second warp stages the tiles' lse (times
//   log2 e) and delta in shared memory and arrives on the same barrier.
// - The GQA group sum happens in the consumers' registers: both 64 x d
//   fp32 accumulators (dK and dV, 128 registers a thread at d 128) live
//   across the whole loop. No per-head intermediate, no atomics.
// - Per tile each consumer issues S^T and dP^T (wgmma m64n64k16, SS: K, V,
//   Q and dO all K-major as laid out), computes P^T and dS^T on the
//   accumulator fragments, and feeds them from registers into dV and dK
//   (wgmma RS, dO and Q as MN-major B operands). Tiles fully masked for
//   the warpgroup's keys are skipped.

#include "sm90.cuh"

namespace {

using namespace rtt::sm90;

constexpr int BN = 128;    // keys per block (two warpgroups of 64)
constexpr int BM = 64;     // query rows per tile
constexpr int STAGES = 2;  // Q/dO ring depth
constexpr int NT = 384;    // 2 consumer warpgroups + 1 producer warpgroup

// setmaxnreg split of the block's 3 x 128 x 168 registers (each count a
// multiple of 8, producer + 2 consumers = 504): at d 128 the consumers need
// 240 for the two 64 x 128 fp32 accumulators; at d 64 they need less and
// the producer's lse/delta warp gets 40
template <int D>
constexpr int kProducerRegs = D == 128 ? 24 : 40;
template <int D>
constexpr int kConsumerRegs = D == 128 ? 240 : 232;

template <int D>
struct Smem {
  static constexpr uint32_t kKV = BN * D * 2;  // the K or the V tile
  static constexpr uint32_t kT = BM * D * 2;   // one Q or dO tile
  static constexpr uint32_t kOffV = kKV;
  static constexpr uint32_t kOffQ = 2 * kKV;
  static constexpr uint32_t kOffDO = kOffQ + STAGES * kT;
  static constexpr uint32_t kOffRow = kOffDO + STAGES * kT;  // lse, delta
  static constexpr uint32_t kOffBar = kOffRow + STAGES * 2 * BM * 4;
  // barriers: kv_full, full[STAGES], empty[STAGES]; +1024 for alignment
  static constexpr uint32_t kBytes = kOffBar + 8 * (1 + 2 * STAGES) + 1024;
};

template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int sq, int sk,
                          int H, int KVH, int causal, float scale,
                          float scale_log2) {
  using S = Smem<D>;
  constexpr int NB = D / 64;  // 64-column boxes per row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sK = base, sV = base + S::kOffV;
  const uint32_t sQ = base + S::kOffQ, sDO = base + S::kOffDO;
  // lse (log2 units) and delta of stage s: rows [s][0][BM], [s][1][BM]
  float* const rows = reinterpret_cast<float*>(smem_raw + (base - raw) +
                                               S::kOffRow);
  const uint32_t bar_kv = base + S::kOffBar;
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
    reg_dealloc<kProducerRegs<D>>();
    const int pw = (tid - 256) / 32;
    const int lane = tid % 32;
    if (pw == 0 && lane == 0) {
      mbar_expect_tx(bar_kv, 2 * S::kKV);
      for (int h = 0; h < NB; ++h) {
        tma_load_4d(sK + h * BN * 128, &tk, bar_kv, 64 * h, kh, k0, b);
        tma_load_4d(sV + h * BN * 128, &tv, bar_kv, 64 * h, kh, k0, b);
      }
      for (int it = 0, qt = qt_lo, hh = kh * G; it < n_it; ++it) {
        const int s = it % STAGES;
        mbar_wait(bar_empty(s), ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(bar_full(s), 2 * S::kT);
        for (int h = 0; h < NB; ++h) {
          tma_load_4d(sQ + s * S::kT + h * BM * 128, &tq, bar_full(s),
                      64 * h, hh, qt * BM, b);
          tma_load_4d(sDO + s * S::kT + h * BM * 128, &tdo, bar_full(s),
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
    reg_alloc<kConsumerRegs<D>>();
    const int lt = tid % 128;
    const int warp = lt / 32, lane = lt % 32;
    const int r_lo = 16 * warp + lane / 4;  // key rows r_lo, r_lo + 8 of 64
    const int cq = 2 * (lane % 4);          // column pair in each 8 columns
    const int kw0 = k0 + 64 * wg;           // the warpgroup's first key
    const int kj0 = kw0 + r_lo;             // this thread's keys: kj0, +8

    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    const uint32_t sKw = sK + wg * 64 * 128;
    const uint32_t sVw = sV + wg * 64 * 128;
    mbar_wait(bar_kv, 0);
    for (int it = 0, qt = qt_lo; it < n_it;
         ++it, qt = qt + 1 == n_qt ? qt_lo : qt + 1) {
      const int s = it % STAGES;
      const int q0 = qt * BM;
      mbar_wait(bar_full(s), (it / STAGES) & 1);
      // a tile whose last row is before all 64 keys contributes nothing
      if (!(causal && offset + q0 + BM - 1 < kw0)) {
        const uint32_t sQs = sQ + s * S::kT;
        const uint32_t sDOs = sDO + s * S::kT;
        float st[BM / 2], dpt[BM / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t koff = (kk % 4) * 32;
          wgmma_ss<BM>(st,
                       desc_sw128(sKw + (kk / 4) * BN * 128 + koff, 16, 1024),
                       desc_sw128(sQs + (kk / 4) * BM * 128 + koff, 16, 1024),
                       kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t koff = (kk % 4) * 32;
          wgmma_ss<BM>(
              dpt, desc_sw128(sVw + (kk / 4) * BN * 128 + koff, 16, 1024),
              desc_sw128(sDOs + (kk / 4) * BM * 128 + koff, 16, 1024),
              kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(st);
        fence_regs(dpt);

        // P^T and dS^T: rows are keys kj0 (+8), columns q rows
        const float* r = rows + s * 2 * BM;
        const bool mask = (causal && offset + q0 < kw0 + 63) ||
                          q0 + BM > sq || kw0 + 64 > sk;
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
          wgmma_rs<D>(dv_acc, pa[kk],
                      desc_sw128(sDOs + kk * 16 * 128, BM * 128, 1024));
#pragma unroll
        for (int kk = 0; kk < BM / 16; ++kk)
          wgmma_rs<D>(dk_acc, dsa[kk],
                      desc_sw128(sQs + kk * 16 * 128, BM * 128, 1024));
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
      const long off = ((static_cast<long>(b) * sk + kj) * KVH + kh) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int i = 4 * j + 2 * h;
        *reinterpret_cast<uint32_t*>(dk + off + 8 * j + cq) =
            pack_bf16(dk_acc[i] * scale, dk_acc[i + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + off + 8 * j + cq) =
            pack_bf16(dv_acc[i], dv_acc[i + 1]);
      }
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, int b, int sq, int sk, int H, int KVH,
                   int causal, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  if (!encode_map(&tq, q, D, H, sq, b, BM) ||
      !encode_map(&tk, k, D, KVH, sk, b, BN) ||
      !encode_map(&tv, v, D, KVH, sk, b, BN) ||
      !encode_map(&tdo, dout, D, H, sq, b, BM))
    return cudaErrorInvalidValue;
  const int smem = static_cast<int>(Smem<D>::kBytes);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_sm90_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sk + BN - 1) / BN, b * KVH);
  flash_bwd_dkv_sm90_kernel<D><<<grid, NT, smem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), sq, sk, H, KVH, causal, scale,
      scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rtt_flash_bwd_dkv_sm90(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dk, void* dv, int b, int sq,
                                      int sk, int H, int KVH, int d,
                                      int causal, float scale, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || KVH <= 0 || H % KVH != 0 ||
      b * KVH > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (d == 64)
    err = launch<64>(q, k, v, dout, lse, delta, dk, dv, b, sq, sk, H, KVH,
                     causal, scale, st);
  else if (d == 128)
    err = launch<128>(q, k, v, dout, lse, delta, dk, dv, b, sq, sk, H, KVH,
                      causal, scale, st);
  return static_cast<int>(err);
}
