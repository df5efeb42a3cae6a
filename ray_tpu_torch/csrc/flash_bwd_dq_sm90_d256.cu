// Flash-attention dQ backward for Hopper (sm_90a) at head dim 256, bf16
// inputs: wgmma on bf16 tiles that TMA loads into shared memory behind
// mbarriers.
//
// Replaces: ray_tpu/ops/attention.py::_flash_bwd_dq_kernel (pallas_call at
// attention.py:346), on the bf16 path at Gemma's head dim 256; head dims
// 64 and 128 take flash_bwd_dq_sm90.cu, fp32 the scalar dQ kernel of
// flash_bwd.cu. Same function: P = exp(S*scale - lse) recomputed tile by
// tile from the forward's fp32 row logsumexp (masked under the causal
// offset sk - sq), dP = dO V^T, dS = P * (dP - delta) with delta =
// rowsum(dO * O) from the wrapper, dQ = scale * dS K; query head h reads
// kv head h / (H / KVH).
//
// Layout: q, dO [b, sq, H, 256]; k, v [b, sk, KVH, 256], read in place
// through 4-D TMA maps; lse, delta [b*H, sq] fp32; dq [b, sq, H, 256] bf16.
//
// Precision, as flash_bwd_dq_sm90.cu: S = Q K^T and dP = dO V^T
// accumulate in fp32 from bf16; the scale is applied to S in fp32 (folded
// with log2 e into an exp2, against lse * log2 e); dS is rounded to bf16
// as the A operand of dQ += dS K, which accumulates in fp32.
//
// What bounds it: 6*256 FLOPs per visible (q, k) pair and query head
// (1.03e11 at b 2, s 2048, 16/16 heads, causal) against ~b*s*(2H +
// 2KVH)*256*2 bytes: the bf16 tensor-core rate. The d-128 dQ keeps Q and
// dO resident for its 128 rows; at d 256 they take 128 KB, so 64-key K/V
// tiles in a 2-stage ring (another 128 KB) would not fit in the 227 KB a
// block may have. So this is its structure at 32-key tiles:
// - One block per (b*H, 128 query rows), q tiles in reverse order so the
//   longest causal rows start first. Three warpgroups: two consumers of 64
//   query rows each, one producer (setmaxnreg 24 / 240 / 240).
// - The producer's first thread loads Q and dO once (64-column boxes,
//   128-byte swizzle, four to a row of d), then streams 32-key K and V
//   tiles through a 2-stage ring (full/empty mbarriers); its second warp
//   stages the block's lse (times log2 e) and delta in shared memory with
//   bounds checks and arrives on Q's barrier. Q + dO 128 KB, the ring
//   64 KB: ~194 KB of shared memory, one block an SM.
// - Per K/V tile each consumer issues S and dP (16 k-steps each of wgmma
//   m64n32k16, SS: Q, K, dO and V all K-major as laid out), computes P and
//   dS on the fragments (masks only on diagonal or ragged tiles; tiles
//   fully masked for the warpgroup's rows are skipped), packs dS to bf16
//   registers and feeds each 16-key k-step of it into two wgmma m64n128k16
//   products, dQ[:, 0:128] and dQ[:, 128:256] += dS K (RS, K as an
//   MN-major B operand whose second half lies two boxes further on). The
//   64 x 256 fp32 dQ accumulator (2 x 64 registers a thread) lives across
//   the loop: no atomics, no second pass.
// - The cost of 32-key tiles: an m64n32 SS product reads 3 KB of shared
//   memory for 65,536 FLOPs, so S and dP may be held by shared-memory
//   reads rather than by the tensor cores (~1.5x the tensor time).
// Each product is waited for before the next step: the two consumer
// warpgroups overlap each other, not themselves (as the forward).

#include "sm90.cuh"

namespace {

using namespace rtt::sm90;

constexpr int D = 256;      // head dim
constexpr int NB = D / 64;  // 64-column boxes per row
constexpr int BM = 128;     // query rows per block (two warpgroups of 64)
constexpr int BN = 32;      // keys per tile
constexpr int STAGES = 2;   // K/V ring depth
constexpr int NT = 384;     // 2 consumer warpgroups + 1 producer warpgroup

constexpr uint32_t kQ = BM * D * 2;   // the Q or the dO tile
constexpr uint32_t kKV = BN * D * 2;  // one K or V tile
constexpr uint32_t kOffDO = kQ;
constexpr uint32_t kOffK = 2 * kQ;
constexpr uint32_t kOffV = kOffK + STAGES * kKV;
constexpr uint32_t kOffRow = kOffV + STAGES * kKV;  // lse, delta
constexpr uint32_t kOffBar = kOffRow + 2 * BM * 4;
// barriers: q_full, full[STAGES], empty[STAGES]; +1024 for alignment
constexpr uint32_t kSmemBytes = kOffBar + 8 * (1 + 2 * STAGES) + 1024;

__global__ void __launch_bounds__(NT, 1)
flash_bwd_dq_sm90_d256_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dq, int sq, int sk,
                              int H, int KVH, int causal, float scale,
                              float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base, sDO = base + kOffDO;
  const uint32_t sK = base + kOffK, sV = base + kOffV;
  // lse (log2 units) of the block's rows, then their delta: [2][BM]
  float* const rows =
      reinterpret_cast<float*>(smem_raw + (base - raw) + kOffRow);
  const uint32_t bar_q = base + kOffBar;
  auto bar_full = [&](int s) { return bar_q + 8u * (1 + s); };
  auto bar_empty = [&](int s) { return bar_q + 8u * (1 + STAGES + s); };

  const int n_qt = (sq + BM - 1) / BM;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * BM;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int hh = bh % H;
  const int kh = hh / (H / KVH);
  const int offset = sk - sq;  // query row i sits at key position offset+i
  int n_kt = (sk + BN - 1) / BN;
  if (causal) {
    const int last_q = offset + min(q0 + BM, sq) - 1;
    n_kt = min(n_kt, last_q < 0 ? 0 : last_q / BN + 1);
  }

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_q, 1 + 32);  // the TMA thread + the row warp
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full(s), 1);
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
      mbar_expect_tx(bar_q, 2 * kQ);
      for (int h = 0; h < NB; ++h) {
        tma_load_4d(sQ + h * BM * 128, &tq, bar_q, 64 * h, hh, q0, b);
        tma_load_4d(sDO + h * BM * 128, &tdo, bar_q, 64 * h, hh, q0, b);
      }
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(bar_empty(s), ((kt / STAGES) & 1) ^ 1);
        mbar_expect_tx(bar_full(s), 2 * kKV);
        for (int h = 0; h < NB; ++h) {
          tma_load_4d(sK + s * kKV + h * BN * 128, &tk, bar_full(s), 64 * h,
                      kh, kt * BN, b);
          tma_load_4d(sV + s * kKV + h * BN * 128, &tv, bar_full(s), 64 * h,
                      kh, kt * BN, b);
        }
      }
    } else if (pw == 1) {
      // rows past sq read as 0: their dQ is never stored
      const long row0 = static_cast<long>(bh) * sq + q0;
#pragma unroll
      for (int e = 0; e < BM / 32; ++e) {
        const int i = lane + 32 * e;
        const bool in = q0 + i < sq;
        rows[i] = in ? lse[row0 + i] * kLog2e : 0.f;
        rows[BM + i] = in ? delta[row0 + i] : 0.f;
      }
      mbar_arrive(bar_q);
    }
  } else {
    // --------------------------------------------------------- consumers
    reg_alloc<240>();
    const int lt = tid % 128;
    const int warp = lt / 32, lane = lt % 32;
    const int r_lo = 16 * warp + lane / 4;  // rows r_lo and r_lo + 8 of 64
    const int cq = 2 * (lane % 4);          // column pair in each 8 columns
    const int row_first = q0 + 64 * wg;     // the warpgroup's first row
    const int row0 = row_first + r_lo;      // this thread's rows: row0, +8

    // dQ's two halves of d: acc[hf][4j + e] is column 128*hf + 8j + ...
    float acc[2][64];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[hf][i] = 0.f;

    const uint32_t sQw = sQ + wg * 64 * 128;
    const uint32_t sDOw = sDO + wg * 64 * 128;
    mbar_wait(bar_q, 0);
    // this thread's two rows' lse (log2 units) and delta
    float lse2[2], del[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lse2[h] = rows[64 * wg + r_lo + 8 * h];
      del[h] = rows[BM + 64 * wg + r_lo + 8 * h];
    }
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % STAGES;
      const int k0 = kt * BN;
      mbar_wait(bar_full(s), (kt / STAGES) & 1);
      // a tile past the causal bound of all 64 rows contributes nothing
      if (!(causal && k0 > offset + row_first + 63)) {
        const uint32_t sKs = sK + s * kKV;
        const uint32_t sVs = sV + s * kKV;
        float sc[BN / 2], dp[BN / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t koff = (kk % 4) * 32;
          wgmma_ss_n32(sc,
                       desc_sw128(sQw + (kk / 4) * BM * 128 + koff, 16, 1024),
                       desc_sw128(sKs + (kk / 4) * BN * 128 + koff, 16, 1024),
                       kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t koff = (kk % 4) * 32;
          wgmma_ss_n32(dp,
                       desc_sw128(sDOw + (kk / 4) * BM * 128 + koff, 16, 1024),
                       desc_sw128(sVs + (kk / 4) * BN * 128 + koff, 16, 1024),
                       kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);
        fence_regs(dp);

        // P and dS: rows row0 (+8), columns keys k0 + 8j + cq (+1)
        const bool mask = (causal && k0 + BN - 1 > offset + row_first) ||
                          k0 + BN > sk;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            float p = exp2_approx(sc[i] * scale_log2 - lse2[e / 2]);
            if (mask) {
              const int col = k0 + 8 * j + cq + (e & 1);
              const int row = row0 + 8 * (e / 2);
              if (col >= sk || (causal && offset + row < col)) p = 0.f;
            }
            dp[i] = p * (dp[i] - del[e / 2]);
          }
        uint32_t dsa[BN / 16][4];
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            dsa[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
        // dQ[:, half] += dS K[:, half]: K's half hf starts 2 boxes on
        wgmma_fence();
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int kk = 0; kk < BN / 16; ++kk)
            wgmma_rs_n128(acc[hf], dsa[kk],
                          desc_sw128(sKs + 2 * hf * BN * 128 + kk * 16 * 128,
                                     BN * 128, 1024));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc[0]);
        fence_regs(acc[1]);
        fence_regs(dsa);
      }
      mbar_arrive(bar_empty(s));
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= sq) continue;
      __nv_bfloat16* drow =
          dq + ((static_cast<long>(b) * sq + row) * H + hh) * D;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int j = 0; j < 16; ++j)
          *reinterpret_cast<uint32_t*>(drow + 128 * hf + 8 * j + cq) =
              pack_bf16(acc[hf][4 * j + 2 * h] * scale,
                        acc[hf][4 * j + 2 * h + 1] * scale);
    }
  }
}

}  // namespace

extern "C" int rtt_flash_bwd_dq_sm90_d256(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const void* lse, const void* delta,
                                          void* dq, int b, int sq, int sk,
                                          int H, int KVH, int causal,
                                          float scale, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || KVH <= 0 || H % KVH != 0 ||
      b * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv, tdo;
  if (!encode_map(&tq, q, D, H, sq, b, BM) ||
      !encode_map(&tk, k, D, KVH, sk, b, BN) ||
      !encode_map(&tv, v, D, KVH, sk, b, BN) ||
      !encode_map(&tdo, dout, D, H, sq, b, BM))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(kSmemBytes);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_sm90_d256_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((sq + BM - 1) / BM, b * H);
  flash_bwd_dq_sm90_d256_kernel<<<grid, NT, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq), sq,
      sk, H, KVH, causal, scale, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}
