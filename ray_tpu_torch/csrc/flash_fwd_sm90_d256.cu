// Flash-attention forward for Hopper (sm_90a) at head dim 256, bf16 inputs:
// wgmma on bf16 tiles that TMA loads into shared memory behind mbarriers.
//
// Replaces: ray_tpu/ops/attention.py::_flash_kernel (launched by
// _flash_forward, pallas_call at attention.py:178), on the bf16 path at
// Gemma's head dim 256; head dims 64 and 128 take flash_fwd_sm90.cu, fp32
// the scalar kernel of flash_fwd.cu. Same function: blocked causal or
// non-causal attention with an fp32 online softmax, the causal mask offset
// by sk - sq, GQA head h reading kv head h / (H / KVH), outputs O in bf16
// and the fp32 row logsumexp lse = m + log(max(l, 1e-30)) that the
// backward consumes.
//
// Layout: q [b, sq, H, 256], k/v [b, sk, KVH, 256], read in place through
// 4-D TMA maps; o [b, sq, H, 256]; lse [b*H, sq].
//
// Precision, as flash_fwd_sm90.cu: S = Q K^T accumulates in fp32 from bf16;
// the softmax scale (folded with log2 e into an exp2) is applied to S in
// fp32; P is rounded to bf16 as the A operand of O += P V, which
// accumulates in fp32; the row sums l add the fp32 probabilities.
//
// What bounds it: 4*256 FLOPs per visible (q, k) pair and query head
// against ~b*s*(2H + 2KVH)*256*2 bytes. At the Gemma serving prefill (b 8,
// s 512, 16/16 heads) the bytes bound it (0.040 ms against 0.017 ms of
// tensor-core time); at training lengths the tensor cores do. The d-128
// kernel's tiles do not fit at d 256 (a 128-key K/V stage alone would be
// 128 KB), so this is its structure at other tile sizes:
// - One block per (b*H, 128 query rows), q tiles in reverse order so the
//   longest causal rows start first. Two consumer warpgroups of 64 rows,
//   one producer warpgroup whose first thread issues the TMA loads;
//   setmaxnreg moves registers from the producer (24) to the consumers
//   (240).
// - Keys stream in 64-key K and V tiles through a 2-stage ring: Q 64 KB +
//   2 x (32 + 32) KB, ~193 KB of shared memory, one block an SM. The TMA
//   boxes are 64 columns wide (128-byte swizzle), four to a row of d.
// - Each consumer computes S [64 x 64] by 16 k-steps of wgmma m64n64k16
//   (Q and K K-major as laid out), runs the online softmax on the
//   accumulator fragment, and feeds P from registers into two wgmma
//   m64n128k16 products, one for each half of d (V MN-major, the second
//   half two boxes further). O is 2 x 64 fp32 registers a thread.
// Each product is waited for before the next step: the two consumer
// warpgroups overlap each other's softmax and products, but a warpgroup
// does not overlap its own.

#include "sm90.cuh"

namespace {

using namespace rtt::sm90;

constexpr int D = 256;       // head dim
constexpr int NB = D / 64;   // 64-column boxes per row
constexpr int BM = 128;      // query rows per block (two warpgroups of 64)
constexpr int BN = 64;       // keys per tile
constexpr int STAGES = 2;    // K/V ring depth
constexpr int NT = 384;      // 2 consumer warpgroups + 1 producer warpgroup

constexpr uint32_t kQ = BM * D * 2;   // Q tile bytes
constexpr uint32_t kKV = BN * D * 2;  // one K or V tile
constexpr uint32_t kOffK = kQ;
constexpr uint32_t kOffV = kOffK + STAGES * kKV;
constexpr uint32_t kOffBar = kOffV + STAGES * kKV;
// barriers: q_full, full[STAGES], empty[STAGES]; +1024 for alignment
constexpr uint32_t kSmemBytes = kOffBar + 8 * (1 + 2 * STAGES) + 1024;

__global__ void __launch_bounds__(NT, 1)
flash_fwd_sm90_d256_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse, int sq, int sk, int H,
                           int KVH, int causal, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = base + kOffK, sV = base + kOffV;
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
    mbar_init(bar_q, 1);
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
    if (tid == 256) {
      mbar_expect_tx(bar_q, kQ);
      for (int h = 0; h < NB; ++h)
        tma_load_4d(sQ + h * BM * 128, &tq, bar_q, 64 * h, hh, q0, b);
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

    // O's two halves of d: acc[hf][4j + e] is column 128*hf + 8j + ...
    float acc[2][64];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[hf][i] = 0.f;
    // running max (log2 units) and sum of each of the two rows; masked
    // scores take the reference's finite -1e30, keys past sk -inf
    const float kMasked = -1e30f;
    float m[2] = {kMasked, kMasked};
    float l[2] = {0.f, 0.f};

    const uint32_t sQw = sQ + wg * 64 * 128;
    mbar_wait(bar_q, 0);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % STAGES;
      const int k0 = kt * BN;
      mbar_wait(bar_full(s), (kt / STAGES) & 1);
      // a tile past the causal bound of all 64 rows contributes nothing
      if (!(causal && k0 > offset + row_first + 63)) {
        const uint32_t sKs = sK + s * kKV;
        const uint32_t sVs = sV + s * kKV;
        float sc[BN / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t koff = (kk % 4) * 32;
          wgmma_ss_n64(sc,
                       desc_sw128(sQw + (kk / 4) * BM * 128 + koff, 16, 1024),
                       desc_sw128(sKs + (kk / 4) * BN * 128 + koff, 16, 1024),
                       kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);

        // scores in log2 units; mask the diagonal and ragged tiles only
        const bool mask = (causal && k0 + BN - 1 > offset + row_first) ||
                          k0 + BN > sk;
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float t = sc[4 * j + e] * scale_log2;
            if (mask) {
              const int col = k0 + 8 * j + cq + (e & 1);
              const int row = row0 + 8 * (e / 2);
              if (col >= sk)
                t = -__int_as_float(0x7f800000);  // past the keys: -inf
              else if (causal && offset + row < col)
                t = kMasked;
            }
            sc[4 * j + e] = t;
            mx[e / 2] = fmaxf(mx[e / 2], t);
          }
        float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          alpha[h] = exp2_approx(m[h] - mx[h]);
          m[h] = mx[h];
        }
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const float p = exp2_approx(sc[i] - m[(i / 2) % 2]);
          sc[i] = p;
          rs[(i / 2) % 2] += p;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
          rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
          l[h] = l[h] * alpha[h] + rs[h];
        }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int i = 0; i < 64; ++i) acc[hf][i] *= alpha[(i / 2) % 2];

        // P as bf16 A fragments, one per 16 keys
        uint32_t pa[BN / 16][4];
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
        // O[:, half] += P V[:, half]: V's half hf starts 2 boxes on
        wgmma_fence();
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int kk = 0; kk < BN / 16; ++kk)
            wgmma_rs_n128(acc[hf], pa[kk],
                          desc_sw128(sVs + 2 * hf * BN * 128 + kk * 16 * 128,
                                     BN * 128, 1024));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc[0]);
        fence_regs(acc[1]);
        fence_regs(pa);
      }
      mbar_arrive(bar_empty(s));
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= sq) continue;
      const float l_safe = fmaxf(l[h], 1e-30f);
      const float inv = 1.f / l_safe;
      __nv_bfloat16* orow =
          o + ((static_cast<long>(b) * sq + row) * H + hh) * D;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int j = 0; j < 16; ++j)
          *reinterpret_cast<uint32_t*>(orow + 128 * hf + 8 * j + cq) =
              pack_bf16(acc[hf][4 * j + 2 * h] * inv,
                        acc[hf][4 * j + 2 * h + 1] * inv);
      if (lane % 4 == 0)
        lse[static_cast<long>(bh) * sq + row] =
            (m[h] + log2f(l_safe)) * kLn2;
    }
  }
}

}  // namespace

extern "C" int rtt_flash_fwd_sm90_d256(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int b, int sq, int sk, int H, int KVH,
                                       int causal, float scale,
                                       void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || KVH <= 0 || H % KVH != 0 ||
      b * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  if (!encode_map(&tq, q, D, H, sq, b, BM) ||
      !encode_map(&tk, k, D, KVH, sk, b, BN) ||
      !encode_map(&tv, v, D, KVH, sk, b, BN))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(kSmemBytes);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_sm90_d256_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((sq + BM - 1) / BM, b * H);
  flash_fwd_sm90_d256_kernel<<<grid, NT, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      sq, sk, H, KVH, causal, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}
