// Paged decode attention for Hopper (sm_90a), fp32 or bf16 inputs: split-K
// over pages, then a deterministic merge.
//
// Replaces: ray_tpu/ops/paged_attention.py::_paged_kernel (launched by
// paged_attention, pallas_call at paged_attention.py:172). Same function:
// history-only attention of each slot's G query rows per kv head over the
// pages its block table lists, positions < ctx_len only, folded into an
// online softmax. Returns the un-normalised triple acc f32 [S, KVH, G,
// hd], m f32 [S, KVH, G], l f32 [S, KVH, G]; a slot with ctx 0 returns acc
// 0, l 0, m -1e30. The caller merges the in-flight token's self term
// (models/llama_paged.py).
//
// Layout: q [S, KVH, G, hd]; k/v pools [P, KVH, page, hd] (one page of one
// kv head is a contiguous page*hd run); block_table [S, MAXP] int32;
// ctx_len [S] int32. Only entries of pages < ceil(ctx/page) are read; an
// entry there that lies outside the pool is read as a JAX gather reads it
// (negative ids count from the end, the rest clamp into [0, P-1]), like
// clamp_page_ids in ops/paged_attention.py.
//
// What bounds it: every K/V byte of the history is used by only G (= 4 at
// Llama-3-8B, 7 at Qwen2-7B) query rows, ~2 FLOPs per byte, far below the
// card's ridge, and G rows do not fill a tensor-core tile: the bound is
// memory bandwidth over the ctx tokens' pages, so the design aims at bytes
// in flight.
// - Split-K. The grid is (S*KVH, n_split); block (unit, i) takes pages
//   [i*pps, (i+1)*pps) of its slot, with pps (pages per split) chosen by
//   the wrapper from shapes alone (ctx_len is never read back). A block
//   whose first page is at or past ceil(ctx/page) writes an empty partial
//   (m -1e30, l 0) and exits. At the serving shape (S 8, KVH 8, MAXP 16,
//   page 64, ctx 116-516) that is 352 live one-page blocks, not 64
//   serial walks of up to 9 pages.
// - Within a block, 4 warps split each page's keys in 16-key sub-tiles,
//   round robin, and each warp runs its own online softmax over its
//   sub-tiles: no block barrier in the loop. A warp brings its K and V
//   sub-tiles into shared memory with 16-byte cp.async copies in their
//   storage dtype, the next sub-tile's copy in flight while it computes
//   this one (two stages when the block has more sub-tiles than warps and
//   they fit: fp32 at hd 256 would need 256 KB, so it refills its one
//   stage after use). Scores: LPK lanes share one key, each holding 16 or
//   32 bytes of its row against the pre-scaled fp32 q chunk in registers,
//   reduced by xor shuffles. Each key group keeps its scores in its own
//   lanes (NI x G registers a lane), or, where that would pass 32
//   registers (mostly G 5-8 and hd 256), lane kk keeps key kk's score of
//   every row (G registers a lane, two more reductions over the warp).
//   P.V: each lane accumulates hd/32 fp32 columns of all G rows; at hd 16
//   (16 columns for 32 lanes) the two half-warps take alternate keys and
//   are summed before the combine. At the end the 4 warps' (m, l, acc)
//   are combined in shared memory and the block writes its fp32 partial.
// - G is a runtime row count under a compile-time maximum GM (1, 2, 4 or
//   8): G 3 runs the GM 4 instance, G 5-7 the GM 8 one, with the rows past
//   G skipped. Registers are sized by GM; 40 instances (2 dtypes x 5 head
//   dims x 4 maxima) instead of the 80 that one per G would take, and the
//   rows a smaller G leaves idle cost no bytes, which set the time.
// - Merge. A second small kernel combines each (slot, head)'s live splits
//   in split order: m = max m_i, l = sum l_i e^(m_i - m), acc = sum acc_i
//   e^(m_i - m). A separate kernel rather than a last-block ticket: it
//   keeps no counter state between calls and no fence/atomic protocol, and
//   its ~0.7 MB of partials at the serving shape are still in L2. No float
//   atomics anywhere, so two calls on the same inputs agree bit for bit.
// Page size must be a multiple of 16; hd 16, 32, 64, 128 or 256 (16 and
// 32 are the tiny presets' widths); G 1 to 8.

#include <mutex>

#include "common.cuh"

namespace {

constexpr int NT = 128;      // threads per block
constexpr int NW = NT / 32;  // warps per block
constexpr int SUB = 16;      // keys per warp step (a sub-tile)
constexpr int kMaxDevices = 64;
constexpr int kMaxSmem = 232448;  // bytes a block may opt in to (H100)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// N values of T at p (N * sizeof(T) bytes, 2, 4, 8 or 16, aligned to
// their size) as fp32; bf16 widens exactly.
template <typename T, int N>
__device__ __forceinline__ void load_floats(const T* p, float (&o)[N]) {
  constexpr int W = N * static_cast<int>(sizeof(T)) / 4;  // 32-bit words
  static_assert(W <= 2 || W == 4, "2, 4, 8 or 16 bytes");
  if constexpr (W == 0) {  // one bf16
    o[0] = __uint_as_float(
        static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p)) << 16);
  } else {
    uint32_t w[W];
    if constexpr (W == 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
    } else if constexpr (W == 2) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[0] = v.x, w[1] = v.y;
    } else {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    }
#pragma unroll
    for (int i = 0; i < W; ++i) {
      if constexpr (sizeof(T) == 4) {
        o[i] = __uint_as_float(w[i]);
      } else {
        o[2 * i] = __uint_as_float(w[i] << 16);
        o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    }
  }
}

// N contiguous values of T at p as fp32, in loads of at most 16 bytes.
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* p, float (&o)[N]) {
  constexpr int V = 16 / static_cast<int>(sizeof(T)) < N
                        ? 16 / static_cast<int>(sizeof(T))
                        : N;
  static_assert(N % V == 0, "whole loads");
#pragma unroll
  for (int i = 0; i < N / V; ++i) {
    float t[V];
    load_floats<T, V>(p + i * V, t);
#pragma unroll
    for (int e = 0; e < V; ++e) o[i * V + e] = t[e];
  }
}

// The split kernel's shape constants for storage type T and head dim HD.
template <typename T, int HD>
struct Shape {
  static constexpr int VEC = 16 / static_cast<int>(sizeof(T));  // per 16 B
  // lanes per key in the score product, and q values a lane holds
  static constexpr int LPK = HD / VEC < 32 ? HD / VEC : 32;
  static constexpr int QV = HD / LPK;
  static constexpr int KPI = 32 / LPK;  // keys per warp iteration
  static constexpr int NI = SUB / KPI;  // iterations per sub-tile
  // P.V output columns per lane; below hd 32 a column takes KSPLIT lanes,
  // each summing every KSPLIT-th key
  static constexpr int DPL = HD >= 32 ? HD / 32 : 1;
  static constexpr int KSPLIT = 32 * DPL / HD;
  static constexpr int TILE = SUB * HD;  // values of one K (or V) sub-tile
  static constexpr int CHUNKS = TILE * static_cast<int>(sizeof(T)) / 16 / 32;
  static constexpr int STAGE_BYTES = 2 * TILE * static_cast<int>(sizeof(T));
  static constexpr int MAX_STAGES = NW * 2 * STAGE_BYTES <= kMaxSmem ? 2 : 1;
  static_assert(LPK <= 32 && 32 % LPK == 0 && KPI <= SUB && CHUNKS >= 1,
                "shape");
};

// Two stages per warp when a block has more sub-tiles than warps (and two
// fit), else one.
template <typename T, int HD>
int n_stages(int pps, int page) {
  return pps * page / SUB > NW ? Shape<T, HD>::MAX_STAGES : 1;
}

template <typename T, int HD, int GM>
constexpr int smem_bytes(int stages) {
  const int tiles = NW * stages * Shape<T, HD>::STAGE_BYTES;
  const int combine = NW * GM * (HD + 2) * 4;
  return tiles > combine ? tiles : combine;
}

// One 16-key sub-tile of one warp: the scores of the GM rows, the online
// softmax update of (m_w, l_w, acc), and acc += P V over the keys before
// ctx (V past ctx may hold anything). Two layouts of the scores:
//
// tile_grouped keeps each key group's NI scores a row in its LPK lanes
// (NI x GM registers a lane) and reduces max and sum over the KPI groups
// only; it computes all GM rows (rows past G hold q = 0, harmlessly).
template <typename T, int HD, int GM>
__device__ __forceinline__ void tile_grouped(
    const T* Ks, const T* Vs, const float (&qr)[GM][Shape<T, HD>::QV],
    float (&m_w)[GM], float (&l_w)[GM],
    float (&acc)[GM][Shape<T, HD>::DPL], int key0, int ctx, int lane) {
  using Sh = Shape<T, HD>;
  constexpr int LPK = Sh::LPK, QV = Sh::QV, KPI = Sh::KPI, NI = Sh::NI;
  constexpr int DPL = Sh::DPL;
  const int j = lane / LPK, c = lane % LPK;
  // scores of key it*KPI + j for every row, in the lanes of group j
  float sc[NI][GM];
#pragma unroll
  for (int it = 0; it < NI; ++it) {
    float kf[QV];
    load_row<T, QV>(Ks + (it * KPI + j) * HD + c * QV, kf);
    const bool valid = key0 + it * KPI + j < ctx;
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float a = 0.f;
#pragma unroll
      for (int e = 0; e < QV; ++e) a = fmaf(qr[g][e], kf[e], a);
      a = rtt::group_sum<LPK>(a);
      sc[it][g] = valid ? a : rtt::kNegInf;
    }
  }
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    float mx = m_w[g];
#pragma unroll
    for (int it = 0; it < NI; ++it) mx = fmaxf(mx, sc[it][g]);
#pragma unroll
    for (int off = LPK; off < 32; off <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float alpha = expf(m_w[g] - mx);
    m_w[g] = mx;
    float rs = 0.f;
#pragma unroll
    for (int it = 0; it < NI; ++it) {
      const bool valid = key0 + it * KPI + j < ctx;
      const float p = valid ? expf(sc[it][g] - mx) : 0.f;
      sc[it][g] = p;
      rs += p;
    }
#pragma unroll
    for (int off = LPK; off < 32; off <<= 1)
      rs += __shfl_xor_sync(0xffffffffu, rs, off);
    l_w[g] = l_w[g] * alpha + rs;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[g][e] *= alpha;
  }
  // this lane's P.V columns and, below hd 32, its share of the keys
  constexpr int COLS = HD / DPL, KSPLIT = Sh::KSPLIT;
  const int col = (lane % COLS) * DPL, part = lane / COLS;
#pragma unroll
  for (int it = 0; it < NI; ++it)
#pragma unroll
    for (int jj = 0; jj < KPI; ++jj) {
      const int kk = it * KPI + jj;
      if (key0 + kk >= ctx) continue;  // uniform across the warp
      float vf[DPL];
      load_row<T, DPL>(Vs + kk * HD + col, vf);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        const float p = __shfl_sync(0xffffffffu, sc[it][g], jj * LPK);
        if (KSPLIT == 1 || kk % KSPLIT == part) {
#pragma unroll
          for (int e = 0; e < DPL; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
        }
      }
    }
}

// tile_spread hands key kk's score of every row to lane kk (GM registers
// a lane whatever the head dim) and reduces max and sum over the warp; it
// skips the rows past G. The instances whose grouped scores would take
// more than 32 registers a lane (NI x GM > 32: GM 8 except bf16 at hd
// 64, and GM 4 at fp32 hd 128 and at hd 256) use it.
template <typename T, int HD, int GM>
__device__ __forceinline__ void tile_spread(
    const T* Ks, const T* Vs, const float (&qr)[GM][Shape<T, HD>::QV],
    float (&m_w)[GM], float (&l_w)[GM],
    float (&acc)[GM][Shape<T, HD>::DPL], int key0, int ctx, int G,
    int lane) {
  using Sh = Shape<T, HD>;
  constexpr int LPK = Sh::LPK, QV = Sh::QV, KPI = Sh::KPI, NI = Sh::NI;
  constexpr int DPL = Sh::DPL;
  static_assert(Sh::KSPLIT == 1, "a lane's own columns: hd 32 and up");
  const int j = lane / LPK, c = lane % LPK;
  float sc[GM];
#pragma unroll
  for (int g = 0; g < GM; ++g) sc[g] = rtt::kNegInf;
#pragma unroll
  for (int it = 0; it < NI; ++it) {
    float kf[QV];
    load_row<T, QV>(Ks + (it * KPI + j) * HD + c * QV, kf);
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g >= G) continue;
      float a = 0.f;
#pragma unroll
      for (int e = 0; e < QV; ++e) a = fmaf(qr[g][e], kf[e], a);
      a = rtt::group_sum<LPK>(a);  // key it*KPI + j, in group j's lanes
      if constexpr (KPI > 1)
        a = __shfl_sync(0xffffffffu, a, (lane % KPI) * LPK);
      if (lane / KPI == it) sc[g] = a;
    }
  }
  const bool valid = lane < SUB && key0 + lane < ctx;
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g >= G) continue;
    const float mx =
        fmaxf(m_w[g], rtt::group_max<32>(valid ? sc[g] : rtt::kNegInf));
    const float alpha = expf(m_w[g] - mx);
    m_w[g] = mx;
    const float p = valid ? expf(sc[g] - mx) : 0.f;
    sc[g] = p;
    l_w[g] = l_w[g] * alpha + rtt::group_sum<32>(p);
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[g][e] *= alpha;
  }
#pragma unroll
  for (int kk = 0; kk < SUB; ++kk) {
    if (key0 + kk >= ctx) break;  // uniform across the warp
    float vf[DPL];
    load_row<T, DPL>(Vs + kk * HD + lane * DPL, vf);
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g >= G) continue;
      const float p = __shfl_sync(0xffffffffu, sc[g], kk);
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
    }
  }
}

template <typename T, int HD, int GM>
__global__ void __launch_bounds__(NT)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                   const T* __restrict__ vp,
                   const int* __restrict__ block_table,
                   const int* __restrict__ ctx_len,
                   float* __restrict__ part_acc, float* __restrict__ part_m,
                   float* __restrict__ part_l, int G, int KVH, int page,
                   int num_pages, int maxp, int pps, int n_split, int stages,
                   float scale) {
  using Sh = Shape<T, HD>;
  constexpr int QV = Sh::QV, DPL = Sh::DPL, TILE = Sh::TILE;
  constexpr int CHUNKS = Sh::CHUNKS;

  extern __shared__ __align__(16) uint8_t smem[];
  const int unit = blockIdx.x;  // slot * KVH + kv head
  const int split = blockIdx.y;
  const int slot = unit / KVH;
  const int kh = unit % KVH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long prow = (static_cast<long>(unit) * n_split + split) * G;

  const int ctx = ctx_len[slot];
  const int n_pages = ctx <= 0 ? 0 : min((ctx + page - 1) / page, maxp);
  const int p_begin = split * pps;
  if (p_begin >= n_pages) {
    if (threadIdx.x < G) {
      part_m[prow + threadIdx.x] = rtt::kNegInf;
      part_l[prow + threadIdx.x] = 0.f;
    }
    return;
  }
  const int key_begin = p_begin * page;
  const int key_end = min(ctx, min(p_begin + pps, n_pages) * page);
  const int n_sub = (key_end - key_begin + SUB - 1) / SUB;

  // this lane's chunk of every query row, pre-scaled; rows past G are 0
  const int c = lane % Sh::LPK;
  float qr[GM][QV];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g < G) {
      load_row<T, QV>(q + (static_cast<long>(unit) * G + g) * HD + c * QV,
                      qr[g]);
#pragma unroll
      for (int e = 0; e < QV; ++e) qr[g][e] *= scale;
    } else {
#pragma unroll
      for (int e = 0; e < QV; ++e) qr[g][e] = 0.f;
    }
  }

  // the warp's stage buffers: stage s holds K [SUB][HD] then V [SUB][HD]
  const bool two = stages == 2;
  T* const wbuf = reinterpret_cast<T*>(smem) + warp * stages * 2 * TILE;
  auto issue = [&](int t, int s) {
    const int key0 = key_begin + t * SUB;
    long pid = block_table[static_cast<long>(slot) * maxp + key0 / page];
    if (pid < 0) pid += num_pages;
    pid = pid < 0 ? 0 : (pid >= num_pages ? num_pages - 1 : pid);
    const long off = ((pid * KVH + kh) * page + key0 % page) * HD;
    const uint8_t* ks = reinterpret_cast<const uint8_t*>(kp + off);
    const uint8_t* vs = reinterpret_cast<const uint8_t*>(vp + off);
    const uint32_t kd = smem_u32(wbuf + s * 2 * TILE);
    const uint32_t vd = kd + TILE * sizeof(T);
#pragma unroll
    for (int r = 0; r < CHUNKS; ++r) {
      const int i = 16 * (lane + 32 * r);
      cp_async16(kd + i, ks + i);
      cp_async16(vd + i, vs + i);
    }
  };

  float m_w[GM], l_w[GM], acc[GM][DPL];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m_w[g] = rtt::kNegInf;
    l_w[g] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[g][e] = 0.f;
  }

  if (warp < n_sub) issue(warp, 0);
  cp_async_commit();
  for (int t = warp, s = 0; t < n_sub; t += NW, s = two ? s ^ 1 : 0) {
    const bool more = t + NW < n_sub;
    if (two && more) issue(t + NW, s ^ 1);
    cp_async_commit();
    if (two) {
      cp_async_wait<1>();  // all but the copy just issued
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const T* Ks = wbuf + s * 2 * TILE;
    const T* Vs = Ks + TILE;
    const int key0 = key_begin + t * SUB;

    if constexpr (Sh::NI * GM > 32)
      tile_spread<T, HD, GM>(Ks, Vs, qr, m_w, l_w, acc, key0, ctx, G, lane);
    else
      tile_grouped<T, HD, GM>(Ks, Vs, qr, m_w, l_w, acc, key0, ctx, lane);
    __syncwarp();  // every lane is done with stage s before it refills
    if (!two && more) issue(t + NW, 0);
  }
  cp_async_wait<0>();

  // combine the warps: [NW][GM] m, [NW][GM] l, [NW][GM][HD] acc in fp32
  __syncthreads();
  float* wm = reinterpret_cast<float*>(smem);
  float* wl = wm + NW * GM;
  float* wacc = wl + NW * GM;
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g >= G) continue;
    if (lane == 0) {
      wm[warp * GM + g] = m_w[g];
      wl[warp * GM + g] = l_w[g];
    }
    // below hd 32 the half-warps' key shares sum first
    constexpr int COLS = HD / DPL;
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      float a = acc[g][e];
#pragma unroll
      for (int off = COLS; off < 32; off <<= 1)
        a += __shfl_xor_sync(0xffffffffu, a, off);
      if (lane < COLS) wacc[(warp * GM + g) * HD + lane * DPL + e] = a;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < G * HD; e += NT) {
    const int g = e / HD;
    float m = wm[g];
#pragma unroll
    for (int w = 1; w < NW; ++w) m = fmaxf(m, wm[w * GM + g]);
    float a = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = expf(wm[w * GM + g] - m);
      a = fmaf(wacc[(w * GM + g) * HD + e % HD], f, a);
      l = fmaf(wl[w * GM + g], f, l);
    }
    part_acc[prow * HD + e] = a;
    if (e % HD == 0) {
      part_m[prow + g] = m;
      part_l[prow + g] = l;
    }
  }
}

// One block per (slot, kv head): the live splits of its row, in order.
__global__ void __launch_bounds__(NT)
paged_merge_kernel(const float* __restrict__ part_acc,
                   const float* __restrict__ part_m,
                   const float* __restrict__ part_l,
                   const int* __restrict__ ctx_len, float* __restrict__ acc,
                   float* __restrict__ m_out, float* __restrict__ l_out,
                   int KVH, int G, int hd, int page, int maxp, int pps,
                   int n_split) {
  const int unit = blockIdx.x;
  const int ctx = ctx_len[unit / KVH];
  const int n_pages = ctx <= 0 ? 0 : min((ctx + page - 1) / page, maxp);
  const int n_live = (n_pages + pps - 1) / pps;
  const long row0 = static_cast<long>(unit) * n_split * G;
  for (int e = threadIdx.x; e < G * hd; e += NT) {
    const int g = e / hd, d = e % hd;
    float m = rtt::kNegInf;
    for (int i = 0; i < n_live; ++i) m = fmaxf(m, part_m[row0 + i * G + g]);
    float a = 0.f, l = 0.f;
    for (int i = 0; i < n_live; ++i) {
      const long r = row0 + i * G + g;
      const float f = expf(part_m[r] - m);
      a = fmaf(part_acc[r * hd + d], f, a);
      l = fmaf(part_l[r], f, l);
    }
    acc[static_cast<long>(unit) * G * hd + e] = a;
    if (d == 0) {
      m_out[static_cast<long>(unit) * G + g] = m;
      l_out[static_cast<long>(unit) * G + g] = l;
    }
  }
}

// Allow the split kernel its dynamic shared memory (above 48 KB), once per
// instantiation and device rather than on every call.
template <typename T, int HD, int GM>
cudaError_t allow_smem() {
  static std::mutex mu;
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> hold(mu);
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      paged_split_kernel<T, HD, GM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<T, HD, GM>(Shape<T, HD>::MAX_STAGES));
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

struct Args {
  const void *q, *kp, *vp, *bt, *ctx;
  void *part_acc, *part_m, *part_l;
  int S, KVH, G, page, num_pages, maxp, pps, n_split;
  float scale;
  cudaStream_t stream;
};

template <typename T, int HD, int GM>
cudaError_t launch(const Args& a) {
  cudaError_t err = allow_smem<T, HD, GM>();
  if (err != cudaSuccess) return err;
  const int stages = n_stages<T, HD>(a.pps, a.page);
  const int smem = smem_bytes<T, HD, GM>(stages);
  dim3 grid(a.S * a.KVH, a.n_split);
  paged_split_kernel<T, HD, GM><<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.kp),
      static_cast<const T*>(a.vp), static_cast<const int*>(a.bt),
      static_cast<const int*>(a.ctx), static_cast<float*>(a.part_acc),
      static_cast<float*>(a.part_m), static_cast<float*>(a.part_l), a.G,
      a.KVH, a.page, a.num_pages, a.maxp, a.pps, a.n_split, stages,
      a.scale);
  return cudaGetLastError();
}

// G rows run the instance of the smallest row maximum GM >= G.
template <typename T, int HD>
cudaError_t launch_g(const Args& a) {
  if (a.G <= 1) return launch<T, HD, 1>(a);
  if (a.G <= 2) return launch<T, HD, 2>(a);
  if (a.G <= 4) return launch<T, HD, 4>(a);
  if (a.G <= 8) return launch<T, HD, 8>(a);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_hd(int hd, const Args& a) {
  if (hd == 16) return launch_g<T, 16>(a);
  if (hd == 32) return launch_g<T, 32>(a);
  if (hd == 64) return launch_g<T, 64>(a);
  if (hd == 128) return launch_g<T, 128>(a);
  if (hd == 256) return launch_g<T, 256>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// The split pass: fp32 partials part_acc [S, KVH, n_split, G, hd], part_m
// and part_l [S, KVH, n_split, G], n_split = ceil(maxp / pps).
extern "C" int rtt_paged_attention(const void* q, const void* kp,
                                   const void* vp, const void* block_table,
                                   const void* ctx_len, void* part_acc,
                                   void* part_m, void* part_l, int dtype,
                                   int S, int KVH, int G, int hd, int page,
                                   int num_pages, int maxp, int pps,
                                   int n_split, float scale, void* stream) {
  if (S <= 0 || KVH <= 0 || G <= 0 || G > 8 || page <= 0 ||
      page % SUB != 0 || num_pages <= 0 || maxp <= 0 || pps <= 0 ||
      n_split != (maxp + pps - 1) / pps || n_split > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,       kp,     vp,   block_table, ctx_len,
               part_acc, part_m, part_l, S,        KVH,
               G,       page,   num_pages, maxp,   pps,
               n_split, scale,  static_cast<cudaStream_t>(stream)};
  if (dtype == rtt::kFloat32)
    return static_cast<int>(launch_hd<float>(hd, a));
  if (dtype == rtt::kBFloat16)
    return static_cast<int>(launch_hd<__nv_bfloat16>(hd, a));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The merge pass: the (acc, m, l) triple from the split pass's partials.
extern "C" int rtt_paged_merge(const void* part_acc, const void* part_m,
                               const void* part_l, const void* ctx_len,
                               void* acc, void* m, void* l, int S, int KVH,
                               int G, int hd, int page, int maxp, int pps,
                               int n_split, void* stream) {
  if (S <= 0 || KVH <= 0 || G <= 0 || hd <= 0 || page <= 0 || maxp <= 0 ||
      pps <= 0 || n_split != (maxp + pps - 1) / pps)
    return static_cast<int>(cudaErrorInvalidValue);
  paged_merge_kernel<<<S * KVH, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_m),
      static_cast<const float*>(part_l), static_cast<const int*>(ctx_len),
      static_cast<float*>(acc), static_cast<float*>(m), static_cast<float*>(l),
      KVH, G, hd, page, maxp, pps, n_split);
  return static_cast<int>(cudaGetLastError());
}
