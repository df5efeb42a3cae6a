// fp32 products on the tensor cores for the fp32 attention kernels
// (flash_fwd_tf32x3.cu, flash_bwd_dkv_tf32x3.cu), and the cp.async copies
// that stage their tiles.
//
// 3xTF32: each fp32 operand x is split into hi = tf32(x) (rounded as
// cvt.rna: to nearest, ties away from zero, to 10 explicit mantissa bits)
// and lo = x - hi (which the tensor core truncates to TF32), and a product
// a*b is summed as hi(a)*lo(b) + lo(a)*hi(b) + hi(a)*hi(b) into one fp32
// accumulator, the small terms first. The dropped terms are ~2^-21 of the
// product, so the result lands within a few ulps of an fp32 product, at
// tensor-core rate (three m16n8k8 TF32 products per fp32 one). One TF32
// product alone keeps ~3 decimal digits: too few for the 1e-4 that the
// fp32 engines and gradients are held to.
//
// mma.sync m16n8k8 fragments (lane = 4 * g + t, g = lane / 4, t = lane % 4):
// - A (16 x 8, row-major): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//   a3 (g + 8, t + 4);
// - B (8 x 8, k x n): b0 (t, g), b1 (t + 4, g);
// - C/D (16 x 8, fp32): c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//   c3 (g + 8, 2t + 1).
// The reduction index of a product may be permuted, as long as A and B
// agree. The kernels map slot t to element 2t and slot t + 4 to 2t + 1 of
// each 8-step: a0/a2 and b0/b1 are then adjacent in memory (one 8-byte
// shared load), and an accumulator's (c0, c1, c2, c3) of one 8-column
// tile is, as it stands, the A fragment (a0, a2, a1, a3) of the next
// product over those 8 columns: no shuffle and no shared-memory round trip
// between a product and the one it feeds.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rtt {
namespace tf32x3 {

// One operand fragment in its two TF32 halves.
template <int N>
struct Frag {
  uint32_t hi[N], lo[N];
};
using FragA = Frag<4>;
using FragB = Frag<2>;

// cvt.rna.tf32.f32 for finite x, in two integer operations: adding half
// the weight of the 13 dropped bits to the sign-magnitude pattern rounds
// the magnitude half up (ties away from zero), then the bits are cleared.
// (cvt.rna itself compiles to these plus an infinity test and a select,
// which made the splits most of the kernels' instructions.)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// lo goes in as x - hi unrounded: the tensor core reads the top 19 bits
// of a TF32 operand, so lo is truncated to TF32 there, for free. (Rounding
// it first costs two more operations a value and changes no digit that
// survives the fp32 accumulation: tests/test_torch_tf32x3.py.)
template <int N>
__device__ __forceinline__ void split(Frag<N>& f, int i, float x) {
  f.hi[i] = to_tf32(x);
  f.lo[i] = __float_as_uint(x - __uint_as_float(f.hi[i]));
}

// d += a * b, one m16n8k8 TF32 product accumulating in fp32.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b in 3xTF32: the two small products, then hi * hi.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma(d, a.hi, b.lo);
  mma(d, a.lo, b.hi);
  mma(d, a.hi, b.hi);
}

// The A fragment of 16 rows x one 8-step from an fp32 tile in shared
// memory: `p` points at (row g, element 2t) of the step, `stride` is the
// row stride in floats.
__device__ __forceinline__ FragA load_a(const float* p, int stride) {
  const float2 r0 = *reinterpret_cast<const float2*>(p);
  const float2 r1 = *reinterpret_cast<const float2*>(p + 8 * stride);
  FragA a;
  split(a, 0, r0.x);
  split(a, 1, r1.x);
  split(a, 2, r0.y);
  split(a, 3, r1.y);
  return a;
}

// The A fragment from an accumulator over the same 8 columns.
__device__ __forceinline__ FragA acc_to_a(const float (&c)[4]) {
  FragA a;
  split(a, 0, c[0]);
  split(a, 1, c[2]);
  split(a, 2, c[1]);
  split(a, 3, c[3]);
  return a;
}

// The B fragment of an n x k product read as rows n of a row-major tile
// (B = tile^T): `p` points at (row g, element 2t) of the 8-step.
__device__ __forceinline__ FragB load_bt(const float* p) {
  const float2 r = *reinterpret_cast<const float2*>(p);
  FragB b;
  split(b, 0, r.x);
  split(b, 1, r.y);
  return b;
}

// The B fragments of two 8-column tiles of a k x n row-major tile whose k
// rows are 2t and 2t + 1 of the step: `p` points at (row 2t, column 2g)
// of a 16-column group. Column 2g goes to the even tile, 2g + 1 to the
// odd one, so the even tile's accumulator holds columns 4t and 4t + 2 of
// the group and the odd one's 4t + 1 and 4t + 3.
__device__ __forceinline__ void load_b_pair(const float* p, int stride,
                                            FragB& even, FragB& odd) {
  const float2 r0 = *reinterpret_cast<const float2*>(p);
  const float2 r1 = *reinterpret_cast<const float2*>(p + stride);
  split(even, 0, r0.x);
  split(even, 1, r1.x);
  split(odd, 0, r0.y);
  split(odd, 1, r1.y);
}

// ----------------------------------------------------------------- cp.async

// 16 bytes from global to shared memory; zero-filled when !pred (the
// source is then not read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool pred) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

// 4 bytes, zero-filled when !pred.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool pred) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace tf32x3
}  // namespace rtt
