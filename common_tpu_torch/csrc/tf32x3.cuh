// fp32-accurate products on Hopper's tensor cores: 3xTF32 split products,
// and the cp.async copies that feed them.
//
// A TF32 operand keeps 10 of fp32's 23 mantissa bits, about three decimal
// digits, and one TF32 product biases the samplers' quadratic forms
// (common_tpu/likelihoods/niw.py, sample_params_prec). So every operand is
// split, a = hi + lo, with hi = a rounded to TF32 and lo = a - hi, which fp32
// holds exactly; each product is then the sum of three TF32 products,
//
//     a * b ~= lo_a * hi_b + hi_a * lo_b + hi_a * hi_b,
//
// accumulated in fp32. The tensor core reads only the top 19 bits of an
// operand register, so lo enters truncated to TF32: its error is below
// 2^-11 |lo| <= 2^-23 |a|, and the dropped lo_a * lo_b below 2^-24 |a b|,
// the size of fp32's own rounding. No product here is a single TF32 pass.
//
// `mma` is mma.sync.m16n8k8 (TF32 in, fp32 accumulate): both operands
// come from registers, so a kernel centres and splits each fragment in
// registers right after loading it from shared memory. It runs at about
// half of Hopper's TF32 peak. wgmma (wgmma.cuh) reaches the peak but reads
// B from shared memory, so a kernel on it splits B once into hi and lo
// panels in device memory and brings both in; A still comes from
// registers, split as here (gaussian_assign.cu, the warpgroup route).
#pragma once

#include <cstdint>

namespace tf32x3 {

// a = hi + lo. hi: a rounded to nearest TF32 (ties away from zero) with its
// low 13 bits cleared; lo: the exact fp32 remainder.
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  const uint32_t h = (__float_as_uint(a) + 0x1000u) & 0xFFFFE000u;
  hi = h;
  lo = __float_as_uint(a - __uint_as_float(h));
}

// d += a * b for one m16n8k8 tile: a row-major 16 x 8, b 8 x 8 given by
// columns, d 16 x 8, in the PTX fragment layouts.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes global -> shared, asynchronously; src_bytes = 0 fills zeros.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared, for rows that are not 16-byte aligned.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most `kPending` committed groups are still in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

}  // namespace tf32x3
