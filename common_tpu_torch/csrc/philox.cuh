// Philox4x32-10 counter-based generator (Salmon et al., SC'11), the
// Random123 recipe. A draw depends only on (key, counter), so a kernel can
// key its noise on (seed, row, cluster) and the stream does not depend on
// how the grid tiles the work. Known-answer vectors: counter 0, key 0 gives
// {0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8}.
#pragma once

#include <cstdint>

namespace philox {

__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint2 key) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(kM0, ctr.x), lo0 = kM0 * ctr.x;
    const uint32_t hi1 = __umulhi(kM1, ctr.z), lo1 = kM1 * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
    key.x += kW0;
    key.y += kW1;
  }
  return ctr;
}

// Uniform in (0, 1) from the top 24 bits, floored at 1e-7 as the Pallas
// kernel's mantissa-fill uniform is (ops/gaussian_assign.py
// _uniform_from_bits), so -log(-log(u)) is always finite.
__device__ __forceinline__ float uniform_open(uint32_t bits) {
  const float u = static_cast<float>(bits >> 8) * (1.0f / 16777216.0f);
  return fmaxf(u, 1e-7f);
}

__device__ __forceinline__ float gumbel_of_bits(uint32_t bits) { return -logf(-logf(uniform_open(bits))); }

// A draw of `gumbel_of_bits` lies in [-2.7799, 16.6355]: u runs from 1e-7
// to 1 - 2^-24. So a score more than their spread, 19.4154 nats, below
// another's can never win the argmax, whatever the two draws; kReach is
// that spread with a margin (ops/linear_assign.py REACH is the same
// number, and a test ties both to the draw's range).
constexpr float kReach = 19.5f;

// Standard Gumbel draw keyed on (seed, a, b, c): counter (a, b, c, 0), the
// first output word. The Gaussian assignment kernels use a = row, b =
// cluster within its chain, c = chain, so chain 0 (and every single-chain
// launch) draws the same stream.
__device__ __forceinline__ float gumbel(uint32_t seed, uint32_t a, uint32_t b, uint32_t c = 0u) {
  const uint4 bits = philox4x32_10(make_uint4(a, b, c, 0u), make_uint2(seed, 0x5EEDu));
  return gumbel_of_bits(bits.x);
}

// The four words of one call with counter (row, group, 0, 1): the linear
// assignment kernel's noise for clusters 4 group .. 4 group + 3, word j (x,
// y, z, w) for cluster 4 group + j, each its own uniform. The counter's last
// word, 1, keeps this stream apart from `gumbel`'s, whose last word is 0.
__device__ __forceinline__ uint4 linear_words(uint32_t seed, uint32_t row, uint32_t group) {
  return philox4x32_10(make_uint4(row, group, 0u, 1u), make_uint2(seed, 0x5EEDu));
}

// The four words of one call with counter (group, 0, 0, 2): a slice update's
// uniforms 4 group .. 4 group + 3, word j (x, y, z, w) for draw 4 group + j.
// The counter's last word, 2, keeps the stream apart from the assignment
// kernels' (0 and 1).
__device__ __forceinline__ uint4 slice_words(uint32_t seed, uint32_t group) {
  return philox4x32_10(make_uint4(group, 0u, 0u, 2u), make_uint2(seed, 0x5EEDu));
}

// The four words of one call with counter (token, group, token_hi, 3): the
// dense HDP assignment's noise for topics 4 group .. 4 group + 3 of one
// token, word j (x, y, z, w) for topic 4 group + j. `token` is the low 32
// bits of the global token index d L + l and `token_hi` its high bits (0 for
// any corpus under 2^32 tokens). The last word, 3, keeps the stream apart
// from the other kernels' (0, 1 and 2).
__device__ __forceinline__ uint4 hdp_words(uint32_t seed, uint32_t token, uint32_t group, uint32_t token_hi) {
  return philox4x32_10(make_uint4(token, group, token_hi, 3u), make_uint2(seed, 0x5EEDu));
}

}  // namespace philox
