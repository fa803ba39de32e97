// The quantizer's arithmetic and the packed words' layout, shared by the two
// kernels that write codes: pack.cu (B2 / B3, the prompt pass) and flush.cu
// (a decode step's flush). Both must write the same bits for the same
// group, and decode.cu reads what either wrote.
//
// Step and code (gear_tpu/core/quant.py): the step is (max - min) times the
// float32 reciprocal of the top code (what the JAX package computes under
// jit); a constant group (step 0) divides by 1; the code is rint of the IEEE
// quotient (x - min) / divisor (no --use_fast_math; rintf rounds half to
// even like jnp.round and torch.round, not roundf), clipped after rounding.
//
// Byte-strided layout (gear_tpu/core/quant.py::pack_codes_bytestrided):
// word w of a row holds bytes 4w..4w+3 little-endian; byte c holds the
// codes of channels c + m * D / vpb at bit m * bits (vpb = 8 / bits).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// The top code of a width: 2^bits - 1.
template <int BITS>
__host__ __device__ constexpr float quant_levels() {
  return static_cast<float>((1 << BITS) - 1);
}

// The step of a group whose values lie in [lo, hi].
template <int BITS>
__device__ __forceinline__ float quant_step(float lo, float hi) {
  constexpr float kInvLevels = 1.0f / quant_levels<BITS>();
  return __fmul_rn(__fsub_rn(hi, lo), kInvLevels);
}

// The divisor of a step: 1 where the group is constant.
__device__ __forceinline__ float quant_divisor(float step) {
  return step == 0.0f ? 1.0f : step;
}

// The code of num = x - min: rint(num / divisor), clipped to [0, levels].
__device__ __forceinline__ uint32_t quant_code(float num, float divisor,
                                               float levels) {
  const float q = rintf(__fdiv_rn(num, divisor));
  return static_cast<uint32_t>(fminf(fmaxf(q, 0.0f), levels));
}

// The bit of its byte at which a code of field f starts: byte k of word w
// holds the code of channel 4w + k + f * D / vpb at bit field_bit(f) (and
// so at bit 8k + field_bit(f) of the word), for f < vpb.
template <int BITS>
__host__ __device__ constexpr int field_bit(int f) {
  return f * BITS;
}

}  // namespace
