// Fused group min/max + quantize + byte-strided bit-pack, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels gear_tpu/kernels/pack.py::_token_kernel
// (V layout: per-token groups of `v_group` channels) and ::_channel_kernel
// (K layout: per-channel groups of `group` tokens). Both emit packed int32
// words plus float32 scale/min in one read of the float32 block, so the
// int32 code tensor never reaches device memory.
//
// Byte-strided layout (gear_tpu/core/quant.py::pack_codes_bytestrided):
// word w of a row holds bytes 4w..4w+3 little-endian; byte c holds the
// codes of channels c + m * D / vpb at bit m * bits (vpb = 8 / bits).
//
// Bit-exactness with the plain version and with gear_tpu: the step is
// (max - min) times the float32 reciprocal of the top code (what the JAX
// package computes under jit), the code divides by the step with IEEE
// division (no --use_fast_math), rintf rounds half to even (like jnp.round
// and torch.round; not roundf), clip after rounding, and the same
// `scale == 0 -> 1` guard for constant groups.
//
// Bound on the card: bytes. Each element is read once as float32 and written
// back as bits/32 of a word, with ~10 operations per element, far below the
// H100's 295 operations per byte. Design: one thread block stages its rows
// in shared memory with coalesced loads, reduces min/max there, and writes
// whole words with consecutive threads on consecutive words.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTokenRows = 16;  // rows per block in the token kernel

__device__ __forceinline__ uint32_t quant_code(float x, float mn, float scale,
                                               float levels) {
  const float safe = scale == 0.0f ? 1.0f : scale;
  float q = rintf((x - mn) / safe);
  q = fminf(fmaxf(q, 0.0f), levels);
  return static_cast<uint32_t>(q);
}

// x [M, D] f32 -> words [M, D*bits/32] i32, scale/mn [M, D/v_group] f32.
__global__ void token_kernel(const float* __restrict__ x,
                             int32_t* __restrict__ words,
                             float* __restrict__ scale_out,
                             float* __restrict__ mn_out, int64_t m, int d,
                             int bits, int v_group) {
  extern __shared__ float smem[];
  const int ngv = d / v_group;
  float* xs = smem;                           // [kTokenRows][d]
  float* sc = xs + kTokenRows * d;            // [kTokenRows][ngv]
  float* mns = sc + kTokenRows * ngv;         // [kTokenRows][ngv]
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kTokenRows;
  const int64_t left = m - row0;
  const int rows = left < kTokenRows ? static_cast<int>(left) : kTokenRows;
  const float levels = static_cast<float>((1 << bits) - 1);
  const float inv_levels = 1.0f / levels;

  for (int i = threadIdx.x; i < rows * d; i += blockDim.x)
    xs[i] = x[row0 * d + i];
  __syncthreads();

  for (int i = threadIdx.x; i < rows * ngv; i += blockDim.x) {
    const int r = i / ngv, g = i % ngv;
    const float* seg = xs + r * d + g * v_group;
    float lo = seg[0], hi = seg[0];
    for (int j = 1; j < v_group; ++j) {
      lo = fminf(lo, seg[j]);
      hi = fmaxf(hi, seg[j]);
    }
    const float s = (hi - lo) * inv_levels;
    sc[i] = s;
    mns[i] = lo;
    scale_out[(row0 + r) * ngv + g] = s;
    mn_out[(row0 + r) * ngv + g] = lo;
  }
  __syncthreads();

  const int vpb = 8 / bits;
  const int stride = d / vpb;
  const int wd = d * bits / 32;
  for (int i = threadIdx.x; i < rows * wd; i += blockDim.x) {
    const int r = i / wd, w = i % wd;
    uint32_t word = 0;
    for (int k = 0; k < 4; ++k) {
      const int c = 4 * w + k;
      uint32_t byte = 0;
      for (int f = 0; f < vpb; ++f) {
        const int ch = c + f * stride;
        const int g = ch / v_group;
        byte |= quant_code(xs[r * d + ch], mns[r * ngv + g], sc[r * ngv + g],
                           levels) << (f * bits);
      }
      word |= byte << (8 * k);
    }
    words[(row0 + r) * wd + w] = static_cast<int32_t>(word);
  }
}

// x [NBLK, G, D] f32 -> words [NBLK*G, D*bits/32] i32, scale/mn [NBLK, D] f32.
__global__ void channel_kernel(const float* __restrict__ x,
                               int32_t* __restrict__ words,
                               float* __restrict__ scale_out,
                               float* __restrict__ mn_out, int group, int d,
                               int bits) {
  extern __shared__ float smem[];
  float* xs = smem;               // [group][d]
  float* sc = xs + group * d;     // [d]
  float* mns = sc + d;            // [d]
  const int64_t blk = blockIdx.x;
  const float* xb = x + blk * group * d;
  const float levels = static_cast<float>((1 << bits) - 1);
  const float inv_levels = 1.0f / levels;

  for (int i = threadIdx.x; i < group * d; i += blockDim.x) xs[i] = xb[i];
  __syncthreads();

  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float lo = xs[c], hi = xs[c];
    for (int t = 1; t < group; ++t) {
      lo = fminf(lo, xs[t * d + c]);
      hi = fmaxf(hi, xs[t * d + c]);
    }
    const float s = (hi - lo) * inv_levels;
    sc[c] = s;
    mns[c] = lo;
    scale_out[blk * d + c] = s;
    mn_out[blk * d + c] = lo;
  }
  __syncthreads();

  const int vpb = 8 / bits;
  const int stride = d / vpb;
  const int wd = d * bits / 32;
  for (int i = threadIdx.x; i < group * wd; i += blockDim.x) {
    const int t = i / wd, w = i % wd;
    uint32_t word = 0;
    for (int k = 0; k < 4; ++k) {
      const int c = 4 * w + k;
      uint32_t byte = 0;
      for (int f = 0; f < vpb; ++f) {
        const int ch = c + f * stride;
        byte |= quant_code(xs[t * d + ch], mns[ch], sc[ch], levels)
                << (f * bits);
      }
      word |= byte << (8 * k);
    }
    words[(blk * group + t) * wd + w] = static_cast<int32_t>(word);
  }
}

}  // namespace

extern "C" int gear_quant_pack_tokens(const float* x, int32_t* words,
                                      float* scale, float* mn, int64_t m,
                                      int d, int bits, int v_group,
                                      cudaStream_t stream) {
  const int ngv = d / v_group;
  const size_t smem = sizeof(float) * kTokenRows * (d + 2 * ngv);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(token_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  const int64_t blocks = (m + kTokenRows - 1) / kTokenRows;
  if (blocks > 0)
    token_kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
        x, words, scale, mn, m, d, bits, v_group);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gear_quant_pack_channels(const float* x, int32_t* words,
                                        float* scale, float* mn,
                                        int64_t nblocks, int group, int d,
                                        int bits, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(group) * d + 2 * d);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(channel_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  if (nblocks > 0)
    channel_kernel<<<static_cast<unsigned>(nblocks), kThreads, smem, stream>>>(
        x, words, scale, mn, group, d, bits);
  return static_cast<int>(cudaGetLastError());
}
