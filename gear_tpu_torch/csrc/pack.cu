// Fused group min/max + quantize + byte-strided bit-pack, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels gear_tpu/kernels/pack.py::_token_kernel
// (V layout: per-token groups of `v_group` channels; B3) and
// ::_channel_kernel (K layout: per-channel groups of `group` tokens; B2).
// Both emit packed int32 words plus float32 scale/min in one read of the
// block, so the int32 code tensor never reaches device memory.
//
// Byte-strided layout (gear_tpu/core/quant.py::pack_codes_bytestrided):
// word w of a row holds bytes 4w..4w+3 little-endian; byte c holds the
// codes of channels c + m * D / vpb at bit m * bits (vpb = 8 / bits).
//
// Bit-exactness with the plain version and with gear_tpu: the step is
// (max - min) times the float32 reciprocal of the top code (what the JAX
// package computes under jit), the code is rint of the IEEE quotient
// (x - min) / step (no --use_fast_math; rintf rounds half to even like
// jnp.round and torch.round, not roundf), clipped after rounding, with the
// same `scale == 0 -> 1` guard for constant groups. bf16 input widens to
// float32 exactly, so it packs to the same words and sidebands.
//
// Bound on the card: bytes. Each element is read once (4 bytes as float32,
// 2 as bf16) and written back as bits/32 of a word, with ~10 operations per
// element, far below the H100's 295 operations per byte.
// Token kernel (B3), one pass: a warp per row, lane l holding channels
// 4l..4l+3 from one 16-byte (float32) or 8-byte (bf16) load; group min and
// max by xor-shuffles among the lanes of a group (a segmented scan where
// groups do not fall on lane boundaries), no shared memory, no barrier; the
// code from the product with the step's reciprocal, the IEEE quotient
// deciding near a half-integer; word w gathers its fields from lanes
// w + f * WD, one shuffle a field; each warp walks groups of rows
// grid-stride and loads the next group while it packs this one. Channel
// kernel (B2), as first written: a block stages its rows in shared memory
// with coalesced loads, reduces min/max there, and writes whole words with
// consecutive threads on consecutive words (its redesign is later work).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // the channel kernel's block
constexpr int kTokWarps = 8;   // the token kernel's block: 8 warps

// Rows a warp of the token kernel packs at a time (and loads ahead): 1 KB
// of input, 2 rows of float32 or 4 of bf16 at D = 128. More rows a warp
// cost registers and so warps an SM: 4 float32 rows ran 17% slower.
template <typename T>
__host__ __device__ constexpr int tok_rows() {
  return 8 / static_cast<int>(sizeof(T));
}

__device__ __forceinline__ uint32_t quant_code(float x, float mn, float scale,
                                               float levels) {
  const float safe = scale == 0.0f ? 1.0f : scale;
  float q = rintf((x - mn) / safe);
  q = fminf(fmaxf(q, 0.0f), levels);
  return static_cast<uint32_t>(q);
}

// quant_code without the division, for the token kernel. The step's
// reciprocal (rcp.approx, within 2 ulp for a step far from the ends of the
// float range; nan otherwise) times x - mn lies within 6e-5 of the IEEE
// quotient (which is at most levels (1 + 2^-21): the step is (max - min)
// / levels up to two roundings), so it rounds to the same integer unless
// it sits within 1e-3 of a half-integer; there, and for a nan, the IEEE
// quotient decides: a branch almost no element takes. Adding 1.5 * 2^23
// rounds half to even, as rintf does, and leaves the code in the low byte.
// With quant_code's division per element instead, the kernel ran 30-37%
// slower on the H100 (PERF.md); tests/test_torch_cuda.py holds it to
// the IEEE quotient at and next to half-integers.
__device__ __forceinline__ float fast_rcp(float x) {
  if (!(x > 1e-30f && x < 1e30f)) return __int_as_float(0x7FFFFFFF);
  float r;
  asm("rcp.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ uint32_t code_of(float num, float safe, float inv,
                                            float levels) {
  const float y = num * inv;
  const float m = y + 12582912.0f;
  if (__builtin_expect(!(fabsf(y - (m - 12582912.0f)) < 0.499f), 0)) {
    const float q = rintf(__fdiv_rn(num, safe));
    return static_cast<uint32_t>(fminf(fmaxf(q, 0.0f), levels));
  }
  return __float_as_uint(m) & 0xFFu;
}

// The four consecutive elements of a row that a lane holds, as floats
// (bf16 -> f32 is exact: the bits move up 16 places).
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(a.x << 16);
  v[1] = __uint_as_float(a.x & 0xFFFF0000u);
  v[2] = __uint_as_float(a.y << 16);
  v[3] = __uint_as_float(a.y & 0xFFFF0000u);
}

// x [M, D] f32 or bf16 -> words [M, D*bits/32] i32, scale/mn [M, D/v_group]
// f32. A warp per row: lane l holds channels 4l .. 4l + 3 (D / 4 lanes; the
// others idle). Each warp walks groups of tok_rows rows, grid-stride, and
// loads the next group while it packs this one.
template <typename T, int BITS, bool LANE_GROUPS>
__global__ void __launch_bounds__(kTokWarps * 32)
token_kernel(const T* __restrict__ x, int32_t* __restrict__ words,
             float* __restrict__ scale_out, float* __restrict__ mn_out,
             int64_t m, int d, int v_group) {
  constexpr int VPB = 8 / BITS;
  constexpr float kLevels = static_cast<float>((1 << BITS) - 1);
  const float inv_levels = 1.0f / kLevels;
  const unsigned full = 0xFFFFFFFFu;
  const int lane = threadIdx.x & 31;
  const bool active = 4 * lane < d;
  const int ngv = d / v_group, wd = d * BITS / 32;
  // this lane's field and word of the byte-strided layout: channel c sits
  // in word (c % stride) / 4, byte c % 4, field c / stride; a lane's four
  // channels share word and field (stride = D / VPB is a multiple of 4)
  const int stride = d / VPB;
  const int field = 4 * lane / stride;
  // LANE_GROUPS: v_group is 4 x a power of two, so a group is `span`
  // aligned lanes
  const int span = v_group / 4;
  // per element of the lane, once (the integer divisions stay out of the
  // row loop): its group, whether it opens the group, whether it continues
  // the previous lane's last group, and where its group ends (lane, slot)
  int grp[4], src[4], slot[4];
  bool opens[4], cont[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = 4 * lane + i;
    grp[i] = c / v_group;
    opens[i] = c % v_group == 0;
    cont[i] = lane > 0 && grp[i] == (4 * lane - 1) / v_group;
    const int last = (grp[i] + 1) * v_group - 1;
    src[i] = min(last / 4, 31);
    slot[i] = last % 4;
  }
  // first lane of the group of this lane's last element
  const int seg = grp[3] * v_group / 4;

  constexpr int kTokRows = tok_rows<T>();
  const int64_t n_groups = (m + kTokRows - 1) / kTokRows;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kTokWarps;
  int64_t grp0 = static_cast<int64_t>(blockIdx.x) * kTokWarps + threadIdx.x / 32;
  float v[kTokRows][4], nv[kTokRows][4] = {};
  auto load = [&](int64_t gr, float (&to)[kTokRows][4]) {
#pragma unroll
    for (int r = 0; r < kTokRows; ++r) {
      const int64_t row = gr * kTokRows + r;
      if (active && row < m) {
        load4(x + row * d + 4 * lane, to[r]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) to[r][i] = 0.0f;
      }
    }
  };
  if (grp0 < n_groups) load(grp0, v);
  for (; grp0 < n_groups; grp0 += step) {
    if (grp0 + step < n_groups) load(grp0 + step, nv);
#pragma unroll
    for (int r = 0; r < kTokRows; ++r) {
      const int64_t row = grp0 * kTokRows + r;
      // (min, max) of each element's group
      float lo[4], hi[4];
      if constexpr (LANE_GROUPS) {
        // xor-shuffles among a group's lanes
        float a = fminf(fminf(v[r][0], v[r][1]), fminf(v[r][2], v[r][3]));
        float b = fmaxf(fmaxf(v[r][0], v[r][1]), fmaxf(v[r][2], v[r][3]));
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          if (o < span) {  // the same for the whole warp
            a = fminf(a, __shfl_xor_sync(full, a, o));
            b = fmaxf(b, __shfl_xor_sync(full, b, o));
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          lo[i] = a;
          hi[i] = b;
        }
      } else {
        // any other group width: a segmented scan over the row, element by
        // element within the lane, then lane by lane; a group's value is the
        // scan's at its last element
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool head = i == 0 || opens[i];
          lo[i] = head ? v[r][i] : fminf(lo[i - 1], v[r][i]);
          hi[i] = head ? v[r][i] : fmaxf(hi[i - 1], v[r][i]);
        }
        float a = lo[3], b = hi[3];
        for (int o = 1; o < 32; o <<= 1) {
          const float ua = __shfl_up_sync(full, a, o);
          const float ub = __shfl_up_sync(full, b, o);
          if (lane - o >= seg) {
            a = fminf(a, ua);
            b = fmaxf(b, ub);
          }
        }
        // the scan up to the previous lane continues this lane's first group
        const float ca = __shfl_up_sync(full, a, 1);
        const float cb = __shfl_up_sync(full, b, 1);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (cont[i]) {
            lo[i] = fminf(lo[i], ca);
            hi[i] = fmaxf(hi[i], cb);
          }
        }
        // broadcast each group's value from its last element
        float glo[4], ghi[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float ta = __shfl_sync(full, lo[k], src[i]);
            const float tb = __shfl_sync(full, hi[k], src[i]);
            if (k == slot[i]) {
              glo[i] = ta;
              ghi[i] = tb;
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          lo[i] = glo[i];
          hi[i] = ghi[i];
        }
      }
      // quantize (as quant_code), and OR this lane's codes into its part of
      // the word
      const bool live = row < m;
      // step, divisor and its reciprocal per group: once a lane when its
      // four elements share one
      float sc[4], safe[4], inv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i == 0 || !LANE_GROUPS) {
          sc[i] = (hi[i] - lo[i]) * inv_levels;
          safe[i] = sc[i] == 0.0f ? 1.0f : sc[i];
          inv[i] = fast_rcp(safe[i]);
        } else {
          sc[i] = sc[0];
          safe[i] = safe[0];
          inv[i] = inv[0];
        }
      }
      uint32_t part = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        part |= code_of(v[r][i] - lo[i], safe[i], inv[i], kLevels)
                << (8 * i + field * BITS);
        if (live && active && opens[i]) {
          scale_out[row * ngv + grp[i]] = sc[i];
          mn_out[row * ngv + grp[i]] = lo[i];
        }
      }
      // word w takes field f from lane w + f * wd: one shuffle per field
      uint32_t word = part;
#pragma unroll
      for (int f = 1; f < VPB; ++f)
        word |= __shfl_down_sync(full, part, f * wd);
      if (live && lane < wd) words[row * wd + lane] = static_cast<int32_t>(word);
    }
#pragma unroll
    for (int r = 0; r < kTokRows; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) v[r][i] = nv[r][i];
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

// One instantiation's launch: as many blocks as are resident on the card at
// once (the warps walk the rows grid-stride), fewer for a short input.
template <typename T, int BITS, bool LANE_GROUPS>
cudaError_t launch_tokens(const void* x, int32_t* words, float* scale,
                          float* mn, int64_t m, int d, int v_group,
                          cudaStream_t stream) {
  static int resident = 0;
  if (!resident) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, token_kernel<T, BITS, LANE_GROUPS>, kTokWarps * 32, 0);
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int64_t per_block = kTokWarps * tok_rows<T>();
  const int64_t need = (m + per_block - 1) / per_block;
  const unsigned blocks = static_cast<unsigned>(need < resident ? need : resident);
  token_kernel<T, BITS, LANE_GROUPS><<<blocks, kTokWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), words, scale, mn, m, d, v_group);
  return cudaGetLastError();
}

template <typename T, int BITS>
cudaError_t launch_tokens(const void* x, int32_t* words, float* scale,
                          float* mn, int64_t m, int d, int v_group,
                          cudaStream_t stream) {
  const int span = v_group / 4;
  if (v_group % 4 == 0 && (span & (span - 1)) == 0)
    return launch_tokens<T, BITS, true>(x, words, scale, mn, m, d, v_group,
                                        stream);
  return launch_tokens<T, BITS, false>(x, words, scale, mn, m, d, v_group,
                                       stream);
}

template <typename T>
cudaError_t launch_tokens(const void* x, int32_t* words, float* scale,
                          float* mn, int64_t m, int d, int bits, int v_group,
                          cudaStream_t stream) {
  switch (bits) {
    case 2: return launch_tokens<T, 2>(x, words, scale, mn, m, d, v_group, stream);
    case 4: return launch_tokens<T, 4>(x, words, scale, mn, m, d, v_group, stream);
    case 8: return launch_tokens<T, 8>(x, words, scale, mn, m, d, v_group, stream);
    default: return cudaErrorInvalidValue;
  }
}

// x: float32 (x_bf16 = 0) or bf16 (x_bf16 = 1), [m, d] contiguous, aligned
// to 16 bytes; d <= 128 a multiple of 32 / bits, v_group a divisor of d.
extern "C" int gear_quant_pack_tokens(const void* x, int x_bf16,
                                      int32_t* words, float* scale, float* mn,
                                      int64_t m, int d, int bits, int v_group,
                                      cudaStream_t stream) {
  if (d <= 0 || d > 128 || v_group <= 0 || d % v_group ||
      (bits != 2 && bits != 4 && bits != 8) || d % (32 / bits) ||
      (reinterpret_cast<uintptr_t>(x) & 15))
    return cudaErrorInvalidValue;
  if (m <= 0) return cudaSuccess;
  return static_cast<int>(
      x_bf16 ? launch_tokens<__nv_bfloat16>(x, words, scale, mn, m, d, bits,
                                            v_group, stream)
             : launch_tokens<float>(x, words, scale, mn, m, d, bits, v_group,
                                    stream));
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
