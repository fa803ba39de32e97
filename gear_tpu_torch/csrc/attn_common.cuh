// Pieces shared by the two flash-decode kernels (decode.cu over the
// compressed cache, flash.cu over the raw bf16 cache): asynchronous copies
// into shared memory, warp reductions, the online-softmax update over one
// tile of 128 tokens (one thread per token), and the kernel that merges the
// token splits' (max, sum, acc) states.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;  // tokens per tile == threads per block
constexpr int kWarps = kTile / 32;
typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}

// Asynchronous copies from device memory into shared memory (cp.async, sm_80
// and later): 16 bytes through L2 only, or 4 bytes; both addresses aligned
// to the size. A thread's copies issued since its last commit form one
// group; wait<N> returns once at most N of its groups are still in flight,
// and a __syncthreads() after it makes every thread's landed copies visible.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Online-softmax update over one tile: thread `tid` holds its token's
// scores s[GQ]. Writes p into p_s [GQ][kTile] and rescales the running
// (m, l); alpha is the factor the caller applies to its accumulators.
template <int GQ>
__device__ __forceinline__ void softmax_tile(const float* s, bool valid,
                                             float* p_s, float* red_max,
                                             float* red_sum, float* m_run,
                                             float* l_run, float* alpha) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int g = 0; g < GQ; ++g) {
    const float v = warp_max(valid ? s[g] : -INFINITY);
    if (lane == 0) red_max[g * kWarps + warp] = v;
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < GQ; ++g) {
    float tmax = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) tmax = fmaxf(tmax, red_max[g * kWarps + w]);
    const float m_new = fmaxf(m_run[g], tmax);
    alpha[g] = m_new == -INFINITY ? 1.0f : expf(m_run[g] - m_new);
    const float pv = valid ? expf(s[g] - m_new) : 0.0f;
    p_s[g * kTile + tid] = pv;
    const float ps = warp_sum(pv);
    if (lane == 0) red_sum[g * kWarps + warp] = ps;
    m_run[g] = m_new;
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < GQ; ++g) {
    float tsum = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) tsum += red_sum[g * kWarps + w];
    l_run[g] = l_run[g] * alpha[g] + tsum;
  }
}

// One split's state: part_acc [BH, NS, GQ, D], part_ml [BH, NS, GQ, 2].
template <int GQ>
__device__ __forceinline__ void store_partial(float* part_acc, float* part_ml,
                                              size_t slot, int d, bool has_d,
                                              const float* m_run,
                                              const float* l_run,
                                              const float* acc) {
  const int tid = threadIdx.x;
  if (tid == 0) {
#pragma unroll
    for (int g = 0; g < GQ; ++g) {
      part_ml[(slot * GQ + g) * 2] = m_run[g];
      part_ml[(slot * GQ + g) * 2 + 1] = l_run[g];
    }
  }
  if (has_d) {
#pragma unroll
    for (int g = 0; g < GQ; ++g) part_acc[(slot * GQ + g) * d + tid] = acc[g];
  }
}

// Merge the splits' (m, l, acc) states: out = sum acc_i e^{m_i - M} /
// sum l_i e^{m_i - M}. grid (BH, GQ), one thread per channel.
__global__ void attn_merge_kernel(const float* __restrict__ part_acc,
                                  const float* __restrict__ part_ml,
                                  float* __restrict__ out, int ns, int gq,
                                  int d) {
  const int bh = blockIdx.x, g = blockIdx.y;
  float m_tot = -INFINITY;
  for (int i = 0; i < ns; ++i)
    m_tot = fmaxf(m_tot, part_ml[((static_cast<size_t>(bh) * ns + i) * gq + g) * 2]);
  for (int dd = threadIdx.x; dd < d; dd += blockDim.x) {
    float num = 0.0f, den = 0.0f;
    if (m_tot != -INFINITY) {
      for (int i = 0; i < ns; ++i) {
        const size_t slot = (static_cast<size_t>(bh) * ns + i) * gq + g;
        const float w = expf(part_ml[slot * 2] - m_tot);
        num += part_acc[slot * d + dd] * w;
        den += part_ml[slot * 2 + 1] * w;
      }
    }
    out[(static_cast<size_t>(bh) * gq + g) * d + dd] = den > 0.0f ? num / den : 0.0f;
  }
}

}  // namespace
