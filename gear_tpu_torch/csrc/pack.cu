// Fused group min/max + quantize + byte-strided bit-pack, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels gear_tpu/kernels/pack.py::_token_kernel
// (V layout: per-token groups of `v_group` channels; B3) and
// ::_channel_kernel (K layout: per-channel groups of `group` tokens; B2).
// Both emit packed int32 words plus float32 scale/min in one read of the
// block, so the int32 code tensor never reaches device memory.
//
// The step, the code and the byte-strided layout are quant_common.cuh's,
// which flush.cu shares: bit-exact with the plain version and with
// gear_tpu. bf16 input widens to float32 exactly, so it packs to the same
// words and sidebands.
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
// grid-stride and loads the next group while it packs this one.
// Channel kernel (B2), one read of every input byte: a thread owns one
// output word of a row, so it loads that word's fields (channels
// 4w..4w+3 + f * D / vpb) as one 16-byte (float32) or 8-byte (bf16) load
// each, and consecutive threads hold consecutive words of consecutive rows
// (whole sectors in, one coalesced run of words out). The threads of a
// block cover `slots` rows at a time and walk the group's rows in steps,
// keeping the first BITS steps (32 floats) in registers. Per-channel min and
// max are reduced over a thread's rows in registers, then over the row slots
// through shared memory (one barrier), and a second barrier publishes each
// channel's min, divisor and reciprocal; the codes come from the registers
// with the token kernel's reciprocal and exact fallback, and each thread
// ORs its word together with no shuffle. Blocks walk (group, word chunk)
// units grid-stride, as many as are resident, loading the next unit while
// they pack this one. Rows past the registers' steps are read a second time
// (from L2); rows wider than a block's threads split into chunks of words,
// each a unit of its own. The input is read through its strides (batch,
// head, token), so the model's K needs no contiguous copy first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_common.cuh"

namespace {

constexpr int kTokWarps = 8;   // the token kernel's block: 8 warps

// Rows a warp of the token kernel packs at a time (and loads ahead): 1 KB
// of input, 2 rows of float32 or 4 of bf16 at D = 128. More rows a warp
// cost registers and so warps an SM: 4 float32 rows ran 17% slower.
template <typename T>
__host__ __device__ constexpr int tok_rows() {
  return 8 / static_cast<int>(sizeof(T));
}

// quant_code(x - mn, divisor, levels) without a division per element, for
// both kernels. The step's reciprocal (rcp.approx, within 2 ulp for a step
// far from the ends of the float range; nan otherwise) times x - mn lies
// within 6e-5 of the IEEE quotient (which is at most levels (1 + 2^-21):
// the step is (max - min) / levels up to two roundings), so it rounds to
// the same integer unless it sits within 1e-3 of a half-integer; there, and
// for a nan, the IEEE quotient decides: a branch almost no element takes.
// Adding 1.5 * 2^23 rounds half to even, as rintf does, and leaves the code
// in the low byte.
// With the division per element instead, the token kernel ran 30-37%
// slower on the H100 (PERF.md); tests/test_torch_cuda.py holds both
// kernels to the IEEE quotient at and next to half-integers.
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
  if (__builtin_expect(!(fabsf(y - (m - 12582912.0f)) < 0.499f), 0))
    return quant_code(num, safe, levels);
  return __float_as_uint(m) & 0xFFu;
}

// Four consecutive elements of a row as loaded (one 16-byte or 8-byte
// load) and widened to floats (bf16 -> f32 is exact: the bits move up 16
// places).
template <typename T>
struct Quad;

template <>
struct Quad<float> {
  using Raw = float4;
  __device__ __forceinline__ static void widen(const Raw& a, float* v) {
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  }
};

template <>
struct Quad<__nv_bfloat16> {
  using Raw = uint2;
  __device__ __forceinline__ static void widen(const Raw& a, float* v) {
    v[0] = __uint_as_float(a.x << 16);
    v[1] = __uint_as_float(a.x & 0xFFFF0000u);
    v[2] = __uint_as_float(a.y << 16);
    v[3] = __uint_as_float(a.y & 0xFFFF0000u);
  }
};

template <typename T>
__device__ __forceinline__ typename Quad<T>::Raw load_raw(const T* p) {
  return *reinterpret_cast<const typename Quad<T>::Raw*>(p);
}

template <typename T>
__device__ __forceinline__ void load4(const T* p, float* v) {
  Quad<T>::widen(load_raw(p), v);
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
  constexpr float kLevels = quant_levels<BITS>();
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
      // quantize (as code_of), and OR this lane's codes into its part of
      // the word
      const bool live = row < m;
      // step, divisor and its reciprocal per group: once a lane when its
      // four elements share one
      float sc[4], safe[4], inv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i == 0 || !LANE_GROUPS) {
          sc[i] = quant_step<BITS>(lo[i], hi[i]);
          safe[i] = quant_divisor(sc[i]);
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
                << (8 * i + field_bit<BITS>(field));
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

constexpr int kChanThreads = 256;  // the channel kernel's block: 8 warps

// Words of a row that one unit of the channel kernel covers: the whole row,
// or kChanThreads of them.
__host__ __device__ inline int chan_chunk_words(int wd) {
  return wd < kChanThreads ? wd : kChanThreads;
}

// Shared floats of a channel-kernel block: per row slot the partial min and
// max of the chunk's channels, then each channel's min, divisor and
// reciprocal.
__host__ inline size_t chan_smem_bytes(int d, int bits) {
  const int wc = chan_chunk_words(d * bits / 32);
  const int cw = 4 * (8 / bits) * wc, slots = kChanThreads / wc;
  return sizeof(float) * static_cast<size_t>(2 * slots + 3) * cw;
}

// x [B, H, S, D] f32 or bf16, rows read through the strides s_b, s_h, s_t
// (in elements; the channels contiguous) -> words [B*H*S, D*bits/32] i32,
// scale/mn [B*H*S/G, D] f32. A unit is one group of G rows and one chunk
// of at most kChanThreads words of them. Thread (slot, wl) owns word
// w0 + wl of rows slot, slot + slots, ...: the fields of that word are
// channels 4w + k + f * D / vpb (k < 4, f < vpb), one quad each.
template <typename T, int BITS>
__global__ void __launch_bounds__(kChanThreads)
channel_kernel(const T* __restrict__ x, int32_t* __restrict__ words,
               float* __restrict__ scale_out, float* __restrict__ mn_out,
               int64_t n_bh, int heads, int64_t s_b, int64_t s_h,
               int64_t s_t, int n_grp, int group, int d) {
  constexpr int NQ = 8 / BITS;   // fields of a word: one quad each
  constexpr int RREG = BITS;     // row steps kept in registers: 32 floats
  constexpr float kLevels = quant_levels<BITS>();
  using Raw = typename Quad<T>::Raw;
  extern __shared__ float smem[];
  const int wd = d * BITS / 32, stride = d / NQ;
  const int wc = chan_chunk_words(wd);
  const int nch = (wd + wc - 1) / wc;
  const int slots = kChanThreads / wc;
  const int cw = 4 * NQ * wc;  // channels of a chunk, as [f][wl][k]
  float* plo = smem;
  float* phi = plo + slots * cw;
  float* fmn = phi + slots * cw;
  float* fsafe = fmn + cw;
  float* finv = fsafe + cw;
  const int slot = threadIdx.x / wc, wl = threadIdx.x % wc;
  const int nstep = (group + slots - 1) / slots;
  const int units = static_cast<int>(n_bh * n_grp * nch);

  // unit u: its group's first row, the group's index, its first word (32-bit
  // divisions, once a unit)
  struct Unit {
    const T* rows;
    int blk, w0;
  };
  auto unit_of = [&](int u) {
    const int blk = u / nch;
    const int bh = blk / n_grp;
    return Unit{x + (bh / heads) * s_b + (bh % heads) * s_h +
                    static_cast<int64_t>(blk - bh * n_grp) * group * s_t,
                blk, (u - blk * nch) * wc};
  };
  auto load = [&](const T* rows, int row, int w, Raw (&to)[NQ]) {
    const T* r = rows + row * s_t + 4 * w;
#pragma unroll
    for (int f = 0; f < NQ; ++f) to[f] = load_raw(r + f * stride);
  };
  auto fetch = [&](const Unit& un, Raw (&to)[RREG][NQ]) {
    if (slot >= slots || un.w0 + wl >= wd) return;
#pragma unroll
    for (int s = 0; s < RREG; ++s) {
      const int row = slot + slots * s;
      if (row < group) load(un.rows, row, un.w0 + wl, to[s]);
    }
  };

  // (the launcher starts no more blocks than there are units)
  Raw cur[RREG][NQ], nxt[RREG][NQ];
  Unit cu = unit_of(blockIdx.x), nu = cu;
  fetch(cu, cur);
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const T* rows = cu.rows;
    const int64_t blk = cu.blk;
    const int w0 = cu.w0;
    const int w = w0 + wl;
    const bool act = slot < slots && w < wd;
    // min / max of this thread's rows, per channel of its word
    float lo[NQ][4], hi[NQ][4];
#pragma unroll
    for (int f = 0; f < NQ; ++f)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        lo[f][k] = __int_as_float(0x7F800000);   // +inf
        hi[f][k] = __int_as_float(0xFF800000);   // -inf
      }
    auto take = [&](const Raw (&r)[NQ]) {
#pragma unroll
      for (int f = 0; f < NQ; ++f) {
        float v[4];
        Quad<T>::widen(r[f], v);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          lo[f][k] = fminf(lo[f][k], v[k]);
          hi[f][k] = fmaxf(hi[f][k], v[k]);
        }
      }
    };
    if (act) {
#pragma unroll
      for (int s = 0; s < RREG; ++s)
        if (slot + slots * s < group) take(cur[s]);
      for (int s = RREG; s < nstep; ++s) {
        const int row = slot + slots * s;
        if (row >= group) break;
        Raw r[NQ];
        load(rows, row, w, r);
        take(r);
      }
#pragma unroll
      for (int f = 0; f < NQ; ++f) {
        const int at = slot * cw + f * 4 * wc + 4 * wl;
        *reinterpret_cast<float4*>(plo + at) =
            make_float4(lo[f][0], lo[f][1], lo[f][2], lo[f][3]);
        *reinterpret_cast<float4*>(phi + at) =
            make_float4(hi[f][0], hi[f][1], hi[f][2], hi[f][3]);
      }
    }
    __syncthreads();
    // the next unit's loads fly while this one is reduced and packed
    if (u + gridDim.x < units) {
      nu = unit_of(u + gridDim.x);
      fetch(nu, nxt);
    }
    // per channel over the row slots: min, step, divisor, reciprocal
    for (int lc = threadIdx.x; lc < cw; lc += kChanThreads) {
      const int f = lc / (4 * wc), wq = (lc / 4) % wc, k = lc % 4;
      if (w0 + wq >= wd) continue;
      float a = plo[lc], b = phi[lc];
      for (int s = 1; s < slots; ++s) {
        a = fminf(a, plo[s * cw + lc]);
        b = fmaxf(b, phi[s * cw + lc]);
      }
      const float sc = quant_step<BITS>(a, b);
      const float safe = quant_divisor(sc);
      fmn[lc] = a;
      fsafe[lc] = safe;
      finv[lc] = fast_rcp(safe);
      const int64_t ch = blk * d + 4 * (w0 + wq) + k + f * stride;
      scale_out[ch] = sc;
      mn_out[ch] = a;
    }
    __syncthreads();
    if (act) {
      float mn[NQ][4], inv[NQ][4];
#pragma unroll
      for (int f = 0; f < NQ; ++f) {
        const int at = f * 4 * wc + 4 * wl;
        const float4 m4 = *reinterpret_cast<const float4*>(fmn + at);
        const float4 i4 = *reinterpret_cast<const float4*>(finv + at);
        mn[f][0] = m4.x; mn[f][1] = m4.y; mn[f][2] = m4.z; mn[f][3] = m4.w;
        inv[f][0] = i4.x; inv[f][1] = i4.y; inv[f][2] = i4.z; inv[f][3] = i4.w;
      }
      auto pack = [&](const Raw (&r)[NQ], int row) {
        uint32_t word = 0;
#pragma unroll
        for (int f = 0; f < NQ; ++f) {
          const int at = f * 4 * wc + 4 * wl;
          float v[4];
          Quad<T>::widen(r[f], v);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            // the divisor is read only where the reciprocal cannot decide
            const uint32_t code = code_of(v[k] - mn[f][k], fsafe[at + k],
                                          inv[f][k], kLevels);
            word |= code << (8 * k + field_bit<BITS>(f));
          }
        }
        words[(blk * group + row) * wd + w] = static_cast<int32_t>(word);
      };
#pragma unroll
      for (int s = 0; s < RREG; ++s)
        if (slot + slots * s < group) pack(cur[s], slot + slots * s);
      for (int s = RREG; s < nstep; ++s) {
        const int row = slot + slots * s;
        if (row >= group) break;
        Raw r[NQ];
        load(rows, row, w, r);
        pack(r, row);
      }
    }
    cu = nu;
#pragma unroll
    for (int s = 0; s < RREG; ++s)
#pragma unroll
      for (int f = 0; f < NQ; ++f) cur[s][f] = nxt[s][f];
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

template <typename T, int BITS>
cudaError_t launch_channels(const void* x, int32_t* words, float* scale,
                            float* mn, int64_t n_bh, int heads, int64_t s_b,
                            int64_t s_h, int64_t s_t, int n_grp, int group,
                            int d, cudaStream_t stream) {
  const size_t smem = chan_smem_bytes(d, BITS);
  // blocks resident at once for this shared size (kept per instantiation;
  // recomputed when the size changes)
  static size_t smem_seen = 0;
  static int resident = 0;
  if (smem != smem_seen) {
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          channel_kernel<T, BITS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, channel_kernel<T, BITS>, kChanThreads, smem);
    resident = sms * (per_sm > 0 ? per_sm : 1);
    smem_seen = smem;
  }
  const int wd = d * BITS / 32, wc = chan_chunk_words(wd);
  const int64_t units = n_bh * n_grp * ((wd + wc - 1) / wc);
  const unsigned blocks =
      static_cast<unsigned>(units < resident ? units : resident);
  channel_kernel<T, BITS><<<blocks, kChanThreads, smem, stream>>>(
      static_cast<const T*>(x), words, scale, mn, n_bh, heads, s_b, s_h, s_t,
      n_grp, group, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_channels(const void* x, int32_t* words, float* scale,
                            float* mn, int64_t n_bh, int heads, int64_t s_b,
                            int64_t s_h, int64_t s_t, int n_grp, int group,
                            int d, int bits, cudaStream_t stream) {
  switch (bits) {
    case 2: return launch_channels<T, 2>(x, words, scale, mn, n_bh, heads,
                                         s_b, s_h, s_t, n_grp, group, d,
                                         stream);
    case 4: return launch_channels<T, 4>(x, words, scale, mn, n_bh, heads,
                                         s_b, s_h, s_t, n_grp, group, d,
                                         stream);
    case 8: return launch_channels<T, 8>(x, words, scale, mn, n_bh, heads,
                                         s_b, s_h, s_t, n_grp, group, d,
                                         stream);
    default: return cudaErrorInvalidValue;
  }
}

// x: float32 (x_bf16 = 0) or bf16 (x_bf16 = 1) [n_bh / heads, heads, s_len,
// d] with element strides s_b, s_h, s_t and contiguous channels; every row
// start aligned to 16 bytes; s_len a multiple of group, d of 32 / bits.
extern "C" int gear_quant_pack_channels(const void* x, int x_bf16,
                                        int32_t* words, float* scale,
                                        float* mn, int64_t n_bh, int heads,
                                        int64_t s_b, int64_t s_h, int64_t s_t,
                                        int64_t s_len, int group, int d,
                                        int bits, cudaStream_t stream) {
  const int64_t el = x_bf16 ? 2 : 4;
  if (d <= 0 || group <= 0 || heads <= 0 || n_bh % heads || s_len % group ||
      (bits != 2 && bits != 4 && bits != 8) ||
      d % (32 / bits) || (reinterpret_cast<uintptr_t>(x) & 15) ||
      (s_b * el) % 16 || (s_h * el) % 16 || (s_t * el) % 16)
    return cudaErrorInvalidValue;
  if (n_bh <= 0 || s_len == 0) return cudaSuccess;
  const int wd = d * bits / 32, wc = chan_chunk_words(wd);
  if (n_bh * (s_len / group) * ((wd + wc - 1) / wc) > INT32_MAX)
    return cudaErrorInvalidValue;  // units are counted in 32 bits
  const int n_grp = static_cast<int>(s_len / group);
  return static_cast<int>(
      x_bf16 ? launch_channels<__nv_bfloat16>(x, words, scale, mn, n_bh,
                                              heads, s_b, s_h, s_t, n_grp,
                                              group, d, bits, stream)
             : launch_channels<float>(x, words, scale, mn, n_bh, heads, s_b,
                                      s_h, s_t, n_grp, group, d, bits,
                                      stream));
}
