// Flash decode over the two-tier GEARL compressed KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel gear_tpu/kernels/decode.py::_decode_kernel
// (reached through decode_attention / attend_fused) for GEARL caches:
// byte-strided 2/4/8-bit codes, per-(block, channel) K scales, per-(token,
// d-group) V scales, bf16 low-rank error bases, the bf16 residual tier, and
// the comp_len / resid_len / pad_start masks. It computes what
// gear_tpu_torch/cache.py::attend computes. COO outliers, int8 bases and the
// sliding window are not handled here (the wrapper refuses such caches).
//
// Bound on the card: bytes. Per decode step a layer's compressed cache is
// read once (codes at bits/16 of the bf16 cache, plus sidebands and bases),
// while the arithmetic is a few multiply-adds per stored element, far below
// the H100's ~295 operations per byte.
//
// Design (a simple kernel that is right first):
//  * grid (BH rows, 1 + token splits). Split 0 attends the residual tier;
//    each other block walks its split's tiles of 128 tokens (one thread per
//    token) below comp_len. A second tiny kernel merges the splits' (max,
//    sum, acc) states, flash-decoding style. The wrapper picks enough
//    splits for many blocks per SM, which hides the load latency.
//  * K scores: per quant block the scale folds into q once
//    (qs = q * scale), and q.mn and q.P_blk are reduced once; each thread then
//    unpacks its token's code words straight from device memory (consecutive
//    tokens are consecutive addresses in the [D/fpi, T] layout) and adds
//    qs.code + q.mn + (q.P_blk).Q[:, t].
//  * PV: the tile's V code words, V scales and Q columns are staged in
//    shared memory; p * vscale is formed per token, and sum p * vmn and
//    sum p * Q[:, t] per block are reduced once, so one thread per channel
//    accumulates (p * vscale) * code per token plus a few per-tile terms.
//  * float32 throughout; online softmax with -inf for masked tokens.
// Faster forms (wgmma products, TMA staging, reading the shared prefill P
// once) are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;  // tokens per tile == threads per block
constexpr int kWarps = kTile / 32;
typedef __nv_bfloat16 bf16;

struct Params {
  const float* q;          // [BH, GQ, D], sm_scale folded in
  const int32_t* k_codes;  // [BH, D/fpi, T]
  const bf16* k_scale;     // [BH, NB, D]
  const bf16* k_mn;        // [BH, NB, D]
  const bf16* kpt;         // [BH, NB, R, D]
  const bf16* kqt;         // [BH, R, T]
  const int32_t* v_codes;  // [BH, D/fpi, T]
  const bf16* v_scale;     // [BH, NGV, T]
  const bf16* v_mn;        // [BH, NGV, T]
  const bf16* vpt;         // [BH, NB, R, D]
  const bf16* vqt;         // [BH, R, T]
  const bf16* k_resid;     // [BH, G, D]
  const bf16* v_resid;     // [BH, G, D]
  const int32_t* pad_start;  // [B]
  float* part_acc;         // [BH, NS, GQ, D]
  float* part_ml;          // [BH, NS, GQ, 2]
  int hkv, d, t, nb, r, group, v_group;
  int comp_len, resid_len, n_split, tiles_per_split;
};

__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
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

size_t split_smem_bytes(int gq, int d, int bits, int r, int group,
                        int v_group) {
  const int nbt = kTile / group;
  const int ngv = d / v_group;
  const int wd = d * bits / 32;
  size_t floats = 0;
  floats += gq * d;                 // q_s
  floats += nbt * gq * d;           // qs_s
  floats += nbt * gq;               // qm_s
  floats += nbt * gq * r;           // qp_s
  floats += gq * kTile;             // p_s
  floats += 2 * ngv * kTile;        // vs_s, vm_s
  floats += r * kTile;              // vq_s
  floats += nbt * r * d;            // vp_s
  floats += 2 * gq * kWarps;        // red_max, red_sum
  floats += gq * ngv * kTile;       // pvs_s
  floats += gq * ngv;               // pvm_s
  floats += gq * nbt * r;           // wv_s
  floats += wd * (kTile + 1);       // vw_s (int32)
  return floats * sizeof(float);
}

template <int BITS, int GQ>
__global__ void __launch_bounds__(kTile) decode_split_kernel(Params p) {
  extern __shared__ float smem[];
  constexpr int VPB = 8 / BITS;
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  const int bh = blockIdx.x, split = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int D = p.d, T = p.t, R = p.r, G = p.group, NB = p.nb;
  const int WD = D * BITS / 32;
  const int NGV = D / p.v_group;
  const int NBT = kTile / G;
  const int NS = p.n_split + 1;
  const int VWS = kTile + 1;  // padded stride: no bank conflicts in PV

  float* q_s = smem;
  float* qs_s = q_s + GQ * D;
  float* qm_s = qs_s + NBT * GQ * D;
  float* qp_s = qm_s + NBT * GQ;
  float* p_s = qp_s + NBT * GQ * R;
  float* vs_s = p_s + GQ * kTile;
  float* vm_s = vs_s + NGV * kTile;
  float* vq_s = vm_s + NGV * kTile;
  float* vp_s = vq_s + R * kTile;
  float* red_max = vp_s + NBT * R * D;
  float* red_sum = red_max + GQ * kWarps;
  float* pvs_s = red_sum + GQ * kWarps;
  float* pvm_s = pvs_s + GQ * NGV * kTile;
  float* wv_s = pvm_s + GQ * NGV;
  int32_t* vw_s = reinterpret_cast<int32_t*>(wv_s + GQ * NBT * R);

  for (int i = tid; i < GQ * D; i += kTile)
    q_s[i] = p.q[static_cast<size_t>(bh) * GQ * D + i];

  float m_run[GQ], l_run[GQ], acc[GQ], alpha[GQ], s[GQ];
#pragma unroll
  for (int g = 0; g < GQ; ++g) {
    m_run[g] = -INFINITY;
    l_run[g] = 0.0f;
    acc[g] = 0.0f;
  }

  // This thread's channel in the PV phase.
  const bool has_d = tid < D;
  const int stride_f = D / VPB;
  int w_me = 0, shift_me = 0, grp_me = 0;
  if (has_d) {
    const int f = tid / stride_f, c = tid % stride_f;
    w_me = c / 4;
    shift_me = 8 * (c % 4) + f * BITS;
    grp_me = tid / p.v_group;
  }

  // Split 0 attends the residual tier (scheduled first: it is the longest
  // single block); splits 1.. walk the compressed prefix.
  if (split > 0) {
    const int csplit = split - 1;
    const size_t bh_nb = static_cast<size_t>(bh) * NB;
    const int32_t* kc_row = p.k_codes + static_cast<size_t>(bh) * WD * T;
    const int32_t* vc_row = p.v_codes + static_cast<size_t>(bh) * WD * T;
    const int ntiles = (p.comp_len + kTile - 1) / kTile;
    const int tile_lo = csplit * p.tiles_per_split;
    const int tile_hi = min(ntiles, tile_lo + p.tiles_per_split);
    const int pad = p.pad_start[bh / p.hkv];
    for (int tile = tile_lo; tile < tile_hi; ++tile) {
      const int t0 = tile * kTile;
      const int n_valid = min(kTile, p.comp_len - t0);
      if (t0 + n_valid <= pad) continue;  // wholly left of the padding
      __syncthreads();  // q_s ready; previous tile's smem reads done
      const int blk0 = t0 / G;

      // K folds per quant block of the tile.
      for (int i = tid; i < NBT * GQ * D; i += kTile) {
        const int j = i / (GQ * D), rem = i % (GQ * D);
        const int g = rem / D, dd = rem % D;
        const int blk = blk0 + j;
        qs_s[i] = blk < NB ? q_s[g * D + dd] * ld(p.k_scale + (bh_nb + blk) * D + dd)
                           : 0.0f;
      }
      for (int item = warp; item < NBT * GQ * (1 + R); item += kWarps) {
        const int j = item / (GQ * (1 + R)), rem = item % (GQ * (1 + R));
        const int g = rem / (1 + R), which = rem % (1 + R);
        const int blk = blk0 + j;
        float acc_d = 0.0f;
        if (blk < NB) {
          const bf16* src =
              which == 0 ? p.k_mn + (bh_nb + blk) * D
                         : p.kpt + ((bh_nb + blk) * R + (which - 1)) * D;
#pragma unroll 4
          for (int dd = lane; dd < D; dd += 32) acc_d += q_s[g * D + dd] * ld(src + dd);
        }
        acc_d = warp_sum(acc_d);
        if (lane == 0) {
          if (which == 0)
            qm_s[j * GQ + g] = acc_d;
          else
            qp_s[(j * GQ + g) * R + which - 1] = acc_d;
        }
      }
      // Stage the tile's V side (unrolled: several loads in flight).
#pragma unroll 4
      for (int i = tid; i < WD * kTile; i += kTile) {
        const int w = i / kTile, tt = i % kTile;
        vw_s[w * VWS + tt] =
            tt < n_valid ? vc_row[static_cast<size_t>(w) * T + t0 + tt] : 0;
      }
      for (int i = tid; i < NGV * kTile; i += kTile) {
        const int g = i / kTile, tt = i % kTile;
        const size_t off = (static_cast<size_t>(bh) * NGV + g) * T + t0 + tt;
        vs_s[i] = tt < n_valid ? ld(p.v_scale + off) : 0.0f;
        vm_s[i] = tt < n_valid ? ld(p.v_mn + off) : 0.0f;
      }
#pragma unroll 4
      for (int i = tid; i < R * kTile; i += kTile) {
        const int rr = i / kTile, tt = i % kTile;
        vq_s[i] = tt < n_valid
                      ? ld(p.vqt + (static_cast<size_t>(bh) * R + rr) * T + t0 + tt)
                      : 0.0f;
      }
#pragma unroll 4
      for (int i = tid; i < NBT * R * D; i += kTile) {
        const int j = i / (R * D), rem = i % (R * D);
        const int blk = blk0 + j;
        vp_s[i] = blk < NB ? ld(p.vpt + (bh_nb + blk) * R * D + rem) : 0.0f;
      }
      __syncthreads();

      // Scores: one thread per token.
      const int t = t0 + tid;
      const bool valid = tid < n_valid && t >= pad;
#pragma unroll
      for (int g = 0; g < GQ; ++g) s[g] = 0.0f;
      if (valid) {
        const int j = tid / G;
        const float* qsj = qs_s + j * GQ * D;
        for (int w0 = 0; w0 < WD; w0 += 4) {
          uint32_t words[4];  // four code words in flight at once
#pragma unroll
          for (int i = 0; i < 4; ++i)
            words[i] = w0 + i < WD ? static_cast<uint32_t>(
                kc_row[static_cast<size_t>(w0 + i) * T + t]) : 0u;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (w0 + i >= WD) break;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const uint32_t byte = (words[i] >> (8 * k)) & 0xFFu;
              const int c = 4 * (w0 + i) + k;
#pragma unroll
              for (int f = 0; f < VPB; ++f) {
                const float code =
                    static_cast<float>((byte >> (f * BITS)) & MASK);
                const int ch = c + f * stride_f;
#pragma unroll
                for (int g = 0; g < GQ; ++g) s[g] += qsj[g * D + ch] * code;
              }
            }
          }
        }
#pragma unroll
        for (int g = 0; g < GQ; ++g) s[g] += qm_s[j * GQ + g];
        for (int rr = 0; rr < R; ++rr) {
          const float kq = ld(p.kqt + (static_cast<size_t>(bh) * R + rr) * T + t);
#pragma unroll
          for (int g = 0; g < GQ; ++g) s[g] += qp_s[(j * GQ + g) * R + rr] * kq;
        }
      }
      softmax_tile<GQ>(s, valid, p_s, red_max, red_sum, m_run, l_run, alpha);

      // PV folds: p * vscale per (token, d-group); sum_t p * vmn per
      // d-group; sum_t p * Q[r, t] per quant block (the low-rank term
      // then costs R multiply-adds per channel per block, not per token).
      for (int i = tid; i < GQ * NGV * kTile; i += kTile) {
        const int g = i / (NGV * kTile), rem = i % (NGV * kTile);
        pvs_s[i] = p_s[g * kTile + rem % kTile] * vs_s[rem];
      }
      for (int item = warp; item < GQ * (NGV + NBT * R); item += kWarps) {
        const int g = item / (NGV + NBT * R), rem = item % (NGV + NBT * R);
        float part = 0.0f;
        if (rem < NGV) {
          for (int tt = lane; tt < kTile; tt += 32)
            part += p_s[g * kTile + tt] * vm_s[rem * kTile + tt];
        } else {
          const int j = (rem - NGV) / R, rr = (rem - NGV) % R;
          for (int tt = j * G + lane; tt < (j + 1) * G; tt += 32)
            part += p_s[g * kTile + tt] * vq_s[rr * kTile + tt];
        }
        part = warp_sum(part);
        if (lane == 0) {
          if (rem < NGV)
            pvm_s[g * NGV + rem] = part;
          else
            wv_s[g * NBT * R + rem - NGV] = part;
        }
      }
      __syncthreads();

      // PV: one thread per channel.
      if (has_d) {
#pragma unroll
        for (int g = 0; g < GQ; ++g) {
          float a = acc[g] * alpha[g] + pvm_s[g * NGV + grp_me];
          for (int i = 0; i < NBT * R; ++i)
            a += wv_s[g * NBT * R + i] * vp_s[i * D + tid];
          acc[g] = a;
        }
#pragma unroll 4
        for (int tt = 0; tt < n_valid; ++tt) {
          const uint32_t word = static_cast<uint32_t>(vw_s[w_me * VWS + tt]);
          const float code = static_cast<float>((word >> shift_me) & MASK);
#pragma unroll
          for (int g = 0; g < GQ; ++g)
            acc[g] += pvs_s[(g * NGV + grp_me) * kTile + tt] * code;
        }
      }
    }
  } else {
    // Residual tier: at most `group` <= kTile bf16 tokens. One warp per
    // token for the scores (lanes over channels, coalesced), staged in p_s.
    __syncthreads();  // q_s ready
    const int n_valid = p.resid_len;
    for (int tt = warp; tt < n_valid; tt += kWarps) {
      const bf16* kr = p.k_resid + (static_cast<size_t>(bh) * G + tt) * D;
      float part[GQ];
#pragma unroll
      for (int g = 0; g < GQ; ++g) part[g] = 0.0f;
      for (int dd = lane; dd < D; dd += 32) {
        const float kv = ld(kr + dd);
#pragma unroll
        for (int g = 0; g < GQ; ++g) part[g] += q_s[g * D + dd] * kv;
      }
#pragma unroll
      for (int g = 0; g < GQ; ++g) {
        const float tot = warp_sum(part[g]);
        if (lane == 0) p_s[g * kTile + tt] = tot;
      }
    }
    __syncthreads();
    const bool valid = tid < n_valid;
#pragma unroll
    for (int g = 0; g < GQ; ++g) s[g] = valid ? p_s[g * kTile + tid] : 0.0f;
    // (softmax_tile syncs before it overwrites p_s)
    softmax_tile<GQ>(s, valid, p_s, red_max, red_sum, m_run, l_run, alpha);
    if (has_d) {
#pragma unroll 4
      for (int tt = 0; tt < n_valid; ++tt) {
        const float v = ld(p.v_resid + (static_cast<size_t>(bh) * G + tt) * D + tid);
#pragma unroll
        for (int g = 0; g < GQ; ++g) acc[g] += p_s[g * kTile + tt] * v;
      }
    }
  }

  const size_t slot = static_cast<size_t>(bh) * NS + split;
  if (tid == 0) {
#pragma unroll
    for (int g = 0; g < GQ; ++g) {
      p.part_ml[(slot * GQ + g) * 2] = m_run[g];
      p.part_ml[(slot * GQ + g) * 2 + 1] = l_run[g];
    }
  }
  if (has_d) {
#pragma unroll
    for (int g = 0; g < GQ; ++g) p.part_acc[(slot * GQ + g) * D + tid] = acc[g];
  }
}

// Merge the splits' (m, l, acc) states: out = sum acc_i e^{m_i - M} /
// sum l_i e^{m_i - M}. grid (BH, GQ), one thread per channel.
__global__ void decode_merge_kernel(const float* __restrict__ part_acc,
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

template <int BITS, int GQ>
cudaError_t launch_split(const Params& p, int bh, size_t smem,
                         cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_split_kernel<BITS, GQ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  dim3 grid(bh, p.n_split + 1);
  decode_split_kernel<BITS, GQ><<<grid, kTile, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int BITS>
cudaError_t launch_bits(const Params& p, int bh, int gq, size_t smem,
                        cudaStream_t stream) {
  switch (gq) {
    case 1: return launch_split<BITS, 1>(p, bh, smem, stream);
    case 2: return launch_split<BITS, 2>(p, bh, smem, stream);
    case 4: return launch_split<BITS, 4>(p, bh, smem, stream);
    case 8: return launch_split<BITS, 8>(p, bh, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int gear_decode_attention(
    const float* q, const int32_t* k_codes, const void* k_scale,
    const void* k_mn, const void* kpt, const void* kqt, const int32_t* v_codes,
    const void* v_scale, const void* v_mn, const void* vpt, const void* vqt,
    const void* k_resid, const void* v_resid, const int32_t* pad_start,
    float* part_acc, float* part_ml, float* out, int bh, int hkv, int gq,
    int d, int t, int nb, int r, int group, int v_group, int bits,
    int comp_len, int resid_len, int n_split, int tiles_per_split,
    cudaStream_t stream) {
  if (kTile % group != 0 || d > kTile || group > kTile) return cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k_codes = k_codes;
  p.k_scale = static_cast<const bf16*>(k_scale);
  p.k_mn = static_cast<const bf16*>(k_mn);
  p.kpt = static_cast<const bf16*>(kpt);
  p.kqt = static_cast<const bf16*>(kqt);
  p.v_codes = v_codes;
  p.v_scale = static_cast<const bf16*>(v_scale);
  p.v_mn = static_cast<const bf16*>(v_mn);
  p.vpt = static_cast<const bf16*>(vpt);
  p.vqt = static_cast<const bf16*>(vqt);
  p.k_resid = static_cast<const bf16*>(k_resid);
  p.v_resid = static_cast<const bf16*>(v_resid);
  p.pad_start = pad_start;
  p.part_acc = part_acc;
  p.part_ml = part_ml;
  p.hkv = hkv;
  p.d = d;
  p.t = t;
  p.nb = nb;
  p.r = r;
  p.group = group;
  p.v_group = v_group;
  p.comp_len = comp_len;
  p.resid_len = resid_len;
  p.n_split = n_split;
  p.tiles_per_split = tiles_per_split;
  const size_t smem = split_smem_bytes(gq, d, bits, r, group, v_group);
  cudaError_t e;
  switch (bits) {
    case 2: e = launch_bits<2>(p, bh, gq, smem, stream); break;
    case 4: e = launch_bits<4>(p, bh, gq, smem, stream); break;
    case 8: e = launch_bits<8>(p, bh, gq, smem, stream); break;
    default: e = cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(bh, gq);
  decode_merge_kernel<<<grid, d, 0, stream>>>(part_acc, part_ml, out,
                                              n_split + 1, gq, d);
  return static_cast<int>(cudaGetLastError());
}
