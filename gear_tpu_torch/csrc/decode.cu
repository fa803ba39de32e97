// Flash decode over the two-tier GEAR compressed KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel gear_tpu/kernels/decode.py::_decode_kernel
// (reached through decode_attention / attend_fused), its whole contract:
// byte-strided 2/4/8-bit codes, per-(block, channel) K scales (per block or,
// for a KCVT prefill, one scale replicated over the prefill's block rows: the
// kernel reads either the same way), per-(token, d-group) V scales, low-rank
// error bases in bf16 or as int8 codes with f32 scales per (block, rank),
// sorted COO outlier deltas with their boundary tables, the bf16 residual
// tier, and the comp_len / resid_len / pad_start masks (the wrapper folds a
// sliding window into pad_start). It computes what
// gear_tpu_torch/cache.py::attend computes.
//
// Bound on the card: bytes. Per decode step a layer's compressed cache is
// read once: codes at bits/16 of the bf16 cache, sidebands, bases (half the
// bytes as int8, plus their scales), and per quant block and tensor the
// outlier entries (4 bytes each: 16-bit index + bf16 delta) and a 512-byte
// boundary table. At Llama/Mistral shapes (group 64, D 128, int4, 256 stored
// entries) the outliers add 3 KB to a block's 9.5 KB. The arithmetic is a few
// multiply-adds per stored element, far below the H100's ~295 operations per
// byte.
//
// Design (a simple kernel that is right first):
//  * grid (BH rows, 1 + token splits). Split 0 attends the residual tier;
//    each other block walks its split's tiles of 128 tokens (one thread per
//    token) below comp_len. A second tiny kernel merges the splits' (max,
//    sum, acc) states, flash-decoding style. The wrapper picks enough
//    splits for many blocks per SM, which hides the load latency.
//  * K scores: per quant block the scale folds into q once
//    (qs = q * scale), and q.mn and q.P_blk are reduced once (int8 bases:
//    times both scales there); each thread then unpacks its token's code
//    words straight from device memory (consecutive tokens are consecutive
//    addresses in the [D/fpi, T] layout) and adds
//    qs.code + q.mn + (q.P_blk).Q[:, t].
//  * PV: the tile's V code words, V scales and Q columns are staged in
//    shared memory; p * vscale is formed per token, and sum p * vmn and
//    sum p * Q[:, t] per block are reduced once, so one thread per channel
//    accumulates (p * vscale) * code per token plus a few per-tile terms.
//  * Outliers: the TPU kernel's one-hot dots and running-sum gathers stand
//    in for a scatter it does not have. Here the entries of the tile's
//    blocks are staged in shared memory; K entries are sorted by token, so
//    the thread of token t walks its own segment bnd[t-1]+1 .. bnd[t] and
//    adds q[d] * delta to its scores; V entries are sorted by channel, so
//    the PV thread of channel d walks its segment and adds p[t] * delta.
//    No atomics, a fixed order. The padding entries up to the stored count
//    (idx 0, delta 0) are the last out_pad entries of token 0's / channel
//    0's segment (the stable sort keeps them behind that key's real
//    entries); those two threads stop before them.
//  * float32 throughout; online softmax with -inf for masked tokens.
// Faster forms (wgmma products, TMA staging, reading the shared prefill P
// once, one score product over a KCVT prefill region) are later work.
//
//
// The paged form (-DGEAR_DECODE_PAGED=1) replaces the TPU kernel
// gear_tpu/kernels/decode.py::decode_attention_paged (its inner `kernel`,
// reached through attend_paged): the same tile body read straight from the
// physical page pool. Row bh is sequence b = bh / hkv, head h = bh % hkv;
// quant block blk of that sequence lives in page
// max(block_table[b][blk / PB], 0) at block offset blk % PB, so a leaf's row
// is (page, h) and its block and token axes are a page's. The indirection is
// per quant block, not per tile: a 128-token tile may span several pages
// (PB * group < 128) or sit inside one; consecutive tokens of a block stay
// consecutive addresses. comp_len and resid_len are each sequence's own,
// read from `lens` in device memory; the grid is sized from a host bound on
// comp_len, and a block whose tiles lie beyond its row's comp_len stores the
// empty state (max -inf, sum 0), which the merge absorbs. A parked row
// (comp_len 0, one zero residual token, a table of -1) attends that one
// token and yields zeros. It computes what
// gear_tpu_torch/paged.py::attend_gathered computes; its bound is bytes too:
// the live blocks of every row, the residual tier, the table row.
//
// Built once per code width and form, -DGEAR_DECODE_BITS=2, 4 and 8 times
// -DGEAR_DECODE_PAGED=0 and 1, into six objects that compile side by side;
// each exports gear_decode_attention_b<bits> or
// gear_decode_attention_paged_b<bits>.
#include "attn_common.cuh"

#ifndef GEAR_DECODE_BITS
#error "compile with -DGEAR_DECODE_BITS=2, 4 or 8 (one object per code width)"
#endif
#ifndef GEAR_DECODE_PAGED
#define GEAR_DECODE_PAGED 0
#endif
#define GEAR_CAT_(a, b) a##b
#define GEAR_CAT(a, b) GEAR_CAT_(a, b)

namespace {

// Shapes as in the dense form; in the paged form read [P, H] for BH, a
// page's blocks PB for NB and a page's tokens PT for T (k/v_resid stay
// [B, H, G, D], which is [BH, G, D]).
struct Params {
  const float* q;          // [BH, GQ, D], sm_scale folded in
  const int32_t* k_codes;  // [BH, D/fpi, T]
  const bf16* k_scale;     // [BH, NB, D]
  const bf16* k_mn;        // [BH, NB, D]
  const void* kpt;         // [BH, NB, R, D] bf16 or int8
  const void* kqt;         // [BH, R, T]
  const int32_t* v_codes;  // [BH, D/fpi, T]
  const bf16* v_scale;     // [BH, NGV, T]
  const bf16* v_mn;        // [BH, NGV, T]
  const void* vpt;         // [BH, NB, R, D]
  const void* vqt;         // [BH, R, T]
  const bf16* k_resid;     // [BH, G, D]
  const bf16* v_resid;     // [BH, G, D]
  const int32_t* pad_start;  // [B]
  const float* kpt_scale;  // [BH, NB, R] (int8 bases only)
  const float* kqt_scale;  // [BH, R, NB]
  const float* vpt_scale;  // [BH, NB, R]
  const float* vqt_scale;  // [BH, R, NB]
  const int32_t* k_out_idx;  // [BH, NB, KO/2]: entry j low, j + KO/2 high
  const bf16* k_out_val;     // [BH, NB, KO] deltas, sorted by token
  const int32_t* k_out_bnd;  // [BH, NB, 128]
  const int32_t* v_out_idx;
  const bf16* v_out_val;     // sorted by channel
  const int32_t* v_out_bnd;
  float* part_acc;         // [BH, NS, GQ, D]
  float* part_ml;          // [BH, NS, GQ, 2]
  const int32_t* lens;         // paged: [B, 3] comp, resid, prefill lengths
  const int32_t* block_table;  // paged: [B, MAXP], entries < 0 unallocated
  int hkv, d, t, nb, r, group, v_group, ko;  // nb: blocks of a sequence
  int out_pad;  // padding entries at the end of segment 0 of every block
  int comp_len, resid_len;  // dense form (the paged form reads `lens`)
  int n_split, tiles_per_split;
  int maxp, pb;  // paged: table width, blocks per page
};

constexpr int kBnd = 128;  // lanes of an outlier boundary table

// One element of a low-rank base: bf16, or an int8 code (scaled by the caller).
template <bool BASE8>
__device__ __forceinline__ float ldb(const void* p, size_t i) {
  if constexpr (BASE8)
    return static_cast<float>(static_cast<const int8_t*>(p)[i]);
  else
    return __bfloat162float(static_cast<const bf16*>(p)[i]);
}

// Entry e of a block's packed outlier indices (KO/2 words in shared memory).
__device__ __forceinline__ int out_idx(const int32_t* words, int e, int koh) {
  const uint32_t w = static_cast<uint32_t>(words[e < koh ? e : e - koh]);
  return static_cast<int>(e < koh ? (w & 0xFFFFu) : (w >> 16));
}

size_t split_smem_bytes(int gq, int d, int bits, int r, int group,
                        int v_group, int ko, bool paged) {
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
  // per block of the tile and per tensor: KO/2 index words, KO deltas, table
  if (ko) floats += 2 * nbt * (ko / 2 + ko + kBnd);
  if (paged) floats += 2 * nbt;     // lrow_s, loff_s (int32)
  return floats * sizeof(float);
}

// Blocks per SM that the register budget is held to. Without it the
// compiler's own choice flips between 96 and 126 registers a thread (five
// or four blocks an SM) from one small edit of this file to the next, and a
// step up cost 17% of the kernel's time on an H100 (GEARL int4, 128 rows of
// 1,930 tokens: 0.080 -> 0.093 ms). The loads of a tile are dependent round
// trips to device memory, so more blocks in flight win over more registers
// a thread.
constexpr int min_blocks(int gq) { return gq == 1 ? 5 : gq == 4 ? 6 : 4; }

template <int BITS, int GQ, bool BASE8, bool PAGED>
__global__ void __launch_bounds__(kTile, min_blocks(GQ))
decode_split_kernel(Params p) {
  extern __shared__ float smem[];
  constexpr int VPB = 8 / BITS;
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  const int bh = blockIdx.x, split = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int D = p.d, R = p.r, G = p.group, NB = p.nb;
  const int seq = bh / p.hkv;
  // blocks and tokens of one row of a leaf: a sequence's, or a page's (the
  // dense form reads both straight from the kernel's parameters)
  const int NBS = PAGED ? p.pb : p.nb;
  const int TS = PAGED ? p.pb * p.group : p.t;
  const int comp_len = PAGED ? p.lens[seq * 3] : p.comp_len;
  const int resid_len = PAGED ? p.lens[seq * 3 + 1] : p.resid_len;
  const int KO = p.ko, KOH = p.ko / 2;
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
  // outlier tiles (KO > 0): [NBT][KO/2] index words, [NBT][KO] deltas,
  // [NBT][kBnd] boundary tables, for K and for V
  int32_t* koi_s = vw_s + WD * VWS;
  int32_t* voi_s = koi_s + NBT * KOH;
  float* kov_s = reinterpret_cast<float*>(voi_s + NBT * KOH);
  float* vov_s = kov_s + NBT * KO;
  int32_t* kob_s = reinterpret_cast<int32_t*>(vov_s + NBT * KO);
  int32_t* vob_s = kob_s + NBT * kBnd;
  // paged: leaf row (page * hkv + head) and block offset in the page of
  // each quant block of the tile
  int32_t* lrow_s = kob_s + (KO ? 2 * NBT * kBnd : 0);
  int32_t* loff_s = lrow_s + NBT;

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
    const int ntiles = (comp_len + kTile - 1) / kTile;
    const int tile_lo = csplit * p.tiles_per_split;
    const int tile_hi = min(ntiles, tile_lo + p.tiles_per_split);
    const int pad = p.pad_start[seq];
    for (int tile = tile_lo; tile < tile_hi; ++tile) {
      const int t0 = tile * kTile;
      const int n_valid = min(kTile, comp_len - t0);
      if (t0 + n_valid <= pad) continue;  // wholly left of the padding
      __syncthreads();  // q_s ready; previous tile's smem reads done
      const int blk0 = t0 / G;
      if constexpr (PAGED) {
        if (tid < NBT) {
          const int blk = min(blk0 + tid, NB - 1);
          const int pid = max(p.block_table[seq * p.maxp + blk / p.pb], 0);
          lrow_s[tid] = pid * p.hkv + bh % p.hkv;
          loff_s[tid] = blk % p.pb;
        }
        __syncthreads();
      }
      // Index of the tile's block j among a leaf's [rows, NBS] blocks.
      auto blk_at = [&](int j) -> size_t {
        if constexpr (PAGED)
          return static_cast<size_t>(lrow_s[j]) * NBS + loff_s[j];
        else
          return static_cast<size_t>(bh) * NB + blk0 + j;
      };
      // Offset of the tile's token tt in row x of a [rows, X, TS] leaf.
      auto tok_at = [&](int X, int x, int tt) -> size_t {
        if constexpr (PAGED) {
          const int j = tt / G;
          return (static_cast<size_t>(lrow_s[j]) * X + x) * TS +
                 loff_s[j] * G + (tt - j * G);
        } else {
          return (static_cast<size_t>(bh) * X + x) * TS + t0 + tt;
        }
      };
      // Offset of (rank rr, tile block j) in a [rows, R, NBS] leaf.
      auto lane_at = [&](int rr, int j) -> size_t {
        if constexpr (PAGED)
          return (static_cast<size_t>(lrow_s[j]) * R + rr) * NBS + loff_s[j];
        else
          return (static_cast<size_t>(bh) * R + rr) * NB + blk0 + j;
      };

      // K folds per quant block of the tile.
      for (int i = tid; i < NBT * GQ * D; i += kTile) {
        const int j = i / (GQ * D), rem = i % (GQ * D);
        const int g = rem / D, dd = rem % D;
        const int blk = blk0 + j;
        qs_s[i] = blk < NB ? q_s[g * D + dd] * ld(p.k_scale + blk_at(j) * D + dd)
                           : 0.0f;
      }
      for (int item = warp; item < NBT * GQ * (1 + R); item += kWarps) {
        const int j = item / (GQ * (1 + R)), rem = item % (GQ * (1 + R));
        const int g = rem / (1 + R), which = rem % (1 + R);
        const int blk = blk0 + j;
        float acc_d = 0.0f;
        if (blk < NB && which == 0) {
          const bf16* src = p.k_mn + blk_at(j) * D;
#pragma unroll 4
          for (int dd = lane; dd < D; dd += 32) acc_d += q_s[g * D + dd] * ld(src + dd);
        } else if (blk < NB) {
          const size_t row = (blk_at(j) * R + (which - 1)) * D;
#pragma unroll 4
          for (int dd = lane; dd < D; dd += 32)
            acc_d += q_s[g * D + dd] * ldb<BASE8>(p.kpt, row + dd);
          if constexpr (BASE8)  // both int8 scales of (block, rank) fold in here
            acc_d *= p.kpt_scale[blk_at(j) * R + which - 1] *
                     p.kqt_scale[lane_at(which - 1, j)];
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
            tt < n_valid ? p.v_codes[tok_at(WD, w, tt)] : 0;
      }
      for (int i = tid; i < NGV * kTile; i += kTile) {
        const int g = i / kTile, tt = i % kTile;
        const size_t off = tok_at(NGV, g, tt);
        vs_s[i] = tt < n_valid ? ld(p.v_scale + off) : 0.0f;
        vm_s[i] = tt < n_valid ? ld(p.v_mn + off) : 0.0f;
      }
#pragma unroll 4
      for (int i = tid; i < R * kTile; i += kTile) {
        const int rr = i / kTile, tt = i % kTile;
        float vq = 0.0f;
        if (tt < n_valid) {
          vq = ldb<BASE8>(p.vqt, tok_at(R, rr, tt));
          if constexpr (BASE8) vq *= p.vqt_scale[lane_at(rr, tt / G)];
        }
        vq_s[i] = vq;
      }
#pragma unroll 4
      for (int i = tid; i < NBT * R * D; i += kTile) {
        const int j = i / (R * D), rem = i % (R * D);
        const int blk = blk0 + j;
        float vp = 0.0f;
        if (blk < NB) {
          vp = ldb<BASE8>(p.vpt, blk_at(j) * R * D + rem);
          if constexpr (BASE8) vp *= p.vpt_scale[blk_at(j) * R + rem / D];
        }
        vp_s[i] = vp;
      }
      // Stage the outlier entries of the tile's live blocks.
      if (KO) {
        for (int i = tid; i < NBT * KOH; i += kTile) {
          const int j = i / KOH, blk = blk0 + j;
          const bool live = blk * G < comp_len;
          const size_t off = blk_at(j) * KOH + i % KOH;
          koi_s[i] = live ? p.k_out_idx[off] : 0;
          voi_s[i] = live ? p.v_out_idx[off] : 0;
        }
        for (int i = tid; i < NBT * KO; i += kTile) {
          const int j = i / KO, blk = blk0 + j;
          const bool live = blk * G < comp_len;
          const size_t off = blk_at(j) * KO + i % KO;
          kov_s[i] = live ? ld(p.k_out_val + off) : 0.0f;
          vov_s[i] = live ? ld(p.v_out_val + off) : 0.0f;
        }
        for (int i = tid; i < NBT * kBnd; i += kTile) {
          const int j = i / kBnd, blk = blk0 + j;
          const bool live = blk * G < comp_len;
          const size_t off = blk_at(j) * kBnd + i % kBnd;
          kob_s[i] = live ? p.k_out_bnd[off] : -1;  // -1: empty segments
          vob_s[i] = live ? p.v_out_bnd[off] : -1;
        }
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
                p.k_codes[tok_at(WD, w0 + i, tid)]) : 0u;
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
          const float kq = ldb<BASE8>(p.kqt, tok_at(R, rr, tid));
#pragma unroll
          for (int g = 0; g < GQ; ++g) s[g] += qp_s[(j * GQ + g) * R + rr] * kq;
        }
        if (KO) {  // this token's outlier segment: q[d] * delta
          const int tl = tid - j * G;
          const int lo = tl ? kob_s[j * kBnd + tl - 1] + 1 : 0;
          const int hi =
              min(kob_s[j * kBnd + tl], KO - 1) - (tl ? 0 : p.out_pad);
          for (int e = max(lo, 0); e <= hi; ++e) {
            const int dd = out_idx(koi_s + j * KOH, e, KOH) % D;
            const float delta = kov_s[j * KO + e];
#pragma unroll
            for (int g = 0; g < GQ; ++g) s[g] += q_s[g * D + dd] * delta;
          }
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
        if (KO) {  // this channel's outlier segments: p[t] * delta
          for (int j = 0; j < NBT; ++j) {
            const int lo = tid ? vob_s[j * kBnd + tid - 1] + 1 : 0;
            const int hi =
                min(vob_s[j * kBnd + tid], KO - 1) - (tid ? 0 : p.out_pad);
            for (int e = max(lo, 0); e <= hi; ++e) {
              const int tl = min(out_idx(voi_s + j * KOH, e, KOH) / D, G - 1);
              const float delta = vov_s[j * KO + e];
#pragma unroll
              for (int g = 0; g < GQ; ++g)
                acc[g] += p_s[g * kTile + j * G + tl] * delta;
            }
          }
        }
      }
    }
  } else {
    // Residual tier: at most `group` <= kTile bf16 tokens. One warp per
    // token for the scores (lanes over channels, coalesced), staged in p_s.
    __syncthreads();  // q_s ready
    const int n_valid = resid_len;
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

  store_partial<GQ>(p.part_acc, p.part_ml,
                    static_cast<size_t>(bh) * NS + split, D, has_d, m_run,
                    l_run, acc);
}

constexpr bool kPaged = GEAR_DECODE_PAGED != 0;

template <int BITS, int GQ, bool BASE8>
cudaError_t launch_split(const Params& p, int bh, size_t smem,
                         cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_split_kernel<BITS, GQ, BASE8, kPaged>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  dim3 grid(bh, p.n_split + 1);
  decode_split_kernel<BITS, GQ, BASE8, kPaged>
      <<<grid, kTile, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int BITS, bool BASE8>
cudaError_t launch_gq(const Params& p, int bh, int gq, size_t smem,
                      cudaStream_t stream) {
  switch (gq) {
    case 1: return launch_split<BITS, 1, BASE8>(p, bh, smem, stream);
    case 2: return launch_split<BITS, 2, BASE8>(p, bh, smem, stream);
    case 4: return launch_split<BITS, 4, BASE8>(p, bh, smem, stream);
    case 8: return launch_split<BITS, 8, BASE8>(p, bh, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

#if GEAR_DECODE_PAGED
#define GEAR_DECODE_ENTRY GEAR_CAT(gear_decode_attention_paged_b, GEAR_DECODE_BITS)
#else
#define GEAR_DECODE_ENTRY GEAR_CAT(gear_decode_attention_b, GEAR_DECODE_BITS)
#endif

// One signature for both forms. Dense: lens and block_table are null, maxp
// and pb 0, comp_len / resid_len the lengths all rows share. Paged: t and nb
// are a sequence's capacity (MAXP * PB * group tokens, MAXP * PB blocks),
// comp_len a host bound on every row's comp_len, resid_len unused.
extern "C" int GEAR_DECODE_ENTRY(
    const float* q, const int32_t* k_codes, const void* k_scale,
    const void* k_mn, const void* kpt, const void* kqt, const int32_t* v_codes,
    const void* v_scale, const void* v_mn, const void* vpt, const void* vqt,
    const void* k_resid, const void* v_resid, const int32_t* pad_start,
    const float* kpt_scale, const float* kqt_scale, const float* vpt_scale,
    const float* vqt_scale, const int32_t* k_out_idx, const void* k_out_val,
    const int32_t* k_out_bnd, const int32_t* v_out_idx, const void* v_out_val,
    const int32_t* v_out_bnd, float* part_acc, float* part_ml, float* out,
    const int32_t* lens, const int32_t* block_table,
    int bh, int hkv, int gq, int d, int t, int nb, int r, int group,
    int v_group, int base8, int ko, int out_pad, int comp_len, int resid_len,
    int n_split, int tiles_per_split, int maxp, int pb, cudaStream_t stream) {
  if (kTile % group != 0 || d > kTile || group > kTile || ko % 2 != 0 ||
      out_pad < 0 || out_pad > ko)
    return cudaErrorInvalidValue;
  if (kPaged && !(lens && block_table && maxp > 0 && pb > 0 &&
                  nb == maxp * pb && bh % hkv == 0))
    return cudaErrorInvalidValue;
  if (base8 && !(kpt_scale && kqt_scale && vpt_scale && vqt_scale))
    return cudaErrorInvalidValue;
  if (ko && !(k_out_idx && k_out_val && k_out_bnd && v_out_idx && v_out_val &&
              v_out_bnd))
    return cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k_codes = k_codes;
  p.k_scale = static_cast<const bf16*>(k_scale);
  p.k_mn = static_cast<const bf16*>(k_mn);
  p.kpt = kpt;
  p.kqt = kqt;
  p.v_codes = v_codes;
  p.v_scale = static_cast<const bf16*>(v_scale);
  p.v_mn = static_cast<const bf16*>(v_mn);
  p.vpt = vpt;
  p.vqt = vqt;
  p.k_resid = static_cast<const bf16*>(k_resid);
  p.v_resid = static_cast<const bf16*>(v_resid);
  p.pad_start = pad_start;
  p.kpt_scale = kpt_scale;
  p.kqt_scale = kqt_scale;
  p.vpt_scale = vpt_scale;
  p.vqt_scale = vqt_scale;
  p.k_out_idx = k_out_idx;
  p.k_out_val = static_cast<const bf16*>(k_out_val);
  p.k_out_bnd = k_out_bnd;
  p.v_out_idx = v_out_idx;
  p.v_out_val = static_cast<const bf16*>(v_out_val);
  p.v_out_bnd = v_out_bnd;
  p.part_acc = part_acc;
  p.part_ml = part_ml;
  p.lens = lens;
  p.block_table = block_table;
  p.maxp = maxp;
  p.pb = pb;
  p.hkv = hkv;
  p.d = d;
  p.t = t;
  p.nb = nb;
  p.r = r;
  p.group = group;
  p.v_group = v_group;
  p.ko = ko;
  p.out_pad = out_pad;
  p.comp_len = comp_len;
  p.resid_len = resid_len;
  p.n_split = n_split;
  p.tiles_per_split = tiles_per_split;
  constexpr int kBits = GEAR_DECODE_BITS;
  const size_t smem =
      split_smem_bytes(gq, d, kBits, r, group, v_group, ko, kPaged);
  const cudaError_t e =
      base8 ? launch_gq<kBits, true>(p, bh, gq, smem, stream)
            : launch_gq<kBits, false>(p, bh, gq, smem, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(bh, gq);
  attn_merge_kernel<<<grid, d, 0, stream>>>(part_acc, part_ml, out,
                                            n_split + 1, gq, d);
  return static_cast<int>(cudaGetLastError());
}
