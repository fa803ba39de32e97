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
// gear_tpu_torch/cache.py::attend computes. The lengths every row shares
// are read from `lens` in device memory: the launch holds no length, so
// that a CUDA graph replays it with each step's, and the grid is sized
// from the capacity T; a block whose tiles lie beyond comp_len stores the
// empty state, which the merge absorbs.
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
// Design: every byte of a tile in flight at once, issued without holding
// the threads, and the next tile's while this one computes.
//  * grid (BH rows, 1 + token splits). Split 0 attends the residual tier;
//    each other block walks its split's tiles of 128 tokens below
//    comp_len; tiles and quant blocks wholly left of pad_start
//    are neither copied nor read. A second tiny kernel merges the splits'
//    (max, sum, acc) states, flash-decoding style.
//  * Staging: a ring of kStages = 2 stages in shared memory, each holding
//    everything one tile reads (Stage below): K and V code words, V scales
//    and minima, kqt / vqt columns, K scales and minima, kpt / vpt rows, the
//    int8 base scales, the outlier index words, deltas and boundary tables.
//    One quant block's tokens are a run of G consecutive elements in every
//    [rows, X, T] leaf, and its per-block rows are runs too, so the whole
//    tile is a list of runs, dealt to the lanes of one warp per kind of
//    leaf. A run of 16-byte multiples is one bulk copy (cp.async.bulk, the
//    copy engine of sm_90) that counts its bytes on the stage's mbarrier:
//    the issuing thread goes on at once, where a thread issuing 16-byte
//    cp.async pieces stalled while the card's memory streamed (measured:
//    ~40% of a block on the Llama path). Other runs go as 4-byte cp.async
//    pieces in the tile's commit group. Tile k + 2 is issued as soon as
//    tile k's math is done; each tile costs one wait on its barrier and
//    group and one block barrier.
//  * Paged: warp 0 looks up the pages of tile k + 2's quant blocks at the
//    start of tile k (lrow_s / loff_s, one slot per stage), so the table is
//    off the critical path; the page of a block is then only the source
//    address of its runs.
//  * The prefill's P once (the TPU kernel's dual_region): cache.prefill
//    replicates the prefill's P basis (and int8 scales) over its blocks, so
//    a tile wholly inside the prefill (below prefill_len) stages no kpt /
//    vpt rows; the block stages P0 once with its first tile, reduces q.P0
//    once per query row, and keeps sum_t p * Q[r, t] over its prefill tiles
//    as a running [GQ][R] state that the online softmax rescales with acc,
//    applied to P0 once when the block stores its state. Tiles past the
//    prefill (decode-flushed blocks) keep their own P per block.
//  * K scores: per quant block the scale folds into q once
//    (qs = q * scale), and q.mn and q.P_blk are reduced once (int8 bases:
//    times both scales there), all from the stage; a score is then
//    qs.code + q.mn + (q.P).Q[:, t]. The products qs.code are the
//    tensor-core form's MMAs, or in the multiply-add form each thread
//    unpacks its token's code words from the stage and multiplies.
//  * PV: p * vscale is formed per token, and sum p * vmn and sum p * Q[:, t]
//    per block (int8: times both scales) are reduced once, so the products
//    are (p * vscale) * code per token plus a few per-tile terms: the
//    tensor-core form's MMAs, or one thread per channel in the
//    multiply-add form.
//  * Outliers: the TPU kernel's one-hot dots and running-sum gathers stand
//    in for a scatter it does not have. The thread of token t (K entries
//    are sorted by token) or of channel d (V, sorted by channel) sums its
//    own segment bnd[t-1]+1 .. bnd[t] in entry order: no atomics. At
//    GQ <= 2 every live entry's terms (q[g][d] * delta for K, p[g][t] *
//    delta for V) are first formed in a fixed share a thread, into shared
//    memory, so that the walk that segments of unequal length make
//    divergent costs a load and an add a step; at GQ 4 and 8 that buffer
//    would cost a block an SM, and the walking thread forms its terms
//    itself (term_buffer below; the tensor-core form walks a segment per
//    lane for all query rows, below). The padding entries up to the stored
//    count (idx 0, delta 0) are the last out_pad entries of token 0's /
//    channel 0's segment (the stable sort keeps them behind that key's real
//    entries); they are neither formed nor summed.
//  * Residual tier (split 0): its K and V rows come in as one batch of
//    16-byte cp.async copies into the first region, then scores and PV
//    from shared memory (the simple form read them one dependent trip at a
//    time: 24 us at 60 tokens on the Llama path's shapes).
//  * Shared memory at D = 128, group 64, rank 4, 256 stored outliers: a
//    stage is 22,656 / 30,976 / 47,616 bytes at int2 / int4 / int8 with bf16
//    bases; with the prefill's P rows, the outlier terms (GQ <= 2, the
//    multiply-add form), the MMAs' B operands (the tensor-core form) and
//    the float32 working buffers (the K side's per-tile sums share their
//    floats with the V side's) a block takes 52-123 KB (kernels/decode.py::
//    decode_smem_bytes counts it, and this file checks the count), three
//    blocks an SM at int2 / int4 with GQ <= 4, fewer otherwise; min_blocks
//    holds the registers to that.
//  * float32 throughout; online softmax with -inf for masked tokens.
//
// Tensor-core products (mma_form: int2 and int4 codes, GQ >= 2, D 128,
// group 64, V group 64, rank <= 4; every other launch multiplies on the
// CUDA cores, one thread per token and per channel). The kernel runs one
// of two bodies, split_body<..., MMA>; the tensor-core one has its shape's
// sizes as constants, which holds it to the launch bounds' registers.
// At GQ 4 a thread of the multiply-add form spends ~6 instructions a code
// (unpacks, float4 loads of q * scale or p * vscale, fused multiply-adds),
// and 12 warps an SM hide little of their latency: the kernel ran at ~12%
// of its byte bound. Here the block is one
// warpgroup and both products are wgmma (sm_90a) chains, m64 x N x k16,
// A in registers, B in shared memory, float32 sums in registers:
//  * Exact as float32: a code below 2^7 is the low mantissa bits of a bf16
//    of exponent 7, 128 + code; one mask-and-or of a code word makes two of
//    them, a bf16x2 multiply-add takes the 128 off (code_pair). q * scale
//    and p * vscale go in as three bf16 pieces, h + m + l = x (split3),
//    each piece its own column of B, so that the MMA's products are exact
//    and only its float32 sums round; a thread owns the three columns of a
//    (token or channel, query row) and adds them.
//  * K: one chain of 8 MMAs per quant block of the tile: its 64 tokens
//    are the rows (a thread's pair of rows two adjacent tokens), the 128
//    channels the contraction in a permuted order: a quad lane reads four
//    whole words of its two tokens (K code rows padded by 4 words, so the
//    quad's reads fall in distinct banks), and word W's shifts by field
//    and byte give the two channels 4W + b and 4W + b + 2 of a bf16x2
//    register; B, q * scale, is written in that order.
//  * PV: a chain per d-group of 64 channels (the rows), the tile's tokens
//    the contraction: a byte permute of two tokens' words gives a
//    register's two tokens of one channel, and a quad lane's four token
//    columns of a k-step are four consecutive tokens (one 16-byte read).
//    The sums run over the tiles, rescaled by the softmax's factor per
//    column.
//  * Around them, on the CUDA cores: the folds' q.mn and q.P, and per
//    (token, row) or (channel, row) the low-rank and outlier terms. A quad
//    of lanes shares its rows' tokens and channels, so each lane walks one
//    of the quad's four outlier segments for every query row while a
//    chain runs: the K terms go to their rows' lanes through p_s, the V
//    terms stay in per-lane running sums, as do p's sum, p * vmn and the
//    prefill's sum_t p * Q[r, t], reduced once a block.
//  * Bound on this card: latency at 12 warps an SM. The MMAs with their
//    unpacking take ~20% of a block's cycles; the folds (q * scale in
//    pieces, q.mn, q.P), the per-row terms and the copy issue most of the
//    rest (PERF.md section 5).
// Later work: one K scale over a KCVT prefill (the TPU kernel's kcvt
// path).
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
  const int32_t* lens;         // comp, resid, prefill lengths: paged [B, 3],
                               // dense [3] that every row shares
  const int32_t* block_table;  // paged: [B, MAXP], entries < 0 unallocated
  int hkv, d, t, nb, r, group, v_group, ko;  // nb: blocks of a sequence
  int out_pad;  // padding entries at the end of segment 0 of every block
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

// An unsigned code below 2^23 as a float: its bits under the exponent of
// 2^23, less 2^23 (exact; two full-rate operations where an int-to-float
// conversion runs at a quarter of the rate).
__device__ __forceinline__ float small_code(uint32_t bits, uint32_t mask) {
  return __uint_as_float((bits & mask) | 0x4B000000u) - 8388608.0f;
}

// Code byte KK of a word whose bytes each hold one code (the other fields
// masked off), as a float: a byte permute builds the float's bits.
template <int KK>
__device__ __forceinline__ float code_at(uint32_t bytes) {
  return __uint_as_float(__byte_perm(bytes, 0x4B000000u, 0x7540 | KK)) -
         8388608.0f;
}

// s + a . (c0, c1, c2, c3): a chain of fused multiply-adds where the other
// query rows give a thread independent work (GQ > 1), a tree where they do
// not.
template <int GQ>
__device__ __forceinline__ float dot4(float s, float4 a, float c0, float c1,
                                      float c2, float c3) {
  if constexpr (GQ > 1)
    return fmaf(a.w, c3, fmaf(a.z, c2, fmaf(a.y, c1, fmaf(a.x, c0, s))));
  else
    return s + ((a.x * c0 + a.y * c1) + (a.z * c2 + a.w * c3));
}

constexpr int kSums = 5;  // sums a warp reduces together (q.mn and 4 ranks)

// Reduce N sums over the warp at once: their shuffles interleave.
template <int N>
__device__ __forceinline__ void warp_sums(float* v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int u = 0; u < N; ++u) v[u] += __shfl_xor_sync(0xffffffffu, v[u], o);
  }
}

// s[0 .. GQ) += o[0 .. GQ): one outlier entry's terms, 16 or 8 bytes a load.
template <int GQ>
__device__ __forceinline__ void add_terms(float* s, const float* o) {
  if constexpr (GQ % 4 == 0) {
#pragma unroll
    for (int g = 0; g < GQ; g += 4) {
      const float4 v = *reinterpret_cast<const float4*>(o + g);
      s[g] += v.x;
      s[g + 1] += v.y;
      s[g + 2] += v.z;
      s[g + 3] += v.w;
    }
  } else if constexpr (GQ == 2) {
    const float2 v = *reinterpret_cast<const float2*>(o);
    s[0] += v.x;
    s[1] += v.y;
  } else {
    s[0] += o[0];
  }
}

// Entry e of a block's packed outlier indices (KO/2 words in shared memory).
__device__ __forceinline__ int out_idx(const int32_t* words, int e, int koh) {
  const uint32_t w = static_cast<uint32_t>(words[e < koh ? e : e - koh]);
  return static_cast<int>(e < koh ? (w & 0xFFFFu) : (w >> 16));
}

// The tile's two forms. The tensor-core form takes (BITS, GQ) whose codes
// lie below 2^7, so that a code is the low bits of a bf16 of exponent 7
// (int2, int4), and whose two or more query rows fill the MMAs' columns;
// a launch then takes it when its shape is the one the fragments are laid
// out for: D 128, quant group 64 (a chain's 64 rows are a quant block's
// tokens), V group 64 (a PV chain's 64 rows are a d-group's channels), and
// at most kMmaRanks ranks (its running prefill sums live in registers).
// Every other launch takes the multiply-add form.
constexpr int kMmaRanks = 4;
__host__ __device__ constexpr bool mma_codes(int bits, int gq) {
  return bits != 8 && gq >= 2;
}
__host__ __device__ inline bool mma_form(int bits, int gq, int d, int group,
                                         int v_group, int r) {
  return mma_codes(bits, gq) && d == 128 && group == 64 && v_group == 64 &&
         r <= kMmaRanks;
}
// Columns of the MMAs' B: three bf16 pieces of each query row, a thread's
// rows' pieces in its own columns (mma_col), rounded up to 8.
__host__ __device__ constexpr int mma_cols(int gq) {
  return 8 * ((3 * ((gq + 3) / 4) + 1) / 2);
}
// Bytes of one k-step (16 rows of K) of a B operand: mma_cols rows of 32.
__host__ __device__ constexpr int mma_kstep_bytes(int gq) {
  return mma_cols(gq) * 32;
}
// The B operands' region: a chain of 8 k-steps per quant block of a tile
// (the K scores) or per d-group (PV), the two sides at different times.
__host__ __device__ inline int mma_bytes(int gq, int nbt, int ngv) {
  return (nbt > ngv ? nbt : ngv) * 8 * mma_kstep_bytes(gq);
}

// The ring: kStages stages, each holding every byte one tile needs. Stage
// k % kStages takes the block's k-th tile; its pages sit in lookup slot
// k % kStages.
constexpr int kStages = 2;

// Byte offsets of the pieces of one stage: [WD][kws] K code words,
// [WD][vws] V code words, [NGV][kTile] V scales and minima, [R][kTile]
// kqt and vqt columns, [NBT][D] K scales and minima, [NBT][R][D] kpt and vpt
// rows, int8 base scales [NBT][R] (kpt, vpt) and [R][NBT] (kqt, vqt),
// outlier index words [NBT][KO/2], deltas [NBT][KO] and boundary tables
// [NBT][kBnd] for K and for V. Each piece starts on 16 bytes. A code row is
// padded by 4 words where the form's reads of a warp would fall in one
// bank otherwise: the V rows in the multiply-add form (its PV reads 8
// words of one token), the K rows in the tensor-core form (its quads read
// 4 words of 8 tokens); the other rows are kTile words.
struct Stage {
  int kws, vws;  // K and V code row strides (words)
  int kc, vc, vs, vm, kq, vq, ksc, kmn, kp, vp, kps, vps, kqs, vqs;
  int koi, voi, kov, vov, kob, vob, bytes;
};

__host__ __device__ inline int take(int& at, int n) {
  const int here = at;
  at += (n + 15) & ~15;
  return here;
}

__host__ __device__ inline Stage stage_layout(int d, int bits, int r,
                                              int group, int v_group, int ko,
                                              bool base8, bool mma) {
  const int nbt = kTile / group, ngv = d / v_group, wd = d * bits / 32;
  const int bel = base8 ? 1 : 2;
  const int sc = base8 ? nbt * r * 4 : 0;
  Stage s;
  s.kws = mma ? kTile + 4 : kTile;
  s.vws = mma ? kTile : kTile + 4;
  int at = 0;
  s.kc = take(at, wd * s.kws * 4);
  s.vc = take(at, wd * s.vws * 4);
  s.vs = take(at, ngv * kTile * 2);
  s.vm = take(at, ngv * kTile * 2);
  s.kq = take(at, r * kTile * bel);
  s.vq = take(at, r * kTile * bel);
  s.ksc = take(at, nbt * d * 2);
  s.kmn = take(at, nbt * d * 2);
  s.kp = take(at, nbt * r * d * bel);
  s.vp = take(at, nbt * r * d * bel);
  s.kps = take(at, sc);
  s.vps = take(at, sc);
  s.kqs = take(at, sc);
  s.vqs = take(at, sc);
  s.koi = take(at, nbt * (ko / 2) * 4);
  s.voi = take(at, nbt * (ko / 2) * 4);
  s.kov = take(at, nbt * ko * 2);
  s.vov = take(at, nbt * ko * 2);
  s.kob = take(at, ko ? nbt * kBnd * 4 : 0);
  s.vob = take(at, ko ? nbt * kBnd * 4 : 0);
  s.bytes = at;
  return s;
}

// The first region of a block's shared memory: the ring of the compressed
// splits, or the residual tier's K and V rows ([G][D] bf16 each) in split 0.
__host__ __device__ inline int region_bytes(int d, int bits, int r,
                                            int group, int v_group, int ko,
                                            bool base8, bool mma) {
  const int ring =
      kStages *
      stage_layout(d, bits, r, group, v_group, ko, base8, mma).bytes;
  const int resid = 2 * group * d * 2;
  return ring > resid ? ring : resid;
}

// The prefill's shared P rows of K and V ([R][D] each, base type), after
// the first region.
__host__ __device__ inline int pre_bytes(int d, int r, bool base8) {
  return (2 * r * d * (base8 ? 1 : 2) + 15) & ~15;
}

// The outlier terms go through shared memory (ot_s) where they cost no
// block an SM: at GQ <= 2, in the multiply-add form. At GQ 4 and 8 their
// 8-16 KB would cut the blocks an SM from three to two (on the H100 the
// Mistral path's GQ 4 ran 13% slower so), and each thread of a token or
// channel forms the terms of its own segment as it walks it. On the serving
// run's live pool the buffer takes 16% less time than that walk at GQ 1
// (PERF.md). The tensor-core form walks its segments for one query row a
// thread and takes no buffer.
__host__ __device__ constexpr bool term_buffer(int gq) { return gq <= 2; }

// Floats of the per-tile sums whose lives do not overlap: q.mn and q.P per
// (block, row) from the K folds to the scores, then sum p * vmn and
// sum p * Q per (row, block) from the PV folds to the PV.
__host__ __device__ inline int sums_floats(int gq, int nbt, int ngv, int r) {
  const int k = nbt * gq * (1 + r), v = gq * (ngv + nbt * r);
  return k > v ? k : v;
}

// Shared memory of one block: the first region, the prefill's P rows, the
// MMAs' B operands (tensor-core form), then float32 working buffers, then
// the page lookups (kernels/decode.py::decode_smem_bytes counts the same).
size_t split_smem_bytes(int gq, int d, int bits, int r, int group,
                        int v_group, int ko, bool base8, bool paged) {
  const int nbt = kTile / group;
  const int ngv = d / v_group;
  const bool mma = mma_form(bits, gq, d, group, v_group, r);
  size_t floats = 0;
  floats += gq * d;                 // q_s
  if (!mma) floats += nbt * gq * d;      // qs_s
  if (!mma) floats += gq * ngv * kTile;  // pvs_s
  floats += gq * kTile;             // p_s
  if (term_buffer(gq) && !mma) floats += nbt * ko * gq;  // ot_s
  floats += sums_floats(gq, nbt, ngv, r);  // qm_s, qp_s | pvm_s, wv_s
  floats += 2 * gq * kWarps;        // red_max, red_sum
  floats += 2 * gq * r;             // qp0_s, wv0_s
  if (base8) floats += 4 * r;       // pre_sc: the prefill's int8 scales
  if (mma) floats += gq;            // alpha_s
  if (paged) floats += 2 * kStages * nbt;  // lrow_s, loff_s (int32)
  return static_cast<size_t>(
             region_bytes(d, bits, r, group, v_group, ko, base8, mma)) +
         pre_bytes(d, r, base8) + (mma ? mma_bytes(gq, nbt, ngv) : 0) +
         8 * kStages + floats * sizeof(float);
}

// Blocks per SM that the register budget is held to (65,536 / (128 x n)
// registers a thread: 168 at 3, 255 at 2). At D = 128, group 64, rank 4 and
// 256 stored outliers a block takes 43-75 KB of shared memory at int2/int4
// with GQ <= 4, so three fit on an SM (228 KB, 1 KB of it reserved per
// block); int8 codes or GQ = 8 take 65-121 KB, two or one.
constexpr int min_blocks(int bits, int gq) {
  return bits == 8 || gq == 8 ? 2 : 3;
}

// Bulk copies (the copy engine of sm_90): one instruction moves a run of
// 16-byte multiples from device memory into shared memory and counts its
// bytes on an mbarrier in shared memory; the issuing thread goes on at once.
__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// One arrival that also announces the bytes the phase's bulk copies bring.
__device__ __forceinline__ void bar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of this parity has completed; a phase
// that never completes (bytes announced that no copy brings) traps rather
// than holding the card.
__device__ __forceinline__ void bar_wait(uint32_t bar, int parity) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1u << 22)) __trap();
  }
}

// Warpgroup MMAs (wgmma, sm_90a): the block's 128 threads are one
// warpgroup. A comes from registers, B from shared memory through a
// descriptor, the float32 sums stay in registers; the products are issued
// asynchronously and waited for as one group.

// Descriptor of a K-major B in shared memory, no swizzle: core matrices of
// 8 rows of B's columns by 16 bytes (8 of K), 128 bytes each; the two
// halves of a k-step's 16 rows of K lie 128 bytes apart (leading byte
// offset), groups of 8 columns 256 bytes apart (stride byte offset).
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

// Byte offset in a chain's B of (k-step ks, row kk of its 16, column n),
// in the layout b_desc describes; a k-step takes kstep bytes.
__device__ __forceinline__ int b_off(int kstep, int ks, int kk, int n) {
  return ks * kstep + (n >> 3) * 256 + (kk >> 3) * 128 + (n & 7) * 16 +
         (kk & 7) * 2;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// The accumulators change here as far as the compiler knows: after a wait,
// so that no read of them moves above it.
template <int N>
__device__ __forceinline__ void wgmma_touch(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// Thread writes to shared memory seen by the MMAs' (async proxy) reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d[64 x N] += a[64 x 16] * b[16 x N]: bf16 operands, A as four bf16x2
// registers a thread, float32 accumulators, N / 2 a thread.
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t desc);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t* a,
                                             uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<24>(float* d, const uint32_t* a,
                                             uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, %16, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// Two codes, at bits [0, BITS) and [16, 16 + BITS) of x, as one bf16x2
// register: masked, they are the low mantissa bits of a bf16 of exponent
// 7, 128 + code, and a bf16x2 multiply-add takes the 128 off (exact).
__device__ __forceinline__ uint32_t code_pair(uint32_t x, uint32_t mask2) {
  const uint32_t biased = (x & mask2) | 0x43004300u;
  uint32_t out;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(out)
      : "r"(biased), "r"(0x3F803F80u), "r"(0xC300C300u));
  return out;
}

// x0 and x1 in three bf16 pieces each, h + m + l = x: a float32's 24 bits
// of significand in three of 8 (each difference is exact). Returned as
// bf16x2 registers, x0 in the low half.
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& h,
                                       uint32_t& m, uint32_t& l) {
  const __nv_bfloat162 hb = __floats2bfloat162_rn(x0, x1);
  const float r0 = __fsub_rn(x0, __low2float(hb));
  const float r1 = __fsub_rn(x1, __high2float(hb));
  const __nv_bfloat162 mb = __floats2bfloat162_rn(r0, r1);
  const __nv_bfloat162 lb = __floats2bfloat162_rn(
      __fsub_rn(r0, __low2float(mb)), __fsub_rn(r1, __high2float(mb)));
  h = *reinterpret_cast<const uint32_t*>(&hb);
  m = *reinterpret_cast<const uint32_t*>(&mb);
  l = *reinterpret_cast<const uint32_t*>(&lb);
}

// Column of B (and of the sums) that holds piece c of a thread's row i:
// the thread of quad lane qa owns query rows qa + 4 i, and the columns
// 8 t + 2 qa and 8 t + 2 qa + 1 of every group t of 8 are its own in the
// accumulator layout, so the three pieces of a (token, row) or (channel,
// row) sum in one thread.
__host__ __device__ constexpr int mma_col(int i, int c, int qa) {
  return 8 * ((3 * i + c) / 2) + 2 * qa + (3 * i + c) % 2;
}
// Index among a thread's accumulators of that column, in the row of the
// thread's pair given by rh (0: row g8, 1: row g8 + 8).
__host__ __device__ constexpr int mma_acc(int i, int c, int rh) {
  return 4 * ((3 * i + c) / 2) + (3 * i + c) % 2 + 2 * rh;
}

// One block's work in the tile's form MMA: the tensor-core form takes the
// shape mma_form names, whose sizes are constants here.
template <int BITS, int GQ, bool BASE8, bool PAGED, bool MMA>
__device__ __forceinline__ void split_body(const Params& p) {
  extern __shared__ uint4 smem_v[];
  char* smem = reinterpret_cast<char*>(smem_v);
  constexpr int VPB = 8 / BITS;
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  constexpr uint32_t kByteMask = MASK * 0x01010101u;  // MASK in every byte
  constexpr int BEL = BASE8 ? 1 : 2;  // bytes of a base element
  const int bh = blockIdx.x, split = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int D = MMA ? 128 : p.d, R = p.r, G = MMA ? 64 : p.group, NB = p.nb;
  const int VG = MMA ? 64 : p.v_group;
  const int seq = bh / p.hkv;
  // blocks and tokens of one row of a leaf: a sequence's, or a page's (the
  // dense form reads both straight from the kernel's parameters)
  const int NBS = PAGED ? p.pb : p.nb;
  const int TS = PAGED ? p.pb * G : p.t;
  // the row's lengths: its sequence's in the paged form, the ones every row
  // shares in the dense form
  const int32_t* lens = PAGED ? p.lens + seq * 3 : p.lens;
  const int comp_len = lens[0];
  const int resid_len = lens[1];
  const int KO = p.ko, KOH = p.ko / 2;
  const int WD = D * BITS / 32;
  const int NGV = D / VG;
  const int NBT = kTile / G;
  const int NS = p.n_split + 1;
  constexpr bool mma = MMA;
  const Stage L = stage_layout(D, BITS, R, G, VG, KO, BASE8, mma);

  // the prefill's P rows of K and V, [2][R][D] in the base type
  char* pre_p =
      smem + region_bytes(D, BITS, R, G, VG, KO, BASE8, mma);
  // the tensor-core form's B operands (mma_bytes), on 16 bytes
  char* opnd = pre_p + pre_bytes(D, R, BASE8);
  // working buffers; those read as float4 first, each a multiple of four
  // floats, so that they start on 16 bytes
  // one mbarrier a stage, which the stage's bulk copies count their bytes on
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      opnd + (mma ? mma_bytes(GQ, NBT, NGV) : 0));
  float* q_s = reinterpret_cast<float*>(bars + kStages);
  float* qs_s = q_s + GQ * D;
  float* pvs_s = qs_s + (mma ? 0 : NBT * GQ * D);
  float* p_s = pvs_s + (mma ? 0 : GQ * NGV * kTile);
  // the terms of the tile's outlier entries, [NBT][KO][GQ]: q[g][d] * delta
  // for K (until the scores), p[g][t] * delta for V (after the softmax)
  constexpr bool kTerms = term_buffer(GQ);
  float* ot_s = p_s + GQ * kTile;
  // the per-tile sums: the K side's until the scores, then the V side's
  float* qm_s = ot_s + (kTerms && !mma ? NBT * KO * GQ : 0);
  float* qp_s = qm_s + NBT * GQ;
  float* pvm_s = qm_s;
  float* wv_s = pvm_s + GQ * NGV;
  float* red_max = qm_s + sums_floats(GQ, NBT, NGV, R);
  float* red_sum = red_max + GQ * kWarps;
  float* qp0_s = red_sum + GQ * kWarps;  // q . P of the prefill, [GQ][R]
  float* wv0_s = qp0_s + GQ * R;       // running sum_t p * Q[r, t] over the
                                       // prefill's tiles, [GQ][R]
  float* pre_sc = wv0_s + GQ * R;      // the prefill's int8 scales [4][R]:
                                       // kpt, kqt, vpt, vqt (int8 bases)
  // the tile's softmax factor per query row (tensor-core form), [GQ]
  float* alpha_s = pre_sc + (BASE8 ? 4 * R : 0);
  // paged: leaf row (page * hkv + head) and block offset in the page of
  // each quant block of the tile in each stage, [kStages][NBT]
  int32_t* lrow_s = reinterpret_cast<int32_t*>(alpha_s + (mma ? GQ : 0));
  int32_t* loff_s = lrow_s + kStages * NBT;

  for (int i = tid; i < GQ * D; i += kTile)
    q_s[i] = p.q[static_cast<size_t>(bh) * GQ * D + i];
  for (int i = tid; i < GQ * R; i += kTile) wv0_s[i] = 0.0f;

  float m_run[GQ], l_run[GQ], acc[GQ], alpha[GQ], s[GQ];
#pragma unroll
  for (int g = 0; g < GQ; ++g) {
    m_run[g] = -INFINITY;
    l_run[g] = 0.0f;
    acc[g] = 0.0f;
  }

  // an outlier index is t * D + d: shifts where D is a power of two
  const int dsh = (D & (D - 1)) == 0 ? __ffs(D) - 1 : -1;

  // This thread's channel in the PV phase.
  const bool has_d = tid < D;
  const int stride_f = D / VPB;
  int w_me = 0, shift_me = 0, grp_me = 0;
  if (has_d) {
    const int f = tid / stride_f, c = tid % stride_f;
    w_me = c / 4;
    shift_me = 8 * (c % 4) + f * BITS;
    grp_me = tid / VG;
  }

  // Split 0 attends the residual tier (scheduled first: it is the longest
  // single block); splits 1.. walk the compressed prefix.
  if (split > 0) {
    const int csplit = split - 1;
    const int pad = p.pad_start[seq];
    const int ntiles = (comp_len + kTile - 1) / kTile;
    // tiles wholly left of the padding are skipped
    const int tile_lo = max(csplit * p.tiles_per_split, pad / kTile);
    const int tile_hi =
        min(ntiles, csplit * p.tiles_per_split + p.tiles_per_split);
    const int n_t = max(0, tile_hi - tile_lo);
    const int prefill_len = lens[2];

    // The block's k-th tile: first token, valid tokens (a multiple of the
    // group: comp_len is), live quant blocks [jlo, nbl) (those wholly left
    // of the padding are neither copied nor read), and whether it lies
    // wholly inside the prefill, whose blocks all hold the one P.
    struct Geo {
      int t0, n_valid, jlo, nbl;
      bool pre;
    };
    auto geo = [&](int k) {
      Geo t;
      t.t0 = (tile_lo + k) * kTile;
      t.n_valid = min(kTile, comp_len - t.t0);
      t.nbl = t.n_valid / G;
      t.jlo = pad > t.t0 ? (pad - t.t0) / G : 0;
      t.pre = R > 0 && t.t0 + t.n_valid <= prefill_len;
      return t;
    };
    // the prefill's tiles come first: the block has some if its first is
    const bool has_pre = n_t > 0 && geo(0).pre;
    // Lane `lane` of warp 0 looks up the page of the k-th tile's quant
    // block `lane`: its leaf row (page * hkv + head) and block offset in the
    // page, which go to lookup slot k % kStages.
    auto page_of = [&](int k, int& row, int& off) {
      const int blk = min((tile_lo + k) * NBT + lane, NB - 1);
      const int pid = max(p.block_table[seq * p.maxp + blk / p.pb], 0);
      row = pid * p.hkv + bh % p.hkv;
      off = blk % p.pb;
    };
    auto put_page = [&](int k, int row, int off) {
      lrow_s[(k % kStages) * NBT + lane] = row;
      loff_s[(k % kStages) * NBT + lane] = off;
    };
    // Issue every byte of the k-th tile into stage k % kStages, as one
    // commit group (an empty one past the last tile, so that the count of
    // groups stays uniform).
    auto issue = [&](int k) {
      if (k < n_t) {
        const Geo tg = geo(k);
        char* S = smem + (k % kStages) * L.bytes;
        const int ls = (k % kStages) * NBT;
        const int blk0 = (tile_lo + k) * NBT;
        const int jlo = tg.jlo, nb = tg.nbl - tg.jlo;
        // Index of the tile's block j among a leaf's [rows, NBS] blocks.
        auto blk_at = [&](int j) -> size_t {
          if constexpr (PAGED)
            return static_cast<size_t>(lrow_s[ls + j]) * NBS + loff_s[ls + j];
          else
            return static_cast<size_t>(bh) * NB + blk0 + j;
        };
        // Offset of the first token of the tile's block j in row 0 of a
        // [rows, X, TS] leaf: a run of G consecutive tokens; row x is x * TS
        // further.
        auto run_at = [&](int X, int j) -> size_t {
          if constexpr (PAGED)
            return static_cast<size_t>(lrow_s[ls + j]) * X * TS +
                   loff_s[ls + j] * G;
          else
            return static_cast<size_t>(bh) * X * TS + (blk0 + j) * G;
        };
        // Offset of (rank rr, tile block j) in a [rows, R, NBS] leaf.
        auto lane_at = [&](int rr, int j) -> size_t {
          if constexpr (PAGED)
            return (static_cast<size_t>(lrow_s[ls + j]) * R + rr) * NBS +
                   loff_s[ls + j];
          else
            return (static_cast<size_t>(bh) * R + rr) * NB + blk0 + j;
        };
        const uint32_t bar = smem_addr(bars + k % kStages);
        // One run of `bytes` (a multiple of 4) by this thread: a bulk copy
        // when it is a multiple of 16 bytes, else 4-byte cp.async pieces
        // (the tile's commit group).
        auto copy_run = [&](char* to, const char* from, int bytes) {
          if ((bytes & 15) == 0) {
            bulk_copy(to, from, bytes, bar);
          } else {
            for (int c = 0; c < bytes; c += 4) cp_async4(to + c, from + c);
          }
        };
        auto bulk = [](int bytes) { return (bytes & 15) ? 0 : bytes; };
        // The runs of a [rows, X, TS] leaf of el-byte elements, a lane each
        // in turn: per live block, X runs of G * el bytes, into [X][row].
        auto tok_runs = [&](int off, int row, const void* src, int X,
                            int el) {
          for (int r = lane; r < X * nb; r += 32) {
            const int jj = r / X, x = r - jj * X, j = jlo + jj;
            copy_run(S + off + (x * row + j * G) * el,
                     static_cast<const char*>(src) +
                         (run_at(X, j) + static_cast<size_t>(x) * TS) * el,
                     G * el);
          }
        };
        // The per-block leaves [rows, NBS, bytes] a tile reads, by id:
        // scales and minima, the P rows and their int8 scales (not in a
        // prefill tile), the outlier tables.
        auto blk_leaf = [&](int id, int& off, const void*& src,
                            int& bytes) -> bool {
          const bool rows = !tg.pre, sc8 = BASE8 && !tg.pre, outl = KO > 0;
          switch (id) {
            case 0: off = L.ksc; src = p.k_scale; bytes = D * 2; return true;
            case 1: off = L.kmn; src = p.k_mn; bytes = D * 2; return true;
            case 2: off = L.kp; src = p.kpt; bytes = R * D * BEL; return rows;
            case 3: off = L.vp; src = p.vpt; bytes = R * D * BEL; return rows;
            case 4: off = L.kps; src = p.kpt_scale; bytes = R * 4; return sc8;
            case 5: off = L.vps; src = p.vpt_scale; bytes = R * 4; return sc8;
            case 6: off = L.koi; src = p.k_out_idx; bytes = KOH * 4; return outl;
            case 7: off = L.voi; src = p.v_out_idx; bytes = KOH * 4; return outl;
            case 8: off = L.kov; src = p.k_out_val; bytes = KO * 2; return outl;
            case 9: off = L.vov; src = p.v_out_val; bytes = KO * 2; return outl;
            case 10: off = L.kob; src = p.k_out_bnd; bytes = kBnd * 4; return outl;
            default: off = L.vob; src = p.v_out_bnd; bytes = kBnd * 4; return outl;
          }
        };
        constexpr int kLeaves = 12;
        // the prefill's P rows and int8 scales come with tile 0, once, from
        // its first block (every prefill block holds the same)
        const bool pre0 = k == 0 && tg.pre;
        size_t b0 = static_cast<size_t>(bh) * NB;
        if constexpr (PAGED)
          b0 = (static_cast<size_t>(max(p.block_table[seq * p.maxp], 0)) *
                    p.hkv + bh % p.hkv) * NBS;
        const int pb = R * D * BEL;
        if (tid == 0) {  // the bytes of the tile's bulk copies (blk_leaf's)
          int tx = 2 * WD * bulk(G * 4) + 2 * NGV * bulk(G * 2) +
                   2 * R * bulk(G * BEL) + 2 * bulk(D * 2);
          if (!tg.pre)
            tx += 2 * bulk(R * D * BEL) + (BASE8 ? 2 * bulk(R * 4) : 0);
          if (KO) tx += 2 * (bulk(KOH * 4) + bulk(KO * 2) + bulk(kBnd * 4));
          tx = tx * nb + (pre0 ? 2 * bulk(pb) : 0);
          bar_expect(bar, tx);
        }
        // the stage was last read through the generic proxy
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        if (warp == 0) {
          tok_runs(L.kc, L.kws, p.k_codes, WD, 4);
        } else if (warp == 1) {
          tok_runs(L.vc, L.vws, p.v_codes, WD, 4);
        } else if (warp == 2) {
          tok_runs(L.vs, kTile, p.v_scale, NGV, 2);
          tok_runs(L.vm, kTile, p.v_mn, NGV, 2);
          tok_runs(L.kq, kTile, p.kqt, R, BEL);
          tok_runs(L.vq, kTile, p.vqt, R, BEL);
          if (pre0 && lane < 2)
            copy_run(pre_p + lane * pb,
                     static_cast<const char*>(lane ? p.vpt : p.kpt) + b0 * pb,
                     pb);
          if constexpr (BASE8) {
            // kpt / vpt scales [rows, NBS, R], kqt / vqt [rows, R, NBS]
            const size_t rows = b0 / NBS;
            for (int rr = lane; pre0 && rr < R; rr += 32) {
              cp_async4(pre_sc + rr, p.kpt_scale + b0 * R + rr);
              cp_async4(pre_sc + R + rr, p.kqt_scale + (rows * R + rr) * NBS);
              cp_async4(pre_sc + 2 * R + rr, p.vpt_scale + b0 * R + rr);
              cp_async4(pre_sc + 3 * R + rr,
                        p.vqt_scale + (rows * R + rr) * NBS);
            }
          }
        } else {
          for (int r = lane; r < kLeaves * nb; r += 32) {
            const int id = r / nb, j = jlo + r - id * nb;
            int off, bytes;
            const void* src;
            if (blk_leaf(id, off, src, bytes))
              copy_run(S + off + j * bytes,
                       static_cast<const char*>(src) + blk_at(j) * bytes,
                       bytes);
          }
          if constexpr (BASE8) {  // [R][NBT] lanes of [rows, R, NBS] leaves
            for (int i = lane; !tg.pre && i < 2 * R * nb; i += 32) {
              const int x = i / nb, j = jlo + i - x * nb;
              const int rr = x < R ? x : x - R;
              cp_async4(S + (x < R ? L.kqs : L.vqs) + (rr * NBT + j) * 4,
                        (x < R ? p.kqt_scale : p.vqt_scale) + lane_at(rr, j));
            }
          }
        }
      }
      cp_async_commit();
    };

    if (tid == 0) {
      for (int i = 0; i < kStages; ++i)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                         smem_addr(bars + i))
                     : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    if constexpr (PAGED) {
      if (warp == 0 && lane < NBT) {
        for (int k = 0; k < min(kStages, n_t); ++k) {
          int row, off;
          page_of(k, row, off);
          put_page(k, row, off);
        }
      }
    }
    __syncthreads();  // q_s and the first pages ready
    for (int k = 0; k < kStages; ++k) issue(k);

    // q.mn (r = -1) and q.P_blk per (live block, query row) of the tile in
    // stage S, into qm_s and qp_s: a warp per pair in turn, kSums of the
    // sums reduced together. A prefill tile (RB 0) reduces q.mn alone: its
    // q.P is q.P0, reduced into qp0_s once, with the block's first tile.
    auto k_sums = [&](const char* S, int jlo, int nbl, int RB, bool first) {
      const bf16* kmn = reinterpret_cast<const bf16*>(S + L.kmn);
      const float* kps = reinterpret_cast<const float*>(S + L.kps);
      const float* kqs = reinterpret_cast<const float*>(S + L.kqs);
      for (int jg = warp; jg < (nbl - jlo) * GQ; jg += kWarps) {
        const int j = jlo + jg / GQ, g = jg - (jg / GQ) * GQ;
        if (RB == 0) {  // q.mn alone: one sum
          float part = 0.0f;
          for (int dd = lane; dd < D; dd += 32)
            part += q_s[g * D + dd] * ld(kmn + j * D + dd);
          part = warp_sum(part);
          if (lane == 0) qm_s[j * GQ + g] = part;
          continue;
        }
        for (int r0 = -1; r0 < RB; r0 += kSums) {
          float part[kSums];
#pragma unroll
          for (int u = 0; u < kSums; ++u) part[u] = 0.0f;
          for (int dd = lane; dd < D; dd += 32) {
            const float qv = q_s[g * D + dd];
#pragma unroll
            for (int u = 0; u < kSums; ++u) {
              const int rr = r0 + u;
              if (rr < 0)
                part[u] += qv * ld(kmn + j * D + dd);
              else if (rr < RB)
                part[u] += qv * ldb<BASE8>(S + L.kp, (j * R + rr) * D + dd);
            }
          }
          warp_sums<kSums>(part);
          if (lane == 0) {
#pragma unroll
            for (int u = 0; u < kSums; ++u) {
              const int rr = r0 + u;
              if (rr < 0) {
                qm_s[j * GQ + g] = part[u];
              } else if (rr < RB) {
                float v = part[u];
                if constexpr (BASE8)  // both int8 scales of (block, rank)
                  v *= kps[j * R + rr] * kqs[rr * NBT + j];
                qp_s[(j * GQ + g) * R + rr] = v;
              }
            }
          }
        }
      }
      // q.P0 per query row, once: the prefill's P rows landed with tile 0
      if (first) {
        for (int g = warp; g < GQ; g += kWarps) {
          for (int r0 = 0; r0 < R; r0 += kSums) {
            float part[kSums];
#pragma unroll
            for (int u = 0; u < kSums; ++u) part[u] = 0.0f;
            for (int dd = lane; dd < D; dd += 32) {
              const float qv = q_s[g * D + dd];
#pragma unroll
              for (int u = 0; u < kSums; ++u)
                if (r0 + u < R)
                  part[u] += qv * ldb<BASE8>(pre_p, (r0 + u) * D + dd);
            }
            warp_sums<kSums>(part);
            if (lane == 0) {
#pragma unroll
              for (int u = 0; u < kSums; ++u) {
                const int rr = r0 + u;
                if (rr < R) {
                  float v = part[u];
                  if constexpr (BASE8) v *= pre_sc[rr] * pre_sc[R + rr];
                  qp0_s[g * R + rr] = v;
                }
              }
            }
          }
        }
      }
    };
    // Per query row: the sums of p * vmn (j = -1, with vmn) and, per live
    // block j, of p * Q[r, t], a warp per (row, j) in turn, kSums reduced
    // together; a prefill tile sums p * Q[r, t] over the whole tile (j = 0),
    // for the running prefill term.
    auto v_sums = [&](const char* S, int jlo, int nbl, int tlo, int n_valid,
                    bool pre, bool vmn) {
      const bf16* vm = reinterpret_cast<const bf16*>(S + L.vm);
      const float* vps = reinterpret_cast<const float*>(S + L.vps);
      const float* vqs = reinterpret_cast<const float*>(S + L.vqs);
      for (int it = warp; it < GQ * (1 + NBT); it += kWarps) {
        const int g = it / (1 + NBT), j = it - g * (1 + NBT) - 1;
        if (j < 0 && !vmn) continue;
        const float* pg = p_s + g * kTile;
        const int jt0 = pre ? tlo : j * G, jt1 = pre ? n_valid : (j + 1) * G;
        if (j < 0) {
          for (int v0 = 0; v0 < NGV; v0 += kSums) {
            float part[kSums];
#pragma unroll
            for (int u = 0; u < kSums; ++u) part[u] = 0.0f;
            for (int tt = tlo + lane; tt < n_valid; tt += 32) {
              const float pv = pg[tt];
#pragma unroll
              for (int u = 0; u < kSums; ++u)
                if (v0 + u < NGV) part[u] += pv * ld(vm + (v0 + u) * kTile + tt);
            }
            warp_sums<kSums>(part);
            if (lane == 0) {
#pragma unroll
              for (int u = 0; u < kSums; ++u)
                if (v0 + u < NGV) pvm_s[g * NGV + v0 + u] = part[u];
            }
          }
        } else if (pre ? j == 0 : j >= jlo && j < nbl) {
          for (int r0 = 0; r0 < R; r0 += kSums) {
            float part[kSums];
#pragma unroll
            for (int u = 0; u < kSums; ++u) part[u] = 0.0f;
            for (int tt = jt0 + lane; tt < jt1; tt += 32) {
              const float pv = pg[tt];
#pragma unroll
              for (int u = 0; u < kSums; ++u)
                if (r0 + u < R)
                  part[u] += pv * ldb<BASE8>(S + L.vq, (r0 + u) * kTile + tt);
            }
            warp_sums<kSums>(part);
            if (lane == 0) {
#pragma unroll
              for (int u = 0; u < kSums; ++u) {
                const int rr = r0 + u;
                if (rr < R && pre) {  // [GQ][R]; the P scale at the end
                  float v = part[u];
                  if constexpr (BASE8) v *= pre_sc[3 * R + rr];
                  wv_s[g * R + rr] = v;
                } else if (rr < R) {
                  float v = part[u];
                  if constexpr (BASE8) v *= vqs[rr * NBT + j] * vps[j * R + rr];
                  wv_s[(g * NBT + j) * R + rr] = v;
                }
              }
            }
          }
        }
      }
    };

    // The tensor-core form (see the header): the K scores and the PV sums
    // as warpgroup MMAs over codes unpacked in registers. NBT = NGV = 2 and
    // WD = 4 BITS here; a thread owns query rows qa + 4 i (i < RPT).
    if constexpr (MMA) {
      constexpr int RPT = (GQ + 3) / 4;
      constexpr int NN = mma_cols(GQ);
      constexpr int NACC = NN / 2;         // accumulators of a chain
      constexpr int KSB = mma_kstep_bytes(GQ);
      constexpr int CHAIN = 8 * KSB;       // bytes of a chain's B
      constexpr int NSUM = 3 + kMmaRanks;  // running sums of a row
      constexpr uint32_t MASK2 = MASK | (MASK << 16);
      const int g8 = lane >> 2, qa = lane & 3;
      const uint32_t opnd_at = smem_addr(opnd);
      // K: rows g8 and g8 + 8 of warp w in chain j are the tokens
      // 64 j + tk and 64 j + tk + 1; the quad lane qa reads their words
      // 2 qa + (i & 1) + 8 (i >> 1), i < BITS.
      const int tk = 16 * warp + 2 * g8;
      // V: rows g8 and g8 + 8 of warp w in d-group gv are the channels
      // of bytes vb and vb + 1 of word vw, field vfield(gv); the quad's
      // four token columns of a k-step are four consecutive tokens.
      const int vw = 4 * (warp % BITS) + (g8 >> 2) + 2 * ((g8 & 3) >> 1);
      const int vb = 2 * (g8 & 1);
      const int vfl = warp / BITS;
      const uint32_t vsel = vb ? 0x7632u : 0x5410u;
      auto vfield = [&](int gv) { return gv * (VPB / 2) + vfl; };
      auto vch = [&](int gv, int rh) {
        return 4 * vw + vb + rh + stride_f * vfield(gv);
      };
      // K's B: a channel pair (d, d + 2) is rows kk and kk + 1 of a
      // k-step. This thread writes query rows fg + GL gh of the pairs
      // frest + (128 / GL) pu: a warp's lanes cover 4 rows and 4 word
      // pairs, so that its stores fall in 16 banks.
      constexpr int GL = GQ < 4 ? GQ : 4;
      const int fg = lane % GL, frest = lane / GL + (32 / GL) * warp;
      // PV's B: this thread's two tokens of chain j are rows kkv and
      // kkv + 1 of k-step 4 j + warp.
      const int kkv = 2 * (g8 >> 1) + 8 * (g8 & 1);

      float accv[2][NACC];  // PV sums, d-groups 0 and 1
      float m_own[RPT], l_own[RPT];
      // running sums over this thread's tokens: p (l_own), p * vmn per
      // d-group, and p * Q[r, t] over the prefill's tiles
      float vmn_own[RPT][2], qr_own[RPT][kMmaRanks];
      // running sums of the terms of one of the quad's four channels,
      // vch(qa >> 1, qa & 1), for every query row: its outlier segments
      // and the low-rank term of blocks past the prefill
      float ov[GQ];
#pragma unroll
      for (int g = 0; g < GQ; ++g) ov[g] = 0.0f;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        m_own[i] = -INFINITY;
        l_own[i] = 0.0f;
        vmn_own[i][0] = vmn_own[i][1] = 0.0f;
#pragma unroll
        for (int rr = 0; rr < kMmaRanks; ++rr) qr_own[i][rr] = 0.0f;
      }
#pragma unroll
      for (int x = 0; x < NACC; ++x) accv[0][x] = accv[1][x] = 0.0f;

      for (int k = 0; k < n_t; ++k) {
        cp_async_wait<kStages - 1>();
        bar_wait(smem_addr(bars + k % kStages), (k / kStages) & 1);
        __syncthreads();
        const bool next =
            PAGED && warp == 0 && lane < NBT && k + kStages < n_t;
        int next_row = 0, next_off = 0;
        if (next) page_of(k + kStages, next_row, next_off);
        const Geo tg = geo(k);
        const int t0 = tg.t0, n_valid = tg.n_valid, jlo = tg.jlo;
        const int nbl = tg.nbl, tlo = jlo * G;
        const bool pre = tg.pre;
        const char* S = smem + (k % kStages) * L.bytes;
        const bf16* ksc = reinterpret_cast<const bf16*>(S + L.ksc);

        // K's B per live quant block: q * scale in three bf16 pieces
        for (int j = jlo; j < nbl; ++j) {
          char* bj = opnd + j * CHAIN;
#pragma unroll
          for (int pu = 0; pu < GL / 2; ++pu) {
            // pair q: word 2 fa + fwl + 8 fwh of field fe, byte fhk
            const int q = frest + (128 / GL) * pu;
            const int fa = q & 3, fwl = (q >> 2) & 1, up = q >> 3;
            const int fhk = up & 1;
            const int fwh = BITS == 4 ? (up >> 1) & 1 : 0;
            const int fe = BITS == 4 ? up >> 2 : up >> 1;
            const int fd = stride_f * fe + 4 * (2 * fa + fwl + 8 * fwh) + fhk;
            const int fks = (2 * fwh + fwl) * VPB + fe, fkk = 8 * fhk + 2 * fa;
            const float s0 = ld(ksc + j * D + fd);
            const float s1 = ld(ksc + j * D + fd + 2);
#pragma unroll
            for (int gh = 0; gh < GQ / GL; ++gh) {
              const int g = fg + GL * gh;
              uint32_t pc[3];
              split3(__fmul_rn(q_s[g * D + fd], s0),
                     __fmul_rn(q_s[g * D + fd + 2], s1), pc[0], pc[1], pc[2]);
#pragma unroll
              for (int c = 0; c < 3; ++c)
                *reinterpret_cast<uint32_t*>(
                    bj + b_off(KSB, fks, fkk, mma_col(g >> 2, c, g & 3))) =
                    pc[c];
            }
          }
        }
        // q.mn and q.P per (live block, row), q.P0 once
        k_sums(S, jlo, nbl, pre ? 0 : R, k == 0 && has_pre);
        fence_async_smem();
        __syncthreads();  // K's B and the folds' sums ready

        // K scores, a quant block at a time (so that one chain's A
        // registers are live at once). While block 0's chain runs, each
        // lane of a quad forms the terms of one of the quad's four tokens
        // for every query row -- q.mn + (q.P).Q[:, t] + the token's
        // outlier segment -- and passes them through p_s (free until the
        // softmax): a lane walks one segment, not four.
        auto k_chain = [&](int jj, float* ck) {
          const uint32_t* kc =
              reinterpret_cast<const uint32_t*>(S + L.kc) + 64 * jj + tk;
          uint32_t a[8][4];
#pragma unroll
          for (int i = 0; i < BITS; ++i) {
            const int W = 2 * qa + (i & 1) + 8 * (i >> 1);
            const uint2 w =
                *reinterpret_cast<const uint2*>(kc + W * (kTile + 4));
#pragma unroll
            for (int e = 0; e < VPB; ++e) {
              a[i * VPB + e][0] = code_pair(w.x >> (BITS * e), MASK2);
              a[i * VPB + e][1] = code_pair(w.y >> (BITS * e), MASK2);
              a[i * VPB + e][2] = code_pair(w.x >> (8 + BITS * e), MASK2);
              a[i * VPB + e][3] = code_pair(w.y >> (8 + BITS * e), MASK2);
            }
          }
          const uint64_t desc = b_desc(opnd_at + jj * CHAIN);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < 8; ++ks)
            wgmma_rs<NN>(ck, a[ks], desc + ((ks * KSB) >> 4));
        };
        bool valid[2][2];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            valid[jj][h] =
                jj >= jlo && jj < nbl && t0 + 64 * jj + tk + h >= pad;
        float ck0[NACC], ck1[NACC];
#pragma unroll
        for (int x = 0; x < NACC; ++x) ck0[x] = ck1[x] = 0.0f;
        if (jlo <= 0 && 0 < nbl) k_chain(0, ck0);
        wgmma_commit();
        {
          const int jt = qa >> 1, tok = 64 * jt + tk + (qa & 1);
          float e[GQ];
#pragma unroll
          for (int g = 0; g < GQ; ++g) e[g] = 0.0f;
          if (jt >= jlo && jt < nbl && t0 + tok >= pad) {
            const float* qpj = pre ? qp0_s : qp_s + jt * GQ * R;
#pragma unroll
            for (int g = 0; g < GQ; ++g) e[g] = qm_s[jt * GQ + g];
            for (int rr = 0; rr < R; ++rr) {
              const float kq = ldb<BASE8>(S + L.kq, rr * kTile + tok);
#pragma unroll
              for (int g = 0; g < GQ; ++g) e[g] += qpj[g * R + rr] * kq;
            }
            if (KO) {  // the token's segment, in entry order
              const int32_t* kob = reinterpret_cast<const int32_t*>(S + L.kob);
              const int32_t* koi = reinterpret_cast<const int32_t*>(S + L.koi);
              const bf16* kov = reinterpret_cast<const bf16*>(S + L.kov);
              const int tl = tok - 64 * jt;
              const int lo = tl ? kob[jt * kBnd + tl - 1] + 1 : 0;
              const int hi =
                  min(kob[jt * kBnd + tl], KO - 1) - (tl ? 0 : p.out_pad);
              for (int x = max(lo, 0); x <= hi; ++x) {
                const int dd = out_idx(koi + jt * KOH, x, KOH) & (D - 1);
                const float delta = ld(kov + jt * KO + x);
#pragma unroll
                for (int g = 0; g < GQ; ++g) e[g] += q_s[g * D + dd] * delta;
              }
            }
          }
#pragma unroll
          for (int g = 0; g < GQ; ++g) p_s[g * kTile + tok] = e[g];
        }
        __syncwarp();
        float sc[2][2][RPT];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int i = 0; i < RPT; ++i)
              sc[jj][h][i] = qa + 4 * i < GQ
                                 ? p_s[(qa + 4 * i) * kTile + 64 * jj + tk + h]
                                 : 0.0f;
        wgmma_wait_all();
        wgmma_touch<NACC>(ck0);
        if (jlo <= 1 && 1 < nbl) k_chain(1, ck1);
        wgmma_commit();
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i = 0; i < RPT; ++i)
            sc[0][h][i] += (ck0[mma_acc(i, 0, h)] + ck0[mma_acc(i, 1, h)]) +
                           ck0[mma_acc(i, 2, h)];
        wgmma_wait_all();
        wgmma_touch<NACC>(ck1);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i = 0; i < RPT; ++i)
            sc[1][h][i] += (ck1[mma_acc(i, 0, h)] + ck1[mma_acc(i, 1, h)]) +
                           ck1[mma_acc(i, 2, h)];

        // Online softmax over the tile: a row's scores lie in the 8
        // lanes of its quad lane in each warp. The sum of p is a running
        // sum of the lane's own tokens, reduced once a block.
        float alpha_own[RPT], pr[2][2][RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          float mx = -INFINITY;
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              if (valid[jj][h]) mx = fmaxf(mx, sc[jj][h][i]);
#pragma unroll
          for (int o = 4; o < 32; o <<= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
          if (g8 == 0 && qa + 4 * i < GQ)
            red_max[(qa + 4 * i) * kWarps + warp] = mx;
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int g = qa + 4 * i;
          float ps = 0.0f;
          alpha_own[i] = 1.0f;
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)
            pr[jj][0][i] = pr[jj][1][i] = 0.0f;
          if (g < GQ) {
            float tmax = -INFINITY;
#pragma unroll
            for (int w = 0; w < kWarps; ++w)
              tmax = fmaxf(tmax, red_max[g * kWarps + w]);
            const float m_new = fmaxf(m_own[i], tmax);
            alpha_own[i] =
                m_new == -INFINITY ? 1.0f : expf(m_own[i] - m_new);
            if (warp == 0 && g8 == 0) alpha_s[g] = alpha_own[i];
#pragma unroll
            for (int jj = 0; jj < 2; ++jj)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float pv =
                    valid[jj][h] ? expf(sc[jj][h][i] - m_new) : 0.0f;
                pr[jj][h][i] = pv;
                p_s[g * kTile + 64 * jj + tk + h] = pv;
                ps += pv;
              }
            m_own[i] = m_new;
          }
          l_own[i] = l_own[i] * alpha_own[i] + ps;
        }

        // PV's B per d-group: p * vscale in three bf16 pieces; the
        // running sums of p * vmn and, in a prefill tile, p * Q[r, t]
        const bf16* vs = reinterpret_cast<const bf16*>(S + L.vs);
        const bf16* vm = reinterpret_cast<const bf16*>(S + L.vm);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int g = qa + 4 * i;
          if (g >= GQ) continue;
#pragma unroll
          for (int gv = 0; gv < 2; ++gv) vmn_own[i][gv] *= alpha_own[i];
#pragma unroll
          for (int rr = 0; rr < kMmaRanks; ++rr) qr_own[i][rr] *= alpha_own[i];
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int tok = 64 * jj + tk;
            const float p0 = pr[jj][0][i], p1 = pr[jj][1][i];
            const bool v0 = valid[jj][0], v1 = valid[jj][1];
#pragma unroll
            for (int gv = 0; gv < 2; ++gv) {
              const bf16* vsg = vs + gv * kTile + tok;
              const bf16* vmg = vm + gv * kTile + tok;
              uint32_t pc[3];
              split3(v0 ? __fmul_rn(p0, ld(vsg)) : 0.0f,
                     v1 ? __fmul_rn(p1, ld(vsg + 1)) : 0.0f, pc[0], pc[1],
                     pc[2]);
#pragma unroll
              for (int c = 0; c < 3; ++c)
                *reinterpret_cast<uint32_t*>(
                    opnd + gv * CHAIN +
                    b_off(KSB, 4 * jj + warp, kkv, mma_col(i, c, qa))) =
                    pc[c];
              vmn_own[i][gv] += (v0 ? p0 * ld(vmg) : 0.0f) +
                                (v1 ? p1 * ld(vmg + 1) : 0.0f);
            }
            if (pre) {
#pragma unroll
              for (int rr = 0; rr < kMmaRanks; ++rr) {
                if (rr >= R) break;
                const int at = rr * kTile + tok;
                qr_own[i][rr] +=
                    (v0 ? p0 * ldb<BASE8>(S + L.vq, at) : 0.0f) +
                    (v1 ? p1 * ldb<BASE8>(S + L.vq, at + 1) : 0.0f);
              }
            }
          }
        }
        // a block past the prefill: sum_t p * Q[r, t] per (row, block),
        // once every thread's p is in p_s
        if (!pre) {
          __syncthreads();
          v_sums(S, jlo, nbl, tlo, n_valid, false, false);
        }
        fence_async_smem();
        __syncthreads();  // PV's B and wv_s ready

        // PV: the sums rescaled; then, a quant block at a time, its 4
        // k-steps of 16 tokens as 2 MMAs each (one per d-group), issued
        // and waited for. While block 0's run, each lane of a quad adds
        // the terms of one of the quad's four channels for every query
        // row into its running sums ov: the low-rank term past the
        // prefill, the outlier segments.
#pragma unroll
        for (int x = 0; x < NACC; ++x) {
          constexpr int kNc = 3 * RPT;
          const int c = 2 * (x / 4) + (x & 1);
          if (c < kNc) {
            accv[0][x] *= alpha_own[c / 3];
            accv[1][x] *= alpha_own[c / 3];
          }
        }
        const uint32_t* vc =
            reinterpret_cast<const uint32_t*>(S + L.vc) + vw * kTile + 4 * qa;
        const int sv0 = BITS * vfield(0), sv1 = BITS * vfield(1);
        auto v_group = [&](int jj) {
#pragma unroll
          for (int kq = 0; kq < 4; ++kq) {
            const int ks = 4 * jj + kq;
            const uint4 x = *reinterpret_cast<const uint4*>(vc + 16 * ks);
            const uint32_t lo = __byte_perm(x.x, x.y, vsel);
            const uint32_t hi = __byte_perm(x.z, x.w, vsel);
            const uint32_t a0[4] = {
                code_pair(lo >> sv0, MASK2), code_pair(lo >> (sv0 + 8), MASK2),
                code_pair(hi >> sv0, MASK2), code_pair(hi >> (sv0 + 8), MASK2)};
            const uint32_t a1[4] = {
                code_pair(lo >> sv1, MASK2), code_pair(lo >> (sv1 + 8), MASK2),
                code_pair(hi >> sv1, MASK2), code_pair(hi >> (sv1 + 8), MASK2)};
            wgmma_fence();
            wgmma_rs<NN>(accv[0], a0, b_desc(opnd_at) + ((ks * KSB) >> 4));
            wgmma_rs<NN>(accv[1], a1,
                         b_desc(opnd_at + CHAIN) + ((ks * KSB) >> 4));
          }
        };
        if (jlo <= 0 && 0 < nbl) v_group(0);
        wgmma_commit();
        {
          const int ch = vch(qa >> 1, qa & 1);
#pragma unroll
          for (int g = 0; g < GQ; ++g) ov[g] *= alpha_s[g];
          const int32_t* vob = reinterpret_cast<const int32_t*>(S + L.vob);
          const int32_t* voi = reinterpret_cast<const int32_t*>(S + L.voi);
          const bf16* vov = reinterpret_cast<const bf16*>(S + L.vov);
          for (int j = jlo; j < nbl; ++j) {
            if (!pre) {  // the block's own P: (sum_t p * Q[r, t]) * P[r, d]
              for (int rr = 0; rr < R; ++rr) {
                const float pe = ldb<BASE8>(S + L.vp, (j * R + rr) * D + ch);
#pragma unroll
                for (int g = 0; g < GQ; ++g)
                  ov[g] += wv_s[(g * NBT + j) * R + rr] * pe;
              }
            }
            if (KO) {  // the channel's segment of the block, in entry order
              const int lo = ch ? vob[j * kBnd + ch - 1] + 1 : 0;
              const int hi =
                  min(vob[j * kBnd + ch], KO - 1) - (ch ? 0 : p.out_pad);
              for (int x = max(lo, 0); x <= hi; ++x) {
                const int tl = min(out_idx(voi + j * KOH, x, KOH) >> 7, G - 1);
                const float delta = ld(vov + j * KO + x);
#pragma unroll
                for (int g = 0; g < GQ; ++g)
                  ov[g] += p_s[g * kTile + j * G + tl] * delta;
              }
            }
          }
        }
        wgmma_wait_all();
        wgmma_touch<NACC>(accv[0]);
        wgmma_touch<NACC>(accv[1]);
        if (jlo <= 1 && 1 < nbl) {
          v_group(1);
          wgmma_commit();
          wgmma_wait_all();
          wgmma_touch<NACC>(accv[0]);
          wgmma_touch<NACC>(accv[1]);
        }
        // lookup slot k % kStages: its last reader was issue(k)
        if (next) put_page(k + kStages, next_row, next_off);
        __syncthreads();  // every read of stage k % kStages is done
        issue(k + kStages);
      }
      cp_async_wait<0>();  // no copy outlives the block

      // The running sums over the block's tokens, reduced over the
      // lanes of a row (xor 4, 8, 16), then the warps (through q_s, which
      // the loop's last barrier freed, as [kWarps][GQ][NSUM]); each
      // lane's channel terms ov to their rows' owners through p_s
      // ([GQ][D])
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
#pragma unroll
          for (int gv = 0; gv < 2; ++gv)
            vmn_own[i][gv] += __shfl_xor_sync(0xffffffffu, vmn_own[i][gv], o);
#pragma unroll
          for (int rr = 0; rr < kMmaRanks; ++rr)
            qr_own[i][rr] += __shfl_xor_sync(0xffffffffu, qr_own[i][rr], o);
          l_own[i] += __shfl_xor_sync(0xffffffffu, l_own[i], o);
        }
      }
      float* red = q_s;  // free now, as is p_s
#pragma unroll
      for (int g = 0; g < GQ; ++g) p_s[g * D + vch(qa >> 1, qa & 1)] = ov[g];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int g = qa + 4 * i;
        if (g8 != 0 || g >= GQ) continue;
        float* r = red + (warp * GQ + g) * NSUM;
        r[0] = vmn_own[i][0];
        r[1] = vmn_own[i][1];
#pragma unroll
        for (int rr = 0; rr < kMmaRanks; ++rr) r[2 + rr] = qr_own[i][rr];
        r[NSUM - 1] = l_own[i];
      }
      __syncthreads();
      const size_t slot = static_cast<size_t>(bh) * NS + split;
      const char* pv0 = pre_p + R * D * BEL;  // the prefill's V P rows
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int g = qa + 4 * i;
        if (g >= GQ) continue;
        float tot[NSUM];
#pragma unroll
        for (int u = 0; u < NSUM; ++u) {
          tot[u] = 0.0f;
#pragma unroll
          for (int w = 0; w < kWarps; ++w)
            tot[u] += red[(w * GQ + g) * NSUM + u];
        }
#pragma unroll
        for (int gv = 0; gv < 2; ++gv) {
#pragma unroll
          for (int rh = 0; rh < 2; ++rh) {
            const int ch = vch(gv, rh);
            float v = (accv[gv][mma_acc(i, 0, rh)] +
                       accv[gv][mma_acc(i, 1, rh)]) +
                      accv[gv][mma_acc(i, 2, rh)] + tot[gv] +
                      p_s[g * D + ch];
            if (has_pre) {  // sum_r (sum_t p * Q[r, t]) * P0[r, d]
#pragma unroll
              for (int rr = 0; rr < kMmaRanks; ++rr) {
                if (rr >= R) break;
                float w = tot[2 + rr];
                if constexpr (BASE8)
                  w *= pre_sc[3 * R + rr] * pre_sc[2 * R + rr];
                v += w * ldb<BASE8>(pv0, rr * D + ch);
              }
            }
            p.part_acc[(slot * GQ + g) * D + ch] = v;
          }
        }
        if (warp == 0 && g8 == 0) {
          p.part_ml[(slot * GQ + g) * 2] = m_own[i];
          p.part_ml[(slot * GQ + g) * 2 + 1] = tot[NSUM - 1];
        }
      }
      return;
    }

    for (int k = 0; k < n_t; ++k) {
      // groups issued: up to k + kStages - 1; at most kStages - 1 in flight
      // means tile k has landed (this thread's copies) ...
      cp_async_wait<kStages - 1>();
      // ... and the bulk copies (the stage's k / kStages-th phase) ...
      bar_wait(smem_addr(bars + k % kStages), (k / kStages) & 1);
      __syncthreads();  // ... everyone's; and stage (k - 1)'s readers are done
      // the pages of tile k + kStages: loaded now, stored after this tile's
      // math, so that the load's latency hides behind it
      const bool next = PAGED && warp == 0 && lane < NBT && k + kStages < n_t;
      int next_row = 0, next_off = 0;
      if (next) page_of(k + kStages, next_row, next_off);
      const Geo tg = geo(k);
      const int t0 = tg.t0, n_valid = tg.n_valid, jlo = tg.jlo, nbl = tg.nbl;
      const bool pre = tg.pre;
      const int RB = pre ? 0 : R;  // ranks of a per-block P
      const int tlo = jlo * G;
      const char* S = smem + (k % kStages) * L.bytes;
      const bf16* ksc = reinterpret_cast<const bf16*>(S + L.ksc);

      // K folds per live quant block of the tile: qs = q * scale, one thread
      // per channel; then q.mn and q.P_blk per (block, query row), dealt to
      // the warps in turn.
      if (has_d) {
        for (int j = jlo; j < nbl; ++j) {
          const float sc = ld(ksc + j * D + tid);
#pragma unroll
          for (int g = 0; g < GQ; ++g)
            qs_s[(j * GQ + g) * D + tid] = q_s[g * D + tid] * sc;
        }
      }
      // K outliers, in a fixed share a thread (not per token, whose
      // segments differ in length): every live entry's terms q[g][d] *
      // delta, which each token's thread then sums over its segment
      if (kTerms && KO) {
        const int32_t* koi = reinterpret_cast<const int32_t*>(S + L.koi);
        const bf16* kov = reinterpret_cast<const bf16*>(S + L.kov);
        const int32_t* kob = reinterpret_cast<const int32_t*>(S + L.kob);
        for (int j = jlo; j < nbl; ++j) {
          const int pad_hi = kob[j * kBnd];  // the padding ends token 0's
          for (int e = tid; e < KO; e += kTile) {
            if (e > pad_hi - p.out_pad && e <= pad_hi) continue;
            const int idx = out_idx(koi + j * KOH, e, KOH);
            const int dd = dsh >= 0 ? idx & (D - 1) : idx % D;
            const float delta = ld(kov + j * KO + e);
            float* o = ot_s + (j * KO + e) * GQ;
#pragma unroll
            for (int g = 0; g < GQ; ++g) o[g] = q_s[g * D + dd] * delta;
          }
        }
      }
      k_sums(S, jlo, nbl, RB, k == 0 && has_pre);
      __syncthreads();

      // Scores: one thread per token, its code words from the stage.
      const bool valid = tid < n_valid && t0 + tid >= pad;
#pragma unroll
      for (int g = 0; g < GQ; ++g) s[g] = 0.0f;
      if (valid) {
        const int j = tid / G;
        const float* qsj = qs_s + j * GQ * D;
        const uint32_t* kc = reinterpret_cast<const uint32_t*>(S + L.kc) + tid;
        // Word w holds, in byte kk and field f, the code of channel
        // 4w + kk + f * stride_f: per field, four consecutive channels,
        // whose scale-folded q is one float4.
        for (int w = 0; w < WD; ++w) {
          const uint32_t word = kc[w * kTile];
#pragma unroll
          for (int f = 0; f < VPB; ++f) {
            const uint32_t bytes = (word >> (f * BITS)) & kByteMask;
            const float c0 = code_at<0>(bytes), c1 = code_at<1>(bytes);
            const float c2 = code_at<2>(bytes), c3 = code_at<3>(bytes);
            const float4* q4 =
                reinterpret_cast<const float4*>(qsj + 4 * w + f * stride_f);
#pragma unroll
            for (int g = 0; g < GQ; ++g)
              s[g] = dot4<GQ>(s[g], q4[g * D / 4], c0, c1, c2, c3);
          }
        }
#pragma unroll
        for (int g = 0; g < GQ; ++g) s[g] += qm_s[j * GQ + g];
        // (q.P) of the token's block: q.P0 in a prefill tile
        const float* qpj = pre ? qp0_s : qp_s + j * GQ * R;
        for (int rr = 0; rr < R; ++rr) {
          const float kq = ldb<BASE8>(S + L.kq, rr * kTile + tid);
#pragma unroll
          for (int g = 0; g < GQ; ++g) s[g] += qpj[g * R + rr] * kq;
        }
        if (KO) {  // this token's outlier segment, in entry order
          const int32_t* kob = reinterpret_cast<const int32_t*>(S + L.kob);
          const int tl = tid - j * G;
          const int lo = tl ? kob[j * kBnd + tl - 1] + 1 : 0;
          const int hi =
              min(kob[j * kBnd + tl], KO - 1) - (tl ? 0 : p.out_pad);
          if constexpr (kTerms) {
            const float* o = ot_s + j * KO * GQ;
            for (int e = max(lo, 0); e <= hi; ++e)
              add_terms<GQ>(s, o + e * GQ);
          } else {  // q[d] * delta, entry by entry
            const int32_t* koi = reinterpret_cast<const int32_t*>(S + L.koi);
            const bf16* kov = reinterpret_cast<const bf16*>(S + L.kov);
            for (int e = max(lo, 0); e <= hi; ++e) {
              const int idx = out_idx(koi + j * KOH, e, KOH);
              const int dd = dsh >= 0 ? idx & (D - 1) : idx % D;
              const float delta = ld(kov + j * KO + e);
#pragma unroll
              for (int g = 0; g < GQ; ++g) s[g] += q_s[g * D + dd] * delta;
            }
          }
        }
      }
      softmax_tile<GQ>(s, valid, p_s, red_max, red_sum, m_run, l_run, alpha);

      // PV folds: p * vscale per (token, d-group); sum_t p * vmn per
      // d-group; sum_t p * Q[r, t] per live quant block, both int8 scales
      // folded in (the low-rank term then costs R multiply-adds per channel
      // per block, not per token). Only tokens in [tlo, n_valid) are read.
      const bf16* vs = reinterpret_cast<const bf16*>(S + L.vs);
#pragma unroll
      for (int g = 0; g < GQ; ++g)
        for (int gv = 0; gv < NGV; ++gv)
          pvs_s[(g * NGV + gv) * kTile + tid] =
              p_s[g * kTile + tid] * ld(vs + gv * kTile + tid);
      // V outliers, in a fixed share a thread: every live entry's terms
      // p[g][t] * delta, which each channel's thread then sums over its
      // segment (the K terms in ot_s were read before the softmax)
      if (kTerms && KO) {
        const int32_t* voi = reinterpret_cast<const int32_t*>(S + L.voi);
        const bf16* vov = reinterpret_cast<const bf16*>(S + L.vov);
        const int32_t* vob = reinterpret_cast<const int32_t*>(S + L.vob);
        for (int j = jlo; j < nbl; ++j) {
          const int pad_hi = vob[j * kBnd];  // the padding ends channel 0's
          for (int e = tid; e < KO; e += kTile) {
            if (e > pad_hi - p.out_pad && e <= pad_hi) continue;
            const int idx = out_idx(voi + j * KOH, e, KOH);
            const int tl = min(dsh >= 0 ? idx >> dsh : idx / D, G - 1);
            const float delta = ld(vov + j * KO + e);
            float* o = ot_s + (j * KO + e) * GQ;
#pragma unroll
            for (int g = 0; g < GQ; ++g)
              o[g] = p_s[g * kTile + j * G + tl] * delta;
          }
        }
      }
      v_sums(S, jlo, nbl, tlo, n_valid, pre, true);
      __syncthreads();

      // PV: one thread per channel.
      if (has_d) {
#pragma unroll
        for (int g = 0; g < GQ; ++g) {
          float a = acc[g] * alpha[g] + pvm_s[g * NGV + grp_me];
          for (int i = jlo * RB; i < nbl * RB; ++i)
            a += wv_s[g * NBT * R + i] * ldb<BASE8>(S + L.vp, i * D + tid);
          acc[g] = a;
        }
        // Four tokens at a time: their code words are one uint4 (tlo and
        // n_valid are multiples of the group, itself a multiple of 4), and
        // p * vscale of each query row one float4.
        const uint32_t* vc =
            reinterpret_cast<const uint32_t*>(S + L.vc) + w_me * (kTile + 4);
        const float* pvs = pvs_s + grp_me * kTile;
        for (int tt = tlo; tt < n_valid; tt += 4) {
          const uint4 w4 = *reinterpret_cast<const uint4*>(vc + tt);
          const float c0 = small_code(w4.x >> shift_me, MASK);
          const float c1 = small_code(w4.y >> shift_me, MASK);
          const float c2 = small_code(w4.z >> shift_me, MASK);
          const float c3 = small_code(w4.w >> shift_me, MASK);
#pragma unroll
          for (int g = 0; g < GQ; ++g)
            acc[g] = dot4<GQ>(
                acc[g],
                *reinterpret_cast<const float4*>(pvs + g * NGV * kTile + tt),
                c0, c1, c2, c3);
        }
        if (KO) {  // this channel's outlier segments, in entry order
          const int32_t* vob = reinterpret_cast<const int32_t*>(S + L.vob);
          for (int j = jlo; j < nbl; ++j) {
            const int lo = tid ? vob[j * kBnd + tid - 1] + 1 : 0;
            const int hi =
                min(vob[j * kBnd + tid], KO - 1) - (tid ? 0 : p.out_pad);
            if constexpr (kTerms) {
              const float* o = ot_s + j * KO * GQ;
              for (int e = max(lo, 0); e <= hi; ++e)
                add_terms<GQ>(acc, o + e * GQ);
            } else {  // p[t] * delta, entry by entry
              const int32_t* voi = reinterpret_cast<const int32_t*>(S + L.voi);
              const bf16* vov = reinterpret_cast<const bf16*>(S + L.vov);
              for (int e = max(lo, 0); e <= hi; ++e) {
                const int idx = out_idx(voi + j * KOH, e, KOH);
                const int tl = min(dsh >= 0 ? idx >> dsh : idx / D, G - 1);
                const float delta = ld(vov + j * KO + e);
#pragma unroll
                for (int g = 0; g < GQ; ++g)
                  acc[g] += p_s[g * kTile + j * G + tl] * delta;
              }
            }
          }
        }
      }
      // the running prefill term follows acc: rescaled every tile, and it
      // takes a prefill tile's sum
      if (has_pre && tid < GQ * R) {
        float a = alpha[0];
#pragma unroll
        for (int g = 1; g < GQ; ++g)
          if (tid / R == g) a = alpha[g];
        wv0_s[tid] = wv0_s[tid] * a + (pre ? wv_s[tid] : 0.0f);
      }
      // lookup slot k % kStages: its last reader was issue(k)
      if (next) put_page(k + kStages, next_row, next_off);
      __syncthreads();  // every read of stage k % kStages is done
      issue(k + kStages);
    }
    cp_async_wait<0>();  // no copy outlives the block
    // the prefill's term: sum_r (sum_t p * Q[r, t]) * P0[r, d], once
    if (has_pre && has_d) {
      const char* pv = pre_p + R * D * BEL;
#pragma unroll
      for (int g = 0; g < GQ; ++g) {
        for (int rr = 0; rr < R; ++rr) {
          float w = wv0_s[g * R + rr];
          if constexpr (BASE8) w *= pre_sc[2 * R + rr];
          acc[g] += w * ldb<BASE8>(pv, rr * D + tid);
        }
      }
    }
  } else {
    // Residual tier: at most `group` <= kTile bf16 tokens. Its K and V rows
    // ([resid_len][D] each, contiguous) come in as one batch of 16-byte
    // asynchronous copies into the first region (the ring, which this
    // split does not use); scores a warp per token, lanes over channel
    // quads, and PV a thread per channel, from shared memory.
    const int n_valid = resid_len;
    bf16* kr = reinterpret_cast<bf16*>(smem);
    bf16* vr = kr + G * D;
    const size_t row0 = static_cast<size_t>(bh) * G * D;
    for (int i = tid; i < n_valid * D / 8; i += kTile) {
      cp_async16(kr + 8 * i, p.k_resid + row0 + 8 * i);
      cp_async16(vr + 8 * i, p.v_resid + row0 + 8 * i);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();  // q_s and the rows ready
    for (int tt = warp; tt < n_valid; tt += kWarps) {
      float part[GQ];
#pragma unroll
      for (int g = 0; g < GQ; ++g) part[g] = 0.0f;
      if (4 * lane < D) {
        const uint2 k4 = *reinterpret_cast<const uint2*>(kr + tt * D + 4 * lane);
        const float k0 = __uint_as_float(k4.x << 16);
        const float k1 = __uint_as_float(k4.x & 0xFFFF0000u);
        const float k2 = __uint_as_float(k4.y << 16);
        const float k3 = __uint_as_float(k4.y & 0xFFFF0000u);
#pragma unroll
        for (int g = 0; g < GQ; ++g)
          part[g] = dot4<2>(0.0f,
                            *reinterpret_cast<const float4*>(q_s + g * D + 4 * lane),
                            k0, k1, k2, k3);
      }
      warp_sums<GQ>(part);
      if (lane == 0) {
#pragma unroll
        for (int g = 0; g < GQ; ++g) p_s[g * kTile + tt] = part[g];
      }
    }
    __syncthreads();
    const bool valid = tid < n_valid;
#pragma unroll
    for (int g = 0; g < GQ; ++g) s[g] = valid ? p_s[g * kTile + tid] : 0.0f;
    // (softmax_tile syncs before it overwrites p_s)
    softmax_tile<GQ>(s, valid, p_s, red_max, red_sum, m_run, l_run, alpha);
    if (has_d) {
      int tt = 0;
      for (; tt + 4 <= n_valid; tt += 4) {  // p of four tokens: one float4
        const float v0 = ld(vr + tt * D + tid), v1 = ld(vr + (tt + 1) * D + tid);
        const float v2 = ld(vr + (tt + 2) * D + tid);
        const float v3 = ld(vr + (tt + 3) * D + tid);
#pragma unroll
        for (int g = 0; g < GQ; ++g)
          acc[g] = dot4<2>(acc[g],
                           *reinterpret_cast<const float4*>(p_s + g * kTile + tt),
                           v0, v1, v2, v3);
      }
      for (; tt < n_valid; ++tt) {
        const float v = ld(vr + tt * D + tid);
#pragma unroll
        for (int g = 0; g < GQ; ++g) acc[g] += p_s[g * kTile + tt] * v;
      }
    }
  }

  store_partial<GQ>(p.part_acc, p.part_ml,
                    static_cast<size_t>(bh) * NS + split, D, has_d, m_run,
                    l_run, acc);
}

template <int BITS, int GQ, bool BASE8, bool PAGED>
__global__ void __launch_bounds__(kTile, min_blocks(BITS, GQ))
decode_split_kernel(Params p) {
  if constexpr (mma_codes(BITS, GQ)) {
    if (mma_form(BITS, GQ, p.d, p.group, p.v_group, p.r)) {
      split_body<BITS, GQ, BASE8, PAGED, true>(p);
      return;
    }
  }
  split_body<BITS, GQ, BASE8, PAGED, false>(p);
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

// One signature for both forms; the lengths are in device memory only, so
// the launch holds none (n_split and tiles_per_split, planned by the
// caller, cover every tile the lengths may reach). Dense: block_table is
// null, maxp and pb 0, lens [3] the comp, resid and prefill lengths all
// rows share. Paged: t and nb are a sequence's capacity (MAXP * PB * group
// tokens, MAXP * PB blocks), lens [B, 3] each row's lengths. smem:
// the shared memory per block that kernels/decode.py planned; it must equal
// this file's own count (a check that the two stay in step).
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
    int v_group, int base8, int ko, int out_pad, int n_split,
    int tiles_per_split, int maxp, int pb, int smem,
    cudaStream_t stream) {
  if (kTile % group != 0 || d > kTile || d % 8 != 0 || group > kTile ||
      group % 4 != 0 || ko % 2 != 0 || out_pad < 0 || out_pad > ko || !lens)
    return cudaErrorInvalidValue;
  // the stage's 16-byte copies need 16-byte aligned leaves
  const void* leaves[] = {k_codes, k_scale, k_mn, kpt, kqt, v_codes, v_scale,
                          v_mn, vpt, vqt, kpt_scale, kqt_scale, vpt_scale,
                          vqt_scale, k_out_idx, k_out_val, k_out_bnd,
                          v_out_idx, v_out_val, v_out_bnd, k_resid, v_resid};
  for (const void* leaf : leaves)
    if (reinterpret_cast<uintptr_t>(leaf) & 15) return cudaErrorMisalignedAddress;
  if (kPaged && !(block_table && maxp > 0 && pb > 0 &&
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
  p.n_split = n_split;
  p.tiles_per_split = tiles_per_split;
  constexpr int kBits = GEAR_DECODE_BITS;
  const size_t want = split_smem_bytes(gq, d, kBits, r, group, v_group, ko,
                                       base8 != 0, kPaged);
  if (static_cast<size_t>(smem) != want) return cudaErrorInvalidValue;
  const cudaError_t e =
      base8 ? launch_gq<kBits, true>(p, bh, gq, want, stream)
            : launch_gq<kBits, false>(p, bh, gq, want, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(bh, gq);
  attn_merge_kernel<<<grid, d, 0, stream>>>(part_acc, part_ml, out,
                                            n_split + 1, gq, d);
  return static_cast<int>(cudaGetLastError());
}
