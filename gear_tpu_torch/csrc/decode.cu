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
// Design: every byte of a tile in flight at once, and the next tile's
// while this one computes.
//  * grid (BH rows, 1 + token splits). Split 0 attends the residual tier;
//    each other block walks its split's tiles of 128 tokens (one thread per
//    token) below comp_len; tiles and quant blocks wholly left of pad_start
//    are neither copied nor read. A second tiny kernel merges the splits'
//    (max, sum, acc) states, flash-decoding style.
//  * Staging: a ring of kStages = 2 stages in shared memory, each holding
//    everything one tile reads (Stage below): K and V code words, V scales
//    and minima, kqt / vqt columns, K scales and minima, kpt / vpt rows, the
//    int8 base scales, the outlier index words, deltas and boundary tables.
//    One quant block's tokens are a run of G consecutive elements in every
//    [rows, X, T] leaf, and its per-block rows are runs too, so the whole
//    tile is a list of runs: the block's threads issue them as 16-byte
//    cp.async copies (4-byte where a run is not a multiple of 16 bytes), one
//    commit group per tile. Tile k + 2's group is issued as soon as tile k's
//    math is done, so while a tile computes the next one is in flight; each
//    tile then costs one wait (cp.async.wait_group 1) and one barrier where
//    the simple form had some 15 dependent trips to device memory.
//  * Paged: warp 0 looks up the pages of tile k + 2's quant blocks at the
//    start of tile k (lrow_s / loff_s, one slot per stage), so the table is
//    off the critical path; the page of a block is then only the source
//    address of its runs.
//  * K scores: per quant block the scale folds into q once
//    (qs = q * scale), and q.mn and q.P_blk are reduced once (int8 bases:
//    times both scales there), all from the stage; each thread then unpacks
//    its token's code words from the stage and adds
//    qs.code + q.mn + (q.P_blk).Q[:, t].
//  * PV: p * vscale is formed per token, and sum p * vmn and sum p * Q[:, t]
//    per block (int8: times both scales) are reduced once, so one thread per
//    channel accumulates (p * vscale) * code per token plus a few per-tile
//    terms. V code rows are padded to kTile + 4 words: the 8 words a warp
//    reads at one token fall in 8 banks.
//  * Outliers: the TPU kernel's one-hot dots and running-sum gathers stand
//    in for a scatter it does not have. K entries are sorted by token, so
//    the thread of token t walks its own segment bnd[t-1]+1 .. bnd[t] and
//    adds q[d] * delta to its scores; V entries are sorted by channel, so
//    the PV thread of channel d walks its segment and adds p[t] * delta.
//    No atomics, a fixed order. The padding entries up to the stored count
//    (idx 0, delta 0) are the last out_pad entries of token 0's / channel
//    0's segment (the stable sort keeps them behind that key's real
//    entries); those two threads stop before them.
//  * Shared memory at D = 128, group 64, rank 4, 256 stored outliers: a
//    stage is 22,656 / 30,976 / 47,616 bytes at int2 / int4 / int8 with bf16
//    bases; with the float32 working buffers a block takes 43-121 KB
//    (kernels/decode.py::decode_smem_bytes counts it, and this file checks
//    the count), three blocks an SM at int2 / int4 with GQ <= 4, fewer
//    otherwise; min_blocks holds the registers to that.
//  * float32 throughout; online softmax with -inf for masked tokens.
// Faster forms (wgmma products, reading the shared prefill P once, one
// score product over a KCVT prefill region) are later work.
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

// Entry e of a block's packed outlier indices (KO/2 words in shared memory).
__device__ __forceinline__ int out_idx(const int32_t* words, int e, int koh) {
  const uint32_t w = static_cast<uint32_t>(words[e < koh ? e : e - koh]);
  return static_cast<int>(e < koh ? (w & 0xFFFFu) : (w >> 16));
}

// The ring: kStages stages, each holding every byte one tile needs. Stage
// k % kStages takes the block's k-th tile; its pages sit in lookup slot
// k % kStages.
constexpr int kStages = 2;
constexpr int kVws = kTile + 4;  // staged V code row (int32): 16-byte rows,
                                 // and PV's 8 words a warp reads fall in 8 banks

// Byte offsets of the pieces of one stage: [WD][kTile] K code words,
// [WD][kVws] V code words, [NGV][kTile] V scales and minima, [R][kTile]
// kqt and vqt columns, [NBT][D] K scales and minima, [NBT][R][D] kpt and vpt
// rows, int8 base scales [NBT][R] (kpt, vpt) and [R][NBT] (kqt, vqt),
// outlier index words [NBT][KO/2], deltas [NBT][KO] and boundary tables
// [NBT][kBnd] for K and for V. Each piece starts on 16 bytes.
struct Stage {
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
                                              bool base8) {
  const int nbt = kTile / group, ngv = d / v_group, wd = d * bits / 32;
  const int bel = base8 ? 1 : 2;
  const int sc = base8 ? nbt * r * 4 : 0;
  Stage s;
  int at = 0;
  s.kc = take(at, wd * kTile * 4);
  s.vc = take(at, wd * kVws * 4);
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

// Shared memory of one block: the ring, then float32 working buffers, then
// the page lookups (kernels/decode.py::decode_smem_bytes counts the same).
size_t split_smem_bytes(int gq, int d, int bits, int r, int group,
                        int v_group, int ko, bool base8, bool paged) {
  const int nbt = kTile / group;
  const int ngv = d / v_group;
  size_t floats = 0;
  floats += gq * d;                 // q_s
  floats += nbt * gq * d;           // qs_s
  floats += gq * ngv * kTile;       // pvs_s
  floats += gq * kTile;             // p_s
  floats += nbt * gq;               // qm_s
  floats += nbt * gq * r;           // qp_s
  floats += 2 * gq * kWarps;        // red_max, red_sum
  floats += gq * ngv;               // pvm_s
  floats += gq * nbt * r;           // wv_s
  if (paged) floats += 2 * kStages * nbt;  // lrow_s, loff_s (int32)
  return static_cast<size_t>(kStages) *
             stage_layout(d, bits, r, group, v_group, ko, base8).bytes +
         floats * sizeof(float);
}

// Blocks per SM that the register budget is held to (65,536 / (128 x n)
// registers a thread: 168 at 3, 255 at 2). At D = 128, group 64, rank 4 and
// 256 stored outliers a block takes 43-75 KB of shared memory at int2/int4
// with GQ <= 4, so three fit on an SM (228 KB, 1 KB of it reserved per
// block); int8 codes or GQ = 8 take 65-121 KB, two or one.
constexpr int min_blocks(int bits, int gq) {
  return bits == 8 || gq == 8 ? 2 : 3;
}

// One asynchronous copy of 16 or 4 bytes (every run of the stage starts at
// a multiple of its own size from a leaf aligned to 16 bytes, so a run whose
// size is a multiple of 16 is copied in 16-byte pieces, others in 4-byte
// ones).
__device__ __forceinline__ void copy_piece(char* dst, const char* src,
                                           int bytes) {
  if (bytes == 16)
    cp_async16(dst, src);
  else
    cp_async4(dst, src);
}

template <int BITS, int GQ, bool BASE8, bool PAGED>
__global__ void __launch_bounds__(kTile, min_blocks(BITS, GQ))
decode_split_kernel(Params p) {
  extern __shared__ uint4 smem_v[];
  char* smem = reinterpret_cast<char*>(smem_v);
  constexpr int VPB = 8 / BITS;
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  constexpr uint32_t kByteMask = MASK * 0x01010101u;  // MASK in every byte
  constexpr int BEL = BASE8 ? 1 : 2;  // bytes of a base element
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
  const Stage L = stage_layout(D, BITS, R, G, p.v_group, KO, BASE8);

  // working buffers; those read as float4 first, each a multiple of four
  // floats, so that they start on 16 bytes
  float* q_s = reinterpret_cast<float*>(smem + kStages * L.bytes);
  float* qs_s = q_s + GQ * D;
  float* pvs_s = qs_s + NBT * GQ * D;
  float* p_s = pvs_s + GQ * NGV * kTile;
  float* qm_s = p_s + GQ * kTile;
  float* qp_s = qm_s + NBT * GQ;
  float* red_max = qp_s + NBT * GQ * R;
  float* red_sum = red_max + GQ * kWarps;
  float* pvm_s = red_sum + GQ * kWarps;
  float* wv_s = pvm_s + GQ * NGV;
  // paged: leaf row (page * hkv + head) and block offset in the page of
  // each quant block of the tile in each stage, [kStages][NBT]
  int32_t* lrow_s = reinterpret_cast<int32_t*>(wv_s + GQ * NBT * R);
  int32_t* loff_s = lrow_s + kStages * NBT;

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
    const int pad = p.pad_start[seq];
    const int ntiles = (comp_len + kTile - 1) / kTile;
    // tiles wholly left of the padding are skipped
    const int tile_lo = max(csplit * p.tiles_per_split, pad / kTile);
    const int tile_hi =
        min(ntiles, csplit * p.tiles_per_split + p.tiles_per_split);
    const int n_t = max(0, tile_hi - tile_lo);

    // The block's k-th tile: first token, valid tokens (a multiple of the
    // group: comp_len is), live quant blocks [jlo, nbl) (those wholly left
    // of the padding are neither copied nor read).
    struct Geo {
      int t0, n_valid, jlo, nbl;
    };
    auto geo = [&](int k) {
      Geo t;
      t.t0 = (tile_lo + k) * kTile;
      t.n_valid = min(kTile, comp_len - t.t0);
      t.nbl = t.n_valid / G;
      t.jlo = pad > t.t0 ? (pad - t.t0) / G : 0;
      return t;
    };
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
        // [X][row] token pieces of a [rows, X, TS] leaf of el-byte elements:
        // per live block, X runs of G * el bytes (a power of two, as G is)
        auto tok_runs = [&](int off, int row, const void* src, int X,
                            int el) {
          const int bytes = G * el;
          const int cs = (bytes & 15) ? 4 : 16;  // bytes a copy
          const int lp = __ffs(bytes / cs) - 1;  // log2 of copies a run
          for (int j = jlo; j < tg.nbl; ++j) {
            const char* from =
                static_cast<const char*>(src) + run_at(X, j) * el;
            char* to = S + off + j * bytes;
            for (int i = tid; i < X << lp; i += kTile) {
              const int x = i >> lp, c = (i & ((1 << lp) - 1)) * cs;
              copy_piece(to + x * row * el + c,
                         from + static_cast<size_t>(x) * TS * el + c, cs);
            }
          }
        };
        // [NBT][bytes] per-block pieces of a [rows, NBS, ...] leaf
        auto blk_runs = [&](int off, const void* src, int bytes) {
          const int cs = (bytes & 15) ? 4 : 16;
          for (int j = jlo; j < tg.nbl; ++j) {
            const char* from = static_cast<const char*>(src) + blk_at(j) * bytes;
            char* to = S + off + j * bytes;
            for (int c = tid * cs; c < bytes; c += kTile * cs)
              copy_piece(to + c, from + c, cs);
          }
        };
        // [R][NBT] lanes of a [rows, R, NBS] f32 leaf
        auto lane_runs = [&](int off, const float* src) {
          for (int i = tid; i < R * nb; i += kTile) {
            const int x = i / nb, j = jlo + i - x * nb;
            cp_async4(S + off + (x * NBT + j) * 4, src + lane_at(x, j));
          }
        };
        tok_runs(L.kc, kTile, p.k_codes, WD, 4);
        tok_runs(L.vc, kVws, p.v_codes, WD, 4);
        tok_runs(L.vs, kTile, p.v_scale, NGV, 2);
        tok_runs(L.vm, kTile, p.v_mn, NGV, 2);
        tok_runs(L.kq, kTile, p.kqt, R, BEL);
        tok_runs(L.vq, kTile, p.vqt, R, BEL);
        blk_runs(L.ksc, p.k_scale, D * 2);
        blk_runs(L.kmn, p.k_mn, D * 2);
        blk_runs(L.kp, p.kpt, R * D * BEL);
        blk_runs(L.vp, p.vpt, R * D * BEL);
        if constexpr (BASE8) {
          blk_runs(L.kps, p.kpt_scale, R * 4);
          blk_runs(L.vps, p.vpt_scale, R * 4);
          lane_runs(L.kqs, p.kqt_scale);
          lane_runs(L.vqs, p.vqt_scale);
        }
        if (KO) {
          blk_runs(L.koi, p.k_out_idx, KOH * 4);
          blk_runs(L.voi, p.v_out_idx, KOH * 4);
          blk_runs(L.kov, p.k_out_val, KO * 2);
          blk_runs(L.vov, p.v_out_val, KO * 2);
          blk_runs(L.kob, p.k_out_bnd, kBnd * 4);
          blk_runs(L.vob, p.v_out_bnd, kBnd * 4);
        }
      }
      cp_async_commit();
    };

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

    for (int k = 0; k < n_t; ++k) {
      // groups issued: up to k + kStages - 1; at most kStages - 1 in flight
      // means tile k has landed (this thread's copies) ...
      cp_async_wait<kStages - 1>();
      __syncthreads();  // ... everyone's; and stage (k - 1)'s readers are done
      // the pages of tile k + kStages: loaded now, stored after this tile's
      // math, so that the load's latency hides behind it
      const bool next = PAGED && warp == 0 && lane < NBT && k + kStages < n_t;
      int next_row = 0, next_off = 0;
      if (next) page_of(k + kStages, next_row, next_off);
      const Geo tg = geo(k);
      const int t0 = tg.t0, n_valid = tg.n_valid, jlo = tg.jlo, nbl = tg.nbl;
      const int tlo = jlo * G;
      const char* S = smem + (k % kStages) * L.bytes;
      const bf16* ksc = reinterpret_cast<const bf16*>(S + L.ksc);
      const bf16* kmn = reinterpret_cast<const bf16*>(S + L.kmn);
      const float* kps = reinterpret_cast<const float*>(S + L.kps);
      const float* vps = reinterpret_cast<const float*>(S + L.vps);
      const float* kqs = reinterpret_cast<const float*>(S + L.kqs);
      const float* vqs = reinterpret_cast<const float*>(S + L.vqs);

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
      // q.mn (r = -1) and q.P_blk per (live block, query row): a warp per
      // pair in turn, kSums of the sums reduced together.
      for (int jg = warp; jg < (nbl - jlo) * GQ; jg += kWarps) {
        const int j = jlo + jg / GQ, g = jg - (jg / GQ) * GQ;
        for (int r0 = -1; r0 < R; r0 += kSums) {
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
              else if (rr < R)
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
              } else if (rr < R) {
                float v = part[u];
                if constexpr (BASE8)  // both int8 scales of (block, rank)
                  v *= kps[j * R + rr] * kqs[rr * NBT + j];
                qp_s[(j * GQ + g) * R + rr] = v;
              }
            }
          }
        }
      }
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
        for (int rr = 0; rr < R; ++rr) {
          const float kq = ldb<BASE8>(S + L.kq, rr * kTile + tid);
#pragma unroll
          for (int g = 0; g < GQ; ++g) s[g] += qp_s[(j * GQ + g) * R + rr] * kq;
        }
        if (KO) {  // this token's outlier segment: q[d] * delta
          const int32_t* kob = reinterpret_cast<const int32_t*>(S + L.kob);
          const int32_t* koi = reinterpret_cast<const int32_t*>(S + L.koi);
          const bf16* kov = reinterpret_cast<const bf16*>(S + L.kov);
          const int tl = tid - j * G;
          const int lo = tl ? kob[j * kBnd + tl - 1] + 1 : 0;
          const int hi =
              min(kob[j * kBnd + tl], KO - 1) - (tl ? 0 : p.out_pad);
          for (int e = max(lo, 0); e <= hi; ++e) {
            const int dd = out_idx(koi + j * KOH, e, KOH) % D;
            const float delta = ld(kov + j * KO + e);
#pragma unroll
            for (int g = 0; g < GQ; ++g) s[g] += q_s[g * D + dd] * delta;
          }
        }
      }
      softmax_tile<GQ>(s, valid, p_s, red_max, red_sum, m_run, l_run, alpha);

      // PV folds: p * vscale per (token, d-group); sum_t p * vmn per
      // d-group; sum_t p * Q[r, t] per live quant block, both int8 scales
      // folded in (the low-rank term then costs R multiply-adds per channel
      // per block, not per token). Only tokens in [tlo, n_valid) are read.
      const bf16* vs = reinterpret_cast<const bf16*>(S + L.vs);
      const bf16* vm = reinterpret_cast<const bf16*>(S + L.vm);
#pragma unroll
      for (int g = 0; g < GQ; ++g)
        for (int gv = 0; gv < NGV; ++gv)
          pvs_s[(g * NGV + gv) * kTile + tid] =
              p_s[g * kTile + tid] * ld(vs + gv * kTile + tid);
      // per query row: the sums of p * vmn (j = -1) and, per live block j,
      // of p * Q[r, t], a warp per (row, j) in turn, kSums reduced together
      for (int it = warp; it < GQ * (1 + NBT); it += kWarps) {
        const int g = it / (1 + NBT), j = it - g * (1 + NBT) - 1;
        const float* pg = p_s + g * kTile;
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
        } else if (j >= jlo && j < nbl) {
          for (int r0 = 0; r0 < R; r0 += kSums) {
            float part[kSums];
#pragma unroll
            for (int u = 0; u < kSums; ++u) part[u] = 0.0f;
            for (int tt = j * G + lane; tt < (j + 1) * G; tt += 32) {
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
                if (rr < R) {
                  float v = part[u];
                  if constexpr (BASE8) v *= vqs[rr * NBT + j] * vps[j * R + rr];
                  wv_s[(g * NBT + j) * R + rr] = v;
                }
              }
            }
          }
        }
      }
      __syncthreads();

      // PV: one thread per channel.
      if (has_d) {
#pragma unroll
        for (int g = 0; g < GQ; ++g) {
          float a = acc[g] * alpha[g] + pvm_s[g * NGV + grp_me];
          for (int i = jlo * R; i < nbl * R; ++i)
            a += wv_s[g * NBT * R + i] * ldb<BASE8>(S + L.vp, i * D + tid);
          acc[g] = a;
        }
        // Four tokens at a time: their code words are one uint4 (tlo and
        // n_valid are multiples of the group, itself a multiple of 4), and
        // p * vscale of each query row one float4.
        const uint32_t* vc =
            reinterpret_cast<const uint32_t*>(S + L.vc) + w_me * kVws;
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
        if (KO) {  // this channel's outlier segments: p[t] * delta
          const int32_t* vob = reinterpret_cast<const int32_t*>(S + L.vob);
          const int32_t* voi = reinterpret_cast<const int32_t*>(S + L.voi);
          const bf16* vov = reinterpret_cast<const bf16*>(S + L.vov);
          for (int j = jlo; j < nbl; ++j) {
            const int lo = tid ? vob[j * kBnd + tid - 1] + 1 : 0;
            const int hi =
                min(vob[j * kBnd + tid], KO - 1) - (tid ? 0 : p.out_pad);
            for (int e = max(lo, 0); e <= hi; ++e) {
              const int tl = min(out_idx(voi + j * KOH, e, KOH) / D, G - 1);
              const float delta = ld(vov + j * KO + e);
#pragma unroll
              for (int g = 0; g < GQ; ++g)
                acc[g] += p_s[g * kTile + j * G + tl] * delta;
            }
          }
        }
      }
      // lookup slot k % kStages: its last reader was issue(k)
      if (next) put_page(k + kStages, next_row, next_off);
      __syncthreads();  // every read of stage k % kStages is done
      issue(k + kStages);
    }
    cp_async_wait<0>();  // no copy outlives the block
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
// comp_len a host bound on every row's comp_len, resid_len unused. smem:
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
    int v_group, int base8, int ko, int out_pad, int comp_len, int resid_len,
    int n_split, int tiles_per_split, int maxp, int pb, int smem,
    cudaStream_t stream) {
  if (kTile % group != 0 || d > kTile || d % 8 != 0 || group > kTile ||
      group % 4 != 0 || ko % 2 != 0 || out_pad < 0 || out_pad > ko)
    return cudaErrorInvalidValue;
  // the stage's 16-byte copies need 16-byte aligned leaves
  const void* leaves[] = {k_codes, k_scale, k_mn, kpt, kqt, v_codes, v_scale,
                          v_mn, vpt, vqt, kpt_scale, kqt_scale, vpt_scale,
                          vqt_scale, k_out_idx, k_out_val, k_out_bnd,
                          v_out_idx, v_out_val, v_out_bnd};
  for (const void* leaf : leaves)
    if (reinterpret_cast<uintptr_t>(leaf) & 15) return cudaErrorMisalignedAddress;
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
