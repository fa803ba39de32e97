// The cache's flush, one launch a layer, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference's flush (gear_tpu/cache.py
// _flush) is jitted XLA, and the port's plain version
// (gear_tpu_torch/kernels/flush.py flush_plain) runs it as some 340
// operations of plain PyTorch a layer. This kernel does that layer's whole
// flush, K and V, in place: the residual tier's group of tokens becomes
// codes, sidebands, sorted COO outliers and low-rank error bases at block
// c0 / group of the cache's storages.
//
// Grid (B, H, 2): one block a row, kv head and tensor (K | V). A block
// holds its [group x D] residual group in shared memory as float32 and:
//   1. (outliers) selects the ko/2 largest and ko/2 smallest values, the
//      lower index first among equals (core/outliers.top_k_stable): a radix
//      select over the values' 16-bit order keys (they are bf16), 8 bits a
//      pass, both sides at once, then, where a threshold value's ties are
//      not all taken, a count in index order; ranks the chosen entries in
//      the order the sorts give them, marks the smallest entries whose
//      position is also a largest one (duplicates), and puts the block mean
//      in their places;
//   2. takes each channel's (K, over the tokens) or each token group's (V,
//      v_group channels) min and max, the step and the codes, and packs
//      them byte-strided, word-major transposed: quant_common.cuh's
//      arithmetic and layout, which B2/B3 share, bit for bit;
//   3. (outliers) computes each entry's delta, exact - dequant(code, stored
//      sidebands), 0 for duplicates and padding, sorts the entries stably by
//      token (K) or channel (V) with the padding last, and writes the 16-bit
//      index pairs and the 128-lane boundary table;
//   4. (low rank) forms the error x - x_hat with the outliers restored, runs
//      the power iteration from the start the wrapper hands in (products in
//      float32 FMA, the unrolled Gram-Schmidt on the last iteration only, as
//      core/lowrank._power_iterate), and stores P and Q^T in bf16, or as
//      int8 with absmax scales.
// The sums (block mean, products) are taken in a fixed order, so a flush
// gives the same bits every time; they differ from PyTorch's orders, which
// moves the code stored at an outlier position by at most one step (the
// block mean; ROADMAP C) and the bases within float32 rounding.
//
// Bound on the card: a layer reads its residual tier (2 x B x H x group x D
// bf16) and writes its codes, sidebands, outliers and bases, ~6 MB at the
// Mistral-7B GEAR int4 batch of 16: ~2 us at 3.35 TB/s. The kernel is bound
// by latency instead (the selection's passes, reductions, the power
// iteration's serial steps), with one block of 512 threads a row, head and
// tensor, and nothing but its residual group read from device memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRank = 8;    // a flush's rank and r_store, at most
constexpr int kBndLanes = 128;
constexpr unsigned kFull = 0xFFFFFFFFu;

// One tensor's operands (K or V), the layer's leaves as the cache has them.
struct Side {
  const __nv_bfloat16* resid;  // [B, H, G, D]
  int32_t* codes;              // [B, H, D / fpi, T]
  __nv_bfloat16* scale;        // K: [B, H, NB, D]; V: [B, H, D / vg, T]
  __nv_bfloat16* mn;
  int32_t* out_idx;            // [B, H, NB, KS / 2]
  __nv_bfloat16* out_val;      // [B, H, NB, KS]
  int32_t* out_bnd;            // [B, H, NB, 128]
  void* pt;                    // [B, H, NB, R, D], bf16 or int8
  void* qt;                    // [B, H, R, T]
  float* pt_scale;             // [B, H, NB, R]
  float* qt_scale;             // [B, H, R, NB]
  const float* p0;             // [B, H, D, rank]: the power iteration's start
  int rank;
};

struct Dims {
  int heads, d, g, t_len, n_blocks, c0, ko, ks, r_store, loop, vg, lowrank;
};

// A block's shared arrays, as offsets in 4-byte words.
struct Layout {
  int xs, cs, sc, mn, scs, mns, ps, qs, red, misc;
  int hist, khist, intop, cand, ent_idx, ent_exact, ent_dup,
      ent_val, ent_key, sidx, total;
};

__host__ __device__ inline int max_i(int a, int b) { return a > b ? a : b; }

__host__ __device__ inline Layout layout(const Dims& s, bool outliers) {
  Layout m = {};
  const int n = s.g * s.d;
  const int nseg = max_i(s.d, s.g * (s.d / s.vg));
  int at = 0;
  m.xs = at;    at += n;                     // the group: values, then error
  m.cs = at;    at += s.g * (s.d / 4 + 1);   // codes, a byte each, rows padded
  m.sc = at;    at += nseg;                  // f32 step of each channel / group
  m.mn = at;    at += nseg;
  m.scs = at;   at += nseg;                  // the same, rounded as stored
  m.mns = at;   at += nseg;
  m.ps = at;    at += s.d * kMaxRank;        // P [kMaxRank][D]
  m.qs = at;    at += s.g * kMaxRank;        // Q [kMaxRank][G]
  m.red = at;   at += 2 * kWarps + 1;
  m.misc = at;  at += 16;
  if (outliers) {
    m.hist = at;      at += 512;             // radix bins: largest, smallest
    m.khist = at;     at += kBndLanes;       // entries a token / channel
    m.intop = at;     at += (n + 31) / 32;   // positions among the largest
    m.cand = at;      at += s.ko;              // chosen keys: largest, smallest
    m.ent_idx = at;   at += s.ks;
    m.ent_exact = at; at += s.ks;
    m.ent_dup = at;   at += s.ks;
    m.ent_val = at;   at += s.ks;
    m.ent_key = at;   at += s.ks;
    m.sidx = at;      at += s.ks;
  }
  m.total = at;
  return m;
}

// misc slots
enum { kPre = 0, kNeed = 2, kEq = 4, kCnt = 6, kMean = 8 };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// The sum of every thread's v, in a fixed order, handed to every thread.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kWarps ? red[lane] : 0.0f;
    t = warp_sum(t);
    if (lane == 0) red[kWarps] = t;
  }
  __syncthreads();
  return red[kWarps];
}

// Inclusive sums of a and b over the threads in their order, in place.
// scratch: 2 * kWarps ints.
__device__ void block_scan(int& a, int& b, int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int ya = __shfl_up_sync(kFull, a, o);
    const int yb = __shfl_up_sync(kFull, b, o);
    if (lane >= o) {
      a += ya;
      b += yb;
    }
  }
  if (lane == 31) {
    scratch[warp] = a;
    scratch[kWarps + warp] = b;
  }
  __syncthreads();
  for (int w = 0; w < warp; ++w) {
    a += scratch[w];
    b += scratch[kWarps + w];
  }
  __syncthreads();
}

// Order-preserving key of a float: larger value, larger key; -0 ranks with
// +0, as the comparison sort has them (equal, so the index decides).
__device__ __forceinline__ uint32_t ordered(float x) {
  uint32_t b = __float_as_uint(x);
  if ((b << 1) == 0) b = 0;
  return b ^ ((b & 0x80000000u) ? kFull : 0x80000000u);
}

// hist[bin] += 1 (and mirror[255 - bin] += 1, where given) for each lane
// with `on`: one shared atomic per bin a warp, or one a lane where few are
// on. Every lane of the warp calls it.
__device__ __forceinline__ void hist_add(int* hist, int* mirror, uint32_t bin,
                                         bool on) {
  const unsigned active = __ballot_sync(kFull, on);
  if (!on) return;
  int add = 1;
  if (__popc(active) > 4) {
    const unsigned peers = __match_any_sync(active, bin);
    if ((threadIdx.x & 31) != __ffs(peers) - 1) return;
    add = __popc(peers);
  }
  atomicAdd(hist + bin, add);
  if (mirror) atomicAdd(mirror + 255 - bin, add);
}

// One warp: of 256 bins counted from the top (bin 255 first), the bin in
// which the running count reaches *need; its digit joins *prefix at
// `shift`, *need becomes what is still wanted inside it and *eq its count.
__device__ void pick_bin(const int* hist, uint32_t* prefix, int* need,
                         int* eq, int shift) {
  const int lane = threadIdx.x & 31;
  int c[8], sum = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    c[k] = hist[255 - 8 * lane - k];
    sum += c[k];
  }
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  const int nd = *need;
  const unsigned hit = __ballot_sync(kFull, incl >= nd);
  const int at = __ffs(hit) - 1;
  if (lane == at) {
    int cum = incl - sum;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (cum + c[k] >= nd) {
        *prefix |= static_cast<uint32_t>(255 - 8 * at - k) << shift;
        *need = nd - cum;
        *eq = c[k];
        break;
      }
      cum += c[k];
    }
  }
  __syncwarp();
}

// One warp: modified Gram-Schmidt over the first r columns of a
// column-major [r][len] array (len <= 128), as core/lowrank._thin_qr_q.
__device__ void gram_schmidt(float* a, int len, int r) {
  const int lane = threadIdx.x & 31;
  for (int i = 0; i < r; ++i) {
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = lane + 32 * k;
      v[k] = e < len ? a[i * len + e] : 0.0f;
    }
    for (int j = 0; j < i; ++j) {
      float dot = 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int e = lane + 32 * k;
        if (e < len) dot = fmaf(a[j * len + e], v[k], dot);
      }
      dot = warp_sum(dot);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int e = lane + 32 * k;
        if (e < len)
          v[k] = __fsub_rn(v[k], __fmul_rn(dot, a[j * len + e]));
      }
    }
    float ss = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) ss = fmaf(v[k], v[k], ss);
    const float nrm = fmaxf(sqrtf(warp_sum(ss)), 1e-12f);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = lane + 32 * k;
      if (e < len) a[i * len + e] = __fdiv_rn(v[k], nrm);
    }
    __syncwarp();
  }
}

template <int BITS, bool OUTLIERS, bool BASE8>
__global__ void __launch_bounds__(kThreads)
flush_kernel(Side k_side, Side v_side, Dims s) {
  constexpr float kLevels = quant_levels<BITS>();
  constexpr int VPB = 8 / BITS;
  extern __shared__ __align__(16) uint32_t smem[];
  const Layout L = layout(s, OUTLIERS);
  const bool is_v = blockIdx.z == 1;
  const Side& side = is_v ? v_side : k_side;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d = s.d, g = s.g, n = g * d;
  const int bh = blockIdx.x * s.heads + blockIdx.y;
  const int blk = s.c0 / g;
  const int ngv = d / s.vg;
  const int cstr = d + 4;  // bytes of a row of codes
  float* xs = reinterpret_cast<float*>(smem + L.xs);
  uint8_t* cs = reinterpret_cast<uint8_t*>(smem + L.cs);
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  float* mnv = reinterpret_cast<float*>(smem + L.mn);
  float* scs = reinterpret_cast<float*>(smem + L.scs);
  float* mns = reinterpret_cast<float*>(smem + L.mns);
  float* ps = reinterpret_cast<float*>(smem + L.ps);
  float* qs = reinterpret_cast<float*>(smem + L.qs);
  float* red = reinterpret_cast<float*>(smem + L.red);
  uint32_t* misc = smem + L.misc;
  int* misc_i = reinterpret_cast<int*>(misc);

  // the sideband of element (t, c): its channel (K) or token group (V)
  // row (token) of a flat index, and the token group of a channel: shifts
  // where D and v_group are powers of two, as they are in practice
  const bool d_pow2 = (d & (d - 1)) == 0, vg_pow2 = (s.vg & (s.vg - 1)) == 0;
  const int d_sh = __ffs(d) - 1, vg_sh = __ffs(s.vg) - 1;
  auto row_of = [&](int i) { return d_pow2 ? i >> d_sh : i / d; };
  auto seg_of = [&](int t, int c) {
    return is_v ? t * ngv + (vg_pow2 ? c >> vg_sh : c / s.vg) : c;
  };
  auto code_of = [&](float x, int seg) {
    return quant_code(__fsub_rn(x, mnv[seg]), quant_divisor(sc[seg]),
                      kLevels);
  };
  auto deq = [&](uint32_t code, int seg) {
    return __fadd_rn(__fmul_rn(static_cast<float>(code), scs[seg]), mns[seg]);
  };

  // 0. the group, as float32 (bf16 widens exactly), 8 values a 16-byte
  // load, all of a thread's loads in flight at once; its sum for the mean
  {
    const uint4* src = reinterpret_cast<const uint4*>(
        side.resid + static_cast<int64_t>(bh) * n);
    constexpr int kLoads = 128 * 128 / 8 / kThreads;  // the largest group
    uint4 raw[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int at = tid + k * kThreads;
      if (at < n / 8) raw[k] = src[at];
    }
    float part = 0.0f;
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int at = tid + k * kThreads;
      if (at < n / 8) {
        const uint32_t w[4] = {raw[k].x, raw[k].y, raw[k].z, raw[k].w};
        float x[8];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          x[2 * e] = __uint_as_float(w[e] << 16);
          x[2 * e + 1] = __uint_as_float(w[e] & 0xFFFF0000u);
        }
        float4* to = reinterpret_cast<float4*>(xs + 8 * at);
        to[0] = make_float4(x[0], x[1], x[2], x[3]);
        to[1] = make_float4(x[4], x[5], x[6], x[7]);
#pragma unroll
        for (int e = 0; e < 8; ++e) part += x[e];
      }
    }
    if constexpr (OUTLIERS) {
      if (tid == 0) {
        misc[kPre] = misc[kPre + 1] = 0;
        misc_i[kNeed] = misc_i[kNeed + 1] = s.ko / 2;
        misc_i[kEq] = misc_i[kEq + 1] = 0;
        misc_i[kCnt] = misc_i[kCnt + 1] = 0;
      }
      uint32_t* intop = smem + L.intop;
      for (int i = tid; i < (n + 31) / 32; i += kThreads) intop[i] = 0;
      const float total = block_sum(part, red);  // (synchronises)
      if (tid == 0) misc[kMean] = __float_as_uint(__fdiv_rn(total, n));
    } else {
      __syncthreads();
    }
  }

  // 1. outliers
  if constexpr (OUTLIERS) {
    const int half = s.ko / 2;
    int* hist = reinterpret_cast<int*>(smem + L.hist);
    uint32_t* intop = smem + L.intop;
    uint32_t* cand = smem + L.cand;
    int* ent_idx = reinterpret_cast<int*>(smem + L.ent_idx);
    float* ent_exact = reinterpret_cast<float*>(smem + L.ent_exact);
    int* ent_dup = reinterpret_cast<int*>(smem + L.ent_dup);
    // Element i's key on each side: its value's order (16 bits: the values
    // are bf16) for the largest, the reversed order for the smallest, over
    // 0xFFFF - i. Keys are distinct, and a larger key is a larger (smaller)
    // value, or an equal one at a lower index: top_k_stable's order. A radix
    // select over the value's 16 bits, 8 a pass, finds each side's
    // threshold value; where its ties are not all taken, a count in index
    // order finds the last one taken.
    auto keys = [&](int i, uint32_t& kt, uint32_t& kb) {
      const uint32_t u = ordered(xs[i]) >> 16, j = 0xFFFFu - i;
      kt = (u << 16) | j;
      kb = ((u ^ 0xFFFFu) << 16) | j;
    };
    for (int pass = 0; pass < 2; ++pass) {
      const int shift = 24 - 8 * pass;
      for (int b = tid; b < 512; b += kThreads) hist[b] = 0;
      __syncthreads();
      const uint32_t pt = misc[kPre], pb = misc[kPre + 1];
      for (int base = 0; base < n; base += kThreads) {
        const int i = base + tid;
        const bool in = i < n;
        uint32_t kt = 0, kb = 0;
        if (in) keys(i, kt, kb);
        if (pass == 0) {  // the two sides' first bins mirror each other
          hist_add(hist, hist + 256, kt >> 24, in);
        } else {
          hist_add(hist, nullptr, (kt >> 16) & 255u,
                   in && (kt >> 24) == (pt >> 24));
          hist_add(hist + 256, nullptr, (kb >> 16) & 255u,
                   in && (kb >> 24) == (pb >> 24));
        }
      }
      __syncthreads();
      if (warp < 2)
        pick_bin(hist + 256 * warp, misc + kPre + warp, misc_i + kNeed + warp,
                 misc_i + kEq + warp, shift);
      __syncthreads();
    }
    const bool split_t = misc_i[kNeed] < misc_i[kEq];
    const bool split_b = misc_i[kNeed + 1] < misc_i[kEq + 1];
    if (split_t || split_b) {
      // each thread counts the ties in its run of indices; the run that
      // holds the need-th tie (in index order) sets the threshold's index
      const uint32_t vt = misc[kPre] >> 16, vb = misc[kPre + 1] >> 16;
      const int nt = misc_i[kNeed], nb = misc_i[kNeed + 1];
      const int per = (n + kThreads - 1) / kThreads;
      const int lo = tid * per, hi = min(lo + per, n);
      int ct = 0, cb = 0;
      for (int i = lo; i < hi; ++i) {
        const uint32_t u = ordered(xs[i]) >> 16;
        ct += split_t && u == vt;
        cb += split_b && (u ^ 0xFFFFu) == vb;
      }
      int et = ct, eb = cb;  // counts before this thread's run
      block_scan(et, eb, reinterpret_cast<int*>(red));
      et -= ct;
      eb -= cb;
      if ((et < nt && nt <= et + ct) || (eb < nb && nb <= eb + cb)) {
        for (int i = lo; i < hi; ++i) {
          const uint32_t u = ordered(xs[i]) >> 16;
          if (split_t && u == vt && ++et == nt)
            misc[kPre] = (vt << 16) | (0xFFFFu - i);
          if (split_b && (u ^ 0xFFFFu) == vb && ++eb == nb)
            misc[kPre + 1] = (vb << 16) | (0xFFFFu - i);
        }
      }
      __syncthreads();
    }
    // the chosen keys, in any order (a threshold's index bits are 0 where
    // every tie is taken)
    {
      const uint32_t tt = misc[kPre], tb = misc[kPre + 1];
      for (int i = tid; i < n; i += kThreads) {
        uint32_t kt, kb;
        keys(i, kt, kb);
        if (kt >= tt) cand[atomicAdd(misc_i + kCnt, 1)] = kt;
        if (kb >= tb) cand[half + atomicAdd(misc_i + kCnt + 1, 1)] = kb;
      }
    }
    __syncthreads();
    // their places: the largest by value descending, then the smallest by
    // value ascending, the lower index first among equals; the padding last
    for (int c = tid; c < s.ko; c += kThreads) {
      const int base = c < half ? 0 : half;
      const uint32_t key = cand[c];
      const int i = 0xFFFF - static_cast<int>(key & 0xFFFFu);
      int r = 0;
      for (int q = base; q < base + half; ++q) r += cand[q] > key;
      ent_idx[base + r] = i;
      ent_exact[base + r] = xs[i];
      if (base == 0) atomicOr(intop + (i >> 5), 1u << (i & 31));
    }
    for (int p = s.ko + tid; p < s.ks; p += kThreads) {
      ent_idx[p] = 0;
      ent_exact[p] = 0.0f;
    }
    __syncthreads();
    // duplicates (a smallest entry at a largest one's place) and padding
    // carry delta 0; the outliers' places take the block mean
    const float mean = __uint_as_float(misc[kMean]);
    for (int p = tid; p < s.ks; p += kThreads) {
      const int i = ent_idx[p];
      ent_dup[p] = p >= s.ko ||
                   (p >= half && ((intop[i >> 5] >> (i & 31)) & 1u));
      if (p < s.ko) xs[i] = mean;
    }
    __syncthreads();
  }

  // 2. sidebands: min and max of each channel (K) or token group (V)
  {
    const int nseg = is_v ? g * ngv : d;
    const int len = is_v ? s.vg : g;
    const int sstr = is_v ? s.vg : 1, estr = is_v ? 1 : d;
    int lanes = 1;  // lanes a segment: a power of two
    while (lanes < 32 && 2 * lanes * nseg <= kThreads && 2 * lanes <= len)
      lanes *= 2;
    const int per = kThreads / lanes;
    for (int base = 0; base < nseg; base += per) {
      const int sg = base + tid / lanes, sub = tid % lanes;
      float lo = __int_as_float(0x7F800000), hi = __int_as_float(0xFF800000);
      if (sg < nseg) {
        for (int e = sub; e < len; e += lanes) {
          const float x = xs[sg * sstr + e * estr];
          lo = fminf(lo, x);
          hi = fmaxf(hi, x);
        }
      }
      for (int o = 1; o < lanes; o <<= 1) {
        lo = fminf(lo, __shfl_xor_sync(kFull, lo, o));
        hi = fmaxf(hi, __shfl_xor_sync(kFull, hi, o));
      }
      if (sg < nseg && sub == 0) {
        const float step = quant_step<BITS>(lo, hi);
        const __nv_bfloat16 sb = __float2bfloat16_rn(step);
        const __nv_bfloat16 mb = __float2bfloat16_rn(lo);
        sc[sg] = step;
        mnv[sg] = lo;
        scs[sg] = __bfloat162float(sb);
        mns[sg] = __bfloat162float(mb);
        int64_t at;
        if (is_v) {
          const int t = sg / ngv, j = sg - t * ngv;
          at = (static_cast<int64_t>(bh) * ngv + j) * s.t_len + s.c0 + t;
        } else {
          at = (static_cast<int64_t>(bh) * s.n_blocks + blk) * d + sg;
        }
        side.scale[at] = sb;
        side.mn[at] = mb;
      }
    }
  }
  __syncthreads();

  // 3. codes, a byte each
  for (int i = tid; i < n; i += kThreads) {
    const int t = row_of(i), c = i - t * d;
    cs[t * cstr + c] = static_cast<uint8_t>(code_of(xs[i], seg_of(t, c)));
  }
  __syncthreads();

  // 4. the packed words: word w of token t gathers bytes 4w..4w+3 of the
  // byte-strided row, byte b holding the codes of channels b + m * D / VPB
  {
    const int wd = d * BITS / 32, nb = d / VPB;
    int32_t* out = side.codes + static_cast<int64_t>(bh) * wd * s.t_len +
                   s.c0;
    for (int j = tid; j < g * wd; j += kThreads) {
      const int t = j % g, w = j / g;
      const uint8_t* row = cs + t * cstr + 4 * w;
      uint32_t word = 0;
#pragma unroll
      for (int m = 0; m < VPB; ++m)
        word |= *reinterpret_cast<const uint32_t*>(row + m * nb)
                << field_bit<BITS>(m);
      out[static_cast<int64_t>(w) * s.t_len + t] = static_cast<int32_t>(word);
    }
  }

  // 5. the outliers' deltas, sorted by token (K) or channel (V), and the
  // boundary table
  if constexpr (OUTLIERS) {
    int* ent_idx = reinterpret_cast<int*>(smem + L.ent_idx);
    float* ent_exact = reinterpret_cast<float*>(smem + L.ent_exact);
    int* ent_dup = reinterpret_cast<int*>(smem + L.ent_dup);
    float* ent_val = reinterpret_cast<float*>(smem + L.ent_val);
    int* ent_key = reinterpret_cast<int*>(smem + L.ent_key);
    int* sidx = reinterpret_cast<int*>(smem + L.sidx);
    int* khist = reinterpret_cast<int*>(smem + L.khist);
    for (int t = tid; t < kBndLanes; t += kThreads) khist[t] = 0;
    __syncthreads();
    for (int p = tid; p < s.ks; p += kThreads) {
      const int i = ent_idx[p], t = row_of(i), c = i - t * d;
      const int key = is_v ? c : t;
      ent_key[p] = key;
      atomicAdd(khist + key, 1);
      float delta = 0.0f;
      if (!ent_dup[p]) {
        const int sg = seg_of(t, c);
        delta = __bfloat162float(__float2bfloat16_rn(
            __fsub_rn(ent_exact[p], deq(cs[t * cstr + c], sg))));
      }
      ent_val[p] = delta;
    }
    __syncthreads();
    const int64_t row = static_cast<int64_t>(bh) * s.n_blocks + blk;
    if (warp == 0) {
      // the boundary table, bnd[t] = (entries with key <= t) - 1, and each
      // key's first slot (khist becomes the running slot)
      int c[kBndLanes / 32], sum = 0;
#pragma unroll
      for (int k = 0; k < kBndLanes / 32; ++k) {
        c[k] = khist[lane * (kBndLanes / 32) + k];
        sum += c[k];
      }
      int incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      int run = incl - sum;
#pragma unroll
      for (int k = 0; k < kBndLanes / 32; ++k) {
        const int t = lane * (kBndLanes / 32) + k;
        khist[t] = run;
        run += c[k];
        side.out_bnd[row * kBndLanes + t] = run - 1;
      }
      __syncwarp();
      // a stable counting sort by key, 32 entries at a time in their order
      for (int base = 0; base < s.ks; base += 32) {
        const int p = base + lane;
        const bool in = p < s.ks;
        const int key = in ? ent_key[p] : kBndLanes;
        const unsigned peers = __match_any_sync(kFull, key);
        const int first = in ? khist[key] : 0;
        const int at = first + __popc(peers & ((1u << lane) - 1));
        __syncwarp();
        if (in && lane == __ffs(peers) - 1) khist[key] = first + __popc(peers);
        if (in) {
          sidx[at] = ent_idx[p];
          side.out_val[row * s.ks + at] = __float2bfloat16_rn(ent_val[p]);
        }
        __syncwarp();
      }
    }
    __syncthreads();
    const int hk = s.ks / 2;
    for (int j = tid; j < hk; j += kThreads)
      side.out_idx[row * hk + j] = static_cast<int32_t>(
          static_cast<uint32_t>(sidx[j]) |
          (static_cast<uint32_t>(sidx[j + hk]) << 16));
  }

  if (!s.lowrank) return;
  const int rank = side.rank;

  // 6. the error x - x_hat, in place: codes dequantized from the stored
  // sidebands, the outliers' deltas added back
  if (rank > 0) {
    for (int i = tid; i < n; i += kThreads) {
      const int t = row_of(i), c = i - t * d;
      xs[i] = __fsub_rn(xs[i], deq(cs[t * cstr + c], seg_of(t, c)));
    }
    if constexpr (OUTLIERS) {
      __syncthreads();
      const int* ent_idx = reinterpret_cast<const int*>(smem + L.ent_idx);
      const float* ent_exact =
          reinterpret_cast<const float*>(smem + L.ent_exact);
      const int* ent_dup = reinterpret_cast<const int*>(smem + L.ent_dup);
      const float* ent_val = reinterpret_cast<const float*>(smem + L.ent_val);
      for (int p = tid; p < s.ko; p += kThreads) {
        if (ent_dup[p]) continue;
        const int i = ent_idx[p], t = row_of(i), c = i - t * d;
        const float hat = __fadd_rn(deq(cs[t * cstr + c], seg_of(t, c)),
                                    ent_val[p]);
        xs[i] = __fsub_rn(ent_exact[p], hat);
      }
    }
    // the start
    for (int e = tid; e < d * rank; e += kThreads) {
      const int dd = e / rank, j = e - dd * rank;
      ps[j * d + dd] =
          side.p0[(static_cast<int64_t>(bh) * d + dd) * rank + j];
    }
    __syncthreads();

    // 7. the power iteration: q = E p, p = E^T q; Gram-Schmidt on p and q
    // in the last iteration only
    int parts = 1, qparts = 1;  // threads an entry of p, of q: powers of 2
    while (parts < 32 && 2 * parts * d * rank <= kThreads && 2 * parts <= g)
      parts *= 2;
    while (qparts < 32 && 2 * qparts * g * rank <= kThreads &&
           d % (2 * qparts) == 0)
      qparts *= 2;
    for (int it = 0; it < s.loop; ++it) {
      const bool last = it == s.loop - 1;
      if (last) {
        if (warp == 0) gram_schmidt(ps, d, rank);
        __syncthreads();
      }
      // q = E p: `qparts` consecutive threads an entry (t, j), each over
      // every qparts-th channel from a start turned by the token, so that
      // a warp's reads fall in distinct banks; summed by shuffles
      for (int base = 0; base < g * rank; base += kThreads / qparts) {
        const int o = base + tid / qparts, sub = tid % qparts;
        const int j = o / g, t = o - j * g;
        float acc = 0.0f;
        if (o < g * rank) {
          int dd = (sub + qparts * t) % d;
#pragma unroll 4
          for (int k = 0; k < d / qparts; ++k) {
            acc = fmaf(xs[t * d + dd], ps[j * d + dd], acc);
            dd += qparts;
            if (dd >= d) dd -= d;
          }
        }
        for (int w = 1; w < qparts; w <<= 1)
          acc += __shfl_xor_sync(kFull, acc, w);
        if (o < g * rank && sub == 0) qs[j * g + t] = acc;
      }
      __syncthreads();
      if (last) {
        if (warp == 0) gram_schmidt(qs, g, rank);
        __syncthreads();
      }
      // p = E^T q: `parts` consecutive threads an entry, each over every
      // parts-th token, summed by shuffles
      for (int base = 0; base < d * rank; base += kThreads / parts) {
        const int e = base + tid / parts, sub = tid % parts;
        const int j = e / d, dd = e - j * d;
        float acc = 0.0f;
        if (e < d * rank) {
#pragma unroll 4
          for (int t = sub; t < g; t += parts)
            acc = fmaf(xs[t * d + dd], qs[j * g + t], acc);
        }
        for (int o = 1; o < parts; o <<= 1)
          acc += __shfl_xor_sync(kFull, acc, o);
        if (e < d * rank && sub == 0) ps[j * d + dd] = acc;
      }
      __syncthreads();
    }
  }

  // 8. the bases, zero past `rank`: P^T [R, D] at the block, Q^T [R, G] at
  // the block's tokens; in bf16 with scales of one, or int8 codes with
  // absmax / 127 scales (core: cache._quantize_bases)
  for (int col = warp; col < 2 * s.r_store; col += kWarps) {
    const bool is_p = col < s.r_store;
    const int j = is_p ? col : col - s.r_store;
    const int len = is_p ? d : g;
    const float* from = is_p ? ps : qs;
    float v[4];
    float amax = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = lane + 32 * k;
      v[k] = (e < len && j < rank) ? from[j * len + e] : 0.0f;
      amax = fmaxf(amax, fabsf(v[k]));
    }
    const int64_t p_row =
        ((static_cast<int64_t>(bh) * s.n_blocks + blk) * s.r_store + j) * d;
    const int64_t q_row =
        (static_cast<int64_t>(bh) * s.r_store + j) * s.t_len + s.c0;
    const int64_t at0 = is_p ? p_row : q_row;
    float scale = 1.0f;
    if constexpr (BASE8) {
      scale = __fmul_rn(fmaxf(warp_max(amax), 1e-12f), 1.0f / 127.0f);
      int8_t* to = static_cast<int8_t*>(is_p ? side.pt : side.qt);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int e = lane + 32 * k;
        if (e < len) {
          const float q = fminf(fmaxf(rintf(__fdiv_rn(v[k], scale)), -127.0f),
                                127.0f);
          to[at0 + e] = static_cast<int8_t>(q);
        }
      }
    } else {
      __nv_bfloat16* to = static_cast<__nv_bfloat16*>(is_p ? side.pt
                                                           : side.qt);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int e = lane + 32 * k;
        if (e < len) to[at0 + e] = __float2bfloat16_rn(v[k]);
      }
    }
    if (lane == 0) {
      if (is_p)
        side.pt_scale[(static_cast<int64_t>(bh) * s.n_blocks + blk) *
                          s.r_store + j] = scale;
      else
        side.qt_scale[(static_cast<int64_t>(bh) * s.r_store + j) *
                          s.n_blocks + blk] = scale;
    }
  }
}

template <int BITS, bool OUTLIERS, bool BASE8>
cudaError_t launch(const Side& k, const Side& v, const Dims& s, int batch,
                   cudaStream_t stream) {
  const size_t smem = 4 * static_cast<size_t>(layout(s, OUTLIERS).total);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flush_kernel<BITS, OUTLIERS, BASE8>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  flush_kernel<BITS, OUTLIERS, BASE8>
      <<<dim3(batch, s.heads, 2), kThreads, smem, stream>>>(k, v, s);
  return cudaGetLastError();
}

template <int BITS>
cudaError_t launch(const Side& k, const Side& v, const Dims& s, int batch,
                   bool base8, cudaStream_t stream) {
  if (s.ko) {
    return base8 ? launch<BITS, true, true>(k, v, s, batch, stream)
                 : launch<BITS, true, false>(k, v, s, batch, stream);
  }
  return base8 ? launch<BITS, false, true>(k, v, s, batch, stream)
               : launch<BITS, false, false>(k, v, s, batch, stream);
}

}  // namespace

// Shared memory a block of gear_flush takes for these shapes, in bytes.
extern "C" int64_t gear_flush_smem_bytes(int d, int group, int v_group,
                                         int ko, int ko_store) {
  Dims s = {};
  s.d = d;
  s.g = group;
  s.vg = v_group;
  s.ko = ko;
  s.ks = ko_store;
  return 4 * static_cast<int64_t>(layout(s, ko > 0).total);
}

// One layer's flush, K and V, in place. Each tensor's leaves as the cache
// holds them, contiguous: residual tier, codes, sidebands (bf16), outlier
// index / delta / boundary table, P^T, Q^T (bf16, or int8 with base8),
// their f32 scales, and the power iteration's f32 start [B, H, D, rank]
// (null where the rank is 0 or lowrank is 0). c0 is the compressed length
// before the flush.
extern "C" int gear_flush(
    const void* k_resid, void* k_codes, void* k_scale, void* k_mn,
    void* k_out_idx, void* k_out_val, void* k_out_bnd, void* kpt, void* kqt,
    void* kpt_scale, void* kqt_scale, const void* k_p0,
    const void* v_resid, void* v_codes, void* v_scale, void* v_mn,
    void* v_out_idx, void* v_out_val, void* v_out_bnd, void* vpt, void* vqt,
    void* vpt_scale, void* vqt_scale, const void* v_p0,
    int batch, int heads, int d, int group, int t_len, int c0, int bits,
    int ko, int ko_store, int r_store, int rank_k, int rank_v, int loop,
    int v_group, int lowrank, int base8, cudaStream_t stream) {
  if (batch <= 0 || heads <= 0 || d <= 0 || d > 128 || d % 4 ||
      group <= 0 || group > 128 || (group * d) % 8 ||
      (reinterpret_cast<uintptr_t>(k_resid) & 15) ||
      (reinterpret_cast<uintptr_t>(v_resid) & 15) || (bits != 2 && bits != 4 && bits != 8) ||
      d % (32 / bits) || t_len % group || c0 % group || c0 < 0 ||
      c0 + group > t_len || v_group <= 0 || d % v_group || ko < 0 || ko % 2 ||
      ko_store < ko || ko_store % 2 || (ko && group * d > 65536) ||
      r_store < 1 || r_store > kMaxRank || rank_k < 0 || rank_v < 0 ||
      rank_k > r_store || rank_v > r_store ||
      (lowrank && ((rank_k && !k_p0) || (rank_v && !v_p0) ||
                   ((rank_k || rank_v) && loop < 1))))
    return cudaErrorInvalidValue;
  if (gear_flush_smem_bytes(d, group, v_group, ko, ko_store) > 232448)
    return cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  const Side k = {static_cast<const bf16*>(k_resid),
                  static_cast<int32_t*>(k_codes), static_cast<bf16*>(k_scale),
                  static_cast<bf16*>(k_mn), static_cast<int32_t*>(k_out_idx),
                  static_cast<bf16*>(k_out_val),
                  static_cast<int32_t*>(k_out_bnd), kpt, kqt,
                  static_cast<float*>(kpt_scale),
                  static_cast<float*>(kqt_scale),
                  static_cast<const float*>(k_p0), lowrank ? rank_k : 0};
  const Side v = {static_cast<const bf16*>(v_resid),
                  static_cast<int32_t*>(v_codes), static_cast<bf16*>(v_scale),
                  static_cast<bf16*>(v_mn), static_cast<int32_t*>(v_out_idx),
                  static_cast<bf16*>(v_out_val),
                  static_cast<int32_t*>(v_out_bnd), vpt, vqt,
                  static_cast<float*>(vpt_scale),
                  static_cast<float*>(vqt_scale),
                  static_cast<const float*>(v_p0), lowrank ? rank_v : 0};
  const Dims s = {heads, d, group, t_len, t_len / group, c0, ko, ko_store,
                  r_store, loop, v_group, lowrank ? 1 : 0};
  switch (bits) {
    case 2: return static_cast<int>(launch<2>(k, v, s, batch, base8, stream));
    case 4: return static_cast<int>(launch<4>(k, v, s, batch, base8, stream));
    case 8: return static_cast<int>(launch<8>(k, v, s, batch, base8, stream));
    default: return cudaErrorInvalidValue;
  }
}
