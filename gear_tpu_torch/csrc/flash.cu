// bf16 flash decode over the raw (uncompressed) KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel gear_tpu/kernels/flash.py::_flash_kernel
// (reached through flash_decode / raw_attend_flash): q.K^T over bf16
// K [BH, T, D], the mask pad_start <= t < length, an online softmax with
// float32 accumulators, p.V, normalised output [BH, GQ, D] f32. It computes
// what gear_tpu_torch/models/llama.py::raw_attend computes.
//
// Bound on the card: bytes. K and V rows between pad_start and length are
// read once, 2 x 2 x D bytes per token and kv head; the arithmetic is
// 4 x GQ x D operations per token, some 2 x GQ per byte, far below the
// H100's float32 rate per byte of memory traffic.
//
// Design: keep a block's next copies in flight while it computes.
//  * grid (BH rows, token splits); each block walks its split's tiles of 128
//    tokens (tiles wholly left of pad_start skipped), and a second tiny
//    kernel merges the splits' (max, sum, acc) states.
//  * A tile is two half-tiles, its K rows then its V rows (32 KB each at
//    D = 128), and the block walks the sequence K0 V0 K1 V1 ... through a
//    ring of kSlots = 2 half-tile slots in shared memory, filled by 16-byte
//    cp.async copies, one commit group per half-tile. While the block scores
//    K_i and runs the softmax, the copy of V_i is in flight; while it runs
//    PV on V_i, the copy of K_{i+1}. Each step waits for its own half-tile
//    only, so V is waited on just before PV and the next tile lands while
//    this one computes.
//  * Two slots, not three: a third would keep one more half-tile in flight
//    but cost the SM its third block (108 KB a block against 74 KB). One
//    half-tile in flight per block is 32 KB, three blocks 96 KB an SM, far
//    above the ~25 KB that 3.35 TB/s times a microsecond of latency asks of
//    each of 132 SMs; the third block's warps instead hide the latency of
//    the math (the three-slot form was the slower of the two on the H100).
//  * cp.async, not TMA bulk copies: cp.async writes each 16-byte piece where
//    the thread says, so rows keep the 16 bytes of padding that let one
//    thread per token read its K row in 16-byte pieces without bank
//    conflicts (a bulk copy would land the rows unpadded, and the score loop
//    would need a rotation of the pieces instead). The copies cost the
//    issuing threads a few instructions, no registers in flight.
//  * Shared memory at D = 128: 2 x 128 x 136 x 2 = 69,632 bytes of slots
//    plus q (GQ x 512 B), p (GQ x 512 B) and the softmax scratch: 73,856
//    bytes at GQ = 4, so three blocks fit on an SM (228 KB with 1 KB
//    reserved per block; two at GQ = 8); __launch_bounds__(128, 3) holds a
//    thread to 168 registers (ptxas: 80-124, no spill). kernels/flash.py
//    plans the splits for three blocks per SM: the Mistral-7B path (16 rows,
//    35 tiles) takes 18 splits of 2 tiles, 288 blocks; B = 4 x 32 heads at
//    1,930 tokens 3 splits of 6, 6 and 4 tiles.
//  * Scores add their eight products as a tree (short dependency chains at
//    GQ = 1); q is read as float4, p in PV as float4 over four tokens.
//  * float32 arithmetic on the bf16 loads; q stays float32 (the TPU kernel
//    rounds q and p to bf16 for its matrix unit; that is not part of the
//    contract).
#include "attn_common.cuh"

namespace {

constexpr int kRowPad = 8;  // bf16 of padding per staged row (16 bytes)
constexpr int kSlots = 2;   // half-tile slots of the ring (K or V rows)

struct FlashParams {
  const float* q;            // [BH, GQ, D], sm_scale folded in
  const bf16* k;             // [BH, T, D]
  const bf16* v;             // [BH, T, D]
  const int32_t* pad_start;  // [BH]
  float* part_acc;           // [BH, NS, GQ, D]
  float* part_ml;            // [BH, NS, GQ, 2]
  int d, t, length, n_split, tiles_per_split;
};

size_t flash_smem_bytes(int gq, int d) {
  size_t bytes =
      static_cast<size_t>(kSlots) * kTile * (d + kRowPad) * sizeof(bf16);
  bytes += static_cast<size_t>(gq) * d * sizeof(float);       // q_s
  bytes += static_cast<size_t>(gq) * kTile * sizeof(float);   // p_s
  bytes += 2 * static_cast<size_t>(gq) * kWarps * sizeof(float);
  return bytes;
}

template <int GQ>
__global__ void __launch_bounds__(kTile, 3) flash_split_kernel(FlashParams p) {
  extern __shared__ uint4 smem_v[];
  const int bh = blockIdx.x, split = blockIdx.y, tid = threadIdx.x;
  const int D = p.d, T = p.t;
  const int vec_per_row = D / 8;
  const int stride_v = (D + kRowPad) / 8;  // uint4 per staged row
  const int stride_e = D + kRowPad;        // bf16 per staged row
  const int slot_v = kTile * stride_v;     // uint4 per slot

  uint4* ring = smem_v;
  float* q_s = reinterpret_cast<float*>(ring + kSlots * slot_v);
  float* p_s = q_s + GQ * D;
  float* red_max = p_s + GQ * kTile;
  float* red_sum = red_max + GQ * kWarps;

  for (int i = tid; i < GQ * D; i += kTile)
    q_s[i] = p.q[static_cast<size_t>(bh) * GQ * D + i];

  float m_run[GQ], l_run[GQ], acc[GQ], alpha[GQ], s[GQ];
#pragma unroll
  for (int g = 0; g < GQ; ++g) {
    m_run[g] = -INFINITY;
    l_run[g] = 0.0f;
    acc[g] = 0.0f;
  }
  const bool has_d = tid < D;
  const bf16* k_row = p.k + static_cast<size_t>(bh) * T * D;
  const bf16* v_row = p.v + static_cast<size_t>(bh) * T * D;
  const int pad = p.pad_start[bh];
  const int ntiles = (p.length + kTile - 1) / kTile;
  const int tile_lo = max(split * p.tiles_per_split, pad / kTile);
  const int tile_hi = min(ntiles, split * p.tiles_per_split + p.tiles_per_split);
  const int n_half = 2 * max(0, tile_hi - tile_lo);

  // Issue half-tile h (K rows of tile lo + h/2 if h is even, else its V
  // rows) into slot h % kSlots; past the end an empty group keeps the
  // count of groups uniform.
  auto issue = [&](int h) {
    if (h < n_half) {
      const int t0 = (tile_lo + h / 2) * kTile;
      const int n_valid = min(kTile, p.length - t0);
      const uint4* src = reinterpret_cast<const uint4*>(
          ((h & 1) ? v_row : k_row) + static_cast<size_t>(t0) * D);
      uint4* dst = ring + (h % kSlots) * slot_v;
      for (int i = tid; i < n_valid * vec_per_row; i += kTile) {
        const int row = i / vec_per_row, c = i - row * vec_per_row;
        cp_async16(dst + row * stride_v + c, src + i);
      }
    }
    cp_async_commit();
  };

  for (int h = 0; h < kSlots - 1; ++h) issue(h);
  for (int h = 0; h < n_half; ++h) {
    // groups issued: up to h + kSlots - 2; at most kSlots - 2 in flight
    // means half-tile h has landed (this thread's copies)
    cp_async_wait<kSlots - 2>();
    __syncthreads();  // ... everyone's; and slot (h - 1) % kSlots is free
    issue(h + kSlots - 1);
    const int t0 = (tile_lo + h / 2) * kTile;
    const int n_valid = min(kTile, p.length - t0);
    const uint4* tile = ring + (h % kSlots) * slot_v;
    if ((h & 1) == 0) {
      // Scores: one thread per token, its K row in 16-byte pieces, q in
      // float4 (broadcast: every thread reads the same q).
      const bool valid = tid < n_valid && t0 + tid >= pad;
#pragma unroll
      for (int g = 0; g < GQ; ++g) s[g] = 0.0f;
      if (valid) {
        const uint4* row = tile + tid * stride_v;
        const float4* q4 = reinterpret_cast<const float4*>(q_s);
        for (int c = 0; c < vec_per_row; ++c) {
          const uint4 pk = row[c];
          const uint32_t w[4] = {pk.x, pk.y, pk.z, pk.w};
          float k[8];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            // a bf16 is the high half of the float32 with the same value
            k[2 * i] = __uint_as_float(w[i] << 16);
            k[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
          }
#pragma unroll
          for (int g = 0; g < GQ; ++g) {
            const float4 a = q4[g * vec_per_row * 2 + 2 * c];
            const float4 b = q4[g * vec_per_row * 2 + 2 * c + 1];
            // summed as a tree: short dependency chains
            s[g] += ((a.x * k[0] + a.y * k[1]) + (a.z * k[2] + a.w * k[3])) +
                    ((b.x * k[4] + b.y * k[5]) + (b.z * k[6] + b.w * k[7]));
          }
        }
      }
      softmax_tile<GQ>(s, valid, p_s, red_max, red_sum, m_run, l_run, alpha);
    } else if (has_d) {
      // PV: one thread per channel, down the tile's V column; p in float4.
      const bf16* col = reinterpret_cast<const bf16*>(tile) + tid;
#pragma unroll
      for (int g = 0; g < GQ; ++g) acc[g] *= alpha[g];
      const int n4 = n_valid & ~3;
      for (int tt = 0; tt < n4; tt += 4) {
        const float v0 = ld(col + tt * stride_e);
        const float v1 = ld(col + (tt + 1) * stride_e);
        const float v2 = ld(col + (tt + 2) * stride_e);
        const float v3 = ld(col + (tt + 3) * stride_e);
#pragma unroll
        for (int g = 0; g < GQ; ++g) {
          const float4 pp =
              *reinterpret_cast<const float4*>(p_s + g * kTile + tt);
          acc[g] += pp.x * v0 + pp.y * v1 + pp.z * v2 + pp.w * v3;
        }
      }
      for (int tt = n4; tt < n_valid; ++tt) {
        const float vv = ld(col + tt * stride_e);
#pragma unroll
        for (int g = 0; g < GQ; ++g) acc[g] += p_s[g * kTile + tt] * vv;
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block

  store_partial<GQ>(p.part_acc, p.part_ml,
                    static_cast<size_t>(bh) * p.n_split + split, D, has_d,
                    m_run, l_run, acc);
}

template <int GQ>
cudaError_t launch_flash(const FlashParams& p, int bh, size_t smem,
                         cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_split_kernel<GQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  dim3 grid(bh, p.n_split);
  flash_split_kernel<GQ><<<grid, kTile, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// smem: the shared memory per block that kernels/flash.py planned; it must
// equal this file's own count (a check that the two stay in step).
extern "C" int gear_flash_decode(const float* q, const void* k, const void* v,
                                 const int32_t* pad_start, float* part_acc,
                                 float* part_ml, float* out, int bh, int gq,
                                 int d, int t, int length, int n_split,
                                 int tiles_per_split, int smem,
                                 cudaStream_t stream) {
  if (d > kTile || d % 8 != 0 || n_split < 1 || length < 0 || length > t)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) & 15)
    return cudaErrorMisalignedAddress;
  const size_t want = flash_smem_bytes(gq, d);
  if (static_cast<size_t>(smem) != want) return cudaErrorInvalidValue;
  FlashParams p;
  p.q = q;
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.pad_start = pad_start;
  p.part_acc = part_acc;
  p.part_ml = part_ml;
  p.d = d;
  p.t = t;
  p.length = length;
  p.n_split = n_split;
  p.tiles_per_split = tiles_per_split;
  cudaError_t e;
  switch (gq) {
    case 1: e = launch_flash<1>(p, bh, want, stream); break;
    case 2: e = launch_flash<2>(p, bh, want, stream); break;
    case 4: e = launch_flash<4>(p, bh, want, stream); break;
    case 8: e = launch_flash<8>(p, bh, want, stream); break;
    default: e = cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(bh, gq);
  attn_merge_kernel<<<grid, d, 0, stream>>>(part_acc, part_ml, out, n_split,
                                            gq, d);
  return static_cast<int>(cudaGetLastError());
}
