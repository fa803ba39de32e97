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
// Design (a simple kernel that is right first), the split-and-merge shape of
// decode.cu:
//  * grid (BH rows, token splits); each block walks its split's tiles of 128
//    tokens, and a second tiny kernel merges the splits' (max, sum, acc)
//    states. Tiles wholly left of pad_start are skipped.
//  * Tokens are rows here ([T, D]), so the coalesced direction is along D,
//    the opposite of the compressed layout. A tile's K rows are copied to
//    shared memory with 16-byte loads (all in flight at once), rows padded
//    by 16 bytes so that one thread per token can read its row in 16-byte
//    pieces without bank conflicts; the same buffer then takes the V rows,
//    which one thread per channel reads column-wise.
//  * float32 arithmetic on the bf16 loads; q stays float32 (the TPU kernel
//    rounds q and p to bf16 for its matrix unit; that is not part of the
//    contract).
// Faster forms (wgmma products, TMA staging with the V copy overlapping the
// scores) are later work.
#include "attn_common.cuh"

namespace {

constexpr int kRowPad = 8;  // bf16 of padding per staged row (16 bytes)

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
  size_t bytes = static_cast<size_t>(kTile) * (d + kRowPad) * sizeof(bf16);
  bytes += static_cast<size_t>(gq) * d * sizeof(float);       // q_s
  bytes += static_cast<size_t>(gq) * kTile * sizeof(float);   // p_s
  bytes += 2 * static_cast<size_t>(gq) * kWarps * sizeof(float);
  return bytes;
}

// Copy rows [t0, t0 + n_valid) of a [T, D] bf16 matrix into the padded tile,
// 16 bytes a thread and step; rows past n_valid are zeroed.
__device__ __forceinline__ void stage_rows(const bf16* src_row0, uint4* tile,
                                           int d, int n_valid) {
  const int vec_per_row = d / 8;
  const int stride_v = (d + kRowPad) / 8;
  const uint4* src = reinterpret_cast<const uint4*>(src_row0);
#pragma unroll 4
  for (int i = threadIdx.x; i < kTile * vec_per_row; i += kTile) {
    const int row = i / vec_per_row, c = i % vec_per_row;
    tile[row * stride_v + c] =
        row < n_valid ? src[static_cast<size_t>(row) * vec_per_row + c]
                      : make_uint4(0u, 0u, 0u, 0u);
  }
}

template <int GQ>
__global__ void __launch_bounds__(kTile) flash_split_kernel(FlashParams p) {
  extern __shared__ uint4 smem_v[];
  const int bh = blockIdx.x, split = blockIdx.y, tid = threadIdx.x;
  const int D = p.d, T = p.t;
  const int stride_v = (D + kRowPad) / 8;  // uint4 per staged row
  const int stride_e = D + kRowPad;        // bf16 per staged row

  uint4* tile = smem_v;
  float* q_s = reinterpret_cast<float*>(tile + kTile * stride_v);
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
  const int tile_lo = split * p.tiles_per_split;
  const int tile_hi = min(ntiles, tile_lo + p.tiles_per_split);

  for (int ti = tile_lo; ti < tile_hi; ++ti) {
    const int t0 = ti * kTile;
    const int n_valid = min(kTile, p.length - t0);
    if (t0 + n_valid <= pad) continue;  // wholly left of the padding
    __syncthreads();  // q_s ready; the previous tile's V reads done
    stage_rows(k_row + static_cast<size_t>(t0) * D, tile, D, n_valid);
    __syncthreads();

    // Scores: one thread per token, its K row in 16-byte pieces.
    const bool valid = tid < n_valid && t0 + tid >= pad;
#pragma unroll
    for (int g = 0; g < GQ; ++g) s[g] = 0.0f;
    if (valid) {
      const uint4* row = tile + tid * stride_v;
      for (int c = 0; c < D / 8; ++c) {
        const uint4 pk = row[c];
        const uint32_t w[4] = {pk.x, pk.y, pk.z, pk.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // a bf16 is the high half of the float32 with the same value
          const float lo = __uint_as_float(w[i] << 16);
          const float hi = __uint_as_float(w[i] & 0xFFFF0000u);
#pragma unroll
          for (int g = 0; g < GQ; ++g)
            s[g] += q_s[g * D + c * 8 + 2 * i] * lo +
                    q_s[g * D + c * 8 + 2 * i + 1] * hi;
        }
      }
    }
    // softmax_tile's barriers come after every thread's K reads, so the
    // tile can take the V rows right after it
    softmax_tile<GQ>(s, valid, p_s, red_max, red_sum, m_run, l_run, alpha);
    stage_rows(v_row + static_cast<size_t>(t0) * D, tile, D, n_valid);
    __syncthreads();

    // PV: one thread per channel, down the tile's V column.
    if (has_d) {
      const bf16* col = reinterpret_cast<const bf16*>(tile) + tid;
#pragma unroll
      for (int g = 0; g < GQ; ++g) acc[g] *= alpha[g];
#pragma unroll 4
      for (int tt = 0; tt < n_valid; ++tt) {
        const float vv = ld(col + tt * stride_e);
#pragma unroll
        for (int g = 0; g < GQ; ++g) acc[g] += p_s[g * kTile + tt] * vv;
      }
    }
  }

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

extern "C" int gear_flash_decode(const float* q, const void* k, const void* v,
                                 const int32_t* pad_start, float* part_acc,
                                 float* part_ml, float* out, int bh, int gq,
                                 int d, int t, int length, int n_split,
                                 int tiles_per_split, cudaStream_t stream) {
  if (d > kTile || d % 8 != 0 || n_split < 1 || length < 0 || length > t)
    return cudaErrorInvalidValue;
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
  const size_t smem = flash_smem_bytes(gq, d);
  cudaError_t e;
  switch (gq) {
    case 1: e = launch_flash<1>(p, bh, smem, stream); break;
    case 2: e = launch_flash<2>(p, bh, smem, stream); break;
    case 4: e = launch_flash<4>(p, bh, smem, stream); break;
    case 8: e = launch_flash<8>(p, bh, smem, stream); break;
    default: e = cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(bh, gq);
  attn_merge_kernel<<<grid, d, 0, stream>>>(part_acc, part_ml, out, n_split,
                                            gq, d);
  return static_cast<int>(cudaGetLastError());
}
