// KA, split form: scaled dot-product attention with an f32 softmax at head
// dims past 256 (any hd), any sequence length. Heads are split by column of
// [N, T, heads * hd] rows.
//
// Replaces sitewhere_tpu/models/common.py:61 attn_core where the tiled form
// (attention_tiled.cu, hd 1..256) does not take the head dim: a
// transformer at dim 512 with one head (hd 512), or hd 288 / 300. The
// rounding points are attention_tiled.cu's: QK^T accumulated in f32 and
// rounded to the compute dtype, then scaled by 1/sqrt(hd) in f32; under
// the causal mask keys past i give exp() = 0; the softmax is f32, each p
// rounded to the compute dtype after the division by the row's sum; p.v
// accumulated in f32 and rounded once into the output.
//
// Design (attention_split.cuh): one block per (sequence, head, column
// chunk of 256, query tile of 8 rows), four warps of two rows, a lane 8 of
// the chunk's columns. Pass 1, a lane per key of a 32-key tile: the logits
// over the full head dim (q and k streamed 256 columns at a time, one f32
// sum continued), each row's max and sum of exp by an online rescale over
// the key tiles. Pass 2 recomputes the logits, forms p = rc(exp(l - max) /
// sum) for the tile, stages the tile's values of the block's own columns
// and accumulates p.v. Every chunk's block computes the same p. A causal
// block stops at the key tile of its last query. Grid (N, heads x chunks,
// query tiles; the last dim a grid-stride loop past 65,535 tiles).
//
// Bound on the H100: at the transformer's dim 512, one head (65,536 x 31
// x 512, bf16, causal) the function reads q, k, v and writes the output,
// 8.3 GB (2.5 ms at 3.35 TB/s), and does 4 hd FLOP a (query, key) pair of
// the causal triangle, 67 GFLOP (0.07 ms at the bf16 tensor rate): bytes.
// This form runs on CUDA cores and computes the
// logits twice in every chunk's block: a tensor-core form is the open
// speed work (PERF.md section 7).
#include <cmath>

#include "attention_split.cuh"

namespace {

using namespace ka_split;

size_t fwd_smem_bytes() {
  return (2 * static_cast<size_t>(kTile) * kRS + static_cast<size_t>(kBR) * kChunk +
          static_cast<size_t>(kWarps) * kRW * kTile) *
         sizeof(float);
}

struct FwdArgs {
  const void* q; const void* k; const void* v; void* out;
  int Tn; int D; int hd; int heads; int chunks; int causal; float scale; int qtiles;
};

template <typename T>
__global__ void __launch_bounds__(kWarps * 32) attention_split_kernel(const FwdArgs a) {
  extern __shared__ __align__(16) float sm[];
  float* ks = sm;                   // [kTile][kRS] a key chunk
  float* vs = ks + kTile * kRS;     // [kTile][kRS] the tile's values, own columns
  float* qs = vs + kTile * kRS;     // [kBR][kChunk] a query chunk
  float* ps = qs + kBR * kChunk;    // [kWarps][kRW][kTile]
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const int Tn = a.Tn, D = a.D, hd = a.hd, causal = a.causal;
  const int head = blockIdx.y / a.chunks;
  const int own = (blockIdx.y - head * a.chunks) * kChunk;  // the block's first column
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long base = static_cast<long long>(blockIdx.x) * Tn * D +
                         static_cast<long long>(head) * hd;
  float* pw = ps + warp * kRW * kTile;
  const float* qw = qs + warp * kRW * kChunk;
  const float ninf = -__int_as_float(0x7f800000);

  for (int qt = blockIdx.z; qt < a.qtiles; qt += gridDim.z) {
    const int q0 = qt * kBR;
    const int i0 = q0 + warp * kRW;
    const int nk = causal ? min(q0 + kBR, Tn) : Tn;
    // the raw logits of the warp's rows with key j0 + lane, over the full
    // head dim (rows past T repeat the last query; never stored)
    auto logits = [&](int j0, float (&l)[kRW]) {
#pragma unroll
      for (int r = 0; r < kRW; ++r) l[r] = 0.0f;
      for (int c0 = 0; c0 < hd; c0 += kChunk) {
        __syncthreads();
        stage_cols(qs, q, base, q0, kBR, Tn, true, c0, hd, kChunk, D);
        stage_cols(ks, k, base, j0, kTile, nk, false, c0, hd, kRS, D);
        __syncthreads();
        dots_acc(qw, kChunk, ks + lane * kRS, chunk_w4(c0, hd), l);
      }
    };
    float mx[kRW], sum[kRW];
#pragma unroll
    for (int r = 0; r < kRW; ++r) {
      mx[r] = ninf;
      sum[r] = 0.0f;
    }
    // pass 1: each row's max and sum of exp, rescaled online
    for (int j0 = 0; j0 < nk; j0 += kTile) {
      float l[kRW];
      logits(j0, l);
      const int j = j0 + lane;
#pragma unroll
      for (int r = 0; r < kRW; ++r) {
        const int i = min(i0 + r, Tn - 1);
        const bool ok = j < nk && (!causal || j <= i);
        const float lr = ok ? __fmul_rn(rc<T>(l[r]), a.scale) : ninf;
        const float nm = fmaxf(mx[r], warp_max(lr));
        const float e = ok ? expf(__fsub_rn(lr, nm)) : 0.0f;
        sum[r] = __fadd_rn(__fmul_rn(sum[r], expf(__fsub_rn(mx[r], nm))), warp_sum(e));
        mx[r] = nm;
      }
    }
    // pass 2: p a tile at a time, p.v over the block's own columns
    float acc[kRW][kHQ];
#pragma unroll
    for (int r = 0; r < kRW; ++r)
#pragma unroll
      for (int c = 0; c < kHQ; ++c) acc[r][c] = 0.0f;
    for (int j0 = 0; j0 < nk; j0 += kTile) {
      float l[kRW];
      logits(j0, l);
      const int j = j0 + lane;
#pragma unroll
      for (int r = 0; r < kRW; ++r) {
        const int i = min(i0 + r, Tn - 1);
        const bool ok = j < nk && (!causal || j <= i);
        const float lr = __fmul_rn(rc<T>(l[r]), a.scale);
        pw[r * kTile + lane] =
            ok ? rc<T>(__fdiv_rn(expf(__fsub_rn(lr, mx[r])), sum[r])) : 0.0f;
      }
      // every warp is past this tile's last read of vs (the logits' syncs)
      stage_cols(vs, v, base, j0, kTile, nk, false, own, hd, kRS, D);
      __syncthreads();
      const int kn = min(kTile, nk - j0);
      for (int jj = 0; jj < kn; ++jj) {
        float vv[kHQ];
#pragma unroll
        for (int c = 0; c < kHQ; ++c) vv[c] = vs[jj * kRS + lane + 32 * c];
#pragma unroll
        for (int r = 0; r < kRW; ++r) {
          const float p = pw[r * kTile + jj];
#pragma unroll
          for (int c = 0; c < kHQ; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRW; ++r) {
      const int i = i0 + r;
      if (i >= Tn) continue;
      const long long row = base + static_cast<long long>(i) * D;
#pragma unroll
      for (int c = 0; c < kHQ; ++c) {
        const int d = own + lane + 32 * c;
        if (d < hd) put(static_cast<T*>(a.out) + row + d, acc[r][c]);
      }
    }
  }
}

template <typename T>
int launch_split(FwdArgs a, int N, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(attention_split_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  a.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(a.hd)));
  a.chunks = (a.hd + kChunk - 1) / kChunk;
  a.qtiles = (a.Tn + kBR - 1) / kBR;
  const dim3 grid(N, a.heads * a.chunks, a.qtiles < 65535 ? a.qtiles : 65535);
  attention_split_kernel<T><<<grid, kWarps * 32, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, out: [N, T, heads * hd] in the compute dtype (kind KIND_F32 or
// KIND_BF16); any hd >= 1 (the route sends hd > 256 here); any T >= 1.
extern "C" int sw_attention_split(const void* q, const void* k, const void* v, void* out, int N,
                                  int T, int heads, int hd, int causal, int kind, void* stream) {
  if (N == 0) return static_cast<int>(cudaGetLastError());
  if (N < 0 || T < 1 || heads < 1 || hd < 1 ||
      static_cast<long long>(heads) * ((hd + kChunk - 1) / kChunk) > 65535 ||
      (kind != KIND_F32 && kind != KIND_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  FwdArgs a{q, k, v, out, T, heads * hd, hd, heads, 0, causal, 0.0f, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return kind == KIND_BF16 ? launch_split<__nv_bfloat16>(a, N, st)
                           : launch_split<float>(a, N, st);
}
