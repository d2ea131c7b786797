// KA, tiled form: scaled dot-product attention with an f32 softmax at any
// head dim from 1 to 256 and any sequence length, its shared memory
// independent of T. Heads are split by column of [N, T, heads * hd] rows.
//
// Replaces sitewhere_tpu/models/common.py:61 attn_core where the staged
// form (attention.cu: hd 32 and 64, all T rows of K and V in shared memory)
// does not take the shape: other head dims (ViT-H/14's 80, the reference's
// test widths 8 and 16) and longer sequences (ViT-B/16 at 384: T 577). The
// rounding points are attention.cu's: QK^T accumulated in f32 and rounded
// to the compute dtype, then scaled by 1/sqrt(hd) in f32; under the causal
// mask keys past i give exp() = 0; the softmax is f32, each p rounded to
// the compute dtype after the division by the row's sum; p.v accumulated
// in f32 and rounded once into the output.
//
// Design: one block per (sequence, head, query tile), four warps, each warp
// RW query rows of the tile; key and value tiles of 32 rows stream through
// shared memory (f32, rows padded by four words so a lane's 16-byte read of
// its own key row meets no other lane's bank). Pass 1, a lane per key of
// the tile: the logits of the warp's rows, and each row's max and sum of
// exp by an online rescale over the tiles (the statistics only). Pass 2
// recomputes the logits with the same arithmetic, forms p = rc(exp(l - max)
// / sum) for the tile, and each lane accumulates its hd/32 output columns
// of p.v over the tile's keys. Two passes, not one online pass over
// unnormalized p: the reference rounds p after the normalization. A causal
// block stops at the key tile of its last query. Grid (N, heads, query
// tiles, the last dim a grid-stride loop past 65,535 tiles).
//
// Bound on the H100: at ViT-B/16 at 384 (64 x 577 x 12 x 64, bf16) the
// function reads q, k, v and writes the output, 113 MB, and does 4 T^2 hd
// FLOP a (sequence, head), 65 GFLOP: bytes 0.034 ms, operations 0.066 ms
// at the bf16 tensor rate. This form runs on CUDA cores and computes the
// logits twice: a tensor-core form (mma / wgmma tiles, the same rounding
// points) is the open speed work (PERF.md section 7).
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kKeys = 32;  // keys a tile: one a lane

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__device__ __forceinline__ float rc(float x) {
  return rb<sizeof(T) == 2>(x);
}

// HQ output columns a lane (head dims up to HDM = 32 HQ); RW query rows a
// warp, so a lane holds RW x HQ = 16 accumulators.
template <int HQ>
struct Tiles {
  static constexpr int HDM = 32 * HQ;
  static constexpr int RS = HDM + 4;  // padded row stride of a key/value tile
  static constexpr int RW = 16 / HQ;
  static constexpr int BQ = kWarps * RW;
};

template <int HQ>
size_t fwd_smem_bytes() {
  using S = Tiles<HQ>;
  return (2 * static_cast<size_t>(kKeys) * S::RS + static_cast<size_t>(S::BQ) * S::HDM +
          static_cast<size_t>(kWarps) * S::RW * kKeys) *
         sizeof(float);
}

// Rows [j0, j0 + n) of x (columns < hd; the rest, and rows past `valid`,
// 0) into a tile of `n` rows of stride `stride` floats.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* __restrict__ x, long long base,
                                           int j0, int n, int valid, int hd, int hdm, int stride,
                                           int D) {
  for (int e = threadIdx.x; e < n * hdm; e += blockDim.x) {
    const int r = e / hdm, d = e - r * hdm;
    const int j = j0 + r;
    dst[r * stride + d] =
        (j < valid && d < hd) ? to_f(x[base + static_cast<long long>(j) * D + d]) : 0.0f;
  }
}

// The f32 dot products of the warp's RW query rows qw (stride HDM) with
// the lane's key row kr, d ascending, over hd4 = hd rounded up to 4
// (the padding is 0).
template <int HQ>
__device__ __forceinline__ void row_dots(const float* qw, const float* kr, int hd4,
                                         float (&l)[Tiles<HQ>::RW]) {
  using S = Tiles<HQ>;
#pragma unroll
  for (int r = 0; r < S::RW; ++r) l[r] = 0.0f;
  for (int d = 0; d < hd4; d += 4) {
    const float4 kv = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
    for (int r = 0; r < S::RW; ++r) {
      const float4 qv = *reinterpret_cast<const float4*>(qw + r * S::HDM + d);
      l[r] = fmaf(qv.x, kv.x, l[r]);
      l[r] = fmaf(qv.y, kv.y, l[r]);
      l[r] = fmaf(qv.z, kv.z, l[r]);
      l[r] = fmaf(qv.w, kv.w, l[r]);
    }
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T, int HQ>
__global__ void __launch_bounds__(kWarps * 32)
attention_tiled_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       T* __restrict__ out, int Tn, int D, int hd, int causal, float scale,
                       int qtiles) {
  using S = Tiles<HQ>;
  constexpr int HDM = S::HDM, RS = S::RS, RW = S::RW, BQ = S::BQ;
  extern __shared__ __align__(16) float sm[];
  float* ks = sm;                  // [kKeys][RS]
  float* vs = ks + kKeys * RS;     // [kKeys][RS]
  float* qs = vs + kKeys * RS;     // [BQ][HDM]
  float* ps = qs + BQ * HDM;       // [kWarps][RW][kKeys]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hd4 = (hd + 3) & ~3;
  const long long base = static_cast<long long>(blockIdx.x) * Tn * D +
                         static_cast<long long>(blockIdx.y) * hd;
  float* pw = ps + warp * RW * kKeys;
  const float* qw = qs + warp * RW * HDM;
  const float ninf = -__int_as_float(0x7f800000);

  for (int qt = blockIdx.z; qt < qtiles; qt += gridDim.z) {
    const int q0 = qt * BQ;
    const int i0 = q0 + warp * RW;  // the warp's first query
    __syncthreads();
    // the tile's queries (rows past T repeat the last one; never stored)
    for (int e = threadIdx.x; e < BQ * HDM; e += blockDim.x) {
      const int r = e / HDM, d = e - r * HDM;
      const int i = min(q0 + r, Tn - 1);
      qs[e] = d < hd ? to_f(q[base + static_cast<long long>(i) * D + d]) : 0.0f;
    }
    const int nk = causal ? min(q0 + BQ, Tn) : Tn;  // keys any row of the tile sees
    float mx[RW], sum[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      mx[r] = ninf;
      sum[r] = 0.0f;
    }
    // pass 1: each row's max and sum of exp, rescaled online
    for (int j0 = 0; j0 < nk; j0 += kKeys) {
      __syncthreads();
      stage_rows(ks, k, base, j0, kKeys, nk, hd, HDM, RS, D);
      __syncthreads();
      float l[RW];
      row_dots<HQ>(qw, ks + lane * RS, hd4, l);
      const int j = j0 + lane;
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const int i = min(i0 + r, Tn - 1);
        const bool ok = j < nk && (!causal || j <= i);
        const float lr = ok ? __fmul_rn(rc<T>(l[r]), scale) : ninf;
        const float nm = fmaxf(mx[r], warp_max(lr));
        const float e = ok ? expf(__fsub_rn(lr, nm)) : 0.0f;
        sum[r] = __fadd_rn(__fmul_rn(sum[r], expf(__fsub_rn(mx[r], nm))), warp_sum(e));
        mx[r] = nm;
      }
    }
    // pass 2: p = rc(exp(l - max) / sum) a tile at a time, p.v by column
    float acc[RW][HQ];
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
      for (int c = 0; c < HQ; ++c) acc[r][c] = 0.0f;
    for (int j0 = 0; j0 < nk; j0 += kKeys) {
      __syncthreads();
      stage_rows(ks, k, base, j0, kKeys, nk, hd, HDM, RS, D);
      stage_rows(vs, v, base, j0, kKeys, nk, hd, HDM, RS, D);
      __syncthreads();
      float l[RW];
      row_dots<HQ>(qw, ks + lane * RS, hd4, l);
      const int j = j0 + lane;
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const int i = min(i0 + r, Tn - 1);
        const bool ok = j < nk && (!causal || j <= i);
        const float lr = __fmul_rn(rc<T>(l[r]), scale);
        pw[r * kKeys + lane] = ok ? rc<T>(__fdiv_rn(expf(__fsub_rn(lr, mx[r])), sum[r])) : 0.0f;
      }
      __syncwarp();
      const int kn = min(kKeys, nk - j0);
      for (int jj = 0; jj < kn; ++jj) {
        float vv[HQ];
#pragma unroll
        for (int c = 0; c < HQ; ++c) vv[c] = vs[jj * RS + lane + 32 * c];
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          const float p = pw[r * kKeys + jj];
#pragma unroll
          for (int c = 0; c < HQ; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
        }
      }
      __syncwarp();
    }
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int i = i0 + r;
      if (i >= Tn) continue;
      const long long row = base + static_cast<long long>(i) * D;
#pragma unroll
      for (int c = 0; c < HQ; ++c) {
        const int d = lane + 32 * c;
        if (d < hd) put(out + row + d, acc[r][c]);
      }
    }
  }
}

template <typename T, int HQ>
int launch_tiled(const void* q, const void* k, const void* v, void* out, int N, int Tn,
                 int heads, int hd, int causal, cudaStream_t stream) {
  using S = Tiles<HQ>;
  const size_t smem = fwd_smem_bytes<HQ>();
  cudaError_t err = cudaFuncSetAttribute(attention_tiled_kernel<T, HQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  const int qtiles = (Tn + S::BQ - 1) / S::BQ;
  const dim3 grid(N, heads, qtiles < 65535 ? qtiles : 65535);
  attention_tiled_kernel<T, HQ><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Tn, heads * hd, hd, causal, scale, qtiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_head_dim(const void* q, const void* k, const void* v, void* out, int N, int Tn, int heads,
                int hd, int causal, cudaStream_t st) {
  if (hd <= 32) return launch_tiled<T, 1>(q, k, v, out, N, Tn, heads, hd, causal, st);
  if (hd <= 64) return launch_tiled<T, 2>(q, k, v, out, N, Tn, heads, hd, causal, st);
  if (hd <= 128) return launch_tiled<T, 4>(q, k, v, out, N, Tn, heads, hd, causal, st);
  return launch_tiled<T, 8>(q, k, v, out, N, Tn, heads, hd, causal, st);
}

}  // namespace

// q, k, v, out: [N, T, heads * hd] in the compute dtype (kind KIND_F32 or
// KIND_BF16); 1 <= hd <= 256; any T >= 1.
extern "C" int sw_attention_tiled(const void* q, const void* k, const void* v, void* out, int N,
                                  int T, int heads, int hd, int causal, int kind, void* stream) {
  if (N == 0) return static_cast<int>(cudaGetLastError());
  if (N < 0 || T < 1 || heads < 1 || heads > 65535 || hd < 1 || hd > 256 ||
      (kind != KIND_F32 && kind != KIND_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return kind == KIND_BF16
             ? by_head_dim<__nv_bfloat16>(q, k, v, out, N, T, heads, hd, causal, st)
             : by_head_dim<float>(q, k, v, out, N, T, heads, hd, causal, st);
}
