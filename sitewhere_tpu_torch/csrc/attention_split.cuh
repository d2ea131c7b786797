// Shared pieces of KA's split form (attention_split.cu, its backward
// attention_split_bwd.cu): attention at head dims past the tiled form's 256.
//
// The tiled form (attention_tiled.cu) gives each lane hd/32 output columns
// of each of its warp's 16/(hd/32) query rows: 16 accumulators a lane, so
// hd 256 is the widest head it holds (past hd 512 a warp would hold no row
// at all). The split form cuts the output columns into chunks of kChunk
// (256) and gives each chunk its own block; every block computes the
// logits q.k^T (and in the backward dp = dout.v^T) over the FULL head dim,
// streaming q, k (v, dout) through shared memory kChunk columns at a time
// and continuing one f32 sum, d ascending: every chunk's block forms the
// same bits of p, and the sum is the one the tiled form's row_dots would
// form at that hd. A block then accumulates p.v (the backward dq, dk, dv)
// for its own columns only. No atomics: two runs are bitwise equal.
#pragma once
#include "common.cuh"

namespace ka_split {

constexpr int kWarps = 4;
constexpr int kTile = 32;            // keys (or queries) a streamed tile: one a lane
constexpr int kChunk = 256;          // columns a chunk
constexpr int kHQ = kChunk / 32;     // own columns a lane
constexpr int kRW = 2;               // rows (keys) a warp: kRW x kHQ = 16 accumulators
constexpr int kBR = kWarps * kRW;    // rows (keys) a block
constexpr int kRS = kChunk + 4;      // padded stride of a streamed tile's rows

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__device__ __forceinline__ float rc(float x) {
  return rb<sizeof(T) == 2>(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Columns [c0, c0 + kChunk) of rows [r0, r0 + n) of x (rows at or past
// `valid` and columns at or past hd are 0; with `clamp` a row past `valid`
// repeats row valid - 1 instead) into dst, n rows of stride `stride`.
template <typename T>
__device__ __forceinline__ void stage_cols(float* dst, const T* __restrict__ x, long long base,
                                           int r0, int n, int valid, bool clamp, int c0, int hd,
                                           int stride, int D) {
  for (int e = threadIdx.x; e < n * kChunk; e += blockDim.x) {
    const int r = e / kChunk, d = e - r * kChunk;
    int j = r0 + r;
    bool ok = j < valid;
    if (clamp && !ok) {
      j = valid - 1;
      ok = true;
    }
    dst[r * stride + d] =
        (ok && c0 + d < hd) ? to_f(x[base + static_cast<long long>(j) * D + c0 + d]) : 0.0f;
  }
}

// l[r] += a_r . b over w4 columns (a multiple of 4; the padding is 0): kRW
// rows a (stride sa, shared by the warp) against the lane's row b, d
// ascending. Continued over the chunks it is the tiled form's row_dots.
__device__ __forceinline__ void dots_acc(const float* a, int sa, const float* b, int w4,
                                         float (&l)[kRW]) {
  for (int d = 0; d < w4; d += 4) {
    const float4 bv = *reinterpret_cast<const float4*>(b + d);
#pragma unroll
    for (int r = 0; r < kRW; ++r) {
      const float4 av = *reinterpret_cast<const float4*>(a + r * sa + d);
      l[r] = fmaf(av.x, bv.x, l[r]);
      l[r] = fmaf(av.y, bv.y, l[r]);
      l[r] = fmaf(av.z, bv.z, l[r]);
      l[r] = fmaf(av.w, bv.w, l[r]);
    }
  }
}

// Columns of the chunk from c0 that exist (hd - c0, at most kChunk),
// rounded up to 4.
__device__ __forceinline__ int chunk_w4(int c0, int hd) {
  const int w = min(kChunk, hd - c0);
  return (w + 3) & ~3;
}

}  // namespace ka_split
