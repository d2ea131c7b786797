// KL layernorm_bwd: LayerNorm's backward over rows, with the per-slot
// scale and bias gradients.
//
// Replaces the vjp of sitewhere_tpu/models/common.py:295 layernorm_stacked
// as jax.grad runs it through the transformer family's train loss
// (models/transformer.py:272 loss_stacked: ln1 and ln2 of every block,
// :329, and ln_f, :240): rows x [N, D] and their cotangent dy [N, D] in
// the compute dtype, row n in slot n / rows_per_slot, the per-slot scale
// f32[S, D]. The reference computes LayerNorm in f32 and casts its output
// to x's dtype, so its vjp widens dy to f32, runs the f32 backward and
// casts dx back. In the order of the reference's grad jaxpr (XLA folds
// its divisions by D into products by 1/D and 2/D):
//   mean = sum(x) / D, c = x - mean, ve = sum(c^2) / D + 1e-5, r = rsqrt(ve)
//   gy = dy * scale, dcd = gy * r, dr = sum(c * gy)
//   dvar = dr * ((r / ve) * -0.5), t2 = c * (dvar * 2 / D)
//   dx = (dcd + t2) + ((-sum(dcd)) + (-sum(t2))) / D      (cast back)
//   dscale = sum over the slot's rows of (c * r) * dy, dbias = sum of dy
// (f32, not rounded: the affine is f32 math on f32 params).
//
// Bound on the H100: bytes. Each row reads x and dy and writes dx (3 D
// values) for ~20 D operations. Design: one warp per row as the forward
// (the row's D values in registers, D / 32 a lane, the statistics and the
// two backward sums by shuffles); a block takes a tile of kTileRows rows
// of one slot, eight warps striding over it; each lane keeps its columns'
// dscale and dbias sums over the warp's rows, the block adds its warps in
// order into one row of partials f32[S, tiles, 2 D], and tile_sum adds the
// tiles in order: no float atomics, two runs give the same bits.
#include "common.cuh"
#include "tile_sum.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kTileRows = 512;

template <bool BF16, int VPT>
__global__ void __launch_bounds__(kWarps * 32)
layernorm_bwd_kernel(const void* __restrict__ x, const float* __restrict__ scale,
                     const void* __restrict__ dy, void* __restrict__ dx,
                     float* __restrict__ part, long long rows_per_slot) {
  constexpr int D = 32 * VPT;
  __shared__ float buf[D];
  const int kind = BF16 ? KIND_BF16 : KIND_F32;
  const int t = blockIdx.y, tiles = gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float inv_d = 1.0f / static_cast<float>(D);
  const float two_d = 2.0f / static_cast<float>(D);
  float sc[VPT], ds[VPT], db[VPT];
#pragma unroll
  for (int c = 0; c < VPT; ++c) {
    sc[c] = scale[static_cast<long long>(t) * D + lane + 32 * c];
    ds[c] = 0.0f;
    db[c] = 0.0f;
  }
  const long long r0 = static_cast<long long>(blockIdx.x) * kTileRows;
  const long long r1 = r0 + kTileRows < rows_per_slot ? r0 + kTileRows : rows_per_slot;
  for (long long r = r0 + warp; r < r1; r += kWarps) {
    const long long off = (static_cast<long long>(t) * rows_per_slot + r) * D;
    float v[VPT], g[VPT];
#pragma unroll
    for (int c = 0; c < VPT; ++c) {
      v[c] = load_val(x, kind, off + lane + 32 * c);
      g[c] = load_val(dy, kind, off + lane + 32 * c);
    }
    float ve;
    const float rr = warp_ln_center<VPT>(v, ve);  // v is now c = x - mean
    float dr = 0.0f;
#pragma unroll
    for (int c = 0; c < VPT; ++c) {
      const float gy = __fmul_rn(g[c], sc[c]);
      dr = __fadd_rn(dr, __fmul_rn(v[c], gy));
      ds[c] = __fadd_rn(ds[c], __fmul_rn(__fmul_rn(v[c], rr), g[c]));
      db[c] = __fadd_rn(db[c], g[c]);
    }
    dr = warp_sum(dr);
    const float dvar = __fmul_rn(dr, __fmul_rn(__fdiv_rn(rr, ve), -0.5f));
    const float q = __fmul_rn(dvar, two_d);
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int c = 0; c < VPT; ++c) {
      s1 = __fadd_rn(s1, __fmul_rn(__fmul_rn(g[c], sc[c]), rr));
      s2 = __fadd_rn(s2, __fmul_rn(v[c], q));
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    const float dmean = __fmul_rn(__fadd_rn(-s1, -s2), inv_d);
#pragma unroll
    for (int c = 0; c < VPT; ++c) {
      const float dcd = __fmul_rn(__fmul_rn(g[c], sc[c]), rr);
      const float t2 = __fmul_rn(v[c], q);
      store_val(dx, kind, off + lane + 32 * c, __fadd_rn(__fadd_rn(dcd, t2), dmean));
    }
  }
  float* dst = part + (static_cast<long long>(t) * tiles + blockIdx.x) * 2 * D;
  block_column_sums<VPT, kWarps>(ds, buf, dst);
  block_column_sums<VPT, kWarps>(db, buf, dst + D);
}

template <bool BF16>
int launch_klb(const void* x, const float* scale, const void* dy, void* dx, float* part,
               float* reduced, int T, int D, long long rows_per_slot, int tiles,
               cudaStream_t st) {
  const dim3 grid(tiles, T);
  const int threads = kWarps * 32;
#define SW_KLB_CASE(V)                                                                 \
  case 32 * V:                                                                         \
    layernorm_bwd_kernel<BF16, V><<<grid, threads, 0, st>>>(x, scale, dy, dx, part,    \
                                                            rows_per_slot);            \
    break;
  switch (D) {
    SW_KLB_CASE(1)
    SW_KLB_CASE(2)
    SW_KLB_CASE(4)
    SW_KLB_CASE(8)
    SW_KLB_CASE(16)
    SW_KLB_CASE(24)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SW_KLB_CASE
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_tile_sum(part, reduced, T, tiles, 2 * D, 0, st);
}

}  // namespace

// x, dy, dx: [T * rows_per_slot, D] (kind KIND_F32 or KIND_BF16); scale:
// f32[T, D]; part: f32[T, tiles, 2 D] scratch with tiles =
// ceil(rows_per_slot / 512); reduced: f32[T, 2 D], [dscale | dbias] a slot.
// D one of 32, 64, 128, 256, 512, 768.
extern "C" int sw_layernorm_bwd(const void* x, const float* scale, const void* dy, void* dx,
                                float* part, float* reduced, int T, int D,
                                long long rows_per_slot, int kind, void* stream) {
  if (T == 0 || rows_per_slot == 0) return static_cast<int>(cudaGetLastError());
  if (T < 0 || rows_per_slot < 0 || (kind != KIND_F32 && kind != KIND_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (rows_per_slot + kTileRows - 1) / kTileRows;
  if (tiles > 2147483647LL || T > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return kind == KIND_BF16
             ? launch_klb<true>(x, scale, dy, dx, part, reduced, T, D, rows_per_slot,
                                static_cast<int>(tiles), st)
             : launch_klb<false>(x, scale, dy, dx, part, reduced, T, D, rows_per_slot,
                                 static_cast<int>(tiles), st);
}
