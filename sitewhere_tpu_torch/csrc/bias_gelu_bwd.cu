// KU bias_gelu_bwd: the backward of fc1's bias add and the tanh GELU, with
// the per-slot bias gradient.
//
// Replaces the vjp of the MLP's dense(fc1) bias add and jax.nn.gelu
// (approximate=True) of sitewhere_tpu/models/common.py:329-343
// transformer_block_stacked (GELU at :340) as jax.grad runs it through the
// transformer family's train loss (models/transformer.py:272): fc1's
// matmul output f [N, F] (pre-bias) and the GELU output's cotangent dy
// [N, F] in the compute dtype, the per-slot bias f32[S, F] (row n in slot
// n / rows_per_slot) -> df [N, F] (the cotangent of f, which is also the
// bias add's) and the bias gradient f32[S, F].
// Rounding as the reference's grad HLO in bf16: every op rounds to bf16
// and the constants are bf16 (c = 0.796875, k = 0.044677734375, 0.5, 3).
// With y = f + b and the forward's parts (x3 = (y*y)*y, inner = y + k*x3,
// th = tanh(c*inner), cdf = 0.5*(1 + th), as KU computes them):
//   v1 = y*dy, v2 = dy*cdf, v3 = 0.5*v1, v4 = v3*(1 - th), v5 = v4*th,
//   v6 = v4 + v5, v7 = c*v6, v8 = v2 + v7, v9 = k*v7, t3 = 3*(y*y),
//   df = v8 + v9*t3
// and the bias gradient is the slot's column sum of df, accumulated in f32
// and rounded to the compute dtype (the reference reduces the bf16
// cotangent and widens it to the f32 bias). With f32 compute nothing
// rounds but f32 itself (no FMA contraction).
//
// Bound on the H100: bytes. Each element reads f and dy and writes df (6
// bytes in bf16) for ~30 operations. Design: a block takes a tile of
// kTileRows rows of one slot, its threads consecutive columns (loads and
// stores coalesced), each thread summing its columns' df over the tile in
// order into partials f32[S, tiles, F]; tile_sum adds the tiles in order
// and rounds: no float atomics, two runs give the same bits.
#include <cmath>

#include "common.cuh"
#include "tile_sum.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 256;

template <bool BF16>
__global__ void __launch_bounds__(kThreads)
bias_gelu_bwd_kernel(const void* __restrict__ x, const float* __restrict__ b,
                     const void* __restrict__ dy, void* __restrict__ dx,
                     float* __restrict__ part, long long rows_per_slot, int F) {
  const int kind = BF16 ? KIND_BF16 : KIND_F32;
  const float c = rb<BF16>(0.7978845608028654f);  // sqrt(2 / pi)
  const float k = rb<BF16>(0.044715f);
  const int t = blockIdx.y, tiles = gridDim.x;
  const long long r0 = static_cast<long long>(blockIdx.x) * kTileRows;
  const long long r1 = r0 + kTileRows < rows_per_slot ? r0 + kTileRows : rows_per_slot;
  for (int col = threadIdx.x; col < F; col += kThreads) {
    const float bc = rb<BF16>(b[static_cast<long long>(t) * F + col]);
    float acc = 0.0f;
    for (long long r = r0; r < r1; ++r) {
      const long long i = (static_cast<long long>(t) * rows_per_slot + r) * F + col;
      const float y = rb<BF16>(__fadd_rn(load_val(x, kind, i), bc));
      const float g = load_val(dy, kind, i);
      const float y2 = rb<BF16>(__fmul_rn(y, y));
      const float x3 = rb<BF16>(__fmul_rn(y2, y));
      const float inner = rb<BF16>(__fadd_rn(y, rb<BF16>(__fmul_rn(k, x3))));
      const float th = rb<BF16>(tanhf(rb<BF16>(__fmul_rn(c, inner))));
      const float cdf = rb<BF16>(__fmul_rn(0.5f, rb<BF16>(__fadd_rn(1.0f, th))));
      const float v1 = rb<BF16>(__fmul_rn(y, g));
      const float v2 = rb<BF16>(__fmul_rn(g, cdf));
      const float v3 = rb<BF16>(__fmul_rn(0.5f, v1));
      const float v4 = rb<BF16>(__fmul_rn(v3, rb<BF16>(__fsub_rn(1.0f, th))));
      const float v5 = rb<BF16>(__fmul_rn(v4, th));
      const float v6 = rb<BF16>(__fadd_rn(v4, v5));
      const float v7 = rb<BF16>(__fmul_rn(c, v6));
      const float v8 = rb<BF16>(__fadd_rn(v2, v7));
      const float v9 = rb<BF16>(__fmul_rn(k, v7));
      const float t3 = rb<BF16>(__fmul_rn(3.0f, y2));
      const float d = rb<BF16>(__fadd_rn(v8, rb<BF16>(__fmul_rn(v9, t3))));
      store_val(dx, kind, i, d);
      acc = __fadd_rn(acc, d);
    }
    part[(static_cast<long long>(t) * tiles + blockIdx.x) * F + col] = acc;
  }
}

}  // namespace

// x, dy, dx: [T * rows_per_slot, F] (kind KIND_F32 or KIND_BF16); b:
// f32[T, F]; part: f32[T, tiles, F] scratch with tiles =
// ceil(rows_per_slot / 256); db: f32[T, F].
extern "C" int sw_bias_gelu_bwd(const void* x, const float* b, const void* dy, void* dx,
                                float* part, float* db, int T, int F, long long rows_per_slot,
                                int kind, void* stream) {
  if (T == 0 || F == 0 || rows_per_slot == 0) return static_cast<int>(cudaGetLastError());
  if (T < 0 || T > 65535 || F < 0 || rows_per_slot < 0 ||
      (kind != KIND_F32 && kind != KIND_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (rows_per_slot + kTileRows - 1) / kTileRows;
  if (tiles > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(tiles), T);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == KIND_BF16) {
    bias_gelu_bwd_kernel<true><<<grid, kThreads, 0, st>>>(x, b, dy, dx, part, rows_per_slot, F);
  } else {
    bias_gelu_bwd_kernel<false><<<grid, kThreads, 0, st>>>(x, b, dy, dx, part, rows_per_slot, F);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_tile_sum(part, db, T, static_cast<int>(tiles), F, kind == KIND_BF16, st);
}
