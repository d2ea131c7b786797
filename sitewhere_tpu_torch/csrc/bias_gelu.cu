// KU bias_gelu: fc1's bias add and the tanh GELU in one elementwise pass.
//
// Replaces the MLP's dense(fc1) bias add and jax.nn.gelu (approximate=True)
// of sitewhere_tpu/models/common.py:329-343 transformer_block_stacked, over
// fc1's matmul output x [N, F] in the compute dtype with the per-slot bias
// f32[S, F] (row n in slot n / rows_per_slot). Rounding as the reference
// (XLA rounds each op of jax.nn.gelu in bf16): y = x + b, then
// x3 = (y * y) * y, inner = y + k * x3, t = tanh(c * inner),
// cdf = 0.5 * (1 + t), out = y * cdf, each op rounded to the compute dtype,
// with c = sqrt(2/pi) and k = 0.044715 themselves cast to it. With f32
// compute nothing rounds but f32 itself (no FMA contraction).
//
// Bound on the H100: bytes. Each element is read once and written once
// for ~10 operations. Design: a block takes eight rows, its threads
// consecutive columns of each (the row's slot and bias row found once a
// row); the bias is read through the cache.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 8;

template <bool BF16>
__global__ void __launch_bounds__(256)
bias_gelu_kernel(const void* __restrict__ x, const float* __restrict__ b,
                 void* __restrict__ out, long long N, int F, long long rows_per_slot) {
  const int kind = BF16 ? KIND_BF16 : KIND_F32;
  const float c = rb<BF16>(0.7978845608028654f);  // sqrt(2 / pi)
  const float k = rb<BF16>(0.044715f);
  const long long r0 = static_cast<long long>(blockIdx.x) * kRowsPerBlock;
  for (int r = 0; r < kRowsPerBlock && r0 + r < N; ++r) {
    const long long row = r0 + r;
    const float* br = b + (row / rows_per_slot) * F;
    const long long base = row * F;
    for (int col = threadIdx.x; col < F; col += blockDim.x) {
      const float y = rb<BF16>(__fadd_rn(load_val(x, kind, base + col), rb<BF16>(br[col])));
      const float x3 = rb<BF16>(__fmul_rn(rb<BF16>(__fmul_rn(y, y)), y));
      const float inner = rb<BF16>(__fadd_rn(y, rb<BF16>(__fmul_rn(k, x3))));
      const float t = rb<BF16>(tanhf(rb<BF16>(__fmul_rn(c, inner))));
      const float cdf = rb<BF16>(__fmul_rn(0.5f, rb<BF16>(__fadd_rn(1.0f, t))));
      store_val(out, kind, base + col, __fmul_rn(y, cdf));
    }
  }
}

}  // namespace

// x, out: [N, F] (kind KIND_F32 or KIND_BF16); b: f32[N / rows_per_slot, F].
extern "C" int sw_bias_gelu(const void* x, const float* b, void* out, long long N, int F,
                            long long rows_per_slot, int kind, void* stream) {
  if (N == 0 || F == 0) return static_cast<int>(cudaGetLastError());
  if (F < 1 || rows_per_slot < 1 || (kind != KIND_F32 && kind != KIND_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>((N + kRowsPerBlock - 1) / kRowsPerBlock);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == KIND_BF16) {
    bias_gelu_kernel<true><<<grid, 256, 0, st>>>(x, b, out, N, F, rows_per_slot);
  } else {
    bias_gelu_kernel<false><<<grid, 256, 0, st>>>(x, b, out, N, F, rows_per_slot);
  }
  return static_cast<int>(cudaGetLastError());
}
