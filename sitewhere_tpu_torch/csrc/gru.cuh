// The DeepAR GRU's arithmetic, shared by KD (gru_score.cu), KF
// (deepar_forecast.cu) and KR's forward (gru_train.cu): one gate column's
// input and recurrent terms and the cell update, with the reference's bf16
// rounding points (sitewhere_tpu/models/deepar.py:58-81, :111-119). The
// explicit _rn intrinsics keep nvcc from contracting a product and a sum
// into one FMA where the reference rounds between them.
#pragma once
#include "common.cuh"

// gx = x_t * wx[j] + bx[j]: the product, then the bias add, each rounded.
template <bool BF16>
__device__ __forceinline__ float gru_gx(float x, float wxj, float bxj) {
  return rb<BF16>(__fadd_rn(rb<BF16>(__fmul_rn(rb<BF16>(x), wxj)), bxj));
}

// gh = h . wh[:, j] + bh[j]: the f32-accumulated dot rounded once, then
// the bias add rounded.
template <bool BF16>
__device__ __forceinline__ float gru_gh(float acc, float bhj) {
  return rb<BF16>(__fadd_rn(rb<BF16>(acc), bhj));
}

// The cell's rounded parts: r = sigmoid(rx + rh), z = sigmoid(zx + zh),
// n = tanh(nx + r * nh) and the new h' = (1 - z) * n + z * h; sr and sz
// are the rounded gate sums.
struct GruParts {
  float r, z, n, h;
};

template <bool BF16>
__device__ __forceinline__ GruParts gru_cell_parts(float sr, float sz, float nx, float nh,
                                                   float h) {
  const float r = sigm<BF16>(sr);
  const float z = sigm<BF16>(sz);
  const float n = rb<BF16>(tanhf(rb<BF16>(__fadd_rn(nx, rb<BF16>(__fmul_rn(r, nh))))));
  const float h2 = rb<BF16>(__fadd_rn(rb<BF16>(__fmul_rn(rb<BF16>(__fsub_rn(1.0f, z)), n)),
                                      rb<BF16>(__fmul_rn(z, h))));
  return GruParts{r, z, n, h2};
}

// h' = (1 - z) * n + z * h (KD, KF).
template <bool BF16>
__device__ __forceinline__ float gru_cell(float sr, float sz, float nx, float nh, float h) {
  return gru_cell_parts<BF16>(sr, sz, nx, nh, h).h;
}
