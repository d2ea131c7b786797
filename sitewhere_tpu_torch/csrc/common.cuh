// Shared helpers of the kernels: wire dtype loads/stores, id loads, the
// per-row validity rule, bf16 rounding points, the row prologue of the
// window scorers (KS, KD, KE; its normalization also the train forms' KB
// and KR, bptt.cuh), the Gaussian head epilogue (KD, KF, KN, KR) and a
// warp's LayerNorm statistics (KL, KN). Included by every kernel source.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

// value / score wire kinds (sitewhere_tpu_torch.kernels callers pass these)
enum { KIND_F32 = 0, KIND_BF16 = 1, KIND_F16 = 2 };
// stream-id wire kinds
enum { ID_I32 = 0, ID_U16 = 1 };

__device__ __forceinline__ float load_val(const void* p, int kind, long long i) {
  if (kind == KIND_BF16) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  if (kind == KIND_F16) return __half2float(static_cast<const __half*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_val(void* p, int kind, long long i, float v) {
  if (kind == KIND_BF16) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  } else if (kind == KIND_F16) {
    static_cast<__half*>(p)[i] = __float2half_rn(v);
  } else {
    static_cast<float*>(p)[i] = v;
  }
}

__device__ __forceinline__ long long load_id(const void* p, int kind, long long i) {
  if (kind == ID_U16) return static_cast<long long>(static_cast<const uint16_t*>(p)[i]);
  return static_cast<long long>(static_cast<const int32_t*>(p)[i]);
}

// A row is valid by its lane count (counts mode: rows fill each lane from
// the front) or by a bool mask (mask mode); exactly one of the two is set.
__device__ __forceinline__ bool row_valid(const int* counts, const unsigned char* mask,
                                          int t, int b, int B) {
  if (mask != nullptr) return mask[static_cast<long long>(t) * B + b] != 0;
  return b < counts[t];
}

// Round a float to bf16 and back (round to nearest even): the rounding
// points of a bf16 computation carried in f32 registers.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// rb<true> rounds to bf16 (a rounding point of the bf16 computation);
// rb<false> is the identity (f32 compute).
template <bool BF16>
__device__ __forceinline__ float rb(float x) {
  if constexpr (BF16) return round_bf16(x);
  return x;
}

// jax.nn.sigmoid as XLA lowers it: 1 / (1 + exp(-x)) as three ops, so with
// bf16 compute the exp, the add and the division each round.
template <bool BF16>
__device__ __forceinline__ float sigm(float x) {
  return rb<BF16>(1.0f / rb<BF16>(1.0f + rb<BF16>(expf(-x))));
}

// Per-row standardization of x[0..W), as models/common.py
// normalize_windows: population std, eps added outside the square root.
// The mean is summed relative to x[0] (mu = x0 + sum(x - x0) / W): a
// running sum of raw values that sit far from zero (a temperature series
// of 21 +- 4) loses digits that torch's tree-summed mean keeps, and a
// constant window (one sample, left-padded) gets exactly x0 as its mean.
__device__ __forceinline__ void normalize_row(float* x, int W, float& mu, float& sigma) {
  const float x0 = x[0];
  float sum = 0.0f;
  for (int c = 0; c < W; ++c) sum += x[c] - x0;
  mu = x0 + sum / static_cast<float>(W);
  float sq = 0.0f;
  for (int c = 0; c < W; ++c) {
    const float d = x[c] - mu;
    sq += d * d;
  }
  sigma = sqrtf(sq / static_cast<float>(W)) + 1e-6f;
  for (int c = 0; c < W; ++c) x[c] = (x[c] - mu) / sigma;
}

// Row prologue of the window scorers (KS, KD, KE; `A` is their argument
// struct, which names the same fields). Loads row b of slot t into x[0..W),
// normalized. Windows mode (a.windows set) reads the given window and
// n_valid; ring mode gathers from the post-update ring, clamping the id
// into [0, S) as XLA's gather does, and left-pads a short history with its
// oldest value (ops/windows.py gather_windows). Sets n (samples, at most
// W) and col (the score column the row takes by its `later`; -1 = every
// column, windows mode). Returns whether the row is scored: a valid row of
// an active slot in ring mode, every row in windows mode.
template <class A>
__device__ bool scan_row_load(const A& a, int t, int b, float* x, int& n, int& col) {
  const int W = a.W, K = a.K;
  const long long row = static_cast<long long>(t) * a.B + b;
  const bool select = a.later != nullptr;
  const bool live = select ? (a.active[t] != 0 && row_valid(a.counts, a.mask, t, b, a.B)) : true;
  if (a.windows != nullptr) {
    const float* src = a.windows + row * W;
    for (int c = 0; c < W; ++c) x[c] = src[c];
    n = a.n_valid[row];
  } else {
    long long id = load_id(a.ids, a.id_kind, row);
    id = id < 0 ? 0 : (id >= a.S ? a.S - 1 : id);  // reads clamp
    const long long s = static_cast<long long>(t) * a.S + id;
    const float* raw = a.ring + s * W;
    const int p = a.pos[s];
    const int cnt = a.count[s];
    n = cnt < W ? cnt : W;
    const int fvc = W - n;  // first valid column
    const float first = raw[(p + (fvc < W - 1 ? fvc : W - 1)) % W];
    for (int c = 0; c < W; ++c) x[c] = c < fvc ? first : raw[(p + c) % W];
  }
  float mu, sigma;
  normalize_row(x, W, mu, sigma);
  col = -1;
  if (select) {
    if (K > 1) {
      const int c = K - 1 - a.later[row];
      col = c < 0 ? 0 : (c > K - 1 ? K - 1 : c);
    } else {
      col = 0;
    }
  }
  return live;
}

// sigma = softplus(raw) + 1e-4, softplus = logaddexp(raw, 0) as
// jax.nn.softplus computes it (no threshold): the DeepAR and transformer
// heads.
__device__ __forceinline__ float gauss_sigma(float raw) {
  return __fadd_rn(__fadd_rn(fmaxf(raw, 0.0f), log1pf(expf(-fabsf(raw)))), 1e-4f);
}

// Gaussian NLL 0.5 log(2 pi sigma^2) + (t - mu)^2 / (2 sigma^2), in f32.
__device__ __forceinline__ float gaussian_nll(float t, float mu, float sigma) {
  const float s2 = __fmul_rn(sigma, sigma);
  const float d = __fsub_rn(t, mu);
  return __fadd_rn(__fmul_rn(0.5f, logf(__fmul_rn(6.2831855f, s2))),
                   __fdiv_rn(__fmul_rn(d, d), __fmul_rn(2.0f, s2)));
}

// LayerNorm statistics of one row of D = 32 * VPT values held by a warp
// (lane l holds columns l, l + 32, ...), as models/common.py layernorm:
// f32 mean = sum / D (XLA multiplies by 1/D), var = sum((x - mean)^2) / D,
// r = rsqrt(var + 1e-5). Centers v in place and returns r; the caller
// finishes y = v * r, out = y * scale + bias.
template <int VPT>
__device__ __forceinline__ float warp_ln_center(float (&v)[VPT]) {
  const float inv_d = 1.0f / static_cast<float>(32 * VPT);
  float sum = 0.0f;
#pragma unroll
  for (int c = 0; c < VPT; ++c) sum = __fadd_rn(sum, v[c]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
  const float mean = __fmul_rn(sum, inv_d);
  float sq = 0.0f;
#pragma unroll
  for (int c = 0; c < VPT; ++c) {
    v[c] = __fsub_rn(v[c], mean);
    sq = __fadd_rn(sq, __fmul_rn(v[c], v[c]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sq = __fadd_rn(sq, __shfl_xor_sync(0xffffffffu, sq, o));
  return __frsqrt_rn(__fadd_rn(__fmul_rn(sq, inv_d), 1e-5f));
}

// LayerNorm's affine step on a centered value: (v * r) * scale + bias in
// f32, two rounded ops.
__device__ __forceinline__ float ln_affine(float v, float r, float scale, float bias) {
  return __fadd_rn(__fmul_rn(__fmul_rn(v, r), scale), bias);
}
