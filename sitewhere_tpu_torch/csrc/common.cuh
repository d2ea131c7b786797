// Shared helpers of the kernels: wire dtype loads/stores, id loads, the
// per-row validity rule, bf16 rounding points, and the row prologue of the
// scan scorers (KS, KD). Included by every kernel source.
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
__device__ __forceinline__ void normalize_row(float* x, int W, float& mu, float& sigma) {
  float sum = 0.0f;
  for (int c = 0; c < W; ++c) sum += x[c];
  mu = sum / static_cast<float>(W);
  float sq = 0.0f;
  for (int c = 0; c < W; ++c) {
    const float d = x[c] - mu;
    sq += d * d;
  }
  sigma = sqrtf(sq / static_cast<float>(W)) + 1e-6f;
  for (int c = 0; c < W; ++c) x[c] = (x[c] - mu) / sigma;
}

// Row prologue of the scan scorers (KS, KD; `A` is their argument struct,
// which names the same fields). Loads row b of slot t into x[0..W),
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
