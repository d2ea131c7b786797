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

#include <type_traits>

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

// Storage formats of the scan kernels' weight leaves (KS, KD; the
// per-tenant param_dtype, models/flush.py WEIGHT_FORMATS): f32 masters,
// bf16 (w cast once), int8 (qw per slot and output channel, f32 scales).
enum { WF_F32 = 0, WF_BF16 = 1, WF_I8 = 2 };

// Weight i of a dense leaf at the compute dtype, as models/common.py
// kernel_weight reads it: f32 masters rounded to the compute dtype; bf16
// storage widened (exact, and already a bf16 value); int8 storage
// dequantized, qw * scale at the compute dtype: in bf16 rb(q * rb(scale))
// (|q| <= 127 times a bf16 scale is exact in f32, so the one rounding is
// the reference's), in f32 q * scale. si indexes the leaf's scale
// [slot][output channel].
template <int WF, bool BF16>
__device__ __forceinline__ float wload(const void* w, const float* scale, long long i,
                                       long long si) {
  if constexpr (WF == WF_BF16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(w)[i]);
  } else if constexpr (WF == WF_I8) {
    const float q = static_cast<float>(static_cast<const int8_t*>(w)[i]);
    return rb<BF16>(__fmul_rn(q, rb<BF16>(scale[si])));
  } else {
    return rb<BF16>(static_cast<const float*>(w)[i]);
  }
}

// Threads of a block of n gate columns, padded to whole warps (the GRU's
// 3H columns are 24 and 48 threads at H = 8 and 16).
__host__ __device__ constexpr int whole_warps(int n) { return (n + 31) / 32 * 32; }

// The lanes of the heads' dot products over hidden states (KS, KD, KF, KB,
// KR): a row takes L = min(H, 32) lanes, so a warp takes RPW = 32 / L rows
// at once; lane ul of a row holds units ul, ul + 32, ... (HQ of them) and
// the row's sum is a shuffle tree over its L lanes. At H >= 32 a warp takes
// one row with every lane, as before the narrow widths.
template <int H>
struct HeadLanes {
  static constexpr int L = H < 32 ? H : 32;
  static constexpr int RPW = 32 / L;
  static constexpr int HQ = (H + 31) / 32;
  static_assert(H % 32 == 0 || 32 % H == 0, "head lanes");
};

// Sum v over the L lanes of each aligned group (a row of HeadLanes).
template <int L>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// group_sum of two values (the Gaussian heads' mu and sigma), their
// shuffles interleaved.
template <int L>
__device__ __forceinline__ void group_sum2(float& a, float& b) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
}

// The widths the recurrent kernels are built for: KS, KD, KF, KB and KR
// instantiate each of these hidden sizes (models/flush.py SCAN_HIDDENS).
// Past 64 a thread's H-float weight column no longer fits the registers.
template <class F>
inline int by_hidden(int H, F&& f) {
  switch (H) {
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dispatch the compute dtype (bf16 or f32) at compile time.
template <class F>
inline int by_bf16(int bf16, F&& f) {
  return bf16 ? f(std::true_type{}) : f(std::false_type{});
}

// Dispatch a weight storage format at compile time.
template <class F>
inline int by_format(int wf, F&& f) {
  switch (wf) {
    case WF_F32: return f(std::integral_constant<int, WF_F32>{});
    case WF_BF16: return f(std::integral_constant<int, WF_BF16>{});
    case WF_I8: return f(std::integral_constant<int, WF_I8>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
// Also sets ve = var + 1e-5 (the LayerNorm backward, KL's and KN's train
// modes, reads it).
template <int VPT>
__device__ __forceinline__ float warp_ln_center(float (&v)[VPT], float& ve) {
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
  ve = __fadd_rn(__fmul_rn(sq, inv_d), 1e-5f);
  return __frsqrt_rn(ve);
}

template <int VPT>
__device__ __forceinline__ float warp_ln_center(float (&v)[VPT]) {
  float ve;
  return warp_ln_center<VPT>(v, ve);
}

// The sum of v over the 32 lanes of a warp (a shuffle tree, every lane
// gets it).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// LayerNorm's affine step on a centered value: (v * r) * scale + bias in
// f32, two rounded ops.
__device__ __forceinline__ float ln_affine(float v, float r, float scale, float bias) {
  return __fadd_rn(__fmul_rn(__fmul_rn(v, r), scale), bias);
}
