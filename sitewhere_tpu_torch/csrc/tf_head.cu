// KN tf_head: the transformer's final LayerNorm, (mu, raw sigma) head and
// Gaussian epilogue, in one kernel.
//
// Replaces what the JAX package runs after the transformer's last block:
// models/transformer.py:240 ln_f, then in the scoring flush :258-269 (the
// head on the last K positions, softplus + 1e-4, the Gaussian NLL against
// the normalized targets, kstep_mask) and parallel/sharded.py:564-580
// (K4a: the `later` column select, zeroing of inactive slots and invalid
// rows, the wire cast); in the forecast, :178-182 _emit at the last
// position and one step of :213-220 (x = mu + sigma * eps, the context
// shift) plus the un-normalization of :224-225.
//
// ln_f is applied to the positions the head reads only: LayerNorm is per
// position, so that equals the reference's ln_f over every position read at
// those. Rounding as the reference: ln_f in f32, cast to the compute dtype;
// each head output is an f32-accumulated dot rounded to the compute dtype,
// plus the rounded bias, rounded, then widened to f32; the rest in f32.
//
// Weight formats: in the score and forecast modes the head weight [T, D, 2]
// is read through wload (common.cuh) as the tenant's param_dtype stored it:
// f32 masters, bf16, or int8 qw with per-slot, per-channel f32 scales
// [T, 1, 2] (kernel_weight's dequant, common.py:265); ln_f and the head bias
// stay f32 in every format. The train mode reads the f32 masters only (the
// reference differentiates them, parallel/sharded.py:1111).
//
// Modes: score (windows mode: all K columns f32[T, B, K]; flush mode,
// `later` set: one column a row, masked and cast, [T, B]) and forecast
// (`eps` set, one slot, one launch per horizon step: writes column `step`
// of samples and means f32[B, HZ] in raw units and ctx[:, 1:] ++ x into
// ctx_next f32[B, C]).
//
// Train mode (sw_tf_head_train; the train loss, models/transformer.py:272
// loss_stacked, :284-293, under jax.grad): forward, ln_f and the head at
// every position of h [S, B, Tt, D], softplus + 1e-4, the Gaussian NLL
// against the normalized window's next values (normed f32[S, B, W], target
// of position p is normed[p + 1]) and the row mean -> per-row loss f32[S,
// B]; it saves the two head outputs (mu, raw sigma) f32[S, B, Tt, 2], from
// which the backward evaluates the reference's derivatives in its own
// order (rather than saving derivatives, which would need the seed).
// Backward, from the seed g_row f32[S, B]: per position, in f32 as the
// reference's grad HLO (XLA folds the mean's division into products by
// 1/Tt and 0.5/Tt), d mu = -((gm / 2s^2) (2 (t - mu))) and d raw = (-(gm
// (1 / (2s^2)^2) (t - mu)^2) 2 (2s) + ((hm / (2 pi s^2)) 2 pi) (2s))
// exp(raw - softplus(raw)) with gm = g / Tt, hm = g 0.5 / Tt; both rounded
// to the compute dtype (the cotangent of the head output's cast to f32);
// then d feats = dout . w_head^T (rounded) [S, B, Tt, D] for ln_f's
// backward (KL's), and per slot d head.w [S, D, 2] = sum of z dout and d
// head.b [S, 2] = sum of dout over the slot's positions, accumulated in f32
// and rounded to the compute dtype, z the recomputed ln_f output.
//
// Bound on the H100: bytes; K rows of D values a scored row are read (at
// K=1 and transformer32, 16.8 MB of the 520 MB final residual stream).
// Design: one warp per row, the row's D values in registers (D / 32 a
// lane), LayerNorm statistics and the two dot products by shuffles.
#include "common.cuh"
#include "tile_sum.cuh"

namespace {

constexpr int kRowsPerBlock = 8;

struct KnArgs {
  // [T, D], [T, D], [T, D, 2] as stored (int8 scales hs [T, 1, 2]), [T, 2]
  const float* lnf_s; const float* lnf_b; const void* hw; const float* hs; const float* hb;
  const void* h;  // [T, B, Tt, D] in the compute dtype
  const float* targets; const int* n_valid;
  const int* later; const unsigned char* active; const int* counts; const unsigned char* mask;
  void* out; int out_kind;
  const float* eps; const float* mu_n; const float* sigma_n; float* samples; float* means;
  const float* ctx; float* ctx_next; int step; int HZ;
  int B; int Tt; int D; int K;
};

// The head's two outputs (mu, raw sigma), rounded to the compute dtype and
// widened, at the position of h whose D values start at `off` (slot t),
// and the position's ln_f output z (lane l holds columns l, l + 32, ...);
// every lane gets mu and raw.
template <bool BF16, int VPT, int WF>
__device__ __forceinline__ void head_raw(const float* lnf_s, const float* lnf_b, const void* hw,
                                         const float* hs, const float* hb, const void* h,
                                         long long off, int t, float& mu, float& raw,
                                         float (&z)[VPT]) {
  constexpr int D = 32 * VPT;
  const int lane = threadIdx.x & 31;
  float v[VPT];
#pragma unroll
  for (int c = 0; c < VPT; ++c) v[c] = load_val(h, BF16 ? KIND_BF16 : KIND_F32, off + lane + 32 * c);
  const float r = warp_ln_center<VPT>(v);
  const long long pd = static_cast<long long>(t) * D;
  float p0 = 0.0f, p1 = 0.0f;
#pragma unroll
  for (int c = 0; c < VPT; ++c) {
    const int d = lane + 32 * c;
    z[c] = rb<BF16>(ln_affine(v[c], r, lnf_s[pd + d], lnf_b[pd + d]));
    p0 = fmaf(z[c], wload<WF, BF16>(hw, hs, (pd + d) * 2, t * 2), p0);
    p1 = fmaf(z[c], wload<WF, BF16>(hw, hs, (pd + d) * 2 + 1, t * 2 + 1), p1);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    p0 += __shfl_xor_sync(0xffffffffu, p0, o);
    p1 += __shfl_xor_sync(0xffffffffu, p1, o);
  }
  mu = rb<BF16>(__fadd_rn(rb<BF16>(p0), rb<BF16>(hb[t * 2])));
  raw = rb<BF16>(__fadd_rn(rb<BF16>(p1), rb<BF16>(hb[t * 2 + 1])));
}

// (mu, sigma) of the head at position `p` of row `row` (slot t); every lane
// gets the result
template <bool BF16, int VPT, int WF>
__device__ __forceinline__ void head_at(const KnArgs& a, int t, long long row, int p, float& mu,
                                        float& sigma) {
  float z[VPT], raw;
  head_raw<BF16, VPT, WF>(a.lnf_s, a.lnf_b, a.hw, a.hs, a.hb, a.h,
                          (row * a.Tt + p) * (32 * VPT), t, mu, raw, z);
  sigma = gauss_sigma(raw);
}

template <bool BF16, int VPT, int WF>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
tf_head_kernel(const KnArgs a) {
  const int t = blockIdx.y;
  const int b = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (b >= a.B) return;
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(t) * a.B + b;
  float mu, sigma;
  if (a.eps != nullptr) {
    head_at<BF16, VPT, WF>(a, 0, b, a.Tt - 1, mu, sigma);
    const float x = __fadd_rn(mu, __fmul_rn(sigma, a.eps[b]));
    const int C = a.Tt;
    const float* src = a.ctx + static_cast<long long>(b) * C;
    float* dst = a.ctx_next + static_cast<long long>(b) * C;
    for (int c = lane; c < C; c += 32) dst[c] = c < C - 1 ? src[c + 1] : x;
    if (lane == 0) {
      const long long o = static_cast<long long>(b) * a.HZ + a.step;
      a.samples[o] = __fadd_rn(__fmul_rn(x, a.sigma_n[b]), a.mu_n[b]);
      a.means[o] = __fadd_rn(__fmul_rn(mu, a.sigma_n[b]), a.mu_n[b]);
    }
    return;
  }
  const int K = a.K;
  int first = 0, last = K - 1;
  if (a.later != nullptr) {
    const bool live = a.active[t] != 0 && row_valid(a.counts, a.mask, t, b, a.B);
    if (!live) {
      if (lane == 0) store_val(a.out, a.out_kind, row, 0.0f);
      return;
    }
    const int c = K - 1 - a.later[row];
    first = last = c < 0 ? 0 : (c > K - 1 ? K - 1 : c);
  }
  for (int j = first; j <= last; ++j) {
    head_at<BF16, VPT, WF>(a, t, row, a.Tt - K + j, mu, sigma);
    if (lane == 0) {
      const float nll = gaussian_nll(a.targets[row * K + j], mu, sigma);
      const float sc = (a.n_valid[row] - (K - 1 - j)) >= 4 ? nll : 0.0f;
      if (a.later != nullptr) {
        store_val(a.out, a.out_kind, row, sc);
      } else {
        static_cast<float*>(a.out)[row * K + j] = sc;
      }
    }
  }
}

template <bool BF16, int WF>
int launch_kn(const KnArgs& a, int T, cudaStream_t st) {
  const dim3 grid((a.B + kRowsPerBlock - 1) / kRowsPerBlock, T);
  const int threads = kRowsPerBlock * 32;
  switch (a.D) {
    case 32: tf_head_kernel<BF16, 1, WF><<<grid, threads, 0, st>>>(a); break;
    case 64: tf_head_kernel<BF16, 2, WF><<<grid, threads, 0, st>>>(a); break;
    case 128: tf_head_kernel<BF16, 4, WF><<<grid, threads, 0, st>>>(a); break;
    case 256: tf_head_kernel<BF16, 8, WF><<<grid, threads, 0, st>>>(a); break;
    case 512: tf_head_kernel<BF16, 16, WF><<<grid, threads, 0, st>>>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// hw: the head weight as stored in format wf (WF_F32, WF_BF16, WF_I8; hs
// its int8 scales, else null).
extern "C" int sw_tf_head(const float* lnf_s, const float* lnf_b, const void* hw, const float* hs,
                          int wf, const float* hb, const void* h, const float* targets, const int* n_valid,
                          const int* later, const unsigned char* active, const int* counts,
                          const unsigned char* mask, void* out, int out_kind, const float* eps,
                          const float* mu_n, const float* sigma_n, float* samples, float* means,
                          const float* ctx, float* ctx_next, int step, int HZ, int T, int B,
                          int Tt, int D, int K, int kind, void* stream) {
  if (T == 0 || B == 0) return static_cast<int>(cudaGetLastError());
  if (Tt < 1 || K < 1 || K > Tt || (kind != KIND_F32 && kind != KIND_BF16) ||
      (wf == WF_I8) != (hs != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (eps != nullptr && (T != 1 || step < 0 || step >= HZ))
    return static_cast<int>(cudaErrorInvalidValue);
  KnArgs a{lnf_s, lnf_b, hw, hs, hb, h, targets, n_valid, later, active, counts, mask, out,
           out_kind, eps, mu_n, sigma_n, samples, means, ctx, ctx_next, step, HZ, B, Tt, D, K};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_format(wf, [&](auto f) {
    return by_bf16(kind == KIND_BF16, [&](auto b) {
      return launch_kn<decltype(b)::value, decltype(f)::value>(a, T, st);
    });
  });
}

// -- train mode ------------------------------------------------------------------

namespace {

constexpr int kTrainTileRows = 64;  // rows of one slot per backward block

struct KnTrainArgs {
  const float* lnf_s; const float* lnf_b; const float* hw; const float* hb;
  const void* h;          // [T, B, Tt, D] compute dtype
  const float* normed;    // [T, B, W]
  float* out;             // [T, B, Tt, 2] f32 (mu, raw)
  float* per_row;         // [T, B]
  const float* g_row;     // [T, B]
  void* dfeats;           // [T, B, Tt, D] compute dtype
  float* part;            // [T, tiles, 2 D + 32]
  int B; int Tt; int D; int W;
};

template <bool BF16, int VPT>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
tf_head_train_fwd(const KnTrainArgs a) {
  const int t = blockIdx.y;
  const int b = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (b >= a.B) return;
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(t) * a.B + b;
  const float inv_t = 1.0f / static_cast<float>(a.Tt);
  float sum = 0.0f;
  for (int p = 0; p < a.Tt; ++p) {
    float z[VPT], mu, raw;
    head_raw<BF16, VPT, WF_F32>(a.lnf_s, a.lnf_b, a.hw, nullptr, a.hb, a.h,
                                (row * a.Tt + p) * (32 * VPT), t, mu, raw, z);
    if (lane == 0) {
      a.out[(row * a.Tt + p) * 2] = mu;
      a.out[(row * a.Tt + p) * 2 + 1] = raw;
      sum = __fadd_rn(sum, gaussian_nll(a.normed[row * a.W + p + 1], mu, gauss_sigma(raw)));
    }
  }
  if (lane == 0) a.per_row[row] = __fmul_rn(sum, inv_t);
}

template <bool BF16, int VPT>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
tf_head_train_bwd(const KnTrainArgs a) {
  constexpr int D = 32 * VPT;
  __shared__ float buf[D];
  const int kind = BF16 ? KIND_BF16 : KIND_F32;
  const int t = blockIdx.y, tiles = gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float inv_t = 1.0f / static_cast<float>(a.Tt);
  const float half_inv_t = 0.5f / static_cast<float>(a.Tt);
  const float two_pi = 6.2831855f;
  const long long pd = static_cast<long long>(t) * D;
  float w0[VPT], w1[VPT], g0[VPT], g1[VPT];
#pragma unroll
  for (int c = 0; c < VPT; ++c) {
    const int d = lane + 32 * c;
    w0[c] = rb<BF16>(a.hw[(pd + d) * 2]);
    w1[c] = rb<BF16>(a.hw[(pd + d) * 2 + 1]);
    g0[c] = g1[c] = 0.0f;
  }
  float gb[1] = {0.0f};  // lane 0: d head.b[0], lane 1: d head.b[1]
  const int b0 = blockIdx.x * kTrainTileRows;
  const int b1 = b0 + kTrainTileRows < a.B ? b0 + kTrainTileRows : a.B;
  for (int b = b0 + warp; b < b1; b += kRowsPerBlock) {
    const long long row = static_cast<long long>(t) * a.B + b;
    const float g = a.g_row[row];
    const float gm = __fmul_rn(g, inv_t);
    const float hm = __fmul_rn(g, half_inv_t);
    for (int p = 0; p < a.Tt; ++p) {
      const long long pos = row * a.Tt + p;
      float z[VPT], mu, raw;
      head_raw<BF16, VPT, WF_F32>(a.lnf_s, a.lnf_b, a.hw, nullptr, a.hb, a.h, pos * D, t, mu, raw,
                                  z);
      const float sp = __fadd_rn(fmaxf(raw, 0.0f), log1pf(expf(-fabsf(raw))));
      const float s = __fadd_rn(sp, 1e-4f);
      const float dt = __fsub_rn(a.normed[row * a.W + p + 1], mu);
      const float s2 = __fmul_rn(s, s);
      const float two_s2 = __fmul_rn(s2, 2.0f);
      const float two_s = __fmul_rn(s, 2.0f);
      const float dmu = -__fmul_rn(__fdiv_rn(gm, two_s2), __fmul_rn(dt, 2.0f));
      const float t1 = __fmul_rn(
          __fmul_rn(-__fmul_rn(__fmul_rn(gm, __fdiv_rn(1.0f, __fmul_rn(two_s2, two_s2))),
                               __fmul_rn(dt, dt)),
                    2.0f),
          two_s);
      const float t2 = __fmul_rn(__fmul_rn(__fdiv_rn(hm, __fmul_rn(s2, two_pi)), two_pi), two_s);
      const float draw = __fmul_rn(__fadd_rn(t1, t2), expf(__fsub_rn(raw, sp)));
      const float d0 = rb<BF16>(dmu), d1 = rb<BF16>(draw);
#pragma unroll
      for (int c = 0; c < VPT; ++c) {
        const float df = __fadd_rn(__fmul_rn(d0, w0[c]), __fmul_rn(d1, w1[c]));
        store_val(a.dfeats, kind, pos * D + lane + 32 * c, df);
        g0[c] = __fadd_rn(g0[c], __fmul_rn(z[c], d0));
        g1[c] = __fadd_rn(g1[c], __fmul_rn(z[c], d1));
      }
      if (lane < 2) gb[0] = __fadd_rn(gb[0], lane == 0 ? d0 : d1);
    }
  }
  float* dst = a.part + (static_cast<long long>(t) * tiles + blockIdx.x) * (2 * D + 32);
  block_column_sums<VPT, kRowsPerBlock>(g0, buf, dst);
  block_column_sums<VPT, kRowsPerBlock>(g1, buf, dst + D);
  block_column_sums<1, kRowsPerBlock>(gb, buf, dst + 2 * D);
}

template <bool BF16, int VPT>
int launch_kn_train(const KnTrainArgs& a, int mode, float* red, int T, cudaStream_t st) {
  if (mode == 0) {
    const dim3 grid((a.B + kRowsPerBlock - 1) / kRowsPerBlock, T);
    tf_head_train_fwd<BF16, VPT><<<grid, kRowsPerBlock * 32, 0, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  const int tiles = (a.B + kTrainTileRows - 1) / kTrainTileRows;
  tf_head_train_bwd<BF16, VPT><<<dim3(tiles, T), kRowsPerBlock * 32, 0, st>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_tile_sum(a.part, red, T, tiles, 2 * a.D + 32, BF16, st);
}

template <bool BF16>
int by_width_kn_train(const KnTrainArgs& a, int mode, float* red, int T, cudaStream_t st) {
  switch (a.D) {
    case 32: return launch_kn_train<BF16, 1>(a, mode, red, T, st);
    case 64: return launch_kn_train<BF16, 2>(a, mode, red, T, st);
    case 128: return launch_kn_train<BF16, 4>(a, mode, red, T, st);
    case 256: return launch_kn_train<BF16, 8>(a, mode, red, T, st);
    case 512: return launch_kn_train<BF16, 16>(a, mode, red, T, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// mode 0 (forward): h [T, B, Tt, D] (kind), normed f32[T, B, W] (W >=
// Tt + 1) -> out f32[T, B, Tt, 2], per_row f32[T, B]. mode 1 (backward):
// also g_row f32[T, B] -> dfeats [T, B, Tt, D] (kind) and red f32[T, 2 D +
// 32] = [d head.w column 0 (D) | column 1 (D) | d head.b (2) | 30 zeros],
// through part f32[T, ceil(B / 64), 2 D + 32] scratch.
extern "C" int sw_tf_head_train(int mode, const float* lnf_s, const float* lnf_b, const float* hw,
                                const float* hb, const void* h, const float* normed, float* out,
                                float* per_row, const float* g_row, void* dfeats, float* part,
                                float* red, int T, int B, int Tt, int D, int W, int kind,
                                void* stream) {
  if (T == 0 || B == 0) return static_cast<int>(cudaGetLastError());
  if (T < 0 || T > 65535 || B < 0 || Tt < 1 || W < Tt + 1 || (mode != 0 && mode != 1) ||
      (kind != KIND_F32 && kind != KIND_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  KnTrainArgs a{lnf_s, lnf_b, hw, hb, h, normed, out, per_row, g_row, dfeats, part, B, Tt, D, W};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return kind == KIND_BF16 ? by_width_kn_train<true>(a, mode, red, T, st)
                           : by_width_kn_train<false>(a, mode, red, T, st);
}
