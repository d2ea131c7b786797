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
// Modes: score (windows mode: all K columns f32[T, B, K]; flush mode,
// `later` set: one column a row, masked and cast, [T, B]) and forecast
// (`eps` set, one slot, one launch per horizon step: writes column `step`
// of samples and means f32[B, HZ] in raw units and ctx[:, 1:] ++ x into
// ctx_next f32[B, C]).
//
// Bound on the H100: bytes; K rows of D values a scored row are read (at
// K=1 and transformer32, 16.8 MB of the 520 MB final residual stream).
// Design: one warp per row, the row's D values in registers (D / 32 a
// lane), LayerNorm statistics and the two dot products by shuffles.
#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 8;

struct KnArgs {
  const float* lnf_s; const float* lnf_b; const float* hw; const float* hb;  // [T,D],[T,D],[T,D,2],[T,2]
  const void* h;  // [T, B, Tt, D] in the compute dtype
  const float* targets; const int* n_valid;
  const int* later; const unsigned char* active; const int* counts; const unsigned char* mask;
  void* out; int out_kind;
  const float* eps; const float* mu_n; const float* sigma_n; float* samples; float* means;
  const float* ctx; float* ctx_next; int step; int HZ;
  int B; int Tt; int D; int K;
};

// (mu, sigma) of the head at position `p` of row `row` (slot t); every lane
// gets the result
template <bool BF16, int VPT>
__device__ __forceinline__ void head_at(const KnArgs& a, int t, long long row, int p, float& mu,
                                        float& sigma) {
  constexpr int D = 32 * VPT;
  const int lane = threadIdx.x & 31;
  const long long off = (row * a.Tt + p) * D;
  float v[VPT];
#pragma unroll
  for (int c = 0; c < VPT; ++c) v[c] = load_val(a.h, BF16 ? KIND_BF16 : KIND_F32, off + lane + 32 * c);
  const float r = warp_ln_center<VPT>(v);
  const long long pd = static_cast<long long>(t) * D;
  float p0 = 0.0f, p1 = 0.0f;
#pragma unroll
  for (int c = 0; c < VPT; ++c) {
    const int d = lane + 32 * c;
    const float z = rb<BF16>(ln_affine(v[c], r, a.lnf_s[pd + d], a.lnf_b[pd + d]));
    p0 = fmaf(z, rb<BF16>(a.hw[(pd + d) * 2]), p0);
    p1 = fmaf(z, rb<BF16>(a.hw[(pd + d) * 2 + 1]), p1);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    p0 += __shfl_xor_sync(0xffffffffu, p0, o);
    p1 += __shfl_xor_sync(0xffffffffu, p1, o);
  }
  mu = rb<BF16>(__fadd_rn(rb<BF16>(p0), rb<BF16>(a.hb[t * 2])));
  sigma = gauss_sigma(rb<BF16>(__fadd_rn(rb<BF16>(p1), rb<BF16>(a.hb[t * 2 + 1]))));
}

template <bool BF16, int VPT>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
tf_head_kernel(const KnArgs a) {
  const int t = blockIdx.y;
  const int b = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (b >= a.B) return;
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(t) * a.B + b;
  float mu, sigma;
  if (a.eps != nullptr) {
    head_at<BF16, VPT>(a, 0, b, a.Tt - 1, mu, sigma);
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
    head_at<BF16, VPT>(a, t, row, a.Tt - K + j, mu, sigma);
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

template <bool BF16>
int launch_kn(const KnArgs& a, int T, cudaStream_t st) {
  const dim3 grid((a.B + kRowsPerBlock - 1) / kRowsPerBlock, T);
  const int threads = kRowsPerBlock * 32;
  switch (a.D) {
    case 32: tf_head_kernel<BF16, 1><<<grid, threads, 0, st>>>(a); break;
    case 64: tf_head_kernel<BF16, 2><<<grid, threads, 0, st>>>(a); break;
    case 128: tf_head_kernel<BF16, 4><<<grid, threads, 0, st>>>(a); break;
    case 256: tf_head_kernel<BF16, 8><<<grid, threads, 0, st>>>(a); break;
    case 512: tf_head_kernel<BF16, 16><<<grid, threads, 0, st>>>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sw_tf_head(const float* lnf_s, const float* lnf_b, const float* hw, const float* hb,
                          const void* h, const float* targets, const int* n_valid,
                          const int* later, const unsigned char* active, const int* counts,
                          const unsigned char* mask, void* out, int out_kind, const float* eps,
                          const float* mu_n, const float* sigma_n, float* samples, float* means,
                          const float* ctx, float* ctx_next, int step, int HZ, int T, int B,
                          int Tt, int D, int K, int kind, void* stream) {
  if (T == 0 || B == 0) return static_cast<int>(cudaGetLastError());
  if (Tt < 1 || K < 1 || K > Tt || (kind != KIND_F32 && kind != KIND_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (eps != nullptr && (T != 1 || step < 0 || step >= HZ))
    return static_cast<int>(cudaErrorInvalidValue);
  KnArgs a{lnf_s, lnf_b, hw, hb, h, targets, n_valid, later, active, counts, mask, out, out_kind,
           eps, mu_n, sigma_n, samples, means, ctx, ctx_next, step, HZ, B, Tt, D, K};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return kind == KIND_BF16 ? launch_kn<true>(a, T, st) : launch_kn<false>(a, T, st);
}
