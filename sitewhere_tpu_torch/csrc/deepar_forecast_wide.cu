// KF deepar_forecast, wide form: DeepAR's ancestral-sampling forecast at
// any hidden and any number of sample paths.
//
// Replaces sitewhere_tpu/models/deepar.py:206 forecast (with _encode :84,
// _gru_step :58, _emit :75) at the shapes the one-block KF
// (deepar_forecast.cu) does not take: hidden outside 8/16/32/64 (GluonTS
// DeepAREstimator's num_cells=40) and more paths than one block's shared
// memory holds (its num_parallel_samples=100 default at hidden 64 still
// fits there; 256 does not; models/deepar.py kf_route). The arithmetic is
// the one-block form's: normalize the context, encode it with the GRU,
// start every path from the encoded h and the last normalized value, run
// `horizon` steps of GRU -> (mu, sigma) -> x = mu + sigma * eps in f32
// (the path records the f32 value, the next step reads it cast to the
// compute dtype), un-normalize, and take the mean over samples. eps
// f32[horizon, NS * B] is an input, path index s * B + b.
//
// Bound on the H100: latency, a chain of context + horizon dependent GRU
// steps (192 at context 168, horizon 24); the FLOP bound is microseconds.
// Design: a series' paths split over blocks of R paths (grid B x
// ceil(NS / R)); each block encodes its series' context itself (one row
// group of the wide step, scan_wide.cuh; the context is short beside the
// paths' work), copies h to its paths and steps them together, writing
// each sample straight to global memory. A second kernel takes the mean
// over all NS paths of each (series, step), summed in path order. The
// block state (hT, the heads' weights) sits in shared memory (the wide
// form, hidden up to 2,233) or, in the global form
// (sw_deepar_forecast_global), in a global scratch: the same kernel, any
// hidden.
// Weights: the f32 masters, as the reference's forecast reads them.
#include "scan_wide.cuh"

namespace {

using wide::kTR;

struct KfwArgs {
  const float* wx_w; const float* wx_b; const float* wh_w; const float* wh_b;
  const float* mu_w; const float* mu_b; const float* sg_w; const float* sg_b;
  const float* windows;  // f32[B, C]
  const float* eps;      // f32[HZ, NS * B]
  float* samples;        // f32[NS, B, HZ]
  int B; int C; int NS; int HZ; int H; int R;
  int pblocks; long long blk0;  // path blocks a series; this wave's first block
  float* state; long long stride;  // the global form's scratch, floats a block
};

// Floats of a block's state: hT [2][H][RS], the mu and sigma heads [H] each.
inline long long kfw_state_floats(int H, int R) {
  return 2LL * H * (R + 4) + 2LL * H;
}

template <bool BF16, bool GS>
__global__ void __launch_bounds__(wide::kMaxThreads)
deepar_forecast_wide_kernel(const KfwArgs a) {
  const int H = a.H, R = a.R, RS = R + 4, C = a.C, NS = a.NS, HZ = a.HZ, B = a.B;
  const long long blk = a.blk0 + blockIdx.x;
  const int b = static_cast<int>(blk / a.pblocks);
  const int p0 = static_cast<int>(blk % a.pblocks) * R;
  const int np = NS - p0 < R ? NS - p0 : R;  // this block's paths
  const int tid = threadIdx.x, nth = blockDim.x;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  wide::RowSrc* ctx = reinterpret_cast<wide::RowSrc*>(smem_raw);  // [2]: the context (one used)
  float* xb = reinterpret_cast<float*>(ctx + 2);  // [2][R] each path's input x
  float* hT = wide::block_state<GS>(xb + 2 * R, a.state, a.stride);  // [2][H][RS]
  float* mw = hT + 2 * H * RS;                    // [H]
  float* sw = mw + H;                             // [H]

  for (int e = tid; e < 2 * H * RS; e += nth) hT[e] = 0.0f;
  for (int e = tid; e < 2 * R; e += nth) xb[e] = 0.0f;
  for (int u = tid; u < H; u += nth) {
    mw[u] = rb<BF16>(a.mu_w[u]);
    sw[u] = rb<BF16>(a.sg_w[u]);
  }
  const float mb = rb<BF16>(a.mu_b[0]);
  const float sb = rb<BF16>(a.sg_b[0]);
  __syncthreads();
  if (tid == 0) {
    wide::RowSrc src{a.windows + static_cast<long long>(b) * C, 0, 0, 0.0f, 0.0f, 1.0f};
    wide::row_stats(src, C);
    ctx[0] = src;
    xb[0] = wide::normed_at(src, C, 0);
  }
  __syncthreads();

  // encode the context: one row group, row 0 the series (rows 1..7 idle)
  for (int c = 0; c < C; ++c) {
    const float* hc = hT + (c & 1) * H * RS;
    float* hn = hT + ((c + 1) & 1) * H * RS;
    for (int u = tid; u < H; u += nth) {
      wide::gru_item<WF_F32, BF16>(a.wx_w, nullptr, a.wx_b, a.wh_w, nullptr, a.wh_b, u, 0, H,
                                   u, 0, RS, hc, xb + (c & 1) * R, hn);
    }
    if (tid == 0 && c + 1 < C) xb[((c + 1) & 1) * R] = wide::normed_at(ctx[0], C, c + 1);
    __syncthreads();
  }
  // every path starts from the encoded h and the last normalized value
  int cur = C & 1;
  float* hx = hT + cur * H * RS;
  for (int e = tid; e < H * R; e += nth) {
    const int u = e / R, r = e % R;
    if (r > 0) hx[u * RS + r] = hx[u * RS];
  }
  const float x_last = rb<BF16>(wide::normed_at(ctx[0], C, C - 1));
  for (int r = tid; r < R; r += nth) xb[cur * R + r] = x_last;
  const float mu_n = ctx[0].mu, sigma_n = ctx[0].sigma;
  __syncthreads();

  const int items = H * ((np + kTR - 1) / kTR);
  const int warp = tid >> 5, lane = tid & 31, nwarps = nth >> 5;
  const long long paths = static_cast<long long>(NS) * B;
  for (int t = 0; t < HZ; ++t) {
    const float* hc = hT + cur * H * RS;
    float* hn = hT + (cur ^ 1) * H * RS;
    for (int i = tid; i < items; i += nth) {
      const int u = i % H, r0 = (i / H) * kTR;
      wide::gru_item<WF_F32, BF16>(a.wx_w, nullptr, a.wx_b, a.wh_w, nullptr, a.wh_b, u, 0, H,
                                   u, r0, RS, hc, xb + cur * R, hn);
    }
    __syncthreads();
    // heads, then one draw per path
    for (int r = warp; r < np; r += nwarps) {
      float pm = 0.0f, ps = 0.0f;
      for (int u = lane; u < H; u += 32) {
        const float hv = hn[u * RS + r];
        pm = fmaf(hv, mw[u], pm);
        ps = fmaf(hv, sw[u], ps);
      }
      pm = warp_sum(pm);
      ps = warp_sum(ps);
      if (lane == 0) {
        const float mu = rb<BF16>(__fadd_rn(rb<BF16>(pm), mb));
        const float sigma = gauss_sigma(rb<BF16>(__fadd_rn(rb<BF16>(ps), sb)));
        const long long path = static_cast<long long>(p0 + r) * B + b;
        const float xn = __fadd_rn(mu, __fmul_rn(sigma, a.eps[t * paths + path]));
        a.samples[path * HZ + t] = __fadd_rn(__fmul_rn(xn, sigma_n), mu_n);
        xb[(cur ^ 1) * R + r] = rb<BF16>(xn);
      }
    }
    __syncthreads();
    cur ^= 1;
  }
}

// mean[b, t] = sum over paths s (in order) of samples[s, b, t] / NS
__global__ void kf_mean_kernel(const float* __restrict__ samples, float* __restrict__ mean, int B,
                               int NS, int HZ) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(B) * HZ) return;
  const long long stride = static_cast<long long>(B) * HZ;
  float sum = 0.0f;
  for (int s = 0; s < NS; ++s) sum += samples[s * stride + i];
  mean[i] = sum / static_cast<float>(NS);
}

template <bool BF16, bool GS>
int launch_kfw(KfwArgs a, float* mean, long long wave, cudaStream_t stream) {
  const int R = a.R, H = a.H;
  const size_t small = 2 * sizeof(wide::RowSrc) + 2 * R * sizeof(float);
  const size_t smem = small + (GS ? 0 : kfw_state_floats(H, R) * sizeof(float));
  int err = wide::prepare<GS>(deepar_forecast_wide_kernel<BF16, GS>, smem);
  if (err != 0) return err;
  a.pblocks = (a.NS + R - 1) / R;
  a.stride = wide::state_stride(kfw_state_floats(H, R));
  const long long blocks = static_cast<long long>(a.B) * a.pblocks;
  err = wide::in_waves(blocks, GS ? wave : blocks, [&](long long blk0, unsigned n) {
    a.blk0 = blk0;
    deepar_forecast_wide_kernel<BF16, GS>
        <<<n, wide::threads_for(H * (R / kTR)), smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  });
  if (err != 0) return err;
  const long long n = static_cast<long long>(a.B) * a.HZ;
  kf_mean_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(a.samples, mean, a.B,
                                                                             a.NS, a.HZ);
  return static_cast<int>(cudaGetLastError());
}

template <bool GS>
int kfw_entry(const float* wx_w, const float* wx_b, const float* wh_w, const float* wh_b,
              const float* mu_w, const float* mu_b, const float* sg_w, const float* sg_b,
              const float* windows, const float* eps, float* samples, float* mean, int B, int C,
              int NS, int HZ, int H, int bf16, int R, float* state, long long wave,
              void* stream) {
  if (B == 0) return static_cast<int>(cudaGetLastError());
  if (C < 1 || NS < 1 || HZ < 1 || H < 1 || R < kTR || R % kTR != 0 ||
      (GS && (state == nullptr || wave < 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  KfwArgs a{wx_w, wx_b, wh_w, wh_b, mu_w, mu_b, sg_w, sg_b, windows, eps, samples, B, C, NS, HZ,
            H, R, 0, 0, state, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_bf16(bf16, [&](auto bf) {
    return launch_kfw<decltype(bf)::value, GS>(a, mean, wave, st);
  });
}

}  // namespace

// As sw_deepar_forecast (deepar_forecast.cu), any H >= 1 and NS >= 1, plus
// R: paths a block (a multiple of 8; models/deepar.py kf_route picks it).
// The block state in shared memory.
extern "C" int sw_deepar_forecast_wide(const float* wx_w, const float* wx_b, const float* wh_w,
                                       const float* wh_b, const float* mu_w, const float* mu_b,
                                       const float* sg_w, const float* sg_b,
                                       const float* windows, const float* eps, float* samples,
                                       float* mean, int B, int C, int NS, int HZ, int H, int bf16,
                                       int R, void* stream) {
  return kfw_entry<false>(wx_w, wx_b, wh_w, wh_b, mu_w, mu_b, sg_w, sg_b, windows, eps, samples,
                          mean, B, C, NS, HZ, H, bf16, R, nullptr, 0, stream);
}

// The global form: as sw_deepar_forecast_wide, the block state in `state`,
// a scratch of min(blocks, wave) x stride floats (models/flush.py
// scan_state_floats, state_stride; blocks = B x ceil(NS / R)), in waves of
// at most `wave`.
extern "C" int sw_deepar_forecast_global(const float* wx_w, const float* wx_b,
                                         const float* wh_w, const float* wh_b,
                                         const float* mu_w, const float* mu_b,
                                         const float* sg_w, const float* sg_b,
                                         const float* windows, const float* eps, float* samples,
                                         float* mean, int B, int C, int NS, int HZ, int H,
                                         int bf16, int R, float* state, long long wave,
                                         void* stream) {
  return kfw_entry<true>(wx_w, wx_b, wh_w, wh_b, mu_w, mu_b, sg_w, sg_b, windows, eps, samples,
                         mean, B, C, NS, HZ, H, bf16, R, state, wave, stream);
}
