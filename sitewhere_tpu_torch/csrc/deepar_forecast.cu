// KF deepar_forecast: DeepAR ancestral-sampling forecast, one launch.
//
// Replaces sitewhere_tpu/models/deepar.py:206 forecast (with _encode :84,
// _gru_step :58 and _emit :75): normalize each context window; encode it
// with the GRU; start num_samples paths per series from the encoded h and
// the last normalized value; run `horizon` steps of GRU -> (mu, sigma)
// heads -> x = mu + sigma * eps in f32, the path recording the f32 value
// and the next step reading it cast to the compute dtype; un-normalize
// (path * sigma_n + mu_n); take the mean over samples. The noise eps
// f32[horizon, num_samples * B] is an input (path index s * B + b, as the
// reference lays its paths out), so the kernel and its plain version can
// be held together on the same draws. Rounding points are the GRU's of
// gru.cuh with the bf16 compute dtype; nothing rounds with f32.
//
// Bound on the H100: neither bytes nor operations. The work is a chain of
// context + horizon dependent GRU steps (152 at deepar_replay: context 128,
// horizon 24), each a [rows, H] x [H, 3H] product, so latency sets the
// pace; the card's FLOP bound at deepar_replay (~5.4 GFLOP) is ~5 us.
// Design: one block per series, 3H threads, thread j owning gate column j of
// wh in registers. The block encodes its series once (one row), copies h to
// its num_samples paths, then steps all paths together (rows of the tile)
// so the context is encoded once instead of num_samples times. h, the gate
// sums, the n parts, the carried x and the un-normalized paths live in
// shared memory; samples and the mean are written once at the end.
//
// Widths: one instantiation for each H of 8, 16, 32 and 64, the 3H gate
// columns padded to whole warps as in KD (gru_score.cu). The weights are
// the f32 masters: the reference's forecast reads params[...]["w"]
// (deepar.py:58-61, :74-77), so it has no bf16 or int8 form to port.
#include "gru.cuh"

namespace {

struct KfArgs {
  const float* wx_w; const float* wx_b; const float* wh_w; const float* wh_b;
  const float* mu_w; const float* mu_b; const float* sg_w; const float* sg_b;
  const float* windows;  // f32[B, C]
  const float* eps;      // f32[HZ, NS * B]
  float* samples;        // f32[NS, B, HZ]
  float* mean;           // f32[B, HZ]
  int B; int C; int NS; int HZ;
};

// gate pre-activations of `rows` rows of h (row stride H) with inputs x
// (row r reads x[r * xstride]) into gates [rows][3H] and nxs [rows][H]
template <int H, bool BF16>
__device__ __forceinline__ void gate_phase(const float* hs, const float* x, int xstride,
                                           int rows, const float (&wcol)[H], float wxj,
                                           float bxj, float bhj, float* gates, float* nxs) {
  constexpr int NT = 3 * H;
  constexpr int NTP = whole_warps(NT);
  const int j = threadIdx.x;
  if (NTP != NT && j >= NT) return;  // a padding thread of the last warp
  for (int r = 0; r < rows; ++r) {
    const float4* hr = reinterpret_cast<const float4*>(hs + r * H);
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll
    for (int q = 0; q < H / 4; ++q) {
      const float4 v = hr[q];
      a0 = fmaf(v.x, wcol[4 * q], a0);
      a1 = fmaf(v.y, wcol[4 * q + 1], a1);
      a2 = fmaf(v.z, wcol[4 * q + 2], a2);
      a3 = fmaf(v.w, wcol[4 * q + 3], a3);
    }
    const float gh = gru_gh<BF16>((a0 + a1) + (a2 + a3), bhj);
    const float gx = gru_gx<BF16>(x[r * xstride], wxj, bxj);
    if (j < 2 * H) {
      gates[r * NT + j] = rb<BF16>(__fadd_rn(gx, gh));
    } else {
      gates[r * NT + j] = gh;
      nxs[r * H + (j - 2 * H)] = gx;
    }
  }
}

template <int H, bool BF16>
__device__ __forceinline__ void cell_phase(float* hs, const float* gates, const float* nxs,
                                           int rows) {
  constexpr int NT = 3 * H, NTP = whole_warps(NT);
  for (int e = threadIdx.x; e < rows * H; e += NTP) {
    const int r = e / H, u = e % H;
    const float* gr = gates + r * NT;
    hs[e] = gru_cell<BF16>(gr[u], gr[H + u], nxs[e], gr[2 * H + u], hs[e]);
  }
}

template <int H, bool BF16>
__global__ void __launch_bounds__(whole_warps(3 * H))
deepar_forecast_kernel(const KfArgs a) {
  constexpr int NT = 3 * H;             // gate columns
  constexpr int NTP = whole_warps(NT);  // threads: the columns in whole warps
  constexpr int NW = NTP / 32;
  using HL = HeadLanes<H>;              // the heads' lanes: L a path, RPW paths a warp
  static_assert(H % 8 == 0, "tile shape");
  const int NS = a.NS, C = a.C, HZ = a.HZ, B = a.B;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;

  extern __shared__ float smem[];
  float* hs = smem;                 // [NS][H] hidden state per path (row 0 encodes)
  float* gates = hs + NS * H;       // [NS][3H]: rx+rh, zx+zh, nh
  float* nxs = gates + NS * NT;     // [NS][H]: nx
  float* xs = nxs + NS * H;         // [C] the normalized context
  float* xp = xs + C;               // [NS] each path's carried x
  float* rawp = xp + NS;            // [NS][HZ] un-normalized paths
  float* stat = rawp + NS * HZ;     // mu_n, sigma_n

  for (int c = tid; c < C; c += NTP) xs[c] = a.windows[static_cast<long long>(b) * C + c];
  for (int e = tid; e < H; e += NTP) hs[e] = 0.0f;
  __syncthreads();
  if (tid == 0) normalize_row(xs, C, stat[0], stat[1]);

  const int j = NTP == NT || tid < NT ? tid : NT - 1;  // padding threads: column NT-1, no writes
  float wcol[H];
#pragma unroll
  for (int k = 0; k < H; ++k) wcol[k] = rb<BF16>(a.wh_w[k * NT + j]);
  const float wxj = rb<BF16>(a.wx_w[j]);
  const float bxj = rb<BF16>(a.wx_b[j]);
  const float bhj = rb<BF16>(a.wh_b[j]);
  const int warp = tid >> 5, lane = tid & 31;
  const int ul = lane % HL::L;  // this lane's first head unit
  float mw[HL::HQ], sw[HL::HQ];
#pragma unroll
  for (int q = 0; q < HL::HQ; ++q) {
    mw[q] = rb<BF16>(a.mu_w[ul + 32 * q]);
    sw[q] = rb<BF16>(a.sg_w[ul + 32 * q]);
  }
  const float mb = rb<BF16>(a.mu_b[0]);
  const float sb = rb<BF16>(a.sg_b[0]);
  __syncthreads();

  // encode the context: one row
  for (int c = 0; c < C; ++c) {
    gate_phase<H, BF16>(hs, xs + c, 0, 1, wcol, wxj, bxj, bhj, gates, nxs);
    __syncthreads();
    cell_phase<H, BF16>(hs, gates, nxs, 1);
    __syncthreads();
  }
  // every path starts from the encoded h and the last normalized value
  for (int e = H + tid; e < NS * H; e += NTP) hs[e] = hs[e % H];
  for (int r = tid; r < NS; r += NTP) xp[r] = rb<BF16>(xs[C - 1]);
  __syncthreads();
  const float mu_n = stat[0], sigma_n = stat[1];
  const long long paths = static_cast<long long>(NS) * B;

  for (int t = 0; t < HZ; ++t) {
    gate_phase<H, BF16>(hs, xp, 1, NS, wcol, wxj, bxj, bhj, gates, nxs);
    __syncthreads();
    cell_phase<H, BF16>(hs, gates, nxs, NS);
    __syncthreads();
    // heads, then one draw per path
    for (int r0 = warp * HL::RPW; r0 < NS; r0 += NW * HL::RPW) {
      const int r = r0 + lane / HL::L;  // this lane's path
      const bool in = HL::RPW == 1 || r < NS;
      float pm = 0.0f, ps = 0.0f;
      if (in) {
#pragma unroll
        for (int q = 0; q < HL::HQ; ++q) {
          const float hv = hs[r * H + ul + 32 * q];
          pm = fmaf(hv, mw[q], pm);
          ps = fmaf(hv, sw[q], ps);
        }
      }
      group_sum2<HL::L>(pm, ps);
      if (ul == 0 && in) {
        const float mu = rb<BF16>(__fadd_rn(rb<BF16>(pm), mb));
        const float sigma = gauss_sigma(rb<BF16>(__fadd_rn(rb<BF16>(ps), sb)));
        const float e = a.eps[t * paths + static_cast<long long>(r) * B + b];
        const float xn = __fadd_rn(mu, __fmul_rn(sigma, e));
        rawp[r * HZ + t] = __fadd_rn(__fmul_rn(xn, sigma_n), mu_n);
        xp[r] = rb<BF16>(xn);
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < NS * HZ; e += NTP) {
    const int r = e / HZ, t = e % HZ;
    a.samples[(static_cast<long long>(r) * B + b) * HZ + t] = rawp[e];
  }
  for (int t = tid; t < HZ; t += NTP) {
    float sum = 0.0f;
    for (int r = 0; r < NS; ++r) sum += rawp[r * HZ + t];
    a.mean[static_cast<long long>(b) * HZ + t] = sum / static_cast<float>(NS);
  }
}

template <int H, bool BF16>
int launch_kf(const KfArgs& a, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(a.NS) * (H + 3 * H + H + 1 + a.HZ) + a.C + 2) *
                      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(deepar_forecast_kernel<H, BF16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  deepar_forecast_kernel<H, BF16><<<a.B, whole_warps(3 * H), smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sw_deepar_forecast(const float* wx_w, const float* wx_b, const float* wh_w,
                                  const float* wh_b, const float* mu_w, const float* mu_b,
                                  const float* sg_w, const float* sg_b, const float* windows,
                                  const float* eps, float* samples, float* mean, int B, int C,
                                  int NS, int HZ, int H, int bf16, void* stream) {
  if (B == 0) return static_cast<int>(cudaGetLastError());
  if (C < 1 || NS < 1 || HZ < 1) return static_cast<int>(cudaErrorInvalidValue);
  KfArgs a{wx_w, wx_b, wh_w, wh_b, mu_w, mu_b, sg_w, sg_b, windows, eps, samples, mean,
           B, C, NS, HZ};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_bf16(bf16, [&](auto bf) {
    return by_hidden(H, [&](auto h) {
      return launch_kf<decltype(h)::value, decltype(bf)::value>(a, st);
    });
  });
}
