// KD gru_score: window gather + normalization + stacked GRU scan + the
// DeepAR (mu, sigma) heads + Gaussian NLL + per-row column select, mask and
// wire cast, fused in one kernel.
//
// Replaces, as one kernel, what the JAX package's fused step runs between
// the ring update and the sketch for the DeepAR family:
//   K2 sitewhere_tpu/ops/windows.py:143 gather_windows (ring mode only),
//   K8 sitewhere_tpu/models/deepar.py:97 _stacked_gru_scan and
//      :128 score_stacked, with models/common.py:142 normalize_windows and
//      :345 kstep_mask,
//   K4a sitewhere_tpu/parallel/sharded.py:564-580, the epilogue: column
//      select by `later`, zeroing of inactive slots and invalid rows, cast
//      to the wire dtype.
// Two input modes, as KS (lstm_score.cu): ring mode gathers each row's
// window from the post-update ring of its slot; windows mode reads given
// windows f32[T, B, W] and n_valid and writes all K columns f32[T, B, K].
//
// Rounding points follow the reference (deepar.py:111-119, :138-158) when
// the compute dtype is bf16: weights and biases are read at bf16; x_t is
// rounded; the input term x_t * wx and then + bx are each rounded; the
// recurrent dot h . wh accumulates in f32 and is rounded once, then + bh is
// rounded; gate order along 3H is r, z, n, with bh's n part inside r * nh;
// r, z, n, (1 - z), (1 - z) * n, z * h and the new h are each rounded. Each
// head is a dot rounded to bf16 plus a rounded bf16 bias, then widened to
// f32; sigma = softplus(raw) + 1e-4 with softplus = logaddexp(raw, 0), and
// the NLL 0.5 log(2 pi sigma^2) + (t - mu)^2 / (2 sigma^2) are f32. NLL
// scores can be negative. With f32 compute nothing rounds.
//
// Bound on the H100: operations. One row costs deepar_flops_per_row
// (774,016 FLOP at W=32, H=64, K=1) against ~2 KB of ring reads: at
// forecasting32 (65,536 rows) 50.7 GFLOP, ~51 us at the 989 TFLOP/s bf16
// tensor-core peak. This first version runs on the CUDA cores in f32 FMAs.
// Design (KS's, with 3H gate columns): one block per (slot, 32-row tile),
// 3H threads, thread j owning gate column j of the slot's wh (H x 3H), held
// in registers for all W-1 steps; the tile's h (broadcast float4 reads), the
// r/z gate sums, the n parts and the normalized windows live in shared
// memory. A tile with no live row writes its zeros and leaves.
//
// Widths and weight formats, as KS (lstm_score.cu): one instantiation for
// each H of 8, 16, 32 and 64; the 3H gate columns are padded to whole
// warps (24 and 48 columns at H = 8 and 16 run 32 and 64 threads, the
// threads past 3H idle in the gate phase; the heads' dots as KS's); wx,
// wh, mu and sigma read in their storage format (f32, bf16, or int8 with
// per-slot, per-output-channel f32 scales; common.cuh wload), the biases
// f32.
#include "gru.cuh"

namespace {

constexpr int kRows = 32;  // rows per block

struct KdArgs {
  const void* wx_w; const float* wx_b; const void* wh_w; const float* wh_b;
  const void* mu_w; const float* mu_b; const void* sg_w; const float* sg_b;
  const float* wx_s; const float* wh_s; const float* mu_s; const float* sg_s;  // int8 scales
  const float* ring; const int* pos; const int* count; int S;
  const void* ids; int id_kind;
  const float* windows; const int* n_valid;
  const int* later; const unsigned char* active; const int* counts;
  const unsigned char* mask;
  void* out; int out_kind;
  int B; int W; int K;
};

template <int H, bool BF16, int WF>
__global__ void __launch_bounds__(whole_warps(3 * H))
gru_score_kernel(const KdArgs a) {
  constexpr int NT = 3 * H;               // gate columns (r, z, n)
  constexpr int NTP = whole_warps(NT);    // threads: the columns in whole warps
  constexpr int NW = NTP / 32;            // warps
  using HL = HeadLanes<H>;                // the heads' lanes: L a row, RPW rows a warp
  static_assert(H % 8 == 0 && NTP >= kRows, "tile shape");

  extern __shared__ float smem[];
  float* hs = smem;                       // [kRows][H]
  float* gates = hs + kRows * H;          // [kRows][3H]: rx+rh, zx+zh, nh
  float* nxs = gates + kRows * NT;        // [kRows][H]: nx
  float* xs = nxs + kRows * H;            // [kRows][W] normalized windows
  int* nrow = reinterpret_cast<int*>(xs + kRows * a.W);  // samples per row
  int* colr = nrow + kRows;               // selected column, -1 = all K
  int* liver = colr + kRows;              // row is scored (else 0)

  const int t = blockIdx.y;
  const int b0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int W = a.W, K = a.K, B = a.B;
  const bool select = a.later != nullptr;
  const long long rowbase = static_cast<long long>(t) * B;

  bool live = false;
  if (tid < kRows) {
    const int r = tid, b = b0 + r;
    float* x = xs + r * W;
    int n = 0, col = -1;
    if (b < B) {
      live = scan_row_load(a, t, b, x, n, col);
    } else {
      for (int c = 0; c < W; ++c) x[c] = 0.0f;
    }
    nrow[r] = n;
    colr[r] = col;
    liver[r] = live ? 1 : 0;
  }
  if (!__syncthreads_or(live)) {
    if (select && tid < kRows && b0 + tid < B) store_val(a.out, a.out_kind, rowbase + b0 + tid, 0.0f);
    return;
  }

  // this slot's weights, at the compute dtype
  const int j = tid < NT ? tid : NT - 1;  // padding threads read column NT-1, write nothing
  const long long wo = static_cast<long long>(t) * NT + j;
  float wcol[H];
  const long long whp = static_cast<long long>(t) * H * NT + j;
#pragma unroll
  for (int k = 0; k < H; ++k) wcol[k] = wload<WF, BF16>(a.wh_w, a.wh_s, whp + k * NT, wo);
  const float wxj = wload<WF, BF16>(a.wx_w, a.wx_s, wo, wo);
  const float bxj = rb<BF16>(a.wx_b[wo]);
  const float bhj = rb<BF16>(a.wh_b[wo]);
  const int warp = tid >> 5, lane = tid & 31;
  const int ul = lane % HL::L;  // this lane's first head unit
  float mw[HL::HQ], sw[HL::HQ];
#pragma unroll
  for (int q = 0; q < HL::HQ; ++q) {
    const long long i = static_cast<long long>(t) * H + ul + 32 * q;
    mw[q] = wload<WF, BF16>(a.mu_w, a.mu_s, i, t);
    sw[q] = wload<WF, BF16>(a.sg_w, a.sg_s, i, t);
  }
  const float mb = rb<BF16>(a.mu_b[t]);
  const float sb = rb<BF16>(a.sg_b[t]);

  for (int e = tid; e < kRows * H; e += NTP) hs[e] = 0.0f;
  __syncthreads();

  const int steps = W - 1;
  for (int s = 0; s < steps; ++s) {
    // gx = x_t * wx[j] + bx[j]; gh = h[r] . wh[:, j] + bh[j]
    for (int r = 0; r < kRows && (NTP == NT || tid < NT); ++r) {
      const float4* hr = reinterpret_cast<const float4*>(hs + r * H);
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;  // 4 chains for ILP
#pragma unroll
      for (int q = 0; q < H / 4; ++q) {
        const float4 v = hr[q];
        a0 = fmaf(v.x, wcol[4 * q], a0);
        a1 = fmaf(v.y, wcol[4 * q + 1], a1);
        a2 = fmaf(v.z, wcol[4 * q + 2], a2);
        a3 = fmaf(v.w, wcol[4 * q + 3], a3);
      }
      const float gh = gru_gh<BF16>((a0 + a1) + (a2 + a3), bhj);
      const float gx = gru_gx<BF16>(xs[r * W + s], wxj, bxj);
      if (j < 2 * H) {
        gates[r * NT + j] = rb<BF16>(__fadd_rn(gx, gh));
      } else {
        gates[r * NT + j] = gh;
        nxs[r * H + (j - 2 * H)] = gx;
      }
    }
    __syncthreads();
    for (int e = tid; e < kRows * H; e += NTP) {
      const int r = e / H, u = e % H;
      const float* gr = gates + r * NT;
      hs[e] = gru_cell<BF16>(gr[u], gr[H + u], nxs[e], gr[2 * H + u], hs[e]);
    }
    __syncthreads();
    if (s < steps - K) continue;
    // heads on the last K states: the NLL of the normalized target
    const int jcol = s - (steps - K);
    for (int r0 = warp * HL::RPW; r0 < kRows; r0 += NW * HL::RPW) {
      const int r = r0 + lane / HL::L, b = b0 + r;
      const bool take = b < B && (colr[r] < 0 || colr[r] == jcol);
      if (HL::RPW == 1 && !take) continue;  // a warp-uniform skip (one row a warp)
      float pm = 0.0f, ps = 0.0f;
#pragma unroll
      for (int q = 0; q < HL::HQ; ++q) {
        const float hv = hs[r * H + ul + 32 * q];
        pm = fmaf(hv, mw[q], pm);
        ps = fmaf(hv, sw[q], ps);
      }
      group_sum2<HL::L>(pm, ps);
      if (ul == 0 && take) {
        const float mu = rb<BF16>(__fadd_rn(rb<BF16>(pm), mb));
        const float sigma = gauss_sigma(rb<BF16>(__fadd_rn(rb<BF16>(ps), sb)));
        const float nll = gaussian_nll(xs[r * W + (W - K + jcol)], mu, sigma);
        const float sc = (nrow[r] - (K - 1 - jcol)) >= 4 ? nll : 0.0f;
        if (select) {
          store_val(a.out, a.out_kind, rowbase + b, liver[r] ? sc : 0.0f);
        } else {
          static_cast<float*>(a.out)[(rowbase + b) * K + jcol] = sc;
        }
      }
    }
  }
}

template <int H, bool BF16, int WF>
int launch_kd(const KdArgs& a, int T, cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(kRows) * (H + 3 * H + H + a.W)) * sizeof(float) + 3 * kRows * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(gru_score_kernel<H, BF16, WF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.B + kRows - 1) / kRows, T);
  gru_score_kernel<H, BF16, WF><<<grid, whole_warps(3 * H), smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// wf: the weight leaves' storage format (WF_*); the four scales are set
// for int8 storage and NULL otherwise. H is one of 8, 16, 32, 64.
extern "C" int sw_gru_score(const void* wx_w, const float* wx_b, const void* wh_w,
                            const float* wh_b, const void* mu_w, const float* mu_b,
                            const void* sg_w, const float* sg_b, const float* wx_s,
                            const float* wh_s, const float* mu_s, const float* sg_s, int wf,
                            const float* ring, const int* pos, const int* count, int S,
                            const void* ids, int id_kind, const float* windows,
                            const int* n_valid, const int* later, const unsigned char* active,
                            const int* counts, const unsigned char* mask, void* out,
                            int out_kind, int T, int B, int W, int H, int K, int bf16,
                            void* stream) {
  if (T == 0 || B == 0) return static_cast<int>(cudaGetLastError());
  if (W < 2 || K < 1 || K > W - 1 || (wf == WF_I8 && (!wx_s || !wh_s || !mu_s || !sg_s))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  KdArgs a{wx_w, wx_b, wh_w, wh_b, mu_w, mu_b, sg_w, sg_b, wx_s, wh_s, mu_s, sg_s, ring, pos,
           count, S, ids, id_kind, windows, n_valid, later, active, counts, mask, out, out_kind,
           B, W, K};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_bf16(bf16, [&](auto b) {
    return by_format(wf, [&](auto f) {
      return by_hidden(H, [&](auto h) {
        return launch_kd<decltype(h)::value, decltype(b)::value, decltype(f)::value>(a, T, st);
      });
    });
  });
}
