// KS lstm_score: window gather + normalization + stacked LSTM scan + head +
// per-row column select, mask and wire cast, fused in one kernel.
//
// Replaces, as one kernel, what the JAX package's fused step runs between
// the ring update and the sketch:
//   K2 sitewhere_tpu/ops/windows.py:143 gather_windows (ring mode only),
//   K3 sitewhere_tpu/models/lstm_ad.py:117 _stacked_lstm_scan and
//      :159 score_stacked, with models/common.py:142 normalize_windows and
//      :345 kstep_mask,
//   K4a sitewhere_tpu/parallel/sharded.py:564-580, the epilogue: column
//      select by `later`, zeroing of inactive slots and invalid rows, cast
//      to the wire dtype.
// Two input modes: ring mode gathers each row's window from the
// post-update ring (pos/count) of its slot, clamping ids into [0, S) as
// XLA's gather does; windows mode reads given windows f32[T, B, W] and
// n_valid (the score_stacked contract) and writes all K columns
// f32[T, B, K] with no select or row mask.
//
// Rounding points follow the reference (lstm_ad.py:131-146) when the
// compute dtype is bf16: weights, x_t, each gate term, the gate sum, every
// nonlinearity and product of the cell update, h and c are rounded to bf16;
// the bias is wx.b + wh.b summed in f32, then rounded; the sigmoid rounds
// after its exp, add and division, as XLA's lowering of jax.nn.sigmoid
// does; normalization and |target - pred| are f32; dot products accumulate
// in f32. With f32 compute nothing rounds.
//
// Bound on the H100: operations. One row costs lstm_ad_flops_per_row
// (~1.03 MFLOP at W=32, H=64), against ~2 KB of ring reads, so the scan is
// compute-bound: at tenants32 (65,536 rows) ~67.6 GFLOP, ~68 us at the
// 989 TFLOP/s bf16 tensor-core peak. This first version runs on the CUDA
// cores in f32 FMAs and sits far above that bound; wgmma is later work.
// Design: one block per (slot, 32-row tile), 4H threads, thread j owning
// gate column j. The block's slot weights wh[s] (H x 4H) are loaded once,
// each thread keeping its column in registers for all W-1 steps; the
// tile's h (broadcast reads), gates and normalized windows live in shared
// memory, c in registers. Windows never touch HBM: the ring rows are read
// straight into the prologue. A tile with no live row (inactive slot or
// padding) writes its zeros and leaves.
//
// Widths and weight formats (the tenant's hidden and param_dtype): H is a
// template parameter, one instantiation for each of 8, 16, 32 and 64 (4H =
// 32..256 threads; at H < 32 a warp takes 32 / H rows of the head's dot
// at once, common.cuh HeadLanes). The weight leaves wx, wh and head are
// read in their storage format (common.cuh wload): f32 masters, bf16 (so
// bf16 storage at bf16 compute gives the f32 masters' bits), or int8 with
// per-slot, per-output-channel f32 scales, dequantized once a block as the
// reference's kernel_weight does; biases are f32 in every format. The
// weights are read once a block, so the format moves the block's
// prologue, not the scan.
#include "common.cuh"

namespace {

constexpr int kRows = 32;  // rows per block

struct KsArgs {
  const void* wx_w; const float* wx_b; const void* wh_w; const float* wh_b;
  const void* hd_w; const float* hd_b;
  const float* wx_s; const float* wh_s; const float* hd_s;  // int8 scales
  const float* ring; const int* pos; const int* count; int S;
  const void* ids; int id_kind;
  const float* windows; const int* n_valid;
  const int* later; const unsigned char* active; const int* counts;
  const unsigned char* mask;
  void* out; int out_kind;
  int B; int W; int K;
};

template <int H, bool BF16, int WF>
__global__ void __launch_bounds__(4 * H)
lstm_score_kernel(const KsArgs a) {
  constexpr int NT = 4 * H;          // threads = gate columns
  constexpr int NW = NT / 32;        // warps
  constexpr int PER = kRows * H / NT;  // (row, unit) cells per thread
  using HL = HeadLanes<H>;           // the head's lanes: L a row, RPW rows a warp
  static_assert(H % 8 == 0 && NT >= kRows && (kRows * H) % NT == 0, "tile shape");

  extern __shared__ float smem[];
  float* hs = smem;                       // [kRows][H]
  float* gates = hs + kRows * H;          // [kRows][4H]
  float* xs = gates + kRows * NT;         // [kRows][W] normalized windows
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
  const int j = tid;
  const long long col = static_cast<long long>(t) * NT + j;  // (slot, column)
  float wcol[H];
  const long long whp = static_cast<long long>(t) * H * NT + j;
#pragma unroll
  for (int k = 0; k < H; ++k) wcol[k] = wload<WF, BF16>(a.wh_w, a.wh_s, whp + k * NT, col);
  const float wxj = wload<WF, BF16>(a.wx_w, a.wx_s, col, col);
  const float bj = rb<BF16>(a.wx_b[col] + a.wh_b[col]);
  const int warp = tid >> 5, lane = tid & 31;
  const int ul = lane % HL::L;  // this lane's first head unit
  float hw[HL::HQ];
#pragma unroll
  for (int q = 0; q < HL::HQ; ++q) {
    hw[q] = wload<WF, BF16>(a.hd_w, a.hd_s, static_cast<long long>(t) * H + ul + 32 * q, t);
  }
  const float hb = rb<BF16>(a.hd_b[t]);

  float creg[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) creg[q] = 0.0f;
  for (int e = tid; e < kRows * H; e += NT) hs[e] = 0.0f;
  __syncthreads();

  const int steps = W - 1;
  for (int s = 0; s < steps; ++s) {
    // gates[r][j] = x_t * wx[j] + h[r] . wh[:, j] + bias[j]
    for (int r = 0; r < kRows; ++r) {
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
      const float acc = (a0 + a1) + (a2 + a3);
      const float x = rb<BF16>(xs[r * W + s]);
      gates[r * NT + j] = rb<BF16>(rb<BF16>(rb<BF16>(x * wxj) + rb<BF16>(acc)) + bj);
    }
    __syncthreads();
    // cell update, gate order i, f, g, o; forget gate biased by +1
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int e = tid + q * NT;
      const int r = e / H, u = e % H;
      const float* gr = gates + r * NT;
      const float sf = sigm<BF16>(rb<BF16>(gr[H + u] + 1.0f));
      const float si = sigm<BF16>(gr[u]);
      const float tg = rb<BF16>(tanhf(gr[2 * H + u]));
      const float c = rb<BF16>(rb<BF16>(sf * creg[q]) + rb<BF16>(si * tg));
      creg[q] = c;
      const float so = sigm<BF16>(gr[3 * H + u]);
      hs[r * H + u] = rb<BF16>(so * rb<BF16>(tanhf(c)));
    }
    __syncthreads();
    if (s < steps - K) continue;
    // head on the last K states: |normed target - prediction|
    const int jcol = s - (steps - K);
    for (int r0 = warp * HL::RPW; r0 < kRows; r0 += NW * HL::RPW) {
      const int r = r0 + lane / HL::L, b = b0 + r;
      const bool take = b < B && (colr[r] < 0 || colr[r] == jcol);
      if (HL::RPW == 1 && !take) continue;  // a warp-uniform skip (one row a warp)
      float p = 0.0f;
#pragma unroll
      for (int q = 0; q < HL::HQ; ++q) p = fmaf(hs[r * H + ul + 32 * q], hw[q], p);
      p = group_sum<HL::L>(p);
      if (ul == 0 && take) {
        const float pred = rb<BF16>(rb<BF16>(p) + hb);
        const float err = fabsf(xs[r * W + (W - K + jcol)] - pred);
        const float sc = (nrow[r] - (K - 1 - jcol)) >= 4 ? err : 0.0f;
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
int launch_ks(const KsArgs& a, int T, cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(kRows) * (H + 4 * H + a.W)) * sizeof(float) + 3 * kRows * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(lstm_score_kernel<H, BF16, WF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.B + kRows - 1) / kRows, T);
  lstm_score_kernel<H, BF16, WF><<<grid, 4 * H, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// wf: the weight leaves' storage format (WF_*); the three scales are set
// for int8 storage and NULL otherwise. H is one of 8, 16, 32, 64.
extern "C" int sw_lstm_score(const void* wx_w, const float* wx_b, const void* wh_w,
                             const float* wh_b, const void* hd_w, const float* hd_b,
                             const float* wx_s, const float* wh_s, const float* hd_s, int wf,
                             const float* ring, const int* pos, const int* count, int S,
                             const void* ids, int id_kind, const float* windows,
                             const int* n_valid, const int* later, const unsigned char* active,
                             const int* counts, const unsigned char* mask, void* out,
                             int out_kind, int T, int B, int W, int H, int K, int bf16,
                             void* stream) {
  if (T == 0 || B == 0) return static_cast<int>(cudaGetLastError());
  if (W < 2 || K < 1 || K > W - 1 || (wf == WF_I8 && (!wx_s || !wh_s || !hd_s))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  KsArgs a{wx_w, wx_b, wh_w, wh_b, hd_w, hd_b, wx_s, wh_s, hd_s, ring, pos, count, S, ids,
           id_kind, windows, n_valid, later, active, counts, mask, out, out_kind, B, W, K};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_bf16(bf16, [&](auto b) {
    return by_format(wf, [&](auto f) {
      return by_hidden(H, [&](auto h) {
        return launch_ks<decltype(h)::value, decltype(b)::value, decltype(f)::value>(a, T, st);
      });
    });
  });
}
