// KB lstm_train: the LSTM-AD train form. The forward mode gathers each
// row's window (ring mode) or reads it (windows mode), normalizes it, runs
// the stacked LSTM scan over its W-1 teacher-forced steps with the head on
// every step, and writes the per-row MSE; the backward mode walks the
// steps in reverse (BPTT) from the masked per-slot mean's seed g_row.
//
// Replaces the XLA autodiff, forward and backward, of
//   sitewhere_tpu/models/lstm_ad.py:117 _stacked_lstm_scan and :202
//   loss_stacked (with models/common.py:142 normalize_windows), and in ring
//   mode sitewhere_tpu/ops/windows.py:143 gather_windows (ids = arange(S)),
// as the fused train step runs them (sitewhere_tpu/parallel/sharded.py:1111
// _build_train_step_fused). The weight gradient of the recurrent product,
// dWh[s] = sum_{t,b} h_{t-1}^T dgates_t, stays a torch.bmm over the saved
// h and the dgates this kernel writes (models/train.py).
//
// Forward rounding follows the reference with bf16 compute exactly where KS
// rounds (lstm_score.cu; csrc/common.cuh sigm<BF16>), with _rn intrinsics
// so nvcc contracts no product into a sum where the reference rounds
// between them. Loss: pred = bf16(bf16(h . w_head) + b_head) widened to
// f32, err = pred - target, per-row mean of err^2 in f32. The backward runs
// in f32 on the saved values (every saved value is the forward's own, bf16
// exact under bf16 compute): per step, from the head's seed
// dpred = g_row / (W-1) * 2 err, with dh carried from the later step:
//   do = dh tanh(c); dc += dh o (1 - tanh(c)^2);
//   di = dc g; dg = dc i; df = dc c_{t-1}; dc_{t-1} = dc f;
//   dgates = (di i(1-i), df f(1-f), dg (1-g^2), do o(1-o))   (f = sigma(. + 1))
//   dh_{t-1} = dgates . wh^T.
// dwx (x_t dgates), db (shared by wx.b and wh.b), dhead_w (h_t dpred) and
// dhead_b are summed per tile, then over tiles by the second pass.
//
// Bound on the H100: operations. One train step is ~3x the forward's
// matmul work: 3 x lstm_ad_flops_per_row (1.0357 MFLOP at W=32, H=64) a
// row; at tenants32's train plane (32 slots x 8192 streams) 0.815 TFLOP,
// 0.82 ms at the 989 TFLOP/s bf16 tensor-core peak. This first version
// runs on the CUDA cores in f32 FMAs and sits far above that bound.
// Design: the saves (act i, f, g, o; c; h: 768 bytes a row-step in bf16)
// are written once and read once rather than recomputed: the recurrence
// costs more on CUDA cores than the ~13 GB of traffic the saves and
// dgates cost at tenants32. Forward: KS's layout (a block per (slot,
// 32-row tile), thread j owns gate column j with wh[:, j] in registers).
// Backward: 256 threads, thread (rg, u) owns unit u of rows rg + 4q, keeps
// their dc in registers, and computes their dh_{t-1} from the tile's
// dgates and the slot's wh^T, both in shared memory; a tile whose rows all
// carry a zero seed (masked out) writes zeros and leaves.
//
// Widths: one instantiation for each H of 8, 16, 32 and 64 (forward 4H
// threads; backward 256 / H row groups, bptt.cuh BwdTile). The train form
// reads the f32 master weights only, as the reference trains them; a
// bf16/int8 serving view is derived from the masters (commit_swap).
#include "bptt.cuh"

namespace {

constexpr int kRows = kTrainRows;

enum { WX_W, WX_B, WH_W, WH_B, HD_W, HD_B };

template <int H, bool BF16>
__global__ void __launch_bounds__(4 * H) lstm_train_fwd(const TrainArgs a) {
  constexpr int NT = 4 * H;            // threads = gate columns
  constexpr int NW = NT / 32;          // warps
  constexpr int PER = kRows * H / NT;  // (row, unit) cells per thread
  using HL = HeadLanes<H>;             // the head's lanes: L a row, RPW rows a warp at once
  constexpr int RI = kRows / (NW * HL::RPW);  // head passes a warp makes a step
  static_assert(H % 8 == 0 && (kRows * H) % NT == 0 && kRows % (NW * HL::RPW) == 0,
                "tile shape");

  extern __shared__ float smem[];
  float* hs = smem;               // [kRows][H]
  float* gates = hs + kRows * H;  // [kRows][4H]
  float* xs = gates + kRows * NT; // [kRows][W] normalized windows

  const int t = blockIdx.y;
  const int b0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int W = a.W, B = a.B, steps = W - 1;
  train_tile_load(a, t, b0, xs);

  const int j = tid;
  float wcol[H];
  const float* whp = a.w[WH_W] + static_cast<long long>(t) * H * NT;
#pragma unroll
  for (int k = 0; k < H; ++k) wcol[k] = rb<BF16>(whp[k * NT + j]);
  const long long wo = static_cast<long long>(t) * NT + j;
  const float wxj = rb<BF16>(a.w[WX_W][wo]);
  const float bj = rb<BF16>(__fadd_rn(a.w[WX_B][wo], a.w[WH_B][wo]));
  const int warp = tid >> 5, lane = tid & 31;
  const int ul = lane % HL::L;  // this lane's first head unit
  float hw[HL::HQ];
#pragma unroll
  for (int q = 0; q < HL::HQ; ++q) {
    hw[q] = rb<BF16>(a.w[HD_W][static_cast<long long>(t) * H + ul + 32 * q]);
  }
  const float hb = rb<BF16>(a.w[HD_B][t]);

  float creg[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) creg[q] = 0.0f;
  for (int e = tid; e < kRows * H; e += NT) hs[e] = 0.0f;
  float loss[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) loss[i] = 0.0f;
  __syncthreads();

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
      gates[r * NT + j] = rb<BF16>(
          __fadd_rn(rb<BF16>(__fadd_rn(rb<BF16>(__fmul_rn(x, wxj)), rb<BF16>(acc))), bj));
    }
    __syncthreads();
    // cell update, gate order i, f, g, o; forget gate biased by +1; saves
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int e = tid + q * NT;
      const int r = e / H, u = e % H;
      const float* gr = gates + r * NT;
      const float sf = sigm<BF16>(rb<BF16>(__fadd_rn(gr[H + u], 1.0f)));
      const float si = sigm<BF16>(gr[u]);
      const float tg = rb<BF16>(tanhf(gr[2 * H + u]));
      const float c = rb<BF16>(__fadd_rn(rb<BF16>(__fmul_rn(sf, creg[q])), rb<BF16>(__fmul_rn(si, tg))));
      creg[q] = c;
      const float so = sigm<BF16>(gr[3 * H + u]);
      const float h = rb<BF16>(__fmul_rn(so, rb<BF16>(tanhf(c))));
      hs[r * H + u] = h;
      const int b = b0 + r;
      if (b < B) {
        const long long row = (static_cast<long long>(t) * steps + s) * B + b;
        save<BF16>(a.act, row * NT + u, si);
        save<BF16>(a.act, row * NT + H + u, sf);
        save<BF16>(a.act, row * NT + 2 * H + u, tg);
        save<BF16>(a.act, row * NT + 3 * H + u, so);
        save<BF16>(a.cst, row * H + u, c);
        save<BF16>(a.hst, row * H + u, h);
      }
    }
    __syncthreads();
    // head on every step: the teacher-forced prediction of x[s + 1]
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = (warp + NW * i) * HL::RPW + lane / HL::L;
      float p = 0.0f;
#pragma unroll
      for (int q = 0; q < HL::HQ; ++q) p = fmaf(hs[r * H + ul + 32 * q], hw[q], p);
      p = group_sum<HL::L>(p);
      const int b = b0 + r;
      if (ul == 0 && b < B) {
        const float pred = rb<BF16>(__fadd_rn(rb<BF16>(p), hb));
        const float err = __fsub_rn(pred, xs[r * W + s + 1]);
        loss[i] = __fadd_rn(loss[i], __fmul_rn(err, err));
        a.dhead[(static_cast<long long>(t) * B + b) * steps + s] = 2.0f * err;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int b = b0 + (warp + NW * i) * HL::RPW + lane / HL::L;
    if (ul == 0 && b < B) {
      a.per_row[static_cast<long long>(t) * B + b] = __fdiv_rn(loss[i], static_cast<float>(steps));
    }
  }
}

template <int H, bool BF16>
__global__ void __launch_bounds__(kBwdThreads) lstm_train_bwd(const TrainArgs a) {
  constexpr int G = 4 * H;                 // gate columns
  constexpr int RG = BwdTile<H, G>::RG;    // row groups
  constexpr int PER = BwdTile<H, G>::PER;  // rows per thread
  constexpr int P = 2 * G + H + 1;         // dwx | db | dhead_w | dhead_b
  constexpr int DG = BwdTile<H, G>::dg(RG * (2 * G + H));

  extern __shared__ float smem[];
  float* whT = smem;               // [G][H]: wh^T at the compute dtype
  float* dG = whT + G * H;         // [kRows][G]: this step's dgates (DG floats)
  float* dh = dG + DG;             // [kRows][H]: dh from the later step
  float* xs = dh + kRows * H;      // [kRows][W]
  float* dpr = xs + kRows * a.W;   // [kRows]: this step's dpred

  const int t = blockIdx.y, tile = blockIdx.x;
  const int b0 = tile * kRows;
  const int tid = threadIdx.x;
  const int W = a.W, B = a.B, steps = W - 1;
  bool live = false;
  if (tid < kRows && b0 + tid < B) live = a.g_row[static_cast<long long>(t) * B + b0 + tid] != 0.0f;
  if (!__syncthreads_or(live)) {
    zero_tile<BF16>(a, t, tile, b0, G, P);
    return;
  }
  train_tile_load(a, t, b0, xs);
  const float* whp = a.w[WH_W] + static_cast<long long>(t) * H * G;
  for (int e = tid; e < H * G; e += kBwdThreads) whT[(e % G) * H + e / G] = rb<BF16>(whp[e]);
  for (int e = tid; e < kRows * H; e += kBwdThreads) dh[e] = 0.0f;
  const int u = tid % H, rg = tid / H;
  const float hw = rb<BF16>(a.w[HD_W][static_cast<long long>(t) * H + u]);
  const float inv = 1.0f / static_cast<float>(steps);

  float dc[PER], adb[4], adwx[4], ahw = 0.0f, ahb = 0.0f;
#pragma unroll
  for (int q = 0; q < PER; ++q) dc[q] = 0.0f;
#pragma unroll
  for (int g = 0; g < 4; ++g) adb[g] = adwx[g] = 0.0f;
  __syncthreads();

  for (int s = steps - 1; s >= 0; --s) {
    if (tid < kRows) {
      const int b = b0 + tid;
      dpr[tid] = b < B ? a.g_row[static_cast<long long>(t) * B + b] * inv *
                             a.dhead[(static_cast<long long>(t) * B + b) * steps + s]
                       : 0.0f;
    }
    __syncthreads();
    if (tid == 0) {
      for (int r = 0; r < kRows; ++r) ahb += dpr[r];
    }
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int r = rg + RG * q, b = b0 + r;
      float gd[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (b < B) {
        const long long row = (static_cast<long long>(t) * steps + s) * B + b;
        const float i = saved<BF16>(a.act, row * G + u);
        const float f = saved<BF16>(a.act, row * G + H + u);
        const float g = saved<BF16>(a.act, row * G + 2 * H + u);
        const float o = saved<BF16>(a.act, row * G + 3 * H + u);
        const float c = saved<BF16>(a.cst, row * H + u);
        const float cp = s > 0 ? saved<BF16>(a.cst, (row - B) * H + u) : 0.0f;
        const float h = saved<BF16>(a.hst, row * H + u);
        const float dp = dpr[r];
        const float dhv = dh[r * H + u] + dp * hw;
        ahw += dp * h;
        const float tc = rb<BF16>(tanhf(c));
        const float dcv = dc[q] + dhv * o * (1.0f - tc * tc);
        dc[q] = dcv * f;
        gd[0] = dcv * g * i * (1.0f - i);
        gd[1] = dcv * cp * f * (1.0f - f);
        gd[2] = dcv * i * (1.0f - g * g);
        gd[3] = dhv * tc * o * (1.0f - o);
        const float x = rb<BF16>(xs[r * W + s]);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          save<BF16>(a.dgates, row * G + k * H + u, gd[k]);
          adb[k] += gd[k];
          adwx[k] = fmaf(x, gd[k], adwx[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) dG[r * G + k * H + u] = gd[k];
    }
    __syncthreads();
    float acc[PER];
#pragma unroll
    for (int q = 0; q < PER; ++q) acc[q] = 0.0f;
    recurrent_grad<H, G>(dG, whT, rg, u, acc);
#pragma unroll
    for (int q = 0; q < PER; ++q) dh[(rg + RG * q) * H + u] = acc[q];
    __syncthreads();
  }

  // the tile's partial sums, rows groups added in order
  float* red = dG;  // [2][RG][G] then [RG][H]
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    red[rg * G + k * H + u] = adwx[k];
    red[RG * G + rg * G + k * H + u] = adb[k];
  }
  red[2 * RG * G + rg * H + u] = ahw;
  __syncthreads();
  float* part = a.partials + (static_cast<long long>(t) * gridDim.x + tile) * P;
  for (int jj = tid; jj < G; jj += kBwdThreads) {
    float sx = 0.0f, sb = 0.0f;
    for (int k = 0; k < RG; ++k) {
      sx += red[k * G + jj];
      sb += red[RG * G + k * G + jj];
    }
    part[jj] = sx;
    part[G + jj] = sb;
  }
  if (tid < H) {
    float sw = 0.0f;
    for (int k = 0; k < RG; ++k) sw += red[2 * RG * G + k * H + tid];
    part[2 * G + tid] = sw;
  }
  if (tid == 0) part[2 * G + H] = ahb;
}

template <int H, bool BF16>
int launch_kb(int mode, const TrainArgs& a, int T, cudaStream_t st) {
  const int tiles = (a.B + kRows - 1) / kRows;
  const dim3 grid(tiles, T);
  if (mode == 0) {
    const size_t smem = static_cast<size_t>(kRows) * (H + 4 * H + a.W) * sizeof(float);
    int err = set_smem(lstm_train_fwd<H, BF16>, smem);
    if (err != 0) return err;
    lstm_train_fwd<H, BF16><<<grid, 4 * H, smem, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  constexpr int G = 4 * H;
  constexpr int DG = BwdTile<H, G>::dg(BwdTile<H, G>::RG * (2 * G + H));
  const size_t smem =
      (static_cast<size_t>(G) * H + DG + kRows * (H + a.W) + kRows) * sizeof(float);
  int err = set_smem(lstm_train_bwd<H, BF16>, smem);
  if (err != 0) return err;
  lstm_train_bwd<H, BF16><<<grid, kBwdThreads, smem, st>>>(a);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return launch_tile_reduce(a, T, tiles, 2 * G + H + 1, st);
}

}  // namespace

// mode 0: forward (per_row, act, cst, hst, dhead out); mode 1: backward
// (g_row and the saves in; dgates, partials, reduced out). H is one of 8,
// 16, 32, 64.
extern "C" int sw_lstm_train(int mode, const float* wx_w, const float* wx_b, const float* wh_w,
                             const float* wh_b, const float* hd_w, const float* hd_b,
                             const float* ring, const int* pos, const int* count, int S,
                             const float* windows, int T, int B, int W, int H, int bf16,
                             float* per_row, void* act, void* cst, void* hst, float* dhead,
                             const float* g_row, void* dgates, float* partials, float* reduced,
                             void* stream) {
  if (T == 0 || B == 0) return static_cast<int>(cudaGetLastError());
  if (W < 2 || (mode != 0 && mode != 1)) return static_cast<int>(cudaErrorInvalidValue);
  TrainArgs a{{wx_w, wx_b, wh_w, wh_b, hd_w, hd_b, nullptr, nullptr},
              ring, pos, count, S, windows, B, W, per_row, act, cst, hst, dhead,
              g_row, dgates, partials, reduced};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_bf16(bf16, [&](auto bf) {
    return by_hidden(H, [&](auto h) {
      return launch_kb<decltype(h)::value, decltype(bf)::value>(mode, a, T, st);
    });
  });
}
