// KB lstm_train, wide form: the LSTM-AD train form (window gather or read,
// normalization, the stacked LSTM scan with the head on every step, the
// per-row MSE; and its BPTT backward) at any hidden and any window.
//
// Replaces what lstm_train.cu replaces (the XLA autodiff, forward and
// backward, of sitewhere_tpu/models/lstm_ad.py:117 _stacked_lstm_scan and
// :202 loss_stacked, with models/common.py:142 normalize_windows and, in
// ring mode, sitewhere_tpu/ops/windows.py:143 gather_windows; as
// sitewhere_tpu/parallel/sharded.py:1111 _build_train_step_fused runs them)
// at the shapes the templated KB does not take: hidden outside 8/16/32/64
// (LSTM-AD's tenants at 128, ...) and windows whose tiles no longer fit
// shared memory (models/flush.py train_route). Same two modes, same
// arguments (plus R and the wh^T scratch), the same saves in the same
// layouts, so dWh stays models/train.py's torch.bmm.
//
// Forward rounding: lstm_train.cu's (KS's, with _rn intrinsics); the dot
// products accumulate in f32 in k order (wide::item_dots, KS's wide form).
// Backward: lstm_train.cu's f32 arithmetic on the saved values, per step
// and row, with dh carried from the later step:
//   dpred = g_row / (W-1) * dhead; dh += dpred * w_head;
//   do = dh tanh(c); dc += dh o (1 - tanh(c)^2);
//   dgates = (dc g i(1-i), dc c_{t-1} f(1-f), dc i (1-g^2), dh tanh(c) o(1-o));
//   dc_{t-1} = dc f;  dh_{t-1} = dgates . wh^T.
//
// Bound on the H100: operations. A train step is ~3x the forward's matmul
// work, 3 x lstm_ad_flops_per_row (33.75 MFLOP a row forward at H 128,
// W 256): 26.5 TFLOP at tenants32's train plane (32 x 8192 rows), 26.8 ms
// at the 989 TFLOP/s bf16 tensor-core peak. This first version runs on the
// CUDA cores in f32 FMAs; tensor cores are later work.
// Design: bptt_wide.cuh. An item is one unit's four gate columns (i, f, g,
// o at u, H + u, 2H + u, 3H + u) for 8 rows: the forward's cell update and
// the backward's elementwise step are the item's own; c (forward) and dc
// (backward) live in the block state [R][H], owned by the item. The block
// state sits in shared memory (the wide form, hidden up to 784) or in a
// global scratch (the global form, sw_lstm_train_global): the same
// kernels, any hidden.
#include "bptt_wide.cuh"

namespace {

using bw::kTR;

enum { WX_W, WX_B, WH_W, WH_B, HD_W, HD_B };

template <bool BF16, bool GS>
__global__ void __launch_bounds__(wide::kMaxThreads)
lstm_train_wide_fwd(const TrainArgs a, const bw::Grid g, const float*) {
  const int H = g.H, R = g.R, RS = R + 4, W = a.W, B = a.B, G = 4 * H, steps = W - 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  wide::RowSrc* srcs = reinterpret_cast<wide::RowSrc*>(smem_raw);  // [R]
  float* xb = reinterpret_cast<float*>(srcs + R);  // [2][R] normalized x of a step
  float* loss = xb + 2 * R;                        // [R] summed squared errors
  float* hT = wide::block_state<GS>(loss + R, g.state, g.stride);  // [2][H][RS]
  float* cs = hT + 2 * H * RS;                     // [R][H]
  float* hw = cs + R * H;                          // [H] head weights

  int t, tile;
  bw::block_tile(g, t, tile);
  const int b0 = tile * R;
  const int tid = threadIdx.x, nth = blockDim.x;
  bw::load_srcs(a, t, b0, R, srcs);
  if (tid < R) {
    xb[tid] = wide::normed_at(srcs[tid], W, 0);
    loss[tid] = 0.0f;
  }
  for (int e = tid; e < 2 * H * RS; e += nth) hT[e] = 0.0f;
  for (int e = tid; e < R * H; e += nth) cs[e] = 0.0f;
  for (int u = tid; u < H; u += nth) hw[u] = rb<BF16>(a.w[HD_W][static_cast<long long>(t) * H + u]);
  const float hb = rb<BF16>(a.w[HD_B][t]);
  __syncthreads();

  const int items = H * (R / kTR);
  const int warp = tid >> 5, lane = tid & 31, nwarps = nth >> 5;
  const long long wbase = static_cast<long long>(t) * H * G;
  const float unit[4] = {1.0f, 1.0f, 1.0f, 1.0f};  // f32 masters: no int8 scales
  for (int s = 0; s < steps; ++s) {
    const float* hc = hT + (s & 1) * H * RS;
    float* hn = hT + ((s + 1) & 1) * H * RS;
    const float* xc = xb + (s & 1) * R;
    for (int i = tid; i < items; i += nth) {
      const int u = i % H, r0 = (i / H) * kTR;
      const long long c0 = static_cast<long long>(t) * G + u;
      float wxq[4], bq[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const long long c = c0 + static_cast<long long>(q) * H;
        wxq[q] = rb<BF16>(a.w[WX_W][c]);
        bq[q] = rb<BF16>(__fadd_rn(a.w[WX_B][c], a.w[WH_B][c]));
      }
      float acc[4][kTR];
      wide::item_dots<4, WF_F32, BF16>(acc, hc + r0, RS, a.w[WH_W], wbase, H, u, unit);
      float hv[kTR];
#pragma unroll
      for (int r = 0; r < kTR; ++r) {
        const float x = rb<BF16>(xc[r0 + r]);
        float gv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          gv[q] = rb<BF16>(__fadd_rn(
              rb<BF16>(__fadd_rn(rb<BF16>(__fmul_rn(x, wxq[q])), rb<BF16>(acc[q][r]))), bq[q]));
        }
        // gate order i, f, g, o; forget gate biased by +1
        float* cp = cs + (r0 + r) * H + u;
        const float sf = sigm<BF16>(rb<BF16>(__fadd_rn(gv[1], 1.0f)));
        const float si = sigm<BF16>(gv[0]);
        const float tg = rb<BF16>(tanhf(gv[2]));
        const float c = rb<BF16>(__fadd_rn(rb<BF16>(__fmul_rn(sf, *cp)), rb<BF16>(__fmul_rn(si, tg))));
        *cp = c;
        const float so = sigm<BF16>(gv[3]);
        const float h = rb<BF16>(__fmul_rn(so, rb<BF16>(tanhf(c))));
        hv[r] = h;
        const int b = b0 + r0 + r;
        if (b < B) {
          const long long row = (static_cast<long long>(t) * steps + s) * B + b;
          save<BF16>(a.act, row * G + u, si);
          save<BF16>(a.act, row * G + H + u, sf);
          save<BF16>(a.act, row * G + 2 * H + u, tg);
          save<BF16>(a.act, row * G + 3 * H + u, so);
          save<BF16>(a.cst, row * H + u, c);
          save<BF16>(a.hst, row * H + u, h);
        }
      }
      bw::put_rows(hn, u, RS, r0, hv);
    }
    // the next step's input, which is also this step's target
    if (tid < R) xb[((s + 1) & 1) * R + tid] = wide::normed_at(srcs[tid], W, s + 1);
    __syncthreads();
    // head on every step: the teacher-forced prediction of x[s + 1]
    const float* target = xb + ((s + 1) & 1) * R;
    for (int r = warp; r < R; r += nwarps) {
      const int b = b0 + r;
      if (b >= B) continue;  // warp-uniform
      float p = 0.0f;
      for (int u = lane; u < H; u += 32) p = fmaf(hn[u * RS + r], hw[u], p);
      p = warp_sum(p);
      if (lane == 0) {
        const float pred = rb<BF16>(__fadd_rn(rb<BF16>(p), hb));
        const float err = __fsub_rn(pred, target[r]);
        loss[r] = __fadd_rn(loss[r], __fmul_rn(err, err));
        a.dhead[(static_cast<long long>(t) * B + b) * steps + s] = 2.0f * err;
      }
    }
  }
  __syncthreads();
  if (tid < R && b0 + tid < B) {
    a.per_row[static_cast<long long>(t) * B + b0 + tid] =
        __fdiv_rn(loss[tid], static_cast<float>(steps));
  }
}

template <bool BF16, bool GS>
__global__ void __launch_bounds__(wide::kMaxThreads)
lstm_train_wide_bwd(const TrainArgs a, const bw::Grid g, const float* wt) {
  const int H = g.H, R = g.R, RS = R + 4, W = a.W, B = a.B, G = 4 * H, steps = W - 1;
  const int RG = R / kTR;
  const int PA = 2 * G + H;  // a row group's sums: dwx | db | dhead_w
  extern __shared__ __align__(16) unsigned char smem_raw[];
  wide::RowSrc* srcs = reinterpret_cast<wide::RowSrc*>(smem_raw);  // [R]
  float* dp = reinterpret_cast<float*>(srcs + R);   // [2][R]: a step's dpred
  float* xv = dp + 2 * R;                           // [2][R]: a step's input x
  float* dGT = wide::block_state<GS>(xv + 2 * R, g.state, g.stride);  // [G][RS]: dgates
  float* dh = dGT + G * RS;                         // [R][H]: dh from the later step
  float* dc = dh + R * H;                           // [R][H]: dc from the later step
  float* acc = dc + R * H;                          // [RG][PA]
  float* hw = acc + RG * PA;                        // [H]

  int t, tile;
  bw::block_tile(g, t, tile);
  const int b0 = tile * R;
  const int tid = threadIdx.x, nth = blockDim.x;
  if (!bw::tile_live(a, t, b0, R)) {
    bw::zero_rows<BF16>(a, t, tile, g.tiles, b0, R, G, PA + 1);
    return;
  }
  bw::load_srcs(a, t, b0, R, srcs);
  for (int e = tid; e < 2 * R * H; e += nth) dh[e] = 0.0f;  // dh and dc
  for (int e = tid; e < RG * PA; e += nth) acc[e] = 0.0f;
  for (int u = tid; u < H; u += nth) hw[u] = rb<BF16>(a.w[HD_W][static_cast<long long>(t) * H + u]);
  const float inv = 1.0f / static_cast<float>(steps);
  __syncthreads();
  // step s's seed and input, into buffer s & 1
  auto stage = [&](int s) {
    if (tid < R) {
      const int b = b0 + tid;
      dp[(s & 1) * R + tid] =
          b < B ? a.g_row[static_cast<long long>(t) * B + b] * inv *
                      a.dhead[(static_cast<long long>(t) * B + b) * steps + s]
                : 0.0f;
      xv[(s & 1) * R + tid] = rb<BF16>(wide::normed_at(srcs[tid], W, s));
    }
  };
  stage(steps - 1);
  __syncthreads();

  const int items = H * RG;
  float ahb = 0.0f;  // thread 0: d head.b
  for (int s = steps - 1; s >= 0; --s) {
    const float* dps = dp + (s & 1) * R;
    const float* xs = xv + (s & 1) * R;
    if (tid == 0) {
      for (int r = 0; r < R; ++r) ahb += dps[r];
    }
    for (int i = tid; i < items; i += nth) {
      const int u = i % H, rg = i / H, r0 = rg * kTR;
      const float hwu = hw[u];
      float gT[4][kTR], adb[4] = {0.0f, 0.0f, 0.0f, 0.0f}, adwx[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float ahw = 0.0f;
#pragma unroll
      for (int r = 0; r < kTR; ++r) {
        const int rr = r0 + r, b = b0 + rr;
        float gd[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (b < B) {
          const long long row = (static_cast<long long>(t) * steps + s) * B + b;
          const float ig = saved<BF16>(a.act, row * G + u);
          const float f = saved<BF16>(a.act, row * G + H + u);
          const float g = saved<BF16>(a.act, row * G + 2 * H + u);
          const float o = saved<BF16>(a.act, row * G + 3 * H + u);
          const float c = saved<BF16>(a.cst, row * H + u);
          const float cp = s > 0 ? saved<BF16>(a.cst, (row - B) * H + u) : 0.0f;
          const float h = saved<BF16>(a.hst, row * H + u);
          const float dpv = dps[rr];
          const float dhv = dh[rr * H + u] + dpv * hwu;
          ahw += dpv * h;
          const float tc = rb<BF16>(tanhf(c));
          const float dcv = dc[rr * H + u] + dhv * o * (1.0f - tc * tc);
          dc[rr * H + u] = dcv * f;
          gd[0] = dcv * g * ig * (1.0f - ig);
          gd[1] = dcv * cp * f * (1.0f - f);
          gd[2] = dcv * ig * (1.0f - g * g);
          gd[3] = dhv * tc * o * (1.0f - o);
          const float x = xs[rr];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            save<BF16>(a.dgates, row * G + k * H + u, gd[k]);
            adb[k] += gd[k];
            adwx[k] = fmaf(x, gd[k], adwx[k]);
          }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) gT[k][r] = gd[k];
      }
      float* ac = acc + rg * PA;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        bw::put_rows(dGT, k * H + u, RS, r0, gT[k]);
        ac[k * H + u] += adwx[k];
        ac[G + k * H + u] += adb[k];
      }
      ac[2 * G + u] += ahw;
    }
    if (s > 0) stage(s - 1);
    __syncthreads();
    // dh_{t-1} = dgates . wh^T, each item for its unit and rows
    for (int i = tid; i < items; i += nth) {
      const int u = i % H, r0 = (i / H) * kTR;
      float v[kTR] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      bw::item_rgrad(v, dGT, RS, r0, wt + static_cast<long long>(t) * G * H + u, H, G);
#pragma unroll
      for (int r = 0; r < kTR; ++r) dh[(r0 + r) * H + u] = v[r];
    }
    __syncthreads();
  }
  float* part = a.partials + (static_cast<long long>(t) * g.tiles + tile) * (PA + 1);
  bw::tile_partials(acc, RG, PA, part);
  if (tid == 0) part[PA] = ahb;
}

template <bool BF16, bool GS>
int launch_kbw(int mode, const TrainArgs& a, int T, int H, int R, float* wt, float* state,
               long long wave, cudaStream_t st) {
  const int G = 4 * H, PA = 2 * G + H;
  bw::Grid g{H, R, (a.B + R - 1) / R, 0, state, 0};
  const int threads = wide::threads_for(H * (R / kTR));
  if (mode == 0) {
    const long long floats = bw::fwd_state(H, R, true, 1);
    g.stride = wide::state_stride(floats);
    const size_t smem = bw::fwd_small(R) + (GS ? 0 : floats * sizeof(float));
    return bw::launch_grid<GS>(lstm_train_wide_fwd<BF16, GS>, g, T, threads, smem, wave, st, a,
                               nullptr);
  }
  int err = bw::launch_transpose<BF16>(a.w[WH_W], wt, T, H, G, st);
  if (err != 0) return err;
  const long long floats = bw::bwd_state(H, R, true, 1, 4, PA);
  g.stride = wide::state_stride(floats);
  const size_t smem = bw::bwd_small(R, 1) + (GS ? 0 : floats * sizeof(float));
  err = bw::launch_grid<GS>(lstm_train_wide_bwd<BF16, GS>, g, T, threads, smem, wave, st, a, wt);
  if (err != 0) return err;
  return launch_tile_reduce(a, T, g.tiles, PA + 1, st);
}

template <bool GS>
int kbw_entry(int mode, const float* wx_w, const float* wx_b, const float* wh_w,
              const float* wh_b, const float* hd_w, const float* hd_b, const float* ring,
              const int* pos, const int* count, int S, const float* windows, int T, int B, int W,
              int H, int bf16, float* per_row, void* act, void* cst, void* hst, float* dhead,
              const float* g_row, void* dgates, float* partials, float* reduced, int R,
              float* wt, float* state, long long wave, void* stream) {
  if (T == 0 || B == 0) return static_cast<int>(cudaGetLastError());
  if (W < 2 || H < 1 || R < kTR || R % kTR != 0 || R > 32 || (mode != 0 && mode != 1) ||
      (mode == 1 && wt == nullptr) || (GS && (state == nullptr || wave < 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TrainArgs a{{wx_w, wx_b, wh_w, wh_b, hd_w, hd_b, nullptr, nullptr},
              ring, pos, count, S, windows, B, W, per_row, act, cst, hst, dhead,
              g_row, dgates, partials, reduced};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_bf16(bf16, [&](auto bf) {
    return launch_kbw<decltype(bf)::value, GS>(mode, a, T, H, R, wt, state, wave, st);
  });
}

}  // namespace

// As sw_lstm_train (lstm_train.cu), any H >= 1 and W >= 2, plus R (rows a
// block, a multiple of 8; models/flush.py train_route picks it) and wt,
// scratch f32[T, 4H, H] for the slots' wh^T (the backward writes it). The
// block state in shared memory.
extern "C" int sw_lstm_train_wide(int mode, const float* wx_w, const float* wx_b,
                                  const float* wh_w, const float* wh_b, const float* hd_w,
                                  const float* hd_b, const float* ring, const int* pos,
                                  const int* count, int S, const float* windows, int T, int B,
                                  int W, int H, int bf16, float* per_row, void* act, void* cst,
                                  void* hst, float* dhead, const float* g_row, void* dgates,
                                  float* partials, float* reduced, int R, float* wt,
                                  void* stream) {
  return kbw_entry<false>(mode, wx_w, wx_b, wh_w, wh_b, hd_w, hd_b, ring, pos, count, S, windows,
                          T, B, W, H, bf16, per_row, act, cst, hst, dhead, g_row, dgates,
                          partials, reduced, R, wt, nullptr, 0, stream);
}

// The global form: as sw_lstm_train_wide, the block state in `state`, a
// scratch of min(blocks, wave) x stride floats for this mode
// (models/flush.py train_state_floats; blocks = T x ceil(B / R)), blocks
// launched in waves of at most `wave`.
extern "C" int sw_lstm_train_global(int mode, const float* wx_w, const float* wx_b,
                                    const float* wh_w, const float* wh_b, const float* hd_w,
                                    const float* hd_b, const float* ring, const int* pos,
                                    const int* count, int S, const float* windows, int T, int B,
                                    int W, int H, int bf16, float* per_row, void* act, void* cst,
                                    void* hst, float* dhead, const float* g_row, void* dgates,
                                    float* partials, float* reduced, int R, float* wt,
                                    float* state, long long wave, void* stream) {
  return kbw_entry<true>(mode, wx_w, wx_b, wh_w, wh_b, hd_w, hd_b, ring, pos, count, S, windows,
                         T, B, W, H, bf16, per_row, act, cst, hst, dhead, g_row, dgates,
                         partials, reduced, R, wt, state, wave, stream);
}
