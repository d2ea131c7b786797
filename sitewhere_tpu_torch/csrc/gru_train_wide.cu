// KR gru_train, wide form: the DeepAR train form (window gather or read,
// normalization, the stacked GRU scan with both heads on every step, the
// per-row Gaussian NLL; and its BPTT backward) at any hidden and any window.
//
// Replaces what gru_train.cu replaces (the XLA autodiff, forward and
// backward, of sitewhere_tpu/models/deepar.py:97 _stacked_gru_scan and :165
// loss_stacked, with models/common.py:142 normalize_windows and, in ring
// mode, sitewhere_tpu/ops/windows.py:143 gather_windows; as
// sitewhere_tpu/parallel/sharded.py:1111 runs them) at the shapes the
// templated KR does not take: hidden outside 8/16/32/64 (GluonTS
// DeepAREstimator's num_cells=40, ...) and windows whose tiles no longer fit
// shared memory (models/flush.py train_route). Same arguments as KB's wide
// form (lstm_train_wide.cu), the same saves in the same layouts as
// gru_train.cu (r, z, n, nh and h; the heads' two derivatives).
//
// Forward rounding: gru_train.cu's (KD's, gru.cuh gru_gx, gru_gh,
// gru_cell_parts; the heads' mu and raw rounded as KD rounds them); the dot
// products accumulate in f32 in k order (wide::item_dots). Backward:
// gru_train.cu's f32 arithmetic, per step and row, dh carried from the
// later step plus the heads' seeds:
//   dn = dh (1 - z); dz = dh (h_{t-1} - n); dan = dn (1 - n^2);
//   da_r = dan nh r (1 - r); da_z = dz z (1 - z);
//   dgx = (da_r, da_z, dan); dgh = (da_r, da_z, dan r);
//   dh_{t-1} = dh z + dgh . wh^T.
//
// Bound on the H100: operations. 3 x deepar_flops_per_row (1.91 MFLOP a
// row forward at H 40, W 192): 1.50 TFLOP at forecasting32's train plane,
// 1.52 ms at the 989 TFLOP/s bf16 tensor-core peak; this first version
// runs on the CUDA cores in f32 FMAs.
// Design: bptt_wide.cuh. An item is one unit's r, z and n columns (u,
// H + u, 2H + u) for 8 rows. H need not be a multiple of 8 or 32: items
// map u = i % H, so a warp may span two row groups; the heads' dots are a
// warp per row over lanes u = lane, lane + 32, ... (H 40: 32 + 8 lanes).
// The block state sits in shared memory (the wide form, hidden up to
// 1,017) or in a global scratch (the global form, sw_gru_train_global):
// the same kernels, any hidden.
#include "bptt_wide.cuh"

namespace {

using bw::kTR;

enum { WX_W, WX_B, WH_W, WH_B, MU_W, MU_B, SG_W, SG_B };

template <bool BF16, bool GS>
__global__ void __launch_bounds__(wide::kMaxThreads)
gru_train_wide_fwd(const TrainArgs a, const bw::Grid g, const float*) {
  const int H = g.H, R = g.R, RS = R + 4, W = a.W, B = a.B, G = 3 * H, steps = W - 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  wide::RowSrc* srcs = reinterpret_cast<wide::RowSrc*>(smem_raw);  // [R]
  float* xb = reinterpret_cast<float*>(srcs + R);  // [2][R] normalized x of a step
  float* loss = xb + 2 * R;                        // [R] summed NLLs
  float* hT = wide::block_state<GS>(loss + R, g.state, g.stride);  // [2][H][RS]
  float* mw = hT + 2 * H * RS;                     // [H] mu head
  float* sw = mw + H;                              // [H] sigma head

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
  for (int u = tid; u < H; u += nth) {
    const long long i = static_cast<long long>(t) * H + u;
    mw[u] = rb<BF16>(a.w[MU_W][i]);
    sw[u] = rb<BF16>(a.w[SG_W][i]);
  }
  const float mb = rb<BF16>(a.w[MU_B][t]);
  const float sb = rb<BF16>(a.w[SG_B][t]);
  __syncthreads();

  const int items = H * (R / kTR);
  const int warp = tid >> 5, lane = tid & 31, nwarps = nth >> 5;
  const long long wbase = static_cast<long long>(t) * H * G;
  const float unit[3] = {1.0f, 1.0f, 1.0f};  // f32 masters: no int8 scales
  for (int s = 0; s < steps; ++s) {
    const float* hc = hT + (s & 1) * H * RS;
    float* hn = hT + ((s + 1) & 1) * H * RS;
    const float* xc = xb + (s & 1) * R;
    for (int i = tid; i < items; i += nth) {
      const int u = i % H, r0 = (i / H) * kTR;
      const long long c0 = static_cast<long long>(t) * G + u;
      float wxq[3], bxq[3], bhq[3];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const long long c = c0 + static_cast<long long>(q) * H;
        wxq[q] = rb<BF16>(a.w[WX_W][c]);
        bxq[q] = rb<BF16>(a.w[WX_B][c]);
        bhq[q] = rb<BF16>(a.w[WH_B][c]);
      }
      float acc[3][kTR];
      wide::item_dots<3, WF_F32, BF16>(acc, hc + r0, RS, a.w[WH_W], wbase, H, u, unit);
      float hv[kTR];
#pragma unroll
      for (int r = 0; r < kTR; ++r) {
        const float x = xc[r0 + r];
        const float gr = rb<BF16>(__fadd_rn(gru_gx<BF16>(x, wxq[0], bxq[0]),
                                            gru_gh<BF16>(acc[0][r], bhq[0])));
        const float gz = rb<BF16>(__fadd_rn(gru_gx<BF16>(x, wxq[1], bxq[1]),
                                            gru_gh<BF16>(acc[1][r], bhq[1])));
        const float nx = gru_gx<BF16>(x, wxq[2], bxq[2]);
        const float nh = gru_gh<BF16>(acc[2][r], bhq[2]);
        const GruParts c = gru_cell_parts<BF16>(gr, gz, nx, nh, hc[u * RS + r0 + r]);
        hv[r] = c.h;
        const int b = b0 + r0 + r;
        if (b < B) {
          const long long row = (static_cast<long long>(t) * steps + s) * B + b;
          save<BF16>(a.act, row * 4 * H + u, c.r);
          save<BF16>(a.act, row * 4 * H + H + u, c.z);
          save<BF16>(a.act, row * 4 * H + 2 * H + u, c.n);
          save<BF16>(a.act, row * 4 * H + 3 * H + u, nh);
          save<BF16>(a.hst, row * H + u, c.h);
        }
      }
      bw::put_rows(hn, u, RS, r0, hv);
    }
    // the next step's input, which is also this step's target
    if (tid < R) xb[((s + 1) & 1) * R + tid] = wide::normed_at(srcs[tid], W, s + 1);
    __syncthreads();
    // heads on every step: the NLL of x[s + 1] and its derivatives
    const float* target = xb + ((s + 1) & 1) * R;
    for (int r = warp; r < R; r += nwarps) {
      const int b = b0 + r;
      if (b >= B) continue;  // warp-uniform
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
        const float raw = rb<BF16>(__fadd_rn(rb<BF16>(ps), sb));
        const float sigma = gauss_sigma(raw);
        const float tg = target[r];
        loss[r] = __fadd_rn(loss[r], gaussian_nll(tg, mu, sigma));
        const float d = tg - mu, s2 = sigma * sigma;
        const float dsig = 1.0f / sigma - d * d / (s2 * sigma);
        float* out = a.dhead + ((static_cast<long long>(t) * B + b) * steps + s) * 2;
        out[0] = -d / s2;
        out[1] = dsig / (1.0f + expf(-raw));
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
gru_train_wide_bwd(const TrainArgs a, const bw::Grid g, const float* wt) {
  const int H = g.H, R = g.R, RS = R + 4, W = a.W, B = a.B, G = 3 * H, steps = W - 1;
  const int RG = R / kTR;
  const int PA = 3 * G + 2 * H;  // a row group's sums: dwx | dbx | dbh | dmu_w | dsigma_w
  extern __shared__ __align__(16) unsigned char smem_raw[];
  wide::RowSrc* srcs = reinterpret_cast<wide::RowSrc*>(smem_raw);  // [R]
  float* dpm = reinterpret_cast<float*>(srcs + R);  // [2][R]: a step's dmu
  float* dps = dpm + 2 * R;                         // [2][R]: a step's draw
  float* xv = dps + 2 * R;                          // [2][R]: a step's input x
  float* dGT = wide::block_state<GS>(xv + 2 * R, g.state, g.stride);  // [G][RS]: dgh
  float* dh = dGT + G * RS;                         // [R][H]: dh from the later step
  float* acc = dh + R * H;                          // [RG][PA]
  float* mw = acc + RG * PA;                        // [H]
  float* sw = mw + H;                               // [H]

  int t, tile;
  bw::block_tile(g, t, tile);
  const int b0 = tile * R;
  const int tid = threadIdx.x, nth = blockDim.x;
  if (!bw::tile_live(a, t, b0, R)) {
    bw::zero_rows<BF16>(a, t, tile, g.tiles, b0, R, G, PA + 2);
    return;
  }
  bw::load_srcs(a, t, b0, R, srcs);
  for (int e = tid; e < R * H; e += nth) dh[e] = 0.0f;
  for (int e = tid; e < RG * PA; e += nth) acc[e] = 0.0f;
  for (int u = tid; u < H; u += nth) {
    const long long i = static_cast<long long>(t) * H + u;
    mw[u] = rb<BF16>(a.w[MU_W][i]);
    sw[u] = rb<BF16>(a.w[SG_W][i]);
  }
  const float inv = 1.0f / static_cast<float>(steps);
  __syncthreads();
  // step s's seeds and input, into buffer s & 1
  auto stage = [&](int s) {
    if (tid < R) {
      const int b = b0 + tid;
      float m = 0.0f, r = 0.0f;
      if (b < B) {
        const float sc = a.g_row[static_cast<long long>(t) * B + b] * inv;
        const float* d = a.dhead + ((static_cast<long long>(t) * B + b) * steps + s) * 2;
        m = sc * d[0];
        r = sc * d[1];
      }
      dpm[(s & 1) * R + tid] = m;
      dps[(s & 1) * R + tid] = r;
      xv[(s & 1) * R + tid] = rb<BF16>(wide::normed_at(srcs[tid], W, s));
    }
  };
  stage(steps - 1);
  __syncthreads();

  const int items = H * RG;
  float amb = 0.0f, asb = 0.0f;  // thread 0: d mu.b, d sigma.b
  for (int s = steps - 1; s >= 0; --s) {
    const float* dm = dpm + (s & 1) * R;
    const float* ds = dps + (s & 1) * R;
    const float* xs = xv + (s & 1) * R;
    if (tid == 0) {
      for (int r = 0; r < R; ++r) {
        amb += dm[r];
        asb += ds[r];
      }
    }
    for (int i = tid; i < items; i += nth) {
      const int u = i % H, rg = i / H, r0 = rg * kTR;
      const float mwu = mw[u], swu = sw[u];
      float gT[3][kTR], adx[3] = {0.0f, 0.0f, 0.0f}, adh[3] = {0.0f, 0.0f, 0.0f};
      float awx[3] = {0.0f, 0.0f, 0.0f}, amw = 0.0f, asw = 0.0f;
#pragma unroll
      for (int r = 0; r < kTR; ++r) {
        const int rr = r0 + r, b = b0 + rr;
        float gx[3] = {0.0f, 0.0f, 0.0f}, gh[3] = {0.0f, 0.0f, 0.0f}, dd = 0.0f;
        if (b < B) {
          const long long row = (static_cast<long long>(t) * steps + s) * B + b;
          const float rv = saved<BF16>(a.act, row * 4 * H + u);
          const float zz = saved<BF16>(a.act, row * 4 * H + H + u);
          const float nn = saved<BF16>(a.act, row * 4 * H + 2 * H + u);
          const float nh = saved<BF16>(a.act, row * 4 * H + 3 * H + u);
          const float h = saved<BF16>(a.hst, row * H + u);
          const float hp = s > 0 ? saved<BF16>(a.hst, (row - B) * H + u) : 0.0f;
          const float dhv = dh[rr * H + u] + dm[rr] * mwu + ds[rr] * swu;
          amw += dm[rr] * h;
          asw += ds[rr] * h;
          dd = dhv * zz;
          const float dan = dhv * (1.0f - zz) * (1.0f - nn * nn);
          gx[0] = gh[0] = dan * nh * rv * (1.0f - rv);
          gx[1] = gh[1] = dhv * (hp - nn) * zz * (1.0f - zz);
          gx[2] = dan;
          gh[2] = dan * rv;
          const float x = xs[rr];
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            save<BF16>(a.dgates, row * G + k * H + u, gh[k]);
            adx[k] += gx[k];
            adh[k] += gh[k];
            awx[k] = fmaf(x, gx[k], awx[k]);
          }
        }
        dh[rr * H + u] = dd;  // dh_{t-1}'s direct term, read back below
#pragma unroll
        for (int k = 0; k < 3; ++k) gT[k][r] = gh[k];
      }
      float* ac = acc + rg * PA;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        bw::put_rows(dGT, k * H + u, RS, r0, gT[k]);
        ac[k * H + u] += awx[k];
        ac[G + k * H + u] += adx[k];
        ac[2 * G + k * H + u] += adh[k];
      }
      ac[3 * G + u] += amw;
      ac[3 * G + H + u] += asw;
    }
    if (s > 0) stage(s - 1);
    __syncthreads();
    // dh_{t-1} = dh z + dgh . wh^T, each item for its unit and rows
    for (int i = tid; i < items; i += nth) {
      const int u = i % H, r0 = (i / H) * kTR;
      float v[kTR];
#pragma unroll
      for (int r = 0; r < kTR; ++r) v[r] = dh[(r0 + r) * H + u];
      bw::item_rgrad(v, dGT, RS, r0, wt + static_cast<long long>(t) * G * H + u, H, G);
#pragma unroll
      for (int r = 0; r < kTR; ++r) dh[(r0 + r) * H + u] = v[r];
    }
    __syncthreads();
  }
  float* part = a.partials + (static_cast<long long>(t) * g.tiles + tile) * (PA + 2);
  bw::tile_partials(acc, RG, PA, part);
  if (tid == 0) {
    part[PA] = amb;
    part[PA + 1] = asb;
  }
}

template <bool BF16, bool GS>
int launch_krw(int mode, const TrainArgs& a, int T, int H, int R, float* wt, float* state,
               long long wave, cudaStream_t st) {
  const int G = 3 * H, PA = 3 * G + 2 * H;
  bw::Grid g{H, R, (a.B + R - 1) / R, 0, state, 0};
  const int threads = wide::threads_for(H * (R / kTR));
  if (mode == 0) {
    const long long floats = bw::fwd_state(H, R, false, 2);
    g.stride = wide::state_stride(floats);
    const size_t smem = bw::fwd_small(R) + (GS ? 0 : floats * sizeof(float));
    return bw::launch_grid<GS>(gru_train_wide_fwd<BF16, GS>, g, T, threads, smem, wave, st, a,
                               nullptr);
  }
  int err = bw::launch_transpose<BF16>(a.w[WH_W], wt, T, H, G, st);
  if (err != 0) return err;
  const long long floats = bw::bwd_state(H, R, false, 2, 3, PA);
  g.stride = wide::state_stride(floats);
  const size_t smem = bw::bwd_small(R, 2) + (GS ? 0 : floats * sizeof(float));
  err = bw::launch_grid<GS>(gru_train_wide_bwd<BF16, GS>, g, T, threads, smem, wave, st, a, wt);
  if (err != 0) return err;
  return launch_tile_reduce(a, T, g.tiles, PA + 2, st);
}

template <bool GS>
int krw_entry(int mode, const float* wx_w, const float* wx_b, const float* wh_w,
              const float* wh_b, const float* mu_w, const float* mu_b, const float* sg_w,
              const float* sg_b, const float* ring, const int* pos, const int* count, int S,
              const float* windows, int T, int B, int W, int H, int bf16, float* per_row,
              void* act, void* cst, void* hst, float* dhead, const float* g_row, void* dgates,
              float* partials, float* reduced, int R, float* wt, float* state, long long wave,
              void* stream) {
  if (T == 0 || B == 0) return static_cast<int>(cudaGetLastError());
  if (W < 2 || H < 1 || R < kTR || R % kTR != 0 || R > 32 || (mode != 0 && mode != 1) ||
      (mode == 1 && wt == nullptr) || (GS && (state == nullptr || wave < 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TrainArgs a{{wx_w, wx_b, wh_w, wh_b, mu_w, mu_b, sg_w, sg_b},
              ring, pos, count, S, windows, B, W, per_row, act, cst, hst, dhead,
              g_row, dgates, partials, reduced};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_bf16(bf16, [&](auto bf) {
    return launch_krw<decltype(bf)::value, GS>(mode, a, T, H, R, wt, state, wave, st);
  });
}

}  // namespace

// As sw_gru_train (gru_train.cu), any H >= 1 and W >= 2, plus R (rows a
// block, a multiple of 8 up to 32; models/flush.py train_route picks it)
// and wt, scratch f32[T, 3H, H] for the slots' wh^T (the backward writes
// it). cst is unused. The block state in shared memory.
extern "C" int sw_gru_train_wide(int mode, const float* wx_w, const float* wx_b,
                                 const float* wh_w, const float* wh_b, const float* mu_w,
                                 const float* mu_b, const float* sg_w, const float* sg_b,
                                 const float* ring, const int* pos, const int* count, int S,
                                 const float* windows, int T, int B, int W, int H, int bf16,
                                 float* per_row, void* act, void* cst, void* hst, float* dhead,
                                 const float* g_row, void* dgates, float* partials,
                                 float* reduced, int R, float* wt, void* stream) {
  return krw_entry<false>(mode, wx_w, wx_b, wh_w, wh_b, mu_w, mu_b, sg_w, sg_b, ring, pos, count,
                          S, windows, T, B, W, H, bf16, per_row, act, cst, hst, dhead, g_row,
                          dgates, partials, reduced, R, wt, nullptr, 0, stream);
}

// The global form: as sw_gru_train_wide, the block state in `state`, a
// scratch of min(blocks, wave) x stride floats for this mode
// (models/flush.py train_state_floats), blocks launched in waves of at
// most `wave`.
extern "C" int sw_gru_train_global(int mode, const float* wx_w, const float* wx_b,
                                   const float* wh_w, const float* wh_b, const float* mu_w,
                                   const float* mu_b, const float* sg_w, const float* sg_b,
                                   const float* ring, const int* pos, const int* count, int S,
                                   const float* windows, int T, int B, int W, int H, int bf16,
                                   float* per_row, void* act, void* cst, void* hst,
                                   float* dhead, const float* g_row, void* dgates,
                                   float* partials, float* reduced, int R, float* wt,
                                   float* state, long long wave, void* stream) {
  return krw_entry<true>(mode, wx_w, wx_b, wh_w, wh_b, mu_w, mu_b, sg_w, sg_b, ring, pos, count,
                         S, windows, T, B, W, H, bf16, per_row, act, cst, hst, dhead, g_row,
                         dgates, partials, reduced, R, wt, state, wave, stream);
}
