// KR gru_train: the DeepAR train form, KB's design (lstm_train.cu) with the
// GRU's 3H gate columns (r, z, n) and two heads. The forward mode writes
// each row's mean Gaussian NLL over its W-1 teacher-forced steps; the
// backward mode walks the steps in reverse from the masked per-slot mean's
// seed g_row.
//
// Replaces the XLA autodiff, forward and backward, of
//   sitewhere_tpu/models/deepar.py:97 _stacked_gru_scan and :165
//   loss_stacked (with models/common.py:142 normalize_windows), and in ring
//   mode sitewhere_tpu/ops/windows.py:143 gather_windows (ids = arange(S)),
// as the fused train step runs them (sitewhere_tpu/parallel/sharded.py:1111).
// dWh[s] = sum_{t,b} h_{t-1}^T dgh_t stays a torch.bmm (models/train.py).
//
// Forward: KD's arithmetic and bf16 rounding points (gru.cuh gru_gx,
// gru_gh, gru_cell_parts), every step's heads mu = bf16(bf16(h . w_mu) +
// b_mu), raw = bf16(bf16(h . w_sigma) + b_sigma), widened to f32, sigma =
// softplus(raw) + 1e-4, and the f32 NLL 0.5 log(2 pi sigma^2) + (t - mu)^2
// / (2 sigma^2). Saved per (step, row): r, z, n and nh (the recurrent n
// term, bh's part included) and h, in the compute dtype (exact: each is a
// rounded value of the forward), and the NLL's derivatives
// dNLL/dmu = -(t - mu) / sigma^2 and
// dNLL/draw = (1 / sigma - (t - mu)^2 / sigma^3) * sigmoid(raw)
// (softplus' derivative), f32. Backward, per step, with dh carried from
// the later step plus the heads' seed:
//   dn = dh (1 - z); dz = dh (h_{t-1} - n); dan = dn (1 - n^2);
//   dr = dan nh;     da_r = dr r (1 - r);   da_z = dz z (1 - z);
//   dgx = (da_r, da_z, dan); dgh = (da_r, da_z, dan r);
//   dh_{t-1} = dh z + dgh . wh^T.
// dwx, dbx, dbh, the heads' weights and biases are summed per tile, then
// over tiles by the second pass.
//
// Bound on the H100: operations. 3 x deepar_flops_per_row (0.7817 MFLOP at
// W=32, H=64) a row; at forecasting32's train plane (32 slots x 8192
// streams) 0.615 TFLOP, 0.62 ms at the 989 TFLOP/s bf16 tensor-core peak.
// This first version runs on the CUDA cores in f32 FMAs. Design: KB's
// (saves written once and read once; forward in KD's layout, a thread per
// gate column; backward with 256 threads, a thread per unit of 8 rows,
// wh^T and the tile's dgh in shared memory; zero-seed tiles leave early).
// Widths: one instantiation for each H of 8, 16, 32 and 64, the forward's
// 3H gate columns padded to whole warps as in KD; f32 master weights only,
// as KB.
#include "bptt.cuh"
#include "gru.cuh"

namespace {

constexpr int kRows = kTrainRows;

enum { WX_W, WX_B, WH_W, WH_B, MU_W, MU_B, SG_W, SG_B };

template <int H, bool BF16>
__global__ void __launch_bounds__(whole_warps(3 * H)) gru_train_fwd(const TrainArgs a) {
  constexpr int NT = 3 * H;             // gate columns (r, z, n)
  constexpr int NTP = whole_warps(NT);  // threads: the columns in whole warps
  constexpr int NW = NTP / 32;          // warps
  using HL = HeadLanes<H>;              // the heads' lanes: L a row, RPW rows a warp
  static_assert(H % 8 == 0 && NTP >= kRows, "tile shape");

  extern __shared__ float smem[];
  float* hs = smem;                // [kRows][H]
  float* gates = hs + kRows * H;   // [kRows][3H]: rx+rh, zx+zh, nh
  float* nxs = gates + kRows * NT; // [kRows][H]: nx
  float* xs = nxs + kRows * H;     // [kRows][W] normalized windows
  float* loss = xs + kRows * a.W;  // [kRows]

  const int t = blockIdx.y;
  const int b0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int W = a.W, B = a.B, steps = W - 1;
  train_tile_load(a, t, b0, xs);
  if (tid < kRows) loss[tid] = 0.0f;

  const int j = tid < NT ? tid : NT - 1;  // padding threads read column NT-1, write nothing
  const long long wo = static_cast<long long>(t) * NT + j;
  float wcol[H];
  const float* whp = a.w[WH_W] + static_cast<long long>(t) * H * NT;
#pragma unroll
  for (int k = 0; k < H; ++k) wcol[k] = rb<BF16>(whp[k * NT + j]);
  const float wxj = rb<BF16>(a.w[WX_W][wo]);
  const float bxj = rb<BF16>(a.w[WX_B][wo]);
  const float bhj = rb<BF16>(a.w[WH_B][wo]);
  const int warp = tid >> 5, lane = tid & 31;
  const int ul = lane % HL::L;  // this lane's first head unit
  float mw[HL::HQ], sw[HL::HQ];
#pragma unroll
  for (int q = 0; q < HL::HQ; ++q) {
    const long long i = static_cast<long long>(t) * H + ul + 32 * q;
    mw[q] = rb<BF16>(a.w[MU_W][i]);
    sw[q] = rb<BF16>(a.w[SG_W][i]);
  }
  const float mb = rb<BF16>(a.w[MU_B][t]);
  const float sb = rb<BF16>(a.w[SG_B][t]);

  for (int e = tid; e < kRows * H; e += NTP) hs[e] = 0.0f;
  __syncthreads();

  for (int s = 0; s < steps; ++s) {
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
      const GruParts c = gru_cell_parts<BF16>(gr[u], gr[H + u], nxs[e], gr[2 * H + u], hs[e]);
      hs[e] = c.h;
      const int b = b0 + r;
      if (b < B) {
        const long long row = (static_cast<long long>(t) * steps + s) * B + b;
        save<BF16>(a.act, row * 4 * H + u, c.r);
        save<BF16>(a.act, row * 4 * H + H + u, c.z);
        save<BF16>(a.act, row * 4 * H + 2 * H + u, c.n);
        save<BF16>(a.act, row * 4 * H + 3 * H + u, gr[2 * H + u]);
        save<BF16>(a.hst, row * H + u, c.h);
      }
    }
    __syncthreads();
    // heads on every step: the NLL of x[s + 1] and its derivatives
    for (int r0 = warp * HL::RPW; r0 < kRows; r0 += NW * HL::RPW) {
      const int r = r0 + lane / HL::L;
      float pm = 0.0f, ps = 0.0f;
#pragma unroll
      for (int q = 0; q < HL::HQ; ++q) {
        const float hv = hs[r * H + ul + 32 * q];
        pm = fmaf(hv, mw[q], pm);
        ps = fmaf(hv, sw[q], ps);
      }
      group_sum2<HL::L>(pm, ps);
      const int b = b0 + r;
      if (ul == 0 && b < B) {
        const float mu = rb<BF16>(__fadd_rn(rb<BF16>(pm), mb));
        const float raw = rb<BF16>(__fadd_rn(rb<BF16>(ps), sb));
        const float sigma = gauss_sigma(raw);
        const float tg = xs[r * W + s + 1];
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
  if (tid < kRows && b0 + tid < B) {
    a.per_row[static_cast<long long>(t) * B + b0 + tid] =
        __fdiv_rn(loss[tid], static_cast<float>(steps));
  }
}

template <int H, bool BF16>
__global__ void __launch_bounds__(kBwdThreads) gru_train_bwd(const TrainArgs a) {
  constexpr int G = 3 * H;                 // gate columns
  constexpr int RG = BwdTile<H, G>::RG;    // row groups
  constexpr int PER = BwdTile<H, G>::PER;  // rows per thread
  constexpr int P = 3 * G + 2 * H + 2;     // dwx | dbx | dbh | dmu_w | dsg_w | dmu_b | dsg_b
  constexpr int DG = BwdTile<H, G>::dg(RG * (3 * G + 2 * H));

  extern __shared__ float smem[];
  float* whT = smem;               // [G][H]
  float* dG = whT + G * H;         // [kRows][G]: this step's dgh (DG floats)
  float* dh = dG + DG;             // [kRows][H]
  float* xs = dh + kRows * H;      // [kRows][W]
  float* dpm = xs + kRows * a.W;   // [kRows]: this step's dmu
  float* dps = dpm + kRows;        // [kRows]: this step's draw

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
  const float mw = rb<BF16>(a.w[MU_W][static_cast<long long>(t) * H + u]);
  const float sw = rb<BF16>(a.w[SG_W][static_cast<long long>(t) * H + u]);
  const float inv = 1.0f / static_cast<float>(steps);

  float adx[3], adh[3], awx[3], amw = 0.0f, asw = 0.0f, amb = 0.0f, asb = 0.0f;
#pragma unroll
  for (int g = 0; g < 3; ++g) adx[g] = adh[g] = awx[g] = 0.0f;
  __syncthreads();

  for (int s = steps - 1; s >= 0; --s) {
    if (tid < kRows) {
      const int b = b0 + tid;
      float m = 0.0f, r = 0.0f;
      if (b < B) {
        const float sc = a.g_row[static_cast<long long>(t) * B + b] * inv;
        const float* d = a.dhead + ((static_cast<long long>(t) * B + b) * steps + s) * 2;
        m = sc * d[0];
        r = sc * d[1];
      }
      dpm[tid] = m;
      dps[tid] = r;
    }
    __syncthreads();
    if (tid == 0) {
      for (int r = 0; r < kRows; ++r) {
        amb += dpm[r];
        asb += dps[r];
      }
    }
    float dd[PER];  // dh_{t-1}'s direct term dh z
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int r = rg + RG * q, b = b0 + r;
      float gx[3] = {0.0f, 0.0f, 0.0f}, gh[3] = {0.0f, 0.0f, 0.0f};
      dd[q] = 0.0f;
      if (b < B) {
        const long long row = (static_cast<long long>(t) * steps + s) * B + b;
        const float rr = saved<BF16>(a.act, row * 4 * H + u);
        const float zz = saved<BF16>(a.act, row * 4 * H + H + u);
        const float nn = saved<BF16>(a.act, row * 4 * H + 2 * H + u);
        const float nh = saved<BF16>(a.act, row * 4 * H + 3 * H + u);
        const float h = saved<BF16>(a.hst, row * H + u);
        const float hp = s > 0 ? saved<BF16>(a.hst, (row - B) * H + u) : 0.0f;
        const float dhv = dh[r * H + u] + dpm[r] * mw + dps[r] * sw;
        amw += dpm[r] * h;
        asw += dps[r] * h;
        dd[q] = dhv * zz;
        const float dan = dhv * (1.0f - zz) * (1.0f - nn * nn);
        gx[0] = gh[0] = dan * nh * rr * (1.0f - rr);
        gx[1] = gh[1] = dhv * (hp - nn) * zz * (1.0f - zz);
        gx[2] = dan;
        gh[2] = dan * rr;
        const float x = rb<BF16>(xs[r * W + s]);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          save<BF16>(a.dgates, row * G + k * H + u, gh[k]);
          adx[k] += gx[k];
          adh[k] += gh[k];
          awx[k] = fmaf(x, gx[k], awx[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) dG[r * G + k * H + u] = gh[k];
    }
    __syncthreads();
    recurrent_grad<H, G>(dG, whT, rg, u, dd);
#pragma unroll
    for (int q = 0; q < PER; ++q) dh[(rg + RG * q) * H + u] = dd[q];
    __syncthreads();
  }

  float* red = dG;  // [3][RG][G] then [2][RG][H]
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    red[rg * G + k * H + u] = awx[k];
    red[RG * G + rg * G + k * H + u] = adx[k];
    red[2 * RG * G + rg * G + k * H + u] = adh[k];
  }
  red[3 * RG * G + rg * H + u] = amw;
  red[3 * RG * G + RG * H + rg * H + u] = asw;
  __syncthreads();
  float* part = a.partials + (static_cast<long long>(t) * gridDim.x + tile) * P;
  for (int jj = tid; jj < G; jj += kBwdThreads) {
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
    for (int k = 0; k < RG; ++k) {
      s0 += red[k * G + jj];
      s1 += red[RG * G + k * G + jj];
      s2 += red[2 * RG * G + k * G + jj];
    }
    part[jj] = s0;
    part[G + jj] = s1;
    part[2 * G + jj] = s2;
  }
  if (tid < H) {
    float s0 = 0.0f, s1 = 0.0f;
    for (int k = 0; k < RG; ++k) {
      s0 += red[3 * RG * G + k * H + tid];
      s1 += red[3 * RG * G + RG * H + k * H + tid];
    }
    part[3 * G + tid] = s0;
    part[3 * G + H + tid] = s1;
  }
  if (tid == 0) {
    part[3 * G + 2 * H] = amb;
    part[3 * G + 2 * H + 1] = asb;
  }
}

template <int H, bool BF16>
int launch_kr(int mode, const TrainArgs& a, int T, cudaStream_t st) {
  const int tiles = (a.B + kRows - 1) / kRows;
  const dim3 grid(tiles, T);
  if (mode == 0) {
    const size_t smem = (static_cast<size_t>(kRows) * (H + 3 * H + H + a.W) + kRows) * sizeof(float);
    int err = set_smem(gru_train_fwd<H, BF16>, smem);
    if (err != 0) return err;
    gru_train_fwd<H, BF16><<<grid, whole_warps(3 * H), smem, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  constexpr int G = 3 * H;
  constexpr int DG = BwdTile<H, G>::dg(BwdTile<H, G>::RG * (3 * G + 2 * H));
  const size_t smem =
      (static_cast<size_t>(G) * H + DG + kRows * (H + a.W) + 2 * kRows) * sizeof(float);
  int err = set_smem(gru_train_bwd<H, BF16>, smem);
  if (err != 0) return err;
  gru_train_bwd<H, BF16><<<grid, kBwdThreads, smem, st>>>(a);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return launch_tile_reduce(a, T, tiles, 3 * G + 2 * H + 2, st);
}

}  // namespace

// mode 0: forward (per_row, act, hst, dhead out); mode 1: backward (g_row
// and the saves in; dgates, partials, reduced out). cst is unused. H is one
// of 8, 16, 32, 64.
extern "C" int sw_gru_train(int mode, const float* wx_w, const float* wx_b, const float* wh_w,
                            const float* wh_b, const float* mu_w, const float* mu_b,
                            const float* sg_w, const float* sg_b, const float* ring,
                            const int* pos, const int* count, int S, const float* windows, int T,
                            int B, int W, int H, int bf16, float* per_row, void* act, void* cst,
                            void* hst, float* dhead, const float* g_row, void* dgates,
                            float* partials, float* reduced, void* stream) {
  if (T == 0 || B == 0) return static_cast<int>(cudaGetLastError());
  if (W < 2 || (mode != 0 && mode != 1)) return static_cast<int>(cudaErrorInvalidValue);
  TrainArgs a{{wx_w, wx_b, wh_w, wh_b, mu_w, mu_b, sg_w, sg_b},
              ring, pos, count, S, windows, B, W, per_row, act, cst, hst, dhead,
              g_row, dgates, partials, reduced};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_bf16(bf16, [&](auto bf) {
    return by_hidden(H, [&](auto h) {
      return launch_kr<decltype(h)::value, decltype(bf)::value>(mode, a, T, st);
    });
  });
}
