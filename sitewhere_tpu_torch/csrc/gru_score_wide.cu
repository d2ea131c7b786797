// KD gru_score, wide form: the DeepAR scoring flush (window gather,
// normalization, stacked GRU scan, the (mu, sigma) heads, Gaussian NLL,
// column select, mask and wire cast) at any hidden and any window.
//
// Replaces what gru_score.cu replaces (sitewhere_tpu/ops/windows.py:143,
// sitewhere_tpu/models/deepar.py:97 _stacked_gru_scan and :128
// score_stacked, parallel/sharded.py:564-580) at the shapes the templated
// KD does not take: hidden outside 8/16/32/64 (GluonTS DeepAREstimator's
// num_cells=40 default, 96, 128, 256, ...) and windows past its shared
// memory (the DeepAR paper's 168-point conditioning range and longer;
// models/flush.py scan_route). Same two modes, same arguments (plus R),
// same rounding points (gru_score.cu, gru.cuh).
//
// Bound on the H100: operations, 2 * 3H * H FLOP a row and step; CUDA-core
// f32 FMAs, wh streamed from L1/L2 each step (scan_wide.cuh).
// Design: scan_wide.cuh. An item is one hidden unit's r, z and n columns
// for 8 rows (wide::gru_item), so its thread runs the cell update; one
// barrier a step. The two heads' dots are a warp per row. The block state
// (hT, the heads' weights) sits in shared memory (the wide form, hidden up
// to 2,231) or, in the global form (sw_gru_score_global), in a global
// scratch: the same kernel, any hidden.
#include "scan_wide.cuh"

namespace {

using wide::kTR;

struct KdwArgs {
  const void* wx_w; const float* wx_b; const void* wh_w; const float* wh_b;
  const void* mu_w; const float* mu_b; const void* sg_w; const float* sg_b;
  const float* wx_s; const float* wh_s; const float* mu_s; const float* sg_s;  // int8 scales
  const float* ring; const int* pos; const int* count; int S;
  const void* ids; int id_kind;
  const float* windows; const int* n_valid;
  const int* later; const unsigned char* active; const int* counts;
  const unsigned char* mask;
  void* out; int out_kind;
  int B; int W; int K; int H; int R;
  int tiles; long long blk0;  // row tiles a slot; this wave's first block
  float* state; long long stride;  // the global form's scratch, floats a block
};

// Floats of a block's state: hT [2][H][RS], the mu and sigma heads [H] each.
inline long long kdw_state_floats(int H, int R) {
  return 2LL * H * (R + 4) + 2LL * H;
}

template <bool BF16, int WF, bool GS>
__global__ void __launch_bounds__(wide::kMaxThreads)
gru_score_wide_kernel(const KdwArgs a) {
  const int H = a.H, R = a.R, RS = R + 4, W = a.W, K = a.K, B = a.B;
  const int G = 3 * H;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  wide::RowSrc* srcs = reinterpret_cast<wide::RowSrc*>(smem_raw);  // [R]
  float* xb = reinterpret_cast<float*>(srcs + R);  // [2][R] normalized x of a step
  int* nrow = reinterpret_cast<int*>(xb + 2 * R);  // samples per row
  int* colr = nrow + R;                            // selected column, -1 = all K
  int* liver = colr + R;                           // row is scored (else 0)
  float* hT = wide::block_state<GS>(reinterpret_cast<float*>(liver + R), a.state,
                                    a.stride);     // [2][H][RS]
  float* mw = hT + 2 * H * RS;                     // [H] mu head
  float* sw = mw + H;                              // [H] sigma head

  const long long blk = a.blk0 + blockIdx.x;
  const int t = static_cast<int>(blk / a.tiles);
  const int b0 = static_cast<int>(blk % a.tiles) * R;
  const int tid = threadIdx.x, nth = blockDim.x;
  const bool select = a.later != nullptr;
  const long long rowbase = static_cast<long long>(t) * B;

  bool live = false;
  if (tid < R) {
    const int b = b0 + tid;
    wide::RowSrc src = wide::pad_row(W);
    int n = 0, col = -1;
    if (b < B) live = wide::row_prologue(a, t, b, src, n, col);
    srcs[tid] = src;
    nrow[tid] = n;
    colr[tid] = col;
    liver[tid] = live ? 1 : 0;
    xb[tid] = wide::normed_at(src, W, 0);
  }
  if (!__syncthreads_or(live)) {
    if (select && tid < R && b0 + tid < B) store_val(a.out, a.out_kind, rowbase + b0 + tid, 0.0f);
    return;
  }
  for (int e = tid; e < 2 * H * RS; e += nth) hT[e] = 0.0f;
  for (int u = tid; u < H; u += nth) {
    const long long i = static_cast<long long>(t) * H + u;
    mw[u] = wload<WF, BF16>(a.mu_w, a.mu_s, i, t);
    sw[u] = wload<WF, BF16>(a.sg_w, a.sg_s, i, t);
  }
  const float mb = rb<BF16>(a.mu_b[t]);
  const float sb = rb<BF16>(a.sg_b[t]);
  __syncthreads();

  const int items = H * (R / kTR), steps = W - 1;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nth >> 5;
  const long long wbase = static_cast<long long>(t) * H * G;
  for (int s = 0; s < steps; ++s) {
    const float* hc = hT + (s & 1) * H * RS;
    float* hn = hT + ((s + 1) & 1) * H * RS;
    const float* xc = xb + (s & 1) * R;
    for (int i = tid; i < items; i += nth) {
      const int u = i % H, r0 = (i / H) * kTR;
      wide::gru_item<WF, BF16>(a.wx_w, a.wx_s, a.wx_b, a.wh_w, a.wh_s, a.wh_b,
                               static_cast<long long>(t) * G + u, wbase, H, u, r0, RS, hc, xc,
                               hn);
    }
    // the next step's input, which is also this step's target
    if (tid < R) xb[((s + 1) & 1) * R + tid] = wide::normed_at(srcs[tid], W, s + 1);
    __syncthreads();
    if (s < steps - K) continue;
    // heads on the last K states: the NLL of the normalized target
    const int jcol = s - (steps - K);
    const float* target = xb + ((s + 1) & 1) * R;
    for (int r = warp; r < R; r += nwarps) {
      const int b = b0 + r;
      if (b >= B || (colr[r] >= 0 && colr[r] != jcol)) continue;  // warp-uniform
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
        const float nll = gaussian_nll(target[r], mu, sigma);
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

template <bool BF16, int WF, bool GS>
int launch_kdw(KdwArgs a, int T, long long wave, cudaStream_t stream) {
  const int R = a.R, H = a.H;
  const size_t small = R * sizeof(wide::RowSrc) + 2 * R * sizeof(float) + 3 * R * sizeof(int);
  const size_t smem = small + (GS ? 0 : kdw_state_floats(H, R) * sizeof(float));
  const int err = wide::prepare<GS>(gru_score_wide_kernel<BF16, WF, GS>, smem);
  if (err != 0) return err;
  a.tiles = (a.B + R - 1) / R;
  a.stride = wide::state_stride(kdw_state_floats(H, R));
  const long long blocks = static_cast<long long>(a.tiles) * T;
  return wide::in_waves(blocks, GS ? wave : blocks, [&](long long blk0, unsigned n) {
    a.blk0 = blk0;
    gru_score_wide_kernel<BF16, WF, GS>
        <<<n, wide::threads_for(H * (R / kTR)), smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  });
}

template <bool GS>
int kdw_entry(const void* wx_w, const float* wx_b, const void* wh_w, const float* wh_b,
              const void* mu_w, const float* mu_b, const void* sg_w, const float* sg_b,
              const float* wx_s, const float* wh_s, const float* mu_s, const float* sg_s, int wf,
              const float* ring, const int* pos, const int* count, int S, const void* ids,
              int id_kind, const float* windows, const int* n_valid, const int* later,
              const unsigned char* active, const int* counts, const unsigned char* mask,
              void* out, int out_kind, int T, int B, int W, int H, int K, int bf16, int R,
              float* state, long long wave, void* stream) {
  if (T == 0 || B == 0) return static_cast<int>(cudaGetLastError());
  if (W < 2 || K < 1 || K > W - 1 || H < 1 || R < kTR || R % kTR != 0 ||
      (wf == WF_I8 && (!wx_s || !wh_s || !mu_s || !sg_s)) ||
      (GS && (state == nullptr || wave < 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  KdwArgs a{wx_w, wx_b, wh_w, wh_b, mu_w, mu_b, sg_w, sg_b, wx_s, wh_s, mu_s, sg_s, ring, pos,
            count, S, ids, id_kind, windows, n_valid, later, active, counts, mask, out, out_kind,
            B, W, K, H, R, 0, 0, state, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_bf16(bf16, [&](auto b) {
    return by_format(wf, [&](auto f) {
      return launch_kdw<decltype(b)::value, decltype(f)::value, GS>(a, T, wave, st);
    });
  });
}

}  // namespace

// As sw_gru_score (gru_score.cu), any H >= 1 and W >= 2, plus R: rows a
// block (a multiple of 8; models/flush.py wide_rows picks it). The block
// state in shared memory.
extern "C" int sw_gru_score_wide(const void* wx_w, const float* wx_b, const void* wh_w,
                                 const float* wh_b, const void* mu_w, const float* mu_b,
                                 const void* sg_w, const float* sg_b, const float* wx_s,
                                 const float* wh_s, const float* mu_s, const float* sg_s, int wf,
                                 const float* ring, const int* pos, const int* count, int S,
                                 const void* ids, int id_kind, const float* windows,
                                 const int* n_valid, const int* later,
                                 const unsigned char* active, const int* counts,
                                 const unsigned char* mask, void* out, int out_kind, int T, int B,
                                 int W, int H, int K, int bf16, int R, void* stream) {
  return kdw_entry<false>(wx_w, wx_b, wh_w, wh_b, mu_w, mu_b, sg_w, sg_b, wx_s, wh_s, mu_s, sg_s,
                          wf, ring, pos, count, S, ids, id_kind, windows, n_valid, later, active,
                          counts, mask, out, out_kind, T, B, W, H, K, bf16, R, nullptr, 0,
                          stream);
}

// The global form: as sw_gru_score_wide, the block state in `state`, a
// scratch of min(blocks, wave) x stride floats (models/flush.py
// scan_state_floats, state_stride), blocks launched in waves of at most
// `wave`.
extern "C" int sw_gru_score_global(const void* wx_w, const float* wx_b, const void* wh_w,
                                   const float* wh_b, const void* mu_w, const float* mu_b,
                                   const void* sg_w, const float* sg_b, const float* wx_s,
                                   const float* wh_s, const float* mu_s, const float* sg_s,
                                   int wf, const float* ring, const int* pos, const int* count,
                                   int S, const void* ids, int id_kind, const float* windows,
                                   const int* n_valid, const int* later,
                                   const unsigned char* active, const int* counts,
                                   const unsigned char* mask, void* out, int out_kind, int T,
                                   int B, int W, int H, int K, int bf16, int R, float* state,
                                   long long wave, void* stream) {
  return kdw_entry<true>(wx_w, wx_b, wh_w, wh_b, mu_w, mu_b, sg_w, sg_b, wx_s, wh_s, mu_s, sg_s,
                         wf, ring, pos, count, S, ids, id_kind, windows, n_valid, later, active,
                         counts, mask, out, out_kind, T, B, W, H, K, bf16, R, state, wave,
                         stream);
}
