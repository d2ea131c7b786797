// KS lstm_score, wide form: the LSTM-AD scoring flush (window gather,
// normalization, stacked LSTM scan, head, column select, mask and wire
// cast) at any hidden and any window.
//
// Replaces what lstm_score.cu replaces (sitewhere_tpu/ops/windows.py:143
// gather_windows, sitewhere_tpu/models/lstm_ad.py:117 _stacked_lstm_scan
// and :159 score_stacked, parallel/sharded.py:564-580's epilogue) at the
// shapes the templated KS does not take: hidden outside 8/16/32/64 (GluonTS-
// and tenant-chosen widths: 4, 40, 96, 128, 256, ...) and windows whose
// [32][W] normalized tile no longer fits shared memory
// (models/flush.py scan_route). Same two modes, same arguments (plus R),
// same rounding points (lstm_score.cu); the dot products accumulate in
// f32 in k order.
//
// Bound on the H100: operations, 2 * 4H * H FLOP a row and step (~135
// MFLOP a row at H 128, W 256), against ~1 KB of ring reads a row. This
// first version runs on the CUDA cores in f32 FMAs and streams wh from
// L1/L2 each step (scan_wide.cuh): a thread-block cluster holding wh in
// distributed shared memory, and tensor cores, are later work.
// Design: scan_wide.cuh. One block per (slot, R-row tile); an item is one
// hidden unit's four gate columns (i, f, g, o at u, H + u, 2H + u, 3H + u)
// for 8 rows, so its thread runs the cell update itself (c [R][H] in the
// block state, owned by the item); one barrier a step. The head's dot is
// a warp per row over the new h. The block state (hT, c, the head's
// weights) sits in shared memory (the wide form, hidden up to 1,757) or,
// in the global form (sw_lstm_score_global), in a global scratch: the
// same kernel, any hidden.
#include "scan_wide.cuh"

namespace {

using wide::kTR;

struct KswArgs {
  const void* wx_w; const float* wx_b; const void* wh_w; const float* wh_b;
  const void* hd_w; const float* hd_b;
  const float* wx_s; const float* wh_s; const float* hd_s;  // int8 scales
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

// Floats of a block's state: hT [2][H][RS], c [R][H], head weights [H].
inline long long ksw_state_floats(int H, int R) {
  return 2LL * H * (R + 4) + static_cast<long long>(R) * H + H;
}

template <bool BF16, int WF, bool GS>
__global__ void __launch_bounds__(wide::kMaxThreads)
lstm_score_wide_kernel(const KswArgs a) {
  const int H = a.H, R = a.R, RS = R + 4, W = a.W, K = a.K, B = a.B;
  const int G = 4 * H;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  wide::RowSrc* srcs = reinterpret_cast<wide::RowSrc*>(smem_raw);  // [R]
  float* xb = reinterpret_cast<float*>(srcs + R);  // [2][R] normalized x of a step
  int* nrow = reinterpret_cast<int*>(xb + 2 * R);  // samples per row
  int* colr = nrow + R;                            // selected column, -1 = all K
  int* liver = colr + R;                           // row is scored (else 0)
  float* hT = wide::block_state<GS>(reinterpret_cast<float*>(liver + R), a.state,
                                    a.stride);     // [2][H][RS]
  float* cs = hT + 2 * H * RS;                     // [R][H]
  float* hw = cs + R * H;                          // [H] head weights

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
  for (int e = tid; e < R * H; e += nth) cs[e] = 0.0f;
  for (int u = tid; u < H; u += nth) {
    hw[u] = wload<WF, BF16>(a.hd_w, a.hd_s, static_cast<long long>(t) * H + u, t);
  }
  const float hb = rb<BF16>(a.hd_b[t]);
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
      const long long c0 = static_cast<long long>(t) * G + u;
      float sc[4], wxq[4], bq[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const long long c = c0 + static_cast<long long>(q) * H;
        sc[q] = wide::wscale<WF, BF16>(a.wh_s, c);
        wxq[q] = wload<WF, BF16>(a.wx_w, a.wx_s, c, c);
        bq[q] = rb<BF16>(a.wx_b[c] + a.wh_b[c]);
      }
      float acc[4][kTR];
      wide::item_dots<4, WF, BF16>(acc, hc + r0, RS, a.wh_w, wbase, H, u, sc);
      float hv[kTR];
#pragma unroll
      for (int r = 0; r < kTR; ++r) {
        const float x = rb<BF16>(xc[r0 + r]);
        float gv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          gv[q] = rb<BF16>(rb<BF16>(rb<BF16>(x * wxq[q]) + rb<BF16>(acc[q][r])) + bq[q]);
        }
        // gate order i, f, g, o; forget gate biased by +1
        float* cp = cs + (r0 + r) * H + u;
        const float sf = sigm<BF16>(rb<BF16>(gv[1] + 1.0f));
        const float si = sigm<BF16>(gv[0]);
        const float tg = rb<BF16>(tanhf(gv[2]));
        const float c = rb<BF16>(rb<BF16>(sf * *cp) + rb<BF16>(si * tg));
        *cp = c;
        const float so = sigm<BF16>(gv[3]);
        hv[r] = rb<BF16>(so * rb<BF16>(tanhf(c)));
      }
      float4* dst = reinterpret_cast<float4*>(hn + u * RS + r0);
      dst[0] = make_float4(hv[0], hv[1], hv[2], hv[3]);
      dst[1] = make_float4(hv[4], hv[5], hv[6], hv[7]);
    }
    // the next step's input, which is also this step's target
    if (tid < R) xb[((s + 1) & 1) * R + tid] = wide::normed_at(srcs[tid], W, s + 1);
    __syncthreads();
    if (s < steps - K) continue;
    // head on the last K states: |normed target - prediction|
    const int jcol = s - (steps - K);
    const float* target = xb + ((s + 1) & 1) * R;
    for (int r = warp; r < R; r += nwarps) {
      const int b = b0 + r;
      if (b >= B || (colr[r] >= 0 && colr[r] != jcol)) continue;  // warp-uniform
      float p = 0.0f;
      for (int u = lane; u < H; u += 32) p = fmaf(hn[u * RS + r], hw[u], p);
      p = warp_sum(p);
      if (lane == 0) {
        const float pred = rb<BF16>(rb<BF16>(p) + hb);
        const float err = fabsf(target[r] - pred);
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

template <bool BF16, int WF, bool GS>
int launch_ksw(KswArgs a, int T, long long wave, cudaStream_t stream) {
  const int R = a.R, H = a.H;
  const size_t small = R * sizeof(wide::RowSrc) + 2 * R * sizeof(float) + 3 * R * sizeof(int);
  const size_t smem = small + (GS ? 0 : ksw_state_floats(H, R) * sizeof(float));
  const int err = wide::prepare<GS>(lstm_score_wide_kernel<BF16, WF, GS>, smem);
  if (err != 0) return err;
  a.tiles = (a.B + R - 1) / R;
  a.stride = wide::state_stride(ksw_state_floats(H, R));
  const long long blocks = static_cast<long long>(a.tiles) * T;
  return wide::in_waves(blocks, GS ? wave : blocks, [&](long long blk0, unsigned n) {
    a.blk0 = blk0;
    lstm_score_wide_kernel<BF16, WF, GS>
        <<<n, wide::threads_for(H * (R / kTR)), smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  });
}

template <bool GS>
int ksw_entry(const void* wx_w, const float* wx_b, const void* wh_w, const float* wh_b,
              const void* hd_w, const float* hd_b, const float* wx_s, const float* wh_s,
              const float* hd_s, int wf, const float* ring, const int* pos, const int* count,
              int S, const void* ids, int id_kind, const float* windows, const int* n_valid,
              const int* later, const unsigned char* active, const int* counts,
              const unsigned char* mask, void* out, int out_kind, int T, int B, int W, int H,
              int K, int bf16, int R, float* state, long long wave, void* stream) {
  if (T == 0 || B == 0) return static_cast<int>(cudaGetLastError());
  if (W < 2 || K < 1 || K > W - 1 || H < 1 || R < kTR || R % kTR != 0 ||
      (wf == WF_I8 && (!wx_s || !wh_s || !hd_s)) || (GS && (state == nullptr || wave < 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  KswArgs a{wx_w, wx_b, wh_w, wh_b, hd_w, hd_b, wx_s, wh_s, hd_s, ring, pos, count, S, ids,
            id_kind, windows, n_valid, later, active, counts, mask, out, out_kind, B, W, K, H, R,
            0, 0, state, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_bf16(bf16, [&](auto b) {
    return by_format(wf, [&](auto f) {
      return launch_ksw<decltype(b)::value, decltype(f)::value, GS>(a, T, wave, st);
    });
  });
}

}  // namespace

// As sw_lstm_score (lstm_score.cu), any H >= 1 and W >= 2, plus R: rows a
// block (a multiple of 8; models/flush.py wide_rows picks it). The block
// state in shared memory.
extern "C" int sw_lstm_score_wide(const void* wx_w, const float* wx_b, const void* wh_w,
                                  const float* wh_b, const void* hd_w, const float* hd_b,
                                  const float* wx_s, const float* wh_s, const float* hd_s, int wf,
                                  const float* ring, const int* pos, const int* count, int S,
                                  const void* ids, int id_kind, const float* windows,
                                  const int* n_valid, const int* later,
                                  const unsigned char* active, const int* counts,
                                  const unsigned char* mask, void* out, int out_kind, int T,
                                  int B, int W, int H, int K, int bf16, int R, void* stream) {
  return ksw_entry<false>(wx_w, wx_b, wh_w, wh_b, hd_w, hd_b, wx_s, wh_s, hd_s, wf, ring, pos,
                          count, S, ids, id_kind, windows, n_valid, later, active, counts, mask,
                          out, out_kind, T, B, W, H, K, bf16, R, nullptr, 0, stream);
}

// The global form: as sw_lstm_score_wide, the block state in `state`, a
// scratch of min(blocks, wave) x stride floats (models/flush.py
// scan_state_floats, state_stride; blocks = T x ceil(B / R)), blocks
// launched in waves of at most `wave`.
extern "C" int sw_lstm_score_global(const void* wx_w, const float* wx_b, const void* wh_w,
                                    const float* wh_b, const void* hd_w, const float* hd_b,
                                    const float* wx_s, const float* wh_s, const float* hd_s,
                                    int wf, const float* ring, const int* pos, const int* count,
                                    int S, const void* ids, int id_kind, const float* windows,
                                    const int* n_valid, const int* later,
                                    const unsigned char* active, const int* counts,
                                    const unsigned char* mask, void* out, int out_kind, int T,
                                    int B, int W, int H, int K, int bf16, int R, float* state,
                                    long long wave, void* stream) {
  return ksw_entry<true>(wx_w, wx_b, wh_w, wh_b, hd_w, hd_b, wx_s, wh_s, hd_s, wf, ring, pos,
                         count, S, ids, id_kind, windows, n_valid, later, active, counts, mask,
                         out, out_kind, T, B, W, H, K, bf16, R, state, wave, stream);
}
