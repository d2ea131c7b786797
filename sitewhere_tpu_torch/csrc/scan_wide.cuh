// The wide form of the recurrent scan kernels (KS lstm_score_wide.cu, KD
// gru_score_wide.cu, KF deepar_forecast_wide.cu): any hidden H and any
// window, for the shapes the templated forms (lstm_score.cu, gru_score.cu,
// deepar_forecast.cu) do not take. Those hold a thread's H-float column of
// wh in registers (H in 8, 16, 32, 64) and a tile's normalized windows in
// shared memory; here H is a runtime value and no W-long array is held:
//
// - a block takes R rows (32, 16 or 8: the most whose state fits shared
//   memory, models/flush.py wide_rows; the global form's rule is
//   global_rows); its h lives in the block state (below)
//   transposed and double-buffered, hT[2][H][RS] with RS = R + 4 (16-byte
//   reads of 4 rows at once, conflict-free float4 writes), the LSTM's c in
//   [R][H];
// - an item is (unit u, group of kTR rows); a thread takes items tid,
//   tid + nthreads, ... and computes every gate column of its unit (u,
//   H + u, ... : 4 for the LSTM, 3 for the GRU) for its kTR rows, so the
//   cell update needs no exchange: one barrier a step. wh is streamed from
//   L1/L2 each step, one weight per gate and k, read in its storage format
//   (the int8 scale of each column rounded once an item, as wload rounds
//   it);
// - windows are read from global memory: a row's mean and sigma in the
//   prologue (normalize_row's arithmetic, two passes), and each step's
//   normalized value when the step needs it (ring mode gathers from the
//   post-update ring with the left-pad rule of ops/windows.py
//   gather_windows; windows mode reads the given window).
//
// Rounding points are the templated forms' (see their sources).
//
// Where the block state lives (template parameter GS of every wide kernel):
// the wide form keeps it in shared memory, so a block's hT (and the LSTM's
// c, the heads' weights) caps the hidden width there (models/flush.py
// wide_rows: 1,757 for KS at 8 rows). The global form (GS = true, launch
// names *_global) is the same kernel with that state in the block's slice
// of a scratch in global memory (block_state), which the wrapper allocates
// through torch's allocator; shared memory then holds only the rows'
// sources and per-row scalars and caps nothing, so R can be 32 at any H.
// The item code below takes the state through plain pointers and runs
// unchanged on either space: the same items, order, barriers and rounding
// points, so the global form's results are the wide form's, bit for bit.
// The state is written and read back within a launch, so it is never read
// through __ldg or a const __restrict__ pointer (the non-coherent path could
// return a stale h); __syncthreads() makes a block's global writes visible
// to the block. Blocks run in waves of at most `wave` blocks that reuse the
// scratch (in_waves), in order on the stream; the wide form runs one wave.
// The global form prefers L1 to shared memory (the carve-out, prepare), so
// its state is served from L1 and L2 as far as they hold it.
#pragma once
#include "gru.cuh"

namespace wide {

constexpr int kTR = 8;           // rows of an item: two float4 reads of h a k
constexpr int kMaxThreads = 256;

// Where row r's raw window comes from: x(c) = c < fvc ? first : base[(p + c) % W]
// (windows mode: p = fvc = 0, base the given row; padding rows: fvc = W,
// first = 0), and its normalization.
struct RowSrc {
  const float* base;
  int p, fvc;
  float first, mu, sigma;
};

__device__ __forceinline__ float raw_at(const RowSrc& r, int W, int c) {
  return c < r.fvc ? r.first : r.base[(r.p + c) % W];
}

// normalize_row's statistics without holding the window: mean relative to
// x(0), population std, eps outside the root (common.cuh normalize_row)
__device__ __forceinline__ void row_stats(RowSrc& r, int W) {
  const float x0 = raw_at(r, W, 0);
  float sum = 0.0f;
  for (int c = 0; c < W; ++c) sum += raw_at(r, W, c) - x0;
  r.mu = x0 + sum / static_cast<float>(W);
  float sq = 0.0f;
  for (int c = 0; c < W; ++c) {
    const float d = raw_at(r, W, c) - r.mu;
    sq += d * d;
  }
  r.sigma = sqrtf(sq / static_cast<float>(W)) + 1e-6f;
}

// the normalized value at column c, as normalize_row writes it
__device__ __forceinline__ float normed_at(const RowSrc& r, int W, int c) {
  return (raw_at(r, W, c) - r.mu) / r.sigma;
}

// The weight at index i of a leaf stored in format WF, at the compute
// dtype, with the int8 column's scale already rounded (sc = rb(scale)):
// wload's value, the scale read hoisted out of the k loop.
template <int WF, bool BF16>
__device__ __forceinline__ float wfetch(const void* w, long long i, float sc) {
  if constexpr (WF == WF_BF16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(w)[i]);
  } else if constexpr (WF == WF_I8) {
    return rb<BF16>(__fmul_rn(static_cast<float>(static_cast<const int8_t*>(w)[i]), sc));
  } else {
    return rb<BF16>(static_cast<const float*>(w)[i]);
  }
}

// the rounded int8 scale of column si (unused for the other formats)
template <int WF, bool BF16>
__device__ __forceinline__ float wscale(const float* scale, long long si) {
  if constexpr (WF == WF_I8) return rb<BF16>(scale[si]);
  return 1.0f;
}

// An item's recurrent dots: acc[q][r] = sum_k h[k][r0 + r] * wh[k][q * H + u]
// for its NG gate columns and kTR rows, in f32, k in order. hc: the block's
// hT buffer offset to row r0 (row stride RS); whp: the slot's wh; sc: the
// columns' rounded int8 scales.
template <int NG, int WF, bool BF16>
__device__ __forceinline__ void item_dots(float (&acc)[NG][kTR], const float* hc, int RS,
                                          const void* whp, long long wbase, int H, int u,
                                          const float (&sc)[NG]) {
#pragma unroll
  for (int q = 0; q < NG; ++q) {
#pragma unroll
    for (int r = 0; r < kTR; ++r) acc[q][r] = 0.0f;
  }
  const long long G = static_cast<long long>(NG) * H;
  for (int k = 0; k < H; ++k) {
    const float4 h0 = *reinterpret_cast<const float4*>(hc + k * RS);
    const float4 h1 = *reinterpret_cast<const float4*>(hc + k * RS + 4);
    const float hv[kTR] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
    const long long row = wbase + k * G + u;
#pragma unroll
    for (int q = 0; q < NG; ++q) {
      const float w = wfetch<WF, BF16>(whp, row + static_cast<long long>(q) * H, sc[q]);
#pragma unroll
      for (int r = 0; r < kTR; ++r) acc[q][r] = fmaf(hv[r], w, acc[q][r]);
    }
  }
}

// The row prologue of KS's and KD's wide forms (`A` their argument struct,
// which names the fields of common.cuh scan_row_load's): row b of slot t's
// window source and statistics, its samples n (at most W) and score column
// (-1: every column, windows mode). Returns whether the row is scored, as
// scan_row_load.
template <class A>
__device__ bool row_prologue(const A& a, int t, int b, RowSrc& src, int& n, int& col) {
  const int W = a.W, K = a.K;
  const long long row = static_cast<long long>(t) * a.B + b;
  const bool select = a.later != nullptr;
  const bool live = select ? (a.active[t] != 0 && row_valid(a.counts, a.mask, t, b, a.B)) : true;
  if (a.windows != nullptr) {
    src.base = a.windows + row * W;
    src.p = 0;
    src.fvc = 0;
    src.first = 0.0f;
    n = a.n_valid[row];
  } else {
    long long id = load_id(a.ids, a.id_kind, row);
    id = id < 0 ? 0 : (id >= a.S ? a.S - 1 : id);  // reads clamp
    const long long s = static_cast<long long>(t) * a.S + id;
    src.base = a.ring + s * W;
    src.p = a.pos[s];
    const int cnt = a.count[s];
    n = cnt < W ? cnt : W;
    src.fvc = W - n;  // first valid column
    src.first = src.base[(src.p + (src.fvc < W - 1 ? src.fvc : W - 1)) % W];
  }
  row_stats(src, W);
  col = -1;
  if (select) {
    if (K > 1) {
      const int c = K - 1 - a.later[row];
      col = c < 0 ? 0 : (c > K - 1 ? K - 1 : c);
    } else {
      col = 0;
    }
  }
  return live;
}

// A padding row past B: x = 0 everywhere, normalized to 0.
__device__ __forceinline__ RowSrc pad_row(int W) {
  return RowSrc{nullptr, 0, W, 0.0f, 0.0f, 1.0f};
}

// One GRU item (KD's and KF's wide forms): unit u, rows r0 .. r0 + kTR of
// the block. Reads h from hc ([H][RS]) and x from xc[r], writes h' into
// hn. c0 = slot * 3H + u indexes the unit's r column of wx, the biases and
// the int8 scales; wbase = slot * H * 3H the slot's wh. As KD: gx = x * wx
// + bx and gh = h . wh + bh rounded as gru.cuh rounds them; r and z from
// the rounded sums, n from nx and nh.
template <int WF, bool BF16>
__device__ __forceinline__ void gru_item(const void* wx_w, const float* wx_s, const float* wx_b,
                                         const void* wh_w, const float* wh_s, const float* wh_b,
                                         long long c0, long long wbase, int H, int u, int r0,
                                         int RS, const float* hc, const float* xc, float* hn) {
  float sc[3], wxq[3], bxq[3], bhq[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const long long c = c0 + static_cast<long long>(q) * H;
    sc[q] = wscale<WF, BF16>(wh_s, c);
    wxq[q] = wload<WF, BF16>(wx_w, wx_s, c, c);
    bxq[q] = rb<BF16>(wx_b[c]);
    bhq[q] = rb<BF16>(wh_b[c]);
  }
  float acc[3][kTR];
  item_dots<3, WF, BF16>(acc, hc + r0, RS, wh_w, wbase, H, u, sc);
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
    hv[r] = gru_cell<BF16>(gr, gz, nx, nh, hc[u * RS + r0 + r]);
  }
  float4* dst = reinterpret_cast<float4*>(hn + u * RS + r0);
  dst[0] = make_float4(hv[0], hv[1], hv[2], hv[3]);
  dst[1] = make_float4(hv[4], hv[5], hv[6], hv[7]);
}

// Threads of a block of `items` items: whole warps, at most kMaxThreads.
inline int threads_for(int items) {
  const int n = (items + 31) / 32 * 32;
  return n < 32 ? 32 : (n > kMaxThreads ? kMaxThreads : n);
}

// -- the block state's storage ---------------------------------------------

constexpr int kStateAlign = 32;  // floats: a block's slice starts on 128 bytes

// Floats a block's slice of the global scratch takes (the state's floats
// rounded up to kStateAlign; models/flush.py state_stride mirrors it).
inline long long state_stride(long long floats) {
  return (floats + kStateAlign - 1) / kStateAlign * kStateAlign;
}

// The block's state: past its small arrays in shared memory (smem_tail),
// or (GS) its slice of the scratch, `stride` floats a block of the wave.
template <bool GS>
__device__ __forceinline__ float* block_state(float* smem_tail, float* scratch,
                                              long long stride) {
  if constexpr (GS) {
    return scratch + static_cast<long long>(blockIdx.x) * stride;
  } else {
    return smem_tail;
  }
}

// Allow a kernel the dynamic shared memory it is launched with (above 48 KB
// the attribute must be set first); the global form prefers L1.
template <bool GS, class Kern>
inline int prepare(Kern kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess && GS) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               static_cast<int>(cudaSharedmemCarveoutMaxL1));
  }
  return static_cast<int>(err);
}

// launch(blk0, n) for the waves of at most `wave` of `blocks` blocks, in
// order; stops at the first error.
template <class F>
inline int in_waves(long long blocks, long long wave, F&& launch) {
  for (long long b0 = 0; b0 < blocks; b0 += wave) {
    const long long n = blocks - b0 < wave ? blocks - b0 : wave;
    const int err = launch(b0, static_cast<unsigned>(n));
    if (err != 0) return err;
  }
  return 0;
}

}  // namespace wide
