// KE tf_embed: the transformer's window load, normalization and token
// embedding, in one kernel.
//
// Replaces what the JAX package runs before the transformer's first block:
// in the scoring flush, sitewhere_tpu/ops/windows.py:143 gather_windows
// (K2) and models/transformer.py:256 score_stacked's normalize_windows;
// in the forecast, :207-211 (normalize, last `context` values, left
// padding); in both, the embedding of _backbone_stacked :235-237 and
// _backbone :74-75: x = ((v * w_e) + b_e) + pos[t], with v the normalized
// value cast to the compute dtype and each op rounded in it.
//
// Modes:
//   0 score: row b of slot t from the post-update ring (ring set; the id
//     clamps and a short history is left-padded with its oldest value, as
//     KS/KD's prologue scan_row_load does) or from given windows f32[T, B,
//     W] and n_valid; tokens = W - 1; also writes the normalized last-K
//     targets f32[T, B, K] and n_valid i32[T, B] for KN. With K = W (the
//     train mode) the "targets" are the whole normalized window f32[T, B,
//     W]: KN's train mode reads its next values, KE's backward its inputs.
//   1 context: a normalized context f32[B, C]; tokens = C (the forecast's
//     later steps).
//   2 raw: raw windows f32[B, L]; normalized over all L, then the context
//     is their last C values, left-padded with the first when L < C
//     (written f32[B, C] with the row mu and sigma f32[B]); tokens = C (the
//     forecast's first step).
//
// Weight formats (the tenant's param_dtype, models/flush.py WEIGHT_FORMATS):
// the embed weight w_e is read through wload (common.cuh) as stored, f32
// masters, bf16, or int8 qw with per-slot, per-channel f32 scales
// [T, 1, D] (kernel_weight's dequant, common.py:265, its one rounding);
// b_e and pos stay f32 in every format, as quantize_params leaves them.
// The train mode (K = W) reads the f32 masters only.
//
// Bound on the H100: bytes. The output x [T, B, tokens, D] in the compute
// dtype dominates (0.52 GB at transformer32); the inputs are one window a
// row. Design: a block takes `rows` rows of one slot; their windows are
// loaded and normalized into shared memory (one thread a row), then the
// block's threads write the tokens with consecutive threads on consecutive
// columns.
#include "common.cuh"

namespace {

struct KeArgs {
  // scan_row_load's fields (mode 0)
  const float* ring; const int* pos; const int* count; int S;
  const void* ids; int id_kind;
  const float* windows; const int* n_valid;
  const int* later; const unsigned char* active; const int* counts; const unsigned char* mask;
  int B; int W; int K;
  // embedding params, stacked per slot: w_e [T, 1, D] (its format's
  // storage; int8 scales es [T, 1, D]), b_e [T, D], pos [T, P, D]
  const void* ew; const float* es; const float* eb; const float* ptab; int P;
  const float* src; int L;  // modes 1, 2: f32[B, L] (L = C in mode 1)
  void* x; float* targets; int* nv_out;
  float* ctx_out; float* mu_out; float* sigma_out;
  int mode; int D; int tokens; int rows;
};

template <bool BF16, int WF>
__global__ void tf_embed_kernel(const KeArgs a) {
  extern __shared__ float xs[];  // [rows][len]: each row's normalized values
  const int t = blockIdx.y;
  const int b0 = blockIdx.x * a.rows;
  const int R = min(a.rows, a.B - b0);
  const int len = a.mode == 0 ? a.W : a.L;
  const int C = a.tokens;
  const int tid = threadIdx.x;
  // index of token c's value in a row of xs (mode 2: last C, left-padded)
  const int shift = a.mode == 2 ? a.L - C : 0;

  if (a.mode == 0) {
    if (tid < R) {
      const int b = b0 + tid;
      float* x = xs + tid * len;
      int n = 0, col = -1;
      scan_row_load(a, t, b, x, n, col);
      const long long row = static_cast<long long>(t) * a.B + b;
      for (int j = 0; j < a.K; ++j) a.targets[row * a.K + j] = x[a.W - a.K + j];
      a.nv_out[row] = n;
    }
  } else {
    for (int e = tid; e < R * len; e += blockDim.x) {
      xs[e] = a.src[static_cast<long long>(b0) * len + e];
    }
    if (a.mode == 2) {
      __syncthreads();
      if (tid < R) {
        float mu, sigma;
        normalize_row(xs + tid * len, len, mu, sigma);
        a.mu_out[b0 + tid] = mu;
        a.sigma_out[b0 + tid] = sigma;
      }
    }
  }
  __syncthreads();
  if (a.mode == 2) {
    for (int e = tid; e < R * C; e += blockDim.x) {
      const int r = e / C, c = e % C;
      a.ctx_out[static_cast<long long>(b0 + r) * C + c] = xs[r * len + max(c + shift, 0)];
    }
  }

  const int D = a.D;
  const long long wt = static_cast<long long>(t) * D;  // slot t's w_e, es
  const float* eb = a.eb + static_cast<long long>(t) * D;
  const float* pt = a.ptab + static_cast<long long>(t) * a.P * D;
  const int per_row = C * D;
  for (int r = 0; r < R; ++r) {
    const float* xr = xs + r * len;
    const long long out0 = (static_cast<long long>(t) * a.B + b0 + r) * per_row;
    for (int e = tid; e < per_row; e += blockDim.x) {
      const int c = e / D, d = e - c * D;
      const float v = rb<BF16>(xr[max(c + shift, 0)]);
      float y = rb<BF16>(__fmul_rn(v, wload<WF, BF16>(a.ew, a.es, wt + d, wt + d)));
      y = rb<BF16>(__fadd_rn(y, rb<BF16>(eb[d])));
      y = __fadd_rn(y, rb<BF16>(pt[e]));
      store_val(a.x, BF16 ? KIND_BF16 : KIND_F32, out0 + e, y);
    }
  }
}

template <bool BF16, int WF>
int launch_ke(const KeArgs& a, dim3 grid, size_t smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(tf_embed_kernel<BF16, WF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  tf_embed_kernel<BF16, WF><<<grid, 256, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ew: the embed weight as stored in format wf (WF_F32, WF_BF16, WF_I8;
// es its int8 scales, else null).
extern "C" int sw_tf_embed(const void* ew, const float* es, int wf, const float* eb,
                           const float* ptab, int P, const float* ring, const int* pos,
                           const int* count, int S, const void* ids, int id_kind,
                           const float* windows, const int* n_valid, const float* src, int L,
                           void* x, float* targets, int* nv_out, float* ctx_out, float* mu_out,
                           float* sigma_out, int mode, int T, int B, int W, int D, int K,
                           int tokens, int rows, int kind, void* stream) {
  if (T == 0 || B == 0) return static_cast<int>(cudaGetLastError());
  if (mode < 0 || mode > 2 || rows < 1 || D < 1 || tokens < 1 || tokens > P ||
      (kind != KIND_F32 && kind != KIND_BF16) || (wf == WF_I8) != (es != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (mode == 0 && (W < 2 || tokens != W - 1 || K < 1 || K > W))
    return static_cast<int>(cudaErrorInvalidValue);
  if (mode == 1 && L != tokens) return static_cast<int>(cudaErrorInvalidValue);
  if (mode != 0 && (T != 1 || L < 1)) return static_cast<int>(cudaErrorInvalidValue);
  KeArgs a{ring, pos, count, S, ids, id_kind, windows, n_valid, nullptr, nullptr, nullptr,
           nullptr, B, W, K, ew, es, eb, ptab, P, src, L, x, targets, nv_out, ctx_out, mu_out,
           sigma_out, mode, D, tokens, rows};
  const size_t smem = static_cast<size_t>(rows) * (mode == 0 ? W : L) * sizeof(float);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((B + rows - 1) / rows, T);
  return by_format(wf, [&](auto f) {
    return by_bf16(kind == KIND_BF16, [&](auto b) {
      return launch_ke<decltype(b)::value, decltype(f)::value>(a, grid, smem, st);
    });
  });
}
