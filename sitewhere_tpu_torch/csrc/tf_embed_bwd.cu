// KE tf_embed_bwd: the backward of the transformer's token embedding, the
// per-slot gradients of the embed dense layer and the position table.
//
// Replaces the vjp of sitewhere_tpu/models/transformer.py:235-237 (in
// _backbone_stacked, :229) as jax.grad runs it through the train loss
// (:272 loss_stacked): x = dense_stacked(embed, v) + pos[:, :Tt], with v
// the normalized inputs normed[..., :-1] cast to the compute dtype. From
// the tokens' cotangent dx [S, B, Tt, D] in the compute dtype and the
// normalized windows f32[S, B, W] (KE's train mode writes them; token c of
// row b is normed[b, c]), per slot:
//   d embed.w [S, 1, D] = sum over (b, c) of v[b, c] * dx[b, c, :]
//   d embed.b [S, D]    = sum over (b, c) of dx[b, c, :]
//   d pos [S, P, D]     = sum over b of dx[b, c, :] at rows c < Tt, 0 at
//                         rows Tt..P-1, which the window never reaches.
// Each is accumulated in f32 and rounded once to the compute dtype, as the
// reference's bf16 dot and reductions are before the casts' transposes
// widen them to the f32 params.
//
// Bound on the H100: bytes. dx is read once (0.52 GB at transformer32's
// plane in bf16); the outputs are a few KB a slot. Design: a first pass
// with a block per (tile of kTileRows rows, slot), its threads over the
// (position, column) pairs of a row (consecutive threads on consecutive
// columns: coalesced), each summing dx and v * dx over the tile's rows in
// order into partials f32[S, tiles, 2 Tt D]; tile_sum adds the tiles in
// order; a last pass sums the positions for d embed.b and d embed.w and
// writes d pos. No float atomics: two runs give the same bits.
#include "common.cuh"
#include "tile_sum.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 256;

template <bool BF16>
__global__ void __launch_bounds__(kThreads)
embed_bwd_tiles(const void* __restrict__ dx, const float* __restrict__ normed,
                float* __restrict__ part, int B, int Tt, int D, int W) {
  const int kind = BF16 ? KIND_BF16 : KIND_F32;
  const int t = blockIdx.y, tiles = gridDim.x;
  const int b0 = blockIdx.x * kTileRows;
  const int b1 = b0 + kTileRows < B ? b0 + kTileRows : B;
  const int n = Tt * D;
  float* dst = part + (static_cast<long long>(t) * tiles + blockIdx.x) * 2 * n;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int c = e / D;
    float ap = 0.0f, aw = 0.0f;
    for (int b = b0; b < b1; ++b) {
      const long long row = static_cast<long long>(t) * B + b;
      const float g = load_val(dx, kind, row * n + e);
      const float v = rb<BF16>(normed[row * W + c]);
      ap = __fadd_rn(ap, g);
      aw = __fadd_rn(aw, __fmul_rn(v, g));
    }
    dst[e] = ap;
    dst[n + e] = aw;
  }
}

// red f32[S, 2 Tt D] (the position sums, then the v-weighted sums) -> the
// three gradients. Grid S, kThreads threads over the D columns.
template <bool BF16>
__global__ void __launch_bounds__(kThreads)
embed_bwd_finish(const float* __restrict__ red, float* __restrict__ dw, float* __restrict__ db,
                 float* __restrict__ dpos, int Tt, int D, int P) {
  const int t = blockIdx.x;
  const long long n = static_cast<long long>(Tt) * D;
  const float* rp = red + static_cast<long long>(t) * 2 * n;
  const float* rw = rp + n;
  float* pos = dpos + static_cast<long long>(t) * P * D;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float sb = 0.0f, sw = 0.0f;
    for (int c = 0; c < Tt; ++c) {
      const float p = rp[static_cast<long long>(c) * D + d];
      sb = __fadd_rn(sb, p);
      sw = __fadd_rn(sw, rw[static_cast<long long>(c) * D + d]);
      pos[static_cast<long long>(c) * D + d] = rb<BF16>(p);
    }
    for (int c = Tt; c < P; ++c) pos[static_cast<long long>(c) * D + d] = 0.0f;
    db[static_cast<long long>(t) * D + d] = rb<BF16>(sb);
    dw[static_cast<long long>(t) * D + d] = rb<BF16>(sw);
  }
}

template <bool BF16>
int launch_keb(const void* dx, const float* normed, float* part, float* red, float* dw,
               float* db, float* dpos, int T, int B, int Tt, int D, int W, int P,
               cudaStream_t st) {
  const int tiles = (B + kTileRows - 1) / kTileRows;
  embed_bwd_tiles<BF16><<<dim3(tiles, T), kThreads, 0, st>>>(dx, normed, part, B, Tt, D, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rc = launch_tile_sum(part, red, T, tiles, 2 * Tt * D, 0, st);
  if (rc != 0) return rc;
  embed_bwd_finish<BF16><<<T, kThreads, 0, st>>>(red, dw, db, dpos, Tt, D, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dx: [T, B, Tt, D] (kind KIND_F32 or KIND_BF16); normed: f32[T, B, W]
// with Tt <= W; part: f32[T, ceil(B / 256), 2 Tt D] and red: f32[T, 2 Tt
// D] scratch; dw, db: f32[T, D]; dpos: f32[T, P, D] with Tt <= P.
extern "C" int sw_tf_embed_bwd(const void* dx, const float* normed, float* part, float* red,
                               float* dw, float* db, float* dpos, int T, int B, int Tt, int D,
                               int W, int P, int kind, void* stream) {
  if (T == 0) return static_cast<int>(cudaGetLastError());
  if (T < 0 || T > 65535 || B < 1 || Tt < 1 || Tt > W || Tt > P || D < 1 ||
      (kind != KIND_F32 && kind != KIND_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return kind == KIND_BF16
             ? launch_keb<true>(dx, normed, part, red, dw, db, dpos, T, B, Tt, D, W, P, st)
             : launch_keb<false>(dx, normed, part, red, dw, db, dpos, T, B, Tt, D, W, P, st);
}
