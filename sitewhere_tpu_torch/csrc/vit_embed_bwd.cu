// KV vit_embed_bwd: the backward of the ViT's patch-projection epilogue
// (KV vit_embed), the gradients of the projection's bias, the [CLS] token
// and the position table.
//
// Replaces the vjp of sitewhere_tpu/models/vit.py:86-89 (dense's bias add
// after the patch einsum, the broadcast [CLS] concatenated in front, + pos)
// as jax.grad runs it through the loss (:121, :127). From the tokens'
// cotangent dx [B, N + 1, D] in the compute dtype:
//   d pos [N + 1, D] = the sum over frames of dx[b, t, :]
//   d cls [D]        = the sum over frames of dx[b, 0, :]
//   d patch.b [D]    = the sum over frames and rows 1..N of dx[b, t, :]
// each accumulated in f32 and rounded once to the compute dtype, as the
// reference's bf16 reductions are before the casts' transposes widen them
// to the f32 params (csrc/tf_embed_bwd.cu does the same). The product's
// cotangent is dx[:, 1:] itself; d patch.w = patches^T . dx[:, 1:] is a
// plain GEMM outside this kernel, as the reference leaves it to XLA.
//
// Bound on the H100: bytes. dx is read once (19.4 MB at ViT-B/16's batch
// of 64 in bf16, 5.8 us at 3.35 TB/s); the outputs are 0.6 MB. Design: a
// first pass with a thread per (token, column) of dx's rows (consecutive
// threads on consecutive columns: coalesced), each summing its element
// over the frames in order into red f32[N + 1, D]; a second pass with a
// thread per column writes d pos and d cls and sums rows 1..N in order for
// d patch.b. No float atomics: two runs give the same bits.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <bool BF16>
__global__ void __launch_bounds__(kThreads)
embed_bwd_frames(const void* __restrict__ dx, float* __restrict__ red, int B, long long n) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= n) return;
  float acc = 0.0f;
  for (int b = 0; b < B; ++b)
    acc = __fadd_rn(acc, load_val(dx, BF16 ? KIND_BF16 : KIND_F32, b * n + e));
  red[e] = acc;
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads)
embed_bwd_finish(const float* __restrict__ red, float* __restrict__ dpos,
                 float* __restrict__ dcls, float* __restrict__ db, int Tn, int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= D) return;
  float sb = 0.0f;
  for (int t = 0; t < Tn; ++t) {
    const float p = red[static_cast<long long>(t) * D + d];
    dpos[static_cast<long long>(t) * D + d] = rb<BF16>(p);
    if (t > 0) sb = __fadd_rn(sb, p);
  }
  dcls[d] = rb<BF16>(red[d]);
  db[d] = rb<BF16>(sb);
}

template <bool BF16>
int launch_kvb(const void* dx, float* red, float* dpos, float* dcls, float* db, int B, int Tn,
               int D, cudaStream_t st) {
  const long long n = static_cast<long long>(Tn) * D;
  embed_bwd_frames<BF16><<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0,
                           st>>>(dx, red, B, n);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  embed_bwd_finish<BF16><<<(D + kThreads - 1) / kThreads, kThreads, 0, st>>>(red, dpos, dcls, db,
                                                                            Tn, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dx: [B, N + 1, D] (kind KIND_F32 or KIND_BF16); red: f32[N + 1, D]
// scratch; dpos: f32[N + 1, D], dcls and db: f32[D].
extern "C" int sw_vit_embed_bwd(const void* dx, float* red, float* dpos, float* dcls, float* db,
                                int B, int N, int D, int kind, void* stream) {
  if (B < 1 || N < 0 || D < 1 || (kind != KIND_F32 && kind != KIND_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return kind == KIND_BF16 ? launch_kvb<true>(dx, red, dpos, dcls, db, B, N + 1, D, st)
                           : launch_kvb<false>(dx, red, dpos, dcls, db, B, N + 1, D, st);
}
