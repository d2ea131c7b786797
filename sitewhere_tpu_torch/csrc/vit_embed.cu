// KV vit_embed: the ViT patch projection's epilogue, the [CLS] token and the
// position table, in one pass.
//
// Replaces models/vit.py:86-89 of sitewhere_tpu (dense's bias add after the
// patch einsum, the broadcast [CLS] concatenated in front, + pos) over the
// projection's product prod [B, N, D] in the compute dtype, as
// torch.matmul gives it. Rounding as the reference: row 0 is
// rnd(rnd(cls) + rnd(pos[0])); row n + 1 is rnd(rnd(prod[n] + rnd(b)) +
// rnd(pos[n + 1])), rnd the cast to the compute dtype (none in f32).
//
// Bound on the H100: bytes; each product value is read once and each output
// value written once (2 x 19.4 MB at ViT-B/16's batch of 64), the f32 bias,
// [CLS] and positions come from the cache. Design: one block per output
// row (frame, token), its threads over the D columns.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <bool BF16>
__global__ void __launch_bounds__(kThreads)
vit_embed_kernel(const void* __restrict__ prod, const float* __restrict__ bias,
                 const float* __restrict__ cls, const float* __restrict__ pos,
                 void* __restrict__ out, int N, int D) {
  const int kind = BF16 ? KIND_BF16 : KIND_F32;
  const long long row = blockIdx.x;  // frame * (N + 1) + token
  const long long b = row / (N + 1);
  const int t = static_cast<int>(row - b * (N + 1));
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float v;
    if (t == 0) {
      v = rb<BF16>(cls[d]);
    } else {
      const float x = load_val(prod, kind, (b * N + t - 1) * D + d);
      v = rb<BF16>(__fadd_rn(x, rb<BF16>(bias[d])));
    }
    const float pv = rb<BF16>(pos[static_cast<long long>(t) * D + d]);
    store_val(out, kind, row * D + d, __fadd_rn(v, pv));
  }
}

}  // namespace

// prod: [B, N, D] (kind KIND_F32 or KIND_BF16); bias f32[D], cls f32[D],
// pos f32[N + 1, D]; out: [B, N + 1, D] in prod's kind.
extern "C" int sw_vit_embed(const void* prod, const float* bias, const float* cls,
                            const float* pos, void* out, int B, int N, int D, int kind,
                            void* stream) {
  if (B == 0) return static_cast<int>(cudaGetLastError());
  if (N < 0 || D < 1 || (kind != KIND_F32 && kind != KIND_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(B) * (N + 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == KIND_BF16) {
    vit_embed_kernel<true><<<grid, kThreads, 0, st>>>(prod, bias, cls, pos, out, N, D);
  } else {
    vit_embed_kernel<false><<<grid, kThreads, 0, st>>>(prod, bias, cls, pos, out, N, D);
  }
  return static_cast<int>(cudaGetLastError());
}
