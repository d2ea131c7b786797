// KP frame_patches: camera frames -> the ViT's input patches, normalized and
// cast, in one pass.
//
// Replaces the preprocessing of the classify dispatch,
// sitewhere_tpu/services/streaming_media.py:151-153 (u8 frames widened to
// f32 and normalized on the device: (x / 255 - 0.5) / 0.5), with patchify
// of models/vit.py:75 and the cast to the compute dtype in dense
// (models/common.py:32). The normalization runs op by op in f32 (two exactly
// rounded divisions and a subtraction); after the cast to bf16 that is
// bitwise the reference's jitted form for every u8 value. Pre-normalized
// f32 frames are patchified and cast as they are.
//
// Bound on the H100: bytes. ViT-B/16's batch of 64 frames reads 9.6 MB of
// u8 and writes 19.3 MB of bf16 patches. Design: one block per (frame,
// patch); a patch row is P * C consecutive input values, so consecutive
// threads read consecutive bytes of a frame row and write consecutive
// elements of the patch.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <bool U8, bool BF16>
__global__ void __launch_bounds__(kThreads)
frame_patches_kernel(const void* __restrict__ frames, void* __restrict__ out, int H, int W, int C,
                     int P) {
  const int gw = W / P;
  const int n_patches = (H / P) * gw;
  const long long b = blockIdx.x / n_patches;
  const int n = blockIdx.x - static_cast<int>(b * n_patches);
  const int row_len = P * C;  // one patch row: P pixels of C channels
  const long long base =
      ((b * H + static_cast<long long>(n / gw) * P) * W + static_cast<long long>(n % gw) * P) * C;
  const long long out_base = static_cast<long long>(blockIdx.x) * P * row_len;
  for (int e = threadIdx.x; e < P * row_len; e += kThreads) {
    const int r = e / row_len;
    const long long src = base + static_cast<long long>(r) * W * C + (e - r * row_len);
    float v;
    if constexpr (U8) {
      const float x = static_cast<float>(static_cast<const uint8_t*>(frames)[src]);
      v = __fdiv_rn(__fsub_rn(__fdiv_rn(x, 255.0f), 0.5f), 0.5f);
    } else {
      v = static_cast<const float*>(frames)[src];
    }
    store_val(out, BF16 ? KIND_BF16 : KIND_F32, out_base + e, v);
  }
}

}  // namespace

// frames: [B, H, W, C] (in_kind 0: f32, 1: u8); out: [B, (H/P) * (W/P), P *
// P * C] (out_kind KIND_F32 or KIND_BF16); P divides H and W.
extern "C" int sw_frame_patches(const void* frames, void* out, int B, int H, int W, int C, int P,
                                int in_kind, int out_kind, void* stream) {
  if (B == 0) return static_cast<int>(cudaGetLastError());
  if (P < 1 || C < 1 || H % P || W % P || (in_kind != 0 && in_kind != 1) ||
      (out_kind != KIND_F32 && out_kind != KIND_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(B) * (H / P) * (W / P);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bf16 = out_kind == KIND_BF16;
  if (in_kind == 1) {
    if (bf16) frame_patches_kernel<true, true><<<grid, kThreads, 0, st>>>(frames, out, H, W, C, P);
    else frame_patches_kernel<true, false><<<grid, kThreads, 0, st>>>(frames, out, H, W, C, P);
  } else {
    if (bf16) frame_patches_kernel<false, true><<<grid, kThreads, 0, st>>>(frames, out, H, W, C, P);
    else frame_patches_kernel<false, false><<<grid, kThreads, 0, st>>>(frames, out, H, W, C, P);
  }
  return static_cast<int>(cudaGetLastError());
}
