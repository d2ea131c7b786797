// KO adam_update: one Adam step over every leaf of a slot-stacked param
// tree, in place, with the per-slot learning rate and the freeze of slots
// outside the train mask.
//
// Replaces optax 0.2.6's scale_by_adam update vmapped over the slots and
// the train step's apply / keep_active epilogue
// (sitewhere_tpu/parallel/sharded.py:1168-1187; optax/_src/transform.py
// :285-306). Per element of slot t, with the per-slot bias corrections
// bc1[t] = 1 - b1^count', bc2[t] = 1 - b2^count' computed once by the
// wrapper (sitewhere_tpu_torch/ops/adam.py bias_corrections):
//   mu' = fma(1 - b1, g, b1 * mu)         nu' = fma(1 - b2, g * g, b2 * nu)
//   u   = mu' / (bc1 * (sqrt(nu' / bc2) + eps))
//   p'  = fma(-lr[t], u, p)
// the arithmetic the reference's compiled step performs on the CPU (XLA
// contracts the first product of each moment and the param update into
// FMAs and folds the two divisions), each op written with an _rn
// intrinsic so nvcc contracts nothing else. Slots outside the mask keep
// p, mu, nu and count bitwise (nothing is written). count' = count + 1,
// saturating, is written for the masked-in slots.
//
// Bound on the H100: bytes. Each element reads p, g, mu, nu and writes p,
// mu, nu: 28 bytes; at tenants32 (32 slots x 17,217 LSTM-AD params)
// 15.4 MB, ~4.6 us at 3.35 TB/s, under the launch latency. Design: one
// launch for up to 16 leaves (a tree with more, the transformer's 71 at
// depth 4, takes one launch per 16 from the same C call); the leaf table
// (pointers and the per-slot element count) travels by value in the
// kernel's parameters, blockIdx.y picks the leaf and a grid-stride loop
// walks its [T, n] elements with coalesced 4-byte accesses. No atomics:
// every element is written by one thread.
#include "common.cuh"

namespace {

constexpr int kMaxLeaves = 16;
constexpr int kThreads = 256;

struct Leaf {
  float* p; const float* g; float* mu; float* nu; long long n;
};

struct KoArgs {
  Leaf leaf[kMaxLeaves];
  const float* lr; const float* bc1; const float* bc2; const unsigned char* mask;
  int* count; const int* count_inc; int T; int write_count;
};

__global__ void __launch_bounds__(kThreads) adam_update_kernel(const KoArgs a) {
  const Leaf L = a.leaf[blockIdx.y];
  const long long total = L.n * a.T;
  const float c1 = 0.1f, b1 = 0.9f, c2 = 0.001f, b2 = 0.999f, eps = 1e-8f;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const int t = static_cast<int>(i / L.n);
    if (!a.mask[t]) continue;
    const float g = L.g[i];
    const float mu = __fmaf_rn(c1, g, __fmul_rn(b1, L.mu[i]));
    const float nu = __fmaf_rn(c2, __fmul_rn(g, g), __fmul_rn(b2, L.nu[i]));
    const float den = __fmul_rn(a.bc1[t], __fadd_rn(__fsqrt_rn(__fdiv_rn(nu, a.bc2[t])), eps));
    const float u = __fdiv_rn(mu, den);
    L.p[i] = __fmaf_rn(-a.lr[t], u, L.p[i]);
    L.mu[i] = mu;
    L.nu[i] = nu;
  }
  if (a.write_count && blockIdx.x == 0 && blockIdx.y == 0) {
    for (int t = threadIdx.x; t < a.T; t += kThreads) {
      if (a.mask[t]) a.count[t] = a.count_inc[t];
    }
  }
}

}  // namespace

// table: n_leaves rows of (p, g, mu, nu, elements per slot), host memory.
extern "C" int sw_adam_update(const long long* table, int n_leaves, int T, const float* lr,
                              const float* bc1, const float* bc2, const unsigned char* mask,
                              int* count, const int* count_inc, void* stream) {
  if (n_leaves < 1 || T < 1) return static_cast<int>(cudaErrorInvalidValue);
  for (int first = 0; first < n_leaves; first += kMaxLeaves) {
    const int n = n_leaves - first < kMaxLeaves ? n_leaves - first : kMaxLeaves;
    KoArgs a{};
    long long most = 0;
    for (int l = 0; l < n; ++l) {
      const long long* row = table + 5 * (first + l);
      a.leaf[l] = Leaf{reinterpret_cast<float*>(row[0]), reinterpret_cast<const float*>(row[1]),
                       reinterpret_cast<float*>(row[2]), reinterpret_cast<float*>(row[3]), row[4]};
      most = row[4] * T > most ? row[4] * T : most;
    }
    a.lr = lr; a.bc1 = bc1; a.bc2 = bc2; a.mask = mask;
    a.count = count; a.count_inc = count_inc; a.T = T; a.write_count = first == 0;
    long long blocks = (most + kThreads - 1) / kThreads;
    blocks = blocks < 1 ? 1 : (blocks > 1024 ? 1024 : blocks);
    adam_update_kernel<<<dim3(static_cast<unsigned>(blocks), n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
