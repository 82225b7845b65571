// K1: fused mixture-weight combine, out[b,c] = bias[c] + sum_n w[n]*logits[n,b,c].
//
// Replaces: adanet_tpu/ops/ensemble_kernels.py `_combine_kernel` (launched
// by `_combine_pallas`), the forward of `fused_weighted_combine`.
//
// Bound: bytes. Each output element reads N logits and writes one f32;
// the N-term sum is a handful of FMAs, far below the card's ratio of
// operations to bytes. Design: one thread per output element (b, c), the
// member loop in registers in f32 (members summed in order n = 0..N-1, as
// the TPU kernel unrolls them), the stacked logits read exactly once and
// no [N, B, C] intermediate written. Weights are scalar per member ([N])
// or per class ([N, C]); a null bias adds nothing.

#include <cuda_runtime.h>

__global__ void combine_kernel(const float* __restrict__ logits,
                               const float* __restrict__ weights,
                               const float* __restrict__ bias,
                               float* __restrict__ out, int n, int bc, int c,
                               int vector_weights) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= bc) return;
  int col = idx % c;
  float acc = 0.0f;
  for (int m = 0; m < n; ++m) {
    float w = vector_weights ? weights[m * c + col] : weights[m];
    acc += logits[(long long)m * bc + idx] * w;
  }
  if (bias != nullptr) acc += bias[col];
  out[idx] = acc;
}

extern "C" int combine_forward(const float* logits, const float* weights,
                               const float* bias, float* out, int n, int b,
                               int c, int vector_weights, void* stream) {
  int bc = b * c;
  if (bc == 0) return 0;
  const int threads = 128;
  int blocks = (bc + threads - 1) / threads;
  combine_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      logits, weights, bias, out, n, bc, c, vector_weights);
  return (int)cudaGetLastError();
}
