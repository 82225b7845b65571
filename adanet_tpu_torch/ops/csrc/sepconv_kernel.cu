// K2: fused separable convolution, relu -> k x k depthwise (TF "SAME"
// padding, stride s) -> 1 x 1 pointwise, NHWC, in one pass.
//
// Replaces: adanet_tpu/ops/sepconv_kernels.py `_sepconv_kernel` (launched
// by `_pallas_forward`), the forward of `fused_sep_conv` that every NASNet-A
// separable op runs when `use_pallas_sep_conv` is set.
//
// Arithmetic, as in the TPU kernel: relu in the input dtype, the k*k taps
// multiplied and summed in f32 (taps in row-major order), the depthwise
// result kept in f32 into the pointwise product, the pointwise sum in f32,
// the output stored in the input dtype. Weights arrive in f32 and are
// rounded to the input dtype first, as the JAX caller casts them to the
// compute dtype before the kernel.
//
// Bound: at the NASNet-A CIFAR shapes (C = F <= 128) each output pixel
// does k*k*C + C*F multiply-adds for 2*(C + F) bytes of bf16 traffic, a
// ratio well under the card's, so the kernel is bound by bytes when it
// is bound by anything; at batch <= 32 the grid is small and launch
// latency dominates. Design for that: read x once from device memory
// (the halo re-reads hit L1/L2), write out once, keep the [tile, C]
// depthwise tile in shared memory so the intermediate never reaches
// device memory, and bounds-check the SAME halo instead of materialising
// a padded copy of x (the TPU kernel pads with jnp.pad first). One block
// owns a tile of output pixels of one image and a chunk of output
// channels; grid = (pixel tiles, batch, channel chunks). Shared memory:
// the tile [tile_p][C], the pointwise chunk staged as [C][tile_f + 1]
// (the +1 keeps the transposing stores off one bank), and the depthwise
// taps as [k*k][C], all f32: about 105 KB at C = F = 128, k = 7, hence
// dynamic shared memory above the 48 KB default. The wrapper shrinks
// tile_f and tile_p until the total fits in 227 KB, so any shape tiles.
// Plain CUDA cores, no tensor cores: wgmma/TMA are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

template <typename T>
__device__ __forceinline__ float load_f32(const T* p);
template <>
__device__ __forceinline__ float load_f32<float>(const float* p) {
  return *p;
}
template <>
__device__ __forceinline__ float load_f32<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__device__ __forceinline__ T store_as(float v);
template <>
__device__ __forceinline__ float store_as<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 store_as<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// The weight as the input dtype would hold it, back in f32.
template <typename T>
__device__ __forceinline__ float round_weight(float w);
template <>
__device__ __forceinline__ float round_weight<float>(float w) {
  return w;
}
template <>
__device__ __forceinline__ float round_weight<__nv_bfloat16>(float w) {
  return __bfloat162float(__float2bfloat16(w));
}

template <typename T>
__global__ void sepconv_kernel(const T* __restrict__ x,
                               const float* __restrict__ dw,  // [C][k*k]
                               const float* __restrict__ pw,  // [F][C]
                               T* __restrict__ out, int H, int W, int C,
                               int F, int K, int S, int Ho, int Wo, int pt,
                               int pl, int tile_p, int tile_f) {
  extern __shared__ float smem[];
  const int KK = K * K;
  const int ld_pw = tile_f + 1;
  float* s_tile = smem;                     // [tile_p][C]
  float* s_pw = s_tile + tile_p * C;        // [C][ld_pw]
  float* s_dw = s_pw + C * ld_pw;           // [KK][C]

  const int b = blockIdx.y;
  const int P = Ho * Wo;
  const int p0 = blockIdx.x * tile_p;
  const int f0 = blockIdx.z * tile_f;
  const int np = min(tile_p, P - p0);
  const int nf = min(tile_f, F - f0);
  const T* xb = x + (long long)b * H * W * C;

  for (int i = threadIdx.x; i < C * KK; i += blockDim.x) {
    int c = i / KK, t = i % KK;
    s_dw[t * C + c] = round_weight<T>(dw[i]);
  }
  for (int i = threadIdx.x; i < nf * C; i += blockDim.x) {
    int f = i / C, c = i % C;
    s_pw[c * ld_pw + f] = round_weight<T>(pw[(long long)(f0 + f) * C + c]);
  }
  __syncthreads();

  // Depthwise: neighbouring threads take neighbouring channels of one
  // pixel, so every tap is a coalesced NHWC read.
  for (int i = threadIdx.x; i < np * C; i += blockDim.x) {
    int pp = i / C, c = i % C;
    int p = p0 + pp;
    int ih0 = (p / Wo) * S - pt;
    int iw0 = (p % Wo) * S - pl;
    float acc = 0.0f;
    for (int ki = 0; ki < K; ++ki) {
      int ih = ih0 + ki;
      if (ih < 0 || ih >= H) continue;  // top/bottom SAME halo
      const T* row = xb + (long long)ih * W * C;
      for (int kj = 0; kj < K; ++kj) {
        int iw = iw0 + kj;
        if (iw < 0 || iw >= W) continue;  // left/right SAME halo
        float v = fmaxf(load_f32<T>(row + (long long)iw * C + c), 0.0f);
        acc += v * s_dw[(ki * K + kj) * C + c];
      }
    }
    s_tile[pp * C + c] = acc;
  }
  __syncthreads();

  // Pointwise: neighbouring threads take neighbouring output channels of
  // one pixel: the tile row is a broadcast read, the weights a
  // conflict-free row, the store coalesced.
  for (int i = threadIdx.x; i < np * nf; i += blockDim.x) {
    int pp = i / nf, f = i % nf;
    const float* a = s_tile + pp * C;
    float acc = 0.0f;
    for (int c = 0; c < C; ++c) acc += a[c] * s_pw[c * ld_pw + f];
    out[((long long)b * P + p0 + pp) * F + f0 + f] = store_as<T>(acc);
  }
}

template <typename T>
static int launch(const void* x, const float* dw, const float* pw, void* out,
                  int B, int H, int W, int C, int F, int K, int S, int Ho,
                  int Wo, int pt, int pl, int tile_p, int tile_f,
                  cudaStream_t stream) {
  size_t smem = sizeof(float) * ((size_t)tile_p * C +
                                 (size_t)C * (tile_f + 1) + (size_t)K * K * C);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sepconv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int P = Ho * Wo;
  dim3 grid((P + tile_p - 1) / tile_p, B, (F + tile_f - 1) / tile_f);
  sepconv_kernel<T><<<grid, 256, smem, stream>>>(
      (const T*)x, dw, pw, (T*)out, H, W, C, F, K, S, Ho, Wo, pt, pl, tile_p,
      tile_f);
  return (int)cudaGetLastError();
}

extern "C" int sepconv_forward(const void* x, const float* dw,
                               const float* pw, void* out, int B, int H,
                               int W, int C, int F, int K, int S, int Ho,
                               int Wo, int pt, int pl, int tile_p,
                               int tile_f, int is_bf16, void* stream) {
  if (B == 0 || Ho * Wo == 0 || F == 0) return 0;
  if (is_bf16)
    return launch<__nv_bfloat16>(x, dw, pw, out, B, H, W, C, F, K, S, Ho, Wo,
                                 pt, pl, tile_p, tile_f,
                                 (cudaStream_t)stream);
  return launch<float>(x, dw, pw, out, B, H, W, C, F, K, S, Ho, Wo, pt, pl,
                       tile_p, tile_f, (cudaStream_t)stream);
}
