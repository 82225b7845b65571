// K3: one whole NASNet-A cell in folded-affine form (every batch norm a
// per-channel scale and bias), NHWC, as four kernels the wrapper
// (`adanet_tpu_torch/ops/cell_kernels.py: fused_cell`) launches in order
// on one stream.
//
// Replaces: adanet_tpu/ops/cell_kernels.py `_cell_kernel` (running
// `_cell_body`), launched by `_pallas_forward`, the forward of
// `fused_cell`.
//
// Why not one block per cell: the TPU kernel keeps a batch tile's whole
// state list in VMEM (`_bytes_per_example`: about 3.4 MB for one
// 32x32 example at Cp = Cc = 192, F = 32). A Hopper block has 227 KB of
// shared memory, so the cell is cut into its branch ops instead:
//
//   (a) conv1x1_kernel: optional relu, optional stride-2 subsample,
//       optional (1, 1) shift with zero fill past the bottom and right
//       edge, the 1x1 product in f32, the affine. It serves `begin`,
//       `prev`, the strided `none` branch and both paths of the
//       factorized reduction (no relu, F/2 channels each).
//   (b) sep_layer_kernel: relu, k x k depthwise (TF SAME, stride), the
//       pointwise product in f32, the affine.
//   (c) pool_kernel: 3x3 SAME avg (count_include_pad: always / 9) or max
//       (-inf fill) with stride; mode 0 is the f32 copy of the stride-1
//       `none` identity and of an unprojected `prev` (no relu).
//   (d) cast_bf16_kernel: the f32 concat to bf16, only where `cur` is.
//
// Every kernel writes, or with `accumulate` adds into, a channel slot of
// an f32 state buffer: a base pointer at the slot's first channel and a
// pixel stride (the buffer's channel count). The block's `left + right`
// is the second branch adding onto the first (the same f32 sum as the
// TPU kernel's), and the final concat is the layout of the output buffer,
// not a pass of its own: the unused states at the output resolution are
// written straight into their slots. Intermediate states stay f32, as in
// VMEM; only the output is rounded.
//
// Bound: at NASNet-A's CIFAR widths a cell does about 2 * (pixels) *
// (1x1 and pointwise C * F + depthwise k * k * F) flops per layer for a
// few bytes per pixel and channel, so the bound is bytes at bf16 tensor
// core rates; on CUDA cores (this design) the products dominate. Design:
// pixels of the flattened (batch, row, column) output are cut into tiles
// of `tile_p` (the autotuned knob); the products are register-tiled, 4
// pixels x 4 channels a thread over 256 threads, from shared memory
// (conflict-free: A rows padded by one float, B read along channels).
// (b) keeps the depthwise tile in shared memory, so that intermediate
// never reaches device memory; (a) streams its input channels in chunks
// of 32, so any channel count fits. Plain CUDA cores, no tensor cores:
// wgmma and TMA are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;    // pixels per thread in a product sub-tile
constexpr int kCols = 4;    // output channels per thread
constexpr int kChunk = 32;  // input channels per stage in (a)
// (a)'s static stages: at most 128 sub-tile rows (8 threads along the
// channels) and 64 sub-tile columns (16 threads along the channels).
constexpr int kMaxSubRows = kRows * kThreads / 8;
constexpr int kMaxSubCols = kCols * 16;

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

// acc[i][j] += sum_{c < kc} A[aoff[i] + c] * Bm[c * ldb + boff[j]].
__device__ __forceinline__ void product(float (&acc)[kRows][kCols],
                                        const float* A, const int (&aoff)[kRows],
                                        const float* Bm, const int (&boff)[kCols],
                                        int ldb, int kc) {
  for (int c = 0; c < kc; ++c) {
    float a[kRows], b[kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i) a[i] = A[aoff[i] + c];
#pragma unroll
    for (int j = 0; j < kCols; ++j) b[j] = Bm[c * ldb + boff[j]];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// out[q * out_stride + f] (=|+=) acc * scale[f] + bias[f] for the valid
// rows and columns of one sub-tile.
__device__ __forceinline__ void epilogue(float (&acc)[kRows][kCols],
                                         float* out, int out_stride,
                                         int accumulate, long long q_first,
                                         int row0, int nrows, int rstep,
                                         int col0, int ncols, int cstep,
                                         const float* scale,
                                         const float* bias) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    int row = row0 + rstep * i;
    if (row >= nrows) continue;
    float* o = out + (q_first + row) * out_stride;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      int col = col0 + cstep * j;
      if (col >= ncols) continue;
      float v = acc[i][j] * scale[col] + bias[col];
      o[col] = accumulate ? o[col] + v : v;
    }
  }
}

// (a) 1x1 product. One block owns `tile_p` output pixels and loops over
// sub-tiles of (threads along pixels * kRows) x (tf * kCols), streaming
// the input channels in chunks of kChunk through shared memory.
template <typename T>
__global__ void conv1x1_kernel(const T* __restrict__ x, int x_stride,
                               const float* __restrict__ w,  // [F][C]
                               const float* __restrict__ scale,
                               const float* __restrict__ bias,
                               float* __restrict__ out, int out_stride,
                               int accumulate, int B, int H, int W, int C,
                               int F, int S, int shift, int relu, int Ho,
                               int Wo, int tile_p, int tf) {
  __shared__ float s_x[kMaxSubRows * (kChunk + 1)];  // [rows][kChunk + 1]
  __shared__ float s_w[kChunk * (kMaxSubCols + 1)];  // [kChunk][cols + 1]
  const int tp = kThreads / tf;
  const int sub_r = tp * kRows, sub_c = tf * kCols, ldw = sub_c + 1;
  const int tx = threadIdx.x % tf, ty = threadIdx.x / tf;
  const long long total = (long long)B * Ho * Wo;
  const long long q0 = (long long)blockIdx.x * tile_p;
  const int np = (int)min((long long)tile_p, total - q0);

  for (int r0 = 0; r0 < np; r0 += sub_r) {
    const int nr = min(sub_r, np - r0);
    for (int c0 = 0; c0 < F; c0 += sub_c) {
      const int nc = min(sub_c, F - c0);
      float acc[kRows][kCols] = {};
      int aoff[kRows], boff[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        aoff[i] = min(ty + tp * i, nr - 1) * (kChunk + 1);
#pragma unroll
      for (int j = 0; j < kCols; ++j) boff[j] = min(tx + tf * j, nc - 1);
      for (int k0 = 0; k0 < C; k0 += kChunk) {
        const int kc = min(kChunk, C - k0);
        __syncthreads();  // the previous chunk is consumed
        for (int i = threadIdx.x; i < nr * kc; i += kThreads) {
          int rr = i / kc, cc = i % kc;
          long long q = q0 + r0 + rr;
          int b = (int)(q / (Ho * Wo));
          int r = (int)(q % (Ho * Wo));
          int ih = (r / Wo) * S + shift, iw = (r % Wo) * S + shift;
          float v = 0.0f;  // zero fill past the edge (shifted path)
          if (ih < H && iw < W)
            v = load_f32<T>(x + (((long long)b * H + ih) * W + iw) * x_stride +
                            k0 + cc);
          if (relu) v = fmaxf(v, 0.0f);
          s_x[rr * (kChunk + 1) + cc] = v;
        }
        for (int i = threadIdx.x; i < nc * kc; i += kThreads) {
          int ff = i / kc, cc = i % kc;
          s_w[cc * ldw + ff] = w[(long long)(c0 + ff) * C + k0 + cc];
        }
        __syncthreads();
        product(acc, s_x, aoff, s_w, boff, ldw, kc);
      }
      epilogue(acc, out, out_stride, accumulate, q0 + r0, ty, nr, tp,
               c0 + tx, F, tf, scale, bias);
    }
  }
}

// (b) one separable layer. One block owns `tile_p` output pixels and
// `tile_f` output channels: the depthwise taps and the pointwise chunk
// staged in shared memory, the depthwise tile computed into shared
// memory, then the product in register sub-tiles.
__global__ void sep_layer_kernel(const float* __restrict__ x, int x_stride,
                                 const float* __restrict__ dw,  // [C][K*K]
                                 const float* __restrict__ pw,  // [F][C]
                                 const float* __restrict__ scale,
                                 const float* __restrict__ bias,
                                 float* __restrict__ out, int out_stride,
                                 int accumulate, int B, int H, int W, int C,
                                 int F, int K, int S, int Ho, int Wo, int pt,
                                 int pl, int tile_p, int tile_f, int tf) {
  extern __shared__ float smem[];
  const int KK = K * K, lda = C + 1, ldb = tile_f + 1;
  float* s_a = smem;                // [tile_p][lda]
  float* s_w = s_a + tile_p * lda;  // [C][ldb]
  float* s_dw = s_w + C * ldb;      // [KK][C]
  const long long total = (long long)B * Ho * Wo;
  const long long q0 = (long long)blockIdx.x * tile_p;
  const int np = (int)min((long long)tile_p, total - q0);
  const int f0 = blockIdx.y * tile_f;
  const int nf = min(tile_f, F - f0);

  for (int i = threadIdx.x; i < C * KK; i += kThreads) {
    int c = i / KK, t = i % KK;
    s_dw[t * C + c] = dw[i];
  }
  for (int i = threadIdx.x; i < nf * C; i += kThreads) {
    int f = i / C, c = i % C;
    s_w[c * ldb + f] = pw[(long long)(f0 + f) * C + c];
  }
  __syncthreads();

  // Depthwise: neighbouring threads take neighbouring channels of one
  // pixel (coalesced NHWC reads); taps in row-major order, the SAME halo
  // bounds-checked (a padded tap adds relu(0) * w = 0).
  for (int i = threadIdx.x; i < np * C; i += kThreads) {
    int pp = i / C, c = i % C;
    long long q = q0 + pp;
    int b = (int)(q / (Ho * Wo));
    int r = (int)(q % (Ho * Wo));
    int ih0 = (r / Wo) * S - pt, iw0 = (r % Wo) * S - pl;
    const float* xb = x + (long long)b * H * W * x_stride + c;
    float acc = 0.0f;
    for (int ki = 0; ki < K; ++ki) {
      int ih = ih0 + ki;
      if (ih < 0 || ih >= H) continue;
      for (int kj = 0; kj < K; ++kj) {
        int iw = iw0 + kj;
        if (iw < 0 || iw >= W) continue;
        float v = fmaxf(xb[((long long)ih * W + iw) * x_stride], 0.0f);
        acc = fmaf(v, s_dw[(ki * K + kj) * C + c], acc);
      }
    }
    s_a[pp * lda + c] = acc;
  }
  __syncthreads();

  const int tp = kThreads / tf;
  const int sub_r = tp * kRows, sub_c = tf * kCols;
  const int tx = threadIdx.x % tf, ty = threadIdx.x / tf;
  for (int r0 = 0; r0 < np; r0 += sub_r) {
    const int nr = min(sub_r, np - r0);
    for (int c0 = 0; c0 < nf; c0 += sub_c) {
      const int nc = min(sub_c, nf - c0);
      float acc[kRows][kCols] = {};
      int aoff[kRows], boff[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        aoff[i] = (r0 + min(ty + tp * i, nr - 1)) * lda;
#pragma unroll
      for (int j = 0; j < kCols; ++j) boff[j] = c0 + min(tx + tf * j, nc - 1);
      product(acc, s_a, aoff, s_w, boff, ldb, C);
      epilogue(acc, out + f0, out_stride, accumulate, q0 + r0, ty, nr, tp,
               c0 + tx, nf, tf, scale + f0, bias + f0);
    }
  }
}

// (c) 3x3 SAME pool (mode 1 avg, 2 max) or the identity copy (mode 0),
// one thread per (pixel, channel), `tile_p` pixels a block.
template <typename T>
__global__ void pool_kernel(const T* __restrict__ x, int x_stride,
                            float* __restrict__ out, int out_stride,
                            int accumulate, int B, int H, int W, int C,
                            int mode, int S, int Ho, int Wo, int pt, int pl,
                            int tile_p) {
  const long long total = (long long)B * Ho * Wo;
  const long long q0 = (long long)blockIdx.x * tile_p;
  const int np = (int)min((long long)tile_p, total - q0);
  for (int i = threadIdx.x; i < np * C; i += kThreads) {
    int pp = i / C, c = i % C;
    long long q = q0 + pp;
    int b = (int)(q / (Ho * Wo));
    int r = (int)(q % (Ho * Wo));
    int oh = r / Wo, ow = r % Wo;
    const T* xb = x + (long long)b * H * W * x_stride + c;
    float v;
    if (mode == 0) {
      v = load_f32<T>(xb + ((long long)oh * W + ow) * x_stride);
    } else {
      const bool is_max = mode == 2;
      float acc = is_max ? __int_as_float((int)0xff800000) : 0.0f;  // -inf
      for (int ki = 0; ki < 3; ++ki) {
        int ih = oh * S - pt + ki;
        if (ih < 0 || ih >= H) continue;  // avg: a padded tap adds 0
        for (int kj = 0; kj < 3; ++kj) {
          int iw = ow * S - pl + kj;
          if (iw < 0 || iw >= W) continue;  // max: a padded tap is -inf
          float t = load_f32<T>(xb + ((long long)ih * W + iw) * x_stride);
          acc = is_max ? fmaxf(acc, t) : acc + t;
        }
      }
      v = is_max ? acc : acc / 9.0f;
    }
    float* o = out + q * out_stride + c;
    *o = accumulate ? *o + v : v;
  }
}

// (d) the f32 concat to bf16.
__global__ void cast_bf16_kernel(const float* __restrict__ x,
                                 __nv_bfloat16* __restrict__ y,
                                 long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long step = (long long)gridDim.x * blockDim.x;
  for (; i < n; i += step) y[i] = __float2bfloat16(x[i]);
}

unsigned grid_for(long long total, int tile_p) {
  return (unsigned)((total + tile_p - 1) / tile_p);
}

}  // namespace

extern "C" int cell_conv1x1(const void* x, int x_stride, const float* w,
                            const float* scale, const float* bias, float* out,
                            int out_stride, int accumulate, int B, int H,
                            int W, int C, int F, int S, int shift, int relu,
                            int Ho, int Wo, int tile_p, int tf, int is_bf16,
                            void* stream) {
  long long total = (long long)B * Ho * Wo;
  if (total == 0 || F == 0) return 0;
  if (tile_p < 1 || (tf != 8 && tf != 16)) return (int)cudaErrorInvalidValue;
  dim3 grid(grid_for(total, tile_p));
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    conv1x1_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)x, x_stride, w, scale, bias, out, out_stride,
        accumulate, B, H, W, C, F, S, shift, relu, Ho, Wo, tile_p, tf);
  else
    conv1x1_kernel<float><<<grid, kThreads, 0, s>>>(
        (const float*)x, x_stride, w, scale, bias, out, out_stride,
        accumulate, B, H, W, C, F, S, shift, relu, Ho, Wo, tile_p, tf);
  return (int)cudaGetLastError();
}

extern "C" int cell_sep_layer(const float* x, int x_stride, const float* dw,
                              const float* pw, const float* scale,
                              const float* bias, float* out, int out_stride,
                              int accumulate, int B, int H, int W, int C,
                              int F, int K, int S, int Ho, int Wo, int pt,
                              int pl, int tile_p, int tile_f, int tf,
                              void* stream) {
  long long total = (long long)B * Ho * Wo;
  if (total == 0 || F == 0) return 0;
  if (tile_p < 1 || tile_f < 1 || (tf != 8 && tf != 16))
    return (int)cudaErrorInvalidValue;
  size_t smem = sizeof(float) * ((size_t)tile_p * (C + 1) +
                                 (size_t)C * (tile_f + 1) + (size_t)K * K * C);
  static bool wide_smem = false;  // set once, not per launch
  if (smem > 48 * 1024 && !wide_smem) {
    cudaError_t err = cudaFuncSetAttribute(
        sep_layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        227 * 1024);
    if (err != cudaSuccess) return (int)err;
    wide_smem = true;
  }
  dim3 grid(grid_for(total, tile_p), (F + tile_f - 1) / tile_f);
  sep_layer_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, x_stride, dw, pw, scale, bias, out, out_stride, accumulate, B, H, W,
      C, F, K, S, Ho, Wo, pt, pl, tile_p, tile_f, tf);
  return (int)cudaGetLastError();
}

extern "C" int cell_pool(const void* x, int x_stride, float* out,
                         int out_stride, int accumulate, int B, int H, int W,
                         int C, int mode, int S, int Ho, int Wo, int pt,
                         int pl, int tile_p, int is_bf16, void* stream) {
  long long total = (long long)B * Ho * Wo;
  if (total == 0 || C == 0) return 0;
  if (tile_p < 1 || mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  dim3 grid(grid_for(total, tile_p));
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    pool_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)x, x_stride, out, out_stride, accumulate, B, H,
        W, C, mode, S, Ho, Wo, pt, pl, tile_p);
  else
    pool_kernel<float><<<grid, kThreads, 0, s>>>(
        (const float*)x, x_stride, out, out_stride, accumulate, B, H, W, C,
        mode, S, Ho, Wo, pt, pl, tile_p);
  return (int)cudaGetLastError();
}

extern "C" int cell_cast_bf16(const float* x, void* y, long long n,
                              void* stream) {
  if (n <= 0) return 0;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 4096) blocks = 4096;
  cast_bf16_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      x, (__nv_bfloat16*)y, n);
  return (int)cudaGetLastError();
}
