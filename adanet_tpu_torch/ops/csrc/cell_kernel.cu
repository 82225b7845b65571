// K3: one whole NASNet-A cell in folded-affine form (every batch norm a
// per-channel scale and bias), NHWC, as four kernels the wrapper
// (`adanet_tpu_torch/ops/cell_kernels.py: fused_cell`) launches in order
// on one stream, following a schedule it plans once per cell signature.
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
//       edge, the 1x1 product, the affine. It serves `begin`, `prev`, the
//       strided `none` branch and both paths of the factorized reduction
//       (no relu, F/2 channels each).
//   (b) sep_layer_kernel: relu, k x k depthwise (TF SAME, stride), the
//       pointwise product, the affine.
//   (c) pool_kernel: one or two 3x3 SAME pools (avg, count_include_pad:
//       always / 9; max, -inf fill) or identity copies, summed: a block
//       whose two branches are both pools or identities is one launch.
//       A copy also brings an unprojected `prev` into f32.
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
// Bound: at NASNet-A's CIFAR widths one launch moves 0.3-13 MB and does
// 10-400 MFLOP, a few us at the card's peaks, bytes the larger. What held
// the first design back was parallelism (32 blocks at 8x8 on 132 SMs),
// products on CUDA cores from scalar loads, every depthwise tap read from
// device memory and the weights cast on every call. This design:
// - The wrapper plans every launch on the host once per signature (the
//   `*Plan` structs below, field for field `cell_kernels.*_FIELDS`),
//   sized from the output and the SM count: a bucket-32 launch has at
//   least one block per SM, output channels split where pixels run short.
// - Weights arrive prepared once per tensor version: 1x1 and pointwise
//   as [C][F] f32, depthwise as [k*k][C] f32, so blocks copy rows with
//   16-byte loads and nothing is cast per call.
// - Products: with bf16 activations on the tensor cores (mma.sync
//   m16n8k8, TF32 inputs, f32 sums; a bf16 value is exact in TF32, an f32
//   state keeps 10 mantissa bits, more than the bf16 output's 8); with f32
//   activations CUDA-core FMAs in full f32, so the 1e-4 check holds.
// - (a) streams input channels in chunks (32 to 128, as wide as the
//   shared-memory target allows: each chunk costs a wait) through two
//   shared-memory stages filled with cp.async, so chunk i + 1 loads while
//   chunk i multiplies.
// - (b) follows K2 (sepconv_kernel.cu): per chunk of input channels the
//   input rows are staged once with their SAME halo (16-byte loads,
//   relu), the depthwise runs from shared memory with loops templated on
//   k in {3, 5, 7} and stride in {1, 2}, and the output tile leaves
//   through shared memory with 16-byte stores, the affine applied and the
//   slot written or added to at its pixel stride. Its plan is K2's
//   (`sepconv_kernels.launch_plan` at f32 staging).
// - (c) and (d) move four channels a thread with vector loads.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4;   // output pixels of a row per depthwise item
constexpr int kBatch = 4;  // 16-byte loads of each kind a thread keeps in flight
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// d += a (16x8, tf32, row) * b (8x8, tf32, col), f32 accumulate.
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes from global to shared memory, asynchronously; `ok` false
// writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float4 relu4(float4 v) {
  return make_float4(fmaxf(v.x, 0.0f), fmaxf(v.y, 0.0f), fmaxf(v.z, 0.0f),
                     fmaxf(v.w, 0.0f));
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <typename K>
int wide_smem(K kernel, int smem, bool& done) {
  if (smem <= 48 * 1024 || done) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return (int)err;
  done = true;
  return 0;
}

// ----------------------------------------------------------------- (a)

// Field for field cell_kernels.CONV_FIELDS.
struct ConvPlan {
  int B, H, W, C, F, S, shift, relu, Ho, Wo;
  int x_stride;  // input channels per pixel (the buffer's)
  int o_stride;  // output channels per pixel (the slot's buffer's)
  int accumulate;
  int tp;   // output pixels per block (a multiple of 16)
  int tf;   // output channels per block (a multiple of 8, or F)
  int kc;   // input channels per stage (a multiple of 8)
  int lda;  // row stride (elements) of a staged input tile [tp][lda]
  int ldb;  // row stride (floats) of a staged weight tile [kc][ldb]
  int smem;
  int mma;
  int is_bf16;
};

// x: [B][H][W] pixels of x_stride T from the slot's first channel;
// w: [C][F] f32; out: [B][Ho][Wo] pixels of o_stride f32.
template <typename T, bool kMma>
__global__ void __launch_bounds__(kThreads)
    conv1x1_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias, float* __restrict__ out,
                   ConvPlan p, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* pix = reinterpret_cast<long long*>(smem_raw);  // [tp]
  const int a_bytes = p.tp * p.lda * (int)sizeof(T);
  const int b_bytes = p.kc * p.ldb * 4;
  unsigned char* stages = smem_raw + p.tp * 8;
  const int tid = threadIdx.x;
  const long long total = (long long)p.B * p.Ho * p.Wo;
  const long long q0 = (long long)blockIdx.x * p.tp;
  const int f0 = blockIdx.y * p.tf;
  const int tf8 = (p.tf + 7) & ~7;

  // Each output pixel's input offset, -1 past the edge (zero fill) or
  // past the last pixel.
  for (int i = tid; i < p.tp; i += kThreads) {
    const long long q = q0 + i;
    long long off = -1;
    if (q < total) {
      const int hw = p.Ho * p.Wo;
      const int b = (int)(q / hw), r = (int)(q % hw);
      const int ih = (r / p.Wo) * p.S + p.shift, iw = (r % p.Wo) * p.S + p.shift;
      if (ih < p.H && iw < p.W) off = (((long long)b * p.H + ih) * p.W + iw) * p.x_stride;
    }
    pix[i] = off;
  }
  __syncthreads();

  auto stage = [&](int s, int k0) {
    T* A = reinterpret_cast<T*>(stages + s * (a_bytes + b_bytes));
    float* Bm = reinterpret_cast<float*>(stages + s * (a_bytes + b_bytes) + a_bytes);
    if (vec) {
      constexpr int VA = 16 / (int)sizeof(T);
      const int nav = p.kc / VA;
      for (int i = tid; i < p.tp * nav; i += kThreads) {
        const int r = i / nav, c = (i % nav) * VA;
        const long long off = pix[r];
        const bool ok = off >= 0 && k0 + c < p.C;
        cp_async16(A + r * p.lda + c, ok ? (const void*)(x + off + k0 + c) : (const void*)x, ok);
      }
      const int nbv = tf8 / 4;
      for (int i = tid; i < p.kc * nbv; i += kThreads) {
        const int c = i / nbv, e = (i % nbv) * 4;
        const bool ok = k0 + c < p.C && e < p.tf && f0 + e < p.F;
        cp_async16(Bm + c * p.ldb + e,
                   ok ? (const void*)(w + (long long)(k0 + c) * p.F + f0 + e) : (const void*)w, ok);
      }
    } else {
      // Odd channel counts or unaligned slots: element loads.
      for (int i = tid; i < p.tp * p.kc; i += kThreads) {
        const int r = i / p.kc, c = i % p.kc;
        const long long off = pix[r];
        A[r * p.lda + c] = (off >= 0 && k0 + c < p.C) ? x[off + k0 + c] : from_f32<T>(0.0f);
      }
      for (int i = tid; i < p.kc * tf8; i += kThreads) {
        const int c = i / tf8, e = i % tf8;
        Bm[c * p.ldb + e] = (k0 + c < p.C && e < p.tf && f0 + e < p.F)
                                ? w[(long long)(k0 + c) * p.F + f0 + e]
                                : 0.0f;
      }
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int n_tiles = tf8 / 8;
  const int mma_tiles = (p.tp / 16) * n_tiles;
  const int gf = ((p.tf + 3) & ~3) / 4;
  const bool fma_thread = !kMma && tid < (p.tp / 4) * gf;
  const int fg = tid % gf, pg = tid / gf;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }

  const int nk = (p.C + p.kc - 1) / p.kc;
  stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      stage((kt + 1) & 1, (kt + 1) * p.kc);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* base = stages + (kt & 1) * (a_bytes + b_bytes);
    const T* A = reinterpret_cast<const T*>(base);
    const float* Bm = reinterpret_cast<const float*>(base + a_bytes);
    if constexpr (kMma) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int tile = warp + 8 * i;
        if (tile < mma_tiles) {
          const int m0 = (tile / n_tiles) * 16, n0 = (tile % n_tiles) * 8;
          const T* a = A + (m0 + g) * p.lda + t4;
          const float* bw = Bm + t4 * p.ldb + n0 + g;
#pragma unroll 4
          for (int k0 = 0; k0 < p.kc; k0 += 8) {
            float av[4] = {to_f32(a[k0]), to_f32(a[8 * p.lda + k0]), to_f32(a[k0 + 4]),
                           to_f32(a[8 * p.lda + k0 + 4])};
            uint32_t af[4], bf[2];
#pragma unroll
            for (int u = 0; u < 4; ++u) af[u] = to_tf32(p.relu ? fmaxf(av[u], 0.0f) : av[u]);
            bf[0] = to_tf32(bw[k0 * p.ldb]);
            bf[1] = to_tf32(bw[(k0 + 4) * p.ldb]);
            mma_tf32(acc[i], af, bf);
          }
        }
      }
    } else if (fma_thread) {
      const T* a = A + pg * 4 * p.lda;
      const float* bw = Bm + fg * 4;
#pragma unroll 4
      for (int c = 0; c < p.kc; ++c) {
        const float4 wv = *reinterpret_cast<const float4*>(bw + c * p.ldb);
        const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float v = to_f32(a[i * p.lda + c]);
          if (p.relu) v = fmaxf(v, 0.0f);
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(v, wr[j], acc[i][j]);
        }
      }
    }
    __syncthreads();  // the stage is consumed before it is filled again
  }

  auto emit = [&](int r, int col, float v) {
    const long long q = q0 + r;
    const int f = f0 + col;
    if (q >= total || col >= p.tf || f >= p.F) return;
    float* o = out + q * p.o_stride + f;
    v = v * scale[f] + bias[f];
    *o = p.accumulate ? *o + v : v;
  };
  if constexpr (kMma) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int tile = warp + 8 * i;
      if (tile < mma_tiles) {
        const int m0 = (tile / n_tiles) * 16, n0 = (tile % n_tiles) * 8;
        emit(m0 + g, n0 + 2 * t4, acc[i][0]);
        emit(m0 + g, n0 + 2 * t4 + 1, acc[i][1]);
        emit(m0 + g + 8, n0 + 2 * t4, acc[i][2]);
        emit(m0 + g + 8, n0 + 2 * t4 + 1, acc[i][3]);
      }
    }
  } else if (fma_thread) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) emit(pg * 4 + i, fg * 4 + j, acc[i][j]);
    }
  }
}

template <typename T, bool kMma>
int launch_conv(const ConvPlan& p, const void* x, const float* w,
                const float* scale, const float* bias, float* out,
                cudaStream_t stream) {
  static bool done = false;  // set once per instantiation
  int err = wide_smem(conv1x1_kernel<T, kMma>, p.smem, done);
  if (err) return err;
  constexpr int VA = 16 / (int)sizeof(T);
  const int vec = p.C % VA == 0 && p.x_stride % VA == 0 && p.F % 4 == 0 &&
                  p.tf % 4 == 0 && aligned16(x) && aligned16(w);
  const long long total = (long long)p.B * p.Ho * p.Wo;
  dim3 grid((unsigned)((total + p.tp - 1) / p.tp), (p.F + p.tf - 1) / p.tf);
  conv1x1_kernel<T, kMma><<<grid, kThreads, p.smem, stream>>>(
      (const T*)x, w, scale, bias, out, p, vec);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- (b)

// Field for field cell_kernels.SEP_FIELDS: K2's Plan
// (sepconv_kernels.PLAN_FIELDS, planned at f32 staging), then the slots'
// pixel strides, the accumulate flag and the product's route.
struct SepPlan {
  int B, H, W, C, F, K, S, Ho, Wo, pt, pl;
  int th;       // output rows per tile
  int tw;       // output columns per tile (a multiple of kCols)
  int tf;       // output channels per tile (a multiple of 8, or F)
  int cc;       // input channels per chunk (a power of two, >= 8)
  int tiles_w;  // column tiles; grid.x = row tiles * tiles_w
  int rh, rw;   // staged input rows and columns
  int xs_len;   // floats the staged input takes (rh * rw * cc, rounded to 4)
  int a_ld;     // row stride (floats) of the depthwise tile [cc][a_ld]
  int b_ld;     // row stride (floats) of the pointwise weights [cc][b_ld]
  int o_ld;     // row stride (floats) of the output tile [pixels][o_ld]
  int dw_len;   // cc * K * K rounded up to 4
  int smem;     // dynamic shared memory bytes
  int is_bf16;  // 0: the staged input is the f32 state
  int x_stride, o_stride, accumulate, mma;
};

// Depthwise for one channel `c` of the chunk, every item (tile row, group
// of kCols output columns) this thread owns; KT/ST > 0 unroll.
template <int KT, int ST>
__device__ __forceinline__ void depthwise(const SepPlan& p, const float* xs,
                                          const float* dws, float* as, int c,
                                          int items) {
  const int groups = p.tw / kCols;
  const int step = kThreads / p.cc;  // items of one channel per pass
  if constexpr (KT > 0 && ST > 0) {
    constexpr int KK = KT * KT;
    constexpr int WIN = (kCols - 1) * ST + KT;
    float w[KK];
#pragma unroll
    for (int t = 0; t < KK; ++t) w[t] = dws[t * p.cc + c];
    for (int g = threadIdx.x / p.cc; g < items; g += step) {
      const int r = g / groups, j = g % groups;
      const float* base = xs + ((r * ST) * p.rw + j * kCols * ST) * p.cc + c;
      float acc[kCols];
#pragma unroll
      for (int q = 0; q < kCols; ++q) acc[q] = 0.0f;
#pragma unroll
      for (int ki = 0; ki < KT; ++ki) {
        float v[WIN];
#pragma unroll
        for (int m = 0; m < WIN; ++m) v[m] = base[(ki * p.rw + m) * p.cc];
#pragma unroll
        for (int kj = 0; kj < KT; ++kj) {
#pragma unroll
          for (int q = 0; q < kCols; ++q)
            acc[q] = fmaf(v[q * ST + kj], w[ki * KT + kj], acc[q]);
        }
      }
      *reinterpret_cast<float4*>(as + c * p.a_ld + r * p.tw + j * kCols) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
  } else {
    const int K = p.K, S = p.S;
    for (int g = threadIdx.x / p.cc; g < items; g += step) {
      const int r = g / groups, j = g % groups;
      const float* base = xs + ((r * S) * p.rw + j * kCols * S) * p.cc + c;
      float acc[kCols];
#pragma unroll
      for (int q = 0; q < kCols; ++q) acc[q] = 0.0f;
      for (int ki = 0; ki < K; ++ki)
        for (int kj = 0; kj < K; ++kj) {
          const float wt = dws[(ki * K + kj) * p.cc + c];
#pragma unroll
          for (int q = 0; q < kCols; ++q)
            acc[q] = fmaf(base[(ki * p.rw + q * S + kj) * p.cc], wt, acc[q]);
        }
      *reinterpret_cast<float4*>(as + c * p.a_ld + r * p.tw + j * kCols) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
  }
}

// x: [B][H][W] pixels of x_stride f32 from the slot's first channel;
// dw: [K*K][C] f32; pw: [C][F] f32; out: [B][Ho][Wo] pixels of o_stride.
template <bool kMma, int KT, int ST>
__global__ void __launch_bounds__(kThreads, 2)
    sep_layer_kernel(const float* __restrict__ x, const float* __restrict__ dw,
                     const float* __restrict__ pw,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias, float* __restrict__ out,
                     SepPlan p, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int K = KT > 0 ? KT : p.K;
  const int S = ST > 0 ? ST : p.S;
  const int KK = K * K;
  const int tf8 = (p.tf + 7) & ~7;
  float* xs = smem;                  // [rh][rw][cc], relu'd
  float* dws = smem + p.xs_len;      // [K*K][cc]
  float* as = dws + p.dw_len;        // [cc][a_ld], pixels row-major
  float* bs = as + p.cc * p.a_ld;    // [cc][b_ld]
  float* os = smem;                  // [pixels][o_ld], after the chunks

  const int tid = threadIdx.x;
  const int oh0 = (blockIdx.x / p.tiles_w) * p.th;
  const int ow0 = (blockIdx.x % p.tiles_w) * p.tw;
  const int b = blockIdx.y;
  const int f0 = blockIdx.z * p.tf;
  const int ih0 = oh0 * S - p.pt, iw0 = ow0 * S - p.pl;
  const float* xb = x + (size_t)b * p.H * p.W * p.x_stride;
  const int tpp = p.th * p.tw;
  const int c_own = tid % p.cc;
  const int dw_items = p.th * (p.tw / kCols);
  const int gf = ((p.tf + 3) & ~3) / 4;
  const bool fma_thread = !kMma && tid < (tpp / 4) * gf;
  const int fg = tid % gf, pg = tid / gf;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int n_tiles = tf8 / 8;
  const int mma_tiles = ((tpp + 15) / 16) * n_tiles;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }

  for (int c0 = 0; c0 < p.C; c0 += p.cc) {
    const int cc = min(p.cc, p.C - c0);
    const int cc8 = (cc + 7) & ~7;
    if (c0 > 0) __syncthreads();  // the previous chunk's readers are done

    // Stage the chunk: input rows with the SAME halo (zero past the edge,
    // relu), the depthwise taps [K*K][cc], the pointwise rows c0 .. c0 +
    // cc, columns f0 .. f0 + tf8 (zero past tf and F, and rows past cc).
    if (vec) {
      const int nxv = cc / 4;
      const int x_items = p.rh * p.rw * nxv;
      const int d_items = KK * nxv;
      const int nwv = tf8 / 4;
      const int w_items = cc8 * nwv;
      const int items = max(x_items, max(d_items, w_items));
      for (int i0 = tid; i0 < items; i0 += kBatch * kThreads) {
        float4 xv[kBatch], dv[kBatch], wv[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int i = i0 + u * kThreads;
          const int pix = i / nxv, e4 = (i % nxv) * 4;
          const int ih = ih0 + pix / p.rw, iw = iw0 + pix % p.rw;
          const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
          xv[u] = zero;
          if (i < x_items && ih >= 0 && ih < p.H && iw >= 0 && iw < p.W)
            xv[u] = *reinterpret_cast<const float4*>(
                xb + ((size_t)ih * p.W + iw) * p.x_stride + c0 + e4);
          dv[u] = zero;
          if (i < d_items)
            dv[u] = *reinterpret_cast<const float4*>(dw + (size_t)pix * p.C + c0 + e4);
          const int c = i / nwv, e = (i % nwv) * 4;
          wv[u] = zero;
          if (i < w_items && c < cc && e < p.tf && f0 + e < p.F)
            wv[u] = *reinterpret_cast<const float4*>(pw + (size_t)(c0 + c) * p.F + f0 + e);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int i = i0 + u * kThreads;
          const int at = (i / nxv) * p.cc + (i % nxv) * 4;
          if (i < x_items) *reinterpret_cast<float4*>(xs + at) = relu4(xv[u]);
          if (i < d_items) *reinterpret_cast<float4*>(dws + at) = dv[u];
          if (i < w_items)
            *reinterpret_cast<float4*>(bs + (i / nwv) * p.b_ld + (i % nwv) * 4) = wv[u];
        }
      }
    } else {
      // Odd channel counts or unaligned slots: element loads.
      for (int i = tid; i < p.rh * p.rw * cc; i += kThreads) {
        const int c = i % cc, pix = i / cc;
        const int ih = ih0 + pix / p.rw, iw = iw0 + pix % p.rw;
        float v = 0.0f;
        if (ih >= 0 && ih < p.H && iw >= 0 && iw < p.W)
          v = fmaxf(xb[((size_t)ih * p.W + iw) * p.x_stride + c0 + c], 0.0f);
        xs[pix * p.cc + c] = v;
      }
      for (int i = tid; i < KK * cc; i += kThreads) {
        const int t = i / cc, c = i % cc;
        dws[t * p.cc + c] = dw[(size_t)t * p.C + c0 + c];
      }
      for (int i = tid; i < cc8 * tf8; i += kThreads) {
        const int c = i / tf8, e = i % tf8;
        float v = 0.0f;
        if (c < cc && e < p.tf && f0 + e < p.F) v = pw[(size_t)(c0 + c) * p.F + f0 + e];
        bs[c * p.b_ld + e] = v;
      }
    }
    __syncthreads();

    if (c_own < cc) {
      depthwise<KT, ST>(p, xs, dws, as, c_own, dw_items);
    } else if (kMma && c_own < cc8) {
      for (int q = tid / p.cc; q < tpp; q += kThreads / p.cc)
        as[c_own * p.a_ld + q] = 0.0f;  // a partial MMA step adds zeros
    }
    __syncthreads();

    if constexpr (kMma) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int tile = warp + 8 * i;
        if (tile < mma_tiles) {
          const int m0 = (tile / n_tiles) * 16, n0 = (tile % n_tiles) * 8;
          const float* a = as + t4 * p.a_ld + m0 + g;
          const float* w = bs + t4 * p.b_ld + n0 + g;
#pragma unroll 4
          for (int k0 = 0; k0 < cc8; k0 += 8) {
            uint32_t af[4], bf[2];
            af[0] = to_tf32(a[k0 * p.a_ld]);
            af[1] = to_tf32(a[k0 * p.a_ld + 8]);
            af[2] = to_tf32(a[(k0 + 4) * p.a_ld]);
            af[3] = to_tf32(a[(k0 + 4) * p.a_ld + 8]);
            bf[0] = to_tf32(w[k0 * p.b_ld]);
            bf[1] = to_tf32(w[(k0 + 4) * p.b_ld]);
            mma_tf32(acc[i], af, bf);
          }
        }
      }
    } else if (fma_thread) {
      const float* a = as + pg * 4;
      const float* w = bs + fg * 4;
#pragma unroll 4
      for (int c = 0; c < cc; ++c) {
        const float4 av = *reinterpret_cast<const float4*>(a + c * p.a_ld);
        const float4 wv = *reinterpret_cast<const float4*>(w + c * p.b_ld);
        const float ar[4] = {av.x, av.y, av.z, av.w};
        const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], wr[j], acc[i][j]);
        }
      }
    }
  }

  // The output tile through shared memory: os[pixel][channel] f32.
  __syncthreads();
  if constexpr (kMma) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int tile = warp + 8 * i;
      if (tile < mma_tiles) {
        const int m0 = (tile / n_tiles) * 16, n0 = (tile % n_tiles) * 8;
        *reinterpret_cast<float2*>(os + (m0 + g) * p.o_ld + n0 + 2 * t4) =
            make_float2(acc[i][0], acc[i][1]);
        *reinterpret_cast<float2*>(os + (m0 + g + 8) * p.o_ld + n0 + 2 * t4) =
            make_float2(acc[i][2], acc[i][3]);
      }
    }
  } else if (fma_thread) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) os[(pg * 4 + i) * p.o_ld + fg * 4 + j] = acc[i][j];
    }
  }
  __syncthreads();
  // The affine, then the slot written or added to at its pixel stride.
  const int nov = tf8 / 4;
  for (int i = tid; i < tpp * nov; i += kThreads) {
    const int pix = i / nov, e = (i % nov) * 4;
    const int oh = oh0 + pix / p.tw, ow = ow0 + pix % p.tw;
    if (oh >= p.Ho || ow >= p.Wo || e >= p.tf) continue;
    const int f = f0 + e;
    const float* src = os + pix * p.o_ld + e;
    float* dst = out + (((size_t)b * p.Ho + oh) * p.Wo + ow) * p.o_stride + f;
    if (vec && e + 4 <= p.tf && f + 4 <= p.F) {
      const float4 v = *reinterpret_cast<const float4*>(src);
      const float4 s = *reinterpret_cast<const float4*>(scale + f);
      const float4 t = *reinterpret_cast<const float4*>(bias + f);
      float4 r = make_float4(fmaf(v.x, s.x, t.x), fmaf(v.y, s.y, t.y),
                             fmaf(v.z, s.z, t.z), fmaf(v.w, s.w, t.w));
      if (p.accumulate) {
        const float4 o = *reinterpret_cast<const float4*>(dst);
        r = make_float4(o.x + r.x, o.y + r.y, o.z + r.z, o.w + r.w);
      }
      *reinterpret_cast<float4*>(dst) = r;
    } else {
      for (int j = 0; j < 4 && e + j < p.tf && f + j < p.F; ++j) {
        const float v = fmaf(src[j], scale[f + j], bias[f + j]);
        dst[j] = p.accumulate ? dst[j] + v : v;
      }
    }
  }
}

template <bool kMma, int KT, int ST>
int launch_sep(const SepPlan& p, const float* x, const float* dw,
               const float* pw, const float* scale, const float* bias,
               float* out, cudaStream_t stream) {
  static bool done = false;  // set once per instantiation
  int err = wide_smem(sep_layer_kernel<kMma, KT, ST>, p.smem, done);
  if (err) return err;
  const int vec = p.C % 4 == 0 && p.F % 4 == 0 && p.x_stride % 4 == 0 &&
                  p.o_stride % 4 == 0 && aligned16(x) && aligned16(dw) &&
                  aligned16(pw) && aligned16(scale) && aligned16(bias) &&
                  aligned16(out);
  const int tiles_h = (p.Ho + p.th - 1) / p.th;
  dim3 grid(tiles_h * p.tiles_w, p.B, (p.F + p.tf - 1) / p.tf);
  sep_layer_kernel<kMma, KT, ST><<<grid, kThreads, p.smem, stream>>>(
      x, dw, pw, scale, bias, out, p, vec);
  return (int)cudaGetLastError();
}

template <bool kMma>
int dispatch_sep(const SepPlan& p, const float* x, const float* dw,
                 const float* pw, const float* scale, const float* bias,
                 float* out, cudaStream_t s) {
  if (p.S == 1) {
    if (p.K == 3) return launch_sep<kMma, 3, 1>(p, x, dw, pw, scale, bias, out, s);
    if (p.K == 5) return launch_sep<kMma, 5, 1>(p, x, dw, pw, scale, bias, out, s);
    if (p.K == 7) return launch_sep<kMma, 7, 1>(p, x, dw, pw, scale, bias, out, s);
  } else if (p.S == 2) {
    if (p.K == 3) return launch_sep<kMma, 3, 2>(p, x, dw, pw, scale, bias, out, s);
    if (p.K == 5) return launch_sep<kMma, 5, 2>(p, x, dw, pw, scale, bias, out, s);
    if (p.K == 7) return launch_sep<kMma, 7, 2>(p, x, dw, pw, scale, bias, out, s);
  }
  return launch_sep<kMma, 0, 0>(p, x, dw, pw, scale, bias, out, s);
}

// ----------------------------------------------------------------- (c)

struct PoolSrc {
  int H, W, S, pt, pl;
  int mode;      // 0 copy (stride 1), 1 avg, 2 max
  int x_stride;  // channels per pixel of the source's buffer
};

// Field for field cell_kernels.POOL_FIELDS.
struct PoolPlan {
  int B, C, Ho, Wo, o_stride, accumulate;
  int nsrc;     // 1, or 2: the sum of two branches
  int is_bf16;  // source 0's dtype (source 1 is always an f32 state)
  int blocks;
  PoolSrc src[2];
};

template <int V>
__device__ __forceinline__ void load_v(const float* p, float* v) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
    v[0] = *p;
  }
}
template <int V>
__device__ __forceinline__ void load_v(const __nv_bfloat16* p, float* v) {
  if constexpr (V == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
  } else {
    v[0] = __bfloat162float(*p);
  }
}

// One source's value at output pixel (b, oh, ow), channels c .. c + V,
// added onto v.
template <typename T, int V>
__device__ __forceinline__ void pool_add(const T* x, const PoolSrc& s, int b,
                                         int oh, int ow, int c, float* v) {
  const T* xb = x + (long long)b * s.H * s.W * s.x_stride + c;
  float r[V], t[V];
  if (s.mode == 0) {
    load_v<V>(xb + ((long long)oh * s.W + ow) * s.x_stride, r);
  } else {
    const bool is_max = s.mode == 2;
#pragma unroll
    for (int j = 0; j < V; ++j) r[j] = is_max ? __int_as_float((int)0xff800000) : 0.0f;
    for (int ki = 0; ki < 3; ++ki) {
      const int ih = oh * s.S - s.pt + ki;
      if (ih < 0 || ih >= s.H) continue;  // avg: a padded tap adds 0
      for (int kj = 0; kj < 3; ++kj) {
        const int iw = ow * s.S - s.pl + kj;
        if (iw < 0 || iw >= s.W) continue;  // max: a padded tap is -inf
        load_v<V>(xb + ((long long)ih * s.W + iw) * s.x_stride, t);
#pragma unroll
        for (int j = 0; j < V; ++j) r[j] = is_max ? fmaxf(r[j], t[j]) : r[j] + t[j];
      }
    }
    if (!is_max) {
#pragma unroll
      for (int j = 0; j < V; ++j) r[j] = r[j] / 9.0f;
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] += r[j];
}

// One thread per (output pixel, V channels).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    pool_kernel(const T* __restrict__ x0, const float* __restrict__ x1,
                float* __restrict__ out, PoolPlan p) {
  const int groups = p.C / V;
  const long long total = (long long)p.B * p.Ho * p.Wo * groups;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += (long long)gridDim.x * kThreads) {
    const int c = (int)(i % groups) * V;
    const long long q = i / groups;
    const int hw = p.Ho * p.Wo;
    const int b = (int)(q / hw), r = (int)(q % hw);
    const int oh = r / p.Wo, ow = r % p.Wo;
    float v[V];
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = 0.0f;
    pool_add<T, V>(x0, p.src[0], b, oh, ow, c, v);
    if (p.nsrc == 2) pool_add<float, V>(x1, p.src[1], b, oh, ow, c, v);
    float* o = out + q * p.o_stride + c;
    if constexpr (V == 4) {
      float4 r4 = make_float4(v[0], v[1], v[2], v[3]);
      if (p.accumulate) {
        const float4 a = *reinterpret_cast<const float4*>(o);
        r4 = make_float4(a.x + r4.x, a.y + r4.y, a.z + r4.z, a.w + r4.w);
      }
      *reinterpret_cast<float4*>(o) = r4;
    } else {
      *o = p.accumulate ? *o + v[0] : v[0];
    }
  }
}

template <typename T>
int launch_pool(const PoolPlan& p, const void* x0, const float* x1, float* out,
                cudaStream_t stream) {
  const bool vec = p.C % 4 == 0 && p.o_stride % 4 == 0 &&
                   p.src[0].x_stride % 4 == 0 &&
                   ((uintptr_t)x0 % (4 * sizeof(T))) == 0 && aligned16(out) &&
                   (p.nsrc < 2 || (p.src[1].x_stride % 4 == 0 && aligned16(x1)));
  if (vec) {
    pool_kernel<T, 4><<<p.blocks, kThreads, 0, stream>>>((const T*)x0, x1, out, p);
  } else {
    const long long items = (long long)p.B * p.Ho * p.Wo * p.C;
    const long long blocks = (items + kThreads - 1) / kThreads;
    pool_kernel<T, 1><<<(unsigned)(blocks < 65535 ? blocks : 65535), kThreads, 0, stream>>>(
        (const T*)x0, x1, out, p);
  }
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- (d)

// Eight values a thread: two 16-byte loads, one 16-byte store.
__global__ void __launch_bounds__(kThreads)
    cast_bf16_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ y,
                     long long n, int vec) {
  const long long step = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long n8 = vec ? n / 8 : 0;
  for (long long i = first; i < n8; i += step) {
    const float4 a = reinterpret_cast<const float4*>(x)[2 * i];
    const float4 b = reinterpret_cast<const float4*>(x)[2 * i + 1];
    uint4 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
    h[0] = __floats2bfloat162_rn(a.x, a.y);
    h[1] = __floats2bfloat162_rn(a.z, a.w);
    h[2] = __floats2bfloat162_rn(b.x, b.y);
    h[3] = __floats2bfloat162_rn(b.z, b.w);
    reinterpret_cast<uint4*>(y)[i] = r;
  }
  for (long long i = 8 * n8 + first; i < n; i += step) y[i] = __float2bfloat16(x[i]);
}

// Each launcher takes its pointers, the host's int array of the plan's
// fields in order, and the stream; it returns cudaGetLastError() after
// the launch (or a refusal of the plan). `cell_forward` runs a whole
// schedule with them.

int cell_conv1x1(const void* x, const float* w, const float* scale,
                            const float* bias, float* out, const int* plan,
                            void* stream) {
  ConvPlan p;
  memcpy(&p, plan, sizeof(ConvPlan));
  if (p.B == 0 || p.Ho * p.Wo == 0 || p.F == 0) return 0;
  if (p.tp < 16 || p.tp % 16 || p.tf < 1 || p.kc < 8 || p.kc % 8 ||
      p.tp * ((p.tf + 7) & ~7) > 16 * kThreads || p.ldb < ((p.tf + 7) & ~7) ||
      p.lda < p.kc || p.smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (p.is_bf16) {
    if (p.mma) return launch_conv<__nv_bfloat16, true>(p, x, w, scale, bias, out, s);
    return launch_conv<__nv_bfloat16, false>(p, x, w, scale, bias, out, s);
  }
  if (p.mma) return launch_conv<float, true>(p, x, w, scale, bias, out, s);
  return launch_conv<float, false>(p, x, w, scale, bias, out, s);
}

int cell_sep_layer(const float* x, const float* dw, const float* pw,
                              const float* scale, const float* bias, float* out,
                              const int* plan, void* stream) {
  SepPlan p;
  memcpy(&p, plan, sizeof(SepPlan));
  if (p.B == 0 || p.Ho * p.Wo == 0 || p.F == 0) return 0;
  const int tpp16 = (p.th * p.tw + 15) & ~15, tf8 = (p.tf + 7) & ~7;
  if (p.th < 1 || p.tw < kCols || p.tw % kCols || p.tf < 1 || p.cc < 8 ||
      kThreads % p.cc || tpp16 * tf8 > 16 * kThreads || p.a_ld < tpp16 ||
      p.b_ld < tf8 || p.b_ld % 4 || p.o_ld < tf8 || p.o_ld % 4 ||
      p.smem > kMaxSmem || p.is_bf16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (p.mma) return dispatch_sep<true>(p, x, dw, pw, scale, bias, out, s);
  return dispatch_sep<false>(p, x, dw, pw, scale, bias, out, s);
}

int cell_pool(const void* x0, const float* x1, float* out,
                         const int* plan, void* stream) {
  PoolPlan p;
  memcpy(&p, plan, sizeof(PoolPlan));
  if (p.B == 0 || p.Ho * p.Wo == 0 || p.C == 0) return 0;
  if (p.nsrc < 1 || p.nsrc > 2 || p.blocks < 1) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < p.nsrc; ++i)
    if (p.src[i].mode < 0 || p.src[i].mode > 2 || (p.src[i].mode == 0 && p.src[i].S != 1))
      return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (p.is_bf16) return launch_pool<__nv_bfloat16>(p, x0, x1, out, s);
  return launch_pool<float>(p, x0, x1, out, s);
}

// plan: (n, blocks).
int cell_cast_bf16(const float* x, void* y, const int* plan,
                              void* stream) {
  const int n = plan[0], blocks = plan[1];
  if (n <= 0) return 0;
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  const int vec = aligned16(x) && aligned16(y);
  cast_bf16_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      x, (__nv_bfloat16*)y, n, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// One cell call: the schedule `program`, packed on the host once per
// signature (per step its kind, 0 1x1, 1 separable layer, 2 pool, 3
// cast, the count of its plan's fields, then the fields), and the call's
// pointer arguments in step order (1x1: x, w, scale, bias, out;
// separable layer: x, dw, pw, scale, bias, out; pool: x0, x1 or 0, out;
// cast: x, y). Launches every step on `stream`; on a refusal returns its
// code with the step's index in `failed`.
extern "C" int cell_forward(const int* program, int n_steps,
                            const unsigned long long* ptrs, int* failed,
                            void* stream) {
  const int* step = program;
  const unsigned long long* a = ptrs;
  for (int i = 0; i < n_steps; ++i) {
    const int kind = step[0];
    const int* plan = step + 2;
    int err;
    switch (kind) {
      case 0:
        err = cell_conv1x1((const void*)a[0], (const float*)a[1], (const float*)a[2],
                           (const float*)a[3], (float*)a[4], plan, stream);
        a += 5;
        break;
      case 1:
        err = cell_sep_layer((const float*)a[0], (const float*)a[1], (const float*)a[2],
                             (const float*)a[3], (const float*)a[4], (float*)a[5], plan,
                             stream);
        a += 6;
        break;
      case 2:
        err = cell_pool((const void*)a[0], (const float*)a[1], (float*)a[2], plan, stream);
        a += 3;
        break;
      case 3:
        err = cell_cast_bf16((const float*)a[0], (void*)a[1], plan, stream);
        a += 2;
        break;
      default:
        err = (int)cudaErrorInvalidValue;
    }
    if (err) {
      *failed = i;
      return err;
    }
    step += 2 + step[1];
  }
  return 0;
}
