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
// the output stored in the input dtype. Weights are rounded to the input
// dtype first, as the JAX caller casts them to the compute dtype before
// the kernel. The bf16 instantiation runs the pointwise product on the
// tensor cores (mma.sync m16n8k8, TF32 inputs, f32 accumulation): the
// bf16 weights are exact in TF32, and the f32 depthwise value keeps 10
// mantissa bits, more than the bf16 output's 8. The f32 instantiation
// keeps CUDA-core FMAs and full f32 precision.
//
// Bound: at the NASNet-A CIFAR shapes (C, F <= 128, batch <= 32) one
// launch moves 0.1-4 MB and does 20-360 MFLOP, 0.3-2.5 us at the card's
// peaks, bytes being the larger. What holds a launch back is neither
// peak but parallelism and latency: a small grid leaves SMs idle, every
// block walks load -> depthwise -> pointwise -> store in turn, and every
// block reads the weights of its output channels again (from L2).
//
// Design (sepconv_kernels.launch_plan sizes every tile on the host, once
// per signature, and hands this file a Plan):
// - Grid = (row tiles x column tiles, batch, output-channel tiles). The
//   planner sizes the tile from the output and the SM count, so that a
//   bucket-32 launch has at least one block per SM and a bucket-1 launch
//   at 8x8 at least 16: whole output rows first, then fewer rows, then
//   fewer output channels (each channel tile recomputes the depthwise).
// - Input channels stream through the block in chunks of `cc` (a power of
//   two): for each chunk the block stages its input rows with the SAME
//   halo in shared memory once (zero past the edge, relu, in x's dtype),
//   the chunk's depthwise weights and its pointwise weights, all with
//   16-byte loads, kBatch of each kind in flight per thread before any
//   store. The wrapper hands the pointwise weights over prepared once per
//   weight version, transposed to [C][F] and rounded to the input dtype,
//   so a block copies its rows as they are and reads half the bytes in
//   bf16. Shared memory is bounded by the chunk, not by C, so every shape
//   tiles.
// - Depthwise: a thread owns one channel (the chunk divides the block) and
//   4 neighbouring output pixels of a row; it keeps its k*k weights and a
//   sliding window of the staged row in registers, so neighbouring
//   outputs reuse each loaded input. Loops are templated on k in {3,5,7}
//   and stride in {1,2} and unroll; other k and strides take a generic
//   instantiation. The f32 result goes to shared memory as [cc][pixels].
// - Pointwise: bf16, each warp owns up to four 16 x 8 tensor-core tiles of
//   pixels x output channels; f32, a register tile of 4 x 4 a thread.
//   Both accumulate in f32 across the chunks.
// - The output tile goes through shared memory and out with coalesced
//   16-byte stores.
// - cudaFuncSetAttribute (dynamic shared memory above 48 KB) runs once per
//   instantiation, not per launch.
// What still holds it back (numbers in PERF.md): a block's phases run in
// turn, with no overlap between a chunk's loads and the previous chunk's
// work, so a launch costs some 4 us at bucket 1 whatever its size, and a
// shape whose input needs two chunks (C = 96) pays the load latency twice.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4;   // output pixels of a row per depthwise item
constexpr int kBatch = 4;  // 16-byte loads of each kind a thread keeps in flight
constexpr int kMaxSmem = 227 * 1024;

// Launch plan, field for field sepconv_kernels.PLAN_FIELDS.
struct Plan {
  int B, H, W, C, F, K, S, Ho, Wo, pt, pl;
  int th;       // output rows per tile
  int tw;       // output columns per tile (a multiple of kCols)
  int tf;       // output channels per tile (a multiple of 8, or F)
  int cc;       // input channels per chunk (a power of two, >= 8)
  int tiles_w;  // column tiles; grid.x = row tiles * tiles_w
  int rh, rw;   // staged input rows and columns
  int xs_len;   // floats the staged input takes (rh * rw * cc T, rounded to 4)
  int a_ld;     // row stride (floats) of the depthwise tile [cc][a_ld]
  int b_ld;     // row stride (elements) of the pointwise weights [cc][b_ld]
  int o_ld;     // row stride (elements) of the output tile [pixels][o_ld]
  int dw_len;   // cc * K * K rounded up to 4
  int smem;     // dynamic shared memory bytes
  int is_bf16;
};

template <typename T>
struct Vec;  // elements of T in 16 bytes
template <>
struct Vec<float> {
  static constexpr int N = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

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

__device__ __forceinline__ void store1(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16(v);
}
__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// 16 bytes of x, relu'd in its dtype, into dst (16-byte aligned shared
// memory); `ok` false stores zeros (the SAME halo).
__device__ __forceinline__ void put16(float* dst, uint4 raw, bool ok) {
  float4 v = ok ? *reinterpret_cast<float4*>(&raw) : make_float4(0.f, 0.f, 0.f, 0.f);
  *reinterpret_cast<float4*>(dst) = make_float4(
      fmaxf(v.x, 0.0f), fmaxf(v.y, 0.0f), fmaxf(v.z, 0.0f), fmaxf(v.w, 0.0f));
}
__device__ __forceinline__ void put16(__nv_bfloat16* dst, uint4 raw, bool ok) {
  if (!ok) raw = make_uint4(0u, 0u, 0u, 0u);
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
  const __nv_bfloat162 zero = __float2bfloat162_rn(0.0f);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __hmax2(h[i], zero);
  *reinterpret_cast<uint4*>(dst) = raw;
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

// Depthwise for one channel `c` of the chunk, every item (tile row, group
// of kCols output columns) this thread owns; KT/ST > 0 unroll.
template <int KT, int ST, typename T>
__device__ __forceinline__ void depthwise(const Plan& p, const T* xs,
                                          const float* dws, float* as, int c,
                                          int items) {
  const int groups = p.tw / kCols;
  const int step = kThreads / p.cc;  // items of one channel per pass
  if constexpr (KT > 0 && ST > 0) {
    constexpr int KK = KT * KT;
    constexpr int WIN = (kCols - 1) * ST + KT;
    float w[KK];
#pragma unroll
    for (int t = 0; t < KK; ++t) w[t] = dws[c * KK + t];
    for (int g = threadIdx.x / p.cc; g < items; g += step) {
      const int r = g / groups, j = g % groups;
      const T* base = xs + ((r * ST) * p.rw + j * kCols * ST) * p.cc + c;
      float acc[kCols];
#pragma unroll
      for (int q = 0; q < kCols; ++q) acc[q] = 0.0f;
#pragma unroll
      for (int ki = 0; ki < KT; ++ki) {
        float v[WIN];
#pragma unroll
        for (int m = 0; m < WIN; ++m) v[m] = to_f32(base[(ki * p.rw + m) * p.cc]);
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
    const int K = p.K, S = p.S, KK = K * K;
    for (int g = threadIdx.x / p.cc; g < items; g += step) {
      const int r = g / groups, j = g % groups;
      const T* base = xs + ((r * S) * p.rw + j * kCols * S) * p.cc + c;
      float acc[kCols];
#pragma unroll
      for (int q = 0; q < kCols; ++q) acc[q] = 0.0f;
      for (int ki = 0; ki < K; ++ki)
        for (int kj = 0; kj < K; ++kj) {
          const float wt = dws[c * KK + ki * K + kj];
#pragma unroll
          for (int q = 0; q < kCols; ++q)
            acc[q] = fmaf(to_f32(base[(ki * p.rw + q * S + kj) * p.cc]), wt, acc[q]);
        }
      *reinterpret_cast<float4*>(as + c * p.a_ld + r * p.tw + j * kCols) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
  }
}

// x: [B][H][W][C] T; dw: [C][K*K] f32; pwt: [C][F] T (transposed, rounded);
// out: [B][Ho][Wo][F] T.
template <typename T, int KT, int ST>
__global__ void __launch_bounds__(kThreads, 2)
    sepconv_kernel(const T* __restrict__ x, const float* __restrict__ dw,
                   const T* __restrict__ pwt, T* __restrict__ out, Plan p,
                   int vec) {
  extern __shared__ __align__(16) float smem[];
  constexpr int VX = Vec<T>::N;
  constexpr bool kMma = sizeof(T) == 2;
  const int K = KT > 0 ? KT : p.K;
  const int S = ST > 0 ? ST : p.S;
  const int KK = K * K;
  const int tf8 = (p.tf + 7) & ~7;       // staged weight columns
  T* xs = reinterpret_cast<T*>(smem);   // [rh][rw][cc], relu'd
  float* dws = smem + p.xs_len;          // [cc][K*K] f32
  float* as = dws + p.dw_len;            // [cc][a_ld] f32, pixels row-major
  T* bs = reinterpret_cast<T*>(as + p.cc * p.a_ld);  // [cc][b_ld]
  T* os = reinterpret_cast<T*>(smem);    // [pixels][o_ld], after the chunks

  const int tid = threadIdx.x;
  const int oh0 = (blockIdx.x / p.tiles_w) * p.th;
  const int ow0 = (blockIdx.x % p.tiles_w) * p.tw;
  const int b = blockIdx.y;
  const int f0 = blockIdx.z * p.tf;
  const int ih0 = oh0 * S - p.pt, iw0 = ow0 * S - p.pl;
  const T* xb = x + (size_t)b * p.H * p.W * p.C;
  const int tpp = p.th * p.tw;       // pixels of the tile (padded rows)
  const int c_own = tid % p.cc;      // this thread's depthwise channel
  const int dw_items = p.th * (p.tw / kCols);
  // FMA register tile: 4 pixels (pg) x 4 channels (fg) a thread.
  const int gf = ((p.tf + 3) & ~3) / 4;
  const bool fma_thread = !kMma && tid < (tpp / 4) * gf;
  const int fg = tid % gf, pg = tid / gf;
  // MMA: 16 x 8 output tiles, tile warp + 8 i for i < 4, per warp.
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
    const int cc8 = (cc + 7) & ~7;  // MMA steps of 8 channels
    if (c0 > 0) __syncthreads();    // the previous chunk's readers are done

    // Stage the chunk: input rows with the SAME halo (zero past the
    // edge, relu, in T); the depthwise weights as stored ([cc][K*K],
    // rounded to T); the pointwise weights' rows c0 .. c0 + cc, columns
    // f0 .. f0 + tf8 (zero past tf and F, and, for the MMA steps, rows
    // past cc).
    if (vec) {
      const int nxv = cc / VX;
      const int x_items = p.rh * p.rw * nxv;
      const int d_items = cc * KK / 4;
      const int nwv = tf8 / VX;
      const int w_items = cc8 * nwv;
      const int items = max(x_items, max(d_items, w_items));
      for (int i0 = tid; i0 < items; i0 += kBatch * kThreads) {
        uint4 xr[kBatch], wr[kBatch];
        bool xok[kBatch];
        float4 dv[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int i = i0 + u * kThreads;
          const int pix = i / nxv;
          const int ih = ih0 + pix / p.rw, iw = iw0 + pix % p.rw;
          xok[u] = i < x_items && ih >= 0 && ih < p.H && iw >= 0 && iw < p.W;
          if (xok[u])
            xr[u] = *reinterpret_cast<const uint4*>(
                xb + ((size_t)ih * p.W + iw) * p.C + c0 + (i % nxv) * VX);
          if (i < d_items)
            dv[u] = reinterpret_cast<const float4*>(dw + (size_t)c0 * KK)[i];
          const int c = i / nwv, e = (i % nwv) * VX;
          wr[u] = make_uint4(0u, 0u, 0u, 0u);
          if (i < w_items && c < cc && e < p.tf && f0 + e < p.F)
            wr[u] = *reinterpret_cast<const uint4*>(
                pwt + (size_t)(c0 + c) * p.F + f0 + e);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int i = i0 + u * kThreads;
          if (i < x_items)
            put16(xs + (i / nxv) * p.cc + (i % nxv) * VX, xr[u], xok[u]);
          if (i < d_items)
            *reinterpret_cast<float4*>(dws + 4 * i) = make_float4(
                round_weight<T>(dv[u].x), round_weight<T>(dv[u].y),
                round_weight<T>(dv[u].z), round_weight<T>(dv[u].w));
          if (i < w_items)
            *reinterpret_cast<uint4*>(bs + (i / nwv) * p.b_ld + (i % nwv) * VX) = wr[u];
        }
      }
      for (int i = 4 * d_items + tid; i < cc * KK; i += kThreads)
        dws[i] = round_weight<T>(dw[(size_t)c0 * KK + i]);
    } else {
      // Unaligned or odd channel counts: element loads.
      for (int i = tid; i < p.rh * p.rw * cc; i += kThreads) {
        const int c = i % cc, pix = i / cc;
        const int ih = ih0 + pix / p.rw, iw = iw0 + pix % p.rw;
        float v = 0.0f;
        if (ih >= 0 && ih < p.H && iw >= 0 && iw < p.W)
          v = fmaxf(to_f32(xb[((size_t)ih * p.W + iw) * p.C + c0 + c]), 0.0f);
        store1(xs + pix * p.cc + c, v);
      }
      for (int i = tid; i < cc * KK; i += kThreads)
        dws[i] = round_weight<T>(dw[(size_t)c0 * KK + i]);
      for (int i = tid; i < cc8 * tf8; i += kThreads) {
        const int c = i / tf8, e = i % tf8;
        T w = T();
        if (c < cc && e < p.tf && f0 + e < p.F) w = pwt[(size_t)(c0 + c) * p.F + f0 + e];
        bs[c * p.b_ld + e] = w;
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
      const unsigned short* bh = reinterpret_cast<const unsigned short*>(bs);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int tile = warp + 8 * i;
        if (tile < mma_tiles) {
          const int m0 = (tile / n_tiles) * 16, n0 = (tile % n_tiles) * 8;
          const float* a = as + t4 * p.a_ld + m0 + g;
          const unsigned short* w = bh + t4 * p.b_ld + n0 + g;
#pragma unroll 4
          for (int k0 = 0; k0 < cc8; k0 += 8) {
            uint32_t af[4], bf[2];
            af[0] = to_tf32(a[k0 * p.a_ld]);
            af[1] = to_tf32(a[k0 * p.a_ld + 8]);
            af[2] = to_tf32(a[(k0 + 4) * p.a_ld]);
            af[3] = to_tf32(a[(k0 + 4) * p.a_ld + 8]);
            bf[0] = (uint32_t)w[k0 * p.b_ld] << 16;  // bf16 -> f32, exact
            bf[1] = (uint32_t)w[(k0 + 4) * p.b_ld] << 16;
            mma_tf32(acc[i], af, bf);
          }
        }
      }
    } else if (fma_thread) {
      const float* a = as + pg * 4;
      const float* w = reinterpret_cast<const float*>(bs) + fg * 4;
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

  // The output tile through shared memory: os[pixel][channel] in T.
  __syncthreads();
  if constexpr (kMma) {
    // Tile i: acc[i] = D[g][2 t4 .. +1], D[g + 8][2 t4 .. +1].
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int tile = warp + 8 * i;
      if (tile < mma_tiles) {
        const int m0 = (tile / n_tiles) * 16, n0 = (tile % n_tiles) * 8;
        store2(os + (m0 + g) * p.o_ld + n0 + 2 * t4, acc[i][0], acc[i][1]);
        store2(os + (m0 + g + 8) * p.o_ld + n0 + 2 * t4, acc[i][2], acc[i][3]);
      }
    }
  } else if (fma_thread) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) store1(os + (pg * 4 + i) * p.o_ld + fg * 4 + j, acc[i][j]);
    }
  }
  __syncthreads();
  const int nov = tf8 / VX;
  for (int i = tid; i < tpp * nov; i += kThreads) {
    const int pix = i / nov, e = (i % nov) * VX;
    const int oh = oh0 + pix / p.tw, ow = ow0 + pix % p.tw;
    if (oh >= p.Ho || ow >= p.Wo || e >= p.tf) continue;
    const T* src = os + pix * p.o_ld + e;
    T* dst = out + (((size_t)b * p.Ho + oh) * p.Wo + ow) * p.F + f0 + e;
    if (vec && e + VX <= p.tf && f0 + e + VX <= p.F) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int j = 0; j < VX && e + j < p.tf && f0 + e + j < p.F; ++j) dst[j] = src[j];
    }
  }
}

template <typename T, int KT, int ST>
int launch(const Plan& p, const void* x, const float* dw, const void* pwt,
           void* out, cudaStream_t stream) {
  static bool wide_smem = false;  // set once per instantiation
  if (p.smem > 48 * 1024 && !wide_smem) {
    cudaError_t err = cudaFuncSetAttribute(
        sepconv_kernel<T, KT, ST>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    wide_smem = true;
  }
  // 16-byte paths: channel counts in whole vectors, aligned pointers.
  const int vx = Vec<T>::N;
  const int vec = p.C % vx == 0 && p.F % vx == 0 && p.C % 4 == 0 &&
                  (uintptr_t)x % 16 == 0 && (uintptr_t)dw % 16 == 0 &&
                  (uintptr_t)pwt % 16 == 0 && (uintptr_t)out % 16 == 0;
  const int tiles_h = (p.Ho + p.th - 1) / p.th;
  dim3 grid(tiles_h * p.tiles_w, p.B, (p.F + p.tf - 1) / p.tf);
  sepconv_kernel<T, KT, ST><<<grid, kThreads, p.smem, stream>>>(
      (const T*)x, dw, (const T*)pwt, (T*)out, p, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Plan& p, const void* x, const float* dw, const void* pwt,
             void* out, cudaStream_t s) {
  if (p.S == 1) {
    if (p.K == 3) return launch<T, 3, 1>(p, x, dw, pwt, out, s);
    if (p.K == 5) return launch<T, 5, 1>(p, x, dw, pwt, out, s);
    if (p.K == 7) return launch<T, 7, 1>(p, x, dw, pwt, out, s);
  } else if (p.S == 2) {
    if (p.K == 3) return launch<T, 3, 2>(p, x, dw, pwt, out, s);
    if (p.K == 5) return launch<T, 5, 2>(p, x, dw, pwt, out, s);
    if (p.K == 7) return launch<T, 7, 2>(p, x, dw, pwt, out, s);
  }
  return launch<T, 0, 0>(p, x, dw, pwt, out, s);
}

}  // namespace

// `plan` points at the host's int array of Plan's fields, in order; `pwt`
// is the pointwise weight transposed to [C][F] in x's dtype.
extern "C" int sepconv_forward(const void* x, const float* dw, const void* pwt,
                               void* out, const int* plan, void* stream) {
  Plan p;
  memcpy(&p, plan, sizeof(Plan));
  if (p.B == 0 || p.Ho * p.Wo == 0 || p.F == 0) return 0;
  const int tpp16 = (p.th * p.tw + 15) & ~15, tf8 = (p.tf + 7) & ~7;
  if (p.th < 1 || p.tw < kCols || p.tw % kCols || p.tf < 1 || p.cc < 8 ||
      kThreads % p.cc || tpp16 * tf8 > 16 * kThreads || p.a_ld < tpp16 ||
      p.b_ld < tf8 || p.b_ld % 8 || p.o_ld < tf8 || p.o_ld % 8 ||
      p.smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (p.is_bf16) return dispatch<__nv_bfloat16>(p, x, dw, pwt, out, s);
  return dispatch<float>(p, x, dw, pwt, out, s);
}
