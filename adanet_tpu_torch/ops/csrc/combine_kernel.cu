// K1: fused mixture-weight combine, out[b,c] = bias[c] + sum_n w[n]*logits[n,b,c].
//
// Replaces: adanet_tpu/ops/ensemble_kernels.py `_combine_kernel` (launched
// by `_combine_pallas`), the forward of `fused_weighted_combine`.
//
// What it computes, as `_combine_kernel` does: members summed in f32 in
// order n = 0..N-1 from a zero, the bias added last, the result written
// in the logits' dtype (f32 or bf16, one dtype a launch). Weights are f32
// [N] (scalar per member) or [N, C] (vector per member); the bias is f32
// [C] or absent. The sums use unfused multiplies and adds (__fmul_rn,
// __fadd_rn), the arithmetic of the plain PyTorch version.
//
// Bound: bytes. Each output element reads N logits and writes one; its
// N multiply-adds are far below the card's ratio of operations to bytes.
// What bounds a call depends on its size:
//  - At serving sizes ([2, 1..32, 10], at most 320 elements, 2.6 KB) the
//    bytes take about a nanosecond of device memory time: the launch
//    bounds the call. The design keeps the launch to one, with nothing
//    around it: each member's logits are read where the member wrote them,
//    through a table of member pointers passed by value in the kernel's
//    parameter space (no [N, B, C] stack, as the TPU kernel keeps that out
//    of memory), the weights arrive prepared (`ensemble_kernels`), and
//    the grid is one block of a few warps.
//  - At the NASNet ImageNet head's 1001 classes ([4, 4096, 1001] f32 or
//    [4, 8192, 1001] bf16, 82 MB, above the 50 MB L2) device memory bounds
//    it. The design streams: one 16-byte vector a thread (4 f32 or 8
//    bf16 elements) over a grid as large as the output (8008 blocks of
//    128 at these shapes: the first K1's one thread an element read
//    faster than a grid of 4 blocks an SM striding over the output). A
//    thread issues the loads of four f32 members (two bf16), their
//    weights and the bias before the first sum, so that it waits on
//    memory once (weights loaded after the members' arrival held f32
//    with vector weights and a bias at 1.1x the first K1's time). The
//    column of a vector weight or the bias follows the flat index, so an
//    odd C such as 1001 keeps the wide path; the elements past the last
//    whole vector go one a thread to a warp of their own, so that no warp
//    waits on memory twice (a tail in the vectors' warp, run after them,
//    put 0.45 us on [2, 1, 10]). Vector weights and the bias ((N + 1) * C
//    floats, a few KB that every block re-reads) are plain 4-byte loads
//    through L1 and L2.
// The stacked [N, B, C] form is the case of equal member strides: the
// table holds its base and the kernel steps by the stride, so both forms
// launch this kernel. Pointers that are not 16-byte aligned take the
// scalar variant (one element a thread), which the planner sizes too.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // most threads a block (ensemble_kernels.THREADS)
constexpr int kMinBlocks = 8;  // blocks an SM the registers must allow (64 registers)
// Members whose loads a thread keeps in flight: 64 bytes in f32, 32 in
// bf16, whose 8-element vectors would otherwise not fit 64 registers.
template <bool kBf16>
constexpr int kGroup = kBf16 ? 2 : 4;
// Member pointers a launch's table holds: the kernel's parameters stay
// under 4 KB (ensemble_kernels.MAX_MEMBERS); more members are stacked.
constexpr int kMaxTable = 448;

// Launch plan, field for field ensemble_kernels.PLAN_FIELDS (int64 each).
struct Plan {
  long long n;               // members
  long long bc;              // elements of the output, B * C
  long long c;               // classes
  long long is_bf16;         // logits and output in bf16 (else f32)
  long long vector_weights;  // weights [N, C] (else [N])
  long long has_bias;
  long long vec;             // elements a thread loads at once: 16 bytes' or 1
  long long threads;
  long long blocks;
  long long stride;          // bytes between members of a stacked tensor (0: table)
};

struct Args {
  const char* member[kMaxTable];
  const float* weights;
  const float* bias;
  char* out;
  long long bc;
  long long stride;
  int n, c, vector_weights, has_bias;
};

// V consecutive elements at `e`: one 16-byte load (4 f32 or 8 bf16) or
// one element, kept packed until the sums take them.
template <bool kBf16, int V>
struct Raw;
template <>
struct Raw<false, 4> { using T = float4; };
template <>
struct Raw<true, 8> { using T = uint4; };
template <>
struct Raw<false, 1> { using T = float; };
template <>
struct Raw<true, 1> { using T = unsigned short; };

template <bool kBf16, int V>
__device__ __forceinline__ typename Raw<kBf16, V>::T load(const char* base, long long e) {
  return __ldg(reinterpret_cast<const typename Raw<kBf16, V>::T*>(base) + e / V);
}

// Packed elements as f32; bf16 -> f32 is exact (the top 16 bits).
__device__ __forceinline__ void unpack(float4 v, float (&x)[4]) {
  x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
}
__device__ __forceinline__ void unpack(uint4 v, float (&x)[8]) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    x[2 * k] = __uint_as_float(w[k] << 16);
    x[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(float v, float (&x)[1]) { x[0] = v; }
__device__ __forceinline__ void unpack(unsigned short v, float (&x)[1]) {
  x[0] = __uint_as_float((unsigned)v << 16);
}

// f32 -> bf16 bits, rounded to nearest even; a NaN becomes 0x7fc0, as
// torch rounds.
__device__ __forceinline__ unsigned bf16_bits(float f) {
  const unsigned u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0u;
  return (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
}

template <bool kBf16, int V>
__device__ __forceinline__ void store(char* base, long long e, const float (&x)[V]) {
  if constexpr (!kBf16 && V == 4) {
    reinterpret_cast<float4*>(base)[e / 4] = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (kBf16 && V == 8) {
    uint4 v;
    v.x = bf16_bits(x[0]) | (bf16_bits(x[1]) << 16);
    v.y = bf16_bits(x[2]) | (bf16_bits(x[3]) << 16);
    v.z = bf16_bits(x[4]) | (bf16_bits(x[5]) << 16);
    v.w = bf16_bits(x[6]) | (bf16_bits(x[7]) << 16);
    reinterpret_cast<uint4*>(base)[e / 8] = v;
  } else if constexpr (!kBf16) {
    reinterpret_cast<float*>(base)[e] = x[0];
  } else {
    reinterpret_cast<unsigned short*>(base)[e] = (unsigned short)bf16_bits(x[0]);
  }
}

__device__ __forceinline__ const char* member_ptr(const Args& a, int m) {
  return a.stride ? a.member[0] + m * a.stride : a.member[m];
}

// w[j] = row[(col + j) mod C] for j < V: the columns of V consecutive
// elements, wrapping at C, as 4-byte loads through L1 and L2.
template <int V>
__device__ __forceinline__ void columns(const float* row, int c, int col, float (&w)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    w[j] = __ldg(row + col);
    if (++col == c) col = 0;
  }
}

// Elements e .. e + V - 1, the first in column `col`.
template <bool kBf16, int V>
__device__ __forceinline__ void combine_at(const Args& a, long long e, int col) {
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.0f;
  float b[V];
  if (a.has_bias) columns<V>(a.bias, a.c, col, b);
  constexpr int group = kGroup<kBf16>;
  for (int m0 = 0; m0 < a.n; m0 += group) {
    // The group's loads, members' and weights', all issued before the
    // first sum: a thread waits on memory once a group.
    typename Raw<kBf16, V>::T raw[group];
    float w[group][V];  // vector weights: the V columns of each member
    float ws[group];    // scalar weights
#pragma unroll
    for (int k = 0; k < group; ++k) {
      if (m0 + k >= a.n) break;
      raw[k] = load<kBf16, V>(member_ptr(a, m0 + k), e);
      if (a.vector_weights)
        columns<V>(a.weights + (long long)(m0 + k) * a.c, a.c, col, w[k]);
      else
        ws[k] = __ldg(a.weights + m0 + k);
    }
#pragma unroll
    for (int k = 0; k < group; ++k) {
      if (m0 + k >= a.n) break;
      float x[V];
      unpack(raw[k], x);
#pragma unroll
      for (int j = 0; j < V; ++j)
        acc[j] = __fadd_rn(acc[j], __fmul_rn(x[j], a.vector_weights ? w[k][j] : ws[k]));
    }
  }
  if (a.has_bias) {
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = __fadd_rn(acc[j], b[j]);
  }
  store<kBf16, V>(a.out, e, acc);
}

// Column of element e: e mod C, in 32 bits where e fits.
__device__ __forceinline__ int column(const Args& a, long long e) {
  if (!(a.vector_weights || a.has_bias)) return 0;
  return e <= 0x7fffffff ? (int)((unsigned)e % (unsigned)a.c) : (int)(e % a.c);
}

// One launch, one item a thread: thread t < B*C / V takes the whole
// vector of V elements from t * V; the elements past the last whole
// vector (fewer than V) go one a thread to the warp that follows the
// vectors' last warp.
template <bool kBf16, int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    combine_kernel(const __grid_constant__ Args a) {
  const long long nvec = a.bc / V;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < nvec) {
    combine_at<kBf16, V>(a, t * V, column(a, t * V));
  } else if (V > 1) {
    const long long e = nvec * V + (t - ((nvec + 31) & ~31LL));
    if (e >= nvec * V && e < a.bc) combine_at<kBf16, 1>(a, e, column(a, e));
  }
}

template <bool kBf16, int V>
int launch(const Plan& p, const void* const* ptrs, cudaStream_t stream) {
  Args a = {};
  const int table = p.stride ? 1 : (int)p.n;
  for (int m = 0; m < table; ++m) a.member[m] = static_cast<const char*>(ptrs[m]);
  a.weights = static_cast<const float*>(ptrs[table]);
  a.bias = static_cast<const float*>(ptrs[table + 1]);
  a.out = static_cast<char*>(const_cast<void*>(ptrs[table + 2]));
  a.bc = p.bc;
  a.stride = p.stride;
  a.n = (int)p.n;
  a.c = (int)p.c;
  a.vector_weights = (int)p.vector_weights;
  a.has_bias = (int)p.has_bias;
  combine_kernel<kBf16, V><<<(unsigned)p.blocks, (unsigned)p.threads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// One K1 launch. `plan`: a Plan (int64 fields). `ptrs`: the member table
// (N pointers, or the stacked tensor's base when plan.stride > 0), then
// the f32 weights ([N] or [N, C]), the f32 bias ([C], null when absent)
// and the output. Refuses, before launching, a plan the kernel does not
// take and a wide plan (vec > 1) whose members, output or stride are not
// 16-byte aligned.
extern "C" int combine_forward(const long long* plan, const void* const* ptrs, void* stream) {
  const Plan& p = *reinterpret_cast<const Plan*>(plan);
  if (p.bc == 0) return 0;
  const long long table = p.stride ? 1 : p.n;
  if (p.n < 1 || table > kMaxTable || p.c < 1 || p.threads < 1 || p.threads > kThreads ||
      p.blocks < 1)
    return (int)cudaErrorInvalidValue;
  const int wide = p.is_bf16 ? 8 : 4;
  if (p.vec != 1 && p.vec != wide) return (int)cudaErrorInvalidValue;
  if (p.vec > 1) {
    uintptr_t bits = (uintptr_t)ptrs[table + 2] | (uintptr_t)p.stride;
    for (long long m = 0; m < table; ++m) bits |= (uintptr_t)ptrs[m];
    if (bits & 15) return (int)cudaErrorMisalignedAddress;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (p.is_bf16) return p.vec > 1 ? launch<true, 8>(p, ptrs, s) : launch<true, 1>(p, ptrs, s);
  return p.vec > 1 ? launch<false, 4>(p, ptrs, s) : launch<false, 1>(p, ptrs, s);
}
