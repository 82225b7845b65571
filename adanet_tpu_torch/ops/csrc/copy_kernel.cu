// K0: identity copy, the build-and-launch self-test of the port's kernels.
//
// Replaces: adanet_tpu/ops/sepconv_kernels.py `_platform_dependent_prunes`
// (`_tpu_branch`, the Pallas copy kernel `_kernel`), which probes whether
// a Pallas TPU kernel lowers before the real kernels are used. Here the
// probe is a real launch: one copy on the current stream, checked with
// cudaGetLastError, run once per process before K1 and K2.
//
// Bound: bytes (n reads + n writes), 32 bytes at the probe's size, so
// 0.02 ns of the card's memory time; what a call costs is the launch, and
// most of that is the host's side of it (the wrapper's Python, the ctypes
// call, cudaLaunchKernel). Design: on the device, a grid-stride byte loop,
// no shared memory, nothing to tune. On the host, the launch path is kept
// to what torch.clone does (an allocation and one launch): the wrapper
// (`_build.copy_tensor`) takes the bound function from a dict without a
// lock once the libraries are loaded, and the stream's raw handle with
// one C call (`_build.stream_handle`), with no torch.cuda.Stream built.

#include <cuda_runtime.h>
#include <cstdint>

__global__ void copy_bytes_kernel(const unsigned char* __restrict__ src,
                                  unsigned char* __restrict__ dst,
                                  long long nbytes) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long step = (long long)gridDim.x * blockDim.x;
  for (; i < nbytes; i += step) dst[i] = src[i];
}

extern "C" int copy_forward(const void* src, void* dst, long long nbytes,
                            void* stream) {
  if (nbytes <= 0) return 0;
  const int threads = 256;
  long long blocks = (nbytes + threads - 1) / threads;
  if (blocks > 1024) blocks = 1024;
  copy_bytes_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const unsigned char*)src, (unsigned char*)dst, nbytes);
  return (int)cudaGetLastError();
}

// The message of a cudaError_t, for the Python wrappers' exceptions.
extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
