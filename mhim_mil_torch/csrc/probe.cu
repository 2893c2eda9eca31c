// The kernel gate's probe for sm_90a (K6).
//
// Replaces the kernel `k` of the Mosaic probe `_PROBE_SRC`
// (mhim_mil_tpu/utils/pallas_gate.py:37-41, run by `probe_mosaic`): o = x + 1
// over an fp32 array. The gate builds this source and launches it in a
// subprocess before it enables the other kernels, so a toolkit that cannot
// build for sm_90a, or a card that cannot run what it builds, shows there
// and not in the driver's process. One thread per element; plain C
// interface, loaded with ctypes; the entry returns cudaGetLastError() after
// the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void probe_kernel(const float* __restrict__ x, float* __restrict__ o, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = x[i] + 1.0f;
}

}  // namespace

// x[n] and o[n] fp32, contiguous, on the card.
extern "C" int probe(const float* x, float* o, int64_t n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  constexpr int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  probe_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(x, o, n);
  return (int)cudaGetLastError();
}
