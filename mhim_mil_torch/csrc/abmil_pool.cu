// Masked ABMIL attention pooling for sm_90a (K4).
//
// Replaces the Pallas kernel `_abmil_kernel`
// (mhim_mil_tpu/ops/pallas_abmil.py:42-75, launched by `fused_abmil_pool`).
// For each bag b it computes, over the valid tokens t of x[b] and their
// attention logits l[b, t]:
//   m = max_t l,  s = Σ_t exp(l − m),  pooled[b] = Σ_t exp(l − m)·x[b, t] / max(s, 1e-30)
// and writes pooled[B, D] with the stats (denominator max(s, 1e-30), m) from
// which the caller recomputes attn[B, N]. A bag with no valid token gives
// pooled = 0, denominator 1e-30 and m = −1e30, as on the TPU.
//
// Bound at the flagship (batch 4, N = 10,240, D = 512): x is read once,
// 84 MB in fp32 (42 MB in bf16), against 2·B·N·D = 42 MFLOP; bytes bound it,
// at 0.025 ms (fp32) on 3.35 TB/s. What the design does about it: x is read
// once, coalesced (a warp reads 32 neighbouring columns of one token), in
// the caller's type, and never copied, padded or cast in device memory;
// masked tokens are skipped, not read.
//
// Design. The TPU grid (B, N/tile) runs in order and carries the online
// softmax state across tiles. One block per bag would leave 128 of the 132
// SMs idle at batch 4, so the work is split in two kernels:
//   partial: a block owns CHUNK tokens of one bag and all D columns; it
//            takes the chunk's max, weights p_t = exp(l_t − m_c) and writes
//            (m_c, s_c = Σ p_t, acc_c[D] = Σ p_t·x_t);
//   merge:   a block per (bag, 32 columns) rescales the partials by
//            exp(m_c − m) and sums them, its warps over disjoint chunks.
// Plain C interface, loaded with ctypes. The entry returns cudaGetLastError()
// after each launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int CHUNK = 64;  // tokens of a partial block
constexpr int MERGE_WARPS = 8;  // warps of a merge block
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Block-wide max / sum of one value per thread over NT threads; every thread
// gets the result.
template <int NT>
__device__ __forceinline__ float block_reduce(float v, float* red, bool is_max) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, w) : v + w;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // red may still be read by an earlier reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < NT / 32; ++w) v = is_max ? fmaxf(v, red[w]) : v + red[w];
  return v;
}

// grid (ceil(N / CHUNK), B). Thread tid owns columns tid + j·THREADS, j < CPT.
template <typename T, int CPT>
__global__ void __launch_bounds__(THREADS)
partial_kernel(const T* __restrict__ x, int64_t x_sb, int64_t x_sn,
               const float* __restrict__ logits, const uint8_t* __restrict__ mask,
               float* __restrict__ part_m, float* __restrict__ part_s,
               float* __restrict__ part_acc, int N, int D) {
  __shared__ float p[CHUNK];
  __shared__ uint8_t valid[CHUNK];
  __shared__ float red[THREADS / 32];
  const int c = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int nchunks = gridDim.x;
  const int t0 = c * CHUNK;
  const int nt = min(CHUNK, N - t0);
  const float* lb = logits + (int64_t)b * N + t0;
  const uint8_t* mb = mask + (int64_t)b * N + t0;

  float l = NEG_INF;
  for (int i = tid; i < nt; i += THREADS)
    if (mb[i]) l = fmaxf(l, lb[i]);
  const float m = block_reduce<THREADS>(l, red, true);

  float s = 0.f;
  for (int i = tid; i < CHUNK; i += THREADS) {
    const bool in = i < nt && mb[i];
    const float e = in ? expf(lb[i] - m) : 0.f;
    p[i] = e;
    valid[i] = in;
    s += e;
  }
  s = block_reduce<THREADS>(s, red, false);  // its barriers also publish p and valid

  float acc[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) acc[j] = 0.f;
  const T* xb = x + (int64_t)b * x_sb + (int64_t)t0 * x_sn;
#pragma unroll 4
  for (int i = 0; i < nt; ++i) {
    if (!valid[i]) continue;  // block-uniform; a masked row may hold anything
    const float w = p[i];
    const T* row = xb + (int64_t)i * x_sn;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int d = tid + j * THREADS;
      if (d < D) acc[j] += w * to_f32(row[d]);
    }
  }
  const int64_t slot = (int64_t)b * nchunks + c;
  float* out = part_acc + slot * D;
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int d = tid + j * THREADS;
    if (d < D) out[d] = acc[j];
  }
  if (tid == 0) {
    part_m[slot] = m;
    part_s[slot] = s;
  }
}

// grid (ceil(D / 32), B), 32·MERGE_WARPS threads; dynamic shared memory:
// nchunks floats of rescale factors. Lane l of every warp owns column
// 32·blockIdx.x + l; warp w sums the chunks c ≡ w (mod MERGE_WARPS), and the
// warps' sums meet in shared memory. Every block of a bag computes the bag's
// max and denominator from the nchunks partial stats itself.
__global__ void __launch_bounds__(32 * MERGE_WARPS)
merge_kernel(const float* __restrict__ part_m, const float* __restrict__ part_s,
             const float* __restrict__ part_acc, float* __restrict__ pooled,
             float* __restrict__ stats, int nchunks, int D) {
  constexpr int NT = 32 * MERGE_WARPS;
  extern __shared__ float scale[];
  __shared__ float red[MERGE_WARPS];
  __shared__ float acc_w[MERGE_WARPS][32];
  const int b = blockIdx.y, tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const float* pm = part_m + (int64_t)b * nchunks;
  const float* ps = part_s + (int64_t)b * nchunks;

  float mx = NEG_INF;
  for (int c = tid; c < nchunks; c += NT) mx = fmaxf(mx, pm[c]);
  const float m = block_reduce<NT>(mx, red, true);
  float s = 0.f;
  for (int c = tid; c < nchunks; c += NT) {
    const float e = expf(pm[c] - m);
    scale[c] = e;
    s += ps[c] * e;
  }
  s = block_reduce<NT>(s, red, false);  // its barriers also publish scale
  const float denom = fmaxf(s, 1e-30f);

  const int d = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (d < D) {
    const float* pa = part_acc + (int64_t)b * nchunks * D + d;
#pragma unroll 4
    for (int c = warp; c < nchunks; c += MERGE_WARPS) acc += pa[(int64_t)c * D] * scale[c];
  }
  acc_w[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && d < D) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < MERGE_WARPS; ++w) t += acc_w[w][lane];
    pooled[(int64_t)b * D + d] = t / denom;
  }
  if (blockIdx.x == 0 && tid == 0) {
    stats[2 * b] = denom;
    stats[2 * b + 1] = m;
  }
}

template <typename T, int CPT>
int launch(const void* x, int64_t x_sb, int64_t x_sn, const float* logits,
           const uint8_t* mask, float* part_m, float* part_s, float* part_acc,
           float* pooled, float* stats, int B, int N, int D, cudaStream_t st) {
  const int nchunks = (N + CHUNK - 1) / CHUNK;
  partial_kernel<T, CPT><<<dim3(nchunks, B), THREADS, 0, st>>>(
      static_cast<const T*>(x), x_sb, x_sn, logits, mask, part_m, part_s, part_acc, N, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)nchunks * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  merge_kernel<<<dim3((D + 31) / 32, B), 32 * MERGE_WARPS, smem, st>>>(
      part_m, part_s, part_acc, pooled, stats, nchunks, D);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, int64_t x_sb, int64_t x_sn, const float* logits,
             const uint8_t* mask, float* part_m, float* part_s, float* part_acc,
             float* pooled, float* stats, int B, int N, int D, cudaStream_t st) {
  if (D <= THREADS)
    return launch<T, 1>(x, x_sb, x_sn, logits, mask, part_m, part_s, part_acc, pooled, stats, B, N, D, st);
  if (D <= 2 * THREADS)
    return launch<T, 2>(x, x_sb, x_sn, logits, mask, part_m, part_s, part_acc, pooled, stats, B, N, D, st);
  if (D <= 4 * THREADS)
    return launch<T, 4>(x, x_sb, x_sn, logits, mask, part_m, part_s, part_acc, pooled, stats, B, N, D, st);
  if (D <= 8 * THREADS)
    return launch<T, 8>(x, x_sb, x_sn, logits, mask, part_m, part_s, part_acc, pooled, stats, B, N, D, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int abmil_pool_chunk() { return CHUNK; }

// x[B, N, D] with strides (x_sb, x_sn, 1), fp32 (x_bf16 = 0) or bf16 (1);
// logits[B, N] fp32 and mask[B, N] bytes, contiguous; scratch part_m,
// part_s[B, nchunks] and part_acc[B, nchunks, D] with nchunks =
// ceil(N / abmil_pool_chunk()); outputs pooled[B, D] and stats[B, 2].
extern "C" int abmil_pool(const void* x, int64_t x_sb, int64_t x_sn, int x_bf16,
                          const float* logits, const uint8_t* mask, float* part_m,
                          float* part_s, float* part_acc, float* pooled, float* stats,
                          int B, int N, int D, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return dispatch<__nv_bfloat16>(x, x_sb, x_sn, logits, mask, part_m, part_s, part_acc,
                                   pooled, stats, B, N, D, st);
  return dispatch<float>(x, x_sb, x_sn, logits, mask, part_m, part_s, part_acc, pooled,
                         stats, B, N, D, st);
}
