// Masked ABMIL attention pooling for sm_90a (K4), in one launch.
//
// Replaces the Pallas kernel `_abmil_kernel`
// (mhim_mil_tpu/ops/pallas_abmil.py:42-75, launched by `fused_abmil_pool`)
// and the recompute of attn after it (:135-143). For each bag b, over the
// valid tokens t of x[b] and their attention logits l[b, t]:
//   m = max_t l,  s = Σ_t exp(l − m),  pooled[b] = Σ_t exp(l − m)·x[b, t] / max(s, 1e-30),
//   attn[b, t] = exp(l − m) / max(s, 1e-30) where t is valid, else 0.
// A bag with no valid token gives pooled = 0 and attn = 0, as on the TPU.
//
// Bound at the flagship (batch 4, N = 10,240, D = 512): x is read once,
// 84 MB in fp32 (42 MB in bf16), against 2·B·N·D = 42 MFLOP; bytes bound it,
// at 0.025 ms (fp32) on 3.35 TB/s. What the design does about it: x is read
// once, in the caller's type, by 16-byte loads, eight rows of a thread in
// flight (64 KB a block of 512 threads), and never copied, padded or cast in
// device memory; masked tokens are skipped, not read; the grid is about
// two blocks an SM (the wrapper's `abmil_plan`), so every SM streams
// its share in one wave and the merge below has few chunks to add.
//
// Design. The TPU grid (B, N/tile) runs in order and carries the online
// softmax state across tiles. Here a block owns a chunk of one bag's tokens
// and all D ≤ 1,024 columns: it takes the chunk's max m_c, its weights
// p_t = exp(l_t − m_c) and s_c = Σ p_t, and acc_c[D] = Σ p_t·x_t, a thread
// owning a 16-byte column piece of every few rows, the rows' sums added in
// a fixed order through shared memory; it writes (m_c, s_c, acc_c) to
// scratch. The last block of a bag to finish (an int32 ticket, reset for
// the next launch; flash_nystrom.cuh's `arrived_last`) merges the bag's
// chunks, rescaling each by exp(m_c − m): a thread adds 4 columns of every
// few chunks with their loads in flight, and the threads' sums meet in
// shared memory in a fixed order; it writes pooled[b] and attn[b, :]. No
// float atomics, so the bits are fixed, and nothing is left for the
// wrapper to launch. Plain C interface, loaded with
// ctypes; the entry returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>

#include "flash_nystrom.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int U = 8;  // rows of a thread with their loads in flight
constexpr int MAX_CHUNK = 1024;  // tokens of a block
constexpr int MAX_CHUNKS = 4096;  // chunks of a bag

template <typename T>
struct Piece;  // 16 bytes of x: VEC elements
template <>
struct Piece<float> {
  static constexpr int VEC = 4;
};
template <>
struct Piece<__nv_bfloat16> {
  static constexpr int VEC = 8;
};

__device__ __forceinline__ uint32_t bits_of(float v) { return __float_as_uint(v); }
__device__ __forceinline__ uint32_t bits_of(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }

// Elements [c0, c0 + VEC) of a row as 16 raw bytes, zero past D: one 16-byte
// load where the rows are 16-byte aligned and the piece is whole.
template <typename T, bool ALIGNED>
__device__ __forceinline__ uint4 load_piece(const T* row, int c0, int D) {
  constexpr int VEC = Piece<T>::VEC;
  if (ALIGNED && c0 + VEC <= D) return __ldg(reinterpret_cast<const uint4*>(row + c0));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < VEC; ++e)
    if (c0 + e < D) w[e * 4 / VEC] |= bits_of(row[c0 + e]) << (32 / (VEC / 4) * (e % (VEC / 4)));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The VEC elements of a piece as floats.
template <typename T>
__device__ __forceinline__ void decode(uint4 r, float f[Piece<T>::VEC]) {
  const uint32_t u[4] = {r.x, r.y, r.z, r.w};
  if constexpr (Piece<T>::VEC == 4) {
#pragma unroll
    for (int e = 0; e < 4; ++e) f[e] = __uint_as_float(u[e]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      f[2 * e] = __uint_as_float(u[e] << 16);
      f[2 * e + 1] = __uint_as_float(u[e] & 0xffff0000u);
    }
  }
}

// Block-wide max / sum of one value a thread; every thread gets the result,
// summed in the same order in every launch.
__device__ __forceinline__ float block_reduce(float v, float* red, bool is_max) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, w) : v + w;
  }
  __syncthreads();  // red may still be read by an earlier reduction
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < THREADS / 32; ++w) v = is_max ? fmaxf(v, red[w]) : v + red[w];
  return v;
}

// grid (nchunks, B), THREADS threads; dynamic shared memory max(5·chunk,
// 4·nchunks) bytes (rounded to 16). Thread tid owns column piece tid % cvp
// (cvp: the row's pieces rounded up to a power of two) of rows
// tid / cvp + k·(THREADS / cvp) of the chunk.
template <typename T, bool ALIGNED>
__global__ void __launch_bounds__(THREADS, 2)
abmil_pool_kernel(const T* __restrict__ x, int64_t x_sb, int64_t x_sn, const float* __restrict__ logits,
                  const uint8_t* __restrict__ mask, float* __restrict__ part_ms, float* __restrict__ part_acc,
                  int* __restrict__ tickets, float* __restrict__ pooled, float* __restrict__ attn, int N, int D,
                  int chunk, int cvp) {
  const int dp = (D + 3) / 4 * 4;  // floats of a row of part_acc
  constexpr int VEC = Piece<T>::VEC;
  extern __shared__ __align__(16) float dyn[];
  __shared__ float red[THREADS / 32];
  __shared__ __align__(16) float rows[THREADS * VEC];
  float* p = dyn;  // chunk weights, then (last block) the chunks' scales
  uint8_t* valid = reinterpret_cast<uint8_t*>(dyn + chunk);
  const int c = blockIdx.x, b = blockIdx.y, tid = threadIdx.x, nchunks = gridDim.x;
  const int t0 = c * chunk, nt = min(chunk, N - t0);
  const float* lb = logits + (int64_t)b * N;
  const uint8_t* mb = mask + (int64_t)b * N;

  const int piece = tid % cvp, lane_row = tid / cvp, rpb = THREADS / cvp, c0 = piece * VEC;
  const bool cols = c0 < D;
  const T* xb = x + (int64_t)b * x_sb + (int64_t)t0 * x_sn;
  float l = NEG_INF;
  for (int i = tid; i < nt; i += THREADS)
    if (mb[t0 + i]) l = fmaxf(l, lb[t0 + i]);
  const float m_c = block_reduce(l, red, true);
  float s = 0.f;
  for (int i = tid; i < nt; i += THREADS) {
    const bool in = mb[t0 + i];
    const float e = in ? expf(lb[t0 + i] - m_c) : 0.f;
    p[i] = e;
    valid[i] = in;
    s += e;
  }
  const float s_c = block_reduce(s, red, false);  // its barriers also publish p and valid

  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
  for (int i0 = lane_row; i0 < nt; i0 += U * rpb) {
    uint4 raw[U];
    float w[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {  // all U rows' loads first
      const int i = i0 + u * rpb;
      const bool use = cols && i < nt && valid[i];  // a masked row may hold anything: never read
      w[u] = use ? p[i] : 0.f;
      if (use) raw[u] = load_piece<T, ALIGNED>(xb + (int64_t)i * x_sn, c0, D);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (w[u] != 0.f) {
        float f[VEC];
        decode<T>(raw[u], f);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] += w[u] * f[e];
      }
  }
  // the rpb row lanes' sums of each column, added in row-lane order
#pragma unroll
  for (int e = 0; e < VEC; ++e) rows[lane_row * cvp * VEC + c0 + e] = acc[e];
  __syncthreads();
  const int64_t slot = (int64_t)b * nchunks + c;
  for (int d = tid; d < D; d += THREADS) {
    float v = rows[d];
    for (int r = 1; r < rpb; ++r) v += rows[r * cvp * VEC + d];
    part_acc[slot * dp + d] = v;
  }
  if (tid == 0) {
    part_ms[2 * slot] = m_c;
    part_ms[2 * slot + 1] = s_c;
  }
  if (!arrived_last(tickets + b, nchunks)) return;

  // the last block of bag b: merge its chunks
  const float* pm = part_ms + (int64_t)b * nchunks * 2;
  float mx = NEG_INF;
  for (int k = tid; k < nchunks; k += THREADS) mx = fmaxf(mx, __ldcg(pm + 2 * k));
  const float m = block_reduce(mx, red, true);
  float* scale = dyn;
  float st = 0.f;
  for (int k = tid; k < nchunks; k += THREADS) {
    const float e = expf(__ldcg(pm + 2 * k) - m);
    scale[k] = e;
    st += __ldcg(pm + 2 * k + 1) * e;
  }
  const float denom = fmaxf(block_reduce(st, red, false), 1e-30f);  // its barriers also publish scale
  // thread (group, piece): 4 columns, the chunks group, group + groups, ...;
  // the groups' sums then added in group order
  const int pieces = (D + 3) / 4, groups = max(1, THREADS / pieces);
  const int q = tid % pieces, grp = tid / pieces;
  const float4* pa = reinterpret_cast<const float4*>(part_acc + (int64_t)b * nchunks * dp) + q;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (grp < groups) {
#pragma unroll 8
    for (int k = grp; k < nchunks; k += groups) {
      const float4 a = __ldcg(pa + (int64_t)k * (dp / 4));
      const float e = scale[k];
      v.x += a.x * e;
      v.y += a.y * e;
      v.z += a.z * e;
      v.w += a.w * e;
    }
  }
  __syncthreads();  // rows is free
  float4* gs = reinterpret_cast<float4*>(rows);
  if (grp < groups) gs[grp * pieces + q] = v;
  __syncthreads();
  for (int d = tid; d < D; d += THREADS) {
    float t = 0.f;
    for (int g2 = 0; g2 < groups; ++g2) t += rows[g2 * pieces * 4 + d];
    pooled[(int64_t)b * D + d] = t / denom;
  }
  if (attn != nullptr)
    for (int n = tid; n < N; n += THREADS)
      attn[(int64_t)b * N + n] = mb[n] ? expf(lb[n] - m) / denom : 0.f;
}

template <typename T>
int launch(const void* x, int64_t x_sb, int64_t x_sn, bool aligned, const float* logits, const uint8_t* mask,
           float* part_ms, float* part_acc, int* tickets, float* pooled, float* attn, int B, int N, int D,
           int chunk, cudaStream_t st) {
  constexpr int VEC = Piece<T>::VEC;
  const int nchunks = (N + chunk - 1) / chunk;
  int cvp = 1;
  while (cvp * VEC < D) cvp *= 2;
  if (cvp > THREADS || chunk < 1 || chunk > MAX_CHUNK || nchunks > MAX_CHUNKS) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(max(5 * chunk, 4 * nchunks) + 15) / 16 * 16;
  const dim3 grid(nchunks, B);
  const T* xt = static_cast<const T*>(x);
  if (aligned)
    abmil_pool_kernel<T, true><<<grid, THREADS, smem, st>>>(xt, x_sb, x_sn, logits, mask, part_ms, part_acc,
                                                            tickets, pooled, attn, N, D, chunk, cvp);
  else
    abmil_pool_kernel<T, false><<<grid, THREADS, smem, st>>>(xt, x_sb, x_sn, logits, mask, part_ms, part_acc,
                                                             tickets, pooled, attn, N, D, chunk, cvp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int abmil_pool_limits(int* out) {
  out[0] = THREADS;
  out[1] = MAX_CHUNK;
  out[2] = MAX_CHUNKS;
  return 0;
}

// x[B, N, D] with strides (x_sb, x_sn, 1), fp32 (x_bf16 = 0) or bf16 (1),
// rows 16-byte aligned where `aligned`; D ≤ 512 pieces of 16 bytes; logits
// [B, N] fp32 and mask[B, N] bytes, contiguous; scratch part_ms[B, nchunks, 2]
// and part_acc[B, nchunks, ceil(D / 4)·4] with nchunks = ceil(N / chunk); tickets[B]
// int32, zero at the first launch and left zero by each; outputs
// pooled[B, D] and attn[B, N] (null: not written).
extern "C" int abmil_pool(const void* x, int64_t x_sb, int64_t x_sn, int x_bf16, int aligned,
                          const float* logits, const uint8_t* mask, float* part_ms, float* part_acc,
                          int* tickets, float* pooled, float* attn, int B, int N, int D, int chunk,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || N < 1 || D < 1) return (int)cudaErrorInvalidValue;
  if (x_bf16)
    return launch<__nv_bfloat16>(x, x_sb, x_sn, aligned, logits, mask, part_ms, part_acc, tickets, pooled,
                                 attn, B, N, D, chunk, st);
  return launch<float>(x, x_sb, x_sn, aligned, logits, mask, part_ms, part_acc, tickets, pooled, attn, B, N, D,
                       chunk, st);
}
