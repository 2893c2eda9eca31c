// Warp-level pieces shared by the flash-Nystrom kernels for sm_90a: the
// forward passes K1 and K2 (flash_nystrom.cu) and their backwards, K2b
// (flash_nystrom_bwd.cu) and K1b (flash_nystrom_k1b.cu).
//
// Precision: 3×TF32. Each fp32 operand x is split into hi = tf32(x)
// (rounded to nearest) and lo = x − hi (truncated to TF32 by the tensor
// core, see `split`), and each product is lo·hi + hi·lo + hi·hi, accumulated
// in fp32 by mma.sync.m16n8k8: close to fp32's accuracy (the lo·lo term is
// below 2^-22 and the truncation of lo below 2^-21 of |x|·|y|) at three
// tensor-core products. A single TF32 product fails the kernels' tolerances.
// Exponentials are __expf (ex2.approx of x·log2 e): their error grows with
// |x| to a few ulps at the scores' tens, far inside the tolerances.
//
// Layouts. Every product is a warp's mma.sync over 16 rows, in the m16n8k8
// accumulator layout (thread g·4 + t holds rows g and g + 8, columns 2t and
// 2t + 1 of each 8-column tile). A score tile S of a 32-column step stays in
// registers: the sum over S's columns does not care about their order, so
// the thread's columns 2t, 2t + 1 of tile j are taken as the A fragment's
// columns t and t + 4, and the B fragment of the next product is read from
// rows 8j + 2t and 8j + 2t + 1 to match. No shuffle and no shared-memory
// round trip for P. Operand tiles are staged in shared memory in rows of
// dh + 4 floats (the fragment reads are free of bank conflicts) by 16-byte
// cp.async straight from strided views.
//
// Head dims 16, 32, 64, 128 and 256 are instantiated. A block of K1 or K2
// keeps at most a 128-column accumulator (64 floats a thread): at 256 the
// grid runs two column halves, each block computing its scores over all 256
// columns (`scores` loops over them in k8 steps) and accumulating its half
// of the value side, read at a column offset from rows staged at full
// width. The backward kernels split the head dim across warps instead
// (flash_nystrom_bwd.cuh).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---- phase stamps, in diagnostic builds only ----
// Built with -DNYS_PHASES (mhim_mil_torch/utils/phase_nystrom_bwd.py), each
// warp of a backward kernel sums the clock64() cycles between its PHASE
// marks, by the phase that just ended, and adds them to
// g_phases[kernel][phase] at its end; slot NPHASES counts the warps. Two
// more switches of those builds: NYS_FREE_SPLIT makes flash_nystrom_bwd.cuh's
// `split_t` pass each operand to the tensor cores unsplit (hi = lo = x:
// wrong sums, the same mma.sync count) and NYS_ONE_MMA makes `mma3` issue
// the hi·hi product alone. Without NYS_PHASES the marks compile to nothing.
enum Phase { PH_STAGE, PH_WAIT, PH_SCORES, PH_ELEM, PH_ACC, PH_EPI, NPHASES };
#ifdef NYS_PHASES
__device__ unsigned long long* g_phases;
#define PHASES_BEGIN                  \
  long long ph_acc_[NPHASES] = {};    \
  long long ph_t_ = clock64();
#define PHASE(p)                        \
  do {                                  \
    const long long t_ = clock64();     \
    ph_acc_[p] += t_ - ph_t_;           \
    ph_t_ = t_;                         \
  } while (0)
#define PHASES_END(kernel)                                                               \
  do {                                                                                   \
    if (g_phases != nullptr && threadIdx.x % 32 == 0) {                                  \
      for (int p_ = 0; p_ < NPHASES; ++p_)                                               \
        atomicAdd(g_phases + (kernel) * (NPHASES + 1) + p_, (unsigned long long)ph_acc_[p_]); \
      atomicAdd(g_phases + (kernel) * (NPHASES + 1) + NPHASES, 1ull);                    \
    }                                                                                    \
  } while (0)
#define PHASES_ENTRY(prefix)                                           \
  extern "C" int prefix##_set_phases(void* p) {                        \
    return (int)cudaMemcpyToSymbol(g_phases, &p, sizeof(p));           \
  }
// A kernel's blocks an SM at `threads` and `smem` bytes of dynamic shared
// memory, its registers a thread, its local (spilled) bytes, smem and threads.
template <typename K>
int occupancy_of(K kernel, int threads, size_t smem, int* out) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cudaFuncAttributes a;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, kernel);
  int blocks = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = blocks;
  out[1] = a.numRegs;
  out[2] = (int)a.localSizeBytes;
  out[3] = (int)smem;
  out[4] = threads;
  return 0;
}
#else
#define PHASES_BEGIN
#define PHASE(p)
#define PHASES_END(kernel)
#define PHASES_ENTRY(prefix)
#endif

constexpr float NEG_INF = -1e30f;
constexpr int COLS = 32;      // columns of a step: keys, landmarks or tokens
constexpr int NT = COLS / 8;  // 8-column mma tiles of a step

// The accumulator columns of head dim DH and the column halves its grid runs.
__host__ __device__ constexpr int acc_cols(int dh) { return dh > 128 ? 128 : dh; }
__host__ __device__ constexpr int halves(int dh) { return dh / acc_cols(dh); }

__host__ __device__ constexpr bool instantiated(int dh) {
  return dh == 16 || dh == 32 || dh == 64 || dh == 128 || dh == 256;
}

// ---- 3×TF32 mma.sync ----

// x = hi + lo, hi = x rounded to TF32 (to nearest, ties away from zero, as
// cvt.rna.tf32.f32 rounds) and lo = x − hi exactly. Both go to mma.sync as
// fp32 bit patterns: a tf32 operand is read from the top 19 bits of its
// register (sign, exponent, 10 mantissa bits) and the rest is ignored, so hi
// arrives exact and lo truncated, off by at most 2^-21·|x|. Three
// instructions, where ptxas expands each cvt.rna.tf32.f32 into an integer
// sequence with a finiteness test of its own.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) + 0x1000u;
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u));
}

__device__ __forceinline__ void mma(float d[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a·b with both operands split: the small products first
__device__ __forceinline__ void mma3(float d[4], const uint32_t ah[4], const uint32_t al[4],
                                     const uint32_t bh[2], const uint32_t bl[2]) {
#ifndef NYS_ONE_MMA
  mma(d, al, bh);
  mma(d, ah, bl);
#endif
  mma(d, ah, bh);
}

// ---- cp.async ----

__device__ __forceinline__ void cp16(float* dst, const float* src, bool in) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp4(float* dst, const float* src, bool in) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s), "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Stage rows [0, R) of a strided [*, DH] slab into shared memory rows of
// DH + 4 floats; rows at or past nrows are zero-filled (and not read).
template <int DH, int R, int NTH>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int64_t stride, int nrows) {
  constexpr int CPR = DH / 4;  // 16-byte pieces of a row
  for (int c = threadIdx.x; c < R * CPR; c += NTH) {
    const int r = c / CPR, p = c % CPR;
    const bool in = r < nrows;
    cp16(dst + r * (DH + 4) + 4 * p, in ? src + r * stride + 4 * p : src, in);
  }
}

// Stage COLS consecutive floats of a vector by 4-byte cp.async, threads
// [first, first + COLS) one each; entries at or past n are zero-filled.
__device__ __forceinline__ void stage_vec(float* dst, const float* src, int n, int first) {
  const int i = threadIdx.x - first;
  if (i < 0 || i >= COLS) return;
  const bool in = i < n;
  cp4(dst + i, src + (in ? i : 0), in);
}

// ---- warp-level pieces, in the m16n8k8 layouts (g = lane / 4, t = lane % 4) ----

// s[j] = rows [0, 16) of A · rows [8j, 8j + 8) of B over DH; A and B are
// row-major in shared memory with rows of DH + 4 floats.
template <int DH>
__device__ __forceinline__ void scores(const float* A, const float* B, int g, int t, float s[NT][4]) {
  constexpr int LD = DH + 4;
#pragma unroll
  for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < DH; k0 += 8) {
    uint32_t ah[4], al[4];
    split(A[g * LD + k0 + t], ah[0], al[0]);
    split(A[(g + 8) * LD + k0 + t], ah[1], al[1]);
    split(A[g * LD + k0 + t + 4], ah[2], al[2]);
    split(A[(g + 8) * LD + k0 + t + 4], ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* b = B + (8 * j + g) * LD + k0 + t;
      uint32_t bh[2], bl[2];
      split(b[0], bh[0], bl[0]);
      split(b[4], bh[1], bl[1]);
      mma3(s[j], ah, al, bh, bl);
    }
  }
}

// Bit 2j + e set where the thread's column 8j + 2t + e of a step of 8·NTT
// columns starting at c0 is below `limit` and its flag is nonzero.
template <int NTT = NT>
__device__ __forceinline__ uint32_t valid_bits(const uint8_t* flags, int c0, int limit, int t) {
  uint32_t bits = 0;
#pragma unroll
  for (int j = 0; j < NTT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = c0 + 8 * j + 2 * t + e;
      if (c < limit && flags[c]) bits |= 1u << (2 * j + e);
    }
  return bits;
}

__device__ __forceinline__ bool kept(uint32_t keep, int j, int e) { return (keep >> (2 * j + e)) & 1u; }

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One step of the online softmax on a 16 × 8·NTT score tile (NTT = NT: a
// 16 × COLS tile): columns whose bit in `keep` is 0 are masked; updates the
// running max (quad-uniform) and the thread's share of the running sum,
// leaves the probabilities in s and the factor that rescaled the earlier
// sums in `scale`.
template <int NTT = NT>
__device__ __forceinline__ void online_softmax(float s[NTT][4], uint32_t keep, float m_run[2],
                                               float l_run[2], float scale[2]) {
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < NTT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool ok = kept(keep, j, e);
      s[j][e] = ok ? s[j][e] : NEG_INF;
      s[j][2 + e] = ok ? s[j][2 + e] : NEG_INF;
      mx[0] = fmaxf(mx[0], s[j][e]);
      mx[1] = fmaxf(mx[1], s[j][2 + e]);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m_run[r], quad_max(mx[r]));
    scale[r] = __expf(m_run[r] - m_new);
    m_run[r] = m_new;
    l_run[r] *= scale[r];
  }
#pragma unroll
  for (int j = 0; j < NTT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool ok = kept(keep, j, e);
      s[j][e] = ok ? __expf(s[j][e] - m_run[0]) : 0.f;
      s[j][2 + e] = ok ? __expf(s[j][2 + e] - m_run[1]) : 0.f;
      l_run[0] += s[j][e];
      l_run[1] += s[j][2 + e];
    }
}

// online_softmax, then the [16 × DH] accumulator rescaled to the new max.
template <int DH>
__device__ __forceinline__ void softmax_step(float s[NT][4], uint32_t keep, float m_run[2],
                                             float l_run[2], float acc[DH / 8][4]) {
  float scale[2];
  online_softmax(s, keep, m_run, l_run, scale);
#pragma unroll
  for (int d = 0; d < DH / 8; ++d) {
    acc[d][0] *= scale[0];
    acc[d][1] *= scale[0];
    acc[d][2] *= scale[1];
    acc[d][3] *= scale[1];
  }
}

template <int DH>
__device__ __forceinline__ void zero(float acc[DH / 8][4]) {
#pragma unroll
  for (int d = 0; d < DH / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
}

// acc += P · V over the step's COLS rows of V (DH columns of rows LD floats
// apart), P in the accumulator layout of `scores`: the thread's columns 2t,
// 2t + 1 of tile j serve as the A fragment's columns t, t + 4, so V's B
// fragment is read from rows 8j + 2t and 8j + 2t + 1. With ZERO, V rows whose
// bit in `keep` is 0 read as zero (values at masked rows may hold anything,
// NaN included).
template <int DH, bool ZERO, int LD = DH + 4>
__device__ __forceinline__ void accumulate(const float p[NT][4], const float* V, uint32_t keep,
                                           int g, int t, float acc[DH / 8][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    uint32_t ah[4], al[4];
    split(p[j][0], ah[0], al[0]);
    split(p[j][2], ah[1], al[1]);
    split(p[j][1], ah[2], al[2]);
    split(p[j][3], ah[3], al[3]);
    const float* v0 = V + (8 * j + 2 * t) * LD + g;
    const bool k0 = !ZERO || kept(keep, j, 0);
    const bool k1 = !ZERO || kept(keep, j, 1);
#pragma unroll
    for (int d = 0; d < DH / 8; ++d) {
      uint32_t bh[2], bl[2];
      split(k0 ? v0[8 * d] : 0.f, bh[0], bl[0]);
      split(k1 ? v0[LD + 8 * d] : 0.f, bh[1], bl[1]);
      mma3(acc[d], ah, al, bh, bl);
    }
  }
}

// Called by every thread of each of the `count` blocks that write the
// partial sums of one output tile, after their writes: true in the block
// that arrives last at `ticket` (an int32 that is 0 before the first
// arrival and that this block resets to 0 for the next launch), which then
// sees every other block's partial sums. No float atomics, so the sums that
// follow are in a fixed order.
__device__ __forceinline__ bool arrived_last(int* ticket, int count) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(ticket, 1) == count - 1;
    if (last) *ticket = 0;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// Store a warp's [16 × DH] accumulator row r (0: row g, 1: row g + 8) at
// dst (the row's first column), or zeros where `keep_row` is false.
template <int DH>
__device__ __forceinline__ void store_row(float* dst, const float acc[DH / 8][4], int r, int t,
                                          bool keep_row) {
#pragma unroll
  for (int d = 0; d < DH / 8; ++d)
    *reinterpret_cast<float2*>(dst + 8 * d + 2 * t) =
        keep_row ? make_float2(acc[d][2 * r], acc[d][2 * r + 1]) : make_float2(0.f, 0.f);
}

}  // namespace
