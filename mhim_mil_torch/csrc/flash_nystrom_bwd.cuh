// Geometry and warp-level pieces shared by the backward kernels K2b
// (flash_nystrom_bwd.cu) and K1b (flash_nystrom_k1b.cu), on top of
// flash_nystrom.cuh's 3×TF32 mma.sync, cp.async and m16n8k8 layouts.
//
// Geometry. A block is RG row groups × CG column groups, one warp each:
// warp (rg, cg) owns rows [16·rg, 16·rg + 16) of the block's rows and the
// head-dim columns [cg·DW, cg·DW + DW), DW = DH / CG ≤ 64. Up to DH 64, CG
// is 1 and RG 4 (64 rows, 128 threads); at DH 128, RG 2 × CG 2 (32 rows,
// 128 threads); at DH 256, RG 2 × CG 4 (32 rows, 256 threads). A score tile
// (16 rows × COLS columns) is a sum over the head dim: each warp of a row
// group computes it over its own DW columns, and the CG partial tiles are
// added through shared memory in column-group order (`group_sum`), so every
// warp of the group holds the same bits and no product is computed twice.
// Each warp then accumulates its own DW columns of the value side: the
// accumulators are at most 64 columns, 32 floats a thread each. Steps are
// COLS = 32 rows of the streamed operand up to DH 64 and 16 above, where a
// ring of two 32-row steps of two operands would hold an SM to one block.

#pragma once

#include "flash_nystrom.cuh"

namespace {

__host__ __device__ constexpr int bwd_cgroups(int dh) { return dh > 64 ? dh / 64 : 1; }
__host__ __device__ constexpr int bwd_rgroups(int dh) { return dh > 64 ? 2 : 4; }
__host__ __device__ constexpr int bwd_rows(int dh) { return 16 * bwd_rgroups(dh); }
__host__ __device__ constexpr int bwd_threads(int dh) { return 32 * bwd_rgroups(dh) * bwd_cgroups(dh); }
__host__ __device__ constexpr int bwd_cols(int dh) { return dh > 64 ? 16 : 32; }
// blocks an SM each backward kernel is built for (its __launch_bounds__):
// what shared memory admits at the rings below
__host__ __device__ constexpr int bwd_resident(int dh) { return dh > 128 ? 1 : dh > 64 ? 2 : 3; }

template <int DH>
struct Bwd {
  static constexpr int CG = bwd_cgroups(DH), RG = bwd_rgroups(DH), DW = DH / CG;
  static constexpr int ROWS = bwd_rows(DH), NTH = bwd_threads(DH);
  static constexpr int COLS = bwd_cols(DH), NT = COLS / 8, LD = DH + 4, TILE = COLS * LD;
  static constexpr int STAGES = 2;
  // floats of the partial score tiles that group_sum passes (two tiles a warp)
  static constexpr int XB = CG > 1 ? RG * CG * 2 * NT * 4 * 32 : 0;
};

__device__ __forceinline__ void group_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// The backward's split of x into TF32 hi + lo: hi = x as it is (mma.sync
// reads a tf32 operand from the top 19 bits of its register, so hi arrives
// as x truncated to TF32) and lo = x − trunc(x), exact, truncated in turn by
// the tensor core. Two instructions where flash_nystrom.cuh's `split`, which
// rounds hi to nearest, takes three (two of them on the integer pipe); the
// bound of a 3×TF32 product's error grows from about 2^-20 to 3·2^-20 of
// |x|·|y| (|lo| < 2^-10·|x|, not 2^-11), far inside the backward's
// tolerances (1e-4 of max|ref|, and the kernel gate's VJP criterion).
// NYS_FREE_SPLIT: see flash_nystrom.cuh.
__device__ __forceinline__ void split_t(float x, uint32_t& hi, uint32_t& lo) {
#ifdef NYS_FREE_SPLIT
  hi = lo = __float_as_uint(x);
#else
  hi = __float_as_uint(x);
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u));
#endif
}

// Four 8 × 8 b16 matrices from shared memory, each thread's row address p
// (lanes 8i..8i + 7 give matrix i's rows): r[i] holds the thread's 32-bit
// word (lane % 4) of row lane / 4 of matrix i, so a matrix of 8 rows × 4
// floats lands in the m16n8k8 tf32 fragment layout.
__device__ __forceinline__ void ldsm_x4(const float* p, uint32_t r[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

// s[j] = rows [0, 16) of A · rows [8j, 8j + 8) of B over K columns; A and B
// row-major in shared memory, rows LD floats apart (16-byte aligned), each
// already offset to the warp's first column. Fragments arrive by ldmatrix:
// one x4 for A's 16 × 8 step, one for two of B's 8 × 8 tiles.
template <int K, int NT, int LD>
__device__ __forceinline__ void scores_k(const float* A, const float* B, int g, int t, float s[NT][4]) {
  static_assert(NT % 2 == 0, "B tiles go in pairs");
  const int lane = 4 * g + t, mi = lane >> 3, rr = lane & 7;
  const float* a_row = A + (rr + 8 * (mi & 1)) * LD + 4 * (mi >> 1);
  const float* b_row = B + (rr + 8 * (mi >> 1)) * LD + 4 * (mi & 1);
#pragma unroll
  for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 8) {
    uint32_t araw[4], ah[4], al[4];
    ldsm_x4(a_row + k0, araw);
#pragma unroll
    for (int i = 0; i < 4; ++i) split_t(__uint_as_float(araw[i]), ah[i], al[i]);
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      uint32_t braw[4];
      ldsm_x4(b_row + 16 * jp * LD + k0, braw);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        uint32_t bh[2], bl[2];
        split_t(__uint_as_float(braw[2 * u]), bh[0], bl[0]);
        split_t(__uint_as_float(braw[2 * u + 1]), bh[1], bl[1]);
        mma3(s[2 * jp + u], ah, al, bh, bl);
      }
    }
  }
}

// acc += P · V over the step's 8·NT rows of V and DW of its columns (V
// offset to the warp's first column, rows LD floats apart), P in the
// accumulator layout of scores_k: the thread's columns 2t, 2t + 1 of tile j
// serve as the A fragment's columns t, t + 4, so V's B fragment is read from
// rows 8j + 2t and 8j + 2t + 1. With ZERO, V rows whose bit in `keep` is 0
// read as zero (values at masked rows may hold anything, NaN included).
template <int DW, int NT, int LD, bool ZERO>
__device__ __forceinline__ void accumulate_k(const float p[NT][4], const float* V, uint32_t keep, int g, int t,
                                             float acc[DW / 8][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    uint32_t ah[4], al[4];
    split_t(p[j][0], ah[0], al[0]);
    split_t(p[j][2], ah[1], al[1]);
    split_t(p[j][1], ah[2], al[2]);
    split_t(p[j][3], ah[3], al[3]);
    const float* v0 = V + (8 * j + 2 * t) * LD + g;
    const bool k0 = !ZERO || kept(keep, j, 0);
    const bool k1 = !ZERO || kept(keep, j, 1);
#pragma unroll
    for (int d = 0; d < DW / 8; ++d) {
      uint32_t bh[2], bl[2];
      split_t(k0 ? v0[8 * d] : 0.f, bh[0], bl[0]);
      split_t(k1 ? v0[LD + 8 * d] : 0.f, bh[1], bl[1]);
      mma3(acc[d], ah, al, bh, bl);
    }
  }
}

// Add the partial sums of n_splits slots, `stride` floats apart, in slot
// order into dst: n floats (a multiple of 4, 16-byte aligned) by threads
// [0, NTH), a float4 each, four slots' loads in flight at a time.
template <int NTH>
__device__ __forceinline__ void merge_splits(float* dst, const float* src, int64_t stride, int n_splits, int n) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(dst);
  const int64_t st4 = stride / 4;
  for (int e = threadIdx.x; e < n / 4; e += NTH) {
    float4 x = __ldcg(s4 + e);
#pragma unroll 4
    for (int i = 1; i < n_splits; ++i) {
      const float4 y = __ldcg(s4 + i * st4 + e);
      x.x += y.x;
      x.y += y.y;
      x.z += y.z;
      x.w += y.w;
    }
    d4[e] = x;
  }
}

// The CG warps of row group rg add their partial tiles s[0..NTILE): each
// writes its tiles to its slot of xb, the group meets at its named barrier
// (1 + rg), each adds the CG slots in column-group order, and a second
// barrier frees xb for the next step. Every thread of the block calls it
// with the same NTILE; it is a no-op at CG 1.
template <int RG, int CG, int NT, int NTILE>
__device__ __forceinline__ void group_sum(float s[NTILE][NT][4], float* xb, int rg, int cg, int lane) {
  if constexpr (CG > 1) {
    constexpr int SLOT = NTILE * NT * 4 * 32;
    float* base = xb + rg * CG * SLOT;
#pragma unroll
    for (int u = 0; u < NTILE; ++u)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) base[cg * SLOT + ((u * NT + j) * 4 + i) * 32 + lane] = s[u][j][i];
    group_barrier(1 + rg, 32 * CG);
#pragma unroll
    for (int u = 0; u < NTILE; ++u)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int at = ((u * NT + j) * 4 + i) * 32 + lane;
          float x = base[at];
#pragma unroll
          for (int c = 1; c < CG; ++c) x += base[c * SLOT + at];
          s[u][j][i] = x;
        }
    group_barrier(1 + rg, 32 * CG);
  }
}

// Stage COLS consecutive floats of a vector by 4-byte cp.async, threads
// [first, first + COLS) one each; entries at or past n are zero-filled.
template <int COLS>
__device__ __forceinline__ void stage_vec_k(float* dst, const float* src, int n, int first) {
  const int i = threadIdx.x - first;
  if (i < 0 || i >= COLS) return;
  const bool in = i < n;
  cp4(dst + i, src + (in ? i : 0), in);
}

// Zeros in the thread's columns of a DW-column row at dst (store_row's
// columns of a masked row).
template <int DW>
__device__ __forceinline__ void zero_row(float* dst, int t) {
#pragma unroll
  for (int d = 0; d < DW / 8; ++d) *reinterpret_cast<float2*>(dst + 8 * d + 2 * t) = make_float2(0.f, 0.f);
}

// f(r, Σ_d a[r]·b[r]) for rows [0, R) of two [*, DH] slabs in global
// memory (rows sa and sb floats apart, 16-byte aligned), called by one
// thread a row: DH / 8 threads a row take 8 columns each as two float4
// loads of each slab, the block takes NTH·8 / DH rows at a time, U of them
// a thread with all their loads in flight, and the sums fold over the row's
// threads in a fixed order. Every thread of the block calls it.
template <int DH, int NTH, typename F>
__device__ __forceinline__ void rows_dot(const float* a, int64_t sa, const float* b, int64_t sb, int R, F f) {
  constexpr int TPR = DH / 8, PER = NTH / TPR, U = 4;
  const int p = threadIdx.x % TPR, r0 = threadIdx.x / TPR;
  for (int base = 0; base < R; base += PER * U) {  // the same trip count in every thread
    float4 av[U][2], bv[U][2];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = base + u * PER + r0;
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4* a4 = reinterpret_cast<const float4*>(a + r * sa) + 2 * p;
      const float4* b4 = reinterpret_cast<const float4*>(b + r * sb) + 2 * p;
      av[u][0] = r < R ? __ldg(a4) : z;
      av[u][1] = r < R ? __ldg(a4 + 1) : z;
      bv[u][0] = r < R ? __ldg(b4) : z;
      bv[u][1] = r < R ? __ldg(b4 + 1) : z;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float x = 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        x += av[u][i].x * bv[u][i].x + av[u][i].y * bv[u][i].y + av[u][i].z * bv[u][i].z + av[u][i].w * bv[u][i].w;
#pragma unroll
      for (int o = 1; o < TPR; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
      const int r = base + u * PER + r0;
      if (p == 0 && r < R) f(r, x);
    }
  }
}

}  // namespace
