// K3p: the products of the Newton–Schulz pseudo-inverse inside K3, the
// differentiable flash-Nystrom attention, for sm_90a.
//
// Replaces the XLA pseudo-inverse that the forward of the Pallas custom VJP
// `flash_nystrom` (mhim_mil_tpu/ops/pallas_nystrom.py:249) runs between its
// two kernels, `moore_penrose_pinv` (mhim_mil_tpu/ops/nystrom.py:33-56), and
// its backward's autograd. One launch is one batched fp32 product
//   D = α·op(A)·(op(B) + d·I) + β·C    over G = B·H matrices of m × m,
// op transposing its operand or not (never both), so an iteration
//   xz = x·z,  u = xz·(7I − xz),  w = xz·(15I − u),  z' = 0.25·z·(13I − w)
// is four launches, c·I − M taken as −(M − c·I) (α negated, d = −c), and
// its reverse sweep eight, with the transposes and β = 1 accumulation
// (mhim_mil_torch/ops/nystrom_pinv.py). C may be D itself; A and B are
// never D.
//
// What bounds it on this card: operations. A product is 2·m³ FLOPs a
// matrix against 3·4·m² bytes; at m 256 that is 43 FLOPs a byte, and at
// 3×TF32 on the tensor cores (three TF32 products each) the card's 495
// TFLOP/s give 6.5 µs for the 32 matrices of the student's batch, where
// the bytes take 2.5 µs. What the design does about it: the products run
// on mma.sync.m16n8k8 in 3×TF32 (flash_nystrom.cuh's `mma3`; each operand
// split into hi and lo once, as its fragment is read, by flash_nystrom.cuh's
// `split`, hi rounded to nearest: the backward kernels' truncating split
// triples a term's error bound, and K3's output magnifies the pinv's
// error), so fp32's accuracy holds where a single TF32 product would not;
// operand tiles arrive through a three-stage cp.async ring, C's tile through
// the slot the ring frees for the step past the last, in flight with the
// last products; the fragments of an operand read along K come by
// ldmatrix; d·I is added to B's fragments on the diagonal 8 × 8 tiles as
// they are read, so no pass over a matrix forms c·I − M; α and β·C are
// applied in the epilogue, so no elementwise pass remains between the
// products.
//
// Geometry. A block is 4 warps over a BM × BN tile of D (2 × 2 warps, each
// (BM/2) × (BN/2)) and walks K in steps of 32. Tiles 64 × 64 and 32 × 32;
// the wrapper's plan (`pinv_plan`) takes 64 × 64 where its grid has a block
// for three quarters of the SMs. Staged rows: an operand read along K (A, or B
// transposed) in rows of 32 + 4 floats, one read across K (A transposed, or
// B) in rows of its tile width + 8, which keeps the fragment reads free of
// bank conflicts. m is a multiple of 4 (16-byte rows; the wrapper pads
// others with zeros); rows and columns past m are zero-filled, which is
// exact here: a zero column of A meets whatever d adds on B's diagonal.
// Plain C interface, loaded with ctypes; the entry returns
// cudaGetLastError() after its launch.

#include "flash_nystrom_bwd.cuh"  // ldsm_x4, and flash_nystrom.cuh's split, mma3, cp.async

namespace {

constexpr int PK = 32;  // K of a step
constexpr int PINV_STAGES = 3;
constexpr int PINV_THREADS = 128;

template <int BM, int BN, bool TA, bool TB>
struct PinvTile {
  static constexpr int WM = BM / 2, WN = BN / 2;  // a warp's tile
  static constexpr int MT = WM / 16, NT = WN / 8;  // its m16 and n8 mma tiles
  static constexpr int RA = TA ? PK : BM, PA = TA ? BM + 8 : PK + 4;  // staged rows of A and their pitch
  static constexpr int RB = TB ? BN : PK, PB = TB ? PK + 4 : BN + 8;
  static constexpr int PC = BN + 8;  // pitch of C's tile, staged in a free slot of the ring
  static constexpr int STAGE = RA * PA + RB * PB;
  static_assert(BM * PC <= STAGE, "C's tile fits a slot");
  static constexpr size_t SMEM = sizeof(float) * PINV_STAGES * STAGE;
};

// Stage R × C floats of a row-major [m, m] matrix from (r0, c0) into rows of
// P floats by 16-byte cp.async; zero past row or column m.
template <int R, int C, int P>
__device__ __forceinline__ void stage_tile(float* dst, const float* src, int m, int r0, int c0) {
  constexpr int CPR = C / 4;
  static_assert(R * CPR % PINV_THREADS == 0, "whole rounds of 16-byte pieces");
#pragma unroll
  for (int u = 0; u < R * CPR / PINV_THREADS; ++u) {
    const int c = threadIdx.x + u * PINV_THREADS, r = c / CPR, p = c % CPR;
    const bool in = r0 + r < m && c0 + 4 * p < m;
    cp16(dst + r * P + 4 * p, in ? src + (int64_t)(r0 + r) * m + c0 + 4 * p : src, in);
  }
}

// grid (ceil(m / BN), ceil(m / BM), G): a BM × BN tile a block
template <int BM, int BN, bool TA, bool TB>
__global__ void __launch_bounds__(PINV_THREADS, 4)
pinv_product_kernel(const float* __restrict__ A, const float* __restrict__ B, const float* C, float* D, int m,
                    float alpha, float diag, float beta) {
  using T = PinvTile<BM, BN, TA, TB>;
  extern __shared__ __align__(16) float smem[];
  const int64_t off = (int64_t)blockIdx.z * m * m;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  A += off;
  B += off;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wm = (warp / 2) * T::WM, wn = (warp % 2) * T::WN;
  const int steps = (m + PK - 1) / PK;

  // Slot `step` of the ring takes K-step `step`; the slot of step `steps`,
  // the first past the end, takes C's tile for the epilogue, in flight
  // with the last steps' products.
  auto stage = [&](int step) {
    float* a = smem + (step % PINV_STAGES) * T::STAGE;
    float* b = a + T::RA * T::PA;
    const int k0 = step * PK;
    if (step == steps) {
      if (beta != 0.f) stage_tile<BM, BN, T::PC>(a, C + off, m, m0, n0);
      return;
    }
    if constexpr (TA) stage_tile<PK, BM, T::PA>(a, A, m, k0, m0);
    else stage_tile<BM, PK, T::PA>(a, A, m, m0, k0);
    if constexpr (TB) stage_tile<BN, PK, T::PB>(b, B, m, n0, k0);
    else stage_tile<PK, BN, T::PB>(b, B, m, k0, n0);
  };
#pragma unroll
  for (int s = 0; s < PINV_STAGES - 1; ++s) {
    if (s <= steps) stage(s);
    cp_commit();
  }

  float acc[T::MT][T::NT][4];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int step = 0; step < steps; ++step) {
    cp_wait<PINV_STAGES - 2>();
    __syncthreads();  // the step has landed, and the slot read a step ago is free
    if (step + PINV_STAGES - 1 <= steps) stage(step + PINV_STAGES - 1);
    cp_commit();
    const float* a = smem + (step % PINV_STAGES) * T::STAGE;
    const float* b = a + T::RA * T::PA;
    const int k0 = step * PK;
#pragma unroll
    for (int kk = 0; kk < PK; kk += 8) {
      uint32_t ah[T::MT][4], al[T::MT][4], braw[4];
#pragma unroll
      for (int i = 0; i < T::MT; ++i) {
        const int r = wm + 16 * i + g;
        float f[4];
        if constexpr (TA) {  // staged [k][row]
          f[0] = a[(kk + t) * T::PA + r];
          f[1] = a[(kk + t) * T::PA + r + 8];
          f[2] = a[(kk + t + 4) * T::PA + r];
          f[3] = a[(kk + t + 4) * T::PA + r + 8];
        } else {  // staged [row][k]: the 16 × 8 fragment by one ldmatrix.x4
          uint32_t raw[4];
          ldsm_x4(a + (wm + 16 * i + (lane & 7) + 8 * ((lane >> 3) & 1)) * T::PA + kk + 4 * (lane >> 4), raw);
#pragma unroll
          for (int e = 0; e < 4; ++e) f[e] = __uint_as_float(raw[e]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) split(f[e], ah[i][e], al[i][e]);
      }
#pragma unroll
      for (int j = 0; j < T::NT; ++j) {
        const int c = wn + 8 * j + g;
        float f0, f1;
        if constexpr (TB) {  // staged [col][k]: two 8 × 8 tiles by one ldmatrix.x4
          if (j % 2 == 0)
            ldsm_x4(b + (wn + 8 * j + (lane & 7) + 8 * (lane >> 4)) * T::PB + kk + 4 * ((lane >> 3) & 1), braw);
          f0 = __uint_as_float(braw[2 * (j % 2)]);
          f1 = __uint_as_float(braw[2 * (j % 2) + 1]);
        } else {  // staged [k][col]
          f0 = b[(kk + t) * T::PB + c];
          f1 = b[(kk + t + 4) * T::PB + c];
        }
        if (k0 + kk == n0 + wn + 8 * j) {  // a diagonal 8 × 8 tile of B: (k, col) = (t, g) and (t + 4, g)
          f0 += t == g ? diag : 0.f;
          f1 += t + 4 == g ? diag : 0.f;
        }
        uint32_t bh[2], bl[2];
        split(f0, bh[0], bl[0]);
        split(f1, bh[1], bl[1]);
#pragma unroll
        for (int i = 0; i < T::MT; ++i) mma3(acc[i][j], ah[i], al[i], bh, bl);
      }
    }
  }

  cp_wait<0>();
  __syncthreads();  // C's tile has landed
  const float* cs = smem + (steps % PINV_STAGES) * T::STAGE;
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m0 + wm + 16 * i + g + 8 * r, col = n0 + wn + 8 * j + 2 * t;
        if (row >= m || col >= m) continue;
        const int64_t at = off + (int64_t)row * m + col;
        float2 v = make_float2(alpha * acc[i][j][2 * r], alpha * acc[i][j][2 * r + 1]);
        if (beta != 0.f) {  // after the products: an accumulator started at β·C lost accuracy (PERF.md)
          const float2 c = *reinterpret_cast<const float2*>(cs + (row - m0) * T::PC + col - n0);
          v.x += beta * c.x;
          v.y += beta * c.y;
        }
        *reinterpret_cast<float2*>(D + at) = v;
      }
}

template <int BM, int BN, bool TA, bool TB>
int launch(const float* A, const float* B, const float* C, float* D, int G, int m, float alpha, float diag,
           float beta, cudaStream_t st) {
  using T = PinvTile<BM, BN, TA, TB>;
  cudaError_t err = cudaFuncSetAttribute(pinv_product_kernel<BM, BN, TA, TB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((m + BN - 1) / BN, (m + BM - 1) / BM, G);
  pinv_product_kernel<BM, BN, TA, TB><<<grid, PINV_THREADS, T::SMEM, st>>>(A, B, C, D, m, alpha, diag, beta);
  return (int)cudaGetLastError();
}

template <int BM, int BN>
int by_transposes(const float* A, const float* B, const float* C, float* D, int G, int m, int ta, int tb,
                  float alpha, float diag, float beta, cudaStream_t st) {
  if (ta) return launch<BM, BN, true, false>(A, B, C, D, G, m, alpha, diag, beta, st);
  if (tb) return launch<BM, BN, false, true>(A, B, C, D, G, m, alpha, diag, beta, st);
  return launch<BM, BN, false, false>(A, B, C, D, G, m, alpha, diag, beta, st);
}

}  // namespace

// The tiles the kernel is built for, as BM·1000 + BN, into out[0..2).
extern "C" int nystrom_pinv_tiles(int* out) {
  out[0] = 64064;
  out[1] = 32032;
  return 0;
}

// A, B, D [G, m, m] fp32 contiguous, C the same or null (β = 0), m a
// multiple of 4; D = α·op(A)·(op(B) + diag·I) + β·C with op transposing A
// where ta, B where tb (not both); a BM × BN tile of nystrom_pinv_tiles.
extern "C" int nystrom_pinv_product(const float* A, const float* B, const float* C, float* D, int G, int m,
                                    int ta, int tb, float alpha, float diag, float beta, int bm, int bn,
                                    void* stream) {
  if (G < 1 || m < 1 || m % 4 != 0 || (ta && tb) || (beta != 0.f && C == nullptr) || D == A || D == B)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bm == 64 && bn == 64) return by_transposes<64, 64>(A, B, C, D, G, m, ta, tb, alpha, diag, beta, st);
  if (bm == 32 && bn == 32) return by_transposes<32, 32>(A, B, C, D, G, m, ta, tb, alpha, diag, beta, st);
  return (int)cudaErrorInvalidValue;
}

