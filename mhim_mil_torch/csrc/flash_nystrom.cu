// Fused masked Nystrom attention, the two streaming passes, for sm_90a.
//
// K1 `pass_a` replaces the Pallas kernel `_pass_a_kernel`
// (mhim_mil_tpu/ops/pallas_nystrom.py:45-82). For each landmark row of
// sim3 = Q_l·Kᵀ it runs an online softmax over the valid keys and accumulates
// attn3@V, then writes attn3v[m, dh] = acc / sum, the final row max m3 and
// the row sum s3.
//
// K2 `pass_b` replaces `_pass_b_kernel` (same file, :85-117). For each token
// row it computes out = softmax_m(Q·K_lᵀ, lm_mask) @ mid, zero at masked
// tokens, and cls[t] = Σ_m r'[m]·exp(q_l[m]·k_t − m3[m]), zero at masked
// tokens.
//
// Bound at the flagship shape (batch 4, 8 heads, N = 10241, m = 256,
// dh = 64, fp32 in and out; H100 SXM data sheet: 67 TFLOP/s fp32 outside
// the tensor cores, 3.35 TB/s):
//   K1: 4·B·H·m·N·dh = 21.5 GFLOP (sim3 and attn3@V), 168 MB (k and v read
//       once) -> operations bound it, at 0.32 ms.
//   K2: 6·B·H·m·N·dh = 32.2 GFLOP (sim1, attn1@mid, sim3 again for the cls
//       row), 252 MB (q and k read, out written) -> operations bound it, at
//       0.48 ms.
// What the design does about it: nothing of size N·m ever reaches device
// memory; each pass reads its N-sized operands once, straight from the
// strided qkv projection (no transposed, padded or masked copies), and the
// ragged tail is masked instead of padded. The products run as plain fp32
// FMAs from shared memory: this first version is simple and exact and does
// not reach the bound. The way to it is bf16 operands on the tensor cores
// (wgmma) with TMA-fed tiles, and a split of K1's N loop across blocks at
// batch 1, where 32 blocks leave most SMs idle.
//
// Design. The TPU grid (B·H, N/tile) runs in order and carries the softmax
// state in scratch across N tiles. GPU blocks run in parallel, so K1 keeps
// that loop inside the block: a block owns 64 landmark rows of one (bag,
// head) and walks over all keys in tiles of 32, with the running max, sum
// and the 64×dh accumulator in registers. K2 is parallel over token tiles:
// a block owns 64 tokens and walks over the landmarks in chunks of 32 with
// the same online softmax (flash attention with keys K_l and values mid),
// then walks over them again for the cls row, which is additive over
// landmarks. 256 threads: 16 row groups of 4 rows by 16 lanes; a row's
// statistics reduce across its 16 lanes with shuffles.
//
// Plain C interface, loaded with ctypes. Each entry returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 64;      // rows of a block: landmarks in K1, tokens in K2
constexpr int COLS = 32;      // columns of a step: keys in K1, landmarks in K2
constexpr int THREADS = 256;  // 16 row groups x 16 lanes
constexpr int PLD = COLS + 1;
constexpr float NEG_INF = -1e30f;

// Copy rows [0, nrows) of a strided [*, DH] slab into shared memory with a
// padded row of DH + 1 floats. Rows past nrows, and rows whose byte in
// `rowmask` is 0 where one is given, read as zero.
template <int DH, int R>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int64_t stride, int nrows,
                                          const uint8_t* rowmask = nullptr) {
  for (int e = threadIdx.x; e < R * DH; e += THREADS) {
    const int r = e / DH, c = e % DH;
    const bool in = r < nrows && (rowmask == nullptr || rowmask[r]);
    dst[r * (DH + 1) + c] = in ? src[(int64_t)r * stride + c] : 0.f;
  }
}

// s[i][j] = A[ty*4 + i] · B[tx + 16*j] over DH, both padded rows in shared memory.
template <int DH>
__device__ __forceinline__ void tile_dot(const float* A, const float* B, int ty,
                                         int tx, float s[4][2]) {
  constexpr int LD = DH + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 8
  for (int d = 0; d < DH; ++d) {
    float a[4], b[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty * 4 + i) * LD + d];
#pragma unroll
    for (int j = 0; j < 2; ++j) b[j] = B[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

__device__ __forceinline__ float group16_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float group16_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One step of the online softmax over a ROWS x COLS tile of scores: masks the
// invalid columns, updates the running max and sum, rescales the accumulator
// and leaves the probabilities in sP for the product with the values.
template <int CPT>
__device__ __forceinline__ void online_softmax_step(
    float s[4][2], const float* sValid, float* sP, int ty, int tx,
    float m_run[4], float s_run[4], float acc[4][CPT]) {
  bool ok[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) ok[j] = sValid[tx + 16 * j] != 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (!ok[j]) s[i][j] = NEG_INF;
      mx = fmaxf(mx, s[i][j]);
    }
    mx = group16_max(mx);
    const float m_new = fmaxf(m_run[i], mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
      sP[(ty * 4 + i) * PLD + tx + 16 * j] = p;
      sum += p;
    }
    sum = group16_sum(sum);
    const float scale = expf(m_run[i] - m_new);
    s_run[i] = s_run[i] * scale + sum;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] *= scale;
    m_run[i] = m_new;
  }
}

// acc[i][c] += Σ_k sP[ty*4 + i][k] · V[k][tx + 16*c]
template <int DH, int CPT>
__device__ __forceinline__ void accumulate_pv(const float* sP, const float* sV,
                                              int ty, int tx, float acc[4][CPT]) {
#pragma unroll 4
  for (int k = 0; k < COLS; ++k) {
    float vv[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) vv[c] = sV[k * (DH + 1) + tx + 16 * c];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = sP[(ty * 4 + i) * PLD + k];
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
pass_a_kernel(const float* __restrict__ ql,  // [B*H, M, DH]
              const float* __restrict__ k, int64_t k_sb, int64_t k_sh, int64_t k_sn,
              const float* __restrict__ v, int64_t v_sb, int64_t v_sh, int64_t v_sn,
              const uint8_t* __restrict__ mask,  // [B, N]
              float* __restrict__ attn3v,        // [B*H, M, DH]
              float* __restrict__ m3,            // [B*H, M]
              float* __restrict__ s3,            // [B*H, M]
              int H, int N, int M) {
  constexpr int CPT = DH / 16;
  __shared__ float sQ[ROWS * (DH + 1)];
  __shared__ float sK[COLS * (DH + 1)];
  __shared__ float sV[COLS * (DH + 1)];
  __shared__ float sP[ROWS * PLD];
  __shared__ float sValid[COLS];

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int row0 = blockIdx.y * ROWS;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;
  const uint8_t* mb = mask + (int64_t)b * N;

  load_rows<DH, ROWS>(sQ, ql + ((int64_t)bh * M + row0) * DH, DH, M - row0);

  float m_run[4], s_run[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = NEG_INF;
    s_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  for (int n0 = 0; n0 < N; n0 += COLS) {
    __syncthreads();  // the previous step's reads of sK/sV/sP are done
    load_rows<DH, COLS>(sK, kb + n0 * k_sn, k_sn, N - n0);
    // values of masked keys are never read: their weight is 0, and a
    // non-finite value there must not turn the sum into NaN
    load_rows<DH, COLS>(sV, vb + n0 * v_sn, v_sn, N - n0, mb + n0);
    if (tid < COLS) sValid[tid] = (n0 + tid < N && mb[n0 + tid]) ? 1.f : 0.f;
    __syncthreads();
    float s[4][2];
    tile_dot<DH>(sQ, sK, ty, tx, s);
    online_softmax_step<CPT>(s, sValid, sP, ty, tx, m_run, s_run, acc);
    __syncthreads();
    accumulate_pv<DH, CPT>(sP, sV, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= M) continue;
    const int64_t o = (int64_t)bh * M + r;
    const float denom = fmaxf(s_run[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CPT; ++c) attn3v[o * DH + tx + 16 * c] = acc[i][c] / denom;
    if (tx == 0) {
      m3[o] = m_run[i];
      s3[o] = s_run[i];
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
pass_b_kernel(const float* __restrict__ q, int64_t q_sb, int64_t q_sh, int64_t q_sn,
              const float* __restrict__ k, int64_t k_sb, int64_t k_sh, int64_t k_sn,
              const uint8_t* __restrict__ mask,     // [B, N]
              const float* __restrict__ kl,         // [B*H, M, DH], zero at empty landmarks
              const uint8_t* __restrict__ lm_mask,  // [B, M]
              const float* __restrict__ mid,        // [B*H, M, DH]
              const float* __restrict__ ql,         // [B*H, M, DH], zero at empty landmarks
              const float* __restrict__ rp,         // [B*H, M]
              const float* __restrict__ m3,         // [B*H, M]
              float* __restrict__ out, int64_t o_sb, int64_t o_sh, int64_t o_sn,
              float* __restrict__ cls,              // [B*H, N]
              int H, int N, int M) {
  constexpr int CPT = DH / 16;
  __shared__ float sA[ROWS * (DH + 1)];  // the block's q rows, then its k rows
  __shared__ float sL[COLS * (DH + 1)];  // landmark keys, then landmark queries
  __shared__ float sM[COLS * (DH + 1)];  // mid rows
  __shared__ float sP[ROWS * PLD];
  __shared__ float sValid[COLS];
  __shared__ float sR[COLS];
  __shared__ float sM3[COLS];

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int t0 = blockIdx.y * ROWS;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const uint8_t* mb = mask + (int64_t)b * N;
  const uint8_t* lb = lm_mask + (int64_t)b * M;
  const int64_t lm0 = (int64_t)bh * M;

  // ---- out = softmax over valid landmarks of q·k_l, times mid ----
  load_rows<DH, ROWS>(sA, q + b * q_sb + h * q_sh + t0 * q_sn, q_sn, N - t0);
  float m_run[4], s_run[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = NEG_INF;
    s_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }
  for (int c0 = 0; c0 < M; c0 += COLS) {
    __syncthreads();
    load_rows<DH, COLS>(sL, kl + (lm0 + c0) * DH, DH, M - c0);
    load_rows<DH, COLS>(sM, mid + (lm0 + c0) * DH, DH, M - c0);
    if (tid < COLS) sValid[tid] = (c0 + tid < M && lb[c0 + tid]) ? 1.f : 0.f;
    __syncthreads();
    float s[4][2];
    tile_dot<DH>(sA, sL, ty, tx, s);
    online_softmax_step<CPT>(s, sValid, sP, ty, tx, m_run, s_run, acc);
    __syncthreads();
    accumulate_pv<DH, CPT>(sP, sM, ty, tx, acc);
  }
  float* ob = out + b * o_sb + h * o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty * 4 + i;
    if (t >= N) continue;
    const bool valid = mb[t] != 0;
    const float denom = fmaxf(s_run[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      ob[t * o_sn + tx + 16 * c] = valid ? acc[i][c] / denom : 0.f;
  }

  // ---- cls[t] = Σ_m r'[m]·exp(q_l[m]·k_t − m3[m]) over all landmarks ----
  __syncthreads();
  load_rows<DH, ROWS>(sA, k + b * k_sb + h * k_sh + t0 * k_sn, k_sn, N - t0);
  float cl[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c0 = 0; c0 < M; c0 += COLS) {
    __syncthreads();
    load_rows<DH, COLS>(sL, ql + (lm0 + c0) * DH, DH, M - c0);
    if (tid < COLS) {
      const bool in = c0 + tid < M;
      sR[tid] = in ? rp[lm0 + c0 + tid] : 0.f;
      sM3[tid] = in ? m3[lm0 + c0 + tid] : 0.f;
    }
    __syncthreads();
    float s[4][2];
    tile_dot<DH>(sA, sL, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        cl[i] += expf(s[i][j] - sM3[tx + 16 * j]) * sR[tx + 16 * j];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x = group16_sum(cl[i]);
    const int t = t0 + ty * 4 + i;
    if (tx == 0 && t < N) cls[(int64_t)bh * N + t] = mb[t] ? x : 0.f;
  }
}

}  // namespace

extern "C" int flash_nystrom_pass_a(
    const float* ql, const float* k, int64_t k_sb, int64_t k_sh, int64_t k_sn,
    const float* v, int64_t v_sb, int64_t v_sh, int64_t v_sn, const uint8_t* mask,
    float* attn3v, float* m3, float* s3, int B, int H, int N, int M, int DH,
    void* stream) {
  const dim3 grid(B * H, (M + ROWS - 1) / ROWS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (DH == 64) {
    pass_a_kernel<64><<<grid, THREADS, 0, st>>>(ql, k, k_sb, k_sh, k_sn, v, v_sb, v_sh,
                                                 v_sn, mask, attn3v, m3, s3, H, N, M);
  } else if (DH == 32) {
    pass_a_kernel<32><<<grid, THREADS, 0, st>>>(ql, k, k_sb, k_sh, k_sn, v, v_sb, v_sh,
                                                 v_sn, mask, attn3v, m3, s3, H, N, M);
  } else if (DH == 16) {
    pass_a_kernel<16><<<grid, THREADS, 0, st>>>(ql, k, k_sb, k_sh, k_sn, v, v_sb, v_sh,
                                                 v_sn, mask, attn3v, m3, s3, H, N, M);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int flash_nystrom_pass_b(
    const float* q, int64_t q_sb, int64_t q_sh, int64_t q_sn, const float* k,
    int64_t k_sb, int64_t k_sh, int64_t k_sn, const uint8_t* mask, const float* kl,
    const uint8_t* lm_mask, const float* mid, const float* ql, const float* rp,
    const float* m3, float* out, int64_t o_sb, int64_t o_sh, int64_t o_sn, float* cls,
    int B, int H, int N, int M, int DH, void* stream) {
  const dim3 grid(B * H, (N + ROWS - 1) / ROWS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (DH == 64) {
    pass_b_kernel<64><<<grid, THREADS, 0, st>>>(q, q_sb, q_sh, q_sn, k, k_sb, k_sh, k_sn,
                                                 mask, kl, lm_mask, mid, ql, rp, m3, out,
                                                 o_sb, o_sh, o_sn, cls, H, N, M);
  } else if (DH == 32) {
    pass_b_kernel<32><<<grid, THREADS, 0, st>>>(q, q_sb, q_sh, q_sn, k, k_sb, k_sh, k_sn,
                                                 mask, kl, lm_mask, mid, ql, rp, m3, out,
                                                 o_sb, o_sh, o_sn, cls, H, N, M);
  } else if (DH == 16) {
    pass_b_kernel<16><<<grid, THREADS, 0, st>>>(q, q_sb, q_sh, q_sn, k, k_sb, k_sh, k_sn,
                                                 mask, kl, lm_mask, mid, ql, rp, m3, out,
                                                 o_sb, o_sh, o_sn, cls, H, N, M);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
