// K1b: the backward of K1's pass inside K3, the differentiable flash-Nystrom
// attention, for sm_90a.
//
// Replaces, for the terms of K1's pass, the recompute-and-differentiate
// backward `_flash_bwd` of the custom VJP `flash_nystrom`
// (mhim_mil_tpu/ops/pallas_nystrom.py:249-304), which materialises
// [B, H, m, N]. K1 computes, per (bag, head), P = softmax_N(q_l·kᵀ) over the
// valid keys, attn3v = P·v and the row max m3 and sum s3. Given the
// cotangents d_attn3v and d_s3 (m3 is a constant: the composition does not
// change when m3 and s3 shift together), this is FlashAttention-2's backward
// with the m landmark rows as its queries:
//   D_j = Σ_d d_attn3v[j]·attn3v[j] − s3_j·d_s3_j   (s3's cotangent folded in)
//   P[j, n] = exp(q_l[j]·k_n − m3_j) / s3_j,  dP = d_attn3v·vᵀ,  dS = P ∘ (dP − D)
//   d_ql = dS·k,  d_k = dSᵀ·q_l,  d_v = Pᵀ·d_attn3v
// Gradients at masked keys are zero; values at masked keys (NaN included)
// are never used.
//
// Three kernels:
//   stats:    a warp per landmark row: D and 1 / s3, to scratch [2, B·H, M].
//   key:      a block owns 64 keys (4 warps × 16; 32 at DH 256) of one
//             (bag, head) and walks the (q_l, d_attn3v, m3, 1/s3, D) chunks
//             of every landmark row through a cp.async ring, accumulating
//             d_k and d_v in registers; no atomics.
//   landmark: a block owns 64 landmark rows (32 at DH 256) of one (bag,
//             head) and a contiguous split of the keys (the wrapper's plan,
//             as K2b's landmark kernel splits its tokens) and accumulates
//             d_ql; each split writes its partial sums, and the last block of
//             a landmark tile to finish (an int32 ticket, no float atomics)
//             adds them in split order, so two runs give the same bits.
//
// Bound at the student's shape (B 4, H 8, N 1,027, dh 64, m 256; H100 SXM
// data sheet, 495 TFLOP/s TF32 on the tensor cores at 3×TF32): the
// function's products are S, dP, d_ql, d_k and d_v over the valid keys,
// 5·nv·m·dh FMAs a (bag, head); this design computes S and dP in both the
// key and the landmark kernel, 7 products. Operations bound it; its bytes
// (k, v read once, d_k, d_v written) take a third of that time.
//
// Precision, layouts and the two column halves at DH 256 are
// flash_nystrom.cuh's. Plain C interface, loaded with ctypes; the entry
// returns cudaGetLastError() after its launches.

#include "flash_nystrom.cuh"

namespace {

constexpr int STAGES = 2, STATS_WARPS = 8;

// Stage COLS consecutive entries of each of three vectors by 4-byte
// cp.async: dst holds a | b | c; entries at or past n are zero-filled.
template <int NTH>
__device__ __forceinline__ void stage_vecs(float* dst, const float* a, const float* b, const float* c,
                                           int n) {
  for (int i = threadIdx.x; i < 3 * COLS; i += NTH) {
    const int which = i / COLS, j = i % COLS;
    const float* src = which == 0 ? a : which == 1 ? b : c;
    const bool in = j < n;
    cp4(dst + i, src + (in ? j : 0), in);
  }
}

// One warp per landmark row: D = Σ d_attn3v·attn3v − s3·d_s3 (d_s3 may be
// null: zero) and 1 / max(s3, 1e-30).
__global__ void __launch_bounds__(32 * STATS_WARPS)
stats_kernel(const float* __restrict__ attn3v, const float* __restrict__ d_attn3v,
             const float* __restrict__ s3, const float* __restrict__ d_s3, float* __restrict__ dd,
             float* __restrict__ inv, int64_t rows, int DH) {
  const int64_t row = (int64_t)blockIdx.x * STATS_WARPS + threadIdx.x / 32;
  if (row >= rows) return;  // warp-uniform
  const int lane = threadIdx.x % 32;
  float x = 0.f;
  for (int d = lane; d < DH; d += 32) x += attn3v[row * DH + d] * d_attn3v[row * DH + d];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  if (lane == 0) {
    const float s = s3[row];
    dd[row] = d_s3 != nullptr ? x - s * d_s3[row] : x;
    inv[row] = 1.f / fmaxf(s, 1e-30f);
  }
}

template <int DH>
constexpr size_t key_smem() {
  // k rows, v rows, and a ring of (q_l, d_attn3v, m3 | 1/s3 | D) chunks
  constexpr size_t tile = (size_t)COLS * (DH + 4);
  return (2 * 16 * bwd_warps(DH) * (DH + 4) + STAGES * (2 * tile + 3 * COLS)) * sizeof(float);
}

template <int DH>
constexpr size_t landmark_smem() {
  // q_l rows, d_attn3v rows, and a ring of (k, v) tiles
  constexpr size_t tile = (size_t)COLS * (DH + 4);
  return (2 * 16 * bwd_warps(DH) * (DH + 4) + STAGES * 2 * tile) * sizeof(float);
}

// grid (ceil(N / rows), B·H, halves), rows = 16·bwd_warps; value half z
// keeps d_k's and d_v's columns [z·128, z·128 + 128).
template <int DH>
__global__ void __launch_bounds__(32 * bwd_warps(DH), bwd_resident(DH))
key_kernel(const float* __restrict__ ql,  // [B*H, M, DH]
           const float* __restrict__ k, int64_t k_sb, int64_t k_sh, int64_t k_sn,
           const float* __restrict__ v, int64_t v_sb, int64_t v_sh, int64_t v_sn,
           const uint8_t* __restrict__ mask,      // [B, N]
           const float* __restrict__ m3,          // [B*H, M]
           const float* __restrict__ d_attn3v,    // [B*H, M, DH]
           const float* __restrict__ dd,          // [B*H, M]
           const float* __restrict__ inv,         // [B*H, M]
           float* __restrict__ d_k,               // [B*H, N, DH]
           float* __restrict__ d_v,               // [B*H, N, DH]
           int H, int N, int M) {
  constexpr int LD = DH + 4, TILE = COLS * LD, DV = acc_cols(DH), STEP = 2 * TILE + 3 * COLS;
  constexpr int ROWS = 16 * bwd_warps(DH), NTH = 32 * bwd_warps(DH);
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + ROWS * LD;
  float* ring = sV + ROWS * LD;

  // the value half: a compile-time 0 below DH 256, so those bodies index no half
  const int t0 = blockIdx.x * ROWS, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int vh = halves(DH) > 1 ? (int)blockIdx.z : 0;
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int64_t lm0 = (int64_t)bh * M;
  const int nchunks = (M + COLS - 1) / COLS;
  const float* kw = sK + 16 * warp * LD;
  const float* vw = sV + 16 * warp * LD;
  int key[2];
  bool valid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    key[r] = t0 + 16 * warp + g + 8 * r;
    valid[r] = key[r] < N && mask[(int64_t)b * N + key[r]] != 0;
  }

  auto stage = [&](int c) {
    const int c0 = c * COLS;
    float* dst = ring + (c % STAGES) * STEP;
    stage_rows<DH, COLS, NTH>(dst, ql + (lm0 + c0) * DH, DH, M - c0);
    stage_rows<DH, COLS, NTH>(dst + TILE, d_attn3v + (lm0 + c0) * DH, DH, M - c0);
    stage_vecs<NTH>(dst + 2 * TILE, m3 + lm0 + c0, inv + lm0 + c0, dd + lm0 + c0, M - c0);
  };
  stage_rows<DH, ROWS, NTH>(sK, k + b * k_sb + h * k_sh + t0 * k_sn, k_sn, N - t0);
  stage_rows<DH, ROWS, NTH>(sV, v + b * v_sb + h * v_sh + t0 * v_sn, v_sn, N - t0);
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < nchunks) stage(i);
    cp_commit();
  }
  float acc_k[DV / 8][4], acc_v[DV / 8][4];
  zero<DV>(acc_k);
  zero<DV>(acc_v);
  for (int c = 0; c < nchunks; ++c) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    if (c + STAGES - 1 < nchunks) stage(c + STAGES - 1);
    cp_commit();
    const float* st = ring + (c % STAGES) * STEP;
    const float* sv = st + 2 * TILE;  // m3 | 1/s3 | D of the chunk's landmarks
    float s[NT][4], dp[NT][4];
    scores<DH>(kw, st, g, t, s);          // Sᵀ = k·q_lᵀ
    scores<DH>(vw, st + TILE, g, t, dp);  // dPᵀ = v·d_attn3vᵀ
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t + e;
        const bool ok = c * COLS + col < M;
        const float mm = sv[col], iv = sv[COLS + col], d = sv[2 * COLS + col];
        const float p0 = ok ? __expf(s[j][e] - mm) * iv : 0.f;
        const float p1 = ok ? __expf(s[j][2 + e] - mm) * iv : 0.f;
        s[j][e] = ok ? p0 * (dp[j][e] - d) : 0.f;
        s[j][2 + e] = ok ? p1 * (dp[j][2 + e] - d) : 0.f;
        dp[j][e] = p0;
        dp[j][2 + e] = p1;
      }
    accumulate<DV, false, LD>(s, st + vh * DV, 0u, g, t, acc_k);          // d_k += dSᵀ · q_l
    accumulate<DV, false, LD>(dp, st + TILE + vh * DV, 0u, g, t, acc_v);  // d_v += Pᵀ · d_attn3v
  }
  cp_wait<0>();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= N) continue;
    const int64_t o = ((int64_t)bh * N + key[r]) * DH + vh * DV;
    store_row<DV>(d_k + o, acc_k, r, t, valid[r]);
    store_row<DV>(d_v + o, acc_v, r, t, valid[r]);
  }
}

// grid (ceil(M / rows)·halves, n_splits, B·H), rows = 16·bwd_warps; block x
// takes landmark tile x / halves and value half x % halves. Split s covers
// keys [s·per_split, min(N, (s + 1)·per_split)). Writes the partial d_ql of
// its rows and columns at slot (bh·n_splits + s)·M + row of `part`; with
// more than one split, the last block of each (landmark tile, half) to
// finish adds the splits of its columns into d_ql and resets its ticket.
template <int DH>
__global__ void __launch_bounds__(32 * bwd_warps(DH), bwd_resident(DH))
landmark_kernel(const float* __restrict__ ql,
                const float* __restrict__ k, int64_t k_sb, int64_t k_sh, int64_t k_sn,
                const float* __restrict__ v, int64_t v_sb, int64_t v_sh, int64_t v_sn,
                const uint8_t* __restrict__ mask, const float* __restrict__ m3,
                const float* __restrict__ d_attn3v, const float* __restrict__ dd,
                const float* __restrict__ inv, float* __restrict__ part, float* __restrict__ d_ql,
                int* __restrict__ tickets,  // [B*H, ceil(M / rows)·halves], zero between launches
                int H, int N, int M, int per_split) {
  constexpr int LD = DH + 4, TILE = COLS * LD, DV = acc_cols(DH);
  constexpr int ROWS = 16 * bwd_warps(DH), NTH = 32 * bwd_warps(DH);
  extern __shared__ float4 smem4[];
  float* sQl = reinterpret_cast<float*>(smem4);
  float* sDa = sQl + ROWS * LD;  // d_attn3v rows
  float* ring = sDa + ROWS * LD;

  constexpr int HALVES = halves(DH);
  const int row0 = blockIdx.x / HALVES * ROWS, vh = blockIdx.x % HALVES;
  const int split_id = blockIdx.y, bh = blockIdx.z, b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const uint8_t* mb = mask + (int64_t)b * N;
  const int64_t lm0 = (int64_t)bh * M;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;
  const int s0 = split_id * per_split, s1 = min(N, s0 + per_split);
  const int ntiles = s1 > s0 ? (s1 - s0 + COLS - 1) / COLS : 0;
  const bool active = row0 + 16 * warp < M;  // warp-uniform
  const float* aw = sQl + 16 * warp * LD;
  const float* bw = sDa + 16 * warp * LD;
  int row[2];
  float m3v[2], ivv[2], ddv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row[r] = row0 + 16 * warp + g + 8 * r;
    const bool in = row[r] < M;
    m3v[r] = in ? m3[lm0 + row[r]] : 0.f;
    ivv[r] = in ? inv[lm0 + row[r]] : 0.f;
    ddv[r] = in ? dd[lm0 + row[r]] : 0.f;
  }

  auto stage = [&](int i) {
    const int n0 = s0 + i * COLS;
    float* dst = ring + (i % STAGES) * 2 * TILE;
    stage_rows<DH, COLS, NTH>(dst, kb + n0 * k_sn, k_sn, s1 - n0);
    stage_rows<DH, COLS, NTH>(dst + TILE, vb + n0 * v_sn, v_sn, s1 - n0);
  };
  stage_rows<DH, ROWS, NTH>(sQl, ql + (lm0 + row0) * DH, DH, M - row0);
  stage_rows<DH, ROWS, NTH>(sDa, d_attn3v + (lm0 + row0) * DH, DH, M - row0);
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < ntiles) stage(i);
    cp_commit();
  }
  float acc[DV / 8][4];
  zero<DV>(acc);
  for (int it = 0; it < ntiles; ++it) {
    const uint32_t keep = valid_bits(mb, s0 + it * COLS, s1, t);
    cp_wait<STAGES - 2>();
    __syncthreads();
    if (it + STAGES - 1 < ntiles) stage(it + STAGES - 1);
    cp_commit();
    if (!active) continue;
    const float* st = ring + (it % STAGES) * 2 * TILE;
    float s[NT][4], dp[NT][4];
    scores<DH>(aw, st, g, t, s);          // S = q_l·kᵀ
    scores<DH>(bw, st + TILE, g, t, dp);  // dP = d_attn3v·vᵀ
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = kept(keep, j, e);
        const float p0 = ok ? __expf(s[j][e] - m3v[0]) * ivv[0] : 0.f;
        const float p1 = ok ? __expf(s[j][2 + e] - m3v[1]) * ivv[1] : 0.f;
        s[j][e] = ok ? p0 * (dp[j][e] - ddv[0]) : 0.f;
        s[j][2 + e] = ok ? p1 * (dp[j][2 + e] - ddv[1]) : 0.f;
      }
    accumulate<DV, true, LD>(s, st + vh * DV, keep, g, t, acc);  // d_ql += dS · k
  }
  cp_wait<0>();
  float* slot_base = part + ((int64_t)bh * gridDim.y + split_id) * M * DH;
  if (active) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row[r] < M) store_row<DV>(slot_base + (int64_t)row[r] * DH + vh * DV, acc, r, t, true);
  }

  if (gridDim.y == 1) return;  // part is d_ql
  // The last split of this (landmark tile, half) to finish adds the partials in split order.
  if (!arrived_last(tickets + (int64_t)bh * gridDim.x + blockIdx.x, gridDim.y)) return;
  const int rows = min(ROWS, M - row0);
  const float* p0 = part + ((int64_t)bh * gridDim.y * M + row0) * DH + vh * DV;
  float* o = d_ql + (lm0 + row0) * DH + vh * DV;
  for (int e = threadIdx.x; e < rows * DV; e += NTH) {
    const int64_t at = (int64_t)(e / DV) * DH + e % DV;
    float x = 0.f;
    for (int i = 0; i < (int)gridDim.y; ++i) x += __ldcg(p0 + (int64_t)i * M * DH + at);
    o[at] = x;
  }
}

template <int DH>
int launch(const float* ql, const float* k, int64_t k_sb, int64_t k_sh, int64_t k_sn, const float* v,
           int64_t v_sb, int64_t v_sh, int64_t v_sn, const uint8_t* mask, const float* attn3v,
           const float* m3, const float* s3, const float* d_attn3v, const float* d_s3, float* d_ql,
           float* d_k, float* d_v, float* stats, float* part, int* tickets, int B, int H, int N, int M,
           int n_splits, int per_split, cudaStream_t st) {
  constexpr size_t smem_k = key_smem<DH>(), smem_l = landmark_smem<DH>();
  constexpr int ROWS = 16 * bwd_warps(DH), NTH = 32 * bwd_warps(DH);
  cudaError_t err = cudaFuncSetAttribute(key_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_k);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(landmark_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_l);
  if (err != cudaSuccess) return (int)err;
  const int64_t rows = (int64_t)B * H * M;
  float* dd = stats;
  float* inv = stats + rows;
  stats_kernel<<<(unsigned)((rows + STATS_WARPS - 1) / STATS_WARPS), 32 * STATS_WARPS, 0, st>>>(
      attn3v, d_attn3v, s3, d_s3, dd, inv, rows, DH);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  key_kernel<DH><<<dim3((N + ROWS - 1) / ROWS, B * H, halves(DH)), NTH, smem_k, st>>>(
      ql, k, k_sb, k_sh, k_sn, v, v_sb, v_sh, v_sn, mask, m3, d_attn3v, dd, inv, d_k, d_v, H, N, M);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  landmark_kernel<DH><<<dim3((M + ROWS - 1) / ROWS * halves(DH), n_splits, B * H), NTH, smem_l, st>>>(
      ql, k, k_sb, k_sh, k_sn, v, v_sb, v_sh, v_sn, mask, m3, d_attn3v, dd, inv, part, d_ql, tickets, H,
      N, M, per_split);
  return (int)cudaGetLastError();
}

}  // namespace

// Landmark rows of a landmark-kernel block and the blocks an SM holds, by
// head dim dh (0 where dh is not instantiated), and the keys of its tiles
// (a split's length is a multiple): the wrapper's plan mirrors all three.
extern "C" int flash_nystrom_k1b_rows(int dh) { return instantiated(dh) ? 16 * bwd_warps(dh) : 0; }
extern "C" int flash_nystrom_k1b_keys() { return COLS; }
extern "C" int flash_nystrom_k1b_resident(int dh) { return instantiated(dh) ? bwd_resident(dh) : 0; }

#define K1B_ARGS                                                                                  \
  ql, k, k_sb, k_sh, k_sn, v, v_sb, v_sh, v_sn, mask, attn3v, m3, s3, d_attn3v, d_s3, d_ql, d_k, d_v, \
      stats, part, tickets, B, H, N, M, n_splits, per_split, st

// k and v [B, H, N, DH] views whose rows start on 16 bytes; ql, attn3v,
// d_attn3v [B*H, M, DH], m3, s3 and d_s3 [B*H, M] contiguous (d_s3 null:
// zero). Outputs d_ql [B*H, M, DH], d_k and d_v [B*H, N, DH]; scratch stats
// [2, B*H, M], part [B*H, n_splits, M, DH] (d_ql itself when n_splits is 1)
// and tickets [B*H, ceil(M / rows)·halves] int32, zero at the first launch
// and left zero by each.
extern "C" int flash_nystrom_pass_a_bwd(
    const float* ql, const float* k, int64_t k_sb, int64_t k_sh, int64_t k_sn, const float* v,
    int64_t v_sb, int64_t v_sh, int64_t v_sn, const uint8_t* mask, const float* attn3v,
    const float* m3, const float* s3, const float* d_attn3v, const float* d_s3, float* d_ql,
    float* d_k, float* d_v, float* stats, float* part, int* tickets, int B, int H, int N, int M,
    int DH, int n_splits, int per_split, void* stream) {
  if (per_split <= 0 || per_split % COLS != 0 || n_splits <= 0 ||
      (int64_t)n_splits * per_split < N || (int64_t)(n_splits - 1) * per_split >= N ||
      (n_splits == 1) != (part == d_ql))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (DH) {
    case 256: return launch<256>(K1B_ARGS);
    case 128: return launch<128>(K1B_ARGS);
    case 64: return launch<64>(K1B_ARGS);
    case 32: return launch<32>(K1B_ARGS);
    case 16: return launch<16>(K1B_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
}
