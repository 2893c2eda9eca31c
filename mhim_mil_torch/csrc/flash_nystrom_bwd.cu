// K2b: the backward of K2's pass inside K3, the differentiable flash-Nystrom
// attention, for sm_90a.
//
// Replaces, for the terms of K2's pass, the recompute-and-differentiate
// backward `_flash_bwd` of the custom VJP `flash_nystrom`
// (mhim_mil_tpu/ops/pallas_nystrom.py:249-304), which materialises
// [B, H, N, m]. Per (bag, head), over valid tokens t and landmarks j, with
// P1 = softmax_j(q·k_lᵀ) over the valid landmarks, out = P1·mid (K2's
// output) and E[j, t] = exp(q_l[j]·k_t − m3[j]):
//   dP1[t, j] = d_out_t·mid_j,  D_t = Σ_j P1·dP1 = d_out_t·out_t,
//   dS1 = P1 ∘ (dP1 − D_t),  d_q = dS1·k_l,  d_kl = dS1ᵀ·q,  d_mid = P1ᵀ·d_out
// and, given d_cls (the cotangent of the cls row),
//   G[j, t] = r'_j·E[j, t]·d_cls_t,  d_k = Gᵀ·q_l,  d_ql = G·k,
//   d_r'_j = Σ_t E[j, t]·d_cls_t
// (the wrapper takes d_m3 = −r'·d_r'). Gradients at masked tokens and, for
// d_kl and d_mid, at empty landmark groups are zero; values at masked
// tokens (NaN included) are never used.
//
// What bounds it on this card. The function's products are s1, dP1, d_q,
// d_kl and d_mid over the valid tokens, 5·nv·m·dh FMAs a (bag, head), 8
// with the cls term; at 3×TF32 on the tensor cores, operations bound it and
// its bytes take a fifth of that. A warp's cycles by phase (clock64 stamps,
// utils/phase_nystrom_bwd.py, PERF.md) go mostly to the products: their
// three mma.sync and their split arithmetic, then the exponentials and the
// ring's waits; a block that keeps a 128-column accumulator would recompute
// every score in each column half at dh 256, at 2 warps an SM.
//
// Two kernels, as a FlashAttention-2 backward splits its work:
//   token:    a block owns 64 tokens (32 above dh 64) of one (bag, head). Its
//             prologue takes D_t = d_out_t·out_t from K2's out (while its
//             rows and first chunk arrive), so one walk
//             over the (k_l, mid) chunks does: s1 and dP1, the online
//             softmax of s1, and d_q += exp(s1 − max)·(dP1 − D)·k_l with the
//             running max's rescaling, divided by the row sum at the end,
//             which gives each token's log-sum-exp too; lse and D go to fp32
//             scratch [B·H, N]. With d_cls it walks the (q_l, r', m3)
//             chunks over its k rows, accumulating d_k. Three products of
//             the function's five (a first walk for the statistics would
//             make it five). A tile of masked tokens writes zeros.
//   landmark: a block owns 64 landmarks (32 above dh 64) of one (bag, head)
//             and a contiguous split of the tokens (pass_b_backward_plan); it
//             recomputes P1ᵀ and dP1ᵀ from the scratch statistics and
//             accumulates d_kl and d_mid, and, with d_cls, walks its tokens
//             again for d_ql and d_r'. Each split writes its partial sums;
//             the last block of a landmark tile to finish (an integer ticket,
//             no float atomics) adds the splits in split order, all loads in
//             flight, so two runs give the same bits.
// Seven products in all. Above dh 64 each block
// splits the head dim across the warps of a row group and adds their
// partial score tiles (flash_nystrom_bwd.cuh): every score is computed once,
// and a block keeps 4 (dh 128) or 8 (dh 256) warps. Each product's operands
// are split into TF32 hi and lo in two instructions (`split_t`).
//
// Layouts, the ring and the geometry are flash_nystrom.cuh's and
// flash_nystrom_bwd.cuh's. Plain C interface, loaded with ctypes; the entry
// returns cudaGetLastError() after its launches.

#include "flash_nystrom_bwd.cuh"

namespace {

// Floats of a landmark row of the partial sums: d_kl, d_mid, and with the
// cls term d_ql and d_r' (padded so that rows stay 16-byte aligned).
__host__ __device__ constexpr int part_width(int dh, bool cls) { return cls ? 3 * dh + 4 : 2 * dh; }

template <int DH>
__host__ __device__ constexpr int token_ring() {
  // a ring of (k_l, mid) chunks or of (q_l, r', m3) chunks
  using G = Bwd<DH>;
  return G::STAGES * 2 * G::TILE > G::STAGES * (G::TILE + 2 * G::COLS) ? G::STAGES * 2 * G::TILE
                                                                        : G::STAGES * (G::TILE + 2 * G::COLS);
}

template <int DH>
constexpr size_t token_smem() {
  // q rows (then k rows), d_out rows, the ring, the partial score tiles and the rows' D
  using G = Bwd<DH>;
  return ((size_t)2 * G::ROWS * G::LD + token_ring<DH>() + G::XB + G::ROWS) * sizeof(float);
}

template <int DH>
__host__ __device__ constexpr int landmark_ring() {
  // a ring of (q, d_out, lse, D) tiles or of (k, d_cls) tiles
  using G = Bwd<DH>;
  return G::STAGES * (2 * G::TILE + 2 * G::COLS);
}

template <int DH>
constexpr size_t landmark_smem() {
  // k_l rows (then q_l rows), mid rows, the ring and the partial score tiles
  using G = Bwd<DH>;
  return ((size_t)2 * G::ROWS * G::LD + landmark_ring<DH>() + G::XB) * sizeof(float);
}

// grid (ceil(N / rows), B·H): a block's warp (rg, cg) takes tokens
// [16·rg, 16·rg + 16) of the block's and head-dim columns [cg·DW, cg·DW + DW).
template <int DH, bool CLS>
__global__ void __launch_bounds__(bwd_threads(DH), bwd_resident(DH))
token_kernel(const float* __restrict__ q, int64_t q_sb, int64_t q_sh, int64_t q_sn,
             const float* __restrict__ k, int64_t k_sb, int64_t k_sh, int64_t k_sn,
             const uint8_t* __restrict__ mask,     // [B, N]
             const float* __restrict__ kl,         // [B*H, M, DH]
             const uint8_t* __restrict__ lm_mask,  // [B, M]
             const float* __restrict__ mid,        // [B*H, M, DH]
             const float* __restrict__ ql,         // [B*H, M, DH]
             const float* __restrict__ rp,         // [B*H, M]
             const float* __restrict__ m3,         // [B*H, M]
             const float* __restrict__ d_out, int64_t d_sb, int64_t d_sh, int64_t d_sn,
             const float* __restrict__ out, int64_t o_sb, int64_t o_sh, int64_t o_sn,
             const float* __restrict__ d_cls,      // [B*H, N], with CLS
             float* __restrict__ d_q,              // [B*H, N, DH]
             float* __restrict__ d_k,              // [B*H, N, DH], with CLS
             float* __restrict__ lse,              // [B*H, N] scratch
             float* __restrict__ dd,               // [B*H, N] scratch: D_t
             int H, int N, int M) {
  using G = Bwd<DH>;
  constexpr int LD = G::LD, COLS = G::COLS, NT = G::NT, DW = G::DW, ROWS = G::ROWS, NTH = G::NTH;
  constexpr int TILE = G::TILE, STAGES = G::STAGES, CG = G::CG, RG = G::RG;
  extern __shared__ float4 smem4[];
  float* sRows = reinterpret_cast<float*>(smem4);  // q rows, then k rows
  float* sDo = sRows + ROWS * LD;                  // d_out rows
  float* ring = sDo + ROWS * LD;
  float* xb = ring + token_ring<DH>();
  float* sD = xb + G::XB;

  const int t0 = blockIdx.x * ROWS, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, rg = warp / CG, cg = warp % CG;
  const int g = lane / 4, t = lane % 4;
  const uint8_t* lb = lm_mask + (int64_t)b * M;
  const int64_t lm0 = (int64_t)bh * M;
  const int nchunks = (M + COLS - 1) / COLS;
  const float* rw = sRows + 16 * rg * LD + cg * DW;
  const float* dw = sDo + 16 * rg * LD + cg * DW;
  int tok[2];
  bool valid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tok[r] = t0 + 16 * rg + g + 8 * r;
    valid[r] = tok[r] < N && mask[(int64_t)b * N + tok[r]] != 0;
  }
  if (!__syncthreads_or(valid[0] || valid[1])) {
    // a tile of masked tokens: zero gradients and statistics, nothing else read
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (tok[r] >= N) continue;
      zero_row<DW>(d_q + ((int64_t)bh * N + tok[r]) * DH + cg * DW, t);
      if (CLS) zero_row<DW>(d_k + ((int64_t)bh * N + tok[r]) * DH + cg * DW, t);
      if (cg == 0 && t == 0) lse[(int64_t)bh * N + tok[r]] = dd[(int64_t)bh * N + tok[r]] = 0.f;
    }
    return;
  }
  PHASES_BEGIN

  auto stage_out = [&](int c) {
    const int c0 = c * COLS;
    float* dst = ring + (c % STAGES) * 2 * TILE;
    stage_rows<DH, COLS, NTH>(dst, kl + (lm0 + c0) * DH, DH, M - c0);
    stage_rows<DH, COLS, NTH>(dst + TILE, mid + (lm0 + c0) * DH, DH, M - c0);
  };
  stage_rows<DH, ROWS, NTH>(sRows, q + b * q_sb + h * q_sh + t0 * q_sn, q_sn, N - t0);
  stage_rows<DH, ROWS, NTH>(sDo, d_out + b * d_sb + h * d_sh + t0 * d_sn, d_sn, N - t0);
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < nchunks) stage_out(i);
    cp_commit();
  }
  PHASE(PH_STAGE);
  // while they arrive: D_t = d_out_t·out_t from global memory, zero at masked tokens
  for (int r = threadIdx.x; r < ROWS; r += NTH)
    if (t0 + r >= N) sD[r] = 0.f;
  rows_dot<DH, NTH>(d_out + b * d_sb + h * d_sh + t0 * d_sn, d_sn, out + b * o_sb + h * o_sh + t0 * o_sn, o_sn,
                    min(ROWS, N - t0),
                    [&](int r, float x) { sD[r] = mask[(int64_t)b * N + t0 + r] ? x : 0.f; });
  __syncthreads();
  float row_d[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) row_d[r] = sD[16 * rg + g + 8 * r];
  PHASE(PH_ELEM);
  // one walk: the online softmax of s1 and acc = Σ_j exp(s1 − max)·(dP1 − D)·k_l
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};
  float acc[DW / 8][4];
  zero<DW>(acc);
  for (int c = 0; c < nchunks; ++c) {
    const uint32_t keep = valid_bits<NT>(lb, c * COLS, M, t);
    cp_wait<STAGES - 2>();
    __syncthreads();
    PHASE(PH_WAIT);
    if (c + STAGES - 1 < nchunks) stage_out(c + STAGES - 1);
    cp_commit();
    PHASE(PH_STAGE);
    const float* st = ring + (c % STAGES) * 2 * TILE;
    float sc[2][NT][4];
    scores_k<DW, NT, LD>(rw, st + cg * DW, g, t, sc[0]);         // s1 = q·k_lᵀ
    scores_k<DW, NT, LD>(dw, st + TILE + cg * DW, g, t, sc[1]);  // dP1 = d_out·midᵀ
    group_sum<RG, CG, NT, 2>(sc, xb, rg, cg, lane);
    PHASE(PH_SCORES);
    float scale[2];
    online_softmax<NT>(sc[0], keep, m_run, l_run, scale);
#pragma unroll
    for (int d = 0; d < DW / 8; ++d) {
      acc[d][0] *= scale[0];
      acc[d][1] *= scale[0];
      acc[d][2] *= scale[1];
      acc[d][3] *= scale[1];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {  // p is 0 at masked landmarks, where dp is finite
        sc[0][j][e] *= sc[1][j][e] - row_d[0];
        sc[0][j][2 + e] *= sc[1][j][2 + e] - row_d[1];
      }
    PHASE(PH_ELEM);
    accumulate_k<DW, NT, LD, false>(sc[0], st + cg * DW, 0u, g, t, acc);  // k_l rows past M are zero-filled
    PHASE(PH_ACC);
  }
  cp_wait<0>();
  __syncthreads();  // the ring and the q rows are free
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float den = fmaxf(quad_sum(l_run[r]), 1e-30f), inv = 1.f / den;
#pragma unroll
    for (int d = 0; d < DW / 8; ++d) {
      acc[d][2 * r] *= inv;
      acc[d][2 * r + 1] *= inv;
    }
    if (cg == 0 && t == 0 && tok[r] < N) {
      lse[(int64_t)bh * N + tok[r]] = valid[r] ? m_run[r] + logf(den) : 0.f;
      dd[(int64_t)bh * N + tok[r]] = valid[r] ? row_d[r] : 0.f;
    }
    if (tok[r] < N) store_row<DW>(d_q + ((int64_t)bh * N + tok[r]) * DH + cg * DW, acc, r, t, valid[r]);
  }
  PHASE(PH_EPI);

  if constexpr (CLS) {
    // G = r'·exp(k·q_lᵀ − m3)·d_cls and d_k += G · q_l, over every landmark (r' = 0 past M)
    auto stage_cls = [&](int c) {
      const int c0 = c * COLS;
      float* dst = ring + (c % STAGES) * (TILE + 2 * COLS);
      stage_rows<DH, COLS, NTH>(dst, ql + (lm0 + c0) * DH, DH, M - c0);
      stage_vec_k<COLS>(dst + TILE, rp + lm0 + c0, M - c0, 0);
      stage_vec_k<COLS>(dst + TILE + COLS, m3 + lm0 + c0, M - c0, COLS);
    };
    stage_rows<DH, ROWS, NTH>(sRows, k + b * k_sb + h * k_sh + t0 * k_sn, k_sn, N - t0);
    float dc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) dc[r] = valid[r] ? d_cls[(int64_t)bh * N + tok[r]] : 0.f;
    for (int i = 0; i < STAGES - 1; ++i) {
      if (i < nchunks) stage_cls(i);
      cp_commit();
    }
    zero<DW>(acc);
    for (int c = 0; c < nchunks; ++c) {
      cp_wait<STAGES - 2>();
      __syncthreads();
      PHASE(PH_WAIT);
      if (c + STAGES - 1 < nchunks) stage_cls(c + STAGES - 1);
      cp_commit();
      PHASE(PH_STAGE);
      const float* st = ring + (c % STAGES) * (TILE + 2 * COLS);
      const float* sR = st + TILE;
      float sc[1][NT][4];
      scores_k<DW, NT, LD>(rw, st + cg * DW, g, t, sc[0]);  // s3ᵀ = k·q_lᵀ
      group_sum<RG, CG, NT, 1>(sc, xb, rg, cg, lane);
      PHASE(PH_SCORES);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * t + e;
          const float r = sR[col], mm = sR[COLS + col];
          sc[0][j][e] = __expf(sc[0][j][e] - mm) * r * dc[0];
          sc[0][j][2 + e] = __expf(sc[0][j][2 + e] - mm) * r * dc[1];
        }
      PHASE(PH_ELEM);
      accumulate_k<DW, NT, LD, false>(sc[0], st + cg * DW, 0u, g, t, acc);
      PHASE(PH_ACC);
    }
    cp_wait<0>();
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (tok[r] < N) store_row<DW>(d_k + ((int64_t)bh * N + tok[r]) * DH + cg * DW, acc, r, t, valid[r]);
    PHASE(PH_EPI);
  }
  PHASES_END(0);
}

// grid (ceil(M / rows), n_splits, B·H): a block's warp (rg, cg) takes
// landmark rows [16·rg, 16·rg + 16) of its tile and head-dim columns
// [cg·DW, cg·DW + DW). Split s covers tokens [s·per_split, min(N, (s + 1)·
// per_split)). Writes the partial sums of its landmark rows at slot
// (bh·n_splits + s)·M + row of `part`; with more than one split, the last
// block of each landmark tile to finish adds the splits into `out` [B*H, M,
// W] and resets its ticket to 0 for the next launch.
template <int DH, bool CLS>
__global__ void __launch_bounds__(bwd_threads(DH), bwd_resident(DH))
landmark_kernel(const float* __restrict__ q, int64_t q_sb, int64_t q_sh, int64_t q_sn,
                const float* __restrict__ k, int64_t k_sb, int64_t k_sh, int64_t k_sn,
                const uint8_t* __restrict__ mask, const float* __restrict__ kl,
                const uint8_t* __restrict__ lm_mask, const float* __restrict__ mid,
                const float* __restrict__ ql, const float* __restrict__ rp,
                const float* __restrict__ m3,
                const float* __restrict__ d_out, int64_t d_sb, int64_t d_sh, int64_t d_sn,
                const float* __restrict__ d_cls, const float* __restrict__ lse,
                const float* __restrict__ dd, float* __restrict__ part, float* __restrict__ out,
                int* __restrict__ tickets,  // [B*H, ceil(M / rows)], zero between launches
                int H, int N, int M, int per_split) {
  using G = Bwd<DH>;
  constexpr int LD = G::LD, COLS = G::COLS, NT = G::NT, DW = G::DW, ROWS = G::ROWS, NTH = G::NTH;
  constexpr int TILE = G::TILE, STAGES = G::STAGES, CG = G::CG, RG = G::RG, W = part_width(DH, CLS);
  extern __shared__ float4 smem4[];
  float* sA = reinterpret_cast<float*>(smem4);  // k_l rows, then q_l rows
  float* sMid = sA + ROWS * LD;
  float* ring = sMid + ROWS * LD;
  float* xb = ring + landmark_ring<DH>();

  const int row0 = blockIdx.x * ROWS, split_id = blockIdx.y, bh = blockIdx.z;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, rg = warp / CG, cg = warp % CG;
  const int g = lane / 4, t = lane % 4;
  const uint8_t* mb = mask + (int64_t)b * N;
  const int64_t lm0 = (int64_t)bh * M;
  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* db = d_out + b * d_sb + h * d_sh;
  const int s0 = split_id * per_split, s1 = min(N, s0 + per_split);
  const int ntiles = s1 > s0 ? (s1 - s0 + COLS - 1) / COLS : 0;
  const bool active = row0 + 16 * rg < M;  // uniform over the row group
  const float* aw = sA + 16 * rg * LD + cg * DW;
  const float* mw = sMid + 16 * rg * LD + cg * DW;
  int row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) row[r] = row0 + 16 * rg + g + 8 * r;
  float* slot_base = part + ((int64_t)bh * gridDim.y + split_id) * M * W;
  PHASES_BEGIN

  auto stage_out = [&](int i) {
    const int n0 = s0 + i * COLS;
    float* dst = ring + (i % STAGES) * (2 * TILE + 2 * COLS);
    stage_rows<DH, COLS, NTH>(dst, qb + n0 * q_sn, q_sn, s1 - n0);
    stage_rows<DH, COLS, NTH>(dst + TILE, db + n0 * d_sn, d_sn, s1 - n0);
    stage_vec_k<COLS>(dst + 2 * TILE, lse + (int64_t)bh * N + n0, s1 - n0, 0);
    stage_vec_k<COLS>(dst + 2 * TILE + COLS, dd + (int64_t)bh * N + n0, s1 - n0, COLS);
  };
  stage_rows<DH, ROWS, NTH>(sA, kl + (lm0 + row0) * DH, DH, M - row0);
  stage_rows<DH, ROWS, NTH>(sMid, mid + (lm0 + row0) * DH, DH, M - row0);
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < ntiles) stage_out(i);
    cp_commit();
  }
  float acc_kl[DW / 8][4], acc_mid[DW / 8][4];
  zero<DW>(acc_kl);
  zero<DW>(acc_mid);
  for (int it = 0; it < ntiles; ++it) {
    const uint32_t keep = valid_bits<NT>(mb, s0 + it * COLS, s1, t);
    cp_wait<STAGES - 2>();
    const bool any = __syncthreads_or(keep != 0);  // a tile of masked tokens adds nothing
    PHASE(PH_WAIT);
    if (it + STAGES - 1 < ntiles) stage_out(it + STAGES - 1);
    cp_commit();
    PHASE(PH_STAGE);
    if (!active || !any) continue;
    const float* st = ring + (it % STAGES) * (2 * TILE + 2 * COLS);
    const float* sL = st + 2 * TILE;
    float sc[2][NT][4];
    scores_k<DW, NT, LD>(aw, st + cg * DW, g, t, sc[0]);         // s1ᵀ = k_l·qᵀ
    scores_k<DW, NT, LD>(mw, st + TILE + cg * DW, g, t, sc[1]);  // dP1ᵀ = mid·d_outᵀ
    group_sum<RG, CG, NT, 2>(sc, xb, rg, cg, lane);
    PHASE(PH_SCORES);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t + e;
        const bool ok = kept(keep, j, e);
        const float l = sL[col], d = sL[COLS + col];
        const float p0 = ok ? __expf(sc[0][j][e] - l) : 0.f, p1 = ok ? __expf(sc[0][j][2 + e] - l) : 0.f;
        sc[0][j][e] = ok ? p0 * (sc[1][j][e] - d) : 0.f;
        sc[0][j][2 + e] = ok ? p1 * (sc[1][j][2 + e] - d) : 0.f;
        sc[1][j][e] = p0;
        sc[1][j][2 + e] = p1;
      }
    PHASE(PH_ELEM);
    accumulate_k<DW, NT, LD, true>(sc[0], st + cg * DW, keep, g, t, acc_kl);          // d_kl += dS1ᵀ · q
    accumulate_k<DW, NT, LD, true>(sc[1], st + TILE + cg * DW, keep, g, t, acc_mid);  // d_mid += P1ᵀ · d_out
    PHASE(PH_ACC);
  }
  cp_wait<0>();
  if (active) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row[r] >= M) continue;
      const bool lv = lm_mask[(int64_t)b * M + row[r]] != 0;
      float* pr = slot_base + (int64_t)row[r] * W + cg * DW;
      store_row<DW>(pr, acc_kl, r, t, lv);
      store_row<DW>(pr + DH, acc_mid, r, t, lv);
    }
  }

  if constexpr (CLS) {
    // the cls term: E = exp(q_l·kᵀ − m3) over the split's valid tokens,
    // d_ql += (r'·E·d_cls) · k and d_r' += Σ E·d_cls
    __syncthreads();  // every warp is done with the k_l rows and the ring
    auto stage_cls = [&](int i) {
      const int n0 = s0 + i * COLS;
      float* dst = ring + (i % STAGES) * (TILE + COLS);
      stage_rows<DH, COLS, NTH>(dst, kb + n0 * k_sn, k_sn, s1 - n0);
      stage_vec_k<COLS>(dst + TILE, d_cls + (int64_t)bh * N + n0, s1 - n0, 0);
    };
    stage_rows<DH, ROWS, NTH>(sA, ql + (lm0 + row0) * DH, DH, M - row0);
    for (int i = 0; i < STAGES - 1; ++i) {
      if (i < ntiles) stage_cls(i);
      cp_commit();
    }
    float rpv[2], m3v[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rpv[r] = row[r] < M ? rp[lm0 + row[r]] : 0.f;
      m3v[r] = row[r] < M ? m3[lm0 + row[r]] : 0.f;
    }
    zero<DW>(acc_kl);
    for (int it = 0; it < ntiles; ++it) {
      const uint32_t keep = valid_bits<NT>(mb, s0 + it * COLS, s1, t);
      cp_wait<STAGES - 2>();
      const bool any = __syncthreads_or(keep != 0);
      PHASE(PH_WAIT);
      if (it + STAGES - 1 < ntiles) stage_cls(it + STAGES - 1);
      cp_commit();
      PHASE(PH_STAGE);
      if (!active || !any) continue;
      const float* st = ring + (it % STAGES) * (TILE + COLS);
      float sc[1][NT][4];
      scores_k<DW, NT, LD>(aw, st + cg * DW, g, t, sc[0]);  // s3 = q_l·kᵀ
      group_sum<RG, CG, NT, 1>(sc, xb, rg, cg, lane);
      PHASE(PH_SCORES);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = kept(keep, j, e);
          const float dc = ok ? st[TILE + 8 * j + 2 * t + e] : 0.f;
          const float e0 = ok ? __expf(sc[0][j][e] - m3v[0]) * dc : 0.f;
          const float e1 = ok ? __expf(sc[0][j][2 + e] - m3v[1]) * dc : 0.f;
          rsum[0] += e0;
          rsum[1] += e1;
          sc[0][j][e] = rpv[0] * e0;
          sc[0][j][2 + e] = rpv[1] * e1;
        }
      PHASE(PH_ELEM);
      accumulate_k<DW, NT, LD, true>(sc[0], st + cg * DW, keep, g, t, acc_kl);  // d_ql += G · k
      PHASE(PH_ACC);
    }
    cp_wait<0>();
    if (active) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float x = quad_sum(rsum[r]);  // the whole quad, before any row test
        if (row[r] >= M) continue;
        float* pr = slot_base + (int64_t)row[r] * W;
        store_row<DW>(pr + 2 * DH + cg * DW, acc_kl, r, t, true);
        if (t == 0 && cg == 0) pr[3 * DH] = x;
      }
    }
  }

  const int ntile = gridDim.x;
  if (gridDim.y > 1 && arrived_last(tickets + (int64_t)bh * ntile + blockIdx.x, gridDim.y)) {
    // the last split of this landmark tile to finish adds the partials in split order
    merge_splits<NTH>(out + (lm0 + row0) * W, part + ((int64_t)bh * gridDim.y * M + row0) * W, (int64_t)M * W,
                      gridDim.y, min(ROWS, M - row0) * W);
  }
  PHASE(PH_EPI);
  PHASES_END(1);
}

template <int DH, bool CLS>
int launch(const float* q, int64_t q_sb, int64_t q_sh, int64_t q_sn, const float* k, int64_t k_sb,
           int64_t k_sh, int64_t k_sn, const uint8_t* mask, const float* kl, const uint8_t* lm_mask,
           const float* mid, const float* ql, const float* rp, const float* m3, const float* d_out,
           int64_t d_sb, int64_t d_sh, int64_t d_sn, const float* out_k2, int64_t o_sb, int64_t o_sh,
           int64_t o_sn, const float* d_cls, float* d_q, float* d_k, float* lse, float* dd, float* part,
           float* out, int* tickets, int B, int H, int N, int M, int n_splits, int per_split,
           cudaStream_t st) {
  constexpr size_t smem_t = token_smem<DH>(), smem_l = landmark_smem<DH>();
  cudaError_t err = cudaFuncSetAttribute(token_kernel<DH, CLS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_t);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(landmark_kernel<DH, CLS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_l);
  if (err != cudaSuccess) return (int)err;
  constexpr int ROWS = bwd_rows(DH), NTH = bwd_threads(DH);
  token_kernel<DH, CLS><<<dim3((N + ROWS - 1) / ROWS, B * H), NTH, smem_t, st>>>(
      q, q_sb, q_sh, q_sn, k, k_sb, k_sh, k_sn, mask, kl, lm_mask, mid, ql, rp, m3, d_out, d_sb, d_sh, d_sn,
      out_k2, o_sb, o_sh, o_sn, d_cls, d_q, d_k, lse, dd, H, N, M);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  landmark_kernel<DH, CLS><<<dim3((M + ROWS - 1) / ROWS, n_splits, B * H), NTH, smem_l, st>>>(
      q, q_sb, q_sh, q_sn, k, k_sb, k_sh, k_sn, mask, kl, lm_mask, mid, ql, rp, m3, d_out, d_sb, d_sh, d_sn,
      d_cls, lse, dd, part, out, tickets, H, N, M, per_split);
  return (int)cudaGetLastError();
}

}  // namespace

PHASES_ENTRY(flash_nystrom_bwd)

#ifdef NYS_PHASES
// The token and the landmark kernel's occupancy_of, 5 ints each.
extern "C" int flash_nystrom_bwd_occupancy(int dh, int cls, int* out) {
  auto both = [&](auto tok, auto lm, int nth, size_t st, size_t sl) {
    const int e = occupancy_of(tok, nth, st, out);
    return e ? e : occupancy_of(lm, nth, sl, out + 5);
  };
#define OCC(D)                                                                                  \
  case D:                                                                                       \
    return cls ? both(token_kernel<D, true>, landmark_kernel<D, true>, bwd_threads(D),          \
                      token_smem<D>(), landmark_smem<D>())                                      \
               : both(token_kernel<D, false>, landmark_kernel<D, false>, bwd_threads(D),        \
                      token_smem<D>(), landmark_smem<D>());
  switch (dh) {
    OCC(16) OCC(32) OCC(64) OCC(128) OCC(256)
    default: return (int)cudaErrorInvalidValue;
  }
#undef OCC
}
#endif

// By head dim dh (0 where dh is not instantiated): the landmark rows of a
// landmark-kernel block, the tokens of its tiles (a split's length is a
// multiple) and the blocks an SM it is built for; and the floats of a row
// of its partial sums.
extern "C" int flash_nystrom_bwd_rows(int dh) { return instantiated(dh) ? bwd_rows(dh) : 0; }
extern "C" int flash_nystrom_bwd_keys(int dh) { return instantiated(dh) ? bwd_cols(dh) : 0; }
extern "C" int flash_nystrom_bwd_resident(int dh) { return instantiated(dh) ? bwd_resident(dh) : 0; }
extern "C" int flash_nystrom_bwd_width(int dh, int cls) { return part_width(dh, cls != 0); }

#define BWD_ARGS                                                                                      \
  q, q_sb, q_sh, q_sn, k, k_sb, k_sh, k_sn, mask, kl, lm_mask, mid, ql, rp, m3, d_out, d_sb, d_sh, d_sn, \
      out_k2, o_sb, o_sh, o_sn, d_cls, d_q, d_k, lse, dd, part, out, tickets, B, H, N, M, n_splits,      \
      per_split, st

// q, k, d_out and out_k2 (K2's output) [B, H, N, DH] views whose rows start
// on 16 bytes; kl, mid, ql [B*H, M, DH], rp, m3 [B*H, M] and d_cls [B*H, N]
// contiguous (d_cls null: no cls term, and d_k untouched). Outputs d_q, d_k
// [B*H, N, DH] and out [B*H, M, W] (d_kl | d_mid | d_ql | d_r', W =
// flash_nystrom_bwd_width); scratch lse, dd [B*H, N], part [B*H, n_splits,
// M, W] (out itself when n_splits is 1) and tickets [B*H, ceil(M / rows)]
// int32, zero at the first launch and left zero by each.
extern "C" int flash_nystrom_pass_b_bwd(
    const float* q, int64_t q_sb, int64_t q_sh, int64_t q_sn, const float* k, int64_t k_sb,
    int64_t k_sh, int64_t k_sn, const uint8_t* mask, const float* kl, const uint8_t* lm_mask,
    const float* mid, const float* ql, const float* rp, const float* m3, const float* d_out,
    int64_t d_sb, int64_t d_sh, int64_t d_sn, const float* out_k2, int64_t o_sb, int64_t o_sh,
    int64_t o_sn, const float* d_cls, float* d_q, float* d_k, float* lse, float* dd, float* part,
    float* out, int* tickets, int B, int H, int N, int M, int DH, int n_splits, int per_split,
    void* stream) {
  if (!instantiated(DH) || per_split <= 0 || per_split % bwd_cols(DH) != 0 || n_splits <= 0 ||
      (int64_t)n_splits * per_split < N || (int64_t)(n_splits - 1) * per_split >= N ||
      (n_splits == 1) != (part == out))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool cls = d_cls != nullptr;
  switch (DH) {
    case 256: return cls ? launch<256, true>(BWD_ARGS) : launch<256, false>(BWD_ARGS);
    case 128: return cls ? launch<128, true>(BWD_ARGS) : launch<128, false>(BWD_ARGS);
    case 64: return cls ? launch<64, true>(BWD_ARGS) : launch<64, false>(BWD_ARGS);
    case 32: return cls ? launch<32, true>(BWD_ARGS) : launch<32, false>(BWD_ARGS);
    default: return cls ? launch<16, true>(BWD_ARGS) : launch<16, false>(BWD_ARGS);
  }
}
