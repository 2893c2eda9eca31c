// K2b: the backward of K2's pass inside K3, the differentiable flash-Nystrom
// attention, for sm_90a.
//
// Replaces, for the terms of K2's pass, the recompute-and-differentiate
// backward `_flash_bwd` of the custom VJP `flash_nystrom`
// (mhim_mil_tpu/ops/pallas_nystrom.py:249-304), which materialises
// [B, H, N, m]. Per (bag, head), over valid tokens t and landmarks j, with
// P1 = softmax_j(q·k_lᵀ) over the valid landmarks and
// E[j, t] = exp(q_l[j]·k_t − m3[j]):
//   dP1[t, j] = d_out_t·mid_j,  D_t = Σ_j P1·dP1,  dS1 = P1 ∘ (dP1 − D_t)
//   d_q = dS1·k_l,  d_kl = dS1ᵀ·q,  d_mid = P1ᵀ·d_out
// and, given d_cls (the cotangent of the cls row),
//   G[j, t] = r'_j·E[j, t]·d_cls_t,  d_k = Gᵀ·q_l,  d_ql = G·k,
//   d_r'_j = Σ_t E[j, t]·d_cls_t
// (the wrapper takes d_m3 = −r'·d_r'). Gradients at masked tokens and, for
// d_kl and d_mid, at empty landmark groups are zero; values at masked
// tokens (NaN included) are never used.
//
// Two kernels, as a FlashAttention-2 backward splits its work:
//   token:    a block owns 64 tokens (4 warps × 16; 32 at DH 256) of one
//             (bag, head) and walks the (k_l, mid) chunks twice through a
//             cp.async ring: first for each token's log-sum-exp and D_t,
//             which it writes to fp32 scratch [B·H, N]; then for dS1,
//             accumulating d_q. With d_cls it walks the (q_l, r', m3)
//             chunks a third time, over its k rows, accumulating d_k.
//   landmark: a block owns 64 landmarks (32 at DH 256) of one (bag, head)
//             and a contiguous split of the tokens (planned by the wrapper,
//             as K1's keys are); it recomputes P1ᵀ from the scratch statistics and
//             accumulates d_kl and d_mid, and, with d_cls, walks its tokens
//             again for d_ql and d_r'. Each split writes its partial sums;
//             the last block of a landmark tile to finish (an integer ticket,
//             no float atomics) adds the splits in split order, so two runs
//             give the same bits.
//
// Bound at the student's shape (B 4, H 8, N 1,027, dh 64, m 256; H100 SXM
// data sheet, 495 TFLOP/s TF32 on the tensor cores at 3×TF32): the
// function's products are s1, dP1, d_q, d_kl and d_mid over the valid
// tokens, 5·nv·m·dh FMAs a (bag, head), 9 with the cls term (s3, d_k, d_ql);
// this design recomputes s1 and dP1 once more in the token kernel and both
// again in the landmark kernel. Operations bound it; bytes (q, k, d_out read
// once, d_q, d_k written) are a fifth of that.
//
// Precision, layouts and the two column halves at DH 256 (each block then
// computes its products over all 256 columns and keeps half of the
// gradients' columns) are flash_nystrom.cuh's. Plain C interface, loaded
// with ctypes; the entry returns cudaGetLastError() after its launches.

#include "flash_nystrom.cuh"

namespace {

constexpr int STAGES = 2;

// Blocks an SM holds, by head dim (their __launch_bounds__): shared memory
// admits one block of either kernel at DH 128 and 256.
constexpr int tok_resident(int dh) { return dh > 64 ? 1 : 3; }

// Floats of a landmark row of the partial sums: d_kl, d_mid, and with the
// cls term d_ql and d_r' (padded so that rows stay 16-byte aligned).
template <int DH, bool CLS>
__host__ __device__ constexpr int part_width() { return CLS ? 3 * DH + 4 : 2 * DH; }

template <int DH>
constexpr size_t token_smem() {
  // q rows (then k rows), d_out rows, and a ring of (k_l, mid) or (q_l, r', m3) chunks
  constexpr size_t tile = (size_t)COLS * (DH + 4);
  constexpr size_t out_ring = STAGES * 2 * tile, cls_ring = STAGES * (tile + 2 * COLS);
  return (2 * 16 * bwd_warps(DH) * (DH + 4) + (out_ring > cls_ring ? out_ring : cls_ring)) * sizeof(float);
}

template <int DH>
constexpr size_t landmark_smem() {
  // k_l rows (then q_l rows), mid rows, and a ring of (q, d_out, lse, D) or (k, d_cls) chunks
  constexpr size_t tile = (size_t)COLS * (DH + 4);
  constexpr size_t out_ring = STAGES * (2 * tile + 2 * COLS), cls_ring = STAGES * (tile + COLS);
  return (2 * 16 * bwd_warps(DH) * (DH + 4) + (out_ring > cls_ring ? out_ring : cls_ring)) * sizeof(float);
}

// grid (ceil(N / rows), B·H, halves), rows = 16·bwd_warps; value half z
// keeps d_q's and d_k's columns [z·128, z·128 + 128); half 0 writes the
// scratch statistics.
template <int DH, bool CLS>
__global__ void __launch_bounds__(32 * bwd_warps(DH), tok_resident(DH))
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
             const float* __restrict__ d_cls,      // [B*H, N], with CLS
             float* __restrict__ d_q,              // [B*H, N, DH]
             float* __restrict__ d_k,              // [B*H, N, DH], with CLS
             float* __restrict__ lse,              // [B*H, N] scratch
             float* __restrict__ dd,               // [B*H, N] scratch: D_t
             int H, int N, int M) {
  constexpr int LD = DH + 4, TILE = COLS * LD, DV = acc_cols(DH);
  constexpr int ROWS = 16 * bwd_warps(DH), NTH = 32 * bwd_warps(DH);
  extern __shared__ float4 smem4[];
  float* sRows = reinterpret_cast<float*>(smem4);  // q rows, then k rows
  float* sDo = sRows + ROWS * LD;                  // d_out rows
  float* ring = sDo + ROWS * LD;

  // the value half: a compile-time 0 below DH 256, so those bodies index no half
  const int t0 = blockIdx.x * ROWS, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int vh = halves(DH) > 1 ? (int)blockIdx.z : 0;
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const uint8_t* lb = lm_mask + (int64_t)b * M;
  const int64_t lm0 = (int64_t)bh * M;
  const int nchunks = (M + COLS - 1) / COLS;
  const float* rw = sRows + 16 * warp * LD;
  const float* dw = sDo + 16 * warp * LD;
  int tok[2];
  bool valid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tok[r] = t0 + 16 * warp + g + 8 * r;
    valid[r] = tok[r] < N && mask[(int64_t)b * N + tok[r]] != 0;
  }

  auto stage_out = [&](int c) {
    const int c0 = c * COLS;
    float* dst = ring + (c % STAGES) * 2 * TILE;
    stage_rows<DH, COLS, NTH>(dst, kl + (lm0 + c0) * DH, DH, M - c0);
    stage_rows<DH, COLS, NTH>(dst + TILE, mid + (lm0 + c0) * DH, DH, M - c0);
  };
  // One walk over the (k_l, mid) chunks: step(s, dp, keep) gets the scores
  // s = q·k_lᵀ and dp = d_out·midᵀ of each chunk.
  auto walk_out = [&](auto step) {
    for (int i = 0; i < STAGES - 1; ++i) {
      if (i < nchunks) stage_out(i);
      cp_commit();
    }
    for (int c = 0; c < nchunks; ++c) {
      const uint32_t keep = valid_bits(lb, c * COLS, M, t);
      cp_wait<STAGES - 2>();
      __syncthreads();
      if (c + STAGES - 1 < nchunks) stage_out(c + STAGES - 1);
      cp_commit();
      const float* st = ring + (c % STAGES) * 2 * TILE;
      float s[NT][4], dp[NT][4];
      scores<DH>(rw, st, g, t, s);
      scores<DH>(dw, st + TILE, g, t, dp);
      step(s, dp, keep, st);
    }
    cp_wait<0>();
    __syncthreads();  // the ring is free
  };

  stage_rows<DH, ROWS, NTH>(sRows, q + b * q_sb + h * q_sh + t0 * q_sn, q_sn, N - t0);
  stage_rows<DH, ROWS, NTH>(sDo, d_out + b * d_sb + h * d_sh + t0 * d_sn, d_sn, N - t0);

  // walk 1: the row max and sum of the online softmax, and D_t = Σ_j p·dp / sum
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f}, d_run[2] = {0.f, 0.f};
  walk_out([&](float s[NT][4], float dp[NT][4], uint32_t keep, const float*) {
    float scale[2];
    online_softmax(s, keep, m_run, l_run, scale);
    d_run[0] *= scale[0];
    d_run[1] *= scale[1];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {  // p is 0 at masked landmarks, where dp is finite
        d_run[0] += s[j][e] * dp[j][e];
        d_run[1] += s[j][2 + e] * dp[j][2 + e];
      }
  });
  float row_lse[2], row_d[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float den = fmaxf(quad_sum(l_run[r]), 1e-30f);
    row_lse[r] = m_run[r] + logf(den);
    row_d[r] = quad_sum(d_run[r]) / den;
    if (t == 0 && vh == 0 && tok[r] < N) {
      lse[(int64_t)bh * N + tok[r]] = valid[r] ? row_lse[r] : 0.f;
      dd[(int64_t)bh * N + tok[r]] = valid[r] ? row_d[r] : 0.f;
    }
  }

  // walk 2: dS1 = P1 ∘ (dP1 − D) and d_q += dS1 · k_l
  float acc[DV / 8][4];
  zero<DV>(acc);
  walk_out([&](float s[NT][4], float dp[NT][4], uint32_t keep, const float* st) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = kept(keep, j, e);
        s[j][e] = ok ? __expf(s[j][e] - row_lse[0]) * (dp[j][e] - row_d[0]) : 0.f;
        s[j][2 + e] = ok ? __expf(s[j][2 + e] - row_lse[1]) * (dp[j][2 + e] - row_d[1]) : 0.f;
      }
    accumulate<DV, false, LD>(s, st + vh * DV, 0u, g, t, acc);  // k_l rows past M are zero-filled
  });
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (tok[r] < N) store_row<DV>(d_q + ((int64_t)bh * N + tok[r]) * DH + vh * DV, acc, r, t, valid[r]);
  if constexpr (CLS) {
    // walk 3: G = r'·exp(k·q_lᵀ − m3)·d_cls and d_k += G · q_l, over every landmark (r' = 0 past M)
    auto stage_cls = [&](int c) {
      const int c0 = c * COLS;
      float* dst = ring + (c % STAGES) * (TILE + 2 * COLS);
      stage_rows<DH, COLS, NTH>(dst, ql + (lm0 + c0) * DH, DH, M - c0);
      stage_vec(dst + TILE, rp + lm0 + c0, M - c0, 0);
      stage_vec(dst + TILE + COLS, m3 + lm0 + c0, M - c0, COLS);
    };
    stage_rows<DH, ROWS, NTH>(sRows, k + b * k_sb + h * k_sh + t0 * k_sn, k_sn, N - t0);
    float dc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) dc[r] = valid[r] ? d_cls[(int64_t)bh * N + tok[r]] : 0.f;
    for (int i = 0; i < STAGES - 1; ++i) {
      if (i < nchunks) stage_cls(i);
      cp_commit();
    }
    zero<DV>(acc);
    for (int c = 0; c < nchunks; ++c) {
      cp_wait<STAGES - 2>();
      __syncthreads();
      if (c + STAGES - 1 < nchunks) stage_cls(c + STAGES - 1);
      cp_commit();
      const float* st = ring + (c % STAGES) * (TILE + 2 * COLS);
      const float* sR = st + TILE;
      float s[NT][4];
      scores<DH>(rw, st, g, t, s);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * t + e;
          const float r = sR[col], mm = sR[COLS + col];
          s[j][e] = __expf(s[j][e] - mm) * r * dc[0];
          s[j][2 + e] = __expf(s[j][2 + e] - mm) * r * dc[1];
        }
      accumulate<DV, false, LD>(s, st + vh * DV, 0u, g, t, acc);
    }
    cp_wait<0>();
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (tok[r] < N) store_row<DV>(d_k + ((int64_t)bh * N + tok[r]) * DH + vh * DV, acc, r, t, valid[r]);
  }
}

// grid (ceil(M / rows)·halves, n_splits, B·H), rows = 16·bwd_warps; block x
// takes landmark tile x / halves and value half x % halves, whose columns
// of d_kl, d_mid and d_ql it keeps (half 0 also d_r'). Split s covers tokens
// [s·per_split, min(N, (s + 1)·per_split)). Writes the partial sums of its
// landmark rows at slot (bh·n_splits + s)·M + row of `part`; with more than
// one split, the last block of each (landmark tile, half) to finish adds
// the splits of its columns into `out` [B*H, M, W] and resets its ticket
// to 0 for the next launch.
template <int DH, bool CLS>
__global__ void __launch_bounds__(32 * bwd_warps(DH), bwd_resident(DH))
landmark_kernel(const float* __restrict__ q, int64_t q_sb, int64_t q_sh, int64_t q_sn,
                const float* __restrict__ k, int64_t k_sb, int64_t k_sh, int64_t k_sn,
                const uint8_t* __restrict__ mask, const float* __restrict__ kl,
                const uint8_t* __restrict__ lm_mask, const float* __restrict__ mid,
                const float* __restrict__ ql, const float* __restrict__ rp,
                const float* __restrict__ m3,
                const float* __restrict__ d_out, int64_t d_sb, int64_t d_sh, int64_t d_sn,
                const float* __restrict__ d_cls, const float* __restrict__ lse,
                const float* __restrict__ dd, float* __restrict__ part, float* __restrict__ out,
                int* __restrict__ tickets,  // [B*H, ceil(M / ROWS)·halves], zero between launches
                int H, int N, int M, int per_split) {
  constexpr int LD = DH + 4, TILE = COLS * LD, W = part_width<DH, CLS>(), DV = acc_cols(DH);
  constexpr int ROWS = 16 * bwd_warps(DH), NTH = 32 * bwd_warps(DH);
  extern __shared__ float4 smem4[];
  float* sA = reinterpret_cast<float*>(smem4);  // k_l rows, then q_l rows
  float* sMid = sA + ROWS * LD;
  float* ring = sMid + ROWS * LD;

  constexpr int HALVES = halves(DH);
  const int row0 = blockIdx.x / HALVES * ROWS, vh = blockIdx.x % HALVES;
  const int split_id = blockIdx.y, bh = blockIdx.z;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const uint8_t* mb = mask + (int64_t)b * N;
  const int64_t lm0 = (int64_t)bh * M;
  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* db = d_out + b * d_sb + h * d_sh;
  const int s0 = split_id * per_split, s1 = min(N, s0 + per_split);
  const int ntiles = s1 > s0 ? (s1 - s0 + COLS - 1) / COLS : 0;
  const bool active = row0 + 16 * warp < M;  // warp-uniform
  const float* aw = sA + 16 * warp * LD;
  const float* mw = sMid + 16 * warp * LD;
  int row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) row[r] = row0 + 16 * warp + g + 8 * r;
  float* slot_base = part + ((int64_t)bh * gridDim.y + split_id) * M * W;

  auto stage_out = [&](int i) {
    const int n0 = s0 + i * COLS;
    float* dst = ring + (i % STAGES) * (2 * TILE + 2 * COLS);
    stage_rows<DH, COLS, NTH>(dst, qb + n0 * q_sn, q_sn, s1 - n0);
    stage_rows<DH, COLS, NTH>(dst + TILE, db + n0 * d_sn, d_sn, s1 - n0);
    stage_vec(dst + 2 * TILE, lse + (int64_t)bh * N + n0, s1 - n0, 0);
    stage_vec(dst + 2 * TILE + COLS, dd + (int64_t)bh * N + n0, s1 - n0, COLS);
  };
  stage_rows<DH, ROWS, NTH>(sA, kl + (lm0 + row0) * DH, DH, M - row0);
  stage_rows<DH, ROWS, NTH>(sMid, mid + (lm0 + row0) * DH, DH, M - row0);
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < ntiles) stage_out(i);
    cp_commit();
  }
  float acc_kl[DV / 8][4], acc_mid[DV / 8][4];
  zero<DV>(acc_kl);
  zero<DV>(acc_mid);
  for (int it = 0; it < ntiles; ++it) {
    const uint32_t keep = valid_bits(mb, s0 + it * COLS, s1, t);
    cp_wait<STAGES - 2>();
    __syncthreads();
    if (it + STAGES - 1 < ntiles) stage_out(it + STAGES - 1);
    cp_commit();
    if (!active) continue;
    const float* st = ring + (it % STAGES) * (2 * TILE + 2 * COLS);
    const float* sL = st + 2 * TILE;
    float s[NT][4], dp[NT][4];
    scores<DH>(aw, st, g, t, s);          // s1ᵀ = k_l·qᵀ
    scores<DH>(mw, st + TILE, g, t, dp);  // dP1ᵀ = mid·d_outᵀ
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t + e;
        const bool ok = kept(keep, j, e);
        const float l = sL[col], d = sL[COLS + col];
        const float p0 = ok ? __expf(s[j][e] - l) : 0.f, p1 = ok ? __expf(s[j][2 + e] - l) : 0.f;
        s[j][e] = ok ? p0 * (dp[j][e] - d) : 0.f;
        s[j][2 + e] = ok ? p1 * (dp[j][2 + e] - d) : 0.f;
        dp[j][e] = p0;
        dp[j][2 + e] = p1;
      }
    accumulate<DV, true, LD>(s, st + vh * DV, keep, g, t, acc_kl);           // d_kl += dS1ᵀ · q
    accumulate<DV, true, LD>(dp, st + TILE + vh * DV, keep, g, t, acc_mid);  // d_mid += P1ᵀ · d_out
  }
  cp_wait<0>();
  if (active) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row[r] >= M) continue;
      const bool lv = lm_mask[(int64_t)b * M + row[r]] != 0;
      float* pr = slot_base + (int64_t)row[r] * W + vh * DV;
      store_row<DV>(pr, acc_kl, r, t, lv);
      store_row<DV>(pr + DH, acc_mid, r, t, lv);
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
      stage_vec(dst + TILE, d_cls + (int64_t)bh * N + n0, s1 - n0, 0);
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
    zero<DV>(acc_kl);
    for (int it = 0; it < ntiles; ++it) {
      const uint32_t keep = valid_bits(mb, s0 + it * COLS, s1, t);
      cp_wait<STAGES - 2>();
      __syncthreads();
      if (it + STAGES - 1 < ntiles) stage_cls(it + STAGES - 1);
      cp_commit();
      if (!active) continue;
      const float* st = ring + (it % STAGES) * (TILE + COLS);
      float s[NT][4];
      scores<DH>(aw, st, g, t, s);  // s3 = q_l·kᵀ
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = kept(keep, j, e);
          const float dc = ok ? st[TILE + 8 * j + 2 * t + e] : 0.f;
          const float e0 = ok ? __expf(s[j][e] - m3v[0]) * dc : 0.f;
          const float e1 = ok ? __expf(s[j][2 + e] - m3v[1]) * dc : 0.f;
          rsum[0] += e0;
          rsum[1] += e1;
          s[j][e] = rpv[0] * e0;
          s[j][2 + e] = rpv[1] * e1;
        }
      accumulate<DV, true, LD>(s, st + vh * DV, keep, g, t, acc_kl);  // d_ql += G · k
    }
    cp_wait<0>();
    if (active) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float x = quad_sum(rsum[r]);  // the whole quad, before any row test
        if (row[r] >= M) continue;
        float* pr = slot_base + (int64_t)row[r] * W;
        store_row<DV>(pr + 2 * DH + vh * DV, acc_kl, r, t, true);
        if (t == 0 && vh == 0) pr[3 * DH] = x;
      }
    }
  }

  if (gridDim.y == 1) return;  // part is out
  // The last split of this (landmark tile, half) to finish adds the partials in split order.
  if (!arrived_last(tickets + (int64_t)bh * gridDim.x + blockIdx.x, gridDim.y)) return;
  const int rows = min(ROWS, M - row0);
  const float* p0 = part + ((int64_t)bh * gridDim.y * M + row0) * W;
  float* o = out + (lm0 + row0) * W;
  for (int e = threadIdx.x; e < rows * W; e += NTH) {
    const int col = e % W;  // this half's columns of d_kl, d_mid, d_ql; d_r' and padding with half 0
    if ((col < 3 * DH ? (col % DH) / DV : 0) != vh) continue;
    float x = 0.f;
    for (int i = 0; i < (int)gridDim.y; ++i) x += __ldcg(p0 + (int64_t)i * M * W + e);
    o[e] = x;
  }
}

template <int DH, bool CLS>
int launch(const float* q, int64_t q_sb, int64_t q_sh, int64_t q_sn, const float* k, int64_t k_sb,
           int64_t k_sh, int64_t k_sn, const uint8_t* mask, const float* kl, const uint8_t* lm_mask,
           const float* mid, const float* ql, const float* rp, const float* m3, const float* d_out,
           int64_t d_sb, int64_t d_sh, int64_t d_sn, const float* d_cls, float* d_q, float* d_k,
           float* lse, float* dd, float* part, float* out, int* tickets, int B, int H, int N,
           int M, int n_splits, int per_split, cudaStream_t st) {
  constexpr size_t smem_t = token_smem<DH>(), smem_l = landmark_smem<DH>();
  cudaError_t err = cudaFuncSetAttribute(token_kernel<DH, CLS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_t);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(landmark_kernel<DH, CLS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_l);
  if (err != cudaSuccess) return (int)err;
  constexpr int ROWS = 16 * bwd_warps(DH), NTH = 32 * bwd_warps(DH);
  token_kernel<DH, CLS><<<dim3((N + ROWS - 1) / ROWS, B * H, halves(DH)), NTH, smem_t, st>>>(
      q, q_sb, q_sh, q_sn, k, k_sb, k_sh, k_sn, mask, kl, lm_mask, mid, ql, rp, m3, d_out, d_sb,
      d_sh, d_sn, d_cls, d_q, d_k, lse, dd, H, N, M);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  landmark_kernel<DH, CLS><<<dim3((M + ROWS - 1) / ROWS * halves(DH), n_splits, B * H), NTH, smem_l, st>>>(
      q, q_sb, q_sh, q_sn, k, k_sb, k_sh, k_sn, mask, kl, lm_mask, mid, ql, rp, m3, d_out, d_sb,
      d_sh, d_sn, d_cls, lse, dd, part, out, tickets, H, N, M, per_split);
  return (int)cudaGetLastError();
}

}  // namespace

// Landmark rows of a landmark-kernel block and the landmark-kernel blocks
// an SM holds, by head dim dh (0 where dh is not instantiated), tokens of
// its tiles (a split's length is a multiple), and the floats of a row of
// its partial sums.
extern "C" int flash_nystrom_bwd_rows(int dh) { return instantiated(dh) ? 16 * bwd_warps(dh) : 0; }
extern "C" int flash_nystrom_bwd_keys() { return COLS; }
extern "C" int flash_nystrom_bwd_resident(int dh) { return instantiated(dh) ? bwd_resident(dh) : 0; }
extern "C" int flash_nystrom_bwd_width(int dh, int cls) {
  return cls ? 3 * dh + 4 : 2 * dh;
}

#define BWD_ARGS                                                                                 \
  q, q_sb, q_sh, q_sn, k, k_sb, k_sh, k_sn, mask, kl, lm_mask, mid, ql, rp, m3, d_out, d_sb, d_sh, \
      d_sn, d_cls, d_q, d_k, lse, dd, part, out, tickets, B, H, N, M, n_splits, per_split, st

// q, k and d_out [B, H, N, DH] views whose rows start on 16 bytes; kl, mid,
// ql [B*H, M, DH], rp, m3 [B*H, M] and d_cls [B*H, N] contiguous (d_cls
// null: no cls term, and d_k untouched). Outputs d_q, d_k [B*H, N, DH] and
// out [B*H, M, W] (d_kl | d_mid | d_ql | d_r', W = flash_nystrom_bwd_width);
// scratch lse, dd [B*H, N], part [B*H, n_splits, M, W] (out itself when
// n_splits is 1) and tickets [B*H, ceil(M / rows)·halves] int32, zero at the
// first launch and left zero by each.
extern "C" int flash_nystrom_pass_b_bwd(
    const float* q, int64_t q_sb, int64_t q_sh, int64_t q_sn, const float* k, int64_t k_sb,
    int64_t k_sh, int64_t k_sn, const uint8_t* mask, const float* kl, const uint8_t* lm_mask,
    const float* mid, const float* ql, const float* rp, const float* m3, const float* d_out,
    int64_t d_sb, int64_t d_sh, int64_t d_sn, const float* d_cls, float* d_q, float* d_k,
    float* lse, float* dd, float* part, float* out, int* tickets, int B, int H, int N, int M,
    int DH, int n_splits, int per_split, void* stream) {
  if (per_split <= 0 || per_split % COLS != 0 || n_splits <= 0 ||
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
    case 16: return cls ? launch<16, true>(BWD_ARGS) : launch<16, false>(BWD_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
}
