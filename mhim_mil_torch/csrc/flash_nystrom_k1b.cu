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
// What bounds it on this card. The function's products are S, dP, d_ql, d_k
// and d_v over the valid keys, 5·nv·m·dh FMAs a (bag, head); at 3×TF32 on
// the tensor cores, operations bound it, and its bytes (k, v read once, d_k,
// d_v written) take a third of that time. A warp's cycles by phase
// (utils/phase_nystrom_bwd.py, PERF.md) go mostly to the products: their
// three mma.sync and their split arithmetic, then the exponentials; a block
// that keeps a 128-column accumulator would recompute every score in each
// column half at dh 256, at 2 warps an SM.
//
// One launch: the statistics D and 1/s3 are taken by the blocks that use
// them, so no kernel of their own runs first. The grid holds two kinds of
// block:
//   landmark: the first blocks; each owns 64 landmark rows (32 above dh 64)
//             of one (bag, head) and a contiguous split of the keys
//             (pass_a_backward_plan), takes D and 1/s3 of its rows itself,
//             and accumulates d_ql; each split writes its partial sums, and
//             the last block of a landmark tile to finish (an int32 ticket,
//             no float atomics) adds them in split order, all loads in
//             flight, so two runs give the same bits.
//   key:      the rest; each owns 64 keys (32 above dh 64) of one (bag,
//             head), takes m3, D and 1/s3 of every landmark row into shared
//             memory in its prologue, while its first chunk arrives (every
//             load of a round in flight), and walks the (q_l, d_attn3v)
//             chunks through a cp.async ring, accumulating d_k and d_v in
//             registers; no atomics. A tile of masked keys writes zeros.
// S and dP are computed by both kinds, 7 products for the function's 5: a
// key block's dS would reach d_ql only through partial sums of every key
// block, which cost more to merge. Above dh 64 each block splits the head
// dim across the warps of a row group and adds their partial score tiles
// (flash_nystrom_bwd.cuh): every score is computed once, and a block keeps 4
// (dh 128) or 8 (dh 256) warps. Each product's operands are split into TF32
// hi and lo in two instructions (`split_t`).
//
// Layouts, the ring and the geometry are flash_nystrom.cuh's and
// flash_nystrom_bwd.cuh's. Plain C interface, loaded with ctypes; the entry
// returns cudaGetLastError() after its launch.

#include "flash_nystrom_bwd.cuh"

namespace {

// Floats of shared memory of a block at head dim DH with M landmarks: two
// row slabs, a ring of two tiles a step, the partial score tiles, and a key
// block's m3 | D | 1/s3 of every landmark (a landmark block's D of its rows).
template <int DH>
size_t k1b_smem(int M) {
  using G = Bwd<DH>;
  const int stats = 3 * M > G::ROWS ? 3 * M : G::ROWS;
  return ((size_t)2 * G::ROWS * G::LD + (size_t)G::STAGES * 2 * G::TILE + G::XB + stats) * sizeof(float);
}

// The key blocks: d_k and d_v of keys [row0, row0 + ROWS); warp (rg, cg)
// takes keys [16·rg, 16·rg + 16) of them and head-dim columns [cg·DW, cg·DW
// + DW).
template <int DH>
__device__ __forceinline__ void key_block(
    float* smem, const float* __restrict__ ql, const float* __restrict__ k, int64_t k_sb, int64_t k_sh,
    int64_t k_sn, const float* __restrict__ v, int64_t v_sb, int64_t v_sh, int64_t v_sn,
    const uint8_t* __restrict__ mask, const float* __restrict__ attn3v, const float* __restrict__ m3,
    const float* __restrict__ s3, const float* __restrict__ d_attn3v, const float* __restrict__ d_s3,
    float* __restrict__ d_k, float* __restrict__ d_v, int row0, int bh, int H, int N, int M) {
  using G = Bwd<DH>;
  constexpr int LD = G::LD, COLS = G::COLS, NT = G::NT, DW = G::DW, ROWS = G::ROWS, NTH = G::NTH;
  constexpr int TILE = G::TILE, STAGES = G::STAGES, CG = G::CG, RG = G::RG;
  float* sK = smem;
  float* sV = sK + ROWS * LD;
  float* ring = sV + ROWS * LD;
  float* xb = ring + STAGES * 2 * TILE;
  float* sStat = xb + G::XB;  // m3 | D | 1/s3 of every landmark

  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, rg = warp / CG, cg = warp % CG;
  const int g = lane / 4, t = lane % 4;
  const int64_t lm0 = (int64_t)bh * M;
  const int nchunks = (M + COLS - 1) / COLS;
  const float* kw = sK + 16 * rg * LD + cg * DW;
  const float* vw = sV + 16 * rg * LD + cg * DW;
  int key[2];
  bool valid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    key[r] = row0 + 16 * rg + g + 8 * r;
    valid[r] = key[r] < N && mask[(int64_t)b * N + key[r]] != 0;
  }
  if (!__syncthreads_or(valid[0] || valid[1])) {
    // a tile of masked keys: zero gradients, nothing else read
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (key[r] >= N) continue;
      const int64_t o = ((int64_t)bh * N + key[r]) * DH + cg * DW;
      zero_row<DW>(d_k + o, t);
      zero_row<DW>(d_v + o, t);
    }
    return;
  }
  PHASES_BEGIN

  auto stage = [&](int c) {
    const int c0 = c * COLS;
    float* dst = ring + (c % STAGES) * 2 * TILE;
    stage_rows<DH, COLS, NTH>(dst, ql + (lm0 + c0) * DH, DH, M - c0);
    stage_rows<DH, COLS, NTH>(dst + TILE, d_attn3v + (lm0 + c0) * DH, DH, M - c0);
  };
  stage_rows<DH, ROWS, NTH>(sK, k + b * k_sb + h * k_sh + row0 * k_sn, k_sn, N - row0);
  stage_rows<DH, ROWS, NTH>(sV, v + b * v_sb + h * v_sh + row0 * v_sn, v_sn, N - row0);
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < nchunks) stage(i);
    cp_commit();
  }
  PHASE(PH_STAGE);
  // while they arrive: m3, D_j = Σ d_attn3v·attn3v − s3·d_s3 and 1/s3 of
  // every landmark (the first step's barrier publishes them)
  rows_dot<DH, NTH>(attn3v + lm0 * DH, DH, d_attn3v + lm0 * DH, DH, M, [&](int j, float x) {
    const float s = s3[lm0 + j];
    sStat[j] = m3[lm0 + j];
    sStat[M + j] = d_s3 != nullptr ? x - s * d_s3[lm0 + j] : x;
    sStat[2 * M + j] = 1.f / fmaxf(s, 1e-30f);
  });
  PHASE(PH_ELEM);

  float acc_k[DW / 8][4], acc_v[DW / 8][4];
  zero<DW>(acc_k);
  zero<DW>(acc_v);
  for (int c = 0; c < nchunks; ++c) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    PHASE(PH_WAIT);
    if (c + STAGES - 1 < nchunks) stage(c + STAGES - 1);
    cp_commit();
    PHASE(PH_STAGE);
    const float* st = ring + (c % STAGES) * 2 * TILE;
    float sc[2][NT][4];
    scores_k<DW, NT, LD>(kw, st + cg * DW, g, t, sc[0]);         // Sᵀ = k·q_lᵀ
    scores_k<DW, NT, LD>(vw, st + TILE + cg * DW, g, t, sc[1]);  // dPᵀ = v·d_attn3vᵀ
    group_sum<RG, CG, NT, 2>(sc, xb, rg, cg, lane);
    PHASE(PH_SCORES);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c * COLS + 8 * j + 2 * t + e;
        const bool ok = col < M;
        const int at = ok ? col : 0;
        const float mm = sStat[at], d = sStat[M + at], iv = sStat[2 * M + at];
        const float p0 = ok ? __expf(sc[0][j][e] - mm) * iv : 0.f;
        const float p1 = ok ? __expf(sc[0][j][2 + e] - mm) * iv : 0.f;
        sc[0][j][e] = ok ? p0 * (sc[1][j][e] - d) : 0.f;
        sc[0][j][2 + e] = ok ? p1 * (sc[1][j][2 + e] - d) : 0.f;
        sc[1][j][e] = p0;
        sc[1][j][2 + e] = p1;
      }
    PHASE(PH_ELEM);
    accumulate_k<DW, NT, LD, false>(sc[0], st + cg * DW, 0u, g, t, acc_k);          // d_k += dSᵀ · q_l
    accumulate_k<DW, NT, LD, false>(sc[1], st + TILE + cg * DW, 0u, g, t, acc_v);  // d_v += Pᵀ · d_attn3v
    PHASE(PH_ACC);
  }
  cp_wait<0>();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= N) continue;
    const int64_t o = ((int64_t)bh * N + key[r]) * DH + cg * DW;
    store_row<DW>(d_k + o, acc_k, r, t, valid[r]);
    store_row<DW>(d_v + o, acc_v, r, t, valid[r]);
  }
  PHASE(PH_EPI);
  PHASES_END(0);
}

// The landmark blocks: the partial d_ql of landmark rows [row0, row0 + ROWS)
// over keys [s·per_split, min(N, (s + 1)·per_split)) of split s, at slot
// (bh·n_splits + s)·M + row of `part`; with more than one split, the last
// block of the tile to finish adds the splits into d_ql and resets its
// ticket.
template <int DH>
__device__ __forceinline__ void landmark_block(
    float* smem, const float* __restrict__ ql, const float* __restrict__ k, int64_t k_sb, int64_t k_sh,
    int64_t k_sn, const float* __restrict__ v, int64_t v_sb, int64_t v_sh, int64_t v_sn,
    const uint8_t* __restrict__ mask, const float* __restrict__ attn3v, const float* __restrict__ m3,
    const float* __restrict__ s3, const float* __restrict__ d_attn3v, const float* __restrict__ d_s3,
    float* __restrict__ part, float* __restrict__ d_ql, int* __restrict__ tickets, int tile, int split_id,
    int n_splits, int bh, int H, int N, int M, int per_split) {
  using G = Bwd<DH>;
  constexpr int LD = G::LD, COLS = G::COLS, NT = G::NT, DW = G::DW, ROWS = G::ROWS, NTH = G::NTH;
  constexpr int TILE = G::TILE, STAGES = G::STAGES, CG = G::CG, RG = G::RG;
  float* sQl = smem;
  float* sDa = sQl + ROWS * LD;  // d_attn3v rows
  float* ring = sDa + ROWS * LD;
  float* xb = ring + STAGES * 2 * TILE;
  float* sD = xb + G::XB;

  const int row0 = tile * ROWS, b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, rg = warp / CG, cg = warp % CG;
  const int g = lane / 4, t = lane % 4;
  const uint8_t* mb = mask + (int64_t)b * N;
  const int64_t lm0 = (int64_t)bh * M;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;
  const int s0 = split_id * per_split, s1 = min(N, s0 + per_split);
  const int ntiles = s1 > s0 ? (s1 - s0 + COLS - 1) / COLS : 0;
  const bool active = row0 + 16 * rg < M;  // uniform over the row group
  const float* aw = sQl + 16 * rg * LD + cg * DW;
  const float* bw = sDa + 16 * rg * LD + cg * DW;
  PHASES_BEGIN

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
  PHASE(PH_STAGE);
  // D of the block's rows while the copies arrive
  for (int r = threadIdx.x; r < ROWS; r += NTH)
    if (row0 + r >= M) sD[r] = 0.f;
  rows_dot<DH, NTH>(attn3v + (lm0 + row0) * DH, DH, d_attn3v + (lm0 + row0) * DH, DH, min(ROWS, M - row0),
                    [&](int r, float x) {
                      const int64_t at = lm0 + row0 + r;
                      sD[r] = d_s3 != nullptr ? x - s3[at] * d_s3[at] : x;
                    });
  __syncthreads();
  float m3v[2], ivv[2], ddv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 16 * rg + g + 8 * r;
    const bool in = row < M;
    m3v[r] = in ? m3[lm0 + row] : 0.f;
    ivv[r] = in ? 1.f / fmaxf(s3[lm0 + row], 1e-30f) : 0.f;
    ddv[r] = sD[16 * rg + g + 8 * r];
  }
  PHASE(PH_ELEM);

  float acc[DW / 8][4];
  zero<DW>(acc);
  for (int it = 0; it < ntiles; ++it) {
    const uint32_t keep = valid_bits<NT>(mb, s0 + it * COLS, s1, t);
    cp_wait<STAGES - 2>();
    const bool any = __syncthreads_or(keep != 0);  // a tile of masked keys adds nothing
    PHASE(PH_WAIT);
    if (it + STAGES - 1 < ntiles) stage(it + STAGES - 1);
    cp_commit();
    PHASE(PH_STAGE);
    if (!active || !any) continue;
    const float* st = ring + (it % STAGES) * 2 * TILE;
    float sc[2][NT][4];
    scores_k<DW, NT, LD>(aw, st + cg * DW, g, t, sc[0]);         // S = q_l·kᵀ
    scores_k<DW, NT, LD>(bw, st + TILE + cg * DW, g, t, sc[1]);  // dP = d_attn3v·vᵀ
    group_sum<RG, CG, NT, 2>(sc, xb, rg, cg, lane);
    PHASE(PH_SCORES);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = kept(keep, j, e);
        const float p0 = ok ? __expf(sc[0][j][e] - m3v[0]) * ivv[0] : 0.f;
        const float p1 = ok ? __expf(sc[0][j][2 + e] - m3v[1]) * ivv[1] : 0.f;
        sc[0][j][e] = ok ? p0 * (sc[1][j][e] - ddv[0]) : 0.f;
        sc[0][j][2 + e] = ok ? p1 * (sc[1][j][2 + e] - ddv[1]) : 0.f;
      }
    PHASE(PH_ELEM);
    accumulate_k<DW, NT, LD, true>(sc[0], st + cg * DW, keep, g, t, acc);  // d_ql += dS · k
    PHASE(PH_ACC);
  }
  cp_wait<0>();
  float* slot_base = part + ((int64_t)bh * n_splits + split_id) * M * DH;
  if (active) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 16 * rg + g + 8 * r;
      if (row < M) store_row<DW>(slot_base + (int64_t)row * DH + cg * DW, acc, r, t, true);
    }
  }
  const int mtiles = (M + ROWS - 1) / ROWS;
  if (n_splits > 1 && arrived_last(tickets + (int64_t)bh * mtiles + tile, n_splits)) {
    // the last split of this landmark tile to finish adds the partials in split order
    merge_splits<NTH>(d_ql + (lm0 + row0) * DH, part + ((int64_t)bh * n_splits * M + row0) * DH,
                      (int64_t)M * DH, n_splits, min(ROWS, M - row0) * DH);
  }
  PHASE(PH_EPI);
  PHASES_END(1);
}

// grid (ceil(M / rows)·n_splits + ceil(N / rows), B·H): block x below
// ceil(M / rows)·n_splits is landmark tile x % ceil(M / rows) of split
// x / ceil(M / rows); the rest are key blocks, in order.
template <int DH>
__global__ void __launch_bounds__(bwd_threads(DH), bwd_resident(DH))
k1b_kernel(const float* __restrict__ ql,  // [B*H, M, DH]
           const float* __restrict__ k, int64_t k_sb, int64_t k_sh, int64_t k_sn,
           const float* __restrict__ v, int64_t v_sb, int64_t v_sh, int64_t v_sn,
           const uint8_t* __restrict__ mask,      // [B, N]
           const float* __restrict__ attn3v,      // [B*H, M, DH]
           const float* __restrict__ m3,          // [B*H, M]
           const float* __restrict__ s3,          // [B*H, M]
           const float* __restrict__ d_attn3v,    // [B*H, M, DH]
           const float* __restrict__ d_s3,        // [B*H, M] or null
           float* __restrict__ d_ql,              // [B*H, M, DH]
           float* __restrict__ d_k,               // [B*H, N, DH]
           float* __restrict__ d_v,               // [B*H, N, DH]
           float* __restrict__ part,              // [B*H, n_splits, M, DH]
           int* __restrict__ tickets,             // [B*H, ceil(M / rows)], zero between launches
           int H, int N, int M, int n_splits, int per_split) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int ROWS = bwd_rows(DH);
  const int mtiles = (M + ROWS - 1) / ROWS, lm_blocks = mtiles * n_splits;
  const int x = blockIdx.x, bh = blockIdx.y;
  if (x < lm_blocks)
    landmark_block<DH>(smem, ql, k, k_sb, k_sh, k_sn, v, v_sb, v_sh, v_sn, mask, attn3v, m3, s3, d_attn3v,
                       d_s3, part, d_ql, tickets, x % mtiles, x / mtiles, n_splits, bh, H, N, M, per_split);
  else
    key_block<DH>(smem, ql, k, k_sb, k_sh, k_sn, v, v_sb, v_sh, v_sn, mask, attn3v, m3, s3, d_attn3v, d_s3,
                  d_k, d_v, (x - lm_blocks) * ROWS, bh, H, N, M);
}

template <int DH>
int launch(const float* ql, const float* k, int64_t k_sb, int64_t k_sh, int64_t k_sn, const float* v,
           int64_t v_sb, int64_t v_sh, int64_t v_sn, const uint8_t* mask, const float* attn3v,
           const float* m3, const float* s3, const float* d_attn3v, const float* d_s3, float* d_ql,
           float* d_k, float* d_v, float* part, int* tickets, int B, int H, int N, int M, int n_splits,
           int per_split, cudaStream_t st) {
  const size_t smem = k1b_smem<DH>(M);
  cudaError_t err = cudaFuncSetAttribute(k1b_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int ROWS = bwd_rows(DH);
  const int blocks = (M + ROWS - 1) / ROWS * n_splits + (N + ROWS - 1) / ROWS;
  k1b_kernel<DH><<<dim3(blocks, B * H), bwd_threads(DH), smem, st>>>(
      ql, k, k_sb, k_sh, k_sn, v, v_sb, v_sh, v_sn, mask, attn3v, m3, s3, d_attn3v, d_s3, d_ql, d_k, d_v, part,
      tickets, H, N, M, n_splits, per_split);
  return (int)cudaGetLastError();
}

}  // namespace

PHASES_ENTRY(flash_nystrom_k1b)

#ifdef NYS_PHASES
// The kernel's occupancy_of at M = 256, for its key and its landmark blocks
// (one kernel: the same numbers), 5 ints each.
extern "C" int flash_nystrom_k1b_occupancy(int dh, int cls, int* out) {
  (void)cls;
#define OCC(D)                                                                            \
  case D: {                                                                               \
    const int e = occupancy_of(k1b_kernel<D>, bwd_threads(D), k1b_smem<D>(256), out);     \
    return e ? e : occupancy_of(k1b_kernel<D>, bwd_threads(D), k1b_smem<D>(256), out + 5); \
  }
  switch (dh) {
    OCC(16) OCC(32) OCC(64) OCC(128) OCC(256)
    default: return (int)cudaErrorInvalidValue;
  }
#undef OCC
}
#endif

// By head dim dh (0 where dh is not instantiated): the landmark rows of a
// landmark block, the keys of its tiles (a split's length is a multiple)
// and the blocks an SM it is built for: the wrapper's plan mirrors them.
extern "C" int flash_nystrom_k1b_rows(int dh) { return instantiated(dh) ? bwd_rows(dh) : 0; }
extern "C" int flash_nystrom_k1b_keys(int dh) { return instantiated(dh) ? bwd_cols(dh) : 0; }
extern "C" int flash_nystrom_k1b_resident(int dh) { return instantiated(dh) ? bwd_resident(dh) : 0; }

#define K1B_ARGS                                                                                     \
  ql, k, k_sb, k_sh, k_sn, v, v_sb, v_sh, v_sn, mask, attn3v, m3, s3, d_attn3v, d_s3, d_ql, d_k, d_v, part, \
      tickets, B, H, N, M, n_splits, per_split, st

// k and v [B, H, N, DH] views whose rows start on 16 bytes; ql, attn3v,
// d_attn3v [B*H, M, DH], m3, s3 and d_s3 [B*H, M] contiguous (d_s3 null:
// zero). Outputs d_ql [B*H, M, DH], d_k and d_v [B*H, N, DH]; scratch part
// [B*H, n_splits, M, DH] (d_ql itself when n_splits is 1) and tickets
// [B*H, ceil(M / rows)] int32, zero at the first launch and left zero by
// each.
extern "C" int flash_nystrom_pass_a_bwd(
    const float* ql, const float* k, int64_t k_sb, int64_t k_sh, int64_t k_sn, const float* v,
    int64_t v_sb, int64_t v_sh, int64_t v_sn, const uint8_t* mask, const float* attn3v,
    const float* m3, const float* s3, const float* d_attn3v, const float* d_s3, float* d_ql,
    float* d_k, float* d_v, float* part, int* tickets, int B, int H, int N, int M, int DH, int n_splits,
    int per_split, void* stream) {
  if (!instantiated(DH) || per_split <= 0 || per_split % bwd_cols(DH) != 0 || n_splits <= 0 ||
      (int64_t)n_splits * per_split < N || (int64_t)(n_splits - 1) * per_split >= N ||
      (n_splits == 1) != (part == d_ql))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (DH) {
    case 256: return launch<256>(K1B_ARGS);
    case 128: return launch<128>(K1B_ARGS);
    case 64: return launch<64>(K1B_ARGS);
    case 32: return launch<32>(K1B_ARGS);
    default: return launch<16>(K1B_ARGS);
  }
}
