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
// dh = 64, fp32 in and out; H100 SXM data sheet: 495 TFLOP/s TF32 on the
// tensor cores, 3.35 TB/s):
//   K1: 4·B·H·m·N·dh = 21.5 GFLOP (sim3 and attn3@V), three TF32 products
//       each (below) = 64.4 GFLOP -> 0.13 ms; 168 MB (k and v read once)
//       -> 0.05 ms. Operations bound it.
//   K2: 6·B·H·m·N·dh = 32.2 GFLOP (sim1, attn1@mid, sim3 for the cls row),
//       96.6 GFLOP in TF32 -> 0.195 ms; 252 MB -> 0.075 ms. Operations.
//
// Precision (3×TF32 products on mma.sync, __expf) and the register and
// shared-memory layouts are those of flash_nystrom.cuh. A warp owns 16 rows
// (landmarks in K1, tokens in K2) with the running max, sum and the
// [16 × dh] accumulator in registers; row statistics reduce across the quad
// only at the end. Operand tiles arrive through cp.async rings, so the next
// tile loads while this one computes; rows past the end are zero-filled.
//
// Head dims 16, 32, 64, 128 and 256 are instantiated (the wrapper zero-pads
// any other dh up to the next). At 128 the accumulator doubles, so K1 runs
// one block an SM and K2 two (a_resident, b_resident), where 64 and below
// run two and four. At 256 each runs as two column halves of the value side
// (flash_nystrom.cuh), one block an SM, K1 with 64 landmark rows a block so
// that its q_l rows and a three-stage ring of 256-wide k and 128-wide v
// tiles fit in shared memory. That recomputes the scores once per half: no
// speed target there.
//
// K1: a block owns 128 landmark rows (8 warps) of one (bag, head) and a
// contiguous split of the keys; the wrapper plans the splits so that the
// grid fills the card at batch 1 as at batch 4. The grid's fastest index
// is the landmark row block, so the blocks that read the same keys run
// together and k and v come from L2 after the first. Each block writes a
// partial (max, sum, unnormalised acc[dh]) per row; a second kernel merges
// the splits by log-sum-exp rescaling. Values at masked keys are never
// used: their scores are replaced and their V rows read as zero.
// K2: a block owns 64 tokens (4 warps) of one (bag, head), with their q and
// k rows staged in turn, and walks the landmarks twice in chunks of 32: first
// (k_l, mid) chunks in a two-stage ring, computing sim1 with the online
// softmax and P·mid, and writes out; then (q_l, r', m3) chunks in a
// three-stage ring over the same shared memory, computing sim3ᵀ = k·q_lᵀ
// and adding exp(sim3 − m3)·r' to the cls row. Two walks need half the ring
// of one walk over all three operands and one set of token rows at a time,
// so four blocks fit on an SM.
//
// Plain C interface, loaded with ctypes. Each entry returns
// cudaGetLastError() after its launches.

#include "flash_nystrom.cuh"

namespace {

constexpr int A_STAGES = 3;
constexpr int B_WARPS = 4, B_ROWS = 16 * B_WARPS, B_STAGES = 2, C_STAGES = 3;
constexpr int MERGE_THREADS = 256;

// Blocks an SM holds, by head dim: each kernel's __launch_bounds__ and the
// register budget it sets. At DH 128 a warp's [16 × DH] accumulator is 64
// floats a thread; K1 (whose shared memory then admits one block) takes one
// block an SM and K2 two, so that neither spills.
constexpr int a_resident(int dh) { return dh > 64 ? 1 : 2; }
constexpr int b_resident(int dh) { return dh > 128 ? 1 : dh > 64 ? 2 : 4; }
__host__ __device__ constexpr int a_warps(int dh) { return dh > 128 ? 4 : 8; }

// ---- K1 ----

template <int DH>
constexpr size_t pass_a_smem() {
  // q_l rows, and a ring of (k tile, v tile); v at the accumulator's width
  return ((size_t)16 * a_warps(DH) * (DH + 4) + (size_t)A_STAGES * COLS * (DH + acc_cols(DH) + 8)) *
         sizeof(float);
}

// grid (ceil(M / rows)·halves, n_splits, B·H), rows = 16·a_warps; block x
// takes row block x / halves and value half x % halves. Split s covers keys
// [s·per_split, min(N, (s + 1)·per_split)). Writes the partials of its rows
// at slot (bh·n_splits + s)·M + row.
template <int DH>
__global__ void __launch_bounds__(32 * a_warps(DH), a_resident(DH))
pass_a_partial_kernel(const float* __restrict__ ql,  // [B*H, M, DH]
                      const float* __restrict__ k, int64_t k_sb, int64_t k_sh, int64_t k_sn,
                      const float* __restrict__ v, int64_t v_sb, int64_t v_sh, int64_t v_sn,
                      const uint8_t* __restrict__ mask,  // [B, N]
                      float* __restrict__ part_m, float* __restrict__ part_s,
                      float* __restrict__ part_acc, int H, int N, int M, int per_split) {
  constexpr int A_ROWS = 16 * a_warps(DH), DV = acc_cols(DH), NTH = 32 * a_warps(DH);
  constexpr int LD = DH + 4, KT = COLS * LD, STEP = KT + COLS * (DV + 4);
  extern __shared__ float4 smem4[];
  float* sQl = reinterpret_cast<float*>(smem4);
  float* ring = sQl + A_ROWS * LD;  // A_STAGES × (k tile, v tile)

  constexpr int HALVES = halves(DH);
  const int row0 = blockIdx.x / HALVES * A_ROWS, vh = blockIdx.x % HALVES;
  const int split_id = blockIdx.y, bh = blockIdx.z;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;
  const uint8_t* mb = mask + (int64_t)b * N;
  const int s0 = split_id * per_split, s1 = min(N, s0 + per_split);
  const int ntiles = s1 > s0 ? (s1 - s0 + COLS - 1) / COLS : 0;

  auto stage_tile = [&](int i) {
    const int n0 = s0 + i * COLS;
    float* dst = ring + (i % A_STAGES) * STEP;
    stage_rows<DH, COLS, NTH>(dst, kb + n0 * k_sn, k_sn, s1 - n0);
    stage_rows<DV, COLS, NTH>(dst + KT, vb + n0 * v_sn + vh * DV, v_sn, s1 - n0);
  };
  stage_rows<DH, A_ROWS, NTH>(sQl, ql + ((int64_t)bh * M + row0) * DH, DH, M - row0);
#pragma unroll
  for (int i = 0; i < A_STAGES - 1; ++i) {
    if (i < ntiles) stage_tile(i);
    cp_commit();
  }

  const bool active = row0 + 16 * warp < M;  // warp-uniform
  const float* qw = sQl + 16 * warp * LD;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};
  float acc[DV / 8][4];
  zero<DV>(acc);

  for (int it = 0; it < ntiles; ++it) {
    const uint32_t keep = valid_bits(mb, s0 + it * COLS, s1, t);
    cp_wait<A_STAGES - 2>();  // tile it has landed (this thread's copies)
    __syncthreads();          // ... everyone's, and tile it - 1 is consumed
    if (it + A_STAGES - 1 < ntiles) stage_tile(it + A_STAGES - 1);
    cp_commit();
    if (!active) continue;
    const float* sK = ring + (it % A_STAGES) * STEP;
    float s[NT][4];
    scores<DH>(qw, sK, g, t, s);
    softmax_step<DV>(s, keep, m_run, l_run, acc);
    accumulate<DV, true>(s, sK + KT, keep, g, t, acc);
  }
  cp_wait<0>();
  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(l_run[r]);
    const int row = row0 + 16 * warp + g + 8 * r;
    if (row >= M) continue;
    const int64_t slot = ((int64_t)bh * gridDim.y + split_id) * M + row;
    float* pa = part_acc + slot * DH + vh * DV + 2 * t;
#pragma unroll
    for (int d = 0; d < DV / 8; ++d)
      *reinterpret_cast<float2*>(pa + 8 * d) = make_float2(acc[d][2 * r], acc[d][2 * r + 1]);
    if (t == 0 && vh == 0) {
      part_m[slot] = m_run[r];
      part_s[slot] = l;
    }
  }
}

// One thread per output element (row, d): rescales the n_splits partials
// of its row by exp(m_i − m) and sums them. A split without a valid key has
// m_i = −1e30, s_i = 0 and acc_i = 0 and adds nothing.
template <int DH>
__global__ void __launch_bounds__(MERGE_THREADS)
pass_a_merge_kernel(const float* __restrict__ part_m, const float* __restrict__ part_s,
                    const float* __restrict__ part_acc, float* __restrict__ attn3v,
                    float* __restrict__ m3, float* __restrict__ s3, int64_t rows, int M,
                    int n_splits) {
  const int64_t e = (int64_t)blockIdx.x * MERGE_THREADS + threadIdx.x;
  if (e >= rows * DH) return;
  const int64_t row = e / DH, bh = row / M;
  const int d = (int)(e % DH);
  const int64_t base = bh * n_splits * M + row % M;  // split 0's slot
  float m = NEG_INF;
  for (int i = 0; i < n_splits; ++i) m = fmaxf(m, part_m[base + (int64_t)i * M]);
  float s = 0.f, a = 0.f;
  for (int i = 0; i < n_splits; ++i) {
    const int64_t slot = base + (int64_t)i * M;
    const float w = __expf(part_m[slot] - m);
    s += part_s[slot] * w;
    a += part_acc[slot * DH + d] * w;
  }
  attn3v[e] = a / fmaxf(s, 1e-30f);
  if (d == 0) {
    m3[row] = m;
    s3[row] = s;
  }
}

template <int DH>
int launch_pass_a(const float* ql, const float* k, int64_t k_sb, int64_t k_sh, int64_t k_sn,
                  const float* v, int64_t v_sb, int64_t v_sh, int64_t v_sn, const uint8_t* mask,
                  float* part_m, float* part_s, float* part_acc, float* attn3v, float* m3,
                  float* s3, int B, int H, int N, int M, int n_splits, int per_split,
                  cudaStream_t st) {
  constexpr size_t smem = pass_a_smem<DH>();
  cudaError_t err = cudaFuncSetAttribute(pass_a_partial_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int a_rows = 16 * a_warps(DH);
  const dim3 grid((M + a_rows - 1) / a_rows * halves(DH), n_splits, B * H);
  pass_a_partial_kernel<DH><<<grid, 32 * a_warps(DH), smem, st>>>(
      ql, k, k_sb, k_sh, k_sn, v, v_sb, v_sh, v_sn, mask, part_m, part_s, part_acc, H, N, M,
      per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t rows = (int64_t)B * H * M;
  const int64_t blocks = (rows * DH + MERGE_THREADS - 1) / MERGE_THREADS;
  pass_a_merge_kernel<DH><<<(unsigned)blocks, MERGE_THREADS, 0, st>>>(
      part_m, part_s, part_acc, attn3v, m3, s3, rows, M, n_splits);
  return (int)cudaGetLastError();
}

// ---- K2 ----

template <int DH>
constexpr size_t pass_b_smem() {
  // the block's q rows (then its k rows), then a ring shared by the two
  // phases; mid at the accumulator's width
  constexpr size_t tile = (size_t)COLS * (DH + 4);
  constexpr size_t out_ring = B_STAGES * (tile + COLS * (acc_cols(DH) + 4)), cls_ring = C_STAGES * (tile + 2 * COLS);
  return (B_ROWS * (DH + 4) + (out_ring > cls_ring ? out_ring : cls_ring)) * sizeof(float);
}

// grid (ceil(N / B_ROWS), B·H, halves): the token tiles of one (bag, head)
// are neighbours, so its landmark operands stay in L2. Value half z writes
// out's columns [z·128, z·128 + 128); half 0 alone computes the cls row.
template <int DH>
__global__ void __launch_bounds__(32 * B_WARPS, b_resident(DH))
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
  constexpr int LD = DH + 4, TILE = COLS * LD, NTH = 32 * B_WARPS, DV = acc_cols(DH);
  constexpr int STEP = TILE + COLS * (DV + 4);
  extern __shared__ float4 smem4[];
  float* sRows = reinterpret_cast<float*>(smem4);  // the block's q rows, then its k rows
  float* ring = sRows + B_ROWS * LD;                // (k_l, mid) chunks, then (q_l, r', m3) chunks

  // the value half: a compile-time 0 below DH 256, so those bodies index no half
  const int t0 = blockIdx.x * B_ROWS, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int vh = halves(DH) > 1 ? (int)blockIdx.z : 0;
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const uint8_t* mb = mask + (int64_t)b * N;
  const uint8_t* lb = lm_mask + (int64_t)b * M;
  const int64_t lm0 = (int64_t)bh * M;
  const int nchunks = (M + COLS - 1) / COLS;
  const float* rw = sRows + 16 * warp * LD;  // the warp's q rows, then its k rows
  bool valid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int tok = t0 + 16 * warp + g + 8 * r;
    valid[r] = tok < N && mb[tok] != 0;
  }

  // phase 1, out: online softmax of q·k_lᵀ over the valid landmarks, times mid
  auto stage_out = [&](int c) {
    const int c0 = c * COLS;
    float* dst = ring + (c % B_STAGES) * STEP;
    stage_rows<DH, COLS, NTH>(dst, kl + (lm0 + c0) * DH, DH, M - c0);
    stage_rows<DV, COLS, NTH>(dst + TILE, mid + (lm0 + c0) * DH + vh * DV, DH, M - c0);
  };
  stage_rows<DH, B_ROWS, NTH>(sRows, q + b * q_sb + h * q_sh + t0 * q_sn, q_sn, N - t0);
#pragma unroll
  for (int i = 0; i < B_STAGES - 1; ++i) {
    if (i < nchunks) stage_out(i);
    cp_commit();
  }
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};
  float acc[DV / 8][4];
  zero<DV>(acc);
  for (int c = 0; c < nchunks; ++c) {
    const uint32_t keep = valid_bits(lb, c * COLS, M, t);
    cp_wait<B_STAGES - 2>();
    __syncthreads();
    if (c + B_STAGES - 1 < nchunks) stage_out(c + B_STAGES - 1);
    cp_commit();
    const float* st = ring + (c % B_STAGES) * STEP;
    float s[NT][4];
    scores<DH>(rw, st, g, t, s);
    softmax_step<DV>(s, keep, m_run, l_run, acc);
    accumulate<DV, false>(s, st + TILE, 0u, g, t, acc);
  }
  cp_wait<0>();
  __syncthreads();  // the q rows and the ring are free for phase 2

  float* ob = out + b * o_sb + h * o_sh + vh * DV;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(l_run[r]);
    const int tok = t0 + 16 * warp + g + 8 * r;
    if (tok >= N) continue;
    const float denom = fmaxf(l, 1e-30f);
    float* orow = ob + tok * o_sn + 2 * t;
#pragma unroll
    for (int d = 0; d < DV / 8; ++d)
      *reinterpret_cast<float2*>(orow + 8 * d) =
          valid[r] ? make_float2(acc[d][2 * r] / denom, acc[d][2 * r + 1] / denom) : make_float2(0.f, 0.f);
  }

  if (vh != 0) return;  // block-uniform: the cls row is half 0's

  // phase 2, cls: Σ over every landmark of r'·exp(q_l·k − m3); past M, r' = 0
  auto stage_cls = [&](int c) {
    const int c0 = c * COLS;
    float* dst = ring + (c % C_STAGES) * (TILE + 2 * COLS);
    stage_rows<DH, COLS, NTH>(dst, ql + (lm0 + c0) * DH, DH, M - c0);
    const int i = threadIdx.x % COLS;
    const bool in = c0 + i < M;
    if (threadIdx.x < COLS) cp4(dst + TILE + i, rp + lm0 + (in ? c0 + i : 0), in);
    else if (threadIdx.x < 2 * COLS) cp4(dst + TILE + COLS + i, m3 + lm0 + (in ? c0 + i : 0), in);
  };
  stage_rows<DH, B_ROWS, NTH>(sRows, k + b * k_sb + h * k_sh + t0 * k_sn, k_sn, N - t0);
#pragma unroll
  for (int i = 0; i < C_STAGES - 1; ++i) {
    if (i < nchunks) stage_cls(i);
    cp_commit();
  }
  float cl[2] = {0.f, 0.f};
  for (int c = 0; c < nchunks; ++c) {
    cp_wait<C_STAGES - 2>();
    __syncthreads();
    if (c + C_STAGES - 1 < nchunks) stage_cls(c + C_STAGES - 1);
    cp_commit();
    const float* st = ring + (c % C_STAGES) * (TILE + 2 * COLS);
    float s[NT][4];
    scores<DH>(rw, st, g, t, s);
    const float* sR = st + TILE;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t + e;
        const float r = sR[col], mm = sR[COLS + col];
        cl[0] += __expf(s[j][e] - mm) * r;
        cl[1] += __expf(s[j][2 + e] - mm) * r;
      }
  }
  cp_wait<0>();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float x = quad_sum(cl[r]);
    const int tok = t0 + 16 * warp + g + 8 * r;
    if (tok < N && t == 0) cls[(int64_t)bh * N + tok] = valid[r] ? x : 0.f;
  }
}

template <int DH>
int launch_pass_b(const float* q, int64_t q_sb, int64_t q_sh, int64_t q_sn, const float* k,
                  int64_t k_sb, int64_t k_sh, int64_t k_sn, const uint8_t* mask, const float* kl,
                  const uint8_t* lm_mask, const float* mid, const float* ql, const float* rp,
                  const float* m3, float* out, int64_t o_sb, int64_t o_sh, int64_t o_sn,
                  float* cls, int B, int H, int N, int M, cudaStream_t st) {
  constexpr size_t smem = pass_b_smem<DH>();
  cudaError_t err = cudaFuncSetAttribute(pass_b_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + B_ROWS - 1) / B_ROWS, B * H, halves(DH));
  pass_b_kernel<DH><<<grid, 32 * B_WARPS, smem, st>>>(q, q_sb, q_sh, q_sn, k, k_sb, k_sh, k_sn,
                                                      mask, kl, lm_mask, mid, ql, rp, m3, out,
                                                      o_sb, o_sh, o_sn, cls, H, N, M);
  return (int)cudaGetLastError();
}

}  // namespace

// Rows of a K1 block and keys of its tiles: a split's length is a multiple
// of the latter (the wrapper's plan mirrors both), and the K1 blocks an SM
// holds, by head dim dh (0 for a head dim that is not instantiated).
extern "C" int flash_nystrom_pass_a_rows(int dh) { return instantiated(dh) ? 16 * a_warps(dh) : 0; }
extern "C" int flash_nystrom_pass_a_keys() { return COLS; }
extern "C" int flash_nystrom_pass_a_resident(int dh) { return instantiated(dh) ? a_resident(dh) : 0; }

#define PASS_A_ARGS                                                                             \
  ql, k, k_sb, k_sh, k_sn, v, v_sb, v_sh, v_sn, mask, part_m, part_s, part_acc, attn3v, m3, s3, \
      B, H, N, M, n_splits, per_split, st
#define PASS_B_ARGS                                                                            \
  q, q_sb, q_sh, q_sn, k, k_sb, k_sh, k_sn, mask, kl, lm_mask, mid, ql, rp, m3, out, o_sb, o_sh, \
      o_sn, cls, B, H, N, M, st

// q/k/v rows must start on 16 bytes (the wrapper checks): the base pointers
// and every stride but the last a multiple of 4 floats. Scratch part_m,
// part_s [B*H, n_splits, M] and part_acc [B*H, n_splits, M, DH], fp32.
extern "C" int flash_nystrom_pass_a(
    const float* ql, const float* k, int64_t k_sb, int64_t k_sh, int64_t k_sn,
    const float* v, int64_t v_sb, int64_t v_sh, int64_t v_sn, const uint8_t* mask,
    float* part_m, float* part_s, float* part_acc, float* attn3v, float* m3, float* s3,
    int B, int H, int N, int M, int DH, int n_splits, int per_split, void* stream) {
  if (per_split <= 0 || per_split % COLS != 0 || n_splits <= 0 ||
      (int64_t)n_splits * per_split < N || (int64_t)(n_splits - 1) * per_split >= N)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (DH) {
    case 256: return launch_pass_a<256>(PASS_A_ARGS);
    case 128: return launch_pass_a<128>(PASS_A_ARGS);
    case 64: return launch_pass_a<64>(PASS_A_ARGS);
    case 32: return launch_pass_a<32>(PASS_A_ARGS);
    case 16: return launch_pass_a<16>(PASS_A_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int flash_nystrom_pass_b(
    const float* q, int64_t q_sb, int64_t q_sh, int64_t q_sn, const float* k,
    int64_t k_sb, int64_t k_sh, int64_t k_sn, const uint8_t* mask, const float* kl,
    const uint8_t* lm_mask, const float* mid, const float* ql, const float* rp,
    const float* m3, float* out, int64_t o_sb, int64_t o_sh, int64_t o_sn, float* cls,
    int B, int H, int N, int M, int DH, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (DH) {
    case 256: return launch_pass_b<256>(PASS_B_ARGS);
    case 128: return launch_pass_b<128>(PASS_B_ARGS);
    case 64: return launch_pass_b<64>(PASS_B_ARGS);
    case 32: return launch_pass_b<32>(PASS_B_ARGS);
    case 16: return launch_pass_b<16>(PASS_B_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
}
