// Separable 2D selective scan for sm_90a (K5).
//
// Replaces the Pallas kernel `_scan2d_kernel` with its row scan
// `_hillis_steele` (mhim_mil_tpu/ops/pallas_scan2d.py:40-86, launched by
// `pallas_selective_scan_2d`). Per (bag, channel e, state n), with
// a = −exp(A_log[e, n]) and the cells (r, c) of an H × W grid:
//   ā = exp(Δ·a),  b̄x = Δ·x·B[n]
//   u[r, c] = ā·u[r, c−1] + b̄x            (horizontal, along the row)
//   h[r, c] = ā·h[r−1, c] + u[r, c]        (vertical, across rows)
//   y[r, c, e] = Σ_n h·C[n] + D[e]·x
// x, Δ are [Bs, H, W, ED] and B, C [Bs, H, W, N] (fp32, or bf16 converted in
// registers); y is fp32. Ā, B̄x, u and h never touch device memory, except
// at the two ends of the row loop: the C entry scan2d_carry takes an fp32
// h0[Bs, W, ED, N], the vertical state entering the first row (h[−1, c] in
// the recurrence above; null: zero), and writes the last row's h into
// h_last[Bs, W, ED, N] (null: not written). Since the vertical step is
// elementwise per column, a band of rows depends on the rows above it only
// through that one row of state: a grid whose rows are split into bands
// over several processes is scanned band by band, each from the state the
// bands above hand it (mhim_mil_torch/ops/scan2d.py `scan2d_carry`). Each
// thread reads and writes its own columns' N states once, 6.2 MB each way
// at the BLCA grid's width beside x, Δ and y's 107 MB.
//
// Bound at the BLCA grid (Bs 1, H 275, W 381, ED 256, N 16, fp32): x, Δ and
// y move 107 MB each and B, C 6.7 MB each, 335 MB or 0.10 ms at 3.35 TB/s;
// the 0.43 G exponentials take 0.10 ms on the special-function units, and
// the FMAs 0.06 ms.
//
// Design (scan2d_cluster_kernel). On the TPU the rows are the sequential
// grid axis and the previous row's h is carried in VMEM scratch. Here the
// row loop lives inside a block, and a row is split across a thread-block
// cluster of S ≤ 8 blocks, each owning G consecutive channels of one bag
// and a segment of P·R columns. Thread (j, g) = threadIdx.x / G, % G walks
// the R = 3 consecutive columns of run j for channel g, all N states,
// serially in registers, and its h[R][N] stays there from row to row. G is
// 8 fp32 or 16 bf16 channels where the row allows (one 32-byte sector of a
// cell), so that a warp reads x and Δ, and writes y, as whole sectors; B and
// C are read once per cell and block, staged per row in shared memory as
// fp32 and read by the G threads of a run as broadcasts. A block has at
// most 128 threads, held to 168 registers, so that three fit an SM and the
// BLCA grid's 32 clusters of 8 are resident at once (at two an SM the GPCs
// hold 30); wider rows take fewer channels a block (8, then 4) rather than
// more threads, and only past 768 columns do 4-channel blocks take up to
// 192 threads (two an SM at the same 168 registers), for rows up to 1,152
// columns. A row:
//   1. pass 1: each run's aggregate (Πā, its scan of b̄x from zero) per
//      state, into shared memory;
//   2. one lane per (channel, state) scans the block's P run aggregates in
//      order, in place, to exclusive prefixes, and publishes the block's
//      aggregate in its double-buffered `tot`;
//   3. one cluster barrier; the same lane folds the aggregates of the
//      blocks to its left, read through distributed shared memory, into the
//      carry entering this block;
//   4. pass 2: each run walks its columns again from its prefix and the
//      carry, ā taken anew (held from pass 1, it would take 48 more
//      registers, two blocks an SM and so a second wave): u, then
//      h = ā·h + u and y = Σ_n h·C + D·x.
// The next row's x, Δ, B and C are loaded into registers while the cluster
// barrier completes, every load issued before any is used, and B and C are
// staged in the other half of a double-buffered stage before pass 2. exp(A_log) is
// taken once per block; expf is the accurate one; no atomics, so y is
// deterministic. The layout (G, S, P) comes from the caller
// (`ops/scan2d.scan_plan`).
//
// Rows wider than a cluster of 8 blocks holds (more than 1,152 columns)
// take scan2d_wide_kernel: one block per
// (bag, channel), one thread per column of 512-column chunks, each thread
// walking ceil(W / 512) columns, the first MAX_CHUNKS with h in registers
// and the rest with h in dynamic shared memory where it fits the block,
// else in a global scratch buffer that the caller allocates (scan2d_scratch
// says how large); either way laid out [chunk, n, thread], so each thread
// owns its entries. Each row and chunk is one block-wide inclusive scan of
// the (ā, b̄x) pairs for all N states: __shfl_up_sync within a warp, then
// each thread folds the totals of the warps before it (and the carry of the
// previous chunk) from shared memory, double-buffered so that one
// __syncthreads per row and chunk suffices.
//
// Plain C interface, loaded with ctypes; each entry returns the launch's
// CUDA error code.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int RUN = 3;  // R: the columns a thread walks; its h[R][N] stays in registers
// Threads of a cluster block: at most 128, three an SM at 168 registers a
// thread, so that a wave holds 45 clusters of 8 (at two an SM, the GPCs hold
// 30); 4-channel blocks take up to 192, two an SM at the same 168 registers.
template <int G> constexpr int block_max() { return G == 4 ? 192 : 128; }
constexpr int MAX_CLUSTER = 8;  // blocks of a cluster (the portable size)
constexpr int MAX_THREADS = 512;  // the wide kernel's block
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int MAX_CHUNKS = 2;  // the wide kernel's chunks whose h lives in registers

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// the vector of states a thread reads from the stage: 4 floats, or 2 at N = 2
template <int N> struct Vec {
  using type = float4;
  static constexpr int width = 4;
};
template <> struct Vec<2> {
  using type = float2;
  static constexpr int width = 2;
};
__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ float lane_of(const float2& v, int i) { return i == 0 ? v.x : v.y; }

// floats per staged column of B or C: N plus 4 from N = 4 on, so that the
// runs of a warp read from distinct banks
__host__ __device__ constexpr int stage_stride(int N) { return N >= 4 ? N + 4 : N; }

// Dynamic shared memory of a cluster block, in floats: the B/C stage
// [2 rows][B, C][P·R columns][stage_stride], the run aggregates and then
// prefixes run_a, run_u [P][(N + 1)·G] (padded by one state so a warp's
// runs fall in distinct banks), tot [2 rows][a, u][N·G], the carry [N·G]
// and −exp(A_log) [N·G].
template <int N, int G>
__host__ __device__ constexpr int64_t cluster_floats(int P) {
  return 4LL * P * RUN * stage_stride(N) + 2LL * P * (N + 1) * G + 6LL * N * G;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// grid (⌈ED/G⌉·S, Bs), clusters (S, 1, 1), blockDim G·P ≤ block_max<G>(),
// two blocks an SM at G 4 and three otherwise; see the design above
template <typename T, int N, int G>
__global__ void __launch_bounds__(G == 4 ? 192 : 128, G == 4 ? 2 : 3)  // block_max, min_blocks
scan2d_cluster_kernel(const T* __restrict__ x, const T* __restrict__ delta,
                      const T* __restrict__ Bm, int64_t b_cs, const T* __restrict__ Cm,
                      int64_t c_cs, const float* __restrict__ A_log,
                      const float* __restrict__ Dv, float* __restrict__ y,
                      const float* __restrict__ h0, float* __restrict__ h_last, int H, int W,
                      int ED, int S, int P) {
  using V = typename Vec<N>::type;
  constexpr int R = RUN, NS = stage_stride(N), NG = N * G, RS = (N + 1) * G;
  constexpr int VW = Vec<N>::width, NV = N / VW;
  constexpr int QH = (R * N + G - 1) / G;  // staged B (and as many C) values a thread loads per row
  extern __shared__ float4 smem4[];
  const int nt = G * P, cb = P * R;  // threads, columns of the block
  float* stage = reinterpret_cast<float*>(smem4);
  float* run_a = stage + 4 * cb * NS;
  float* run_u = run_a + P * RS;
  float* tot = run_u + P * RS;
  float* cin = tot + 4 * NG;
  float* an = cin + NG;

  const int tid = threadIdx.x, g = tid % G, j = tid / G;
  const int seg = blockIdx.x % S, bag = blockIdx.y;
  const int e0 = blockIdx.x / S * G, e = e0 + g;
  const bool ch = e < ED;
  const int c_blk = seg * cb, c_run = c_blk + j * R;
  const int64_t row0 = (int64_t)bag * H * W;

  for (int i = tid; i < NG; i += nt) {  // i = n·G + g
    const int ei = e0 + i % G;
    an[i] = ei < ED ? -expf(A_log[(int64_t)ei * N + i / G]) : 0.f;
  }
  const float d_skip = ch ? Dv[e] : 0.f;

  T xn[R], dn[R], bn[QH], cn[QH];  // the next row, as loaded
  auto load_row = [&](int r) {
    const int64_t cell = row0 + (int64_t)r * W;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int c = c_run + k;
      const bool in = ch && c < W;
      xn[k] = in ? x[(cell + c) * ED + e] : zero<T>();
      dn[k] = in ? delta[(cell + c) * ED + e] : zero<T>();
    }
#pragma unroll
    for (int q = 0; q < QH; ++q) {  // value i of the block's cb·N, i = column·N + n
      const int i = tid + q * nt, c = c_blk + i / N, n = i % N;
      const bool in = i < cb * N && c < W;
      bn[q] = in ? Bm[(cell + c) * b_cs + n] : zero<T>();
      cn[q] = in ? Cm[(cell + c) * c_cs + n] : zero<T>();
    }
  };
  auto stage_row = [&](int buf) {
#pragma unroll
    for (int q = 0; q < QH; ++q) {
      const int i = tid + q * nt;
      if (i < cb * N) {
        float* st = stage + (buf * 2 * cb + i / N) * NS + i % N;
        st[0] = to_f32(bn[q]);
        st[cb * NS] = to_f32(cn[q]);
      }
    }
  };

  float h[R][N];  // from h0 where given: h0 and h_last are [Bs, W, ED, N]
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int c = c_run + k;
    const float* h0k = h0 && ch && c < W ? h0 + (((int64_t)bag * W + c) * ED + e) * N : nullptr;
#pragma unroll
    for (int n = 0; n < N; ++n) h[k][n] = h0k ? h0k[n] : 0.f;
  }

  load_row(0);
  stage_row(0);
  __syncthreads();
  for (int r = 0; r < H; ++r) {
    const int buf = r & 1;
    float xr[R], dtx[R], dr[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      xr[k] = to_f32(xn[k]);
      dr[k] = to_f32(dn[k]);
      dtx[k] = dr[k] * xr[k];
    }
    const float* bs = stage + (buf * 2 * cb + j * R) * NS;
    const float* cs = bs + cb * NS;

    // 1. ā and the run's aggregate per state
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      float pa[VW], pu[VW];
#pragma unroll
      for (int i = 0; i < VW; ++i) {
        pa[i] = 1.f;
        pu[i] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const V bv = *reinterpret_cast<const V*>(bs + k * NS + v * VW);
#pragma unroll
        for (int i = 0; i < VW; ++i) {
          const float ab = expf(dr[k] * an[(v * VW + i) * G + g]);
          pu[i] = fmaf(ab, pu[i], dtx[k] * lane_of(bv, i));
          pa[i] *= ab;
        }
      }
#pragma unroll
      for (int i = 0; i < VW; ++i) {
        run_a[j * RS + (v * VW + i) * G + g] = pa[i];
        run_u[j * RS + (v * VW + i) * G + g] = pu[i];
      }
    }
    __syncthreads();

    // 2. one lane per (channel, state): the block's runs in order, to
    // exclusive prefixes in place, and the block's aggregate; four runs'
    // loads in flight at a time
    for (int i = tid; i < NG; i += nt) {
      float pa = 1.f, pu = 0.f;
      float* ra = run_a + i;
      float* ru = run_u + i;
      int q = 0;
      for (; q + 4 <= P; q += 4) {
        float a4[4], u4[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          a4[t] = ra[(q + t) * RS];
          u4[t] = ru[(q + t) * RS];
        }
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          ra[(q + t) * RS] = pa;
          ru[(q + t) * RS] = pu;
          pu = fmaf(a4[t], pu, u4[t]);
          pa *= a4[t];
        }
      }
      for (; q < P; ++q) {
        const float a = ra[q * RS], u = ru[q * RS];
        ra[q * RS] = pa;
        ru[q * RS] = pu;
        pu = fmaf(a, pu, u);
        pa *= a;
      }
      tot[buf * 2 * NG + i] = pa;
      tot[(buf * 2 + 1) * NG + i] = pu;
    }

    // 3. the carry from the blocks to the left, through distributed shared
    // memory. tot is double-buffered, so one cluster barrier a row
    // suffices; the next row's loads are issued while it completes, and
    // staged before pass 2
    if (S > 1) {
      cluster_arrive();
      if (r + 1 < H) load_row(r + 1);
      cluster_wait();
      cg::cluster_group cluster = cg::this_cluster();
      for (int i = tid; i < NG; i += nt) {
        float ta[MAX_CLUSTER - 1], tu[MAX_CLUSTER - 1];
#pragma unroll
        for (int s = 0; s < MAX_CLUSTER - 1; ++s) {
          if (s < seg) {
            const float* rt = cluster.map_shared_rank(tot, s);
            ta[s] = rt[buf * 2 * NG + i];
            tu[s] = rt[(buf * 2 + 1) * NG + i];
          }
        }
        float carry = 0.f;
#pragma unroll
        for (int s = 0; s < MAX_CLUSTER - 1; ++s)
          if (s < seg) carry = fmaf(ta[s], carry, tu[s]);
        cin[i] = carry;
      }
    } else {
      if (r + 1 < H) load_row(r + 1);
      for (int i = tid; i < NG; i += nt) cin[i] = 0.f;
    }
    __syncthreads();
    if (r + 1 < H) stage_row(buf ^ 1);  // no one reads that half in this row

    // 4. the run again from its carry, ā taken anew: u, h and y
    float yk[R];
#pragma unroll
    for (int k = 0; k < R; ++k) yk[k] = d_skip * xr[k];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      float u[VW];
#pragma unroll
      for (int i = 0; i < VW; ++i) {
        const int o = (v * VW + i) * G + g;
        u[i] = fmaf(run_a[j * RS + o], cin[o], run_u[j * RS + o]);
      }
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const V bv = *reinterpret_cast<const V*>(bs + k * NS + v * VW);
        const V cv = *reinterpret_cast<const V*>(cs + k * NS + v * VW);
#pragma unroll
        for (int i = 0; i < VW; ++i) {
          const int n = v * VW + i;
          const float ab = expf(dr[k] * an[n * G + g]);
          u[i] = fmaf(ab, u[i], dtx[k] * lane_of(bv, i));
          h[k][n] = fmaf(ab, h[k][n], u[i]);
          yk[k] = fmaf(h[k][n], lane_of(cv, i), yk[k]);
        }
      }
    }
    const int64_t cell = row0 + (int64_t)r * W;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int c = c_run + k;
      if (ch && c < W) y[(cell + c) * ED + e] = yk[k];
    }
    __syncthreads();  // the run prefixes and the carry are read; the next row may write them
  }
  if (h_last) {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int c = c_run + k;
      if (ch && c < W) {
        float* hl = h_last + (((int64_t)bag * W + c) * ED + e) * N;
#pragma unroll
        for (int n = 0; n < N; ++n) hl[n] = h[k][n];
      }
    }
  }
  // no block leaves while another may still read its tot
  if (S > 1) cg::this_cluster().sync();
}

// Rows wider than the cluster kernel holds: a runtime number of chunks nk
// of MAX_THREADS columns. Chunks k < MAX_CHUNKS keep h in registers; the h
// of chunk k ≥ MAX_CHUNKS is hx[((k − MAX_CHUNKS)·N + n)·nt + tid], in
// dynamic shared memory, or in hx_global at this block's offset when the
// caller passes one. grid (ED, Bs), blockDim.x = MAX_THREADS.
template <typename T, int N>
__global__ void __launch_bounds__(MAX_THREADS)
scan2d_wide_kernel(const T* __restrict__ x, const T* __restrict__ delta,
                   const T* __restrict__ Bm, int64_t b_cs, const T* __restrict__ Cm, int64_t c_cs,
                   const float* __restrict__ A_log, const float* __restrict__ Dv,
                   float* __restrict__ y, const float* __restrict__ h0, float* __restrict__ h_last,
                   int H, int W, int ED, float* __restrict__ hx_global) {
  extern __shared__ float hx_shared[];
  __shared__ float tot_a[2][MAX_WARPS][N], tot_b[2][MAX_WARPS][N];
  __shared__ float carry[2][N];
  __shared__ float a_neg[N];
  const int e = blockIdx.x, bag = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nt = blockDim.x;
  const int nk = (W + nt - 1) / nt;
  const int64_t nx = (int64_t)(nk - MAX_CHUNKS) * N * nt;
  float* hx = hx_global ? hx_global + ((int64_t)bag * ED + e) * nx : hx_shared;
  auto state_at = [&](auto* hs, int c) {  // column c's N states of h0 or h_last
    return hs + (((int64_t)bag * W + c) * ED + e) * N;
  };
  for (int64_t i = tid; i < nx; i += nt) {  // this thread's own entries, from h0 where given
    const int64_t m = i / nt;
    const int c = (MAX_CHUNKS + (int)(m / N)) * nt + tid;
    hx[i] = h0 && c < W ? state_at(h0, c)[m % N] : 0.f;
  }
  if (tid < N) a_neg[tid] = -expf(A_log[(int64_t)e * N + tid]);
  __syncthreads();
  const float d_skip = Dv[e];

  float hr[MAX_CHUNKS][N];
#pragma unroll
  for (int k = 0; k < MAX_CHUNKS; ++k) {
    const int c = k * nt + tid;
#pragma unroll
    for (int n = 0; n < N; ++n) hr[k][n] = h0 && c < W ? state_at(h0, c)[n] : 0.f;
  }

  int buf = 0;
  for (int r = 0; r < H; ++r) {
    for (int k = 0; k < nk; ++k) {
      const int c = k * nt + tid;
      const bool in = c < W;
      const int64_t cell = ((int64_t)bag * H + r) * W + c;
      float* hk = hx + (int64_t)(k - MAX_CHUNKS) * N * nt + tid;  // used for k >= MAX_CHUNKS
      float h[N];
#pragma unroll
      for (int n = 0; n < N; ++n) h[n] = k == 0 ? hr[0][n] : k == 1 ? hr[1][n] : hk[n * nt];
      float xv = 0.f, dt = 0.f;
      if (in) {
        xv = to_f32(x[cell * ED + e]);
        dt = to_f32(delta[cell * ED + e]);
      }
      const float dtx = dt * xv;
      float abar[N], pa[N], pb[N];
#pragma unroll
      for (int n = 0; n < N; ++n) {
        abar[n] = in ? expf(dt * a_neg[n]) : 1.f;
        pa[n] = abar[n];
        pb[n] = in ? dtx * to_f32(Bm[cell * b_cs + n]) : 0.f;
      }
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float ua = __shfl_up_sync(0xffffffffu, pa[n], off);
          const float ub = __shfl_up_sync(0xffffffffu, pb[n], off);
          if (lane >= off) {
            pb[n] = fmaf(pa[n], ub, pb[n]);
            pa[n] *= ua;
          }
        }
      }
      if (lane == 31) {
#pragma unroll
        for (int n = 0; n < N; ++n) {
          tot_a[buf][warp][n] = pa[n];
          tot_b[buf][warp][n] = pb[n];
        }
      }
      __syncthreads();
      float v[N];
#pragma unroll
      for (int n = 0; n < N; ++n) v[n] = k > 0 ? carry[buf ^ 1][n] : 0.f;
      for (int w = 0; w < warp; ++w) {
#pragma unroll
        for (int n = 0; n < N; ++n) v[n] = fmaf(tot_a[buf][w][n], v[n], tot_b[buf][w][n]);
      }
      float acc = d_skip * xv;
      const bool last = in && (c == W - 1 || tid == nt - 1);
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float u = fmaf(pa[n], v[n], pb[n]);
        h[n] = fmaf(abar[n], h[n], u);
        if (in) acc = fmaf(h[n], to_f32(Cm[cell * c_cs + n]), acc);
        if (last) carry[buf][n] = u;
      }
      if (in) y[cell * ED + e] = acc;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        if (k == 0) hr[0][n] = h[n];
        else if (k == 1) hr[1][n] = h[n];
        else hk[n * nt] = h[n];
      }
      buf ^= 1;
    }
  }
  if (h_last) {
    for (int k = 0; k < nk; ++k) {
      const int c = k * nt + tid;
      if (c >= W) continue;
      float* hl = state_at(h_last, c);
      const float* hk = hx + (int64_t)(k - MAX_CHUNKS) * N * nt + tid;
#pragma unroll
      for (int n = 0; n < N; ++n) hl[n] = k == 0 ? hr[0][n] : k == 1 ? hr[1][n] : hk[n * nt];
    }
  }
}

// Bytes of dynamic shared memory a block of the wide kernel can take on the
// current device, or −1 on a CUDA error.
template <int N>
int64_t wide_shared_room() {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, scan2d_wide_kernel<float, N>) != cudaSuccess)
    return -1;
  return (int64_t)optin - (int64_t)attr.sharedSizeBytes;
}

// Floats of h per (bag, channel) beyond the register chunks of a row W wide.
int64_t wide_floats(int W, int N) {
  const int nk = (W + MAX_THREADS - 1) / MAX_THREADS;
  return nk > MAX_CHUNKS ? (int64_t)(nk - MAX_CHUNKS) * N * MAX_THREADS : 0;
}

template <typename T, int N>
int launch_wide(const void* x, const void* delta, const void* Bm, int64_t b_cs, const void* Cm,
                int64_t c_cs, const float* A_log, const float* Dv, float* y, const float* h0,
                float* h_last, float* scratch, int Bs, int H, int W, int ED, cudaStream_t st) {
  const size_t smem = scratch ? 0 : (size_t)wide_floats(W, N) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      scan2d_wide_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  scan2d_wide_kernel<T, N><<<dim3(ED, Bs), MAX_THREADS, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(delta), static_cast<const T*>(Bm), b_cs,
      static_cast<const T*>(Cm), c_cs, A_log, Dv, y, h0, h_last, H, W, ED, scratch);
  return (int)cudaGetLastError();
}


// the launch configuration of a cluster kernel: blocks of G·P threads in
// clusters of S, and its dynamic shared memory allowed
template <typename T, int N, int G>
cudaError_t cluster_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr, int S, int P) {
  const size_t smem = (size_t)cluster_floats<N, G>(P) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(scan2d_cluster_kernel<T, N, G>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cfg = {};
  cfg.blockDim = dim3(G * P);
  cfg.dynamicSmemBytes = smem;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return err;
}

template <int G>
bool valid_layout(int S, int P, int W) {
  return S >= 1 && S <= MAX_CLUSTER && P >= 1 && G * P <= block_max<G>() && (G * P) % 32 == 0 &&
         (int64_t)S * P * RUN >= W && (int64_t)(S - 1) * P * RUN < W;
}

template <typename T, int N, int G>
int launch_cluster(const void* x, const void* delta, const void* Bm, int64_t b_cs, const void* Cm,
                   int64_t c_cs, const float* A_log, const float* Dv, float* y, const float* h0,
                   float* h_last, int Bs, int H, int W, int ED, int S, int P, cudaStream_t st) {
  if (!valid_layout<G>(S, P, W)) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = cluster_config<T, N, G>(cfg, attr, S, P);
  if (err != cudaSuccess) return (int)err;
  cfg.gridDim = dim3((ED + G - 1) / G * S, Bs);
  cfg.stream = st;
  err = cudaLaunchKernelEx(&cfg, scan2d_cluster_kernel<T, N, G>, static_cast<const T*>(x),
                           static_cast<const T*>(delta), static_cast<const T*>(Bm), b_cs,
                           static_cast<const T*>(Cm), c_cs, A_log, Dv, y, h0, h_last, H, W, ED, S,
                           P);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Calls f(std::integral_constant<int, G>) for a G the cluster kernel is
// built for: 8 and 4 channels (16 with bf16), so that a block can hold more
// runs of a wide row. 0 on any other G. (2 channels would hold rows up to
// 1,536 columns, but stage 48 B and C values a thread: it spilled, and ran
// 29% slower than the wide kernel at 1,500 columns.)
template <typename T, typename F>
int with_group(int G, F&& f) {
  switch (G) {
    case 16:
      if constexpr (sizeof(T) == 2) return f(std::integral_constant<int, 16>{});
      return 0;
    case 8: return f(std::integral_constant<int, 8>{});
    case 4: return f(std::integral_constant<int, 4>{});
    default: return 0;
  }
}

template <typename T, int N>
int by_group(const void* x, const void* delta, const void* Bm, int64_t b_cs, const void* Cm,
             int64_t c_cs, const float* A_log, const float* Dv, float* y, const float* h0,
             float* h_last, float* scratch, int Bs, int H, int W, int ED, int G, int S, int P,
             cudaStream_t st) {
  if (S == 0)
    return launch_wide<T, N>(x, delta, Bm, b_cs, Cm, c_cs, A_log, Dv, y, h0, h_last, scratch, Bs, H,
                             W, ED, st);
  int err = (int)cudaErrorInvalidValue;
  with_group<T>(G, [&](auto g) {
    err = launch_cluster<T, N, decltype(g)::value>(x, delta, Bm, b_cs, Cm, c_cs, A_log, Dv, y, h0,
                                                   h_last, Bs, H, W, ED, S, P, st);
    return 0;
  });
  return err;
}

template <typename T>
int by_state(const void* x, const void* delta, const void* Bm, int64_t b_cs, const void* Cm,
             int64_t c_cs, const float* A_log, const float* Dv, float* y, const float* h0,
             float* h_last, float* scratch, int Bs, int H, int W, int ED, int N, int G, int S,
             int P, cudaStream_t st) {
#define MHIM_SCAN2D_STATE(n)                                                                      \
  case n:                                                                                         \
    return by_group<T, n>(x, delta, Bm, b_cs, Cm, c_cs, A_log, Dv, y, h0, h_last, scratch, Bs, H, \
                          W, ED, G, S, P, st);
  switch (N) {
    MHIM_SCAN2D_STATE(2)
    MHIM_SCAN2D_STATE(4)
    MHIM_SCAN2D_STATE(8)
    MHIM_SCAN2D_STATE(16)
    default: return (int)cudaErrorInvalidValue;
  }
#undef MHIM_SCAN2D_STATE
}

}  // namespace

// Floats of global scratch per (bag, channel) that the wide kernel needs
// for rows W wide at state size N: 0 when h fits in registers (W ≤ 1,024)
// or in the block's shared memory on the current device; −1 on a bad N or
// a CUDA error.
extern "C" int scan2d_scratch(int W, int N) {
  int64_t room;
  switch (N) {
    case 2: room = wide_shared_room<2>(); break;
    case 4: room = wide_shared_room<4>(); break;
    case 8: room = wide_shared_room<8>(); break;
    case 16: room = wide_shared_room<16>(); break;
    default: return -1;
  }
  if (room < 0) return -1;
  const int64_t floats = wide_floats(W, N);
  return floats * (int64_t)sizeof(float) <= room ? 0 : (int)floats;
}

// x, delta[Bs, H, W, ED] contiguous; B[Bs, H, W, N] and C with a cell
// stride of b_cs / c_cs elements and a unit stride along N; all four fp32
// (bf16 = 0) or bf16 (1). A_log[ED, N] and D[ED] fp32, contiguous. Writes
// y[Bs, H, W, ED] fp32. N ∈ {2, 4, 8, 16}. The plan: S ≥ 1 runs the cluster
// kernel with clusters of S blocks of G channels and P runs of 3 columns
// each (S·P·3 ≥ W, no empty block; G 8 or 4, or 16 for bf16; G·P a
// multiple of 32, at most 128, or 192 at G 4); S = 0 runs the wide kernel,
// with scratch null or Bs · ED · scan2d_scratch(W, N) fp32 on the card for
// the h of its chunks. An invalid plan returns cudaErrorInvalidValue. The
// scan starts from zero and keeps no state.
extern "C" int scan2d(const void* x, const void* delta, const void* Bm, int64_t b_cs,
                      const void* Cm, int64_t c_cs, int bf16, const float* A_log,
                      const float* Dv, float* y, float* scratch, int Bs, int H, int W, int ED,
                      int N, int G, int S, int P, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (W < 1 || H < 1) return (int)cudaErrorInvalidValue;
  if (bf16)
    return by_state<__nv_bfloat16>(x, delta, Bm, b_cs, Cm, c_cs, A_log, Dv, y, nullptr, nullptr,
                                   scratch, Bs, H, W, ED, N, G, S, P, st);
  return by_state<float>(x, delta, Bm, b_cs, Cm, c_cs, A_log, Dv, y, nullptr, nullptr, scratch, Bs,
                         H, W, ED, N, G, S, P, st);
}

// scan2d with a carried state: h0[Bs, W, ED, N] fp32 contiguous, the
// vertical state entering the first row (null: zero), and h_last, the same
// shape, which takes the last row's state (null: not written). h0 and
// h_last must not overlap.
extern "C" int scan2d_carry(const void* x, const void* delta, const void* Bm, int64_t b_cs,
                            const void* Cm, int64_t c_cs, int bf16, const float* A_log,
                            const float* Dv, float* y, const float* h0, float* h_last,
                            float* scratch, int Bs, int H, int W, int ED, int N, int G, int S,
                            int P, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (W < 1 || H < 1) return (int)cudaErrorInvalidValue;
  if (bf16)
    return by_state<__nv_bfloat16>(x, delta, Bm, b_cs, Cm, c_cs, A_log, Dv, y, h0, h_last, scratch,
                                   Bs, H, W, ED, N, G, S, P, st);
  return by_state<float>(x, delta, Bm, b_cs, Cm, c_cs, A_log, Dv, y, h0, h_last, scratch, Bs, H, W,
                         ED, N, G, S, P, st);
}
