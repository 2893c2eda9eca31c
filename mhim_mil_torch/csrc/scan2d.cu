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
// registers); y is fp32. Ā, B̄x, u and h never touch device memory.
//
// Bound at the BLCA grid (Bs 1, H 275, W 381, ED 256, N 16, fp32): x, Δ and
// y move 107 MB each and B, C 6.7 MB each, 335 MB or 0.10 ms at 3.35 TB/s;
// the 0.43 G exponentials take 0.10 ms on the special-function units, and
// the FMAs 0.06 ms. Known cost of this first design, not fixed yet: the
// threads of a block read x[b, r, c, e] at a stride of ED elements, so each
// 4-byte load pulls a 32-byte sector and x, Δ and y move about 8× their
// bytes between L2 and the SMs; B and C are read once per channel, from L2.
//
// Design. On the TPU the rows are the sequential grid axis and the previous
// row's h is carried in VMEM scratch. Here blocks run in parallel and in no
// order, so the row loop lives inside a block: one block per (bag, channel),
// one thread per column (at most MAX_THREADS; wider rows are walked in K
// chunks of the block's width, the scan carried from one chunk into the
// next). For rows of up to MAX_CHUNKS chunks a thread keeps its columns'
// h[N] in registers, so the vertical step never leaves the thread. Wider
// rows take scan2d_wide_kernel: each thread walks ceil(W / 512) columns,
// the first MAX_CHUNKS with h in registers and the rest with h in dynamic
// shared memory where it fits the block, else in a global scratch buffer
// that the caller allocates (scan2d_scratch says how large); either way
// laid out [chunk, n, thread], so each thread owns its entries. Each row is one block-wide inclusive scan
// of the (ā, b̄x) pairs for all N states at once: __shfl_up_sync within a
// warp, then each thread folds the totals of the warps before it (and the
// carry of the previous chunk) from shared memory, double-buffered so that
// one __syncthreads per row and chunk suffices. exp(A_log) is taken once
// per block; expf is the accurate one. Plain C interface, loaded with
// ctypes; the entry returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 512;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int MAX_CHUNKS = 2;  // chunks whose h lives in registers

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// grid (ED, Bs); blockDim.x = nt, a multiple of 32; thread t owns the
// columns t + k·nt, k < K.
template <typename T, int N, int K>
__global__ void __launch_bounds__(MAX_THREADS)
scan2d_kernel(const T* __restrict__ x, const T* __restrict__ delta,
              const T* __restrict__ Bm, int64_t b_cs, const T* __restrict__ Cm, int64_t c_cs,
              const float* __restrict__ A_log, const float* __restrict__ Dv,
              float* __restrict__ y, int H, int W, int ED) {
  __shared__ float tot_a[2][MAX_WARPS][N], tot_b[2][MAX_WARPS][N];  // warp totals
  __shared__ float carry[2][N];  // u at the last column of the previous chunk
  __shared__ float a_neg[N];
  const int e = blockIdx.x, bag = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nt = blockDim.x;
  if (tid < N) a_neg[tid] = -expf(A_log[(int64_t)e * N + tid]);
  __syncthreads();
  const float d_skip = Dv[e];

  float h[K][N];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int n = 0; n < N; ++n) h[k][n] = 0.f;

  int buf = 0;
  for (int r = 0; r < H; ++r) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c0 = k * nt;
      if (c0 >= W) break;  // block-uniform
      const int c = c0 + tid;
      const bool in = c < W;
      const int64_t cell = ((int64_t)bag * H + r) * W + c;
      float xv = 0.f, dt = 0.f;
      if (in) {
        xv = to_f32(x[cell * ED + e]);
        dt = to_f32(delta[cell * ED + e]);
      }
      const float dtx = dt * xv;
      // pa, pb: this cell's (ā, b̄x), then the warp's inclusive scan of them
      float abar[N], pa[N], pb[N];
#pragma unroll
      for (int n = 0; n < N; ++n) {
        abar[n] = in ? expf(dt * a_neg[n]) : 1.f;
        pa[n] = abar[n];
        pb[n] = in ? dtx * to_f32(Bm[cell * b_cs + n]) : 0.f;  // identity on idle lanes
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
      // v: the scan's value just left of this warp, from the previous
      // chunk's carry through the totals of the warps before this one
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
        h[k][n] = fmaf(abar[n], h[k][n], u);
        if (in) acc = fmaf(h[k][n], to_f32(Cm[cell * c_cs + n]), acc);
        if (K > 1 && last) carry[buf][n] = u;
      }
      if (in) y[cell * ED + e] = acc;
      buf ^= 1;
    }
  }
}

// Rows wider than MAX_CHUNKS · MAX_THREADS: the body of scan2d_kernel with
// a runtime number of chunks nk. Chunks k < MAX_CHUNKS keep h in registers;
// the h of chunk k ≥ MAX_CHUNKS is hx[((k − MAX_CHUNKS)·N + n)·nt + tid], in
// dynamic shared memory, or in hx_global at this block's offset when the
// caller passes one. blockDim.x = MAX_THREADS.
template <typename T, int N>
__global__ void __launch_bounds__(MAX_THREADS)
scan2d_wide_kernel(const T* __restrict__ x, const T* __restrict__ delta,
                   const T* __restrict__ Bm, int64_t b_cs, const T* __restrict__ Cm, int64_t c_cs,
                   const float* __restrict__ A_log, const float* __restrict__ Dv,
                   float* __restrict__ y, int H, int W, int ED, float* __restrict__ hx_global) {
  extern __shared__ float hx_shared[];
  __shared__ float tot_a[2][MAX_WARPS][N], tot_b[2][MAX_WARPS][N];
  __shared__ float carry[2][N];
  __shared__ float a_neg[N];
  const int e = blockIdx.x, bag = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nt = blockDim.x;
  const int nk = (W + nt - 1) / nt;
  const int64_t nx = (int64_t)(nk - MAX_CHUNKS) * N * nt;
  float* hx = hx_global ? hx_global + ((int64_t)bag * ED + e) * nx : hx_shared;
  for (int64_t i = tid; i < nx; i += nt) hx[i] = 0.f;  // this thread's own entries
  if (tid < N) a_neg[tid] = -expf(A_log[(int64_t)e * N + tid]);
  __syncthreads();
  const float d_skip = Dv[e];

  float hr[MAX_CHUNKS][N];
#pragma unroll
  for (int k = 0; k < MAX_CHUNKS; ++k)
#pragma unroll
    for (int n = 0; n < N; ++n) hr[k][n] = 0.f;

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
                int64_t c_cs, const float* A_log, const float* Dv, float* y, float* scratch, int Bs,
                int H, int W, int ED, cudaStream_t st) {
  const size_t smem = scratch ? 0 : (size_t)wide_floats(W, N) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      scan2d_wide_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  scan2d_wide_kernel<T, N><<<dim3(ED, Bs), MAX_THREADS, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(delta), static_cast<const T*>(Bm), b_cs,
      static_cast<const T*>(Cm), c_cs, A_log, Dv, y, H, W, ED, scratch);
  return (int)cudaGetLastError();
}

template <typename T, int N, int K>
int launch(const void* x, const void* delta, const void* Bm, int64_t b_cs, const void* Cm,
           int64_t c_cs, const float* A_log, const float* Dv, float* y, int Bs, int H, int W,
           int ED, cudaStream_t st) {
  const int nt = 32 * ((min(W, MAX_THREADS) + 31) / 32);
  scan2d_kernel<T, N, K><<<dim3(ED, Bs), nt, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(delta), static_cast<const T*>(Bm), b_cs,
      static_cast<const T*>(Cm), c_cs, A_log, Dv, y, H, W, ED);
  return (int)cudaGetLastError();
}

template <typename T, int N>
int by_chunks(const void* x, const void* delta, const void* Bm, int64_t b_cs, const void* Cm,
              int64_t c_cs, const float* A_log, const float* Dv, float* y, float* scratch, int Bs,
              int H, int W, int ED, cudaStream_t st) {
  if (W <= MAX_THREADS)
    return launch<T, N, 1>(x, delta, Bm, b_cs, Cm, c_cs, A_log, Dv, y, Bs, H, W, ED, st);
  if (W <= MAX_CHUNKS * MAX_THREADS)
    return launch<T, N, MAX_CHUNKS>(x, delta, Bm, b_cs, Cm, c_cs, A_log, Dv, y, Bs, H, W, ED, st);
  return launch_wide<T, N>(x, delta, Bm, b_cs, Cm, c_cs, A_log, Dv, y, scratch, Bs, H, W, ED, st);
}

template <typename T>
int by_state(const void* x, const void* delta, const void* Bm, int64_t b_cs, const void* Cm,
             int64_t c_cs, const float* A_log, const float* Dv, float* y, float* scratch, int Bs,
             int H, int W, int ED, int N, cudaStream_t st) {
  switch (N) {
    case 2: return by_chunks<T, 2>(x, delta, Bm, b_cs, Cm, c_cs, A_log, Dv, y, scratch, Bs, H, W, ED, st);
    case 4: return by_chunks<T, 4>(x, delta, Bm, b_cs, Cm, c_cs, A_log, Dv, y, scratch, Bs, H, W, ED, st);
    case 8: return by_chunks<T, 8>(x, delta, Bm, b_cs, Cm, c_cs, A_log, Dv, y, scratch, Bs, H, W, ED, st);
    case 16: return by_chunks<T, 16>(x, delta, Bm, b_cs, Cm, c_cs, A_log, Dv, y, scratch, Bs, H, W, ED, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Floats of global scratch per (bag, channel) that scan2d needs for rows W
// wide at state size N: 0 when h fits in registers (W ≤ 1,024) or in the
// block's shared memory on the current device; −1 on a bad N or a CUDA error.
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
// y[Bs, H, W, ED] fp32. N ∈ {2, 4, 8, 16}, any W ≥ 1. scratch is null, or
// Bs · ED · scan2d_scratch(W, N) fp32 on the card for the wide path's h.
extern "C" int scan2d(const void* x, const void* delta, const void* Bm, int64_t b_cs,
                      const void* Cm, int64_t c_cs, int bf16, const float* A_log,
                      const float* Dv, float* y, float* scratch, int Bs, int H, int W, int ED,
                      int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (W < 1 || H < 1) return (int)cudaErrorInvalidValue;
  if (bf16)
    return by_state<__nv_bfloat16>(x, delta, Bm, b_cs, Cm, c_cs, A_log, Dv, y, scratch, Bs, H, W,
                                   ED, N, st);
  return by_state<float>(x, delta, Bm, b_cs, Cm, c_cs, A_log, Dv, y, scratch, Bs, H, W, ED, N, st);
}
