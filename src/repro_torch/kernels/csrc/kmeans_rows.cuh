// Distance code shared by the KMeans-DRE kernels: the filter's estimation
// step (kmeans_dist.cu, B2) and the wide route of the Lloyd step
// (lloyd_step.cu, B1), each built into a library of its own.
//
// * The reference's semantics on non-finite values. The matmul-form d2 is
//   clamped by clamp0 (jnp.maximum(v, 0) keeps a NaN; fmaxf would return
//   the 0), and a row's minimum is NaN when any of its d2 is (jnp.min),
//   its argmin the first NaN's index (jnp.argmin, torch.argmin), else the
//   first index of the minimum: see take_min.
// * wide_rows_kernel, for rows wider than the narrow routes take: lanes
//   over features, a warp RW rows at once, KT centroids a pass. The
//   centroids' features are staged FC at a time in shared memory, in
//   feature order, two stages in flight (the next stage's rows and
//   centroids are loaded into registers while this one is computed), one
//   barrier a stage. Each lane sums x2, x.c and c2 over its features and
//   the warp adds the lanes in a butterfly (every lane gets the same bits),
//   so the centroid norms are computed in the same pass as the cross terms
//   and in parallel over the lanes. Fixed orders throughout: two launches
//   on the same inputs give the same bits. The epilogue is the caller's.
#pragma once

#include <cuda_runtime.h>

namespace kmeans_rows {

constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;

// max(v, 0) that keeps a NaN, as jnp.maximum does (fmaxf would return
// the 0): one instruction, like fmaxf
__device__ __forceinline__ float clamp0(float v) {
  float r;
  asm("max.NaN.f32 %0, %1, 0f00000000;" : "=f"(r) : "f"(v));
  return r;
}

// min(a, b) that keeps a NaN, as jnp.min does
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

constexpr float INF = __builtin_huge_valf();

// The running minimum of a row's d2 over centroids j = 0, 1, ..., from
// best = INF and bj = 0: the first NaN wins and stays, else the first
// index of the minimum (a row of infinite d2 keeps index 0).
__device__ __forceinline__ void take_min(float d2, int j, float& best,
                                         int& bj) {
  if (d2 < best || (d2 != d2 && best == best)) {
    best = d2;
    bj = j;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 1; off < WARP; off <<= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

constexpr int W_WARPS = 8;
constexpr int W_THREADS = W_WARPS * WARP;
constexpr int W_RW = 2;                   // rows a warp takes at once
constexpr int W_ROWS = W_WARPS * W_RW;    // rows a block
constexpr int W_FC = 256;                 // features a stage
constexpr int W_U = W_FC / WARP;          // features a lane a stage

// Rows of x (C, n, d) against centroids (C, k, d), for any d: calls
// out(row index into (C, n), min d2, its argmin) once a row. Client c's
// rows start x_cs floats after client c - 1's (0: one x for every
// client), its centroids c_cs floats after.
template <int KT, class Out>
__global__ void __launch_bounds__(W_THREADS)
    wide_rows_kernel(const float* __restrict__ x,
                     const float* __restrict__ cents, int n, int d, int k,
                     size_t x_cs, size_t c_cs, const Out out_arg) {
  constexpr int CU = KT * W_FC / W_THREADS;  // stage floats a thread
  __shared__ float s_c[2][KT][W_FC];
  Out out = out_arg;
  out.begin();  // the epilogue's own loads, issued first
  const int client = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % WARP;
  const int warp = tid / WARP;
  const int r0 = blockIdx.x * W_ROWS + warp * W_RW;
  const float* xc = x + client * x_cs;
  const float* cc = cents + client * c_cs;
  // rows past n read the last row; their results are dropped
  const float* xr[W_RW];
#pragma unroll
  for (int q = 0; q < W_RW; ++q)
    xr[q] = xc + static_cast<size_t>(min(r0 + q, n - 1)) * d;

  const int chunks = (d + W_FC - 1) / W_FC;
  const int tiles = (k + KT - 1) / KT;
  const int stages = tiles * chunks;
  float xn[W_RW][W_U];   // the next stage's row features
  float cn[CU];          // and this thread's part of its centroid stage
  auto fetch = [&](int s) {
    const int j0 = (s / chunks) * KT;
    const int f0 = (s % chunks) * W_FC;
#pragma unroll
    for (int q = 0; q < W_RW; ++q)
#pragma unroll
      for (int u = 0; u < W_U; ++u) {
        const int f = f0 + lane + WARP * u;
        xn[q][u] = f < d ? __ldg(xr[q] + f) : 0.f;
      }
#pragma unroll
    for (int u = 0; u < CU; ++u) {
      const int idx = tid + W_THREADS * u;
      const int j = j0 + idx / W_FC;
      const int f = f0 + idx % W_FC;
      cn[u] = (j < k && f < d) ? __ldg(cc + static_cast<size_t>(j) * d + f)
                               : 0.f;
    }
  };

  float best[W_RW];
  int bj[W_RW];
  float x2[W_RW];
  float cross[W_RW][KT];
  float c2[KT];
#pragma unroll
  for (int q = 0; q < W_RW; ++q) {
    best[q] = INF;
    bj[q] = 0;
    x2[q] = 0.f;
  }
  fetch(0);
  // keeps each fetch's loads where they are written: issued before the
  // stage's computation, not sunk to their first use in the next stage
  asm volatile("" ::: "memory");
  for (int s = 0; s < stages; ++s) {
    const int buf = s & 1;
    const int j0 = (s / chunks) * KT;
    const bool first_chunk = s % chunks == 0;
    if (first_chunk) {
#pragma unroll
      for (int jj = 0; jj < KT; ++jj) {
        c2[jj] = 0.f;
#pragma unroll
        for (int q = 0; q < W_RW; ++q) cross[q][jj] = 0.f;
      }
    }
    float xv[W_RW][W_U];
#pragma unroll
    for (int q = 0; q < W_RW; ++q)
#pragma unroll
      for (int u = 0; u < W_U; ++u) xv[q][u] = xn[q][u];
#pragma unroll
    for (int u = 0; u < CU; ++u) {
      const int idx = tid + W_THREADS * u;
      s_c[buf][idx / W_FC][idx % W_FC] = cn[u];
    }
    // this buffer's last readers (stage s - 2) passed the barrier of
    // stage s - 1 before this thread did
    __syncthreads();
    if (s + 1 < stages) fetch(s + 1);
    asm volatile("" ::: "memory");
#pragma unroll
    for (int u = 0; u < W_U; ++u) {
      const int fl = lane + WARP * u;
      if (j0 == 0) {
#pragma unroll
        for (int q = 0; q < W_RW; ++q)
          x2[q] = fmaf(xv[q][u], xv[q][u], x2[q]);
      }
#pragma unroll
      for (int jj = 0; jj < KT; ++jj) {
        const float cv = s_c[buf][jj][fl];
        c2[jj] = fmaf(cv, cv, c2[jj]);
#pragma unroll
        for (int q = 0; q < W_RW; ++q)
          cross[q][jj] = fmaf(xv[q][u], cv, cross[q][jj]);
      }
    }
    if ((s + 1) % chunks == 0) {  // the tile's last stage: its distances
      if (j0 == 0) {
#pragma unroll
        for (int q = 0; q < W_RW; ++q) x2[q] = warp_sum(x2[q]);
      }
#pragma unroll
      for (int jj = 0; jj < KT; ++jj) {
        c2[jj] = warp_sum(c2[jj]);
#pragma unroll
        for (int q = 0; q < W_RW; ++q) cross[q][jj] = warp_sum(cross[q][jj]);
      }
#pragma unroll
      for (int jj = 0; jj < KT; ++jj) {
        if (j0 + jj >= k) break;
#pragma unroll
        for (int q = 0; q < W_RW; ++q)
          take_min(clamp0(x2[q] - 2.f * cross[q][jj] + c2[jj]), j0 + jj,
                   best[q], bj[q]);
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < W_RW; ++q)
      if (r0 + q < n)
        out(static_cast<size_t>(client) * n + r0 + q, best[q], bj[q]);
  }
}

// Blocks a wide launch needs along its rows.
inline int wide_blocks(int n) { return (n + W_ROWS - 1) / W_ROWS; }

}  // namespace kmeans_rows
