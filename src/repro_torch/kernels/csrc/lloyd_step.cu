// One Lloyd iteration of the KMeans-DRE fit, for C clients at once.
//
// Replaces: src/repro/kernels/kmeans_dist/kernel.py, lloyd_step_pallas
// (body _lloyd_kernel): matmul-form squared distances of every row of
// x (C, n, d) to its client's centroids (C, k, d), the first-index argmin,
// the min distance, and the per-centroid sums (C, k, d) and counts (C, k).
//
// What bounds it on an H100: latency, not bytes or arithmetic. The main
// path runs C = 1, n ~ 6000, d = 50, k <= 10: one pass over n*d*4 bytes
// (~1.2 MB, 0.37 us at 3.35 TB/s) and ~2*n*k*d flops. What the card can
// not hide is the chain launch -> load -> distances -> block sums ->
// cross-block sum, each link an L2 round trip or a barrier, so the design
// keeps the chain to one launch and each link short.
//
// Design.
//  * One launch. Blocks run in parallel and in no order (the TPU kernel's
//    sequential grid axis carried the sums in resident output blocks), so
//    each block writes its partial sums and counts to scratch and takes an
//    integer ticket; the last block of a client to finish, told by the
//    ticket, sums the partials in block order and resets the ticket. No
//    float atomics: two launches on the same inputs give the same bits.
//  * A grid that fills the card: a client's rows are cut into one block
//    per SM, or fewer, longer blocks where the last block's sum would read
//    more than a budget of partials, and at least 64 rows a block. The
//    cut depends on the client's shape only, never on C, so each client's
//    sums are added in the same order, and come out in the same bits, as
//    in a launch for it alone (the cohort engine's fit equals the loop
//    engine's); C clients make C times the blocks.
//  * 16-byte loads: a block's rows are one contiguous range of x, staged
//    in shared memory by float4 loads, several in flight a thread.
//  * Distances for k <= 16: lanes over rows, warps over feature slices.
//    Each lane sums x2 and x.c for every centroid over its slice (the
//    transposed centroids read as broadcasts, no shuffles); the slices'
//    sums meet in shared memory and the first slice's lanes add them in
//    slice order and take the first-index argmin.
//  * Distances for k > 16: lanes over centroids (k/32 each), a warp 4 rows
//    at once over all features, a register tile of 4 rows x k/32
//    centroids per pair of shared loads, then a butterfly argmin.
//  * Sums: every warp adds its rows to its own slab in shared memory, rows
//    in order (for k <= 4 in registers); the slabs are added in warp
//    order. All in IEEE fp32 in the reference's form max(x2 - 2 x.c + c2,
//    0). Rows >= n are masked inside the kernel (no padding copy); the
//    wrapper allocates every output and the scratch.
//  * Non-finite values as in the reference (kmeans_rows.cuh): a NaN d2
//    stays NaN through the clamp and the minimum, and the argmin is the
//    first NaN's index. The reference sums by a one-hot product, which adds
//    0 * x to every centroid a row is not assigned to: a NaN or infinite
//    feature makes that feature's sums NaN for every other centroid, here
//    too (poison_others, in a pass of its own after a block's sums, only
//    where a row had one; the wide route's sums pass notes the centroids
//    of such rows as it goes).
//  * The narrow route above takes d <= 64 and k <= 64 (the feature and
//    token paths: d = 50 or 16, k <= 32), in one launch.
//  * The wide route, 64 < d <= 4096 and k <= 64 (flattened images: 784 or
//    3072 wide), in two launches: the assignment pass is the estimation
//    step's distance code (kmeans_rows.cuh, lanes over features, centroid
//    features staged in shared memory), which writes assign and min_d2;
//    then a block per (32-feature slice, row group, client) walks its rows
//    in 8 contiguous segments, a warp each, adding each row's slice into
//    its centroid's sums in shared memory, rows in order; the segments'
//    sums are added in segment order, and the groups' by the last block to
//    finish, told by an integer ticket. No float atomics on either route:
//    two launches on the same inputs give the same bits.
//  * The launcher returns cudaErrorInvalidValue beyond d = 4096 or k = 64.
#include <cuda_runtime.h>

#include <cstdint>

#include "kmeans_rows.cuh"

namespace {

constexpr int WARP = 32;
constexpr int MAX_D = 64;              // the narrow route's widest row
constexpr int WIDE_MAX_D = 4096;
constexpr int MAX_K = 64;
constexpr int STAGE_ROWS = 128;         // rows of x in shared memory at once
constexpr int MIN_BLOCK_ROWS = 64;      // fewest rows a block takes (n allowing)
// partials the last block may sum: the split path is latency-bound, so
// fewer, longer blocks pay there; the lane path's rows cost more
constexpr int REDUCE_FLOATS_SPLIT = 32768;
constexpr int REDUCE_FLOATS_LANES = 131072;
constexpr int CHUNK = 8;                // float4 partials in flight a thread
constexpr int MAX_SLICES = 64;          // runs of blocks an output is cut in
constexpr int RW = 4;                   // rows a warp takes at once
constexpr int BATCH = 4;                // float4 rows of x in flight a thread
constexpr int MAX_DEVICES = 64;
constexpr unsigned FULL = 0xffffffffu;

// k <= SPLIT_K: lanes over rows, warps over feature slices; above it,
// lanes over centroids
constexpr int SPLIT_K = 16;
constexpr int GROUPS = STAGE_ROWS / WARP;   // row groups of the split path

// warps a block: 16, or 8 where their slabs of sums would not fit in
// shared memory (k > 32)
template <int KP>
__host__ __device__ constexpr int warps_for() { return KP > 32 ? 8 : 16; }

// k*d + k sums and counts, padded to whole float4s
__host__ __device__ __forceinline__ int pitch(int d, int k) {
  return (k * d + k + 3) / 4 * 4;
}

// Shared memory (floats): the staged rows (STAGE_ROWS, d), the transposed
// centroids (d, kp), their norms (kp), then from a 16-byte boundary one
// (pitch,) slab of sums and counts per warp; on the split path then each
// slice's partial x2 and x.c (slices, STAGE_ROWS, kp + 1) and the rows'
// assignments (STAGE_ROWS,).
__host__ __device__ __forceinline__ int slab_offset(int d, int kp) {
  return (STAGE_ROWS * d + d * kp + kp + 3) / 4 * 4;
}

__host__ __device__ __forceinline__ int smem_floats(int d, int k, int kp,
                                                   int warps) {
  int f = slab_offset(d, kp) + warps * pitch(d, k);
  if (kp <= SPLIT_K)
    f += (warps / GROUPS) * STAGE_ROWS * (kp + 1) + STAGE_ROWS;
  // the last block's runs reuse the stage: one float4 a thread
  return f > 4 * warps * WARP ? f : 4 * warps * WARP;
}

using kmeans_rows::clamp0;
using kmeans_rows::take_min;

// (od, oj) comes before (bd, bj) in the reference's argmin order: a NaN
// first (the lower index of two), else the smaller d2, the lower index on
// a tie
__device__ __forceinline__ bool first_min(float od, int oj, float bd,
                                          int bj) {
  const bool o_nan = od != od;
  const bool b_nan = bd != bd;
  if (o_nan || b_nan) return o_nan && (!b_nan || oj < bj);
  return od < bd || (od == bd && oj < bj);
}

// Feature i (value v) of a row assigned to centroid bj, in a slab of (k, d)
// sums: the reference's one-hot product adds 0 * v to every other
// centroid's sum, nothing for a finite v, a NaN for an infinite or NaN one.
__device__ __forceinline__ void poison_others(float* slab, int bj, int k,
                                              int d, int i, float v) {
  if (!isfinite(v))
    for (int j = 0; j < k; ++j)
      if (j != bj) slab[j * d + i] += 0.f * v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 1; off < WARP; off <<= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// count floats from src to dst (16-byte aligned): float4 loads when src
// is 16-byte aligned, BATCH of them in flight a thread before their
// stores (a loop that stored each load before the next would pay one L2
// round trip per iteration)
template <int THREADS>
__device__ __forceinline__ void stage(const float* __restrict__ src,
                                      int count, float* __restrict__ dst) {
  int e = threadIdx.x;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int nv = count / 4;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int v0 = threadIdx.x; v0 < nv; v0 += BATCH * THREADS) {
      float4 q[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u)
        if (v0 + u * THREADS < nv) q[u] = __ldg(s4 + v0 + u * THREADS);
#pragma unroll
      for (int u = 0; u < BATCH; ++u)
        if (v0 + u * THREADS < nv) d4[v0 + u * THREADS] = q[u];
    }
    e += nv * 4;
  }
  for (; e < count; e += THREADS) dst[e] = __ldg(src + e);
}

// sum of count float4s at stride floats apart, in index order, CHUNK
// loads in flight (partials other blocks wrote: read from L2). The tail
// chunk loads clamped indices, so no load waits behind a branch, and
// adds only its own.
__device__ __forceinline__ float4 sum_in_order(const float* p, int count,
                                               int stride) {
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int b = 0; b < count; b += CHUNK) {
    float4 v[CHUNK];
#pragma unroll
    for (int u = 0; u < CHUNK; ++u)
      v[u] = __ldcg(reinterpret_cast<const float4*>(
          p + static_cast<size_t>(min(b + u, count - 1)) * stride));
#pragma unroll
    for (int u = 0; u < CHUNK; ++u)
      if (b + u < count) {
        acc.x += v[u].x;
        acc.y += v[u].y;
        acc.z += v[u].z;
        acc.w += v[u].w;
      }
  }
  return acc;
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

template <int KP>
__global__ void __launch_bounds__(warps_for<KP>() * WARP, 1)
    lloyd_step_kernel(const float* __restrict__ x,
                      const float* __restrict__ cents, int n, int d, int k,
                      int rows_per_block, int* __restrict__ assign,
                      float* __restrict__ min_d2, float* __restrict__ sums,
                      float* __restrict__ counts,
                      float* __restrict__ partials,
                      unsigned* __restrict__ tickets) {
  constexpr int WARPS = warps_for<KP>();
  constexpr int THREADS = WARPS * WARP;
  constexpr int SLICES = WARPS / GROUPS;
  extern __shared__ float4 smem4[];
  float* s_x = reinterpret_cast<float*>(smem4);  // (STAGE_ROWS, d)
  float* s_ct = s_x + STAGE_ROWS * d;             // (d, KP) centroids^T
  float* s_c2 = s_ct + d * KP;                    // (KP,)
  float* s_slab = s_x + slab_offset(d, KP);       // (WARPS, pitch)
  __shared__ bool is_last;
  __shared__ int s_nonfinite;  // a row of the block had a non-finite x2

  const int client = blockIdx.y;
  const int blocks = gridDim.x;
  const int tid = threadIdx.x;
  const int lane = tid % WARP;
  const int warp = tid / WARP;
  const int kd = k * d;
  const int outs = kd + k;
  const int op = pitch(d, k);
  float* s_part = s_slab + WARPS * op;  // split path: (SLICES, STAGE_ROWS, KP + 1)
  int* s_assign = reinterpret_cast<int*>(s_part + SLICES * STAGE_ROWS * (KP + 1));
  const int row_begin = blockIdx.x * rows_per_block;
  const int row_end = min(n, row_begin + rows_per_block);
  const float* xc = x + static_cast<size_t>(client) * n * d;
  const float* cc = cents + static_cast<size_t>(client) * kd;
  const size_t out0 = static_cast<size_t>(client) * n;

  // the first stage's rows, the centroids, their squared norms (a warp a
  // centroid, from global memory) and zeroed slabs, all before one barrier
  stage<THREADS>(xc + static_cast<size_t>(row_begin) * d,
                 min(STAGE_ROWS, row_end - row_begin) * d, s_x);
  for (int idx0 = tid; idx0 < KP * d; idx0 += BATCH * THREADS) {
    float v[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int idx = idx0 + u * THREADS;
      v[u] = idx < kd ? __ldg(cc + idx) : 0.f;  // slots j >= k hold zeros
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int idx = idx0 + u * THREADS;
      const int j = idx / d;
      if (idx < KP * d) s_ct[(idx - j * d) * KP + j] = v[u];
    }
  }
  for (int idx = tid; idx < WARPS * op; idx += THREADS) s_slab[idx] = 0.f;
  if (tid == 0) s_nonfinite = 0;
  for (int j = warp; j < KP; j += WARPS) {
    float v = 0.f;
    if (j < k)
      for (int i = lane; i < d; i += WARP) {
        const float c = __ldg(cc + j * d + i);
        v = fmaf(c, c, v);
      }
    v = warp_sum(v);
    if (lane == 0) s_c2[j] = v;
  }
  __syncthreads();

  float* slab = s_slab + warp * op;  // this warp's sums, then counts
  for (int s0 = row_begin; s0 < row_end; s0 += STAGE_ROWS) {
    if (s0 != row_begin) {
      __syncthreads();  // the last stage is consumed
      stage<THREADS>(xc + static_cast<size_t>(s0) * d,
                     min(STAGE_ROWS, row_end - s0) * d, s_x);
      __syncthreads();
    }
    const int rows = min(STAGE_ROWS, row_end - s0);
    if constexpr (KP <= SPLIT_K) {
      // Lanes over rows, warps over (row group, feature slice): each lane
      // sums x2 and x.c for every centroid over its slice's features (the
      // centroids read as broadcasts), the slices' sums meet in shared
      // memory, and the first slice's lanes add them in slice order and
      // take the argmin.
      const int group = warp % GROUPS;
      const int slice = warp / GROUPS;
      const int r = group * WARP + lane;
      if (group * WARP < rows) {  // the same for the whole warp
        const int per = (d + SLICES - 1) / SLICES;
        const int i1 = min(d, (slice + 1) * per);
        float xx = 0.f;
        float cr[KP];
#pragma unroll
        for (int j = 0; j < KP; ++j) cr[j] = 0.f;
        // rows past `rows` read stale values inside the stage: dropped
#pragma unroll 4
        for (int i = slice * per; i < i1; ++i) {
          const float xv = s_x[r * d + i];
          xx = fmaf(xv, xv, xx);
          if constexpr (KP % 4 == 0) {
            const float4* c4 = reinterpret_cast<const float4*>(s_ct + i * KP);
#pragma unroll
            for (int j = 0; j < KP / 4; ++j) {
              const float4 c = c4[j];
              cr[4 * j] = fmaf(xv, c.x, cr[4 * j]);
              cr[4 * j + 1] = fmaf(xv, c.y, cr[4 * j + 1]);
              cr[4 * j + 2] = fmaf(xv, c.z, cr[4 * j + 2]);
              cr[4 * j + 3] = fmaf(xv, c.w, cr[4 * j + 3]);
            }
          } else {
#pragma unroll
            for (int j = 0; j < KP; ++j)
              cr[j] = fmaf(xv, s_ct[i * KP + j], cr[j]);
          }
        }
        float* pp = s_part + (slice * STAGE_ROWS + r) * (KP + 1);
        pp[0] = xx;
#pragma unroll
        for (int j = 0; j < KP; ++j) pp[1 + j] = cr[j];
      }
      __syncthreads();
      if (slice == 0 && r < rows) {
        float xx = 0.f;
#pragma unroll
        for (int sl = 0; sl < SLICES; ++sl)
          xx += s_part[(sl * STAGE_ROWS + r) * (KP + 1)];
        float bd = kmeans_rows::INF;
        int bj = 0;
#pragma unroll
        for (int j = 0; j < KP; ++j) {
          if (j >= k) break;
          float c = 0.f;
#pragma unroll
          for (int sl = 0; sl < SLICES; ++sl)
            c += s_part[(sl * STAGE_ROWS + r) * (KP + 1) + 1 + j];
          take_min(clamp0(xx - 2.f * c + s_c2[j]), j, bd, bj);
        }
        assign[out0 + s0 + r] = bj;
        min_d2[out0 + s0 + r] = bd;
        s_assign[r] = bj;
        if (!isfinite(xx)) s_nonfinite = 1;  // a non-finite feature
      }
      __syncthreads();
      // each row into its centroid's sums, a warp a row, lanes over
      // features (i = lane + 32u), rows in order within each warp's slab;
      // the next row's assignment and features are read before this
      // row's update, so a row waits only on its own read-modify-write
      constexpr int U = MAX_D / WARP;
      int bj_next = 0;
      float x_next[U];
      auto fetch = [&](int rr) {
        bj_next = s_assign[rr];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int i = lane + WARP * u;
          x_next[u] = i < d ? s_x[rr * d + i] : 0.f;
        }
      };
      if (warp < rows) fetch(warp);
      for (int rr = warp; rr < rows; rr += WARPS) {
        const int bj = bj_next;
        float xv[U];
#pragma unroll
        for (int u = 0; u < U; ++u) xv[u] = x_next[u];
        if (rr + WARPS < rows) fetch(rr + WARPS);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int i = lane + WARP * u;
          if (i < d) slab[bj * d + i] += xv[u];
        }
        if (lane == 0) slab[kd + bj] += 1.f;
      }
      // a stage with a non-finite feature (the flag stays up for the
      // block's later stages, which then check again): the one-hot
      // product's 0 * x for the other centroids
      if (s_nonfinite) {
        for (int rr = warp; rr < rows; rr += WARPS)
          for (int i = lane; i < d; i += WARP)
            poison_others(slab, s_assign[rr], k, d, i, s_x[rr * d + i]);
      }
    } else {
      // Lanes over centroids (KP / 32 each), a warp RW rows at once over
      // all features: x.c for RW rows x KP/32 centroids per pair of shared
      // loads; a butterfly takes the first-index argmin across lanes.
      constexpr int KPL = KP / WARP;
      // r0 + q < STAGE_ROWS always, so the reads past `rows` stay in the
      // buffer; their results are dropped
      for (int r0 = warp * RW; r0 < rows; r0 += WARPS * RW) {
        float cross[RW][KPL];
        float x2[RW];
#pragma unroll
        for (int q = 0; q < RW; ++q) {
          x2[q] = 0.f;
#pragma unroll
          for (int u = 0; u < KPL; ++u) cross[q][u] = 0.f;
        }
#pragma unroll 2
        for (int i = 0; i < d; ++i) {
          float cv[KPL];
#pragma unroll
          for (int u = 0; u < KPL; ++u) cv[u] = s_ct[i * KP + lane + WARP * u];
#pragma unroll
          for (int q = 0; q < RW; ++q) {
            const float xv = s_x[(r0 + q) * d + i];
            x2[q] = fmaf(xv, xv, x2[q]);
#pragma unroll
            for (int u = 0; u < KPL; ++u)
              cross[q][u] = fmaf(xv, cv[u], cross[q][u]);
          }
        }
#pragma unroll
        for (int q = 0; q < RW; ++q) {
          float bd = 0.f;
          int bj = lane;
#pragma unroll
          for (int u = 0; u < KPL; ++u) {
            const int j = lane + WARP * u;
            const float d2 =
                j < k ? clamp0(x2[q] - 2.f * cross[q][u] + s_c2[j])
                      : __int_as_float(0x7f800000);
            // this lane's centroids in index order: the first NaN, else
            // the first index of the minimum
            if (u == 0 || (bd == bd && (d2 < bd || d2 != d2))) {
              bd = d2;
              bj = j;
            }
          }
#pragma unroll
          for (int off = 1; off < WARP; off <<= 1) {
            const float od = __shfl_xor_sync(FULL, bd, off);
            const int oj = __shfl_xor_sync(FULL, bj, off);
            if (first_min(od, oj, bd, bj)) {
              bd = od;
              bj = oj;
            }
          }
          const int r = r0 + q;
          if (r >= rows) continue;  // the same for the whole warp
          if (lane == 0) {
            assign[out0 + s0 + r] = bj;
            min_d2[out0 + s0 + r] = bd;
            slab[kd + bj] += 1.f;
          }
          // the row into its centroid's sums: lanes over features, rows
          // in order, each warp into its own slab (and, for a non-finite
          // feature, the one-hot product's 0 * x into the others')
          for (int i = lane; i < d; i += WARP)
            slab[bj * d + i] += s_x[r * d + i];
          if (!isfinite(x2[q])) {  // the same for the whole warp
            for (int i = lane; i < d; i += WARP)
              poison_others(slab, bj, k, d, i, s_x[r * d + i]);
          }
        }
      }
    }
  }
  __syncthreads();

  // the block's sums: the warps' slabs added in warp order
  float* out_sums = sums + static_cast<size_t>(client) * kd;
  float* out_counts = counts + static_cast<size_t>(client) * k;
  auto put = [&](int o, float v) {
    if (o < kd) out_sums[o] = v;
    else if (o < outs) out_counts[o - kd] = v;
  };
  auto put4 = [&](int q, const float4& v) {
    put(4 * q, v.x);
    put(4 * q + 1, v.y);
    put(4 * q + 2, v.z);
    put(4 * q + 3, v.w);
  };
  const int quads = op / 4;
  const float4* slab4 = reinterpret_cast<const float4*>(s_slab);
  float* part = partials + static_cast<size_t>(client) * blocks * op;
  for (int q = tid; q < quads; q += THREADS) {
    float4 t = slab4[q];
    for (int w = 1; w < WARPS; ++w) add4(t, slab4[w * quads + q]);
    if (blocks == 1) put4(q, t);
    else reinterpret_cast<float4*>(
             part + static_cast<size_t>(blockIdx.x) * op)[q] = t;
  }
  if (blocks == 1) return;

  // The last block to finish, told by an integer ticket, sums the blocks'
  // partials in block order and resets the ticket.
  __threadfence();  // the partials are visible before the ticket is taken
  __syncthreads();
  unsigned* tk = tickets + client;
  if (tid == 0) is_last = atomicAdd(tk, 1u) == blocks - 1;
  __syncthreads();
  if (!is_last) return;
  if (tid == 0) *tk = 0u;
  // every float4 of outputs summed over the blocks in block order; with
  // few of them, `slices` runs of the blocks side by side, then the runs
  // in order (their sums pass through the consumed stage, a float4 a
  // thread)
  const int slices = 2 * quads <= THREADS
                         ? min(min(THREADS / quads, blocks), MAX_SLICES)
                         : 1;
  if (slices == 1) {
    for (int q = tid; q < quads; q += THREADS)
      put4(q, sum_in_order(part + 4 * q, blocks, op));
    return;
  }
  if (tid < slices * quads) {
    const int q = tid % quads;
    const int sl = tid / quads;
    const int b0 = sl * blocks / slices;
    const int b1 = (sl + 1) * blocks / slices;
    smem4[tid] = sum_in_order(part + static_cast<size_t>(b0) * op + 4 * q,
                              b1 - b0, op);
  }
  __syncthreads();
  if (tid < quads) {
    float4 t = smem4[tid];
    for (int sl = 1; sl < slices; ++sl) add4(t, smem4[sl * quads + tid]);
    put4(tid, t);
  }
}

int sm_count() {
  static int sms[MAX_DEVICES] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES)
    return 132;
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    return 132;
  return sms[dev];
}

// Rows a block takes: a multiple of g (so every block's range, and each
// of its stages, starts 16-byte aligned when the client's rows do), cut
// so one client's blocks spread over the SMs (one block each), with
// fewer, longer blocks where the last block's sum would read more partials
// than the budget, and none under MIN_BLOCK_ROWS rows (a small client's
// blocks would pay the centroids' staging and a partial's write for a few
// rows each); the same for any number of clients.
int rows_per_block(int n, int d, int k) {
  const int g = (d % 4 == 0) ? 1 : (d % 2 == 0) ? 2 : 4;
  const int op = pitch(d, k);
  const int budget = k <= SPLIT_K ? REDUCE_FLOATS_SPLIT : REDUCE_FLOATS_LANES;
  const int nb_max = budget / op > 1 ? budget / op : 1;
  const int target = sm_count() < nb_max ? sm_count() : nb_max;
  const int rpb = max((n + target - 1) / target, MIN_BLOCK_ROWS);
  return (rpb + g - 1) / g * g;
}

template <int KP>
cudaError_t launch(const float* x, const float* cents, int C, int n, int d,
                   int k, int* assign, float* min_d2, float* sums,
                   float* counts, float* partials, unsigned* tickets,
                   cudaStream_t s) {
  constexpr int WARPS = warps_for<KP>();
  static bool attr_set[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES || !attr_set[dev]) {
    // the most this instance can take: d = MAX_D, k = KP
    err = cudaFuncSetAttribute(
        lloyd_step_kernel<KP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_floats(MAX_D, KP, KP, WARPS) * sizeof(float)));
    if (err != cudaSuccess) return err;
    if (dev >= 0 && dev < MAX_DEVICES) attr_set[dev] = true;
  }
  const int rpb = rows_per_block(n, d, k);
  const int blocks = (n + rpb - 1) / rpb;
  const size_t smem = smem_floats(d, k, KP, WARPS) * sizeof(float);
  lloyd_step_kernel<KP><<<dim3(blocks, C), WARPS * WARP, smem, s>>>(
      x, cents, n, d, k, rpb, assign, min_d2, sums, counts, partials,
      tickets);
  return cudaGetLastError();
}

// ------------------------------------------------------------ wide route
constexpr int S_WARPS = 8;   // row segments of a sums block, a warp each
constexpr int S_BATCH = 32;  // rows a warp loads at once
constexpr int S_PITCH = WARP + 1;  // a centroid's 32 feature sums, its count
constexpr int S_MIN_ROWS = 256;    // fewest rows a sums block takes

// The assignment pass's epilogue.
struct AssignOut {
  int* assign;
  float* min_d2;
  __device__ __forceinline__ void begin() {}
  __device__ __forceinline__ void operator()(size_t row, float best,
                                             int bj) const {
    assign[row] = bj;
    min_d2[row] = best;
  }
};

// Row groups the sums pass cuts a client's rows into: enough blocks of
// (slice, group) for about two an SM for one client, none under
// S_MIN_ROWS rows; the same for any number of clients (so each client's
// sums are added in the order of a launch for it alone).
int sum_groups(int n, int d) {
  const int slices = (d + WARP - 1) / WARP;
  const int want = (2 * sm_count() + slices - 1) / slices;
  const int most = (n + S_MIN_ROWS - 1) / S_MIN_ROWS;
  return max(1, min(want, most));
}

// The sums pass: a block per (32-feature slice, row group, client), a lane
// per feature. Warp w walks its segment of the group's rows in order, 32
// rows' features and assignments loaded at once, adding each row into its
// centroid's sums in the warp's own (k, 33) slab, counting rows in
// registers; the slabs are added in warp order. With one group, that is
// the output; else each group's block writes it to scratch, and the last
// block of the (slice, client) to finish, told by an integer ticket, adds
// the groups in order and resets the ticket. The slice-0 blocks write the
// counts.
__global__ void __launch_bounds__(S_WARPS * WARP)
    wide_sums_kernel(const float* __restrict__ x,
                     const int* __restrict__ assign, int n, int d, int k,
                     float* __restrict__ sums, float* __restrict__ counts,
                     float* __restrict__ partials,
                     unsigned* __restrict__ tickets) {
  extern __shared__ float4 smem4[];
  float* all = reinterpret_cast<float*>(smem4);  // (S_WARPS, k, S_PITCH)
  __shared__ bool is_last;
  const int slice = blockIdx.x;
  const int group = blockIdx.y;
  const int groups = gridDim.y;
  const int client = blockIdx.z;
  const int lane = threadIdx.x % WARP;
  const int warp = threadIdx.x / WARP;
  const int f = slice * WARP + lane;
  const bool has_f = f < d;
  const int kp = k * S_PITCH;
  const float* xc = x + static_cast<size_t>(client) * n * d;
  const int* ac = assign + static_cast<size_t>(client) * n;
  float* slab = all + warp * kp;
  for (int i = lane; i < kp; i += WARP) slab[i] = 0.f;
  __syncwarp();
  const int per_group = (n + groups - 1) / groups;
  const int g_begin = min(n, group * per_group);
  const int g_end = min(n, g_begin + per_group);
  const int seg = (g_end - g_begin + S_WARPS - 1) / S_WARPS;
  const int r_begin = min(g_end, g_begin + warp * seg);
  const int r_end = min(g_end, r_begin + seg);
  // Without a branch a row: the first centroid whose row has a non-finite
  // value at this feature, and whether one of another centroid followed
  // (the one-hot product's 0 * x then makes every other sum NaN, below);
  // the rows of centroids lane and lane + 32, counted in registers.
  int bad_a = -1;
  bool bad_other = false;
  float cnt0 = 0.f, cnt1 = 0.f;
  for (int b = r_begin; b < r_end; b += S_BATCH) {
    const int a_l = b + lane < r_end ? __ldg(ac + b + lane) : 0;
    float v[S_BATCH];
#pragma unroll
    for (int u = 0; u < S_BATCH; ++u)
      v[u] = (has_f && b + u < r_end)
                 ? __ldg(xc + static_cast<size_t>(b + u) * d + f)
                 : 0.f;
    // all 32 loads issued before the first row's update (not sunk to it)
    asm volatile("" ::: "memory");
#pragma unroll
    for (int u = 0; u < S_BATCH; ++u) {
      if (b + u >= r_end) break;  // the same for the whole warp
      const int a = __shfl_sync(FULL, a_l, u);
      slab[a * S_PITCH + lane] += v[u];
      const bool bad = !isfinite(v[u]);
      bad_other |= bad && bad_a >= 0 && bad_a != a;
      bad_a = bad && bad_a < 0 ? a : bad_a;
      cnt0 += a == lane ? 1.f : 0.f;
      cnt1 += a == lane + WARP ? 1.f : 0.f;
    }
  }
  if (bad_a >= 0) {
    for (int j = 0; j < k; ++j)
      if (bad_other || j != bad_a) slab[j * S_PITCH + lane] += __int_as_float(0x7fffffff);
  }
  if (lane < k) slab[lane * S_PITCH + WARP] = cnt0;
  if (lane + WARP < k) slab[(lane + WARP) * S_PITCH + WARP] = cnt1;
  __syncthreads();
  auto put = [&](int idx, float v) {
    const int j = idx / S_PITCH;
    const int c = idx - j * S_PITCH;
    if (c < WARP) {
      const int fc = slice * WARP + c;
      if (fc < d) sums[(static_cast<size_t>(client) * k + j) * d + fc] = v;
    } else if (slice == 0) {
      counts[static_cast<size_t>(client) * k + j] = v;
    }
  };
  const int cell = client * gridDim.x + slice;   // this (slice, client)
  float* part = partials + static_cast<size_t>(cell) * groups * kp;
  for (int idx = threadIdx.x; idx < kp; idx += S_WARPS * WARP) {
    float v = 0.f;
    for (int w = 0; w < S_WARPS; ++w) v += all[w * kp + idx];
    if (groups == 1) put(idx, v);
    else part[static_cast<size_t>(group) * kp + idx] = v;
  }
  if (groups == 1) return;
  __threadfence();  // the partials are visible before the ticket is taken
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicAdd(tickets + cell, 1u) == static_cast<unsigned>(groups - 1);
  __syncthreads();
  if (!is_last) return;
  if (threadIdx.x == 0) tickets[cell] = 0u;
  for (int idx = threadIdx.x; idx < kp; idx += S_WARPS * WARP) {
    float v = 0.f;
    for (int g = 0; g < groups; ++g)
      v += __ldcg(part + static_cast<size_t>(g) * kp + idx);
    put(idx, v);
  }
}

cudaError_t launch_wide(const float* x, const float* cents, int C, int n,
                        int d, int k, int* assign, float* min_d2,
                        float* sums, float* counts, float* partials,
                        unsigned* tickets, cudaStream_t s) {
  static bool attr_set[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES || !attr_set[dev]) {
    err = cudaFuncSetAttribute(
        wide_sums_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(S_WARPS * MAX_K * S_PITCH * sizeof(float)));
    if (err != cudaSuccess) return err;
    if (dev >= 0 && dev < MAX_DEVICES) attr_set[dev] = true;
  }
  const dim3 grid(kmeans_rows::wide_blocks(n), C);
  const AssignOut out{assign, min_d2};
  const size_t xs = static_cast<size_t>(n) * d, cs = static_cast<size_t>(k) * d;
  if (k <= 4)
    kmeans_rows::wide_rows_kernel<4, AssignOut>
        <<<grid, kmeans_rows::W_THREADS, 0, s>>>(x, cents, n, d, k, xs, cs,
                                                 out);
  else if (k <= 12)
    kmeans_rows::wide_rows_kernel<12, AssignOut>
        <<<grid, kmeans_rows::W_THREADS, 0, s>>>(x, cents, n, d, k, xs, cs,
                                                 out);
  else
    kmeans_rows::wide_rows_kernel<16, AssignOut>
        <<<grid, kmeans_rows::W_THREADS, 0, s>>>(x, cents, n, d, k, xs, cs,
                                                 out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wide_sums_kernel<<<dim3((d + WARP - 1) / WARP, sum_groups(n, d), C),
                     S_WARPS * WARP, S_WARPS * k * S_PITCH * sizeof(float),
                     s>>>(x, assign, n, d, k, sums, counts, partials,
                          tickets);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int repro_lloyd_max_d() { return WIDE_MAX_D; }
int repro_lloyd_max_k() { return MAX_K; }
// Kernels a call launches: one on the narrow route, two (assignments, then
// sums) on the wide route.
int repro_lloyd_launches(int d) { return d > MAX_D ? 2 : 1; }
// Tickets a launch needs: one a client on the narrow route, one a (32-
// feature slice, client) on the wide route.
int repro_lloyd_tickets(int C, int d) {
  return d > MAX_D ? C * ((d + WARP - 1) / WARP) : C;
}
// Floats of scratch a launch needs on the current device: on the narrow
// route every block's sums and counts, (C, blocks, pitch), pitch = k*d + k
// rounded up to 4; on the wide route every row group's sums and counts of
// every slice, (C, slices, groups, k, 33).
long long repro_lloyd_scratch_floats(int C, int n, int d, int k) {
  if (d > MAX_D)
    return static_cast<long long>(C) * ((d + WARP - 1) / WARP) *
           sum_groups(n, d) * k * S_PITCH;
  const int rpb = rows_per_block(n, d, k);
  return static_cast<long long>(C) * ((n + rpb - 1) / rpb) * pitch(d, k);
}

// x (C, n, d), cents (C, k, d) f32; assign (C, n) i32, min_d2 (C, n),
// sums (C, k, d), counts (C, k) f32; partials: repro_lloyd_scratch_floats
// f32 of scratch, 16-byte aligned; tickets: repro_lloyd_tickets u32, zero
// between launches on one stream (the last block to finish resets its
// own).
int repro_lloyd_step(const void* x, const void* cents, int C, int n, int d,
                     int k, void* assign, void* min_d2, void* sums,
                     void* counts, void* partials, void* tickets,
                     void* stream) {
  if (C < 1 || n < 1 || d < 1 || d > WIDE_MAX_D || k < 1 || k > MAX_K)
    return cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* cf = static_cast<const float*>(cents);
  int* a = static_cast<int*>(assign);
  float* m = static_cast<float*>(min_d2);
  float* su = static_cast<float*>(sums);
  float* co = static_cast<float*>(counts);
  float* p = static_cast<float*>(partials);
  unsigned* t = static_cast<unsigned*>(tickets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d > MAX_D)
    return launch_wide(xf, cf, C, n, d, k, a, m, su, co, p, t, s);
#define REPRO_LLOYD(KP) launch<KP>(xf, cf, C, n, d, k, a, m, su, co, p, t, s)
  if (k <= 1) return REPRO_LLOYD(1);
  if (k <= 2) return REPRO_LLOYD(2);
  if (k <= 4) return REPRO_LLOYD(4);
  if (k <= 8) return REPRO_LLOYD(8);
  if (k <= 12) return REPRO_LLOYD(12);
  if (k <= 16) return REPRO_LLOYD(16);
  if (k <= 32) return REPRO_LLOYD(32);
  return REPRO_LLOYD(64);
#undef REPRO_LLOYD
}

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
