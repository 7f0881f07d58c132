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
//    per SM (clients share the SMs), or fewer, longer blocks where the
//    last block's sum would read more than a budget of partials.
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
//  * Limits: d <= 64 and k <= 64 (every caller: d = 50 features or 16
//    tokens, k <= 32 centroids); the launcher returns cudaErrorInvalidValue
//    beyond them.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WARP = 32;
constexpr int MAX_D = 64;
constexpr int MAX_K = 64;
constexpr int STAGE_ROWS = 128;         // rows of x in shared memory at once
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
        float bd = 0.f;
        int bj = 0;
#pragma unroll
        for (int j = 0; j < KP; ++j) {
          if (j >= k) break;
          float c = 0.f;
#pragma unroll
          for (int sl = 0; sl < SLICES; ++sl)
            c += s_part[(sl * STAGE_ROWS + r) * (KP + 1) + 1 + j];
          const float d2 = fmaxf(xx - 2.f * c + s_c2[j], 0.f);
          if (j == 0 || d2 < bd) {  // strict: the first index wins ties
            bd = d2;
            bj = j;
          }
        }
        assign[out0 + s0 + r] = bj;
        min_d2[out0 + s0 + r] = bd;
        s_assign[r] = bj;
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
                j < k ? fmaxf(x2[q] - 2.f * cross[q][u] + s_c2[j], 0.f)
                      : __int_as_float(0x7f800000);
            if (u == 0 || d2 < bd) {  // strict: the first index wins ties
              bd = d2;
              bj = j;
            }
          }
#pragma unroll
          for (int off = 1; off < WARP; off <<= 1) {
            const float od = __shfl_xor_sync(FULL, bd, off);
            const int oj = __shfl_xor_sync(FULL, bj, off);
            if (od < bd || (od == bd && oj < bj)) {
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
          // in order, each warp into its own slab
          for (int i = lane; i < d; i += WARP)
            slab[bj * d + i] += s_x[r * d + i];
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
// so the clients' blocks spread over the SMs (one block each), with fewer,
// longer blocks where the last block's sum would read more partials than
// the budget.
int rows_per_block(int C, int n, int d, int k) {
  const int g = (d % 4 == 0) ? 1 : (d % 2 == 0) ? 2 : 4;
  const int op = pitch(d, k);
  const int budget = k <= SPLIT_K ? REDUCE_FLOATS_SPLIT : REDUCE_FLOATS_LANES;
  const int nb_max = budget / op > 1 ? budget / op : 1;
  int target = sm_count() / C;
  if (target < 1) target = 1;
  if (target > nb_max) target = nb_max;
  const int rpb = (n + target - 1) / target;
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
  const int rpb = rows_per_block(C, n, d, k);
  const int blocks = (n + rpb - 1) / rpb;
  const size_t smem = smem_floats(d, k, KP, WARPS) * sizeof(float);
  lloyd_step_kernel<KP><<<dim3(blocks, C), WARPS * WARP, smem, s>>>(
      x, cents, n, d, k, rpb, assign, min_d2, sums, counts, partials,
      tickets);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int repro_lloyd_max_d() { return MAX_D; }
int repro_lloyd_max_k() { return MAX_K; }
// Floats of scratch a launch needs on the current device: every block's
// sums and counts, (C, blocks, pitch), pitch = k*d + k rounded up to 4.
long long repro_lloyd_scratch_floats(int C, int n, int d, int k) {
  const int rpb = rows_per_block(C, n, d, k);
  return static_cast<long long>(C) * ((n + rpb - 1) / rpb) * pitch(d, k);
}

// x (C, n, d), cents (C, k, d) f32; assign (C, n) i32, min_d2 (C, n),
// sums (C, k, d), counts (C, k) f32; partials: repro_lloyd_scratch_floats
// f32 of scratch, 16-byte aligned; tickets (C,) u32, zero between
// launches on one stream (the last block of each client resets its own).
int repro_lloyd_step(const void* x, const void* cents, int C, int n, int d,
                     int k, void* assign, void* min_d2, void* sums,
                     void* counts, void* partials, void* tickets,
                     void* stream) {
  if (C < 1 || n < 1 || d < 1 || d > MAX_D || k < 1 || k > MAX_K)
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
