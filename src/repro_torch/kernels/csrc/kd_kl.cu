// Temperature-scaled KL distillation loss: per sample, forward and
// backward, and the fused loss of one distill step.
//
// Replaces: src/repro/kernels/distill_kl/kernel.py
//   kd_kl_pallas (body _kernel)              -> repro_kd_kl_fwd
//   kd_kl_bwd_pallas (bodies _bwd_ds_kernel,  -> repro_kd_kl_bwd_ds,
//                     _bwd_dt_kernel)            repro_kd_kl_bwd_dt
//   both, with the weighted mean of          -> repro_kd_kl_loss
//   src/repro/core/distill.py::kd_kl_loss
// For student s and teacher t logits (n, K), with s^ = softmax(s/T) and
// t^ = softmax(t/T):
//   fwd:  kl_i = T^2 * sum_k t^ (log t^ - log s^)
//   ds:   g_i * T * (s^ - t^)
//   dt:   g_i * T * t^ * ((log t^ - log s^) - kl_i / T^2)
//   loss: sum_i w_i kl_i / max(sum_i w_i, 1) (mean of kl without w), and
//         ds for g_i = w_i / max(sum w, 1) (1/n), the mean's cotangent
// Both log-softmaxes are recomputed from the raw logits in every kernel
// (the residuals are the logits, as in the reference's custom VJP).
//
// What bounds it on an H100: bytes. Per row the work is a few sweeps over
// K (max, sum of exps, the weighted sum or the gradient write) at a handful
// of flops per element, against 2*n*K*4 bytes read and n*4 (fwd) or n*K*4
// (bwd) bytes written; on the main path (n = 64, K = 10) it is launch
// latency. Design: one warp per row; each lane takes every 32nd element
// with neighbouring lanes on neighbouring addresses, and the row's max and
// sums are warp-shuffle reductions. The per-sample kernels (eight rows a
// block) re-read the row from L1 at each pass. The fused loss is what one
// distill step runs, so it is built against the launch count: one launch
// writes kl, the scalar loss and ds, and the autograd backward is one
// multiply by the cotangent. It has two routes by K.
//  * Register route (K <= 1024, the main path): one warp a row, the row in
//    registers, divided by T once (ceil(K/32) a lane); 16 rows a block, so
//    the main path's batch spreads over four SMs (on an H100, one block of
//    all 64 rows took 7.3 us of device time against 5.2: the ~300
//    instructions of each row queue on one SM's schedulers).
//  * Wide-row route (K > 1024, the FD trainers' vocabularies): a row is
//    spread over a thread-block cluster of ceil(K / 8192) blocks (at most
//    16, past 8 as a non-portable cluster), so 16 rows of 256000 columns
//    run on 256 blocks, not one. Each block reads its chunk of s and t
//    once, by 16-byte loads after a row's first 16-byte boundary, divides
//    it by T once into shared memory, and keeps it there for every pass.
//    At most 64 registers a thread, so two blocks share an SM and more
//    clusters run at once (on an H100, 4096 columns a block at one block
//    an SM took 0.035 ms at (16, 49155), 8192 at two 0.018).
//    The row's max, then its sums of exps, then its KL are each a block
//    reduction exchanged through distributed shared memory after a
//    cluster barrier; every block reads its peers' values in rank order,
//    so all hold the same bits. The stabiliser is the row's global max (no
//    chunk-rescaled online sum), so the arithmetic keeps the reference's
//    order below. exp(tl) of the KL pass is kept in shared memory for ds,
//    which each block writes from its resident chunk: the row is read once
//    and ds written once, the byte bound. Rank 0 writes kl[row]. (A chunk
//    too large for shared memory, K > 458752, is re-read from memory at
//    each pass instead, the same sums in the same order.)
// The mean's denominator depends on w only, so every warp (every block on
// the wide route) reduces w itself; the scalar is reduced in a fixed order
// by the last block (an integer ticket: a block of 16 rows, or a row's
// rank-0 block), never by float atomics, so two launches on the same
// inputs give the same bits. Neither route's sums depend on where a row
// starts in memory, so a client's slice of a (C, n, K) launch gives the
// bits of its own (n, K) launch.
// Arithmetic is IEEE fp32 in the reference's order: s/T first, then the
// stabilised log-sum-exp, then exp(tl) * (tl - sl).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int WARP = 32;
constexpr int ROWS = 8;  // warps, hence rows, per block
constexpr int LOSS_ROWS = 16;  // warps, hence rows, per block of the loss
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = WARP / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = WARP / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// One row of student and teacher logits over T as one warp walks it:
// lane `lane` takes the elements i = lane, lane + 32, ... below K, in that
// order, and each(f) calls f(i, s_i / T, t_i / T) on them. GlobalRow reads
// device memory and divides at every pass (the per-sample kernels);
// RegRow<V> loads and divides the row once into registers, V elements a
// lane (the fused loss, K <= 32 V). Both walk the same elements in the same
// order and divide exactly, so the helpers below give the same bits
// through either.
struct GlobalRow {
  const float* s;
  const float* t;
  int K, lane;
  float T;
  __device__ __forceinline__ GlobalRow(const float* s_, const float* t_,
                                       int K_, int lane_, float T_)
      : s(s_), t(t_), K(K_), lane(lane_), T(T_) {}
  template <class F>
  __device__ __forceinline__ void each(F f) const {
    for (int i = lane; i < K; i += WARP) f(i, s[i] / T, t[i] / T);
  }
};

template <int V>
struct RegRow {
  float s[V], t[V];
  int K, lane;
  __device__ __forceinline__ RegRow(const float* sp, const float* tp, int K_,
                                    int lane_, float T)
      : K(K_), lane(lane_) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int i = lane + j * WARP;
      s[j] = i < K ? sp[i] : 0.f;
      t[j] = i < K ? tp[i] : 0.f;
    }
    // divide once every load is in flight: the division's slow-path
    // branch would otherwise hold back the loads behind it
#pragma unroll
    for (int j = 0; j < V; ++j) {
      s[j] /= T;
      t[j] /= T;
    }
  }
  template <class F>
  __device__ __forceinline__ void each(F f) const {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int i = lane + j * WARP;
      if (i < K) f(i, s[j], t[j]);
    }
  }
};

// log-sum-exp of s/T and t/T over one row; every lane gets both.
template <class Row>
__device__ __forceinline__ void row_lse(const Row& r, float* s_lse,
                                        float* t_lse) {
  float sm = -INFINITY, tm = -INFINITY;
  r.each([&](int, float s, float t) {
    sm = fmaxf(sm, s);
    tm = fmaxf(tm, t);
  });
  sm = warp_max(sm);
  tm = warp_max(tm);
  float se = 0.f, te = 0.f;
  r.each([&](int, float s, float t) {
    se += expf(s - sm);
    te += expf(t - tm);
  });
  *s_lse = logf(warp_sum(se)) + sm;
  *t_lse = logf(warp_sum(te)) + tm;
}

// sum_k t^ (log t^ - log s^) over one row (KL / T^2); every lane gets it.
template <class Row>
__device__ __forceinline__ float row_kl(const Row& r, float s_lse,
                                        float t_lse) {
  float acc = 0.f;
  r.each([&](int, float s, float t) {
    const float sl = s - s_lse;
    const float tl = t - t_lse;
    acc += expf(tl) * (tl - sl);
  });
  return warp_sum(acc);
}

__global__ void kd_kl_fwd(const float* __restrict__ s,
                          const float* __restrict__ t, int n, int K, float T,
                          float* __restrict__ out) {
  const int lane = threadIdx.x % WARP;
  const int row = blockIdx.x * ROWS + threadIdx.x / WARP;
  if (row >= n) return;  // the whole warp leaves together
  const size_t off = static_cast<size_t>(row) * K;
  const GlobalRow r(s + off, t + off, K, lane, T);
  float s_lse, t_lse;
  row_lse(r, &s_lse, &t_lse);
  const float kl = row_kl(r, s_lse, t_lse);
  if (lane == 0) out[row] = kl * T * T;
}

__global__ void kd_kl_bwd_ds(const float* __restrict__ s,
                             const float* __restrict__ t,
                             const float* __restrict__ g, int n, int K,
                             float T, float* __restrict__ ds) {
  const int lane = threadIdx.x % WARP;
  const int row = blockIdx.x * ROWS + threadIdx.x / WARP;
  if (row >= n) return;
  const size_t off = static_cast<size_t>(row) * K;
  const GlobalRow r(s + off, t + off, K, lane, T);
  float s_lse, t_lse;
  row_lse(r, &s_lse, &t_lse);
  const float gt = g[row] * T;
  r.each([&](int i, float sv, float tv) {
    ds[off + i] = gt * (expf(sv - s_lse) - expf(tv - t_lse));
  });
}

__global__ void kd_kl_bwd_dt(const float* __restrict__ s,
                             const float* __restrict__ t,
                             const float* __restrict__ g, int n, int K,
                             float T, float* __restrict__ dt) {
  const int lane = threadIdx.x % WARP;
  const int row = blockIdx.x * ROWS + threadIdx.x / WARP;
  if (row >= n) return;
  const size_t off = static_cast<size_t>(row) * K;
  const GlobalRow r(s + off, t + off, K, lane, T);
  float s_lse, t_lse;
  row_lse(r, &s_lse, &t_lse);
  // f = KL_i / T^2, recomputed rather than saved
  const float f = row_kl(r, s_lse, t_lse);
  const float gt = g[row] * T;
  r.each([&](int i, float sv, float tv) {
    const float sl = sv - s_lse;
    const float tl = tv - t_lse;
    const float tp = expf(tl);
    dt[off + i] = gt * tp * ((tl - sl) - f);
  });
}

// A value that is the same in every lane of a warp, summed over the
// block's warps in index order; every thread gets the sum. `red` holds one
// float per warp.
__device__ __forceinline__ float block_sum_warps(float v, float* red) {
  __syncthreads();  // red is free from any earlier use
  if (threadIdx.x % WARP == 0) red[threadIdx.x / WARP] = v;
  __syncthreads();
  float total = 0.f;
  for (int j = 0; j < LOSS_ROWS; ++j) total += red[j];
  return total;
}

// max(sum w, 1), or n without a weight. Every warp of every block reduces
// all n weights itself, in the same order, so all hold the same bits
// without a grid sync (n is at most a few thousand on every path).
__device__ __forceinline__ float weight_denominator(const float* w, int n,
                                                   int lane) {
  if (w == nullptr) return static_cast<float>(n);
  float acc = 0.f;
  for (int i = lane; i < n; i += WARP) acc += w[i];
  return fmaxf(warp_sum(acc), 1.f);
}

// The fused loss: per-sample kl, the weighted mean and its gradient for
// the student, one launch. Register route: one warp per row, LOSS_ROWS rows
// a block; the
// grid's y axis is the client: client c's operands and outputs are its
// own slices (rows n c .. n c + n - 1, its loss, its partial sums and its
// ticket), so its blocks compute exactly what a launch for it alone does.
template <class Row>
__global__ void __launch_bounds__(LOSS_ROWS * WARP)
    kd_kl_loss(const float* __restrict__ s, const float* __restrict__ t,
               const float* __restrict__ w, int n, int K, float T,
               int want_ds, float* __restrict__ kl, float* __restrict__ loss,
               float* __restrict__ ds, float* __restrict__ partials,
               unsigned* __restrict__ ticket) {
  __shared__ float red[LOSS_ROWS];
  __shared__ bool is_last;
  const size_t client = blockIdx.y;
  s += client * n * K;
  t += client * n * K;
  if (w != nullptr) w += client * n;
  kl += client * n;
  loss += client;
  if (want_ds) ds += client * n * K;
  partials += client * gridDim.x;
  ticket += client;
  const int lane = threadIdx.x % WARP;
  const int row =
      static_cast<int>(blockIdx.x) * LOSS_ROWS + threadIdx.x / WARP;
  float part = 0.f;   // w_i kl_i of this warp's row
  float denom = 1.f;  // the mean's denominator, in every warp with a row:
                      // warp 0, which writes the loss, always has one
  if (row < n) {      // the whole warp takes the branch together
    const size_t off = static_cast<size_t>(row) * K;
    const Row r(s + off, t + off, K, lane, T);
    const float wi = w != nullptr ? w[row] : 1.f;
    denom = weight_denominator(w, n, lane);
    float s_lse, t_lse;
    row_lse(r, &s_lse, &t_lse);
    const float k = row_kl(r, s_lse, t_lse) * T * T;
    if (lane == 0) kl[row] = k;
    part = wi * k;
    if (want_ds) {
      // the weighted mean's cotangent w_i / max(sum w, 1) (1/n without w)
      const float gt = wi / denom * T;
      r.each([&](int i, float sv, float tv) {
        ds[off + i] = gt * (expf(sv - s_lse) - expf(tv - t_lse));
      });
    }
  }
  const float block_total = block_sum_warps(part, red);
  if (gridDim.x == 1) {
    if (threadIdx.x == 0) *loss = block_total / denom;
    return;
  }
  // Many blocks: each leaves its sum in its slot; the last to finish,
  // told by an integer ticket, sums the slots in a fixed order and resets
  // the ticket for the next launch. No float atomics, so two launches on
  // the same inputs give the same bits.
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = block_total;
    __threadfence();  // the slot is visible before the ticket is taken
    is_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!is_last) return;
  float acc = 0.f;
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += blockDim.x)
    acc += __ldcg(partials + b);  // from L2: other blocks wrote them
  const float total = block_sum_warps(warp_sum(acc), red);
  if (threadIdx.x == 0) {
    *loss = total / denom;
    *ticket = 0u;
  }
}

template <class Row>
int launch_loss(const void* s, const void* t, const void* w, int C, int n,
                int K, float T, int want_ds, void* kl, void* loss, void* ds,
                void* partials, void* ticket, cudaStream_t stream) {
  const int blocks = (n + LOSS_ROWS - 1) / LOSS_ROWS;
  kd_kl_loss<Row><<<dim3(blocks, C), LOSS_ROWS * WARP, 0, stream>>>(
      static_cast<const float*>(s), static_cast<const float*>(t),
      static_cast<const float*>(w), n, K, T, want_ds,
      static_cast<float*>(kl), static_cast<float*>(loss),
      static_cast<float*>(ds), static_cast<float*>(partials),
      static_cast<unsigned*>(ticket));
  return cudaGetLastError();
}

// ------------------------------------------------------ the wide-row route

constexpr int WIDE_THREADS = 512;
constexpr int WIDE_WARPS = WIDE_THREADS / WARP;
constexpr int WIDE_COLUMNS = 8192;     // columns a block (1..16 a row)
constexpr int WIDE_CLUSTER_MAX = 16;   // past 8: a non-portable cluster
// a chunk's floats that stay in shared memory (s/T and t/T, 224 KB at most)
constexpr int WIDE_RESIDENT_MAX = 28672;
constexpr int MAX_DEVICES = 64;

// Blocks a row of K > 1024 columns spreads over (the cluster's size), and
// the columns each block takes, a multiple of 4 (the last block the rest).
inline int wide_blocks(int K) {
  const int b = (K + WIDE_COLUMNS - 1) / WIDE_COLUMNS;
  return b < WIDE_CLUSTER_MAX ? b : WIDE_CLUSTER_MAX;
}

inline int wide_chunk(int K) {
  const int b = wide_blocks(K);
  return ((K + b - 1) / b + 3) / 4 * 4;
}

// One operand's chunk on its way into shared memory: scalar loads up to
// src's first 16-byte boundary (a row of an (n, K) matrix need not start
// on one), 16-byte loads after it, scalar loads for the tail. dst has len
// + 4 floats: element 0 lands 0-3 floats in (base), so every 16-byte load
// is stored by one 16-byte store.
struct ChunkCopy {
  const float* src;
  float* base;  // base[i] = src[i] / T
  int head, body;
  __device__ __forceinline__ ChunkCopy(const float* s, float* dst, int len)
      : src(s) {
    const int mis =
        static_cast<int>((reinterpret_cast<uintptr_t>(s) >> 2) & 3);
    head = min(len, (4 - mis) & 3);
    base = dst + ((4 - head) & 3);
    body = (len - head) / 4;
  }
  __device__ __forceinline__ float4 load(int j) const {
    return __ldcs(reinterpret_cast<const float4*>(src + head) + j);
  }
  __device__ __forceinline__ void store(int j, float4 v) const {
    reinterpret_cast<float4*>(base + head)[j] = v;
  }
};

__device__ __forceinline__ float4 div4(float4 v, float T) {
  return make_float4(v.x / T, v.y / T, v.z / T, v.w / T);
}

__device__ __forceinline__ float max4(float m, float4 v) {
  return fmaxf(m, fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)));
}

// s[0, len) / T and t[0, len) / T into shared memory (dst_s, dst_t of len
// + 4 floats each), four 16-byte loads of each operand in flight a thread;
// *ss, *st get where their element 0 landed and *mx this thread's maxima.
__device__ __forceinline__ void load_chunks(const float* __restrict__ s,
                                            const float* __restrict__ t,
                                            float* dst_s, float* dst_t,
                                            int len, float T, float** ss,
                                            float** st, float2* mx) {
  const int tid = threadIdx.x;
  const ChunkCopy cs(s, dst_s, len), ct(t, dst_t, len);
  float2 m = make_float2(-INFINITY, -INFINITY);
  if (tid < cs.head) m.x = cs.base[tid] = s[tid] / T;
  if (tid < ct.head) m.y = ct.base[tid] = t[tid] / T;
  const int body = max(cs.body, ct.body);
  for (int j0 = tid; j0 < body; j0 += 4 * WIDE_THREADS) {
    float4 vs[4], vt[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + u * WIDE_THREADS;
      if (j < cs.body) vs[u] = cs.load(j);  // read once: streamed
      if (j < ct.body) vt[u] = ct.load(j);
    }
    // divide once every load is in flight (the division's slow-path
    // branch would otherwise hold back the loads behind it)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + u * WIDE_THREADS;
      if (j < cs.body) {
        vs[u] = div4(vs[u], T);
        cs.store(j, vs[u]);
        m.x = max4(m.x, vs[u]);
      }
      if (j < ct.body) {
        vt[u] = div4(vt[u], T);
        ct.store(j, vt[u]);
        m.y = max4(m.y, vt[u]);
      }
    }
  }
  for (int i = cs.head + 4 * cs.body + tid; i < len; i += WIDE_THREADS)
    m.x = fmaxf(m.x, cs.base[i] = s[i] / T);
  for (int i = ct.head + 4 * ct.body + tid; i < len; i += WIDE_THREADS)
    m.y = fmaxf(m.y, ct.base[i] = t[i] / T);
  *ss = cs.base;
  *st = ct.base;
  *mx = m;
}

// A pair of values summed (or maxed) over the block: each warp's butterfly,
// then the warps in index order; every thread gets the result. red holds
// one pair a warp.
template <bool MAX>
__device__ __forceinline__ float2 block_reduce2(float2 v, float2* red) {
  for (int o = WARP / 2; o > 0; o >>= 1) {
    const float x = __shfl_xor_sync(FULL, v.x, o);
    const float y = __shfl_xor_sync(FULL, v.y, o);
    v.x = MAX ? fmaxf(v.x, x) : v.x + x;
    v.y = MAX ? fmaxf(v.y, y) : v.y + y;
  }
  __syncthreads();  // red is free from any earlier use
  if (threadIdx.x % WARP == 0) red[threadIdx.x / WARP] = v;
  __syncthreads();
  float2 r = red[0];
  for (int j = 1; j < WIDE_WARPS; ++j) {
    r.x = MAX ? fmaxf(r.x, red[j].x) : r.x + red[j].x;
    r.y = MAX ? fmaxf(r.y, red[j].y) : r.y + red[j].y;
  }
  return r;
}

// The cluster's blocks' values of one slot (a pair in each block's shared
// memory, written before a cluster barrier), combined in rank order: lane
// q of every warp reads rank q's pair, and the pairs go round the warp by
// shuffles, so every thread of every block holds the same bits.
template <bool MAX>
__device__ __forceinline__ float2 cluster_reduce2(cg::cluster_group& cluster,
                                                  float2* slot) {
  const int lane = threadIdx.x % WARP;
  const int nb = static_cast<int>(cluster.num_blocks());
  const float2 mine =
      lane < nb ? *cluster.map_shared_rank(slot, lane) : make_float2(0.f, 0.f);
  float2 r = make_float2(__shfl_sync(FULL, mine.x, 0),
                         __shfl_sync(FULL, mine.y, 0));
  for (int q = 1; q < nb; ++q) {
    const float x = __shfl_sync(FULL, mine.x, q);
    const float y = __shfl_sync(FULL, mine.y, q);
    r.x = MAX ? fmaxf(r.x, x) : r.x + x;
    r.y = MAX ? fmaxf(r.y, y) : r.y + y;
  }
  return r;
}

// The cluster barrier in two halves: arrive once this thread's reads of
// its peers' shared memory are done, wait before the block may exit (a
// peer may still be reading this block's slots).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The fused loss for rows of K > 1024: a cluster of blocks a row (grid x =
// n * cluster size, y = the client), block rank r taking columns
// [r * chunk, min((r + 1) * chunk, K)). RESIDENT: the chunk of s/T and t/T
// lives in shared memory (2 * (chunk + 4) floats) for every pass; else
// each pass re-reads it from memory. Client c's operands and outputs are
// its own slices, as on the register route; its partial sums are one a
// row (n a client).
template <bool RESIDENT>
__global__ void __launch_bounds__(WIDE_THREADS, 2)
    kd_kl_loss_wide(const float* __restrict__ s, const float* __restrict__ t,
                    const float* __restrict__ w, int n, int K, int chunk,
                    float T, int want_ds, float* __restrict__ kl,
                    float* __restrict__ loss, float* __restrict__ ds,
                    float* __restrict__ partials,
                    unsigned* __restrict__ ticket) {
  extern __shared__ float4 wide_smem[];
  __shared__ float2 red[WIDE_WARPS];
  __shared__ float2 xch[3];  // this block's max, sums of exps, KL share
  __shared__ float denom_s;
  __shared__ bool is_last;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int row = static_cast<int>(blockIdx.x / cluster.num_blocks());
  const int tid = threadIdx.x;
  const size_t client = blockIdx.y;
  s += client * n * K;
  t += client * n * K;
  if (w != nullptr) w += client * n;
  kl += client * n;
  loss += client;
  if (want_ds) ds += client * n * K;
  partials += client * n;
  ticket += client;
  const int c0 = rank * chunk;
  const int len = min(chunk, K - c0);
  const size_t off = static_cast<size_t>(row) * K + c0;
  const float* const sp = s + off;
  const float* const tp = t + off;
  if (tid < WARP) {
    const float d = weight_denominator(w, n, tid);
    if (tid == 0) denom_s = d;
  }

  // the chunk over T and its maxima; then the row's, from every rank
  float* s_s = nullptr;  // s/T of the chunk
  float* s_t = nullptr;  // t/T, then exp(tl)
  float2 mx = make_float2(-INFINITY, -INFINITY);
  if constexpr (RESIDENT) {
    float* const smem = reinterpret_cast<float*>(wide_smem);
    load_chunks(sp, tp, smem, smem + chunk + 4, len, T, &s_s, &s_t, &mx);
  } else {
    for (int i = tid; i < len; i += WIDE_THREADS) {
      mx.x = fmaxf(mx.x, sp[i] / T);
      mx.y = fmaxf(mx.y, tp[i] / T);
    }
  }
  auto sv = [&](int i) { return RESIDENT ? s_s[i] : sp[i] / T; };
  auto tv = [&](int i) { return RESIDENT ? s_t[i] : tp[i] / T; };
  mx = block_reduce2<true>(mx, red);  // also orders the chunk's stores
  if (tid == 0) xch[0] = mx;
  cluster.sync();
  mx = cluster_reduce2<true>(cluster, &xch[0]);

  // log-sum-exps, stabilised by the row's max
  float2 se = make_float2(0.f, 0.f);
  for (int i = tid; i < len; i += WIDE_THREADS) {
    se.x += expf(sv(i) - mx.x);
    se.y += expf(tv(i) - mx.y);
  }
  se = block_reduce2<false>(se, red);
  if (tid == 0) xch[1] = se;
  cluster.sync();
  se = cluster_reduce2<false>(cluster, &xch[1]);
  const float s_lse = logf(se.x) + mx.x;
  const float t_lse = logf(se.y) + mx.y;

  // sum_k t^ (log t^ - log s^), exp(tl) kept for ds
  float acc = 0.f;
  for (int i = tid; i < len; i += WIDE_THREADS) {
    const float sl = sv(i) - s_lse;
    const float tl = tv(i) - t_lse;
    const float e = expf(tl);
    acc += e * (tl - sl);
    if constexpr (RESIDENT) s_t[i] = e;
  }
  float2 part = block_reduce2<false>(make_float2(acc, 0.f), red);
  if (tid == 0) xch[2] = part;
  cluster.sync();
  part = cluster_reduce2<false>(cluster, &xch[2]);
  cluster_arrive();  // this block's reads of its peers are done
  const float k = part.x * T * T;
  const float wi = w != nullptr ? w[row] : 1.f;
  const float denom = denom_s;
  if (want_ds) {
    // the weighted mean's cotangent w_i / max(sum w, 1) (1/n without w)
    const float gt = wi / denom * T;
    float* const dsp = ds + off;
    for (int i = tid; i < len; i += WIDE_THREADS) {
      const float et = RESIDENT ? s_t[i] : expf(tv(i) - t_lse);
      dsp[i] = gt * (expf(sv(i) - s_lse) - et);
    }
  }
  cluster_wait();  // no peer reads this block's slots any more
  if (rank != 0) return;
  // the row's w_i kl_i in its slot; the last row to finish, told by an
  // integer ticket, sums the slots in a fixed order and resets the ticket
  if (tid == 0) {
    kl[row] = k;
    partials[row] = wi * k;
    __threadfence();  // the slot is visible before the ticket is taken
    is_last = atomicAdd(ticket, 1u) == static_cast<unsigned>(n - 1);
  }
  __syncthreads();
  if (!is_last) return;
  float tot = 0.f;
  for (int b = tid; b < n; b += WIDE_THREADS)
    tot += __ldcg(partials + b);  // from L2: other blocks wrote them
  tot = block_reduce2<false>(make_float2(tot, 0.f), red).x;
  if (tid == 0) {
    *loss = tot / denom;
    *ticket = 0u;
  }
}

// Once a device: the resident kernel's shared memory, and clusters past 8
// for both kernels.
cudaError_t wide_attributes() {
  static bool done[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 0 && dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kd_kl_loss_wide<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             2 * (WIDE_RESIDENT_MAX + 4) * sizeof(float));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kd_kl_loss_wide<true>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kd_kl_loss_wide<false>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  if (err == cudaSuccess && dev >= 0 && dev < MAX_DEVICES) done[dev] = true;
  return err;
}

// The launch configuration of the wide route at K columns: grid (n times
// the cluster size, C), the cluster on x.
struct WideLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int chunk;
  bool resident;
  WideLaunch(int C, int n, int K, cudaStream_t stream) : cfg{}, attr{} {
    const int nb = wide_blocks(K);
    chunk = wide_chunk(K);
    resident = chunk <= WIDE_RESIDENT_MAX;
    cfg.gridDim = dim3(static_cast<unsigned>(n) * nb, C, 1);
    cfg.blockDim = dim3(WIDE_THREADS, 1, 1);
    cfg.dynamicSmemBytes = resident ? 2 * (chunk + 4) * sizeof(float) : 0;
    cfg.stream = stream;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = nb;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
};

int launch_wide(const void* s, const void* t, const void* w, int C, int n,
                int K, float T, int want_ds, void* kl, void* loss, void* ds,
                void* partials, void* ticket, cudaStream_t stream) {
  if (static_cast<long long>(n) * wide_blocks(K) > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaError_t err = wide_attributes();
  if (err != cudaSuccess) return err;
  const WideLaunch L(C, n, K, stream);
  const auto* sp = static_cast<const float*>(s);
  const auto* tp = static_cast<const float*>(t);
  const auto* wp = static_cast<const float*>(w);
  auto* klp = static_cast<float*>(kl);
  auto* lossp = static_cast<float*>(loss);
  auto* dsp = static_cast<float*>(ds);
  auto* pp = static_cast<float*>(partials);
  auto* tk = static_cast<unsigned*>(ticket);
  err = L.resident
            ? cudaLaunchKernelEx(&L.cfg, kd_kl_loss_wide<true>, sp, tp, wp, n,
                                 K, L.chunk, T, want_ds, klp, lossp, dsp, pp,
                                 tk)
            : cudaLaunchKernelEx(&L.cfg, kd_kl_loss_wide<false>, sp, tp, wp,
                                 n, K, L.chunk, T, want_ds, klp, lossp, dsp,
                                 pp, tk);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

__global__ void noop() {}

inline dim3 grid_for(int n) { return dim3((n + ROWS - 1) / ROWS); }

}  // namespace

extern "C" {

// s, t (n, K) f32; out (n,) f32.
int repro_kd_kl_fwd(const void* s, const void* t, int n, int K, float T,
                    void* out, void* stream) {
  kd_kl_fwd<<<grid_for(n), ROWS * WARP, 0,
              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s), static_cast<const float*>(t), n, K, T,
      static_cast<float*>(out));
  return cudaGetLastError();
}

// s, t (n, K), g (n,) f32; ds (n, K) f32.
int repro_kd_kl_bwd_ds(const void* s, const void* t, const void* g, int n,
                       int K, float T, void* ds, void* stream) {
  kd_kl_bwd_ds<<<grid_for(n), ROWS * WARP, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s), static_cast<const float*>(t),
      static_cast<const float*>(g), n, K, T, static_cast<float*>(ds));
  return cudaGetLastError();
}

// s, t (n, K), g (n,) f32; dt (n, K) f32.
int repro_kd_kl_bwd_dt(const void* s, const void* t, const void* g, int n,
                       int K, float T, void* dt, void* stream) {
  kd_kl_bwd_dt<<<grid_for(n), ROWS * WARP, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s), static_cast<const float*>(t),
      static_cast<const float*>(g), n, K, T, static_cast<float*>(dt));
  return cudaGetLastError();
}

// s, t (n, K) f32; w (n,) f32 or null (the unweighted mean); kl (n,),
// loss (1,) f32; ds (n, K) f32 when want_ds, else unused (may be null);
// partials f32 scratch of n floats (a block of 16 rows or, for K > 1024,
// a row leaves one); ticket one unsigned, zero between launches (the
// kernel leaves it so), used by one stream at a time.
int repro_kd_kl_loss_clients(const void* s, const void* t, const void* w,
                             int C, int n, int K, float T, int want_ds,
                             void* kl, void* loss, void* ds, void* partials,
                             void* tickets, void* stream);

int repro_kd_kl_loss(const void* s, const void* t, const void* w, int n,
                     int K, float T, int want_ds, void* kl, void* loss,
                     void* ds, void* partials, void* ticket, void* stream) {
  return repro_kd_kl_loss_clients(s, t, w, 1, n, K, T, want_ds, kl, loss, ds,
                                  partials, ticket, stream);
}

// C clients in one launch: s, t (C, n, K) f32; w (C, n) f32 or null; kl
// (C, n), loss (C,) f32, client c's loss the weighted mean over its own
// rows; ds (C, n, K) when want_ds; partials f32 scratch, a client's
// share as for repro_kd_kl_loss (C of them); tickets C unsigned, zero
// between launches. Client c's outputs
// are bit for bit those of a repro_kd_kl_loss launch on its slices.
int repro_kd_kl_loss_clients(const void* s, const void* t, const void* w,
                             int C, int n, int K, float T, int want_ds,
                             void* kl, void* loss, void* ds, void* partials,
                             void* tickets, void* stream) {
  if (C < 1 || C > 65535 || n < 1 || K < 1) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int v = (K + WARP - 1) / WARP;  // elements a lane holds
#define REPRO_LOSS(ROW)                                                    \
  launch_loss<ROW>(s, t, w, C, n, K, T, want_ds, kl, loss, ds, partials, \
                   tickets, st)
  if (v <= 1) return REPRO_LOSS(RegRow<1>);
  if (v <= 2) return REPRO_LOSS(RegRow<2>);
  if (v <= 4) return REPRO_LOSS(RegRow<4>);
  if (v <= 8) return REPRO_LOSS(RegRow<8>);
  if (v <= 16) return REPRO_LOSS(RegRow<16>);
  if (v <= 32) return REPRO_LOSS(RegRow<32>);
#undef REPRO_LOSS
  // K > 1024: a cluster of blocks a row
  return launch_wide(s, t, w, C, n, K, T, want_ds, kl, loss, ds, partials,
                     tickets, st);
}

// The fused loss's wide-row route at K columns (K > 1024): the blocks a
// row spreads over into *blocks, and the clusters the current device holds
// at once into *clusters (chip_smoke.py reports both). Returns a CUDA
// error code.
int repro_kd_kl_loss_wide_route(int K, int* blocks, int* clusters) {
  if (K <= 32 * WARP) return cudaErrorInvalidValue;
  cudaError_t err = wide_attributes();
  if (err != cudaSuccess) return err;
  const WideLaunch L(1, 1, K, nullptr);
  *blocks = wide_blocks(K);
  return L.resident ? cudaOccupancyMaxActiveClusters(
                          clusters, kd_kl_loss_wide<true>, &L.cfg)
                    : cudaOccupancyMaxActiveClusters(
                          clusters, kd_kl_loss_wide<false>, &L.cfg);
}

// An empty kernel through the same C interface: the launch floor that
// chip_smoke.py times beside the fused loss.
int repro_kd_kl_noop(void* stream) {
  noop<<<1, WARP, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
