// Flash attention: o = softmax(q.k^T / sqrt(h) + mask) . v per (batch,
// head), causal or full, with GQA (query head n reads kv head n / group).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:76,
// flash_attention_pallas (body _kernel :30): q (B, N, Sq, h) and
// GQA-expanded k, v (B, N, Sk, h), padded by the wrapper to 256 x 256
// blocks; online-softmax state (running max, denominator, accumulator) in
// VMEM scratch across a sequential fourth grid axis over KV blocks; keys at
// or past the true length masked; rows with every key masked set to 0.
//
// What bounds it on an H100: at the transformer path's sequences (S = 16)
// the bytes. A training step (B = 64, N = 32, Nkv = 8, h = 128) reads q
// 16.8 MB and k, v 4.2 MB each and writes o 16.8 MB: 42 MB, 12.5 us at
// 3.35 TB/s, against ~0.14 GFLOP of causal multiply-adds, 2 us at the
// 67 TFLOP/s fp32 rate. That is 3.4 FLOP a byte, far below the fp32 ridge
// of ~20, so tensor cores would not help (and would need TF32 or bf16,
// which the port's fp32 parity rules out): the design reads each byte once,
// with wide asynchronous copies, and keeps the arithmetic off the critical
// path. On one long causal sequence (S = 4096) the operations bound it:
// ~137 GFLOP, 2.05 ms at the fp32 rate.
//
// Short route (Sq <= 32, the transformer path). The work items are
// (row tile, kv head, batch); a tile holds up to 64 rows, the (query head
// of the kv head's group, query position) pairs, position-major. At G = 4
// and S = 16 a tile is the whole group, so each kv head's keys and values
// are read once for its four query heads (a larger group spans several
// tiles). Persistent blocks of 256 threads, two an SM, walk the items,
// each through two shared-memory stages: while a block computes and
// stores one item, the TMA brings in its next (cp.async.bulk, one copy a
// row, completion counted in bytes on an mbarrier), so the loads,
// arithmetic and stores of different items overlap. Shared rows are
// padded by one 16-byte chunk (the TMA's linear copies cannot swizzle),
// so the rows a warp reads at one chunk fall in distinct bank groups and
// every shared read is a conflict-free float4. A warp holds 8 rows x 16
// keys: each thread 2 rows x 2 keys of the scores (4 float4 reads feed 16
// FMAs) and 2 rows x 16 columns of the output (4 float4 reads and 2
// shuffles feed 32 FMAs). A row's keys lie in 8 lanes of one warp: the row
// max and sum reduce by shuffles among them, and the probabilities reach
// the P.V product by shuffles too. Causal, a warp stops at the last key
// its rows see. o is scaled by one reciprocal a row and written by float4
// stores through its strides. The KV axis loops in tiles of 16 keys with
// the online softmax (a later tile also comes by TMA), so any Sk works;
// 16 keys (not 32) keep a stage at 50 KB at h = 128, two stages for each
// of two blocks an SM. Two blocks of 256 threads leave 128 registers a
// thread: 124 at h = 128, no spills.
//
// Long route (Sq > 32, off the transformer path): one block of 256
// threads per (64-row query tile, head, batch) loops over 32-key tiles in
// shared memory (padded rows, 4-byte loads), each thread 4 rows x 2 keys
// and 4 rows x h/16 columns; causal KV tiles wholly above a query tile are
// skipped and query tiles run heaviest first.
//
// Both routes read the kv head in place (no repeat copy) and any layout
// whose last axis is contiguous through its strides, so the model's
// (B, S, N, h) tensors need no transpose copy; the short route needs
// 16-byte aligned pointers and strides that are multiples of 4 elements
// (the wrapper checks). Rows with every key masked give 0 and the
// denominator is floored at 1e-30, as kernel.py:61-63,72 do. Every product
// is an IEEE fp32 FMA (no TF32) and every sum has a fixed order, so two
// runs give the same bits, and so do a strided and a contiguous copy.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

struct Strides {                          // in elements; the h axis is 1
  long long b, n, s;
};

// ------------------------------------------------------------ short route

constexpr int SHORT_SQ = 32;              // the short route takes Sq <= 32
constexpr int SBM = 64;                   // rows a work item (row tile)
constexpr int SBK = 16;                   // keys a KV tile
constexpr int RR = 2;                     // rows a thread: ra + 4i, i < RR
constexpr int WROWS = 4 * RR;             // rows a warp (x 16 keys)
constexpr int STHREADS = 32 * SBM / WROWS;  // 8 warps
constexpr int SBLOCKS = 2;                // blocks an SM (<= 128 registers)
constexpr int NSTAGE = 2;                 // shared-memory stages a block

template <int HD>
__host__ __device__ constexpr int row_floats() {  // padded shared row
  return HD + 4;
}

template <int HD>
__host__ __device__ constexpr int stage_floats() {  // q, one K, one V tile
  return (SBM + 2 * SBK) * row_floats<HD>();
}

template <int HD>
__host__ __device__ constexpr int short_smem_bytes() {  // + the barriers
  return NSTAGE * stage_floats<HD>() * 4 + (NSTAGE + 1) * 8;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned phase) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(phase)
      : "memory");
}

// TMA: one contiguous run of global memory into shared memory, counted on
// the barrier in bytes
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// order this thread's shared-memory accesses before later TMA accesses
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

__device__ __forceinline__ void fma4(float4& acc, float p, float4 v) {
  acc.x = fmaf(p, v.x, acc.x);
  acc.y = fmaf(p, v.y, acc.y);
  acc.z = fmaf(p, v.z, acc.z);
  acc.w = fmaf(p, v.w, acc.w);
}

__device__ __forceinline__ float row_max8(float x) {
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 4, 8));
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 2, 8));
  return fmaxf(x, __shfl_xor_sync(FULL, x, 1, 8));
}

__device__ __forceinline__ float row_sum8(float x) {
  x += __shfl_xor_sync(FULL, x, 4, 8);
  x += __shfl_xor_sync(FULL, x, 2, 8);
  return x + __shfl_xor_sync(FULL, x, 1, 8);
}

// Scores of rows ra + 4i (i < RR) against keys kx + 8jj (jj < NK; a warp
// whose rows see at most 8 keys of the tile takes NK = 1), each summed
// over h in order. Rows are padded by one 16-byte chunk, so the rows a
// warp reads at one chunk fall in distinct bank groups.
template <int HD, int NK>
__device__ __forceinline__ void tile_scores(const float* s_q,
                                            const float* s_k, int ra,
                                            int kx, float (&s)[RR][2]) {
  constexpr int LD = row_floats<HD>();
#pragma unroll
  for (int c = 0; c < HD / 4; ++c) {
    float4 kk[NK];
#pragma unroll
    for (int jj = 0; jj < NK; ++jj)
      kk[jj] = ld4(s_k + (kx + 8 * jj) * LD + 4 * c);
#pragma unroll
    for (int i = 0; i < RR; ++i) {
      const float4 qq = ld4(s_q + (ra + 4 * i) * LD + 4 * c);
#pragma unroll
      for (int jj = 0; jj < NK; ++jj) s[i][jj] = dot4(qq, kk[jj], s[i][jj]);
    }
  }
}

// One work item of the short route: a row tile of one (batch, kv head).
// Tile row r is position (r0 + r) / group of query head
// kvh * group + (r0 + r) % group.
struct Item {
  int b, kvh, r0;
};

__device__ __forceinline__ Item decode(int it, int tiles, int kv_heads) {
  const int rest = it / tiles;
  const int b = rest / kv_heads;
  const int tile = tiles - 1 - (it - rest * tiles);  // longest causal first
  return Item{b, rest - b * kv_heads, tile * SBM};
}

struct ShortArgs {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  int kv_heads, sq, sk, group, tiles;
  int items;
  Strides qs, ks, vs, os;
  float scale;
  int causal;
};

// Issue the TMA copies of an item's query rows 0 .. nq - 1 (none when nq
// is 0) and of its key and value rows k0 .. k0 + nk - 1 into one stage,
// with their byte count on bar. Copy c (query rows, then key rows, then
// value rows) goes to lane c / NWARPS of warp c % NWARPS, so each warp
// issues a few. Key and value rows nk .. SBK - 1 are zeroed by the block
// (a key past sk has p = 0, and 0 times a stale value could be NaN);
// query rows past the last row stay stale: they are computed and never
// stored.
template <int HD>
__device__ __forceinline__ void copy_rows(float* s_q, uint64_t* bar,
                                          const ShortArgs& a, Item w, int nq,
                                          int k0, int nk, int tid) {
  constexpr int LD = row_floats<HD>();
  constexpr unsigned ROW = HD * 4;
  constexpr int NWARPS = STHREADS / 32;
  float* const s_k = s_q + SBM * LD;
  float* const s_v = s_k + SBK * LD;
  if (nk < SBK) {
    for (int idx = tid; idx < (SBK - nk) * HD; idx += STHREADS) {
      const int r = nk + idx / HD;
      s_k[r * LD + idx % HD] = 0.f;
      s_v[r * LD + idx % HD] = 0.f;
    }
    fence_async_shared();                 // before a later TMA write there
  }
  if (tid == 0) mbar_expect_tx(bar, (nq + 2 * nk) * ROW);
  const int c = (tid & 31) * NWARPS + (tid >> 5);
  if (c < nq) {
    const int rr = w.r0 + c;
    const int pos = rr / a.group;
    const int j = w.kvh * a.group + rr - pos * a.group;
    bulk_load(s_q + c * LD,
              a.q + static_cast<long long>(w.b) * a.qs.b + j * a.qs.n +
                  pos * a.qs.s,
              ROW, bar);
  } else if (c >= SBM && c < SBM + nk) {
    const int r = c - SBM;
    bulk_load(s_k + r * LD,
              a.k + static_cast<long long>(w.b) * a.ks.b + w.kvh * a.ks.n +
                  (k0 + r) * a.ks.s,
              ROW, bar);
  } else if (c >= SBM + SBK && c < SBM + SBK + nk) {
    const int r = c - SBM - SBK;
    bulk_load(s_v + r * LD,
              a.v + static_cast<long long>(w.b) * a.vs.b + w.kvh * a.vs.n +
                  (k0 + r) * a.vs.s,
              ROW, bar);
  }
}

// Start an item: its query rows and first K, V tile.
template <int HD>
__device__ __forceinline__ void start_item(float* stage, uint64_t* bar,
                                           const ShortArgs& a, Item w,
                                           int tid) {
  copy_rows<HD>(stage, bar, a, w, min(SBM, a.group * a.sq - w.r0), 0,
                min(SBK, a.sk), tid);
}

// Persistent blocks, SBLOCKS an SM, each walking the items with stride
// gridDim.x through NSTAGE shared-memory stages: the next item's TMA
// copies are in flight while this item is computed and stored, so loads,
// arithmetic and stores of different items overlap on every SM. Barrier
// NSTAGE counts the copies of a later K, V tile (Sk > 16).
template <int HD>
__global__ void __launch_bounds__(STHREADS, SBLOCKS)
attention_short_kernel(const ShortArgs a) {
  constexpr int LD = row_floats<HD>();
  constexpr int C = HD / 4;               // 16-byte chunks a row
  constexpr int RC = C < 8 ? 1 : C / 8;   // output chunks a thread
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  uint64_t* const bars =
      reinterpret_cast<uint64_t*>(smem + NSTAGE * stage_floats<HD>());

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int kx = lane & 7;                // keys kx, kx + 8; chunks kx + 8j
  const int wr = (tid >> 5) * WROWS;      // the warp's first row
  const int ra = wr + (lane >> 3);        // rows ra + 4i, i < RR
  const int rows = a.group * a.sq;
  const int sk = a.sk, group = a.group, causal = a.causal;

  if (tid == 0) {
    for (int i = 0; i <= NSTAGE; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the first NSTAGE - 1 items go in flight at once; each iteration then
  // refills the stage the last one freed
  for (int i = 0; i < NSTAGE - 1; ++i) {
    const int it = blockIdx.x + i * gridDim.x;
    if (it < a.items)
      start_item<HD>(smem + i * stage_floats<HD>(), &bars[i], a,
                     decode(it, a.tiles, a.kv_heads), tid);
  }
  int n = 0;                              // items this block has done
  int reloads = 0;                        // K, V tiles past the first
  for (int it = blockIdx.x; it < a.items; it += gridDim.x, ++n) {
    const int st = n % NSTAGE;
    float* const s_q = smem + st * stage_floats<HD>();
    float* const s_k = s_q + SBM * LD;
    float* const s_v = s_k + SBK * LD;
    const int ahead = it + (NSTAGE - 1) * gridDim.x;
    if (ahead < a.items) {
      const int sa = (n + NSTAGE - 1) % NSTAGE;
      start_item<HD>(smem + sa * stage_floats<HD>(), &bars[sa], a,
                     decode(ahead, a.tiles, a.kv_heads), tid);
    }
    mbar_wait(&bars[st], (n / NSTAGE) & 1);
    __syncthreads();                      // and the zeroed rows

    const Item w = decode(it, a.tiles, a.kv_heads);
    const int r0 = w.r0;
    // causal: keys past the tile's last position are masked for every
    // row, and past the warp's last position for every row of the warp
    const int last = min(rows, r0 + SBM) - 1;
    const int kend = causal ? min(sk, last / group + 1) : sk;
    const int wlast = min(rows, r0 + wr + WROWS) - 1;
    const int wend = r0 + wr >= rows ? 0
                     : causal        ? min(kend, wlast / group + 1)
                                     : kend;
    int lim[RR];                          // a row's keys: kpos < lim
#pragma unroll
    for (int i = 0; i < RR; ++i)
      lim[i] = causal ? min(sk, (r0 + ra + 4 * i) / group + 1) : sk;

    float m[RR], l[RR];                   // l: this lane's share of the sum
    float4 acc[RR][RC];
#pragma unroll
    for (int i = 0; i < RR; ++i) {
      m[i] = NEG_INF;
      l[i] = 0.f;
#pragma unroll
      for (int cc = 0; cc < RC; ++cc)
        acc[i][cc] = make_float4(0.f, 0.f, 0.f, 0.f);
    }

    for (int k0 = 0; k0 < kend; k0 += SBK) {
      if (k0 > 0) {                       // the next K, V tile (Sk > 16)
        __syncthreads();
        copy_rows<HD>(s_q, &bars[NSTAGE], a, w, 0, k0, min(SBK, sk - k0),
                      tid);
        mbar_wait(&bars[NSTAGE], reloads++ & 1);
        __syncthreads();                  // and the zeroed rows
      }
      // keys of this tile that a row of this warp may see (warp-uniform)
      const int kw = min(SBK, wend - k0);
      if (kw <= 0) continue;

      float s[RR][2] = {};
      if (kw > 8)
        tile_scores<HD, 2>(s_q, s_k, ra, kx, s);
      else
        tile_scores<HD, 1>(s_q, s_k, ra, kx, s);

      // online softmax; a row's 16 keys lie in the 8 lanes kx = 0..7
#pragma unroll
      for (int i = 0; i < RR; ++i) {
        float mc = NEG_INF;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int kpos = k0 + kx + 8 * jj;
          const bool valid = kpos < lim[i];
          s[i][jj] = valid ? s[i][jj] * a.scale : NEG_INF;
          mc = fmaxf(mc, s[i][jj]);
        }
        const float m_new = fmaxf(m[i], row_max8(mc));
        // a row with every key masked so far keeps p = 0 (exp(0) is 1)
        const float alpha = (m[i] == NEG_INF) ? 0.f : expf(m[i] - m_new);
        float ps = 0.f;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          s[i][jj] = (m_new == NEG_INF) ? 0.f : expf(s[i][jj] - m_new);
          ps += s[i][jj];
        }
        l[i] = alpha * l[i] + ps;
#pragma unroll
        for (int cc = 0; cc < RC; ++cc) {
          acc[i][cc].x *= alpha;
          acc[i][cc].y *= alpha;
          acc[i][cc].z *= alpha;
          acc[i][cc].w *= alpha;
        }
        m[i] = m_new;
      }

      // o += p . v over the keys the warp may see (p = 0 past them); key
      // j's probability of a row is in lane j % 8 of the row's 8 lanes
#pragma unroll 4
      for (int j = 0; j < kw; ++j) {
        float p[RR];
#pragma unroll
        for (int i = 0; i < RR; ++i)
          p[i] = __shfl_sync(FULL, j < 8 ? s[i][0] : s[i][1], j & 7, 8);
#pragma unroll
        for (int cc = 0; cc < RC; ++cc) {
          if (C >= 8 || kx < C) {
            const float4 vv = ld4(s_v + j * LD + 4 * (kx + 8 * cc));
#pragma unroll
            for (int i = 0; i < RR; ++i) fma4(acc[i][cc], p[i], vv);
          }
        }
      }
    }

    // o = acc / l, by one reciprocal a row (0 * 1e30 = 0 for a masked
    // row), in float4 stores through o's strides
#pragma unroll
    for (int i = 0; i < RR; ++i) {
      const float inv = 1.f / fmaxf(row_sum8(l[i]), 1e-30f);
      const int rr = r0 + ra + 4 * i;
      if (rr >= rows) continue;
      const int pos = rr / group;
      float* orow = a.o + static_cast<long long>(w.b) * a.os.b +
                    (w.kvh * group + rr - pos * group) * a.os.n +
                    pos * a.os.s;
#pragma unroll
      for (int cc = 0; cc < RC; ++cc) {
        if (C >= 8 || kx < C) {
          const float4 t = acc[i][cc];
          *reinterpret_cast<float4*>(orow + 4 * (kx + 8 * cc)) =
              make_float4(t.x * inv, t.y * inv, t.z * inv, t.w * inv);
        }
      }
    }
    __syncthreads();                      // this stage is free to refill
  }
}

constexpr int MAX_DEVICES = 64;

// Set once a device: the stages' dynamic shared memory (99 KB at h = 128)
// and the largest carveout, which two such blocks an SM need.
template <int HD>
cudaError_t short_attributes(int dev) {
  static bool done[MAX_DEVICES] = {};
  if (dev >= 0 && dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      attention_short_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      short_smem_bytes<HD>());
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attention_short_kernel<HD>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev >= 0 && dev < MAX_DEVICES) done[dev] = true;
  return err;
}

template <int HD>
cudaError_t launch_short(const float* q, const float* k, const float* v,
                         float* o, int batch, int kv_heads, int sq, int sk,
                         int group, const Strides* st, float scale,
                         int causal, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = short_attributes<HD>(dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  ShortArgs a{q, k, v, o, kv_heads, sq, sk, group,
              (group * sq + SBM - 1) / SBM, 0, st[0], st[1], st[2], st[3],
              scale, causal};
  const long long items = static_cast<long long>(a.tiles) * kv_heads * batch;
  if (items > (1LL << 30)) return cudaErrorInvalidValue;
  a.items = static_cast<int>(items);
  const int grid = a.items < sms * SBLOCKS ? a.items : sms * SBLOCKS;
  attention_short_kernel<HD>
      <<<grid, STHREADS, short_smem_bytes<HD>(), stream>>>(a);
  return cudaGetLastError();
}

template <int HD>
cudaError_t short_occupancy(int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = short_attributes<HD>(dev);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, attention_short_kernel<HD>, STHREADS, short_smem_bytes<HD>());
}

// ------------------------------------------------------------- long route

constexpr int TX = 16;                    // threads across keys / columns
constexpr int TY = 16;                    // threads across query rows
constexpr int LTHREADS = TX * TY;
constexpr int LBQ = 64;                   // query rows a block
constexpr int LBK = 32;                   // keys a KV tile

template <int HD>
constexpr int long_smem_floats() {
  return LBQ * (HD + 1) + LBK * (HD + 1) + LBK * HD + LBQ * (LBK + 1);
}

// One block per (query tile, head, batch); thread (ty, tx) owns rows
// ty + 16i (RM of them) and, for those rows, score columns tx + 16j and
// output columns tx + 16c; a row's 16 threads are one half-warp, so row
// max and row sum reduce with shuffles.
template <int HD>
__global__ void __launch_bounds__(LTHREADS)
attention_long_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      int sq, int sk, int group, Strides qs, Strides ks,
                      Strides vs, Strides os, float scale, int causal) {
  constexpr int BQ = LBQ;
  constexpr int BK = LBK;
  constexpr int RM = BQ / TY;             // query rows per thread
  constexpr int RN = BK / TX;             // score columns per thread
  constexpr int RC = HD / TX;             // output columns per thread
  constexpr int QLD = HD + 1;             // padded rows: no bank conflicts
  constexpr int KLD = HD + 1;
  constexpr int PLD = BK + 1;
  extern __shared__ float smem[];
  float* s_q = smem;                      // (BQ, QLD) this tile's queries
  float* s_k = s_q + BQ * QLD;            // (BK, KLD) keys of a KV tile
  float* s_v = s_k + BK * KLD;            // (BK, HD) values of a KV tile
  float* s_p = s_v + BK * HD;             // (BQ, PLD) probabilities

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int n = blockIdx.y;
  const long long b = blockIdx.z;

  const float* qb = q + b * qs.b + n * qs.n;
  const float* kb = k + b * ks.b + (n / group) * ks.n;
  const float* vb = v + b * vs.b + (n / group) * vs.n;
  float* ob = o + b * os.b + n * os.n;

  for (int idx = tid; idx < BQ * HD; idx += LTHREADS) {
    const int r = idx / HD;
    const int d = idx - r * HD;
    s_q[r * QLD + d] = (q0 + r < sq) ? qb[(q0 + r) * qs.s + d] : 0.f;
  }

  float m[RM];
  float l[RM];                            // this thread's columns' share
  float acc[RM][RC];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < RC; ++c) acc[i][c] = 0.f;
  }

  // causal: keys past the tile's last query are masked for every row
  const int kend = causal ? min(sk, q0 + BQ) : sk;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // s_q is stored; the last tile's reads are done
    for (int idx = tid; idx < BK * HD; idx += LTHREADS) {
      const int r = idx / HD;
      const int d = idx - r * HD;
      const bool in = k0 + r < sk;
      s_k[r * KLD + d] = in ? kb[(k0 + r) * ks.s + d] : 0.f;
      s_v[r * HD + d] = in ? vb[(k0 + r) * vs.s + d] : 0.f;
    }
    __syncthreads();

    float s[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float a[RM];
      float kk[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = s_q[(ty + TY * i) * QLD + d];
#pragma unroll
      for (int j = 0; j < RN; ++j) kk[j] = s_k[(tx + TX * j) * KLD + d];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qpos = q0 + ty + TY * i;
      float mc = NEG_INF;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int kpos = k0 + tx + TX * j;
        const bool valid = kpos < sk && (!causal || kpos <= qpos);
        s[i][j] = valid ? s[i][j] * scale : NEG_INF;
        mc = fmaxf(mc, s[i][j]);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        mc = fmaxf(mc, __shfl_xor_sync(FULL, mc, off, TX));
      const float m_new = fmaxf(m[i], mc);
      // a row with every key masked so far keeps p = 0 (exp(0) would be 1)
      const float alpha = (m[i] == NEG_INF) ? 0.f : expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const float p = (m_new == NEG_INF) ? 0.f : expf(s[i][j] - m_new);
        s_p[(ty + TY * i) * PLD + tx + TX * j] = p;
        ps += p;
      }
      l[i] = alpha * l[i] + ps;
#pragma unroll
      for (int c = 0; c < RC; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float p[RM];
      float vv[RC];
#pragma unroll
      for (int i = 0; i < RM; ++i) p[i] = s_p[(ty + TY * i) * PLD + j];
#pragma unroll
      for (int c = 0; c < RC; ++c) vv[c] = s_v[j * HD + tx + TX * c];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < RC; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    float lt = l[i];
#pragma unroll
    for (int off = TX / 2; off > 0; off >>= 1)
      lt += __shfl_xor_sync(FULL, lt, off, TX);
    const int qpos = q0 + ty + TY * i;
    if (qpos >= sq) continue;
    const float den = fmaxf(lt, 1e-30f);  // 0 / 1e-30 = 0 for masked rows
    float* orow = ob + qpos * os.s;
#pragma unroll
    for (int c = 0; c < RC; ++c) orow[tx + TX * c] = acc[i][c] / den;
  }
}

template <int HD>
cudaError_t launch_long(const float* q, const float* k, const float* v,
                        float* o, int batch, int heads, int sq, int sk,
                        int group, const Strides* st, float scale, int causal,
                        cudaStream_t stream) {
  constexpr int smem = long_smem_floats<HD>() * sizeof(float);
  auto kern = attention_long_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + LBQ - 1) / LBQ, heads, batch);
  kern<<<grid, LTHREADS, smem, stream>>>(q, k, v, o, sq, sk, group, st[0],
                                         st[1], st[2], st[3], scale, causal);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   int batch, int heads, int kv_heads, int sq, int sk,
                   const Strides* st, float scale, int causal,
                   cudaStream_t stream) {
  const int group = heads / kv_heads;
  if (sq <= SHORT_SQ)
    return launch_short<HD>(q, k, v, o, batch, kv_heads, sq, sk, group, st,
                            scale, causal, stream);
  return launch_long<HD>(q, k, v, o, batch, heads, sq, sk, group, st, scale,
                         causal, stream);
}

}  // namespace

extern "C" {

// q (B, N, Sq, h), k and v (B, Nkv, Sk, h), o (B, N, Sq, h), all f32 with
// the h axis contiguous; strides holds 12 element strides, (batch, head,
// sequence) of q, k, v and o in that order. h is one of 16, 32, 64, 128;
// the caller checks shapes, that Nkv divides N, and (for Sq <= 32) that
// every pointer is 16-byte aligned and every stride a multiple of 4.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// any other h).
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* o, int batch, int heads, int kv_heads,
                          int sq, int sk, int h, const long long* strides,
                          int causal, void* stream) {
  Strides st[4];
  for (int t = 0; t < 4; ++t)
    st[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  // 1/sqrt(h) in double, rounded once to f32: the scalar the plain version
  // multiplies its f32 logits by
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(h)));
  const auto* qp = static_cast<const float*>(q);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  auto* op = static_cast<float*>(o);
  auto s = static_cast<cudaStream_t>(stream);
  switch (h) {
    case 16:
      return launch<16>(qp, kp, vp, op, batch, heads, kv_heads, sq, sk, st,
                        scale, causal, s);
    case 32:
      return launch<32>(qp, kp, vp, op, batch, heads, kv_heads, sq, sk, st,
                        scale, causal, s);
    case 64:
      return launch<64>(qp, kp, vp, op, batch, heads, kv_heads, sq, sk, st,
                        scale, causal, s);
    case 128:
      return launch<128>(qp, kp, vp, op, batch, heads, kv_heads, sq, sk, st,
                         scale, causal, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Blocks of the short route's kernel at head width h that one SM of the
// current device holds at once, into *blocks (the occupancy that
// chip_smoke.py reports). Returns a CUDA error code.
int repro_flash_attention_short_occupancy(int h, int* blocks) {
  switch (h) {
    case 16:
      return short_occupancy<16>(blocks);
    case 32:
      return short_occupancy<32>(blocks);
    case 64:
      return short_occupancy<64>(blocks);
    case 128:
      return short_occupancy<128>(blocks);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
