// The estimation step of KMeans-DRE: for each row of x (t, d), the distance
// to its nearest centroid, sqrt(min_j max(x2 - 2 x.c_j + c2_j, 0)), and the
// ID mask dist <= threshold.
//
// Replaces: src/repro/kernels/kmeans_dist/kernel.py:48, kmeans_dist_pallas
// (body _kernel): x (t, d) f32, centroids (k, d) f32, a scalar threshold ->
// (t,) f32 distances and a (t,) mask (int8 there, bool here); over a
// client axis as the reference's cohort engine vmaps it
// (src/repro/fed/cohort.py:430, :543).
//
// What bounds it on an H100: nothing on the card. The filter's path runs
// t = 512 proxy rows (lm_tokens: 256) at d = 50 (16) against k <= 10
// centroids, and a calibration over one client's ~6000 private rows: 50 KB
// to 1.2 MB read and well under a MFLOP, a fraction of a microsecond of
// memory traffic. A call costs its launch plus a chain of latencies (the
// parameters' first read, one round trip to L2, the sums, the stores), so
// the design keeps that chain to one round trip and no block barrier.
//
// Design.
//  * Narrow rows (d <= 64), the filter's path: a block is one warp. The
//    block's rows are one contiguous range of x; the warp issues every
//    load at entry, the threshold, the rows and the centroids by 16-byte
//    loads (a block's range starts a multiple of 128 d bytes into x), all
//    before the first store to shared memory (a compiler barrier keeps
//    them there), stages the rows, and after one __syncwarp each row's
//    lanes sum x2, x.c_j and c_j2 for every centroid, the centroids read
//    from shared memory as broadcasts: the centroid norms come in the same
//    pass as the cross terms, each sum split over two chains. A row has
//    one lane (any width), or four at the main path's compiled widths (50:
//    a float2 each in turn; 16: a float4 each), so a report's few rows
//    spread over more SMs, added by a butterfly of 2 steps. Compiled
//    widths unroll every loop over the features without a guard.
//    Distances and mask are stored coalesced.
//    Beyond 16 centroids they are taken 16 at a time, all of them resident
//    in shared memory, each lane's row read from global memory.
//  * Wide rows (d > 64): kmeans_rows.cuh's wide_rows_kernel, shared with
//    the Lloyd step's wide route (lanes over features, centroid features
//    staged through shared memory in feature order).
//  * The reference's semantics on non-finite values (kmeans_rows.cuh): a
//    NaN d2 stays NaN through the clamp and the minimum, and the mask
//    dist <= threshold is false for it.
//  * The threshold: a device scalar read where it lies (a threshold
//    calibrated on the device costs no host read), or a value passed with
//    the launch (the calibration's infinite one: no copy to the device).
//  * Clients: the grid's y axis. A launch takes C clients' centroids and
//    thresholds against one shared x (a cohort's report on the round's
//    proxy batch) or against each client's own rows (a cohort's
//    calibration). A block computes exactly what it computes in a launch
//    for its client alone, so each client's outputs are those bits; only
//    the operands' alignment picks the route, and the wrapper keeps every
//    client's operands 16-byte aligned.
//  * Rows past t are masked in the kernel (no padding copy). Fixed orders
//    of summation: two runs give the same bits.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "kmeans_rows.cuh"

namespace {

using kmeans_rows::clamp0;
using kmeans_rows::min_nan;
using kmeans_rows::WARP;

constexpr int MAX_D = 64;        // the narrow routes' widest row
constexpr int ROWS = WARP;       // most rows a narrow block takes
constexpr int KT_MAX = 16;       // centroids a narrow pass
constexpr int MAX_DEVICES = 64;
constexpr int MAX_SHARED = 232448;

__host__ __device__ __forceinline__ int round4(int v) { return (v + 3) / 4 * 4; }

// Row pitch (floats) of the staged rows: d, or d + 4 where 16-byte reads
// at a pitch of an even number of float4s would meet in the same banks.
__host__ __device__ __forceinline__ int x_pitch(int d) {
  return (d % 4 == 0 && (d / 4) % 2 == 0) ? d + 4 : d;
}

template <int V>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
};
template <>
struct Vec<2> {
  using T = float2;
};
template <>
struct Vec<4> {
  using T = float4;
};

template <int V>
__device__ __forceinline__ void unpack(const typename Vec<V>::T& v, float* o) {
  if constexpr (V == 1) {
    o[0] = v;
  } else if constexpr (V == 2) {
    o[0] = v.x;
    o[1] = v.y;
  } else {
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  }
}

struct Thr {
  const float* ptr;  // one device scalar a client, or null: take value
  float value;
  __device__ __forceinline__ float load(int client) const {
    return ptr != nullptr ? __ldg(ptr + client) : value;
  }
};

// Centroid rows the narrow kernel holds in shared memory: k rounded up to
// whole passes of KT (the padding rows are zeros, so the inner loops need
// no guard).
__host__ __device__ __forceinline__ int held_rows(int k, int kt) {
  return (k + kt - 1) / kt * kt;
}

// Lanes a row: four at a compiled width, else one.
template <int D>
__host__ __device__ constexpr int lanes_a_row() { return D > 0 ? 4 : 1; }

// Narrow rows: a block of one warp; LPR lanes a row, so 32 / LPR rows a
// block. KT centroids a pass; V the width of the rows' vector reads
// (d % V == 0); STAGE: the rows come through shared memory by coalesced
// loads (the filter's path, k <= 16), else each lane reads its own row
// from global memory (k > 16, where the shared memory holds the
// centroids). D > 0: the width is known when compiled (the main path's
// 50 and 16), so every loop over the features unrolls fully and its loads
// issue back to back.
template <int KT, int V, bool STAGE, int D>
__global__ void __launch_bounds__(WARP)
    narrow_kernel(const float* __restrict__ x,
                  const float* __restrict__ cents, Thr thr_in, int t,
                  int d_arg, int k, long long x_cs, long long c_cs,
                  float* __restrict__ dist, unsigned char* __restrict__ mask) {
  static_assert(D == 0 || STAGE, "a compiled width is staged");
  constexpr int LPR = lanes_a_row<D>();
  using VT = typename Vec<V>::T;
  constexpr int RPB = WARP / LPR;                 // rows a block
  constexpr int GROUPS = D > 0 ? (D + V - 1) / V : 0;  // V-groups a row
  constexpr int UNROLL = D > 0 ? (GROUPS + LPR - 1) / LPR : 4;
  // float4s a lane holds: the block's rows, and (STAGE) all centroids
  constexpr int XQ = (RPB * MAX_D / 4 + WARP - 1) / WARP;
  constexpr int CQ = (KT * MAX_D / 4 + WARP - 1) / WARP;
  extern __shared__ float4 smem4[];
  const int d = D > 0 ? D : d_arg;
  const int kd = k * d;
  const int held = held_rows(k, KT) * d;          // centroid floats held
  float* s_c = reinterpret_cast<float*>(smem4);  // (held_rows, d)
  float* s_x = s_c + round4(held);                // (RPB, pitch) rows
  const int lane = threadIdx.x;
  const int r = lane / LPR;                       // this lane's row
  const int h = lane % LPR;                       // and part of it
  const int row0 = blockIdx.x * RPB;
  const int rows = min(RPB, t - row0);
  // the client (grid y): its rows x_cs floats on (0: x shared by every
  // client), its centroids c_cs floats on, its outputs t on
  const int client = blockIdx.y;
  const float thr = thr_in.load(client);
  cents += client * c_cs;
  dist += static_cast<size_t>(client) * t;
  mask += static_cast<size_t>(client) * t;
  const float* xb = x + client * x_cs + static_cast<size_t>(row0) * d;
  const bool c16 = (reinterpret_cast<uintptr_t>(cents) & 15) == 0;

  const float* xrow;  // this lane's row
  if constexpr (STAGE) {
    // every load first: the rows (rows * d floats) and the k * d
    // centroids as float4s, then their stores. A compiled width keeps the
    // rows at pitch d (its four lanes' reads of a row then meet at most in
    // pairs on a bank), and its operands are 16-byte aligned and even-sized
    // (a float2 at most left over each), so its staging has no loop and no
    // branch.
    const int p = D > 0 ? D : x_pitch(d);
    const int nx = rows * d;
    const bool x16 = D > 0 || (reinterpret_cast<uintptr_t>(xb) & 15) == 0;
    const int nx4 = x16 ? nx / 4 : 0;
    const int nc4 = D > 0 || c16 ? kd / 4 : 0;
    float4 xq[XQ];
    float4 cq[CQ];
#pragma unroll
    for (int u = 0; u < XQ; ++u) {
      const int q = lane + WARP * u;
      if (q < nx4) xq[u] = __ldg(reinterpret_cast<const float4*>(xb) + q);
    }
#pragma unroll
    for (int u = 0; u < CQ; ++u) {
      const int q = lane + WARP * u;
      if (q < nc4) cq[u] = __ldg(reinterpret_cast<const float4*>(cents) + q);
    }
    // the tails: a float2 each (compiled widths), else up to 64 floats
    // (everything, where a pointer is not 16-byte aligned)
    float xt[2], ct[2];
    const int ex = nx4 * 4 + (D > 0 ? 2 * lane : lane);
    const int ec = nc4 * 4 + (D > 0 ? 2 * lane : lane);
    if constexpr (D > 0) {
      const float2 a = ex < nx ? __ldg(reinterpret_cast<const float2*>(xb + ex))
                               : make_float2(0.f, 0.f);
      const float2 b = ec < kd ? __ldg(reinterpret_cast<const float2*>(cents + ec))
                               : make_float2(0.f, 0.f);
      xt[0] = a.x, xt[1] = a.y, ct[0] = b.x, ct[1] = b.y;
    } else {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        xt[u] = ex + WARP * u < nx ? __ldg(xb + ex + WARP * u) : 0.f;
        ct[u] = ec + WARP * u < kd ? __ldg(cents + ec + WARP * u) : 0.f;
      }
    }
    // keep every load above ahead of every store below (the compiler would
    // otherwise put the rows' stores, which wait for their data, before
    // the centroids' loads: two round trips instead of one)
    asm volatile("" ::: "memory");
    auto x_at = [&](int e) {  // shared offset of row-range element e
      if (p == d) return e;
      const int rr = e / d;
      return rr * p + (e - rr * d);
    };
#pragma unroll
    for (int u = 0; u < XQ; ++u) {
      const int q = lane + WARP * u;
      // d % 4 == 0 whenever p != d, so a float4 stays in one row
      if (q < nx4) *reinterpret_cast<float4*>(s_x + x_at(4 * q)) = xq[u];
    }
#pragma unroll
    for (int u = 0; u < CQ; ++u) {
      const int q = lane + WARP * u;
      if (q < nc4) smem4[q] = cq[u];
    }
    if constexpr (D > 0) {
      if (ex < nx) *reinterpret_cast<float2*>(s_x + ex) = make_float2(xt[0], xt[1]);
      if (ec < kd) *reinterpret_cast<float2*>(s_c + ec) = make_float2(ct[0], ct[1]);
    } else {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (ex + WARP * u < nx) s_x[x_at(ex + WARP * u)] = xt[u];
        if (ec + WARP * u < kd) s_c[ec + WARP * u] = ct[u];
      }
      // misaligned operands: the rest, element by element
      for (int e = ex + 2 * WARP; e < nx; e += WARP) s_x[x_at(e)] = __ldg(xb + e);
      for (int e = ec + 2 * WARP; e < kd; e += WARP) s_c[e] = __ldg(cents + e);
    }
    for (int e = kd + lane; e < held; e += WARP) s_c[e] = 0.f;
    xrow = s_x + r * p;
  } else {
    // all centroids into shared memory; each lane reads its row from
    // global memory (vector loads: d % V == 0 and x 4V-byte aligned)
    const int nc4 = c16 ? kd / 4 : 0;
    for (int q = lane; q < nc4; q += WARP)
      smem4[q] = __ldg(reinterpret_cast<const float4*>(cents) + q);
    for (int e = nc4 * 4 + lane; e < kd; e += WARP) s_c[e] = __ldg(cents + e);
    for (int e = kd + lane; e < held; e += WARP) s_c[e] = 0.f;
    xrow = xb + static_cast<size_t>(min(r, rows - 1)) * d;
  }
  __syncwarp();
  auto load_x = [&](int i) {
    if constexpr (STAGE) return *reinterpret_cast<const VT*>(xrow + i);
    else return __ldg(reinterpret_cast<const VT*>(xrow + i));
  };
  // the sum of a row's LPR lanes, in a fixed butterfly (same bits in each)
  auto row_sum = [](float v) {
#pragma unroll
    for (int off = 1; off < LPR; off <<= 1)
      v += __shfl_xor_sync(kmeans_rows::FULL, v, off);
    return v;
  };

  // One pass over the features for KT centroids: x.c and c2, each over
  // even and odd features (two short chains), and x2 in the first pass.
  // Lane h of a row takes the V-groups h, h + LPR, ...
  float x2 = 0.f;
  float best = kmeans_rows::INF;   // the minimum, a NaN if any d2 is
  auto pass = [&](int j0, auto first) {
    constexpr bool FIRST = decltype(first)::value;
    float ca[KT], cb[KT], qa[KT], qb[KT];
    float xa = 0.f, xc = 0.f;
#pragma unroll
    for (int jj = 0; jj < KT; ++jj) ca[jj] = cb[jj] = qa[jj] = qb[jj] = 0.f;
    const float* cj = s_c + j0 * d;
#pragma unroll UNROLL
    for (int i0 = 0; i0 < d; i0 += LPR * V) {
      const int i = i0 + h * V;
      // past the row's end (its last lanes when LPR > 1) the reads fall on
      // the next row or centroid, inside the allocation, and are replaced
      // by zeros; known when compiled for all but a compiled width's last
      // step
      const bool in = i0 + LPR * V <= d || i < d;
      float xv[V];
      unpack<V>(load_x(i), xv);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        xv[v] = in ? xv[v] : 0.f;
        if constexpr (FIRST) {
          if (v % 2 == 0) xa = fmaf(xv[v], xv[v], xa);
          else xc = fmaf(xv[v], xv[v], xc);
        }
      }
#pragma unroll
      for (int jj = 0; jj < KT; ++jj) {
        float c[V];
        unpack<V>(*reinterpret_cast<const VT*>(cj + jj * d + i), c);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          c[v] = in ? c[v] : 0.f;
          if (v % 2 == 0) {
            ca[jj] = fmaf(xv[v], c[v], ca[jj]);
            qa[jj] = fmaf(c[v], c[v], qa[jj]);
          } else {
            cb[jj] = fmaf(xv[v], c[v], cb[jj]);
            qb[jj] = fmaf(c[v], c[v], qb[jj]);
          }
        }
      }
    }
    if constexpr (FIRST) x2 = row_sum(xa + xc);
#pragma unroll
    for (int jj = 0; jj < KT; ++jj) {
      const float cross = row_sum(ca[jj] + cb[jj]);
      const float c2 = row_sum(qa[jj] + qb[jj]);
      if (j0 + jj < k) best = min_nan(best, clamp0(x2 - 2.f * cross + c2));
    }
  };
  pass(0, std::true_type{});
  for (int j0 = KT; j0 < k; j0 += KT) pass(j0, std::false_type{});
  if (h == 0 && r < rows) {
    const float md = sqrtf(best);
    dist[row0 + r] = md;
    mask[row0 + r] = md <= thr ? 1 : 0;   // false for a NaN distance
  }
}

// The wide route's epilogue: the distance and the mask.
struct DistMask {
  float* dist;
  unsigned char* mask;
  Thr thr_in;
  float thr;
  __device__ __forceinline__ void begin() { thr = thr_in.load(blockIdx.y); }
  __device__ __forceinline__ void operator()(size_t row, float best,
                                             int) const {
    const float md = sqrtf(best);
    dist[row] = md;
    mask[row] = md <= thr ? 1 : 0;
  }
};

// The narrow kernel's centroids a pass: k up to 4 (3: the weak scenario's
// labels a client), then 8, then 16 at a time.
int pass_width(int k) { return k <= 4 ? k : k <= 8 ? 8 : KT_MAX; }

long long smem_bytes(int d, int k) {
  if (d > MAX_D) return 0;  // the wide route: static shared memory only
  long long f =
      (static_cast<long long>(held_rows(k, pass_width(k))) * d + 3) / 4 * 4;
  if (k <= KT_MAX) {
    // the staged rows: at most ROWS of them at pitch d or x_pitch(d)
    f += static_cast<long long>(ROWS) * x_pitch(d);
  }
  return f * sizeof(float);
}

// The operands of a launch: C clients' centroids (c_cs floats apart) and
// thresholds, their rows (x_cs floats apart, or one x for all: x_cs 0).
struct Args {
  const float* x;
  const float* c;
  Thr thr;
  int C, t, d, k;
  long long x_cs, c_cs;
  float* dist;
  unsigned char* mask;
};

template <int KT, int V, bool STAGE, int D>
cudaError_t launch_narrow(const Args& a, cudaStream_t s) {
  // opt in once per device to the shared memory a launch may use
  static bool allowed[MAX_DEVICES] = {};
  auto kernel = narrow_kernel<KT, V, STAGE, D>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES || !allowed[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SHARED);
    if (err != cudaSuccess) return err;
    if (dev >= 0 && dev < MAX_DEVICES) allowed[dev] = true;
  }
  constexpr int RPB = WARP / lanes_a_row<D>();
  kernel<<<dim3((a.t + RPB - 1) / RPB, a.C), WARP, smem_bytes(a.d, a.k), s>>>(
      a.x, a.c, a.thr, a.t, a.d, a.k, a.x_cs, a.c_cs, a.dist, a.mask);
  return cudaGetLastError();
}

// D > 0: a width the kernel is compiled for (the main path's)
template <int V, int D>
cudaError_t narrow_by_k(const Args& a, cudaStream_t s) {
#define REPRO_NARROW(KT, STAGE, DD) launch_narrow<KT, V, STAGE, DD>(a, s)
  if (a.k > KT_MAX) return REPRO_NARROW(KT_MAX, false, 0);
  switch (pass_width(a.k)) {
    case 1: return REPRO_NARROW(1, true, D);
    case 2: return REPRO_NARROW(2, true, D);
    case 3: return REPRO_NARROW(3, true, D);
    case 4: return REPRO_NARROW(4, true, D);
    case 8: return REPRO_NARROW(8, true, D);
    default: return REPRO_NARROW(KT_MAX, true, D);
  }
#undef REPRO_NARROW
}

template <int KT>
cudaError_t launch_wide(const Args& a, cudaStream_t s) {
  kmeans_rows::wide_rows_kernel<KT, DistMask>
      <<<dim3(kmeans_rows::wide_blocks(a.t), a.C), kmeans_rows::W_THREADS, 0,
         s>>>(a.x, a.c, a.t, a.d, a.k, static_cast<size_t>(a.x_cs),
              static_cast<size_t>(a.c_cs), DistMask{a.dist, a.mask, a.thr, 0.f});
  return cudaGetLastError();
}

int min_dist_mask(const Args& a, cudaStream_t s) {
  if (a.C < 1 || a.C > 65535 || a.t < 1 || a.d < 1 || a.k < 1 ||
      a.x_cs < 0 || a.c_cs < 0 || smem_bytes(a.d, a.k) > MAX_SHARED)
    return cudaErrorInvalidValue;
  if (a.d > MAX_D) {
    if (a.k <= 4) return launch_wide<4>(a, s);
    if (a.k <= 12) return launch_wide<12>(a, s);
    return launch_wide<KT_MAX>(a, s);
  }
  // the rows' vector reads: as wide as d and the alignment of every
  // client's operands allow
  const uintptr_t align = reinterpret_cast<uintptr_t>(a.x) |
                          reinterpret_cast<uintptr_t>(a.c) |
                          static_cast<uintptr_t>(a.x_cs * 4) |
                          static_cast<uintptr_t>(a.c_cs * 4);
  if (a.d % 4 == 0 && (align & 15) == 0) {
    if (a.d == 16)  // lm_tokens' flattened samples
      return narrow_by_k<4, 16>(a, s);
    return narrow_by_k<4, 0>(a, s);
  }
  if (a.d % 2 == 0 && (align & 7) == 0) {
    if (a.d == 50 && (align & 15) == 0)  // the feature path's rows
      return narrow_by_k<2, 50>(a, s);
    return narrow_by_k<2, 0>(a, s);
  }
  return narrow_by_k<1, 0>(a, s);
}

}  // namespace

extern "C" {

int repro_min_dist_mask_clients(const void* x, const void* cents,
                                const void* threshold_ptr,
                                float threshold_value, int C, long long x_cs,
                                long long c_cs, int t, int d, int k,
                                void* dist, void* mask, void* stream);

// Dynamic shared memory a launch for (d, k) needs, in bytes (0: none).
long long repro_min_dist_smem_bytes(int d, int k) { return smem_bytes(d, k); }

// x (t, d), cents (k, d) f32 row-major; the threshold: threshold_ptr, one
// f32 in device memory, or threshold_value when threshold_ptr is null;
// dist (t,) f32; mask (t,) one byte per row (0 or 1, the layout of a
// torch.bool tensor).
int repro_min_dist_mask(const void* x, const void* cents,
                        const void* threshold_ptr, float threshold_value,
                        int t, int d, int k, void* dist, void* mask,
                        void* stream) {
  return repro_min_dist_mask_clients(x, cents, threshold_ptr,
                                     threshold_value, 1, 0, 0, t, d, k, dist,
                                     mask, stream);
}

// C clients in one launch: client c's rows at x + c * x_cs floats (x_cs
// 0: one x (t, d) for every client), its centroids (k, d) at cents + c *
// c_cs, its threshold threshold_ptr[c] (or threshold_value for all);
// dist and mask (C, t). Client c's outputs are bit for bit those of a
// repro_min_dist_mask launch on its own operands at the same alignment
// (x_cs and c_cs multiples of 4 keep the 16-byte routes).
int repro_min_dist_mask_clients(const void* x, const void* cents,
                                const void* threshold_ptr,
                                float threshold_value, int C, long long x_cs,
                                long long c_cs, int t, int d, int k,
                                void* dist, void* mask, void* stream) {
  const Args a{static_cast<const float*>(x),
               static_cast<const float*>(cents),
               Thr{static_cast<const float*>(threshold_ptr), threshold_value},
               C, t, d, k, x_cs, c_cs, static_cast<float*>(dist),
               static_cast<unsigned char*>(mask)};
  return min_dist_mask(a, static_cast<cudaStream_t>(stream));
}

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
