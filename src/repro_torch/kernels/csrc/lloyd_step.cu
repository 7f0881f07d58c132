// One Lloyd iteration of the KMeans-DRE fit, for C clients at once.
//
// Replaces: src/repro/kernels/kmeans_dist/kernel.py, lloyd_step_pallas
// (body _lloyd_kernel): matmul-form squared distances of every row of
// x (C, n, d) to its client's centroids (C, k, d), the first-index argmin,
// the min distance, and the per-centroid sums (C, k, d) and counts (C, k).
//
// What bounds it on an H100: bytes and launch latency, not arithmetic. The
// main path runs C = 1, n ~ 6000, d = 50, k <= 10: it reads n*d*4 bytes
// (~1.2 MB) and does about 2*n*k*d flops, so the whole step is a few
// microseconds of memory traffic and the two launches dominate.
//
// Design. The TPU kernel accumulates sums/counts into output blocks that
// stay resident across a sequential grid axis; Hopper blocks run in
// parallel and in no order, so that does not carry over. Instead:
//   pass 1 (grid: row tiles x clients): each block stages its client's k*d
//     centroids, their squared norms and its TILE rows of x in shared
//     memory (coalesced loads), computes each row's distances in IEEE fp32
//     in the reference's form max(x2 - 2*x.c + c2, 0), takes the argmin,
//     writes assign/min_d2, and writes the tile's partial sums and counts
//     to a scratch buffer (C, tiles, k, d) / (C, tiles, k);
//   pass 2 (grid: k*d+k outputs x clients): reduces the partials over
//     tiles in ascending order.
// No atomics anywhere, so two runs give the same bits. Rows >= n are
// masked inside the kernel (no padding copy); the wrapper allocates every
// output and the scratch, and checks that the shared memory fits.
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 128;     // rows per block in pass 1, one thread each
constexpr int REDUCE = 256;   // threads per block in pass 2

__global__ void lloyd_assign_partial(const float* __restrict__ x,
                                     const float* __restrict__ cents,
                                     int n, int d, int k, int tiles,
                                     int* __restrict__ assign,
                                     float* __restrict__ min_d2,
                                     float* __restrict__ part_sums,
                                     float* __restrict__ part_counts) {
  extern __shared__ float smem[];
  float* s_c = smem;                          // (k, d) centroids
  float* s_c2 = s_c + k * d;                  // (k,) squared norms
  float* s_x = s_c2 + k;                      // (TILE, d) rows of x
  int* s_a = reinterpret_cast<int*>(s_x + TILE * d);  // (TILE,) assignment

  const int client = blockIdx.y;
  const int tile = blockIdx.x;
  const int row0 = tile * TILE;
  const int rows = min(TILE, n - row0);
  const float* xc = x + (static_cast<size_t>(client) * n + row0) * d;
  const float* cc = cents + static_cast<size_t>(client) * k * d;

  for (int i = threadIdx.x; i < k * d; i += blockDim.x) s_c[i] = cc[i];
  for (int i = threadIdx.x; i < rows * d; i += blockDim.x) s_x[i] = xc[i];
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    float c2 = 0.f;
    for (int i = 0; i < d; ++i) c2 += s_c[j * d + i] * s_c[j * d + i];
    s_c2[j] = c2;
  }
  __syncthreads();

  for (int r = threadIdx.x; r < TILE; r += blockDim.x) {
    int best = -1;  // rows past n carry no mass
    if (r < rows) {
      const float* xr = s_x + r * d;
      float x2 = 0.f;
      for (int i = 0; i < d; ++i) x2 += xr[i] * xr[i];
      float best_d2 = 0.f;
      for (int j = 0; j < k; ++j) {
        const float* cj = s_c + j * d;
        float cross = 0.f;
        for (int i = 0; i < d; ++i) cross += xr[i] * cj[i];
        const float d2 = fmaxf(x2 - 2.f * cross + s_c2[j], 0.f);
        if (j == 0 || d2 < best_d2) {  // strict: the first index wins ties
          best_d2 = d2;
          best = j;
        }
      }
      const size_t out = static_cast<size_t>(client) * n + row0 + r;
      assign[out] = best;
      min_d2[out] = best_d2;
    }
    s_a[r] = best;
  }
  __syncthreads();

  // this tile's per-centroid partial sums and counts, rows in order
  const size_t part = static_cast<size_t>(client) * tiles + tile;
  float* ps = part_sums + part * k * d;
  for (int idx = threadIdx.x; idx < k * d; idx += blockDim.x) {
    const int j = idx / d;
    const int i = idx - j * d;
    float acc = 0.f;
    for (int r = 0; r < rows; ++r)
      if (s_a[r] == j) acc += s_x[r * d + i];
    ps[idx] = acc;
  }
  float* pc = part_counts + part * k;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    float cnt = 0.f;
    for (int r = 0; r < rows; ++r)
      if (s_a[r] == j) cnt += 1.f;
    pc[j] = cnt;
  }
}

__global__ void lloyd_reduce(const float* __restrict__ part_sums,
                             const float* __restrict__ part_counts,
                             int k, int d, int tiles,
                             float* __restrict__ sums,
                             float* __restrict__ counts) {
  const int client = blockIdx.y;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int kd = k * d;
  const size_t base = static_cast<size_t>(client) * tiles;
  if (idx < kd) {
    float acc = 0.f;
    for (int t = 0; t < tiles; ++t) acc += part_sums[(base + t) * kd + idx];
    sums[static_cast<size_t>(client) * kd + idx] = acc;
  } else if (idx < kd + k) {
    const int j = idx - kd;
    float acc = 0.f;
    for (int t = 0; t < tiles; ++t) acc += part_counts[(base + t) * k + j];
    counts[static_cast<size_t>(client) * k + j] = acc;
  }
}

}  // namespace

extern "C" {

int repro_lloyd_tile() { return TILE; }

// Dynamic shared memory pass 1 needs for (d, k), in bytes.
long long repro_lloyd_smem_bytes(int d, int k) {
  return (static_cast<long long>(k) * d + k + static_cast<long long>(TILE) * d)
             * sizeof(float) + TILE * sizeof(int);
}

// x (C, n, d), cents (C, k, d) f32; assign (C, n) i32, min_d2 (C, n),
// sums (C, k, d), counts (C, k) f32; part_sums (C, tiles, k, d) and
// part_counts (C, tiles, k) f32 scratch, tiles = ceil(n / TILE).
int repro_lloyd_step(const void* x, const void* cents, int C, int n, int d,
                     int k, void* assign, void* min_d2, void* sums,
                     void* counts, void* part_sums, void* part_counts,
                     void* stream) {
  const int tiles = (n + TILE - 1) / TILE;
  const long long smem = repro_lloyd_smem_bytes(d, k);
  cudaError_t err = cudaFuncSetAttribute(
      lloyd_assign_partial, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  lloyd_assign_partial<<<dim3(tiles, C), TILE, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(cents), n, d,
      k, tiles, static_cast<int*>(assign), static_cast<float*>(min_d2),
      static_cast<float*>(part_sums), static_cast<float*>(part_counts));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int outputs = k * d + k;
  lloyd_reduce<<<dim3((outputs + REDUCE - 1) / REDUCE, C), REDUCE, 0, s>>>(
      static_cast<const float*>(part_sums),
      static_cast<const float*>(part_counts), k, d, tiles,
      static_cast<float*>(sums), static_cast<float*>(counts));
  return cudaGetLastError();
}

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
