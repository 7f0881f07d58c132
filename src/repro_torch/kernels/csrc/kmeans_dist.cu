// The estimation step of KMeans-DRE: for each row of x (t, d), the distance
// to its nearest centroid, sqrt(min_j max(x2 - 2 x.c_j + c2_j, 0)), and the
// ID mask dist <= threshold.
//
// Replaces: src/repro/kernels/kmeans_dist/kernel.py:48, kmeans_dist_pallas
// (body _kernel): x (t, d) f32, centroids (k, d) f32, a scalar threshold ->
// (t,) f32 distances and a (t,) mask (int8 there, bool here).
//
// What bounds it on an H100: nothing on the card. The filter's path runs
// t = 512 proxy rows (calibration: one client's ~6000 private rows) at
// d = 50 against k <= 10 centroids: ~100 KB to 1.2 MB read and well under
// a MFLOP, a fraction of a microsecond of memory traffic, so a call costs
// its launch.
//
// Design. One warp per row, eight rows per block. The block stages the k
// centroids and their squared norms in shared memory once (the TPU kernel
// keeps them resident across its grid); each warp stages its row, its lanes
// split the features, and each dot product reduces across the warp with
// butterfly shuffles (fixed order, so two runs give the same bits). The
// distance keeps the reference's matmul form in IEEE fp32; the first index
// wins ties, as in the Lloyd kernel. The threshold is read from device
// memory: a threshold calibrated on the device is compared without a host
// read. Rows past t are masked in the kernel (no padding copy).
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;                  // rows per block, one warp each
constexpr int THREADS = WARPS * 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(THREADS)
min_dist_mask_kernel(const float* __restrict__ x,
                     const float* __restrict__ cents,
                     const float* __restrict__ threshold, int t, int d, int k,
                     float* __restrict__ dist,
                     unsigned char* __restrict__ mask) {
  extern __shared__ float smem[];
  float* s_c = smem;                      // (k, d) centroids
  float* s_c2 = s_c + k * d;              // (k,) squared norms
  float* s_x = s_c2 + k;                  // (WARPS, d) this block's rows

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + warp;

  for (int i = threadIdx.x; i < k * d; i += THREADS) s_c[i] = cents[i];
  float* xr = s_x + warp * d;
  if (row < t) {
    const float* xg = x + static_cast<size_t>(row) * d;
    for (int i = lane; i < d; i += 32) xr[i] = xg[i];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += THREADS) {
    float c2 = 0.f;
    for (int i = 0; i < d; ++i) c2 += s_c[j * d + i] * s_c[j * d + i];
    s_c2[j] = c2;
  }
  __syncthreads();
  if (row >= t) return;

  float x2 = 0.f;
  for (int i = lane; i < d; i += 32) x2 += xr[i] * xr[i];
  x2 = warp_sum(x2);
  float best = 0.f;
  for (int j = 0; j < k; ++j) {
    const float* cj = s_c + j * d;
    float cross = 0.f;
    for (int i = lane; i < d; i += 32) cross += xr[i] * cj[i];
    cross = warp_sum(cross);
    const float d2 = fmaxf(x2 - 2.f * cross + s_c2[j], 0.f);
    if (j == 0 || d2 < best) best = d2;   // strict: the first index wins
  }
  if (lane == 0) {
    const float md = sqrtf(best);
    dist[row] = md;
    mask[row] = md <= *threshold ? 1 : 0;
  }
}

}  // namespace

extern "C" {

int repro_min_dist_rows_per_block() { return WARPS; }

// Dynamic shared memory the kernel needs for (d, k), in bytes.
long long repro_min_dist_smem_bytes(int d, int k) {
  return (static_cast<long long>(k) * d + k
          + static_cast<long long>(WARPS) * d) * sizeof(float);
}

// x (t, d), cents (k, d) f32 row-major; threshold: one f32 in device
// memory; dist (t,) f32; mask (t,) one byte per row (0 or 1, the layout of
// a torch.bool tensor).
int repro_min_dist_mask(const void* x, const void* cents,
                        const void* threshold, int t, int d, int k,
                        void* dist, void* mask, void* stream) {
  const long long smem = repro_min_dist_smem_bytes(d, k);
  cudaError_t err = cudaFuncSetAttribute(
      min_dist_mask_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (t + WARPS - 1) / WARPS;
  min_dist_mask_kernel<<<blocks, THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(cents),
      static_cast<const float*>(threshold), t, d, k,
      static_cast<float*>(dist), static_cast<unsigned char*>(mask));
  return cudaGetLastError();
}

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
