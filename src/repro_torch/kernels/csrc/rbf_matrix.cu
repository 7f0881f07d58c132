// RBF (Gaussian) Gram matrix of the KuLSIF density-ratio estimator:
// K[i, j] = exp(-max(a2_i - 2 a_i.b_j + b2_j, 0) / (2 sigma^2)).
//
// Replaces: src/repro/kernels/kulsif_rbf/kernel.py:32, rbf_matrix_pallas
// (body _kernel): a (n, d) and b (m, d) f32 -> (n, m) f32, matmul-form
// squared distances, clamped at 0, then the exponential.
//
// What bounds it on an H100: on the Selective-FD path (d = 50, n = 512
// proxy rows, m ~ 6000 private rows) it does 2*n*m*d ~ 307 MFLOP of fp32
// multiply-adds and writes an n*m*4 ~ 12 MB output, so the fp32 CUDA-core
// rate and the output's bytes bound it about equally (a few microseconds).
// The cross term stays on the CUDA cores in IEEE fp32, not on the tensor
// cores: TF32 would shift the ratio enough to flip the filter's threshold
// test against the reference.
//
// Design. The TPU kernel takes (256 x 256) output tiles with the whole
// feature width resident in VMEM. Here a block of 256 threads owns a
// (64 x 64) output tile, each thread a 4 x 4 register sub-tile strided by
// 16 rows and 16 columns. The features are staged through shared memory in
// chunks of 32 (d = 50 takes two), transposed so that the inner loop reads
// without bank conflicts; rows past n or m and features past d load as
// zeros, so the ragged edges need no padding copy and are masked at the
// store. The same chunks give each row's squared norm (a2, b2), summed in
// feature order by one thread per row. No atomics, so two runs give the
// same bits.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;                    // output rows per block
constexpr int BN = 64;                    // output columns per block
constexpr int BK = 32;                    // features staged per step
constexpr int TY = 16;                    // thread rows
constexpr int TX = 16;                    // thread columns
constexpr int RM = BM / TY;               // rows per thread
constexpr int RN = BN / TX;               // columns per thread
constexpr int THREADS = TY * TX;

__global__ void __launch_bounds__(THREADS)
rbf_matrix_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  int n, int m, int d, float denom, float* __restrict__ out) {
  __shared__ float s_a[BK][BM + 1];       // feature-major chunk of a-rows
  __shared__ float s_b[BK][BN + 1];       // feature-major chunk of b-rows
  __shared__ float s_a2[BM];
  __shared__ float s_b2[BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
  float norm = 0.f;  // threads < BM: a2 of one row; < BM + BN: b2 of one

  for (int k0 = 0; k0 < d; k0 += BK) {
    // coalesced: consecutive threads read consecutive features of a row
    for (int idx = tid; idx < BM * BK; idx += THREADS) {
      const int r = idx / BK;
      const int kk = idx - r * BK;
      const int gr = row0 + r;
      const int gk = k0 + kk;
      s_a[kk][r] = (gr < n && gk < d) ? a[static_cast<size_t>(gr) * d + gk]
                                      : 0.f;
    }
    for (int idx = tid; idx < BN * BK; idx += THREADS) {
      const int c = idx / BK;
      const int kk = idx - c * BK;
      const int gc = col0 + c;
      const int gk = k0 + kk;
      s_b[kk][c] = (gc < m && gk < d) ? b[static_cast<size_t>(gc) * d + gk]
                                      : 0.f;
    }
    __syncthreads();
    if (tid < BM) {
      for (int kk = 0; kk < BK; ++kk) norm += s_a[kk][tid] * s_a[kk][tid];
    } else if (tid < BM + BN) {
      const int c = tid - BM;
      for (int kk = 0; kk < BK; ++kk) norm += s_b[kk][c] * s_b[kk][c];
    }
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float av[RM];
      float bv[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) av[i] = s_a[kk][ty + TY * i];
#pragma unroll
      for (int j = 0; j < RN; ++j) bv[j] = s_b[kk][tx + TX * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  if (tid < BM) {
    s_a2[tid] = norm;
  } else if (tid < BM + BN) {
    s_b2[tid - BM] = norm;
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty + TY * i;
    if (row0 + r >= n) continue;
    float* orow = out + static_cast<size_t>(row0 + r) * m;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int c = tx + TX * j;
      if (col0 + c >= m) continue;
      const float d2 = fmaxf(s_a2[r] - 2.f * acc[i][j] + s_b2[c], 0.f);
      orow[col0 + c] = expf(-d2 / denom);
    }
  }
}

}  // namespace

extern "C" {

// a (n, d), b (m, d) f32 row-major; out (n, m) f32. denom = 2 sigma^2,
// rounded to f32 by the caller as PyTorch rounds the plain version's
// scalar.
int repro_rbf_matrix(const void* a, const void* b, int n, int m, int d,
                     float denom, void* out, void* stream) {
  const dim3 grid((m + BN - 1) / BN, (n + BM - 1) / BM);
  rbf_matrix_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), n, m, d,
      denom, static_cast<float*>(out));
  return cudaGetLastError();
}

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
