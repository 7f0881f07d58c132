// Temperature-scaled KL distillation loss per sample, forward and backward.
//
// Replaces: src/repro/kernels/distill_kl/kernel.py
//   kd_kl_pallas (body _kernel)              -> repro_kd_kl_fwd
//   kd_kl_bwd_pallas (bodies _bwd_ds_kernel,  -> repro_kd_kl_bwd_ds,
//                     _bwd_dt_kernel)            repro_kd_kl_bwd_dt
// For student s and teacher t logits (n, K), with s^ = softmax(s/T) and
// t^ = softmax(t/T):
//   fwd:  kl_i = T^2 * sum_k t^ (log t^ - log s^)
//   ds:   g_i * T * (s^ - t^)
//   dt:   g_i * T * t^ * ((log t^ - log s^) - kl_i / T^2)
// Both log-softmaxes are recomputed from the raw logits in every kernel
// (the residuals are the logits, as in the reference's custom VJP).
//
// What bounds it on an H100: bytes. Per row the work is a few sweeps over
// K (max, sum of exps, the weighted sum or the gradient write) at a handful
// of flops per element, against 2*n*K*4 bytes read and n*4 (fwd) or n*K*4
// (bwd) bytes written; on the main path (n = 64, K = 10) it is launch
// latency. Design: one warp per row, eight rows per block; each lane
// strides over K with neighbouring lanes on neighbouring addresses, and
// the row's max and sums are warp-shuffle reductions, so nothing touches
// shared memory and every pass after the first re-reads the row from L1.
// Arithmetic is IEEE fp32 in the reference's order: s/T first, then the
// stabilised log-sum-exp.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WARP = 32;
constexpr int ROWS = 8;  // warps, hence rows, per block
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

// log-sum-exp of s/T and t/T over one row; every lane gets both.
__device__ __forceinline__ void row_lse(const float* s, const float* t,
                                        int K, float T, int lane,
                                        float* s_lse, float* t_lse) {
  float sm = -INFINITY, tm = -INFINITY;
  for (int i = lane; i < K; i += WARP) {
    sm = fmaxf(sm, s[i] / T);
    tm = fmaxf(tm, t[i] / T);
  }
  sm = warp_max(sm);
  tm = warp_max(tm);
  float se = 0.f, te = 0.f;
  for (int i = lane; i < K; i += WARP) {
    se += expf(s[i] / T - sm);
    te += expf(t[i] / T - tm);
  }
  *s_lse = logf(warp_sum(se)) + sm;
  *t_lse = logf(warp_sum(te)) + tm;
}

// sum_k t^ (log t^ - log s^) over one row (KL / T^2); every lane gets it.
__device__ __forceinline__ float row_kl(const float* s, const float* t,
                                        int K, float T, int lane,
                                        float s_lse, float t_lse) {
  float acc = 0.f;
  for (int i = lane; i < K; i += WARP) {
    const float sl = s[i] / T - s_lse;
    const float tl = t[i] / T - t_lse;
    acc += expf(tl) * (tl - sl);
  }
  return warp_sum(acc);
}

__global__ void kd_kl_fwd(const float* __restrict__ s,
                          const float* __restrict__ t, int n, int K, float T,
                          float* __restrict__ out) {
  const int lane = threadIdx.x % WARP;
  const int row = blockIdx.x * ROWS + threadIdx.x / WARP;
  if (row >= n) return;  // the whole warp leaves together
  const float* sr = s + static_cast<size_t>(row) * K;
  const float* tr = t + static_cast<size_t>(row) * K;
  float s_lse, t_lse;
  row_lse(sr, tr, K, T, lane, &s_lse, &t_lse);
  const float kl = row_kl(sr, tr, K, T, lane, s_lse, t_lse);
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
  const float* sr = s + off;
  const float* tr = t + off;
  float s_lse, t_lse;
  row_lse(sr, tr, K, T, lane, &s_lse, &t_lse);
  const float gt = g[row] * T;
  for (int i = lane; i < K; i += WARP) {
    const float sl = sr[i] / T - s_lse;
    const float tl = tr[i] / T - t_lse;
    ds[off + i] = gt * (expf(sl) - expf(tl));
  }
}

__global__ void kd_kl_bwd_dt(const float* __restrict__ s,
                             const float* __restrict__ t,
                             const float* __restrict__ g, int n, int K,
                             float T, float* __restrict__ dt) {
  const int lane = threadIdx.x % WARP;
  const int row = blockIdx.x * ROWS + threadIdx.x / WARP;
  if (row >= n) return;
  const size_t off = static_cast<size_t>(row) * K;
  const float* sr = s + off;
  const float* tr = t + off;
  float s_lse, t_lse;
  row_lse(sr, tr, K, T, lane, &s_lse, &t_lse);
  // f = KL_i / T^2, recomputed rather than saved
  const float f = row_kl(sr, tr, K, T, lane, s_lse, t_lse);
  const float gt = g[row] * T;
  for (int i = lane; i < K; i += WARP) {
    const float sl = sr[i] / T - s_lse;
    const float tl = tr[i] / T - t_lse;
    const float tp = expf(tl);
    dt[off + i] = gt * tp * ((tl - sl) - f);
  }
}

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

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
