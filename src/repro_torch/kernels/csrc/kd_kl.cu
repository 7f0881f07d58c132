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
// multiply by the cotangent. Its row lives in registers, divided by T once
// (ceil(K/32) a lane, K <= 1024; wider rows re-read memory); 16 rows a
// block, so the main path's batch spreads over four SMs (on an H100, one
// block of all 64 rows took 7.3 us of device time against 5.2: the ~300
// instructions of each row queue on one SM's schedulers). The mean's
// denominator depends on w only, so every warp reduces w itself;
// the scalar is reduced in a fixed order by the last block (an integer
// ticket), never by float atomics, so two launches on the same inputs give
// the same bits.
// Arithmetic is IEEE fp32 in the reference's order: s/T first, then the
// stabilised log-sum-exp, then exp(tl) * (tl - sl).
#include <cuda_runtime.h>
#include <math.h>

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
// the student, one launch. One warp per row, LOSS_ROWS rows a block; the
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
// partials (ceil(n / 16),) f32 scratch; ticket one unsigned, zero between
// launches (the kernel leaves it so), used by one stream at a time.
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
// rows; ds (C, n, K) when want_ds; partials (C, ceil(n / 16)) f32
// scratch; tickets C unsigned, zero between launches. Client c's outputs
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
  return REPRO_LOSS(GlobalRow);  // K > 1024: re-read the row at each pass
#undef REPRO_LOSS
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
