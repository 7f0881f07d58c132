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
// What bounds it on an H100: at the transformer scenario's sequences
// (S = 16) the bytes. A training step (B = 64, N = 32, Nkv = 8, h = 128)
// reads q 16.8 MB and k, v 4.2 MB each and writes o 16.8 MB: 42 MB, 12.5 us
// at 3.35 TB/s, against ~0.14 GFLOP of causal multiply-adds, 2 us at the
// 67 TFLOP/s fp32 rate. On one long causal sequence (S = 4096) the
// operations bound it: ~137 GFLOP, 2.05 ms at the fp32 rate.
//
// Design. One block of 256 threads per (query tile, head, batch); a loop
// inside the block over KV tiles staged in shared memory takes the place
// of the TPU's sequential grid axis, with the online-softmax state in
// registers. Two tile shapes: 16 query rows x 16 keys when Sq <= 32 (at
// S = 16 a 64-row tile would be three-quarters masked), 64 x 32 otherwise.
// Each thread owns RM = BQ/16 query rows and, for those rows, BK/16 score
// columns and h/16 output columns, strided by 16; a row's 16 threads are
// one half-warp, so row max and row sum reduce with shuffles. Rows past Sq
// and keys past Sk load as zeros and are masked in the kernel (no padding
// copy); the kv head is read in place (no repeat copy); any layout whose
// last axis is contiguous is read through its strides, so the model's
// (B, S, N, h) tensors need no transpose copy. Causal KV tiles wholly
// above a query tile's last row are skipped; query tiles run heaviest
// first. Every product is an IEEE fp32 FMA (no TF32) and every sum has a
// fixed order, so two runs give the same bits.
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int TX = 16;                    // threads across keys / columns
constexpr int TY = 16;                    // threads across query rows
constexpr int THREADS = TX * TY;

struct Strides {                          // in elements; the h axis is 1
  long long b, n, s;
};

template <int HD, int BQ, int BK>
constexpr int smem_floats() {
  return BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1);
}

template <int HD, int BQ, int BK>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int sq, int sk, int group, Strides qs, Strides ks,
                       Strides vs, Strides os, float scale, int causal) {
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

  for (int idx = tid; idx < BQ * HD; idx += THREADS) {
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
    for (int idx = tid; idx < BK * HD; idx += THREADS) {
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
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off, TX));
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
      lt += __shfl_xor_sync(0xffffffffu, lt, off, TX);
    const int qpos = q0 + ty + TY * i;
    if (qpos >= sq) continue;
    const float den = fmaxf(lt, 1e-30f);  // 0 / 1e-30 = 0 for masked rows
    float* orow = ob + qpos * os.s;
#pragma unroll
    for (int c = 0; c < RC; ++c) orow[tx + TX * c] = acc[i][c] / den;
  }
}

template <int HD, int BQ, int BK>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   int batch, int heads, int sq, int sk, int group,
                   const Strides* st, float scale, int causal,
                   cudaStream_t stream) {
  constexpr int smem = smem_floats<HD, BQ, BK>() * sizeof(float);
  auto kern = flash_attention_kernel<HD, BQ, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BQ - 1) / BQ, heads, batch);
  kern<<<grid, THREADS, smem, stream>>>(q, k, v, o, sq, sk, group, st[0],
                                        st[1], st[2], st[3], scale, causal);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_tiles(const float* q, const float* k, const float* v,
                         float* o, int batch, int heads, int sq, int sk,
                         int group, const Strides* st, float scale,
                         int causal, cudaStream_t stream) {
  if (sq <= 32)
    return launch<HD, 16, 16>(q, k, v, o, batch, heads, sq, sk, group, st,
                              scale, causal, stream);
  return launch<HD, 64, 32>(q, k, v, o, batch, heads, sq, sk, group, st,
                            scale, causal, stream);
}

}  // namespace

extern "C" {

// q (B, N, Sq, h), k and v (B, Nkv, Sk, h), o (B, N, Sq, h), all f32 with
// the h axis contiguous; strides holds 12 element strides, (batch, head,
// sequence) of q, k, v and o in that order. h is one of 16, 32, 64, 128;
// the caller checks shapes and that Nkv divides N. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for any
// other h).
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
  const int group = heads / kv_heads;
  const auto* qp = static_cast<const float*>(q);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  auto* op = static_cast<float*>(o);
  auto s = static_cast<cudaStream_t>(stream);
  switch (h) {
    case 16:
      return launch_tiles<16>(qp, kp, vp, op, batch, heads, sq, sk, group,
                              st, scale, causal, s);
    case 32:
      return launch_tiles<32>(qp, kp, vp, op, batch, heads, sq, sk, group,
                              st, scale, causal, s);
    case 64:
      return launch_tiles<64>(qp, kp, vp, op, batch, heads, sq, sk, group,
                              st, scale, causal, s);
    case 128:
      return launch_tiles<128>(qp, kp, vp, op, batch, heads, sq, sk, group,
                               st, scale, causal, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
