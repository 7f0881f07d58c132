// RBF (Gaussian) Gram matrix of the KuLSIF density-ratio estimator:
// K[i, j] = exp(-max(a2_i - 2 a_i.b_j + b2_j, 0) / (2 sigma^2)).
//
// Replaces: src/repro/kernels/kulsif_rbf/kernel.py:32, rbf_matrix_pallas
// (body _kernel): a (n, d) and b (m, d) f32 -> (n, m) f32, matmul-form
// squared distances, clamped at 0, then the exponential.
//
// What bounds it on an H100. The bound is the cross term's 2*n*m*d
// multiply-adds at the fp32 CUDA-core rate (4.6 us at n = 512, m = 6000,
// d = 50); writing the n*m*4 = 12.3 MB output takes 3.7 us. What the card
// actually spends it on is L2 traffic and phases that do not overlap:
// every block reads its a and b rows from L2 (64 x 128 tiles re-read the
// inputs to 14.4 MB), runs its cross term, then stores, all blocks of a
// wave in the same phase at once.
//
// Design.
//  * The cross term runs on the tensor cores as 3xTF32: each operand is
//    split into a tf32 high part and a tf32 remainder, and hi*lo + lo*hi +
//    hi*hi (mma.sync m16n8k8, fp32 accumulators) keeps about fp32's
//    precision, inside the tolerances that hold the filter's threshold
//    test (plain TF32 would not). The three products of every accumulator
//    are issued pass by pass, so the compiler interleaves them.
//  * Wide rows (d > 64, flattened images): the tensor cores add into
//    their fp32 accumulator without rounding to nearest, a bias of up to
//    an ulp of the running sum a mma, which over 784 features (294 mma)
//    grew to 2e-5 of the norms and over 3072 beyond, outside the
//    tolerance. So each stage of 64 features (24 mma) starts from zero
//    and is added to the running sum with an IEEE fadd. Rows of d <= 64
//    take one stage and the kernel without the extra accumulators, which
//    at d = 50 is the faster one by a quarter (PERF.md section 6).
//  * Tiles by shape: 128 x 96 (8 warps of 32 x 48), which re-reads the
//    inputs less than 64 x 128 (11.2 MB at the main shape), where 64 x 128
//    tiles would give every SM one; else 32 x 64 (4 warps of 16 x 32), so
//    the (256, 256) and (512, 256) matrices still spread over the card.
//  * Loads: every row of both tiles by 8-byte cp.async copies, all in
//    flight at once, row-major with a pitch of 4 (mod 8) floats, so each
//    fragment load of 8 rows x 4 features hits 32 banks. (16-byte copies
//    of the 200-byte rows need a pitch of 2 (mod 4), whose conflicts cost
//    more; a feature-major layout needs transposing stores that cost more.)
//  * Norms: from the fragments the mma loads anyway, by the warps of the
//    tile's first row and column, each row's four lanes added in a fixed
//    butterfly; no separate pass.
//  * Epilogue: one scale -log2(e)/(2 sigma^2) a launch, ex2.approx (2
//    ulp), 8-byte stores of the mma's column pairs. The wrapper pads the
//    output's rows to a multiple of 8 floats, so every row starts a
//    32-byte sector and no sector is written in two pieces (two warps
//    writing one sector in pieces made unpadded odd-m rows much slower).
//  * Non-finite values as in the reference. With both squared norms
//    finite a pair's d2 is finite, and fmaxf's clamp is the reference's. A
//    thread with a pair whose norm is not finite redoes those pairs after
//    its stores: the cross term in plain
//    fp32 (3xTF32 would split an inf into inf + NaN, and an infinite d2,
//    whose kernel value is 0, would come out NaN), a clamp that keeps a
//    NaN (fmaxf returns the 0), and the exponent of a NaN a NaN.
//  * Rows past n or m are masked at the store (no padding copy); widths
//    beyond 64 take several stages. No atomics: two runs give the same
//    bits.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int KC = 64;          // features resident in one stage
constexpr int MAX_DEVICES = 64;
constexpr int WARP = 32;

// Row pitch (floats) of a staged tile w features wide: the features
// rounded up to the mma's k of 8, plus 4, so pitch = 4 (mod 8) and the
// fragment loads of 8 rows x 4 features hit 32 different banks.
__host__ __device__ __forceinline__ int row_pitch(int w) {
  return (w + 7) / 8 * 8 + 4;
}

// Copy rows x [k0, k0 + w) of a row-major (., d) matrix, from src (its
// row r0, column k0), into dst (row pitch P) by asynchronous copies of 8
// bytes (4 where d or w is odd), all in flight at once; the features
// [w, w rounded up to 8) are zeroed for the last k-step. (A row of d = 50
// floats is 8-byte but not 16-byte aligned; 16-byte copies would need a
// pitch of 2 (mod 4), whose bank conflicts cost more than they save.)
template <int THREADS>
__device__ __forceinline__ void copy_tile(const float* __restrict__ src,
                                          int rows, int d, int w, int P,
                                          float* __restrict__ dst) {
  const int tid = threadIdx.x;
  const bool pair = d % 2 == 0 && w % 2 == 0 &&
                    (reinterpret_cast<uintptr_t>(src) & 7) == 0;
  const int unit = pair ? 2 : 1;
  const int h = w / unit;  // copies a row
  const float inv_h = 1.f / static_cast<float>(h);
  for (int idx = tid; idx < rows * h; idx += THREADS) {
    // idx / h, exact in f32 for the idx < 2^16 a tile holds
    const int r = static_cast<int>((static_cast<float>(idx) + 0.5f) * inv_h);
    const int c = (idx - r * h) * unit;
    const unsigned s =
        static_cast<unsigned>(__cvta_generic_to_shared(dst + r * P + c));
    const float* g = src + static_cast<size_t>(r) * d + c;
    if (pair)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                   "l"(g));
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                   "l"(g));
  }
  const int pad = (w + 7) / 8 * 8 - w;
  for (int idx = tid; idx < rows * pad; idx += THREADS) {
    const int r = idx / pad;
    dst[r * P + w + idx - r * pad] = 0.f;
  }
}

__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both tf32: the 3xTF32 split (hi*hi + hi*lo + lo*hi keeps
// about fp32's precision; lo*lo is below it)
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// max(v, 0) that keeps a NaN, as jnp.maximum does (one instruction)
__device__ __forceinline__ float clamp0(float v) {
  float r;
  asm("max.NaN.f32 %0, %1, 0f00000000;" : "=f"(r) : "f"(v));
  return r;
}

// a.b over d features in plain fp32, in feature order
__device__ __forceinline__ float plain_dot(const float* __restrict__ a,
                                        const float* __restrict__ b, int d) {
  float s = 0.f;
  for (int i = 0; i < d; ++i) s = fmaf(__ldg(a + i), __ldg(b + i), s);
  return s;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  // not volatile: the compiler may interleave independent accumulators
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A thread whose pairs include a row with a squared norm that is not
// finite (an inf or NaN feature) redoes those pairs, rows r_base + 16 i +
// 8 h and columns c_base + 8 j + e of the tile, in plain fp32 (3xTF32
// splits an inf into inf + NaN; the reference's matmul has +-inf or NaN
// there), with the clamp that keeps a NaN and the exponent of a NaN a NaN,
// over the values it stored.
template <int MT, int NT>
__device__ __forceinline__ void redo_nonfinite(
    const float* __restrict__ a, const float* __restrict__ b, int d,
    const float* s_a2, const float* s_b2, int r_base, int c_base, int rows_a,
    int rows_b, int row0, int col0, float neg_scale, float* out, int ldo) {
#pragma unroll 1
  for (int i = 0; i < MT; ++i)
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      const int r = r_base + 16 * i + 8 * h;
      if (r >= rows_a) continue;
      const float a2 = s_a2[r];
#pragma unroll 1
      for (int j = 0; j < NT; ++j)
#pragma unroll 1
        for (int e = 0; e < 2; ++e) {
          const int c = c_base + 8 * j + e;
          if (c >= rows_b) continue;
          const float b2 = s_b2[c];
          if (isfinite(a2) && isfinite(b2)) continue;
          const float cross =
              plain_dot(a + static_cast<size_t>(row0 + r) * d,
                        b + static_cast<size_t>(col0 + c) * d, d);
          float v;
          asm("ex2.approx.ftz.f32 %0, %1;\n"
              : "=f"(v)
              : "f"(clamp0(a2 - 2.f * cross + b2) * neg_scale));
          out[static_cast<size_t>(row0 + r) * ldo + col0 + c] = v;
        }
    }
}

// A block owns a (BM x BN) output tile; each of its warps a (WM x WN)
// part of it, MT x NT mma tiles of 16 x 8. STAGED: more than one stage of
// KC features, each summed apart and added to the total by an IEEE fadd.
template <int BM, int BN, int WM, int WN, bool STAGED>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * WARP)
    rbf_matrix_kernel(const float* __restrict__ a,
                      const float* __restrict__ b, int n, int m, int d,
                      float neg_scale, float* __restrict__ out, int ldo) {
  constexpr int WX = BN / WN;                  // warps along the columns
  constexpr int THREADS = (BM / WM) * WX * WARP;
  constexpr int MT = WM / 16;
  constexpr int NT = WN / 8;
  extern __shared__ float4 smem4[];
  const int P = row_pitch(min(d, KC));
  float* s_a = reinterpret_cast<float*>(smem4);  // (BM, P) rows of a
  float* s_b = s_a + BM * P;                      // (BN, P) rows of b
  float* s_a2 = s_b + BN * P;                     // (BM,)
  float* s_b2 = s_a2 + BM;                        // (BN,)

  const int tid = threadIdx.x;
  const int lane = tid % WARP;
  const int warp = tid / WARP;
  const int g = lane / 4;              // the mma's row (or column) group
  const int t = lane % 4;              // and its thread in the group
  const int wm = (warp / WX) * WM;     // this warp's rows in the tile
  const int wn = (warp % WX) * WN;     // and columns
  // the warps of the first column own the a rows' norms, those of the
  // first row the b rows'
  const bool a_norms = warp % WX == 0;
  const bool b_norms = warp / WX == 0;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int rows_a = min(BM, n - row0);
  const int rows_b = min(BN, m - col0);

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  // squared norms in fp32 from the fragments' values: a rows g and g + 8
  // of each m-tile, b row g of each n-tile, this lane's features t + 4u
  float na[MT][2];
  float nb[NT];
#pragma unroll
  for (int i = 0; i < MT; ++i) na[i][0] = na[i][1] = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j) nb[j] = 0.f;

  // the cross term a.b on the tensor cores, 3xTF32, over features
  // [kk0, kk1) of the staged rows
  auto mma_steps = [&](int kk0, int kk1) {
    for (int kk = kk0; kk < kk1; kk += 8) {
      unsigned ah[MT][4];
      unsigned al[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float* ar = s_a + (wm + 16 * i + g) * P + kk + t;
        const float v[4] = {ar[0], ar[8 * P], ar[4], ar[8 * P + 4]};
#pragma unroll
        for (int e = 0; e < 4; ++e) split(v[e], ah[i][e], al[i][e]);
        if (a_norms) {
          na[i][0] = fmaf(v[0], v[0], na[i][0]);
          na[i][0] = fmaf(v[2], v[2], na[i][0]);
          na[i][1] = fmaf(v[1], v[1], na[i][1]);
          na[i][1] = fmaf(v[3], v[3], na[i][1]);
        }
      }
      unsigned bh[NT][2];
      unsigned bl[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* br = s_b + (wn + 8 * j + g) * P + kk + t;
        const float v0 = br[0];
        const float v1 = br[4];
        split(v0, bh[j][0], bl[j][0]);
        split(v1, bh[j][1], bl[j][1]);
        if (b_norms) {
          nb[j] = fmaf(v0, v0, nb[j]);
          nb[j] = fmaf(v1, v1, nb[j]);
        }
      }
      // the small terms first, each pass over every accumulator
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma_tf32(acc[i][j], al[i], bh[j][0], bh[j][1]);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma_tf32(acc[i][j], ah[i], bl[j][0], bl[j][1]);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma_tf32(acc[i][j], ah[i], bh[j][0], bh[j][1]);
    }
  };

  // the running sum over the stages (STAGED only)
  float tot[STAGED ? MT : 1][STAGED ? NT : 1][4];
  if constexpr (STAGED) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) tot[i][j][e] = 0.f;
  }
  for (int k0 = 0; k0 < d; k0 += KC) {
    const int w = min(KC, d - k0);
    if (k0 != 0) __syncthreads();  // the last stage is consumed
    copy_tile<THREADS>(a + static_cast<size_t>(row0) * d + k0, rows_a, d, w,
                       P, s_a);
    copy_tile<THREADS>(b + static_cast<size_t>(col0) * d + k0, rows_b, d, w,
                       P, s_b);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    mma_steps(0, (w + 7) / 8 * 8);
    if constexpr (STAGED) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            tot[i][j][e] = __fadd_rn(tot[i][j][e], acc[i][j][e]);
            acc[i][j][e] = 0.f;
          }
    }
  }
  if constexpr (STAGED) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = tot[i][j][e];
  }
  // each row's norm: its four lanes' sums (features t + 4u), added in a
  // fixed butterfly
  if (a_norms) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = na[i][h];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (t == 0) s_a2[wm + 16 * i + g + 8 * h] = v;
      }
  }
  if (b_norms) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float v = nb[j];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (t == 0) s_b2[wn + 8 * j + g] = v;
    }
  }
  __syncthreads();

  // c[0], c[1]: row g, columns 2t and 2t + 1; c[2], c[3]: row g + 8. The
  // wrapper pads the rows (ldo) to whole 32-byte sectors, so each pair goes
  // as one 8-byte store and no sector is written in two pieces.
  const bool pairs = ldo % 2 == 0 && (reinterpret_cast<uintptr_t>(out) & 7) == 0;
  bool finite = true;  // every squared norm of this thread's pairs
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm + 16 * i + g + 8 * h;
      if (r >= rows_a) continue;
      const float a2 = s_a2[r];
      finite = finite && isfinite(a2);
      float* orow = out + static_cast<size_t>(row0 + r) * ldo + col0;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = wn + 8 * j + 2 * t;
        if (c >= rows_b) continue;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // with both norms finite the d2 is finite: fmaxf's clamp is the
          // reference's (the pairs of a non-finite row are redone below)
          const float b2 = s_b2[c + e];
          finite = finite && (c + e >= rows_b || isfinite(b2));
          const float d2 = fmaxf(a2 - 2.f * acc[i][j][2 * h + e] + b2, 0.f);
          // 2^x to 2 ulp; results below 2^-126 (under the tolerance's
          // absolute term) flush to 0
          asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(v[e]) : "f"(d2 * neg_scale));
        }
        if (pairs && c + 1 < rows_b) {
          *reinterpret_cast<float2*>(orow + c) = make_float2(v[0], v[1]);
        } else {
          orow[c] = v[0];
          if (c + 1 < rows_b) orow[c + 1] = v[1];
        }
      }
    }
  if (!finite)
    redo_nonfinite<MT, NT>(a, b, d, s_a2, s_b2, wm + g, wn + 2 * t, rows_a,
                           rows_b, row0, col0, neg_scale, out, ldo);
}

int sm_count(int dev) {
  static int sms[MAX_DEVICES] = {};
  if (dev < 0 || dev >= MAX_DEVICES) return 132;
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    return 132;
  return sms[dev];
}

template <int BM, int BN, int WM, int WN, bool STAGED>
cudaError_t launch(const float* a, const float* b, int n, int m, int d,
                   float neg_scale, float* out, int ldo, int dev,
                   cudaStream_t s) {
  constexpr int THREADS = (BM / WM) * (BN / WN) * WARP;
  static bool attr_set[MAX_DEVICES] = {};
  auto bytes = [](int dc) {
    return static_cast<int>(((BM + BN) * row_pitch(dc) + BM + BN) *
                            sizeof(float));
  };
  if (dev < 0 || dev >= MAX_DEVICES || !attr_set[dev]) {
    cudaError_t err = cudaFuncSetAttribute(
        rbf_matrix_kernel<BM, BN, WM, WN, STAGED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes(KC));
    if (err != cudaSuccess) return err;
    if (dev >= 0 && dev < MAX_DEVICES) attr_set[dev] = true;
  }
  const dim3 grid((m + BN - 1) / BN, (n + BM - 1) / BM);
  rbf_matrix_kernel<BM, BN, WM, WN, STAGED>
      <<<grid, THREADS, bytes(d < KC ? d : KC), s>>>(a, b, n, m, d,
                                                    neg_scale, out, ldo);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// a (n, d), b (m, d) f32 row-major; out (n, m) f32 with row pitch ldo >= m
// floats (a multiple of 8 puts every row on a 32-byte sector). denom =
// 2 sigma^2, rounded to f32 by the caller as PyTorch rounds the plain
// version's scalar.
int repro_rbf_matrix(const void* a, const void* b, int n, int m, int d,
                     float denom, void* out, int ldo, void* stream) {
  if (n < 1 || m < 1 || d < 1 || ldo < m) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  // exp(-d2 / denom) = exp2(d2 * (-log2(e) / denom)): one scale a launch
  const float neg_scale =
      static_cast<float>(-1.4426950408889634 / static_cast<double>(denom));
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 128 x 96 tiles (8 warps of 32 x 48) where 64 x 128 ones would give at
  // least one an SM, else 32 x 64 (4 warps of 16 x 32)
  const long long big_tiles =
      static_cast<long long>((m + 127) / 128) * ((n + 63) / 64);
  const bool big = big_tiles >= sm_count(dev);
  if (d > KC)
    return big ? launch<128, 96, 32, 48, true>(af, bf, n, m, d, neg_scale, o,
                                               ldo, dev, s)
               : launch<32, 64, 16, 32, true>(af, bf, n, m, d, neg_scale, o,
                                              ldo, dev, s);
  return big ? launch<128, 96, 32, 48, false>(af, bf, n, m, d, neg_scale, o,
                                              ldo, dev, s)
             : launch<32, 64, 16, 32, false>(af, bf, n, m, d, neg_scale, o,
                                             ldo, dev, s);
}

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
