// K3, K4, K5: flash attention forward and backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of fmdm_tpu/ops/pallas/flash_attention.py:
//   K3 _flash_fwd_kernel (:35-62, driven by _flash_forward :88-118): an online
//      softmax over KV tiles with q scaled before the dot (:37); returns out and
//      lse = m + log l in those units (:62).
//   K4 _flash_bwd_dkv_kernel (:143-171): one KV tile loops over the Q tiles,
//      p = exp(scale * q k^T - lse), dV += p^T dO, dS = p (dO V^T - delta),
//      dK += scale * dS^T Q.
//   K5 _flash_bwd_dq_kernel (:174-193): one Q tile loops over the KV tiles,
//      dQ += scale * dS K.
// The T x T scores never reach device memory in either direction.
//
// What bounds them: at the VAE's mid attention, (B, 4 heads, T = 1024,
// d = 64) in f32, the operations (4, 8 and 6 T*T*d per head for K3, K4, K5)
// over the 67 TFLOP/s of f32 outside the tensor cores; the bytes (q, k, v,
// dO, out, lse, delta: a few MB) are 10x below that. f32 inputs compute in
// f32 FMAs, never TF32, so they stay within f32 rounding of the plain version.
// bf16 inputs are widened to f32 on load and the outputs rounded once.
//
// Design: one block of 256 threads per (batch*head, 64-row tile): a Q tile for
// K3 and K5, a KV tile for K4. The block's own tile stays in shared memory and
// the other operand streams through it in 64-row tiles, all as f32 with a
// padded row stride (D + 1) so that the column reads hit 32 banks. Thread
// (ty, tx) of the 16 x 16 grid owns score rows ty + 16 i and columns tx + 16 j
// (i, j < 4) of each 64 x 64 score tile; a row's 16 threads are one half-warp,
// so row max and row sum are shuffles. Ragged tails are masked: keys past Tk
// get a score of -inf in K3 and p = 0 in K5, query rows past Tq get p = 0 in
// K4 (where JAX pads them with lse = 1e30), and nothing past either end is
// stored. K4 owns its KV tile and K5 its Q tile, so neither needs atomics and
// both are deterministic. Head dims up to 128 are padded with zeros to D = 32,
// 64 or 128. wgmma, TMA and warp specialisation are later work.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kTile = 64;                 // rows of every tile
constexpr int kThreads = 256;             // a 16 x 16 grid
constexpr int kPer = kTile / 16;          // score rows (and columns) per thread
constexpr int kPStride = kTile + 1;       // row stride of a 64 x 64 score tile
constexpr int kPFloats = kTile * kPStride;

template <int D>
struct Shape {
  static constexpr int kStride = D + 1;   // row stride of a 64 x D operand tile
  static constexpr int kFloats = kTile * kStride;
  static constexpr int kCols = D / 16;    // output columns per thread: tx + 16 c
};

// rows [r0, r0 + 64) of a row-major (rows, d) matrix, times mul, into a
// (64, D) f32 tile of stride D + 1; zeros past the rows and past d
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, const T* __restrict__ src,
                                          int r0, int rows, int d, float mul) {
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    float val = 0.f;
    if (r0 + r < rows && c < d) val = fmdm::to_float(src[static_cast<int64_t>(r0 + r) * d + c]) * mul;
    dst[r * Shape<D>::kStride + c] = val;
  }
}

// 64 entries of a per-row f32 vector; zeros past the rows
__device__ __forceinline__ void load_rows(float* __restrict__ dst, const float* __restrict__ src,
                                          int r0, int rows) {
  if (threadIdx.x < kTile) dst[threadIdx.x] = r0 + threadIdx.x < rows ? src[r0 + threadIdx.x] : 0.f;
}

// s[i][j] = sum_c a[ty + 16 i][c] * b[tx + 16 j][c] over two (64, D) tiles
template <int D>
__device__ __forceinline__ void tile_dot(float (&s)[kPer][kPer], const float* __restrict__ a,
                                         const float* __restrict__ b, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) s[i][j] = 0.f;
  }
#pragma unroll 8
  for (int c = 0; c < D; ++c) {
    float av[kPer], bv[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) av[i] = a[(ty + 16 * i) * Shape<D>::kStride + c];
#pragma unroll
    for (int j = 0; j < kPer; ++j) bv[j] = b[(tx + 16 * j) * Shape<D>::kStride + c];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }
  }
}

// reductions over the 16 threads of a half-warp (one score row)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int offset = 8; offset > 0; offset >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, offset));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int offset = 8; offset > 0; offset >>= 1) v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

// K3: out = softmax(scale * q k^T) v and lse = m + log l, per 64-row Q tile
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              T* __restrict__ o, float* __restrict__ lse, int tq, int tk, int d, float scale) {
  using S = Shape<D>;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;             // q * scale, this block's rows
  float* sk = sq + S::kFloats;  // the current KV tile
  float* sv = sk + S::kFloats;
  float* sp = sv + S::kFloats;  // exp(s - m) of the current tile
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * kTile;
  const int64_t bh = blockIdx.y;
  const T* kh = k + bh * tk * d;
  const T* vh = v + bh * tk * d;

  load_tile<T, D>(sq, q + bh * tq * d, q0, tq, d, scale);

  float m[kPer], l[kPer], acc[kPer][S::kCols];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < S::kCols; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < tk; k0 += kTile) {
    const int nk = min(kTile, tk - k0);
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(sk, kh, k0, tk, d, 1.f);
    load_tile<T, D>(sv, vh, k0, tk, d, 1.f);
    __syncthreads();

    float s[kPer][kPer];
    tile_dot<D>(s, sq, sk, ty, tx);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if (tx + 16 * j >= nk) s[i][j] = -INFINITY;  // keys past Tk
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));  // finite: a tile holds >= 1 key
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float p = expf(s[i][j] - m_new);
        sp[(ty + 16 * i) * kPStride + tx + 16 * j] = p;
        ps += p;
      }
      const float correction = expf(m[i] - m_new);
      l[i] = l[i] * correction + row_sum(ps);
#pragma unroll
      for (int c = 0; c < S::kCols; ++c) acc[i][c] *= correction;
      m[i] = m_new;
    }
    __syncthreads();

    // acc[row][col] += sum_j p[row][j] * v[j][col]
    for (int j = 0; j < nk; ++j) {
      float vv[S::kCols];
#pragma unroll
      for (int c = 0; c < S::kCols; ++c) vv[c] = sv[j * S::kStride + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const float p = sp[(ty + 16 * i) * kPStride + j];
#pragma unroll
        for (int c = 0; c < S::kCols; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= tq) continue;
    T* orow = o + (bh * tq + row) * d;
#pragma unroll
    for (int c = 0; c < S::kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < d) orow[col] = fmdm::from_float<T>(acc[i][c] / l[i]);
    }
    if (tx == 0) lse[bh * tq + row] = m[i] + logf(l[i]);
  }
}

// K4: dK and dV of one 64-key tile, looping over the Q tiles
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                  int tq, int tk, int d, float scale) {
  using S = Shape<D>;
  extern __shared__ __align__(16) float smem[];
  float* sk = smem;               // this block's keys
  float* sv = sk + S::kFloats;
  float* sq = sv + S::kFloats;    // the current Q tile
  float* sdo = sq + S::kFloats;
  float* sp = sdo + S::kFloats;   // p[row][key]
  float* sds = sp + kPFloats;     // dS[row][key]
  float* slse = sds + kPFloats;
  float* sdelta = slse + kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k0 = blockIdx.x * kTile;
  const int64_t bh = blockIdx.y;
  const T* qh = q + bh * tq * d;
  const T* doh = dout + bh * tq * d;
  const float* lseh = lse + bh * tq;
  const float* deltah = delta + bh * tq;

  load_tile<T, D>(sk, k + bh * tk * d, k0, tk, d, 1.f);
  load_tile<T, D>(sv, v + bh * tk * d, k0, tk, d, 1.f);

  // keys ty + 16 i, columns tx + 16 c
  float dk_acc[kPer][S::kCols], dv_acc[kPer][S::kCols];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
#pragma unroll
    for (int c = 0; c < S::kCols; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;
  }

  for (int q0 = 0; q0 < tq; q0 += kTile) {
    const int nq = min(kTile, tq - q0);
    __syncthreads();
    load_tile<T, D>(sq, qh, q0, tq, d, 1.f);
    load_tile<T, D>(sdo, doh, q0, tq, d, 1.f);
    load_rows(slse, lseh, q0, tq);
    load_rows(sdelta, deltah, q0, tq);
    __syncthreads();

    // rows ty + 16 i of this Q tile, keys tx + 16 j of this block's tile
    float s[kPer][kPer], dp[kPer][kPer];
    tile_dot<D>(s, sq, sk, ty, tx);
    tile_dot<D>(dp, sdo, sv, ty, tx);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = ty + 16 * i;
      const bool live = r < nq;  // query rows past Tq add nothing
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float p = live ? expf(scale * s[i][j] - slse[r]) : 0.f;
        sp[r * kPStride + tx + 16 * j] = p;
        sds[r * kPStride + tx + 16 * j] = p * (dp[i][j] - sdelta[r]);
      }
    }
    __syncthreads();

    // dv[key][col] += sum_r p[r][key] dO[r][col]; dk[key][col] += sum_r dS[r][key] q[r][col]
    for (int r = 0; r < nq; ++r) {
      float dov[S::kCols], qv[S::kCols];
#pragma unroll
      for (int c = 0; c < S::kCols; ++c) {
        dov[c] = sdo[r * S::kStride + tx + 16 * c];
        qv[c] = sq[r * S::kStride + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const float p = sp[r * kPStride + ty + 16 * i];
        const float ds = sds[r * kPStride + ty + 16 * i];
#pragma unroll
        for (int c = 0; c < S::kCols; ++c) {
          dv_acc[i][c] = fmaf(p, dov[c], dv_acc[i][c]);
          dk_acc[i][c] = fmaf(ds, qv[c], dk_acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= tk) continue;
#pragma unroll
    for (int c = 0; c < S::kCols; ++c) {
      const int col = tx + 16 * c;
      if (col >= d) continue;
      dk[(bh * tk + key) * d + col] = fmdm::from_float<T>(scale * dk_acc[i][c]);
      dv[(bh * tk + key) * d + col] = fmdm::from_float<T>(dv_acc[i][c]);
    }
  }
}

// K5: dQ of one 64-row Q tile, looping over the KV tiles
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dq, int tq, int tk, int d,
                 float scale) {
  using S = Shape<D>;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;               // this block's rows
  float* sdo = sq + S::kFloats;
  float* sk = sdo + S::kFloats;   // the current KV tile
  float* sv = sk + S::kFloats;
  float* sds = sv + S::kFloats;   // dS[row][key]
  float* slse = sds + kPFloats;
  float* sdelta = slse + kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * kTile;
  const int64_t bh = blockIdx.y;
  const T* kh = k + bh * tk * d;
  const T* vh = v + bh * tk * d;

  load_tile<T, D>(sq, q + bh * tq * d, q0, tq, d, 1.f);
  load_tile<T, D>(sdo, dout + bh * tq * d, q0, tq, d, 1.f);
  load_rows(slse, lse + bh * tq, q0, tq);
  load_rows(sdelta, delta + bh * tq, q0, tq);

  // rows ty + 16 i, columns tx + 16 c
  float dq_acc[kPer][S::kCols];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
#pragma unroll
    for (int c = 0; c < S::kCols; ++c) dq_acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < tk; k0 += kTile) {
    const int nk = min(kTile, tk - k0);
    __syncthreads();
    load_tile<T, D>(sk, kh, k0, tk, d, 1.f);
    load_tile<T, D>(sv, vh, k0, tk, d, 1.f);
    __syncthreads();

    float s[kPer][kPer], dp[kPer][kPer];
    tile_dot<D>(s, sq, sk, ty, tx);
    tile_dot<D>(dp, sdo, sv, ty, tx);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const bool live = tx + 16 * j < nk;  // keys past Tk add nothing
        const float p = live ? expf(scale * s[i][j] - slse[r]) : 0.f;
        sds[r * kPStride + tx + 16 * j] = p * (dp[i][j] - sdelta[r]);
      }
    }
    __syncthreads();

    // dq[row][col] += sum_j dS[row][j] k[j][col]
    for (int j = 0; j < nk; ++j) {
      float kv[S::kCols];
#pragma unroll
      for (int c = 0; c < S::kCols; ++c) kv[c] = sk[j * S::kStride + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const float ds = sds[(ty + 16 * i) * kPStride + j];
#pragma unroll
        for (int c = 0; c < S::kCols; ++c) dq_acc[i][c] = fmaf(ds, kv[c], dq_acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= tq) continue;
#pragma unroll
    for (int c = 0; c < S::kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < d) dq[(bh * tq + row) * d + col] = fmdm::from_float<T>(scale * dq_acc[i][c]);
    }
  }
}

template <int D>
constexpr int fwd_smem() { return (3 * Shape<D>::kFloats + kPFloats) * 4; }
template <int D>
constexpr int dkv_smem() { return (4 * Shape<D>::kFloats + 2 * kPFloats + 2 * kTile) * 4; }
template <int D>
constexpr int dq_smem() { return (4 * Shape<D>::kFloats + kPFloats + 2 * kTile) * 4; }

// Set the kernel's dynamic shared memory limit, launch, and return
// cudaGetLastError(). grid: (tiles along the block's own rows, batch*heads).
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int smem, int rows, int bh, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((rows + kTile - 1) / kTile, bh);
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t forward(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int tq,
                    int tk, int d, float scale, cudaStream_t s) {
  return launch(flash_fwd<T, D>, fwd_smem<D>(), tq, bh, s, static_cast<const T*>(q),
                static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o),
                static_cast<float*>(lse), tq, tk, d, scale);
}

template <typename T, int D>
cudaError_t backward_dkv(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dk, void* dv, int bh, int tq,
                         int tk, int d, float scale, cudaStream_t s) {
  return launch(flash_bwd_dkv<T, D>, dkv_smem<D>(), tk, bh, s, static_cast<const T*>(q),
                static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(dout),
                static_cast<const float*>(lse), static_cast<const float*>(delta),
                static_cast<T*>(dk), static_cast<T*>(dv), tq, tk, d, scale);
}

template <typename T, int D>
cudaError_t backward_dq(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dq, int bh, int tq, int tk,
                        int d, float scale, cudaStream_t s) {
  return launch(flash_bwd_dq<T, D>, dq_smem<D>(), tq, bh, s, static_cast<const T*>(q),
                static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(dout),
                static_cast<const float*>(lse), static_cast<const float*>(delta),
                static_cast<T*>(dq), tq, tk, d, scale);
}

// Run fn<T, D> with D the smallest of 32, 64, 128 that holds d.
template <template <typename, int> class Fn, typename... Args>
cudaError_t dispatch(int is_bf16, int d, Args... args) {
  if (is_bf16) {
    if (d <= 32) return Fn<__nv_bfloat16, 32>::run(args...);
    if (d <= 64) return Fn<__nv_bfloat16, 64>::run(args...);
    if (d <= 128) return Fn<__nv_bfloat16, 128>::run(args...);
  } else {
    if (d <= 32) return Fn<float, 32>::run(args...);
    if (d <= 64) return Fn<float, 64>::run(args...);
    if (d <= 128) return Fn<float, 128>::run(args...);
  }
  return cudaErrorInvalidValue;
}

template <typename T, int D>
struct Forward {
  template <typename... Args>
  static cudaError_t run(Args... args) { return forward<T, D>(args...); }
};
template <typename T, int D>
struct BackwardDkv {
  template <typename... Args>
  static cudaError_t run(Args... args) { return backward_dkv<T, D>(args...); }
};
template <typename T, int D>
struct BackwardDq {
  template <typename... Args>
  static cudaError_t run(Args... args) { return backward_dq<T, D>(args...); }
};

}  // namespace

// All tensors contiguous. q, dout, out, dq: (bh, tq, d); k, v, dk, dv:
// (bh, tk, d); lse, delta: (bh, tq) f32. q, k, v, dout and the outputs are all
// f32 or all bf16 (is_bf16). 1 <= d <= 128, bh <= 65535. Each returns
// cudaGetLastError() after its one launch (0 on success).
extern "C" int fmdm_flash_forward(int device, const void* q, const void* k, const void* v, void* o,
                                  void* lse, int bh, int tq, int tk, int d, float scale,
                                  int is_bf16, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(dispatch<Forward>(is_bf16, d, q, k, v, o, lse, bh, tq, tk, d, scale,
                                            static_cast<cudaStream_t>(stream)));
}

extern "C" int fmdm_flash_backward_dkv(int device, const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dk, void* dv, int bh, int tq, int tk, int d,
                                       float scale, int is_bf16, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(dispatch<BackwardDkv>(is_bf16, d, q, k, v, dout, lse, delta, dk, dv, bh,
                                                tq, tk, d, scale,
                                                static_cast<cudaStream_t>(stream)));
}

extern "C" int fmdm_flash_backward_dq(int device, const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dq, int bh, int tq, int tk, int d, float scale,
                                      int is_bf16, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(dispatch<BackwardDq>(is_bf16, d, q, k, v, dout, lse, delta, dq, bh, tq,
                                               tk, d, scale, static_cast<cudaStream_t>(stream)));
}
