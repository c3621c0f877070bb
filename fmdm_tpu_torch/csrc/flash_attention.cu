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
// d = 64) in f32, the operations (4, 8 and 6 T*T*d per head for K3, K4, K5);
// the bytes (q, k, v, dO, out, lse, delta: a few MB) are 10x below them.
//
// K3 runs both products on the tensor cores in 3xTF32 (mma.cuh): each f32
// operand is split into a TF32 head and a TF32 remainder and three products
// are summed in f32, which keeps the plain version's f32 accuracy where one
// TF32 product (3 digits) would not; the least time for that is 3x the
// operations at the 495 TFLOP/s TF32 rate, 2.5x below the 67 TFLOP/s of f32
// FMAs. One block of 4 warps per (batch*head, 64-row Q tile), 16 query rows
// per warp; q * scale stays in registers, K and V pass through a 2-slot
// cp.async ring, and P goes from the score accumulators to the PV operands in
// registers (see flash_fwd). Each warp splits the K and V values it reads;
// splitting a tile once per block for all four warps was measured slower. Its exponentials are the SFU's exp2 of
// (s - max) * log2(e), a few f32 ulps from expf.
//
// K4 and K5 compute in f32 FMAs. One block of 256 threads per (batch*head,
// 64-row tile): a KV tile for K4, a Q tile for K5. The block's own tile stays
// in shared memory and the other operand streams through it in 64-row tiles,
// all as f32 with a padded row stride (D + 1) so that the column reads hit 32
// banks. Thread (ty, tx) of the 16 x 16 grid owns score rows ty + 16 i and
// columns tx + 16 j (i, j < 4) of each 64 x 64 score tile; a row's 16 threads
// are one half-warp, so row max and row sum are shuffles.
//
// bf16 inputs are widened to f32 as they are read and the outputs rounded
// once. Ragged tails are masked: keys past Tk get a score of -inf in K3 and
// p = 0 in K5, query rows past Tq get p = 0 in K4 (where JAX pads them with
// lse = 1e30), and nothing past either end is stored. K4 owns its KV tile and
// K5 its Q tile, so neither needs atomics and both are deterministic. Head
// dims up to 128 are padded with zeros to D = 32, 64 or 128. wgmma, TMA and
// warp specialisation are later work.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kTile = 64;                 // rows of every tile
constexpr int kThreads = 256;             // K4, K5: a 16 x 16 grid
constexpr int kFwdThreads = 128;          // K3: 4 warps of 16 query rows
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

// K3: out = softmax(scale * q k^T) v and lse = m + log l, per 64-row Q tile,
// on the tensor cores in 3xTF32 (mma.cuh). Warp w owns query rows 16 w ..
// 16 w + 15 of the tile: q * scale stays in registers as f32 A fragments,
// the scores and the output accumulate in C fragments, and rows g and g + 8
// of a fragment belong to one quad, so row max and row sum are quad shuffles.
// K and V pass through a 2-slot cp.async ring of 64-key tiles.
template <typename T, int D>
__global__ void __launch_bounds__(kFwdThreads)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              T* __restrict__ o, float* __restrict__ lse, int tq, int tk, int d, float scale,
              int aligned) {
  constexpr int S = fmdm::smem_stride<T, D>();
  constexpr int kTileElems = kTile * S;
  extern __shared__ __align__(16) unsigned char fwd_tiles[];
  T* ks = reinterpret_cast<T*>(fwd_tiles);  // two slots of 64 keys
  T* vs = ks + 2 * kTileElems;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int64_t bh = blockIdx.y;
  const int row0 = blockIdx.x * kTile + 16 * warp;
  const bool live = row0 < tq;  // uniform over the warp
  const T* kh = k + bh * tk * d;
  const T* vh = v + bh * tk * d;

  float qa[D / 8][4];  // q * scale in f32, as JAX scales it before the dot (:37)
  fmdm::load_a_tf32<T, D>(qa, q + bh * tq * d, row0, tq, d, scale, g, t);

  // rows g and g + 8: the running max, this lane's share of the running sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  }

  auto stage = [&](int tile) {
    const int slot = tile % 2;
    fmdm::stage_rows<T, D, S, kTile>(ks + slot * kTileElems, kh, tile * kTile, tk, d, aligned);
    fmdm::stage_rows<T, D, S, kTile>(vs + slot * kTileElems, vh, tile * kTile, tk, d, aligned);
    fmdm::cp_async_commit();
  };
  const int ntiles = (tk + kTile - 1) / kTile;
  stage(0);
  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) stage(i + 1); else fmdm::cp_async_commit();
    fmdm::cp_async_wait<1>();
    __syncthreads();
    if (live) {
      const int slot = i % 2;
      float s[8][4];
      fmdm::qk_3xtf32<T, D, S>(s, qa, ks + slot * kTileElems, g, t);
      if ((i + 1) * kTile > tk) {  // the last tile is ragged: keys past Tk score -inf
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (i * kTile + 8 * n + 2 * t + (j & 1) >= tk) s[n][j] = -INFINITY;
          }
        }
      }
      float m_new[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int j = 0; j < 4; ++j) m_new[j >> 1] = fmaxf(m_new[j >> 1], s[n][j]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m_new[h] = fmdm::quad_max(m_new[h]);  // finite: a tile holds >= 1 key
        const float correction = fmdm::exp2_approx((m[h] - m_new[h]) * fmdm::kLog2e);
        l[h] *= correction;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          acc[n][2 * h] *= correction;
          acc[n][2 * h + 1] *= correction;
        }
        m[h] = m_new[h];
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[n][j] = fmdm::exp2_approx((s[n][j] - m[j >> 1]) * fmdm::kLog2e);
          l[j >> 1] += s[n][j];
        }
      }
      fmdm::pv_3xtf32<T, D, S>(acc, s, vs + slot * kTileElems, g, t);
    }
    __syncthreads();  // the slot is free for the copy issued next
  }

  if (!live) return;
  l[0] = fmdm::quad_sum(l[0]);
  l[1] = fmdm::quad_sum(l[1]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= tq) continue;
    T* orow = o + (bh * tq + row) * d;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = 8 * n + 2 * t + j;
        if (col < d) orow[col] = fmdm::from_float<T>(acc[n][2 * h + j] / l[h]);
      }
    }
    if (t == 0) lse[bh * tq + row] = m[h] + logf(l[h]);
  }
}

template <typename T, int D>
constexpr int fwd_smem() { return 4 * kTile * fmdm::smem_stride<T, D>() * sizeof(T); }  // K, V x 2

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
constexpr int dkv_smem() { return (4 * Shape<D>::kFloats + 2 * kPFloats + 2 * kTile) * 4; }
template <int D>
constexpr int dq_smem() { return (4 * Shape<D>::kFloats + kPFloats + 2 * kTile) * 4; }

// Set the kernel's dynamic shared memory limit, launch, and return
// cudaGetLastError(). grid: (tiles along the block's own rows, batch*heads).
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int threads, int smem, int rows, int bh, cudaStream_t stream,
                   Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((rows + kTile - 1) / kTile, bh);
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t forward(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int tq,
                    int tk, int d, float scale, cudaStream_t s) {
  return launch(flash_fwd<T, D>, kFwdThreads, fwd_smem<T, D>(), tq, bh, s,
                static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<T*>(o), static_cast<float*>(lse), tq, tk, d, scale,
                static_cast<int>(fmdm::rows_aligned<T>(d, k, v)));
}

template <typename T, int D>
cudaError_t backward_dkv(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dk, void* dv, int bh, int tq,
                         int tk, int d, float scale, cudaStream_t s) {
  return launch(flash_bwd_dkv<T, D>, kThreads, dkv_smem<D>(), tk, bh, s, static_cast<const T*>(q),
                static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(dout),
                static_cast<const float*>(lse), static_cast<const float*>(delta),
                static_cast<T*>(dk), static_cast<T*>(dv), tq, tk, d, scale);
}

template <typename T, int D>
cudaError_t backward_dq(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dq, int bh, int tq, int tk,
                        int d, float scale, cudaStream_t s) {
  return launch(flash_bwd_dq<T, D>, kThreads, dq_smem<D>(), tq, bh, s, static_cast<const T*>(q),
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
