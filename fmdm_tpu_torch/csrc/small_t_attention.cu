// K2: softmax attention at small T for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// fmdm_tpu/ops/pallas/flash_attention.py::_mha_packed_kernel (:436-449; the
// batched variant :416-433; driven by _mha_packed_forward :452-472, entry
// mha_small_t :499-523). Per head: S = Q K^T * scale in f32 from the input
// dtype, row max, exp, row sum l in f32, P rounded to V's dtype before PV
// (as at :448), PV accumulated in f32, divided by l, then cast. The scores
// stay in registers and never reach device memory.
//
// What bounds it: at the flagship's shapes (64 heads x d=8, T=256 and T=64)
// q, k, v and o are a few MB, and the work is 4*T*T*d operations per head. In
// bf16 the bytes bound it at the tensor-core rate; in f32 (outside the tensor
// cores) the operations do.
//
// Design: one block per (head, tile of up to 128 query rows), one thread per
// query row, q's row and the PV accumulator in registers (d padded to D =
// 8/16/32/64 with zeros). K and V stream through shared memory as f32 tiles
// of 64 keys, so any T works and the T x T score tile (256 KB in f32 at
// T=256) is never formed. Two passes over K: the first finds the row max,
// the second computes p = exp(s - max) once per score. Rounding P to V's
// dtype against the final max is exactly what the TPU kernel does; an online
// softmax would rescale P after rounding and change the result. Every thread
// of a block reads the same key at the same time, so shared memory serves it
// as a broadcast. Head packing is a device of the TPU's matrix unit and is not
// carried over; at d=8 the tensor cores would need padding to k=16, so this
// first version uses FMAs.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kMaxRows = 128;  // query rows (threads) per block
constexpr int kKeyTile = 64;   // keys per shared-memory tile

template <typename T, int D>
__device__ __forceinline__ void stage(float* __restrict__ dst, const T* __restrict__ src,
                                      int k0, int nk, int d) {
  for (int idx = threadIdx.x; idx < kKeyTile * D; idx += blockDim.x) {
    const int j = idx / D, i = idx % D;
    dst[idx] = (j < nk && i < d) ? fmdm::to_float(src[static_cast<int64_t>(k0 + j) * d + i]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kMaxRows)
    small_t_attention(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      T* __restrict__ o, int t, int d, float scale) {
  __shared__ __align__(16) float ks[kKeyTile * D];
  __shared__ __align__(16) float vs[kKeyTile * D];
  const int64_t head = static_cast<int64_t>(blockIdx.y) * t * d;
  const T* qh = q + head;
  const T* kh = k + head;
  const T* vh = v + head;
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = row < t;

  float qr[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    qr[i] = (active && i < d) ? fmdm::to_float(qh[static_cast<int64_t>(row) * d + i]) : 0.f;
  }

  // pass 1: the row max of the scaled scores
  float m = -INFINITY;
  for (int k0 = 0; k0 < t; k0 += kKeyTile) {
    const int nk = min(kKeyTile, t - k0);
    __syncthreads();
    stage<T, D>(ks, kh, k0, nk, d);
    __syncthreads();
    if (active) {
      for (int j = 0; j < nk; ++j) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < D; ++i) s += qr[i] * ks[j * D + i];
        m = fmaxf(m, s * scale);
      }
    }
  }

  // pass 2: p = exp(s - m), l = sum p (f32), acc = sum round(p) v (f32)
  float l = 0.f;
  float acc[D];
#pragma unroll
  for (int i = 0; i < D; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < t; k0 += kKeyTile) {
    const int nk = min(kKeyTile, t - k0);
    __syncthreads();
    stage<T, D>(ks, kh, k0, nk, d);
    stage<T, D>(vs, vh, k0, nk, d);
    __syncthreads();
    if (active) {
      for (int j = 0; j < nk; ++j) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < D; ++i) s += qr[i] * ks[j * D + i];
        const float p = expf(s * scale - m);
        l += p;
        const float p_rounded = fmdm::round_to<T>(p);
#pragma unroll
        for (int i = 0; i < D; ++i) acc[i] += p_rounded * vs[j * D + i];
      }
    }
  }

  if (active) {
    T* oh = o + head + static_cast<int64_t>(row) * d;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      if (i < d) oh[i] = fmdm::from_float<T>(acc[i] / l);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bh, int t, int d,
                   float scale, int rows, cudaStream_t stream) {
  const dim3 grid((t + rows - 1) / rows, bh);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  if (d <= 8) {
    small_t_attention<T, 8><<<grid, rows, 0, stream>>>(qt, kt, vt, ot, t, d, scale);
  } else if (d <= 16) {
    small_t_attention<T, 16><<<grid, rows, 0, stream>>>(qt, kt, vt, ot, t, d, scale);
  } else if (d <= 32) {
    small_t_attention<T, 32><<<grid, rows, 0, stream>>>(qt, kt, vt, ot, t, d, scale);
  } else if (d <= 64) {
    small_t_attention<T, 64><<<grid, rows, 0, stream>>>(qt, kt, vt, ot, t, d, scale);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: (bh, t, d) contiguous, all f32 or all bf16 (is_bf16); d <= 64;
// rows: threads per block, a multiple of 32 and at most 128. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int fmdm_small_t_attention(int device, const void* q, const void* k, const void* v,
                                      void* o, int bh, int t, int d, float scale, int rows,
                                      int is_bf16, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0 || rows > kMaxRows || rows % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = is_bf16 ? launch<__nv_bfloat16>(q, k, v, o, bh, t, d, scale, rows, s)
                : launch<float>(q, k, v, o, bh, t, d, scale, rows, s);
  return static_cast<int>(err);
}
