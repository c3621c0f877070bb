// K1: fused GroupNorm(+affine)(+FiLM)(+SiLU) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fmdm_tpu/ops/pallas/group_norm.py::_kernel
// (:54-89, driven by _pallas_impl :92-128, entry fused_group_norm_act). Per
// (sample, group): f32 mean and variance over cg x spatial (one-pass
// E[x^2]-mean^2, clamped at 0 as the XLA path at ops/norm.py:45 does), then
// (x-mean)*rstd*w+b, optional FiLM y*(1+scale)+shift, optional SiLU, written
// once in the input dtype.
//
// What bounds it: memory. It does ~10 operations per element, against the
// H100's 3.35 TB/s; the least possible time is one read of x and one write of
// the output at that rate.
//
// Design: the TPU kernel keeps a whole group in VMEM and reads it once. One
// flagship group is 4 ch x 256^2 = 262,144 elements (512 KB in bf16), more
// than the 227 KB of shared memory a block can use, and blocks cannot carry a
// sum from one to the next. So two passes:
//   1. gn_stats: a split reduction. grid (splits, N*G); each block reduces a
//      contiguous chunk of its group (a group is contiguous in NCHW) to f32
//      (sum, sum of squares) in a scratch buffer the wrapper allocates. No
//      atomics, so the result is deterministic.
//   2. gn_apply: the same grid; each block combines its group's partials,
//      computes mean and rstd, and rewrites its chunk.
// Both passes move 16 bytes per thread per load when the spatial size is a
// multiple of the vector width (then a vector never straddles two channels);
// otherwise they fall back to one element per load. That is two reads and one
// write: 1.5x the bound. A single-pass cluster design is later work.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
struct Pack {
  static constexpr int kN = 16 / sizeof(T);  // elements per 16-byte vector
};

// Sum a and b over the block; the result is valid in warp 0.
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float sa[kWarps], sb[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = fmdm::warp_sum(a);
  b = fmdm::warp_sum(b);
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < kWarps ? sa[lane] : 0.f;
    b = lane < kWarps ? sb[lane] : 0.f;
    a = fmdm::warp_sum(a);
    b = fmdm::warp_sum(b);
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    gn_stats(const T* __restrict__ x, float* __restrict__ partials, int64_t group_size,
             int64_t chunk) {
  const int split = blockIdx.x;
  const int splits = gridDim.x;
  const int64_t grp = blockIdx.y;
  const T* base = x + grp * group_size;
  const int64_t begin = split * chunk;
  const int64_t end = begin + chunk < group_size ? begin + chunk : group_size;
  float s1 = 0.f, s2 = 0.f;
  if (kVec) {
    constexpr int N = Pack<T>::kN;
    const uint4* p = reinterpret_cast<const uint4*>(base + begin);
    const int64_t nvec = end > begin ? (end - begin) / N : 0;
    for (int64_t i = threadIdx.x; i < nvec; i += kThreads) {
      uint4 raw = __ldg(p + i);
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float f = fmdm::to_float(v[j]);
        s1 += f;
        s2 += f * f;
      }
    }
  } else {
    for (int64_t i = begin + threadIdx.x; i < end; i += kThreads) {
      const float f = fmdm::to_float(base[i]);
      s1 += f;
      s2 += f * f;
    }
  }
  block_sum2(s1, s2);
  if (threadIdx.x == 0) {
    partials[2 * (grp * splits + split)] = s1;
    partials[2 * (grp * splits + split) + 1] = s2;
  }
}

template <typename T, typename W>
struct Apply {
  float mean, rstd;
  const W* weight;
  const W* bias;
  const T* scale;  // (N, C) or nullptr
  const T* shift;
  int act;

  __device__ __forceinline__ float operator()(float v, int c, int64_t nc) const {
    float y = (v - mean) * rstd;
    y = y * fmdm::to_float(weight[c]) + fmdm::to_float(bias[c]);
    if (scale != nullptr) {
      y = y * (1.f + fmdm::to_float(scale[nc])) + fmdm::to_float(shift[nc]);
    }
    if (act) y = y / (1.f + expf(-y));  // SiLU
    return y;
  }
};

template <typename T, typename W, bool kVec>
__global__ void __launch_bounds__(kThreads)
    gn_apply(const T* __restrict__ x, const W* __restrict__ weight, const W* __restrict__ bias,
             const T* __restrict__ scale, const T* __restrict__ shift, T* __restrict__ out,
             const float* __restrict__ partials, int channels, int groups, int64_t hw,
             int64_t chunk, float eps, int act) {
  const int split = blockIdx.x;
  const int splits = gridDim.x;
  const int64_t grp = blockIdx.y;
  const int n = static_cast<int>(grp / groups);
  const int g = static_cast<int>(grp % groups);
  const int cg = channels / groups;
  const int64_t group_size = static_cast<int64_t>(cg) * hw;

  __shared__ float s_mean, s_rstd;
  if (threadIdx.x < 32) {
    float a = 0.f, b = 0.f;
    for (int i = threadIdx.x; i < splits; i += 32) {
      a += partials[2 * (grp * splits + i)];
      b += partials[2 * (grp * splits + i) + 1];
    }
    a = fmdm::warp_sum(a);
    b = fmdm::warp_sum(b);
    if (threadIdx.x == 0) {
      const float m = static_cast<float>(group_size);
      const float mean = a / m;
      const float var = fmaxf(b / m - mean * mean, 0.f);
      s_mean = mean;
      s_rstd = rsqrtf(var + eps);
    }
  }
  __syncthreads();

  const Apply<T, W> f{s_mean, s_rstd, weight, bias, scale, shift, act};
  const int64_t offset = grp * group_size;
  const int c0 = g * cg;
  const int64_t nc0 = static_cast<int64_t>(n) * channels + c0;
  const int64_t begin = split * chunk;
  const int64_t end = begin + chunk < group_size ? begin + chunk : group_size;
  if (kVec) {
    constexpr int N = Pack<T>::kN;
    const uint4* src = reinterpret_cast<const uint4*>(x + offset + begin);
    uint4* dst = reinterpret_cast<uint4*>(out + offset + begin);
    const int64_t nvec = end > begin ? (end - begin) / N : 0;
    for (int64_t i = threadIdx.x; i < nvec; i += kThreads) {
      const int cl = static_cast<int>((begin + i * N) / hw);  // channel within the group
      uint4 raw = __ldg(src + i);
      T* v = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        v[j] = fmdm::from_float<T>(f(fmdm::to_float(v[j]), c0 + cl, nc0 + cl));
      }
      dst[i] = raw;
    }
  } else {
    for (int64_t i = begin + threadIdx.x; i < end; i += kThreads) {
      const int cl = static_cast<int>(i / hw);
      out[offset + i] = fmdm::from_float<T>(f(fmdm::to_float(x[offset + i]), c0 + cl, nc0 + cl));
    }
  }
}

template <typename T, typename W>
cudaError_t launch(const void* x, const void* weight, const void* bias, const void* scale,
                   const void* shift, void* out, float* partials, int n, int channels,
                   int groups, int64_t hw, int splits, int64_t chunk, float eps, int act,
                   bool vec, cudaStream_t stream) {
  const dim3 grid(splits, n * groups);
  const int64_t group_size = static_cast<int64_t>(channels / groups) * hw;
  const T* xt = static_cast<const T*>(x);
  const W* wt = static_cast<const W*>(weight);
  const W* bt = static_cast<const W*>(bias);
  const T* st = static_cast<const T*>(scale);
  const T* tt = static_cast<const T*>(shift);
  T* ot = static_cast<T*>(out);
  if (vec) {
    gn_stats<T, true><<<grid, kThreads, 0, stream>>>(xt, partials, group_size, chunk);
  } else {
    gn_stats<T, false><<<grid, kThreads, 0, stream>>>(xt, partials, group_size, chunk);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (vec) {
    gn_apply<T, W, true><<<grid, kThreads, 0, stream>>>(xt, wt, bt, st, tt, ot, partials, channels,
                                                         groups, hw, chunk, eps, act);
  } else {
    gn_apply<T, W, false><<<grid, kThreads, 0, stream>>>(xt, wt, bt, st, tt, ot, partials,
                                                          channels, groups, hw, chunk, eps, act);
  }
  return cudaGetLastError();
}

}  // namespace

// x, out: (N, C, hw) contiguous, f32 or bf16 (x_bf16); weight, bias: (C,) f32
// or bf16 (w_bf16); scale, shift: (N, C) in x's dtype, or null for no FiLM;
// partials: f32 scratch of 2 * N * groups * splits. Split s of a group covers
// elements [s*chunk, min((s+1)*chunk, C/groups*hw)). With vec set, chunk and
// hw are multiples of the 16-byte vector width and the pointers 16-byte
// aligned. Returns cudaGetLastError() after the launches (0 on success).
extern "C" int fmdm_group_norm_act(int device, const void* x, const void* weight,
                                   const void* bias, const void* scale, const void* shift,
                                   void* out, void* partials, int n, int channels, int groups,
                                   long long hw, int splits, long long chunk, float eps, int act,
                                   int x_bf16, int w_bf16, int vec, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* part = static_cast<float*>(partials);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool v = vec != 0;
  if (x_bf16) {
    err = w_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(x, weight, bias, scale, shift, out, part, n,
                                                         channels, groups, hw, splits, chunk, eps,
                                                         act, v, s)
                 : launch<__nv_bfloat16, float>(x, weight, bias, scale, shift, out, part, n,
                                                channels, groups, hw, splits, chunk, eps, act, v, s);
  } else {
    err = w_bf16 ? launch<float, __nv_bfloat16>(x, weight, bias, scale, shift, out, part, n,
                                                channels, groups, hw, splits, chunk, eps, act, v, s)
                 : launch<float, float>(x, weight, bias, scale, shift, out, part, n, channels,
                                        groups, hw, splits, chunk, eps, act, v, s);
  }
  return static_cast<int>(err);
}

extern "C" const char* fmdm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
