// K1: fused GroupNorm(+affine)(+FiLM)(+SiLU) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fmdm_tpu/ops/pallas/group_norm.py::_kernel
// (:54-89, driven by _pallas_impl :92-128, entry fused_group_norm_act). Per
// (sample, group): f32 mean and variance over cg x spatial (one-pass
// E[x^2]-mean^2, clamped at 0 as the XLA path at ops/norm.py:45 does), then
// (x-mean)*rstd*w+b, optional FiLM y*(1+scale)+shift, optional SiLU, written
// once in the input dtype.
//
// What bounds it: bytes. It does ~11 f32 operations per element against the
// H100's 3.35 TB/s; the least possible time is one read of x and one write of
// the output at that rate.
//
// Design: the TPU kernel keeps a whole group in VMEM and reads it once. A
// group is contiguous in NCHW; a flagship group is 512 KB or 1 MB in bf16,
// more than the 227 KB of shared memory one block can use. So:
//   gn_cluster, the single pass (every group up to R x 227 KB): one
//     thread-block cluster of R CTAs per (sample, group), R <= 8, or 16 where
//     the card schedules the non-portable size. CTA r copies its contiguous
//     chunk of the group once into dynamic shared memory with 1-D bulk copies
//     (TMA), in a few pieces that each complete an mbarrier, and sums each
//     piece to f32 (sum, sum of squares) as it lands. After a cluster barrier
//     every CTA reads the R partials through distributed shared memory in rank
//     order, so every CTA gets the same mean and rstd and two calls the same
//     bits; it then normalizes its chunk from shared memory and writes it once
//     with 16-byte stores. A second cluster barrier keeps each CTA resident
//     until its peers have read its partials. One read of x and one write:
//     the bound's traffic. Small groups are clusters of one.
//   gn_stats + gn_apply, the split (groups no cluster can hold): a split f32
//     reduction into a scratch buffer, then an apply pass that reads x again.
//     Two reads and one write, a floor of 1.5x the bound. No atomics, so it
//     is deterministic too.
// Where the spatial size is not a multiple of the 16-byte vector, or a
// pointer is not 16-byte aligned, both move one element per load (gn_cluster
// still holds its chunk in shared memory and reads x once).

#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPieces = 8;     // bulk copies (and mbarriers) per chunk
constexpr int kMaxCluster = 16;
constexpr int kMaxDevices = 64;   // devices whose kernel attributes are remembered

// 16 bytes of T as floats, and back (bf16 rounded to nearest even, as torch).
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const uint4& r, float (&f)[kN]) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  __device__ __forceinline__ static uint4 store(const float (&f)[kN]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(const uint4& r, float (&f)[kN]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static uint4 store(const float (&f)[kN]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&p);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// n / d for 0 <= n < 2^31 by a multiply-high and a shift (the method of
// PyTorch's IntDivider): the channel of an element without a division.
struct FastDiv {
  uint32_t magic, shift;
  __device__ __forceinline__ uint32_t operator()(uint32_t n) const {
    return (__umulhi(n, magic) + n) >> shift;
  }
};

FastDiv make_fast_div(uint32_t d) {  // 1 <= d <= 2^31
  uint32_t s = 0;
  while ((1ull << s) < d) ++s;
  const uint64_t magic = ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  return {static_cast<uint32_t>(magic), s};
}

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

// mean and rstd from the group's (sum, sum of squares) over m elements.
__device__ __forceinline__ void moments(float s1, float s2, float m, float eps, float& mean,
                                        float& rstd) {
  mean = s1 / m;
  const float var = fmaxf(s2 / m - mean * mean, 0.f);
  rstd = rsqrtf(var + eps);
}

// One channel's affine and FiLM as f32 coefficients.
struct Channel {
  float w, b, scale1, shift;  // scale1 = 1 + scale
};

template <typename T, typename W>
__device__ __forceinline__ Channel channel(const W* weight, const W* bias, const T* scale,
                                           const T* shift, int c, int64_t nc) {
  Channel ch{fmdm::to_float(weight[c]), fmdm::to_float(bias[c]), 1.f, 0.f};
  if (scale != nullptr) {
    ch.scale1 = 1.f + fmdm::to_float(scale[nc]);
    ch.shift = fmdm::to_float(shift[nc]);
  }
  return ch;
}

__device__ __forceinline__ float finish(float v, float mean, float rstd, const Channel& ch,
                                        bool film, bool act) {
  float y = (v - mean) * rstd;
  y = y * ch.w + ch.b;
  if (film) y = y * ch.scale1 + ch.shift;
  if (act) y = __fdividef(y, 1.f + __expf(-y));  // SiLU; 0 where exp(-y) overflows
  return y;
}

// ---- Hopper's bulk copy, mbarriers and cluster barriers (inline PTX) ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from global memory
// into this CTA's shared memory; completes `bytes` of the mbarrier's count
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@!P1 bra LAB_WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// arrive (release) and wait (acquire) on the cluster's barrier, split so that
// the work between them overlaps the peers' arrival
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// ---- the single pass ----

// grid (R, N*G), cluster (R, 1, 1): CTA r of cluster y holds elements
// [r*chunk, min((r+1)*chunk, group_size)) of group y in shared memory.
// With kVec, chunk and piece are multiples of the 16-byte vector (piece of
// kThreads vectors), per_channel divides by hw/N, and x, out are 16-byte
// aligned; otherwise per_channel divides by hw.
template <typename T, typename W, bool kVec>
__global__ void __launch_bounds__(kThreads)
    gn_cluster(const T* __restrict__ x, const W* __restrict__ weight, const W* __restrict__ bias,
               const T* __restrict__ scale, const T* __restrict__ shift, T* __restrict__ out,
               int channels, int groups, int group_size, int chunk, int piece,
               FastDiv per_channel, float eps, int act) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[kMaxPieces];
  __shared__ float2 partial;
  __shared__ float s_mean, s_rstd;

  const int ctas = gridDim.x;
  const int begin = blockIdx.x * chunk;
  const int len = max(0, min(chunk, group_size - begin));
  const int64_t grp = blockIdx.y;
  const int64_t offset = grp * group_size + begin;
  T* held = reinterpret_cast<T*>(smem);

  float s1 = 0.f, s2 = 0.f;
  if (kVec) {
    constexpr int N = Vec<T>::kN;
    const int pieces = (len + piece - 1) / piece;
    const uint32_t bar0 = smem_addr(bars);
    if (threadIdx.x == 0) {
      for (int p = 0; p < pieces; ++p) mbar_init(bar0 + 8 * p, 1);
      fence_mbar_init();
      for (int p = 0; p < pieces; ++p) {
        const int start = p * piece;
        const uint32_t bytes = static_cast<uint32_t>(min(piece, len - start)) * sizeof(T);
        mbar_expect_tx(bar0 + 8 * p, bytes);
        bulk_load(smem_addr(held + start), x + offset + start, bytes, bar0 + 8 * p);
      }
    }
    __syncthreads();  // the mbarriers are initialized before anyone waits on them
    const uint4* v = reinterpret_cast<const uint4*>(held);
    for (int p = 0; p < pieces; ++p) {
      mbar_wait(bar0 + 8 * p, 0);
      // a piece is a whole number of sweeps of the block, so each thread sums
      // its vectors in the order of one strided pass over the chunk
      const int end = min((p + 1) * piece, len) / N;
      for (int i = p * piece / N + threadIdx.x; i < end; i += kThreads) {
        float f[N];
        Vec<T>::load(v[i], f);
#pragma unroll
        for (int j = 0; j < N; ++j) {
          s1 += f[j];
          s2 += f[j] * f[j];
        }
      }
    }
  } else {
    for (int i = threadIdx.x; i < len; i += kThreads) {
      const T e = x[offset + i];
      held[i] = e;
      const float f = fmdm::to_float(e);
      s1 += f;
      s2 += f * f;
    }
  }
  block_sum2(s1, s2);
  if (threadIdx.x == 0) partial = make_float2(s1, s2);

  cg::cluster_group cluster = cg::this_cluster();
  if (ctas > 1) {
    cluster.sync();  // every CTA's partials are written
  } else {
    __syncthreads();
  }
  if (threadIdx.x < 32) {
    float2 mine = make_float2(0.f, 0.f);
    if (static_cast<int>(threadIdx.x) < ctas) {
      mine = ctas > 1 ? *cluster.map_shared_rank(&partial, threadIdx.x) : partial;
    }
    float a = 0.f, b = 0.f;
    for (int r = 0; r < ctas; ++r) {  // rank order, the same in every CTA
      a += __shfl_sync(0xffffffffu, mine.x, r);
      b += __shfl_sync(0xffffffffu, mine.y, r);
    }
    if (threadIdx.x == 0) moments(a, b, static_cast<float>(group_size), eps, s_mean, s_rstd);
  }
  __syncthreads();
  if (ctas > 1) cluster_arrive();  // this CTA is done reading its peers

  const float mean = s_mean, rstd = s_rstd;
  const bool film = scale != nullptr, silu = act != 0;
  const int n = static_cast<int>(grp / groups);
  const int c0 = static_cast<int>(grp % groups) * (channels / groups);
  const int64_t nc0 = static_cast<int64_t>(n) * channels + c0;
  if (kVec) {
    constexpr int N = Vec<T>::kN;
    const uint4* v = reinterpret_cast<const uint4*>(held);
    uint4* dst = reinterpret_cast<uint4*>(out + offset);
    const int v0 = begin / N;
    for (int i = threadIdx.x; i < len / N; i += kThreads) {
      const int cl = static_cast<int>(per_channel(v0 + i));
      const Channel ch = channel(weight, bias, scale, shift, c0 + cl, nc0 + cl);
      float f[N];
      Vec<T>::load(v[i], f);
#pragma unroll
      for (int j = 0; j < N; ++j) f[j] = finish(f[j], mean, rstd, ch, film, silu);
      dst[i] = Vec<T>::store(f);
    }
  } else {
    for (int i = threadIdx.x; i < len; i += kThreads) {
      const int cl = static_cast<int>(per_channel(begin + i));
      const Channel ch = channel(weight, bias, scale, shift, c0 + cl, nc0 + cl);
      out[offset + i] =
          fmdm::from_float<T>(finish(fmdm::to_float(held[i]), mean, rstd, ch, film, silu));
    }
  }
  if (ctas > 1) cluster_wait();  // no CTA leaves while a peer may still read its partials
}

// ---- the split: groups larger than any cluster holds ----

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
    constexpr int N = Vec<T>::kN;
    const uint4* p = reinterpret_cast<const uint4*>(base + begin);
    const int64_t nvec = end > begin ? (end - begin) / N : 0;
    for (int64_t i = threadIdx.x; i < nvec; i += kThreads) {
      float f[N];
      Vec<T>::load(__ldg(p + i), f);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        s1 += f[j];
        s2 += f[j] * f[j];
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
    if (threadIdx.x == 0) moments(a, b, static_cast<float>(group_size), eps, s_mean, s_rstd);
  }
  __syncthreads();

  const float mean = s_mean, rstd = s_rstd;
  const bool film = scale != nullptr, silu = act != 0;
  const int64_t offset = grp * group_size;
  const int c0 = g * cg;
  const int64_t nc0 = static_cast<int64_t>(n) * channels + c0;
  const int64_t begin = split * chunk;
  const int64_t end = begin + chunk < group_size ? begin + chunk : group_size;
  if (kVec) {
    constexpr int N = Vec<T>::kN;
    const uint4* src = reinterpret_cast<const uint4*>(x + offset + begin);
    uint4* dst = reinterpret_cast<uint4*>(out + offset + begin);
    const int64_t nvec = end > begin ? (end - begin) / N : 0;
    for (int64_t i = threadIdx.x; i < nvec; i += kThreads) {
      const int cl = static_cast<int>((begin + i * N) / hw);  // channel within the group
      const Channel ch = channel(weight, bias, scale, shift, c0 + cl, nc0 + cl);
      float f[N];
      Vec<T>::load(__ldg(src + i), f);
#pragma unroll
      for (int j = 0; j < N; ++j) f[j] = finish(f[j], mean, rstd, ch, film, silu);
      dst[i] = Vec<T>::store(f);
    }
  } else {
    for (int64_t i = begin + threadIdx.x; i < end; i += kThreads) {
      const int cl = static_cast<int>(i / hw);
      const Channel ch = channel(weight, bias, scale, shift, c0 + cl, nc0 + cl);
      out[offset + i] =
          fmdm::from_float<T>(finish(fmdm::to_float(x[offset + i]), mean, rstd, ch, film, silu));
    }
  }
}

// ---- host side ----

struct Args {
  const void *x, *weight, *bias, *scale, *shift;
  void* out;
  float* partials;
  int device, n, channels, groups;
  int64_t hw;
  bool single_pass;
  int ctas;  // the cluster's size, or the split count
  int64_t chunk, piece;
  int smem;
  float eps;
  int act;
  bool vec;
  cudaStream_t stream;
};

// Allow `smem` bytes of dynamic shared memory and, for R > 8, the
// non-portable cluster size; remembered per device, so that later calls skip
// cudaFuncSetAttribute once a size has been allowed.
template <typename Kernel>
cudaError_t allow(Kernel kernel, int device, int smem, int ctas, int* allowed_smem, bool* wide) {
  const bool known = device >= 0 && device < kMaxDevices;
  cudaError_t err = cudaSuccess;
  if (!known || smem > allowed_smem[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (known) allowed_smem[device] = smem;
  }
  if (ctas > 8 && (!known || !wide[device])) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    if (known) wide[device] = true;
  }
  return cudaSuccess;
}

template <typename T, typename W, bool kVec>
cudaError_t prepare_cluster(const Args& a) {
  static int allowed_smem[kMaxDevices] = {};
  static bool wide[kMaxDevices] = {};
  return allow(gn_cluster<T, W, kVec>, a.device, a.smem, a.ctas, allowed_smem, wide);
}

cudaLaunchConfig_t cluster_config(const Args& a, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.ctas, a.n * a.groups);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = a.smem;
  cfg.stream = a.stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = a.ctas;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, typename W, bool kVec>
cudaError_t launch_cluster(const Args& a) {
  cudaError_t err = prepare_cluster<T, W, kVec>(a);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(a, &attr);
  const int64_t per_channel = kVec ? a.hw / Vec<T>::kN : a.hw;
  err = cudaLaunchKernelEx(
      &cfg, gn_cluster<T, W, kVec>, static_cast<const T*>(a.x), static_cast<const W*>(a.weight),
      static_cast<const W*>(a.bias), static_cast<const T*>(a.scale),
      static_cast<const T*>(a.shift), static_cast<T*>(a.out), a.channels, a.groups,
      static_cast<int>(a.channels / a.groups * a.hw), static_cast<int>(a.chunk),
      static_cast<int>(a.piece), make_fast_div(static_cast<uint32_t>(per_channel)), a.eps,
      a.act);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, typename W, bool kVec>
cudaError_t launch_split(const Args& a) {
  const dim3 grid(a.ctas, a.n * a.groups);
  const int64_t group_size = static_cast<int64_t>(a.channels / a.groups) * a.hw;
  const T* xt = static_cast<const T*>(a.x);
  gn_stats<T, kVec><<<grid, kThreads, 0, a.stream>>>(xt, a.partials, group_size, a.chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_apply<T, W, kVec><<<grid, kThreads, 0, a.stream>>>(
      xt, static_cast<const W*>(a.weight), static_cast<const W*>(a.bias),
      static_cast<const T*>(a.scale), static_cast<const T*>(a.shift), static_cast<T*>(a.out),
      a.partials, a.channels, a.groups, a.hw, a.chunk, a.eps, a.act);
  return cudaGetLastError();
}

template <typename T, typename W>
cudaError_t launch(const Args& a) {
  if (a.single_pass) return a.vec ? launch_cluster<T, W, true>(a) : launch_cluster<T, W, false>(a);
  return a.vec ? launch_split<T, W, true>(a) : launch_split<T, W, false>(a);
}

template <typename T, typename W, bool kVec>
cudaError_t max_clusters(const Args& a, int* count) {
  cudaError_t err = prepare_cluster<T, W, kVec>(a);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(a, &attr);
  return cudaOccupancyMaxActiveClusters(count, gn_cluster<T, W, kVec>, &cfg);
}

template <typename T, typename W>
cudaError_t query(const Args& a, int* count) {
  return a.vec ? max_clusters<T, W, true>(a, count) : max_clusters<T, W, false>(a, count);
}

}  // namespace

// x, out: (N, C, hw) contiguous, f32 or bf16 (x_bf16); weight, bias: (C,) f32
// or bf16 (w_bf16); scale, shift: (N, C) in x's dtype, or null for no FiLM.
// single_pass: gn_cluster with a cluster of `ctas` CTAs per group, CTA r
// holding elements [r*chunk, min((r+1)*chunk, C/groups*hw)) in `smem` bytes of
// dynamic shared memory, copied in pieces of `piece` elements (at most 8);
// otherwise gn_stats + gn_apply with `ctas` splits of `chunk` elements and
// partials an f32 scratch of 2 * N * groups * ctas. With vec set, chunk, piece
// and hw are multiples of the 16-byte vector width and the pointers 16-byte
// aligned. Returns the CUDA error of the launch (0 on success).
extern "C" int fmdm_group_norm_act(int device, const void* x, const void* weight,
                                   const void* bias, const void* scale, const void* shift,
                                   void* out, void* partials, int n, int channels, int groups,
                                   long long hw, int single_pass, int ctas, long long chunk,
                                   long long piece, int smem, float eps, int act, int x_bf16,
                                   int w_bf16, int vec, void* stream) {
  if (ctas < 1 || (single_pass && (ctas > kMaxCluster || (vec && piece < 1) ||
                                   (vec && (chunk + piece - 1) / piece > kMaxPieces)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{x, weight, bias, scale, shift, out, static_cast<float*>(partials), device, n,
               channels, groups, hw, single_pass != 0, ctas, chunk, piece, smem, eps, act,
               vec != 0, static_cast<cudaStream_t>(stream)};
  if (x_bf16) {
    err = w_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(a) : launch<__nv_bfloat16, float>(a);
  } else {
    err = w_bf16 ? launch<float, __nv_bfloat16>(a) : launch<float, float>(a);
  }
  return static_cast<int>(err);
}

// How many clusters of `ctas` CTAs with `smem` bytes each the card can hold
// at once (cudaOccupancyMaxActiveClusters) into *count; 0 means that cluster
// does not schedule. Returns the CUDA error (0 on success).
extern "C" int fmdm_group_norm_max_clusters(int device, int ctas, int smem, int x_bf16,
                                            int w_bf16, int vec, int* count) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a{};
  a.device = device;
  a.n = 1;
  a.groups = 1;
  a.ctas = ctas;
  a.smem = smem;
  a.vec = vec != 0;
  if (x_bf16) {
    err = w_bf16 ? query<__nv_bfloat16, __nv_bfloat16>(a, count)
                 : query<__nv_bfloat16, float>(a, count);
  } else {
    err = w_bf16 ? query<float, __nv_bfloat16>(a, count) : query<float, float>(a, count);
  }
  return static_cast<int>(err);
}

extern "C" const char* fmdm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
