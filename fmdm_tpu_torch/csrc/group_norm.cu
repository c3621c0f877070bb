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

// ===========================================================================
// K1's backward: dx, dweight, dbias and, with FiLM, dscale and dshift.
//
// Replaces no TPU kernel: the JAX package's _fused_bwd (group_norm.py:141)
// recomputes the XLA reference's VJP, as the port's plain backward
// (group_norm_act_backward_reference) recomputes the plain forward under
// autograd. Per (sample n, group g), in f32, with xhat = (x - mean) * rstd,
// z = (xhat * w + b) * a + t (a = 1 + scale; a = 1, t = 0 without FiLM) and
// y = SiLU(z) (y = z without act):
//   dz = dy * SiLU'(z)
//   A[n,c] = sum dz, B[n,c] = sum dz * xhat, over the channel's extent
//   S1 = sum_c a w A, S2 = sum_c a w B, over the group's channels
//   dx = rstd * (a w dz - S1 / M - xhat * S2 / M), M the group's size
//   dshift = A, dscale = w B + b A, dweight = sum_n a B, dbias = sum_n a A
//
// What bounds it: bytes. The least traffic is x and dy read once and dx
// written once (1.5x the forward's), with ~35 f32 operations and four
// special-function calls per element besides.
//
// Design, after gn_cluster:
//   gn_bwd_cluster, the single pass: one cluster of R CTAs per (sample,
//     group). CTA r bulk-copies its chunk of x into shared memory once and
//     sums it as it lands: the statistics are recomputed, so the forward
//     saves nothing. The R partials are combined through distributed shared
//     memory in rank order. dy is read from device memory in both passes
//     that need it, the second time mostly from L2: holding dy as well would
//     halve the CTAs an SM holds, and measured slower on an H100. Each warp
//     takes items, pieces of at most `item` elements of one channel, and
//     sums dz and dz * xhat over them; a channel's items are added in order
//     into its slot, the slots in order into the CTA's (S1, S2) partial, and
//     after a cluster barrier every CTA adds the R partials in rank order.
//     The CTA that holds a channel's first element adds that channel's slots
//     across the cluster and writes its (A, B). dx is computed from x in
//     shared memory and written once.
//   gn_bwd_moments + gn_bwd_sums + gn_bwd_dx, the split (groups no cluster
//     holds): the statistics, the sums and dx in three grids over the same
//     chunks, through an f32 scratch; x is read three times and dy twice.
//   gn_bwd_params, after either: dweight and dbias summed over the samples in
//     order, dscale and dshift, from (A, B) per (sample, channel).
// No float atomics: every sum has a fixed order, so two calls on the same
// inputs give the same bits.
// ===========================================================================

namespace {

// dz of one element, and its xhat
__device__ __forceinline__ float grad_z(float v, float dy, float mean, float rstd,
                                        const Channel& ch, bool film, bool act, float& xhat) {
  xhat = (v - mean) * rstd;
  if (!act) return dy;
  float z = xhat * ch.w + ch.b;
  if (film) z = z * ch.scale1 + ch.shift;
  const float s = __fdividef(1.f, 1.f + __expf(-z));  // 0 where exp(-z) overflows
  return dy * (s * (1.f + z * (1.f - s)));
}

// Where a chunk [begin, end) of a group lies among the group's channels (hw
// elements each) and items (per_channel items of at most `item` elements to
// a channel, the last one ragged); an empty chunk meets none. A group has
// fewer than 2^31 elements.
struct ChunkMap {
  int begin, end, hw, item, per_channel;
  int c_first, c_last;  // channels met
  int j_first, j_last;  // items met
};

__device__ __forceinline__ ChunkMap chunk_map(int begin, int end, int hw, int item) {
  ChunkMap m{begin, end, hw, item, (hw + item - 1) / item, 0, -1, 0, -1};
  if (end > begin) {
    m.c_first = begin / hw;
    m.c_last = (end - 1) / hw;
    m.j_first = m.c_first * m.per_channel + (begin % hw) / item;
    m.j_last = m.c_last * m.per_channel + ((end - 1) % hw) / item;
  }
  return m;
}

// The layout of dynamic shared memory: x's chunk (`held` bytes, 0 in the
// split), then the item pairs, the slot pairs and the slots' channel
// coefficients.
struct BwdSmem {
  unsigned char* xs;
  float2* items;
  float2* slots;
  Channel* chs;
};

__device__ __forceinline__ BwdSmem bwd_smem(unsigned char* smem, int held, int items,
                                             int slots) {
  BwdSmem s;
  s.xs = smem;
  s.items = reinterpret_cast<float2*>(smem + held);
  s.slots = s.items + (items + 1) / 2 * 2;
  s.chs = reinterpret_cast<Channel*>(s.slots + (slots + 1) / 2 * 2);
  return s;
}

template <typename T, typename W>
__device__ __forceinline__ void load_channels(const ChunkMap& m, const W* weight, const W* bias,
                                              const T* scale, const T* shift, int c0,
                                              int64_t nc0, Channel* chs) {
  for (int s = threadIdx.x; s <= m.c_last - m.c_first; s += kThreads) {
    const int cl = m.c_first + s;
    chs[s] = channel(weight, bias, scale, shift, c0 + cl, nc0 + cl);
  }
}

// Each warp sums dz and dz * xhat over items j_first + warp, + kWarps, ...;
// its lanes stride over the item's elements (16-byte vectors with kVec),
// then the warp's butterfly, and lane 0 stores the pair at
// items[j - j_first]. xs and dys point at the chunk's first element of x
// and dy (shared or device memory).
template <typename T, bool kVec>
__device__ __forceinline__ void item_sums(const T* __restrict__ xs, const T* __restrict__ dys,
                                          const ChunkMap& m, const Channel* __restrict__ chs,
                                          float mean, float rstd, bool film, bool act,
                                          float2* __restrict__ items) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = m.j_first + warp; j <= m.j_last; j += kWarps) {
    const int cl = j / m.per_channel, k = j % m.per_channel;
    const int lo = max(cl * m.hw + k * m.item, m.begin) - m.begin;
    const int hi = min(min(cl * m.hw + (k + 1) * m.item, (cl + 1) * m.hw), m.end) - m.begin;
    const Channel ch = chs[cl - m.c_first];
    float a = 0.f, b = 0.f;
    if (kVec) {
      constexpr int N = Vec<T>::kN;
      const uint4* xv = reinterpret_cast<const uint4*>(xs);
      const uint4* gv = reinterpret_cast<const uint4*>(dys);
      // lane l takes vectors l, l+32, ...: kLaneVectors at a time, their
      // loads issued together
      constexpr int kLaneVectors = 2;
      for (int base = lo / N + lane; base < hi / N; base += 32 * kLaneVectors) {
        uint4 rx[kLaneVectors], rg[kLaneVectors];
#pragma unroll
        for (int r = 0; r < kLaneVectors; ++r) {
          if (base + 32 * r < hi / N) {
            rx[r] = xv[base + 32 * r];
            rg[r] = gv[base + 32 * r];
          }
        }
#pragma unroll
        for (int r = 0; r < kLaneVectors; ++r) {
          if (base + 32 * r < hi / N) {
            float f[N], g[N];
            Vec<T>::load(rx[r], f);
            Vec<T>::load(rg[r], g);
#pragma unroll
            for (int e = 0; e < N; ++e) {
              float xh;
              const float d = grad_z(f[e], g[e], mean, rstd, ch, film, act, xh);
              a += d;
              b += d * xh;
            }
          }
        }
      }
    } else {
      for (int i = lo + lane; i < hi; i += 32) {
        float xh;
        const float d = grad_z(fmdm::to_float(xs[i]), fmdm::to_float(dys[i]), mean, rstd, ch,
                               film, act, xh);
        a += d;
        b += d * xh;
      }
    }
    a = fmdm::warp_sum(a);
    b = fmdm::warp_sum(b);
    if (lane == 0) items[j - m.j_first] = make_float2(a, b);
  }
}

// Slot s (channel c_first + s) adds its items in order; then thread 0 adds
// the slots, weighted by a w, in order into the chunk's (S1, S2) partial.
// The items are complete (a barrier since item_sums).
__device__ __forceinline__ void slot_sums(const ChunkMap& m, const float2* items,
                                          const Channel* chs, float2* slots, float2* partial) {
  for (int s = threadIdx.x; s <= m.c_last - m.c_first; s += kThreads) {
    const int cl = m.c_first + s;
    const int j0 = max(m.j_first, cl * m.per_channel);
    const int j1 = min(m.j_last, cl * m.per_channel + m.per_channel - 1);
    float a = 0.f, b = 0.f;
    for (int j = j0; j <= j1; ++j) {
      a += items[j - m.j_first].x;
      b += items[j - m.j_first].y;
    }
    slots[s] = make_float2(a, b);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s1 = 0.f, s2 = 0.f;
    for (int s = 0; s <= m.c_last - m.c_first; ++s) {
      const float aw = chs[s].scale1 * chs[s].w;
      s1 += aw * slots[s].x;
      s2 += aw * slots[s].y;
    }
    *partial = make_float2(s1, s2);
  }
}

// The channels whose first element lies in chunk `rank`: each adds its slots
// across the chunks that meet it, in order (slots_of(q): chunk q's slots),
// and writes (A, B) to sums[2 * (nc0 + c)].
template <typename SlotsOf>
__device__ __forceinline__ void owner_sums(const ChunkMap& m, int rank, int chunk,
                                           SlotsOf slots_of, float* sums, int64_t nc0) {
  for (int cl = (m.begin + m.hw - 1) / m.hw + threadIdx.x; cl <= m.c_last; cl += kThreads) {
    const int q_last = ((cl + 1) * m.hw - 1) / chunk;
    float a = 0.f, b = 0.f;
    for (int q = rank; q <= q_last; ++q) {
      const float2 v = slots_of(q)[cl - q * chunk / m.hw];
      a += v.x;
      b += v.y;
    }
    sums[2 * (nc0 + cl)] = a;
    sums[2 * (nc0 + cl) + 1] = b;
  }
}

// dx over the chunk: dx = rstd * (a w dz - m1 - xhat * m2), m1 = S1 / M,
// m2 = S2 / M; per_channel divides the element's (vector's) index within
// the group by hw (hw / N).
template <typename T, bool kVec>
__device__ __forceinline__ void write_dx(const T* __restrict__ xs, const T* __restrict__ dys,
                                         T* __restrict__ dx, const ChunkMap& m,
                                         FastDiv per_channel, const Channel* __restrict__ chs,
                                         float mean, float rstd, float m1, float m2, bool film,
                                         bool act) {
  const int len = m.end - m.begin;
  if (kVec) {
    constexpr int N = Vec<T>::kN;
    const uint4* xv = reinterpret_cast<const uint4*>(xs);
    const uint4* gv = reinterpret_cast<const uint4*>(dys);
    uint4* dst = reinterpret_cast<uint4*>(dx);
    const int v0 = m.begin / N;
    for (int i = threadIdx.x; i < len / N; i += kThreads) {
      const Channel ch = chs[per_channel(static_cast<uint32_t>(v0 + i)) - m.c_first];
      const float aw = ch.scale1 * ch.w;
      float f[N], g[N];
      Vec<T>::load(xv[i], f);
      Vec<T>::load(gv[i], g);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        float xh;
        const float d = grad_z(f[e], g[e], mean, rstd, ch, film, act, xh);
        f[e] = rstd * (aw * d - m1 - xh * m2);
      }
      dst[i] = Vec<T>::store(f);
    }
  } else {
    for (int i = threadIdx.x; i < len; i += kThreads) {
      const Channel ch = chs[per_channel(static_cast<uint32_t>(m.begin + i)) - m.c_first];
      float xh;
      const float d = grad_z(fmdm::to_float(xs[i]), fmdm::to_float(dys[i]), mean, rstd, ch, film,
                             act, xh);
      dx[i] = fmdm::from_float<T>(rstd * (ch.scale1 * ch.w * d - m1 - xh * m2));
    }
  }
}

// Warp 0 adds `count` pairs, pair(r) for r in [0, count), in rank order (one
// per lane, then the lanes in order; count <= 32); thread 0 hands the sums
// to `finish`.
template <typename Pair, typename Finish>
__device__ __forceinline__ void rank_order_sum(int count, Pair pair, Finish finish) {
  if (threadIdx.x < 32) {
    float2 mine = make_float2(0.f, 0.f);
    if (static_cast<int>(threadIdx.x) < count) mine = pair(threadIdx.x);
    float a = 0.f, b = 0.f;
    for (int r = 0; r < count; ++r) {
      a += __shfl_sync(0xffffffffu, mine.x, r);
      b += __shfl_sync(0xffffffffu, mine.y, r);
    }
    if (threadIdx.x == 0) finish(a, b);
  }
}

// grid (R, N*G), cluster (R, 1, 1): CTA r holds elements [r*chunk,
// min((r+1)*chunk, group_size)) of x of group y in shared memory. As
// gn_cluster: with kVec, chunk and piece are multiples of the 16-byte
// vector, and x, dy, dx 16-byte aligned. Writes dx and (A, B) per (sample,
// channel) into sums.
template <typename T, typename W, bool kVec>
__global__ void __launch_bounds__(kThreads)
    gn_bwd_cluster(const T* __restrict__ x, const T* __restrict__ dy, const W* __restrict__ weight,
                   const W* __restrict__ bias, const T* __restrict__ scale,
                   const T* __restrict__ shift, T* __restrict__ dx, float* __restrict__ sums,
                   int channels, int groups, int hw, int group_size, int chunk, int piece,
                   int item, int items, int slots, FastDiv per_channel, float eps, int act) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[kMaxPieces];
  __shared__ float2 partial, s_partial;
  __shared__ float s_mean, s_rstd, s_m1, s_m2;

  const int ctas = gridDim.x, rank = blockIdx.x;
  const int begin = rank * chunk;
  const int len = max(0, min(chunk, group_size - begin));
  const int64_t grp = blockIdx.y;
  const int64_t offset = grp * group_size + begin;
  const int held = (chunk * static_cast<int>(sizeof(T)) + 15) / 16 * 16;
  const BwdSmem sm = bwd_smem(smem, held, items, slots);
  T* xs = reinterpret_cast<T*>(sm.xs);
  const T* gs = dy + offset;

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
        bulk_load(smem_addr(xs + start), x + offset + start, bytes, bar0 + 8 * p);
      }
    }
    __syncthreads();  // the mbarriers are initialized before anyone waits on them
    const uint4* v = reinterpret_cast<const uint4*>(xs);
    for (int p = 0; p < pieces; ++p) {
      mbar_wait(bar0 + 8 * p, 0);
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
      xs[i] = e;
      const float f = fmdm::to_float(e);
      s1 += f;
      s2 += f * f;
    }
  }
  block_sum2(s1, s2);
  if (threadIdx.x == 0) partial = make_float2(s1, s2);

  const ChunkMap m = chunk_map(begin, begin + len, hw, item);
  const int n = static_cast<int>(grp / groups);
  const int c0 = static_cast<int>(grp % groups) * (channels / groups);
  const int64_t nc0 = static_cast<int64_t>(n) * channels + c0;
  load_channels(m, weight, bias, scale, shift, c0, nc0, sm.chs);

  cg::cluster_group cluster = cg::this_cluster();
  if (ctas > 1) {
    cluster.sync();  // every CTA's statistics partials are written
  } else {
    __syncthreads();
  }
  rank_order_sum(
      ctas,
      [&](int r) { return ctas > 1 ? *cluster.map_shared_rank(&partial, r) : partial; },
      [&](float a, float b) {
        moments(a, b, static_cast<float>(group_size), eps, s_mean, s_rstd);
      });
  __syncthreads();

  const float mean = s_mean, rstd = s_rstd;
  const bool film = scale != nullptr, silu = act != 0;
  item_sums<T, kVec>(xs, gs, m, sm.chs, mean, rstd, film, silu, sm.items);
  __syncthreads();
  slot_sums(m, sm.items, sm.chs, sm.slots, &s_partial);
  if (ctas > 1) {
    cluster.sync();  // every CTA's slots and (S1, S2) partial are written
  } else {
    __syncthreads();
  }
  const float size = static_cast<float>(group_size);
  rank_order_sum(
      ctas,
      [&](int r) { return ctas > 1 ? *cluster.map_shared_rank(&s_partial, r) : s_partial; },
      [&](float a, float b) {
        s_m1 = a / size;
        s_m2 = b / size;
      });
  owner_sums(
      m, rank, chunk,
      [&](int q) { return ctas > 1 ? cluster.map_shared_rank(sm.slots, q) : sm.slots; }, sums,
      nc0);
  __syncthreads();
  if (ctas > 1) cluster_arrive();  // this CTA is done reading its peers

  write_dx<T, kVec>(xs, gs, dx + offset, m, per_channel, sm.chs, mean, rstd, s_m1, s_m2, film,
                    silu);
  if (ctas > 1) cluster_wait();  // no CTA leaves while a peer may still read its slots
}

// ---- the split: groups larger than any cluster holds ----

// Per (split, group): (sum, sum of squares) of x's chunk into moments, as
// gn_stats.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    gn_bwd_moments(const T* __restrict__ x, float* __restrict__ moments_out, int group_size,
                   int chunk) {
  const int split = blockIdx.x;
  const int splits = gridDim.x;
  const int64_t grp = blockIdx.y;
  const T* base = x + grp * group_size;
  const int begin = split * chunk;
  const int end = min(begin + chunk, group_size);
  float s1 = 0.f, s2 = 0.f;
  if (kVec) {
    constexpr int N = Vec<T>::kN;
    const uint4* p = reinterpret_cast<const uint4*>(base + begin);
    const int nvec = end > begin ? (end - begin) / N : 0;
    for (int i = threadIdx.x; i < nvec; i += kThreads) {
      float f[N];
      Vec<T>::load(__ldg(p + i), f);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        s1 += f[j];
        s2 += f[j] * f[j];
      }
    }
  } else {
    for (int i = begin + threadIdx.x; i < end; i += kThreads) {
      const float f = fmdm::to_float(base[i]);
      s1 += f;
      s2 += f * f;
    }
  }
  block_sum2(s1, s2);
  if (threadIdx.x == 0) {
    moments_out[2 * (grp * splits + split)] = s1;
    moments_out[2 * (grp * splits + split) + 1] = s2;
  }
}

// Warp 0 adds the group's `splits` pairs (warp-strided, then the butterfly:
// the same order in every block) and hands the sums to `finish`.
template <typename Finish>
__device__ __forceinline__ void split_sum(const float* pairs, int64_t grp, int splits,
                                          Finish finish) {
  if (threadIdx.x < 32) {
    float a = 0.f, b = 0.f;
    for (int i = threadIdx.x; i < splits; i += 32) {
      a += pairs[2 * (grp * splits + i)];
      b += pairs[2 * (grp * splits + i) + 1];
    }
    a = fmdm::warp_sum(a);
    b = fmdm::warp_sum(b);
    if (threadIdx.x == 0) finish(a, b);
  }
}

// Per (split, group): the chunk's items, slots (into chan, `slots` pairs per
// chunk) and (S1, S2) partial (into spart), read from device memory.
template <typename T, typename W, bool kVec>
__global__ void __launch_bounds__(kThreads)
    gn_bwd_sums(const T* __restrict__ x, const T* __restrict__ dy, const W* __restrict__ weight,
                const W* __restrict__ bias, const T* __restrict__ scale,
                const T* __restrict__ shift, const float* __restrict__ moments_in,
                float* __restrict__ spart, float2* __restrict__ chan, int channels, int groups,
                int hw, int chunk, int item, int items, int slots, float eps, int act) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float s_mean, s_rstd;
  __shared__ float2 s_partial;
  const int split = blockIdx.x, splits = gridDim.x;
  const int64_t grp = blockIdx.y;
  const int cg = channels / groups;
  const int group_size = cg * hw;
  const BwdSmem sm = bwd_smem(smem, 0, items, slots);
  const int begin = split * chunk;
  const ChunkMap m = chunk_map(begin, min(begin + chunk, group_size), hw, item);
  const int n = static_cast<int>(grp / groups);
  const int c0 = static_cast<int>(grp % groups) * cg;
  const int64_t nc0 = static_cast<int64_t>(n) * channels + c0;
  load_channels(m, weight, bias, scale, shift, c0, nc0, sm.chs);
  split_sum(moments_in, grp, splits, [&](float a, float b) {
    moments(a, b, static_cast<float>(group_size), eps, s_mean, s_rstd);
  });
  __syncthreads();
  const int64_t offset = grp * group_size + begin;
  item_sums<T, kVec>(x + offset, dy + offset, m, sm.chs, s_mean, s_rstd, scale != nullptr,
                     act != 0, sm.items);
  __syncthreads();
  float2* mine = chan + (grp * splits + split) * slots;
  slot_sums(m, sm.items, sm.chs, mine, &s_partial);
  if (threadIdx.x == 0) {
    spart[2 * (grp * splits + split)] = s_partial.x;
    spart[2 * (grp * splits + split) + 1] = s_partial.y;
  }
}

// Per (split, group): the owned channels' (A, B) into sums, then dx.
template <typename T, typename W, bool kVec>
__global__ void __launch_bounds__(kThreads)
    gn_bwd_dx(const T* __restrict__ x, const T* __restrict__ dy, const W* __restrict__ weight,
              const W* __restrict__ bias, const T* __restrict__ scale,
              const T* __restrict__ shift, T* __restrict__ dx,
              const float* __restrict__ moments_in, const float* __restrict__ spart,
              const float2* __restrict__ chan, float* __restrict__ sums, int channels,
              int groups, int hw, int chunk, int item, int slots,
              FastDiv per_channel, float eps, int act) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float s_mean, s_rstd, s_m1, s_m2;
  const int split = blockIdx.x, splits = gridDim.x;
  const int64_t grp = blockIdx.y;
  const int cg = channels / groups;
  const int group_size = cg * hw;
  const BwdSmem sm = bwd_smem(smem, 0, 0, slots);
  const int begin = split * chunk;
  const ChunkMap m = chunk_map(begin, min(begin + chunk, group_size), hw, item);
  const int n = static_cast<int>(grp / groups);
  const int c0 = static_cast<int>(grp % groups) * cg;
  const int64_t nc0 = static_cast<int64_t>(n) * channels + c0;
  load_channels(m, weight, bias, scale, shift, c0, nc0, sm.chs);
  const float size = static_cast<float>(group_size);
  split_sum(moments_in, grp, splits,
            [&](float a, float b) { moments(a, b, size, eps, s_mean, s_rstd); });
  split_sum(spart, grp, splits, [&](float a, float b) {
    s_m1 = a / size;
    s_m2 = b / size;
  });
  owner_sums(
      m, split, chunk, [&](int q) { return chan + (grp * splits + q) * slots; }, sums, nc0);
  __syncthreads();
  const int64_t offset = grp * group_size + begin;
  write_dx<T, kVec>(x + offset, dy + offset, dx + offset, m, per_channel, sm.chs, s_mean, s_rstd,
                    s_m1, s_m2, scale != nullptr, act != 0);
}

// ---- the parameters' gradients ----

// One thread per channel: dweight, dbias over the samples in order; with
// FiLM, dscale and dshift per (sample, channel).
template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
    gn_bwd_params(const float* __restrict__ sums, const W* __restrict__ weight,
                  const W* __restrict__ bias, const T* __restrict__ scale, W* __restrict__ dweight,
                  W* __restrict__ dbias, T* __restrict__ dscale, T* __restrict__ dshift, int n,
                  int channels) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= channels) return;
  const float w = fmdm::to_float(weight[c]), b = fmdm::to_float(bias[c]);
  float gw = 0.f, gb = 0.f;
  for (int i = 0; i < n; ++i) {
    const int64_t nc = static_cast<int64_t>(i) * channels + c;
    const float a_sum = sums[2 * nc], b_sum = sums[2 * nc + 1];
    float a = 1.f;
    if (scale != nullptr) {
      a = 1.f + fmdm::to_float(scale[nc]);
      dscale[nc] = fmdm::from_float<T>(w * b_sum + b * a_sum);
      dshift[nc] = fmdm::from_float<T>(a_sum);
    }
    gw += a * b_sum;
    gb += a * a_sum;
  }
  dweight[c] = fmdm::from_float<W>(gw);
  dbias[c] = fmdm::from_float<W>(gb);
}

// ---- host side ----

struct BwdArgs {
  const void *x, *dy, *weight, *bias, *scale, *shift;
  void *dx, *dweight, *dbias, *dscale, *dshift;
  float* scratch;
  int device, n, channels, groups;
  int64_t hw;
  bool single_pass;
  int ctas;  // the cluster's size, or the split count
  int64_t chunk, piece, item;
  int items, slots, smem;
  float eps;
  int act;
  bool vec;
  cudaStream_t stream;
};

// The bytes bwd_smem lays out in the split (no chunk held).
int bwd_smem_bytes(int items, int slots) {
  return (items + 1) / 2 * 16 + (slots + 1) / 2 * 16 + slots * static_cast<int>(sizeof(Channel));
}

template <typename T, typename W, bool kVec>
cudaError_t prepare_bwd_cluster(const BwdArgs& a) {
  static int allowed_smem[kMaxDevices] = {};
  static bool wide[kMaxDevices] = {};
  return allow(gn_bwd_cluster<T, W, kVec>, a.device, a.smem, a.ctas, allowed_smem, wide);
}

cudaLaunchConfig_t bwd_cluster_config(const BwdArgs& a, cudaLaunchAttribute* attr) {
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

template <typename T, bool kVec>
FastDiv bwd_per_channel(const BwdArgs& a) {
  return make_fast_div(static_cast<uint32_t>(kVec ? a.hw / Vec<T>::kN : a.hw));
}

template <typename T, typename W, bool kVec>
cudaError_t launch_bwd_cluster(const BwdArgs& a) {
  cudaError_t err = prepare_bwd_cluster<T, W, kVec>(a);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = bwd_cluster_config(a, &attr);
  err = cudaLaunchKernelEx(
      &cfg, gn_bwd_cluster<T, W, kVec>, static_cast<const T*>(a.x), static_cast<const T*>(a.dy),
      static_cast<const W*>(a.weight), static_cast<const W*>(a.bias),
      static_cast<const T*>(a.scale), static_cast<const T*>(a.shift), static_cast<T*>(a.dx),
      a.scratch, a.channels, a.groups, static_cast<int>(a.hw),
      static_cast<int>(a.channels / a.groups * a.hw), static_cast<int>(a.chunk),
      static_cast<int>(a.piece), static_cast<int>(a.item), a.items, a.slots,
      bwd_per_channel<T, kVec>(a), a.eps, a.act);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, typename W, bool kVec>
cudaError_t launch_bwd_split(const BwdArgs& a) {
  static int allowed_sums[kMaxDevices] = {};
  static int allowed_dx[kMaxDevices] = {};
  static bool wide_sums[kMaxDevices] = {};
  static bool wide_dx[kMaxDevices] = {};
  const dim3 grid(a.ctas, a.n * a.groups);
  const int group_size = static_cast<int>(a.channels / a.groups * a.hw);
  const int64_t pairs = 2 * static_cast<int64_t>(a.n) * a.groups * a.ctas;
  float* moments_buf = a.scratch + 2 * static_cast<int64_t>(a.n) * a.channels;
  float* spart = moments_buf + pairs;
  float2* chan = reinterpret_cast<float2*>(spart + pairs);
  const int smem_dx = bwd_smem_bytes(0, a.slots);
  cudaError_t err = allow(gn_bwd_sums<T, W, kVec>, a.device, a.smem, 1, allowed_sums, wide_sums);
  if (err != cudaSuccess) return err;
  err = allow(gn_bwd_dx<T, W, kVec>, a.device, smem_dx, 1, allowed_dx, wide_dx);
  if (err != cudaSuccess) return err;
  const T* xt = static_cast<const T*>(a.x);
  const T* gt = static_cast<const T*>(a.dy);
  const W* wt = static_cast<const W*>(a.weight);
  const W* bt = static_cast<const W*>(a.bias);
  const T* st = static_cast<const T*>(a.scale);
  const T* ht = static_cast<const T*>(a.shift);
  gn_bwd_moments<T, kVec><<<grid, kThreads, 0, a.stream>>>(xt, moments_buf, group_size,
                                                            static_cast<int>(a.chunk));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_bwd_sums<T, W, kVec><<<grid, kThreads, a.smem, a.stream>>>(
      xt, gt, wt, bt, st, ht, moments_buf, spart, chan, a.channels, a.groups,
      static_cast<int>(a.hw), static_cast<int>(a.chunk), static_cast<int>(a.item), a.items,
      a.slots, a.eps, a.act);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_bwd_dx<T, W, kVec><<<grid, kThreads, smem_dx, a.stream>>>(
      xt, gt, wt, bt, st, ht, static_cast<T*>(a.dx), moments_buf, spart, chan, a.scratch,
      a.channels, a.groups, static_cast<int>(a.hw), static_cast<int>(a.chunk),
      static_cast<int>(a.item), a.slots, bwd_per_channel<T, kVec>(a), a.eps, a.act);
  return cudaGetLastError();
}

template <typename T, typename W>
cudaError_t launch_bwd(const BwdArgs& a) {
  cudaError_t err;
  if (a.single_pass) {
    err = a.vec ? launch_bwd_cluster<T, W, true>(a) : launch_bwd_cluster<T, W, false>(a);
  } else {
    err = a.vec ? launch_bwd_split<T, W, true>(a) : launch_bwd_split<T, W, false>(a);
  }
  if (err != cudaSuccess) return err;
  gn_bwd_params<T, W><<<(a.channels + kThreads - 1) / kThreads, kThreads, 0, a.stream>>>(
      a.scratch, static_cast<const W*>(a.weight), static_cast<const W*>(a.bias),
      static_cast<const T*>(a.scale), static_cast<W*>(a.dweight), static_cast<W*>(a.dbias),
      static_cast<T*>(a.dscale), static_cast<T*>(a.dshift), a.n, a.channels);
  return cudaGetLastError();
}

template <typename T, typename W, bool kVec>
cudaError_t max_bwd_clusters(const BwdArgs& a, int* count) {
  cudaError_t err = prepare_bwd_cluster<T, W, kVec>(a);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = bwd_cluster_config(a, &attr);
  return cudaOccupancyMaxActiveClusters(count, gn_bwd_cluster<T, W, kVec>, &cfg);
}

template <typename T, typename W>
cudaError_t query_bwd(const BwdArgs& a, int* count) {
  return a.vec ? max_bwd_clusters<T, W, true>(a, count) : max_bwd_clusters<T, W, false>(a, count);
}

}  // namespace

// K1's backward. x, dy, dx: (N, C, hw) contiguous, f32 or bf16 (x_bf16);
// weight, bias, dweight, dbias: (C,) f32 or bf16 (w_bf16); scale, shift,
// dscale, dshift: (N, C) in x's dtype, or null for no FiLM. scratch: f32,
// 2 * N * C for (A, B) per (sample, channel), and for the split 4 * N *
// groups * ctas + 2 * N * groups * ctas * slots more. single_pass:
// gn_bwd_cluster with a cluster of `ctas` CTAs per group holding `chunk`
// elements each of x in `smem` bytes of dynamic shared memory, copied in
// pieces of `piece` elements (at most 8); otherwise the split's three
// grids of `ctas` chunks (`smem`: gn_bwd_sums' dynamic shared memory). A
// chunk meets at most `items` items of `item` elements and `slots` channels.
// With vec set, chunk, piece, item and hw are multiples of the 16-byte
// vector width and the pointers 16-byte aligned. gn_bwd_params follows.
// Returns the CUDA error of the launches (0 on success).
extern "C" int fmdm_group_norm_act_backward(
    int device, const void* x, const void* dy, const void* weight, const void* bias,
    const void* scale, const void* shift, void* dx, void* dweight, void* dbias, void* dscale,
    void* dshift, void* scratch, int n, int channels, int groups, long long hw, int single_pass,
    int ctas, long long chunk, long long piece, long long item, int items, int slots, int smem,
    float eps, int act, int x_bf16, int w_bf16, int vec, void* stream) {
  const bool bad_pass = ctas > kMaxCluster || (vec && piece < 1) ||
                        (vec && (chunk + piece - 1) / piece > kMaxPieces);
  if (ctas < 1 || item < 1 || (single_pass && bad_pass)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const BwdArgs a{x, dy, weight, bias, scale, shift, dx, dweight, dbias, dscale, dshift,
                  static_cast<float*>(scratch), device, n, channels, groups, hw,
                  single_pass != 0, ctas, chunk, piece, item, items, slots, smem, eps, act,
                  vec != 0, static_cast<cudaStream_t>(stream)};
  if (x_bf16) {
    err = w_bf16 ? launch_bwd<__nv_bfloat16, __nv_bfloat16>(a)
                 : launch_bwd<__nv_bfloat16, float>(a);
  } else {
    err = w_bf16 ? launch_bwd<float, __nv_bfloat16>(a) : launch_bwd<float, float>(a);
  }
  return static_cast<int>(err);
}

// How many clusters of gn_bwd_cluster with `ctas` CTAs of `smem` bytes each
// the card can hold at once into *count; 0 means that cluster does not
// schedule. Returns the CUDA error (0 on success).
extern "C" int fmdm_group_norm_backward_max_clusters(int device, int ctas, int smem, int x_bf16,
                                                     int w_bf16, int vec, int* count) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  BwdArgs a{};
  a.device = device;
  a.n = 1;
  a.groups = 1;
  a.ctas = ctas;
  a.smem = smem;
  a.vec = vec != 0;
  if (x_bf16) {
    err = w_bf16 ? query_bwd<__nv_bfloat16, __nv_bfloat16>(a, count)
                 : query_bwd<__nv_bfloat16, float>(a, count);
  } else {
    err = w_bf16 ? query_bwd<float, __nv_bfloat16>(a, count) : query_bwd<float, float>(a, count);
  }
  return static_cast<int>(err);
}
