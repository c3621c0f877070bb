// K2: softmax attention at small T for Hopper (sm_90a), on the tensor cores.
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
// q, k, v and o are a few MB and the products 4*T*T*d operations per head,
// both far below the T*T exponentials per head at the SFU's 16 per clock per
// SM: the exponentials bound it in bf16. In f32 the products do (3xTF32).
//
// Design: one warp per 16 query rows of one head, a block of up to 4 warps
// per (head, 64-row tile). K and V come through shared memory in 64-key
// tiles staged by cp.async; when the whole head fits (the flagship's T <= 256
// at d = 8 is 4 KB per operand) every tile keeps its own slot and the head is
// loaded once, else two slots alternate so the next tile's copy overlaps this
// tile's products. d is padded with zeros to D = 8/16/32/64.
//   bf16: S = Q K^T with mma m16n8k8 (d = 8 is one k = 8 step); PV with
//   m16n8k16, whose A fragment is the C fragments of two adjacent 8-key score
//   tiles rounded to bf16 in registers, and whose B fragment comes from V by
//   ldmatrix.trans. P never touches shared memory.
//   f32: both products in 3xTF32 (mma.cuh), so the result stays within f32
//   rounding of the plain version.
// Two passes over K: the first finds the row max, the second recomputes S,
// forms p = exp(s * scale - max) once per score, adds it to l and rounds it
// to V's dtype against the final max, exactly as the TPU kernel does; an
// online softmax would rescale P after rounding and change the result. The
// exponential is the SFU's exp2 of s * scale * log2(e) - max * log2(e), one
// FMA and one SFU instruction where expf and the scaling take about ten; it
// differs from the plain version's p by a few f32 ulps, far inside a bf16
// ulp of P. Keys past T score -inf. Head packing is a device of the TPU's
// matrix unit and is not carried over.

#include <float.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxWarps = 4;        // 16 query rows each
constexpr int kKeyTile = 64;        // keys per shared-memory tile
constexpr int kResidentBytes = 48 * 1024;  // whole K and V of a head up to this

// The bf16 A fragments (m16n8k8) of the 16 rows [row0, row0 + 16) of a
// row-major (rows, d) bf16 matrix, per 8-column chunk; zeros past the rows
// and past d.
template <int D>
__device__ __forceinline__ void load_a_bf16(uint32_t (&a)[D / 8][2], const bf16* __restrict__ src,
                                            int row0, int rows, int d, int g, int t) {
  const bf16 zero = __float2bfloat16(0.f);
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + g + 8 * i, col = 8 * c + 2 * t;
      const bf16* p = src + static_cast<int64_t>(r) * d + col;
      const bf16 lo = (r < rows && col < d) ? p[0] : zero;
      const bf16 hi = (r < rows && col + 1 < d) ? p[1] : zero;
      const __nv_bfloat162 pair = __halves2bfloat162(lo, hi);
      a[c][i] = *reinterpret_cast<const uint32_t*>(&pair);
    }
  }
}

// s[n] (C fragments) = Q K[8n .. 8n + 7]^T over a 64-key bf16 tile, m16n8k8
template <int D, int S>
__device__ __forceinline__ void qk_bf16(float (&s)[8][4], const uint32_t (&a)[D / 8][2],
                                        const bf16* __restrict__ ks, int g, int t) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
  }
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const uint32_t b = *reinterpret_cast<const uint32_t*>(ks + (8 * n + g) * S + 8 * c + 2 * t);
      fmdm::mma_bf16_k8(s[n], a[c], b);
    }
  }
}

// o[n] += round_bf16(P) V[:, 8n .. 8n + 7] over a 64-key bf16 tile, m16n8k16:
// score tiles 2j and 2j + 1 are the A fragment of keys [16j, 16j + 16)
template <int D, int S>
__device__ __forceinline__ void pv_bf16(float (&o)[D / 8][4], const float (&p)[8][4],
                                        const bf16* __restrict__ vs, int lane) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t a[4] = {fmdm::pack_bf16(p[2 * j][0], p[2 * j][1]),
                           fmdm::pack_bf16(p[2 * j][2], p[2 * j][3]),
                           fmdm::pack_bf16(p[2 * j + 1][0], p[2 * j + 1][1]),
                           fmdm::pack_bf16(p[2 * j + 1][2], p[2 * j + 1][3])};
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      uint32_t b[2];
      fmdm::ldmatrix_x2_trans(b, vs + (16 * j + lane % 16) * S + 8 * n);
      fmdm::mma_bf16_k16(o[n], a, b);
    }
  }
}

// The flagship's bf16 d = 8 instantiation is held to 64 registers, so 8
// blocks fit on an SM and the 16² call at batch 8 (2048 blocks) runs in two
// rounds rather than two and a fraction.
template <typename T, int D>
__host__ __device__ constexpr int min_blocks() { return sizeof(T) == 2 && D == 8 ? 8 : 1; }

template <typename T, int D>
__global__ void __launch_bounds__(kMaxWarps * 32, min_blocks<T, D>())
    small_t_attention(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      T* __restrict__ o, int t, int d, float scale, int resident, int aligned) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  constexpr int S = fmdm::smem_stride<T, D>();
  constexpr int kTileElems = kKeyTile * S;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ntiles = (t + kKeyTile - 1) / kKeyTile;
  const int nslots = resident ? ntiles : 2;
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + nslots * kTileElems;

  const int64_t head = static_cast<int64_t>(blockIdx.y) * t * d;
  const T* kh = k + head;
  const T* vh = v + head;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const int row0 = blockIdx.x * (blockDim.x / 2) + 16 * warp;  // 16 rows per 32 threads
  const bool live = row0 < t;                                  // uniform over the warp

  // The sign of the scale goes into Q (exact), so scores * |scale| are the
  // scaled scores and the row max can be taken before scaling.
  using AFrags = typename std::conditional<kBf16, uint32_t[D / 8][2], float[D / 8][4]>::type;
  AFrags qa;
  if constexpr (kBf16) {
    load_a_bf16<D>(qa, q + head, row0, t, d, g, tq);
    if (scale < 0.f) {
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        qa[c][0] ^= 0x80008000u;
        qa[c][1] ^= 0x80008000u;
      }
    }
  } else {
    fmdm::load_a_tf32<T, D>(qa, q + head, row0, t, d, scale < 0.f ? -1.f : 1.f, g, tq);
  }
  // (at least FLT_MIN: a zero scale keeps the -inf of keys past T)
  const float scale_log2 = fmaxf(fabsf(scale) * fmdm::kLog2e, FLT_MIN);

  auto stage = [&](int tile, bool with_v) {
    const int slot = tile % nslots;
    fmdm::stage_rows<T, D, S, kKeyTile>(ks + slot * kTileElems, kh, tile * kKeyTile, t, d, aligned);
    if (with_v)
      fmdm::stage_rows<T, D, S, kKeyTile>(vs + slot * kTileElems, vh, tile * kKeyTile, t, d, aligned);
    fmdm::cp_async_commit();
  };
  // unscaled scores of the 64 keys of `tile`, -inf past T
  auto scores = [&](float (&s)[8][4], int tile) {
    const T* tk = ks + (tile % nslots) * kTileElems;
    if constexpr (kBf16) {
      qk_bf16<D, S>(s, qa, tk, g, tq);
    } else {
      fmdm::qk_3xtf32<T, D, S>(s, qa, tk, g, tq);
    }
    if ((tile + 1) * kKeyTile > t) {  // the last tile is ragged
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (tile * kKeyTile + 8 * n + 2 * tq + (i & 1) >= t) s[n][i] = -INFINITY;
        }
      }
    }
  };

  // pass 1: the row max of the scores (rows g and g + 8 of the warp); a
  // resident head stages V here too, so pass 2 loads nothing
  float m[2] = {-INFINITY, -INFINITY};
  stage(0, resident);
  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) stage(i + 1, resident); else fmdm::cp_async_commit();
    fmdm::cp_async_wait<1>();
    __syncthreads();
    if (live) {
      float s[8][4];
      scores(s, i);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int i2 = 0; i2 < 4; ++i2) m[i2 >> 1] = fmaxf(m[i2 >> 1], s[n][i2]);
      }
    }
    __syncthreads();  // the slot is free for the copy issued next
  }
  // finite: every row sees at least one key; in log2 units of the scaled scores
  m[0] = fmdm::quad_max(m[0]) * scale_log2;
  m[1] = fmdm::quad_max(m[1]) * scale_log2;

  // pass 2: p = exp(s * scale - m), l = sum p (f32), acc = sum round(p) v (f32)
  float l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  }
  if (!resident) stage(0, true);
  for (int i = 0; i < ntiles; ++i) {
    if (!resident) {
      if (i + 1 < ntiles) stage(i + 1, true); else fmdm::cp_async_commit();
      fmdm::cp_async_wait<1>();
      __syncthreads();
    }
    if (live) {
      float s[8][4];
      scores(s, i);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int i2 = 0; i2 < 4; ++i2) {
          s[n][i2] = fmdm::exp2_approx(fmaf(s[n][i2], scale_log2, -m[i2 >> 1]));  // 0 past T
          l[i2 >> 1] += s[n][i2];
        }
      }
      const T* tv = vs + (i % nslots) * kTileElems;
      if constexpr (kBf16) {
        pv_bf16<D, S>(acc, s, tv, lane);
      } else {
        fmdm::pv_3xtf32<T, D, S>(acc, s, tv, g, tq);
      }
    }
    if (!resident) __syncthreads();
  }

  if (!live) return;
  l[0] = fmdm::quad_sum(l[0]);
  l[1] = fmdm::quad_sum(l[1]);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + g + 8 * half;
    if (row >= t) continue;
    T* orow = o + head + static_cast<int64_t>(row) * d;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = 8 * n + 2 * tq + j;
        if (col < d) orow[col] = fmdm::from_float<T>(acc[n][2 * half + j] / l[half]);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bh, int t, int d,
                   float scale, int rows, cudaStream_t stream) {
  constexpr int S = fmdm::smem_stride<T, D>();
  const int ntiles = (t + kKeyTile - 1) / kKeyTile;
  const int tile_bytes = 2 * kKeyTile * S * static_cast<int>(sizeof(T));  // K and V
  const bool resident = ntiles * tile_bytes <= kResidentBytes;
  const int smem = (resident ? ntiles : 2) * tile_bytes;
  auto kernel = small_t_attention<T, D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + rows - 1) / rows, bh);
  kernel<<<grid, 2 * rows, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<T*>(o), t, d,
                                           scale, resident, fmdm::rows_aligned<T>(d, k, v));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int bh, int t, int d,
                     float scale, int rows, cudaStream_t s) {
  if (d <= 8) return launch<T, 8>(q, k, v, o, bh, t, d, scale, rows, s);
  if (d <= 16) return launch<T, 16>(q, k, v, o, bh, t, d, scale, rows, s);
  if (d <= 32) return launch<T, 32>(q, k, v, o, bh, t, d, scale, rows, s);
  if (d <= 64) return launch<T, 64>(q, k, v, o, bh, t, d, scale, rows, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, o: (bh, t, d) contiguous, all f32 or all bf16 (is_bf16); d <= 64;
// rows: query rows per block, 16, 32, 48 or 64 (one warp per 16). Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int fmdm_small_t_attention(int device, const void* q, const void* k, const void* v,
                                      void* o, int bh, int t, int d, float scale, int rows,
                                      int is_bf16, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows < 16 || rows > 16 * kMaxWarps || rows % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = is_bf16 ? dispatch<bf16>(q, k, v, o, bh, t, d, scale, rows, s)
                : dispatch<float>(q, k, v, o, bh, t, d, scale, rows, s);
  return static_cast<int>(err);
}
