// K3, the flash attention forward (see flash.cuh for what K3, K4 and K5 share).
#include "flash.cuh"

using namespace fmdm::flash;

namespace {

// K3: out = softmax(scale * q k^T) v and lse = m + log l, per 64-row Q tile,
// on the tensor cores in 3xTF32 (mma.cuh). Warp w owns query rows 16 w ..
// 16 w + 15 of the tile: q * scale stays in registers as f32 A fragments,
// the scores and the output accumulate in C fragments, and rows g and g + 8
// of a fragment belong to one quad, so row max and row sum are quad shuffles.
// K and V pass through a 2-slot cp.async ring of 64-key tiles. Each tile's PV
// product sums in fresh accumulators that one f32 add folds into the
// corrected running output, as K4 and K5 sum dK, dV and dQ (flash.cuh).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
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
      fmdm::pv_3xtf32<T, D, S, true>(acc, s, vs + slot * kTileElems, g, t);
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

template <typename T, int D>
cudaError_t forward(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int tq,
                    int tk, int d, float scale, cudaStream_t s) {
  return launch(flash_fwd<T, D>, kThreads, fwd_smem<T, D>(), tq, bh, s,
                static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<T*>(o), static_cast<float*>(lse), tq, tk, d, scale,
                static_cast<int>(fmdm::rows_aligned<T>(d, k, v)));
}

template <typename T, int D>
struct Forward {
  template <typename... Args>
  static cudaError_t run(Args... args) { return forward<T, D>(args...); }
};

}  // namespace

// All tensors contiguous. q, dout, out, dq: (bh, tq, d); k, v, dk, dv:
// (bh, tk, d); lse, delta: (bh, tq) f32. q, k, v, dout and the outputs are all
// f32 or all bf16 (is_bf16). 1 <= d <= 128, bh <= 65535. Returns
// cudaGetLastError() after its one launch (0 on success).
extern "C" int fmdm_flash_forward(int device, const void* q, const void* k, const void* v, void* o,
                                  void* lse, int bh, int tq, int tk, int d, float scale,
                                  int is_bf16, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(dispatch<Forward>(is_bf16, d, q, k, v, o, lse, bh, tq, tk, d, scale,
                                            static_cast<cudaStream_t>(stream)));
}
