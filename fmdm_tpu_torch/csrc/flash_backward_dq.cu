// K5, the flash attention backward for dQ (see flash.cuh for what K3, K4 and K5
// share).
#include "flash.cuh"

using namespace fmdm::flash;

namespace {

// K5: dQ of one 64-row Q tile, looping over the KV tiles: K3's shape plus one
// product, all three in 3xTF32. Warp w owns query rows 16 w .. 16 w + 15;
// lse and delta of rows g and g + 8 stay in registers, K and V pass through
// the 2-slot cp.async ring, dP = dO V^T (small products apart, first, as in
// K4) and S = q K^T land in C fragments, and dS = P (dP - delta) passes to
// dQ += dS K in registers (scale at the store). q stays in registers as A
// fragments up to D = 64; dO's fragments come from a copy of the block's dO
// tile in shared memory: held as well, beside dP's second accumulators, they
// spilled at the 255-register cap and the kernel ran 15% slower (87 KB a
// block, two to an SM). At D = 128 q takes the same way as dO (203 KB, one
// block per SM).
template <int D>
constexpr bool kDqHoldsQ = D <= 64;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dq, int tq, int tk, int d,
                 float scale, int aligned) {
  constexpr int S = fmdm::smem_stride<T, D>();
  constexpr int kTileElems = kTile * S;
  extern __shared__ __align__(16) unsigned char dq_tiles[];
  T* ks = reinterpret_cast<T*>(dq_tiles);  // two slots of 64 keys
  T* vs = ks + 2 * kTileElems;
  T* dos = vs + 2 * kTileElems;            // this block's rows of dO
  T* qs = dos + kTileElems;                // and of q, unless held
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int64_t bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const int row0 = q0 + 16 * warp;
  const bool live = row0 < tq;  // uniform over the warp
  const T* kh = k + bh * tk * d;
  const T* vh = v + bh * tk * d;
  const float scale2 = scale * fmdm::kLog2e;

  constexpr bool kHeld = kDqHoldsQ<D>;
  float qa[kHeld ? D / 8 : 1][4];  // the block's own tiles travel in the first group
  if constexpr (kHeld) {
    fmdm::load_a_tf32<T, D>(qa, q + bh * tq * d, row0, tq, d, 1.f, g, t);
  } else {
    fmdm::stage_rows<T, D, S, kTile>(qs, q + bh * tq * d, q0, tq, d, aligned);
  }
  fmdm::stage_rows<T, D, S, kTile>(dos, dout + bh * tq * d, q0, tq, d, aligned);
  const T* qrow = qs + (16 * warp + g) * S + 2 * t;
  const T* dorow = dos + (16 * warp + g) * S + 2 * t;
  const auto q_frags = [&](int c, float (&f)[4]) {
    if constexpr (kHeld) {
      f[0] = qa[c][0], f[1] = qa[c][1], f[2] = qa[c][2], f[3] = qa[c][3];
    } else {
      fmdm::load_a_tile<T, S>(f, qrow + 8 * c);
    }
  };
  const auto do_frags = [&](int c, float (&f)[4]) { fmdm::load_a_tile<T, S>(f, dorow + 8 * c); };

  // rows g and g + 8: lse * log2(e) and delta
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    lse2[h] = row < tq ? lse[bh * tq + row] * fmdm::kLog2e : 0.f;
    dl[h] = row < tq ? delta[bh * tq + row] : 0.f;
  }
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
      const int valid = tk - i * kTile - 2 * t;  // keys 8 n + j of this lane with 8 n + j < valid
      float s[8][4], dp[8][4];
      fmdm::dot_rows_3xtf32<T, D, S, true>(dp, do_frags, vs + slot * kTileElems, g, t);
      fmdm::dot_rows_3xtf32<T, D, S, false>(s, q_frags, ks + slot * kTileElems, g, t);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // keys past Tk add nothing: p by a select, their staged rows are zero fill
          const float p = 8 * n + (j & 1) < valid ? prob(s[n][j], scale2, lse2[j >> 1]) : 0.f;
          s[n][j] = p * (dp[n][j] - dl[j >> 1]);
        }
      }
      fmdm::pv_3xtf32<T, D, S, true>(acc, s, ks + slot * kTileElems, g, t);
    }
    __syncthreads();  // the slot is free for the copy issued next
  }

  if (!live) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= tq) continue;
    T* dqrow = dq + (bh * tq + row) * d;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = 8 * n + 2 * t + j;
        if (col < d) dqrow[col] = fmdm::from_float<T>(scale * acc[n][2 * h + j]);
      }
    }
  }
}

// K5: two slots of K and V, dO, and q unless held
template <typename T, int D>
constexpr int dq_smem() {
  return (kDqHoldsQ<D> ? 5 : 6) * kTile * fmdm::smem_stride<T, D>() * sizeof(T);
}

template <typename T, int D>
cudaError_t backward_dq(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dq, int bh, int tq, int tk,
                        int d, float scale, cudaStream_t s) {
  const bool aligned = fmdm::rows_aligned<T>(d, q, k) && fmdm::rows_aligned<T>(d, v, dout);
  return launch(flash_bwd_dq<T, D>, kThreads, dq_smem<T, D>(), tq, bh, s,
                static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const T*>(dout), static_cast<const float*>(lse),
                static_cast<const float*>(delta), static_cast<T*>(dq), tq, tk, d, scale,
                static_cast<int>(aligned));
}

template <typename T, int D>
struct BackwardDq {
  template <typename... Args>
  static cudaError_t run(Args... args) { return backward_dq<T, D>(args...); }
};

}  // namespace

// All tensors contiguous. q, dout, out, dq: (bh, tq, d); k, v, dk, dv:
// (bh, tk, d); lse, delta: (bh, tq) f32. q, k, v, dout and the outputs are all
// f32 or all bf16 (is_bf16). 1 <= d <= 128, bh <= 65535. Returns
// cudaGetLastError() after its one launch (0 on success).
extern "C" int fmdm_flash_backward_dq(int device, const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dq, int bh, int tq, int tk, int d, float scale,
                                      int is_bf16, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(dispatch<BackwardDq>(is_bf16, d, q, k, v, dout, lse, delta, dq, bh, tq,
                                               tk, d, scale, static_cast<cudaStream_t>(stream)));
}
