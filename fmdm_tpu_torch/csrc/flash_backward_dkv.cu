// K4, the flash attention backward for dK and dV (see flash.cuh for what K3,
// K4 and K5 share).
#include "flash.cuh"

using namespace fmdm::flash;

namespace {

// K4: dK and dV of one 64-key tile, looping over the Q tiles, every product on
// the tensor cores in 3xTF32. Warp w owns keys 16 w .. 16 w + 15 and computes
// the TRANSPOSED score tile (16 keys x 64 query rows), so that P^T and dS^T
// land in C fragments whose rows are keys and pass to the second products as
// A operands in registers, as P does in K3:
//   dP^T = V dO^T, S^T = K Q^T, P^T = exp(scale S^T - lse),
//   dS^T = P^T (dP^T - delta), dV += P^T dO, dK += dS^T Q (scale at the store).
// dP^T comes first: its small products sum apart (dot_rows_3xtf32), and those
// 32 registers are free again before P^T is live. lse and delta belong to the
// columns here, so they are staged with their Q and dO tiles through the
// 2-slot cp.async ring and read as pairs. The block's own K and V stay in
// shared memory and give their A fragments per 8-column chunk: held in
// registers (64 floats at D = 64) beside dK, dV, P^T and dP^T they would
// spill. At D = 64 in f32 a block takes 105.5 KB, so two share an SM and the
// VAE's 256 blocks are resident at once on 132 SMs; at D = 128 (203 KB, and
// ptxas spills 136 bytes) one block per SM: right, not fast.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                  int tq, int tk, int d, float scale, int aligned, int vectors_aligned) {
  constexpr int S = fmdm::smem_stride<T, D>();
  constexpr int kTileElems = kTile * S;
  extern __shared__ __align__(16) unsigned char dkv_tiles[];
  T* ks = reinterpret_cast<T*>(dkv_tiles);  // this block's 64 keys
  T* vs = ks + kTileElems;
  T* qs = vs + kTileElems;                  // two slots of 64 query rows
  T* dos = qs + 2 * kTileElems;
  float* lses = reinterpret_cast<float*>(dos + 2 * kTileElems);  // two slots of 64
  float* deltas = lses + 2 * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int64_t bh = blockIdx.y;
  const int k0 = blockIdx.x * kTile;
  const int key0 = k0 + 16 * warp;
  const bool live = key0 < tk;  // uniform over the warp
  const T* qh = q + bh * tq * d;
  const T* doh = dout + bh * tq * d;
  const float* lseh = lse + bh * tq;
  const float* deltah = delta + bh * tq;
  const float scale2 = scale * fmdm::kLog2e;

  // rows g and g + 8 of the warp's keys, first column 2 t, per chunk + 8 c
  const T* krow = ks + (16 * warp + g) * S + 2 * t;
  const T* vrow = vs + (16 * warp + g) * S + 2 * t;
  const auto k_frags = [&](int c, float (&f)[4]) { fmdm::load_a_tile<T, S>(f, krow + 8 * c); };
  const auto v_frags = [&](int c, float (&f)[4]) { fmdm::load_a_tile<T, S>(f, vrow + 8 * c); };

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[n][i] = dv_acc[n][i] = 0.f;
  }

  auto stage = [&](int tile) {
    const int slot = tile % 2;
    fmdm::stage_rows<T, D, S, kTile>(qs + slot * kTileElems, qh, tile * kTile, tq, d, aligned);
    fmdm::stage_rows<T, D, S, kTile>(dos + slot * kTileElems, doh, tile * kTile, tq, d, aligned);
    fmdm::stage_vector<kTile>(lses + slot * kTile, lseh, tile * kTile, tq, vectors_aligned);
    fmdm::stage_vector<kTile>(deltas + slot * kTile, deltah, tile * kTile, tq, vectors_aligned);
    fmdm::cp_async_commit();
  };
  // the block's own tiles travel in the first group
  fmdm::stage_rows<T, D, S, kTile>(ks, k + bh * tk * d, k0, tk, d, aligned);
  fmdm::stage_rows<T, D, S, kTile>(vs, v + bh * tk * d, k0, tk, d, aligned);
  const int ntiles = (tq + kTile - 1) / kTile;
  stage(0);
  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) stage(i + 1); else fmdm::cp_async_commit();
    fmdm::cp_async_wait<1>();
    __syncthreads();
    if (live) {
      const int slot = i % 2;
      const T* qt = qs + slot * kTileElems;
      const T* dot = dos + slot * kTileElems;
      const float* lset = lses + slot * kTile + 2 * t;
      const float* deltat = deltas + slot * kTile + 2 * t;
      // query rows past Tq add nothing (JAX pads them with lse = 1e30): their
      // staged lse is zero fill, so p is set by a select, not by the exp
      const int valid = tq - i * kTile - 2 * t;  // columns 8 n + j of this lane with 8 n + j < valid
      float p[8][4], ds[8][4];
      fmdm::dot_rows_3xtf32<T, D, S, true>(ds, v_frags, dot, g, t);  // dP^T
      fmdm::dot_rows_3xtf32<T, D, S, false>(p, k_frags, qt, g, t);   // S^T
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 l = fmdm::load_pair(lset + 8 * n);
        const float l2[2] = {l.x * fmdm::kLog2e, l.y * fmdm::kLog2e};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          p[n][j] = 8 * n + (j & 1) < valid ? prob(p[n][j], scale2, l2[j & 1]) : 0.f;
        }
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 dl = fmdm::load_pair(deltat + 8 * n);
#pragma unroll
        for (int j = 0; j < 4; ++j) ds[n][j] = p[n][j] * (ds[n][j] - ((j & 1) ? dl.y : dl.x));
      }
      fmdm::pv_3xtf32<T, D, S, true>(dv_acc, p, dot, g, t);
      fmdm::pv_3xtf32<T, D, S, true>(dk_acc, ds, qt, g, t);
    }
    __syncthreads();  // the slot is free for the copy issued next
  }

  if (!live) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + g + 8 * h;
    if (key >= tk) continue;
    T* dkrow = dk + (bh * tk + key) * d;
    T* dvrow = dv + (bh * tk + key) * d;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = 8 * n + 2 * t + j;
        if (col >= d) continue;
        dkrow[col] = fmdm::from_float<T>(scale * dk_acc[n][2 * h + j]);
        dvrow[col] = fmdm::from_float<T>(dv_acc[n][2 * h + j]);
      }
    }
  }
}

// K4: K, V, two slots of Q and dO, two slots of lse and delta
template <typename T, int D>
constexpr int dkv_smem() {
  return 6 * kTile * fmdm::smem_stride<T, D>() * sizeof(T) + 4 * kTile * sizeof(float);
}

template <typename T, int D>
cudaError_t backward_dkv(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dk, void* dv, int bh, int tq,
                         int tk, int d, float scale, cudaStream_t s) {
  const bool aligned = fmdm::rows_aligned<T>(d, q, k) && fmdm::rows_aligned<T>(d, v, dout);
  const bool vectors_aligned = tq % 4 == 0 && fmdm::rows_aligned<float>(4, lse, delta);
  return launch(flash_bwd_dkv<T, D>, kThreads, dkv_smem<T, D>(), tk, bh, s,
                static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const T*>(dout), static_cast<const float*>(lse),
                static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), tq, tk,
                d, scale, static_cast<int>(aligned), static_cast<int>(vectors_aligned));
}

template <typename T, int D>
struct BackwardDkv {
  template <typename... Args>
  static cudaError_t run(Args... args) { return backward_dkv<T, D>(args...); }
};

}  // namespace

// All tensors contiguous. q, dout, out, dq: (bh, tq, d); k, v, dk, dv:
// (bh, tk, d); lse, delta: (bh, tq) f32. q, k, v, dout and the outputs are all
// f32 or all bf16 (is_bf16). 1 <= d <= 128, bh <= 65535. Returns
// cudaGetLastError() after its one launch (0 on success).
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
