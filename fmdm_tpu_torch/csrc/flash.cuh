// K3, K4, K5: flash attention forward and backward for Hopper (sm_90a); what
// the three kernels share. K3 is in flash_attention.cu, K4 in
// flash_backward_dkv.cu, K5 in flash_backward_dq.cu: one source each, so that
// their builds run side by side.
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
// All three run every product on the tensor cores in 3xTF32 (mma.cuh): each
// f32 operand is split into a TF32 head and a TF32 remainder and three
// products are summed in f32, which keeps the plain version's f32 accuracy
// where one TF32 product (3 digits) would not; the least time for that is 3x
// the operations at the 495 TFLOP/s TF32 rate, 2.5x below the 67 TFLOP/s of
// f32 FMAs. One block of 4 warps per (batch*head, 64-row tile): a Q tile for
// K3 and K5, a KV tile for K4, 16 of its rows per warp. The other operand
// passes through a 2-slot cp.async ring of 64-row tiles, and the first
// product's result (P, dS) goes from its accumulators to the second
// product's operands in registers (see flash_fwd). Each warp splits the
// values it reads; splitting a tile once per block for all four warps was
// measured slower on K3. Exponentials are one FMA and the SFU's exp2, a few
// f32 ulps from expf.
//
// K4 and K5 recompute p = exp(scale * s - lse) from the saved lse, so S and
// dP are computed in both (14 T*T*d products per backward where one fused
// kernel would do 10). What was hard in them is registers and the tensor
// core's rounding. K4 works on the transposed tile and leaves K and V in
// shared memory; K5 holds q and reads dO from shared memory (see each
// kernel's note). The tensor core rounds its sums toward zero: dP, from
// which delta is subtracted, keeps its small products apart, and K3's output,
// dK, dV and dQ, which sum over every tile of the loop, take each tile's
// share from fresh accumulators by one f32 add. Without the two, the error
// against the plain version was 3x larger and passed the f32 tolerance at
// Tk = 1 and Tk = 77 only by the draw; they cost about 1% of K4's and K5's
// time.
//
// bf16 inputs are widened to f32 as they are read and the outputs rounded
// once. Ragged tails are masked: keys past Tk get a score of -inf in K3 and
// p = 0 in K5, query rows past Tq get p = 0 in K4 (where JAX pads them with
// lse = 1e30), and nothing past either end is stored. K4 owns its KV tile and
// K5 its Q tile, so neither needs atomics and both are deterministic. Head
// dims up to 128 are padded with zeros to D = 32, 64 or 128. wgmma, TMA and
// warp specialisation are later work.
#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace fmdm {
namespace flash {

constexpr int kTile = 64;      // rows of every tile
constexpr int kThreads = 128;  // 4 warps, each 16 rows of the block's own tile

// p = exp(scale * s - lse) as one FMA and one exp2: scale2 = scale * log2(e),
// lse2 = lse * log2(e). JAX scales after the dot here (:159, :186).
__device__ __forceinline__ float prob(float s, float scale2, float lse2) {
  return fmdm::exp2_approx(fmaf(s, scale2, -lse2));
}

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

}  // namespace flash
}  // namespace fmdm
