// Warp-level tensor-core helpers for Hopper (sm_90a), shared by the attention
// kernels: mma.sync and ldmatrix wrappers, cp.async staging of row tiles, the
// 3xTF32 split, and the two products of an f32 attention tile on tensor cores.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k8" and
// "mma.m16n8k16"), for lane = 4 g + t (g = lane / 4 in 0..7, t = lane % 4):
//   C/D of every m16n8 shape, 4 f32: c0, c1 at row g, columns 2t and 2t + 1;
//     c2, c3 at row g + 8, the same columns.
//   tf32 m16n8k8: A (16 x 8), 4 registers: a0 (g, t), a1 (g + 8, t),
//     a2 (g, t + 4), a3 (g + 8, t + 4); B (8 x 8), 2 registers:
//     b0 (k = t, n = g), b1 (k = t + 4, n = g).
//   bf16 m16n8k8: A, 2 registers of 2 bf16: (g, 2t..2t+1), (g + 8, 2t..2t+1);
//     B, 1 register: (k = 2t..2t+1, n = g).
//   bf16 m16n8k16: A, 4 registers: (g, 2t..), (g + 8, 2t..), (g, 2t + 8..),
//     (g + 8, 2t + 8..); B, 2 registers: (k = 2t.., n = g), (k = 2t + 8.., n = g).
// In a register of two bf16 the lower column sits in the low 16 bits.
//
// 3xTF32 (CUTLASS's OpMultiplyAddFastF32): an f32 x is split into
// hi = tf32(x) and lo = tf32(x - hi), both rounded to nearest with ties away
// (cvt.rna); x - hi is exact in f32. a*b is then hi_a*lo_b + lo_a*hi_b +
// hi_a*hi_b, each product exact, the two small terms first. Only lo_a*lo_b
// (about 2^-22 relative) is dropped, so the result keeps f32-level accuracy
// where one TF32 product keeps about 3 digits. What remains is the
// accumulator: the tensor core rounds every sum toward zero, a bias of half
// an f32 ulp of the running sum per mma. Where that shows (a difference of
// near-equal values, a sum over many tiles) the products below can keep the
// small terms apart (kApart) or sum each tile afresh (kFresh).
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace fmdm {

// ---- instructions ----------------------------------------------------------

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16_k8(float (&c)[4], const uint32_t (&a)[2], uint32_t b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

__device__ __forceinline__ void mma_bf16_k16(float (&c)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two 8x8 b16 matrices, transposed: lanes 0-7 give the row addresses of the
// first, lanes 8-15 of the second (16-byte aligned); lane 4 g + t receives
// elements (2t, g) and (2t + 1, g) of each, the B fragment of m16n8k16 when
// the rows are k.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// 16 bytes global -> shared; bytes past src_bytes (0 or 16) are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// c += a * b in 3xTF32: hi*lo, then lo*hi, then hi*hi into one accumulator
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4], const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  mma_tf32(c, a_hi, b_lo);
  mma_tf32(c, a_lo, b_hi);
  mma_tf32(c, a_hi, b_hi);
}

// two f32 rounded to bf16 (nearest even) in one register, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x on the SFU (ex2.approx.ftz: relative error about 2^-22, -inf -> 0).
// exp(y) is taken as exp2(y * log2(e)), the product rounded once in f32.
__device__ __forceinline__ float exp2_approx(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

constexpr float kLog2e = 1.4426950408889634f;

// reductions over the 4 lanes of a quad (one fragment row)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---- shared-memory tiles ---------------------------------------------------

// Row stride (elements) of a (rows, D) tile of T in shared memory, chosen so
// that the fragment loads below hit 32 distinct banks: f32 rows 4 words off a
// multiple of 8 words, bf16 rows an odd number of 16-byte units apart (what
// ldmatrix needs). Every row starts 16-byte aligned.
template <typename T, int D>
__host__ __device__ constexpr int smem_stride() {
  return sizeof(T) == 4 ? D + 4 : ((D / 8) % 2 ? D : D + 8);
}

// Whether every row of two row-major (rows, d) matrices of T starts 16-byte
// aligned, as the cp.async path of stage_rows needs (host side).
template <typename T>
inline bool rows_aligned(int d, const void* a, const void* b) {
  return (static_cast<int64_t>(d) * sizeof(T)) % 16 == 0 &&
         ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16) == 0;
}

// Stage rows [r0, r0 + kRows) of a row-major (rows, d) matrix into a tile of
// row stride S, zero-filled past `rows` and past d: 16-byte cp.async copies
// when every row starts 16-byte aligned (`aligned`: d * sizeof(T) % 16 == 0
// and an aligned base), else a plain copy by the same threads. The caller
// commits the group and waits for it.
template <typename T, int D, int S, int kRows>
__device__ __forceinline__ void stage_rows(T* __restrict__ dst, const T* __restrict__ src, int r0,
                                           int rows, int d, bool aligned) {
  if (aligned) {
    constexpr int kChunk = 16 / sizeof(T);
    constexpr int kChunks = D / kChunk;
    for (int idx = threadIdx.x; idx < kRows * kChunks; idx += blockDim.x) {
      const int r = idx / kChunks, c = (idx % kChunks) * kChunk;
      const bool live = r0 + r < rows && c < d;
      cp_async16(dst + r * S + c, live ? src + static_cast<int64_t>(r0 + r) * d + c : src,
                 live ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < kRows * D; idx += blockDim.x) {
      const int r = idx / D, c = idx % D;
      dst[r * S + c] = (r0 + r < rows && c < d) ? src[static_cast<int64_t>(r0 + r) * d + c]
                                                : from_float<T>(0.f);
    }
  }
}

// Stage entries [r0, r0 + kRows) of an f32 vector of `rows` entries,
// zero-filled past its end: 16-byte cp.async copies when every group of four
// starts 16-byte aligned and ends inside the vector or starts past it
// (`aligned`: an aligned base, and rows and every r0 multiples of 4), else a
// plain copy. The caller commits the group and waits for it.
template <int kRows>
__device__ __forceinline__ void stage_vector(float* __restrict__ dst, const float* __restrict__ src,
                                             int r0, int rows, bool aligned) {
  if (aligned) {
    for (int idx = threadIdx.x; idx < kRows / 4; idx += blockDim.x) {
      const bool live = r0 + 4 * idx < rows;
      cp_async16(dst + 4 * idx, live ? src + r0 + 4 * idx : src, live ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < kRows; idx += blockDim.x) {
      dst[idx] = r0 + idx < rows ? src[r0 + idx] : 0.f;
    }
  }
}

// ---- an f32 attention tile in 3xTF32 ---------------------------------------

// The tf32 A fragments of the 16 rows [row0, row0 + 16) of a row-major
// (rows, d) matrix, as f32 times mul, per 8-column chunk; zeros past the
// rows and past d. They are split into hi and lo where they are used. The k
// index of a chunk runs over its columns in the order (0, 2, 4, 6, 1, 3, 5,
// 7): a1/a3 hold column 2t + 1 where the PTX layout names k = t + 4, so the
// two B registers of qk_3xtf32 are adjacent columns, one 8-byte load.
template <typename T, int D>
__device__ __forceinline__ void load_a_tf32(float (&a)[D / 8][4], const T* __restrict__ src,
                                            int row0, int rows, int d, float mul, int g, int t) {
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + g + 8 * (i & 1), col = 8 * c + 2 * t + (i >> 1);
      a[c][i] = (r < rows && col < d) ? to_float(src[static_cast<int64_t>(r) * d + col]) * mul : 0.f;
    }
  }
}

// Two adjacent elements of shared memory as f32 (8-byte or 4-byte aligned).
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// The same fragments (one 8-column chunk, p at its first column) for rows g
// and g + 8 of a tile of T with row stride S in shared memory, where
// p = tile + (row0 + g) * S + 8 c + 2 t: two 8-byte (f32) or 4-byte loads.
template <typename T, int S>
__device__ __forceinline__ void load_a_tile(float (&f)[4], const T* __restrict__ p) {
  const float2 top = load_pair(p), bottom = load_pair(p + 8 * S);
  f[0] = top.x;
  f[1] = bottom.x;
  f[2] = top.y;
  f[3] = bottom.y;
}

// s[n] (C fragments) = A (16 x D) B[8n .. 8n + 7]^T for the 64 rows of a tile
// B of T with row stride S, in 3xTF32. a(c, f) fills f with A's fragments of
// chunk c in the order of load_a_tf32, from registers or from shared memory.
// kApart: the two small products of every chunk sum into accumulators of
// their own, added at the end. The tensor core rounds each sum toward zero
// at the size of its accumulator, so this takes two of every three roundings
// off the large sum: for a result that the caller subtracts from a value
// near it (dP - delta), at the cost of 32 registers while the product runs.
template <typename T, int D, int S, bool kApart, typename A>
__device__ __forceinline__ void dot_rows_3xtf32(float (&s)[8][4], const A& a,
                                                const T* __restrict__ bs, int g, int t) {
  float small[kApart ? 8 : 1][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[n][i] = 0.f;
      if constexpr (kApart) small[n][i] = 0.f;
    }
  }
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    float f[4];
    a(c, f);
    uint32_t a_hi[4], a_lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(f[i], a_hi[i], a_lo[i]);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 b = load_pair(bs + (8 * n + g) * S + 8 * c + 2 * t);  // k = t, t + 4
      uint32_t b_hi[2], b_lo[2];
      split_tf32(b.x, b_hi[0], b_lo[0]);
      split_tf32(b.y, b_hi[1], b_lo[1]);
      if constexpr (kApart) {
        mma_tf32(small[n], a_hi, b_lo);
        mma_tf32(small[n], a_lo, b_hi);
        mma_tf32(s[n], a_hi, b_hi);
      } else {
        mma_3xtf32(s[n], a_hi, a_lo, b_hi, b_lo);
      }
    }
  }
  if constexpr (kApart) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] += small[n][i];
    }
  }
}

// dot_rows_3xtf32 with A held in registers as load_a_tf32 left it: the scores
// of 16 query rows against the 64 keys of a tile.
template <typename T, int D, int S>
__device__ __forceinline__ void qk_3xtf32(float (&s)[8][4], const float (&a)[D / 8][4],
                                          const T* __restrict__ ks, int g, int t) {
  const auto held = [&a](int c, float (&f)[4]) {
    f[0] = a[c][0];
    f[1] = a[c][1];
    f[2] = a[c][2];
    f[3] = a[c][3];
  };
  dot_rows_3xtf32<T, D, S, false>(s, held, ks, g, t);
}

// o[n] (C fragments) += P V[:, 8n .. 8n + 7] over the 64 keys of a tile of T
// with row stride S, in 3xTF32, where p holds P (16 x 64, f32) as the C
// fragments that dot_rows_3xtf32 left. A C fragment holds columns 2t and 2t + 1
// where an A fragment wants t and t + 4, so each 8-key chunk is summed in
// the key order (0, 2, 4, 6, 1, 3, 5, 7) and B is read in the same order:
// P goes from accumulators to operands without a shuffle.
// kFresh: the tile's 24 products per output sum into zeroed accumulators that
// one f32 add (round to nearest) then folds into o, so the tensor core's
// rounding toward zero acts at the size of one tile's share and not of a sum
// that grows over many tiles; 32 registers (D = 64) while the product runs.
template <typename T, int D, int S, bool kFresh = false>
__device__ __forceinline__ void pv_3xtf32(float (&o)[D / 8][4], const float (&p)[8][4],
                                          const T* __restrict__ vs, int g, int t) {
  float fresh[kFresh ? D / 8 : 1][4];
  if constexpr (kFresh) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) fresh[n][i] = 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint32_t a_hi[4], a_lo[4];
    split_tf32(p[j][0], a_hi[0], a_lo[0]);  // (g, key 2t)
    split_tf32(p[j][2], a_hi[1], a_lo[1]);  // (g + 8, key 2t)
    split_tf32(p[j][1], a_hi[2], a_lo[2]);  // (g, key 2t + 1)
    split_tf32(p[j][3], a_hi[3], a_lo[3]);  // (g + 8, key 2t + 1)
    const T* even = vs + (8 * j + 2 * t) * S;
    const T* odd = even + S;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      uint32_t b_hi[2], b_lo[2];
      split_tf32(to_float(even[8 * n + g]), b_hi[0], b_lo[0]);
      split_tf32(to_float(odd[8 * n + g]), b_hi[1], b_lo[1]);
      if constexpr (kFresh) {
        mma_3xtf32(fresh[n], a_hi, a_lo, b_hi, b_lo);
      } else {
        mma_3xtf32(o[n], a_hi, a_lo, b_hi, b_lo);
      }
    }
  }
  if constexpr (kFresh) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) o[n][i] += fresh[n][i];
    }
  }
}

}  // namespace fmdm
