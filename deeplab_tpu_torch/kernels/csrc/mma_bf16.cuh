// Warp-level bf16 tensor-core helpers shared by the MBConv kernels
// (fused_mbconv.cu, fused_mbconv_train.cu): mma.sync m16n8k16 with f32
// accumulation and fragment loads from shared memory.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mbconv {

__device__ __forceinline__ float relu6(float v) { return fminf(fmaxf(v, 0.f), 6.f); }

// round to bf16 and back (the plain versions' q(v) for the bf16 policy)
__device__ __forceinline__ float qbf(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D += A(16x16, row) * B(16x8, col); bf16 operands, f32 accumulate.
// Fragments (g = lane/4, t = lane%4):
//   a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)  a3 (g+8, 2t+8..)
//   b0 (k 2t..2t+1, n g)  b1 (k 2t+8.., n g)
//   d0,d1 (g, 2t..2t+1)  d2,d3 (g+8, 2t..2t+1)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[j] += A[m0 .. m0+16, 0..K) * B[0..K, 8 nt_j ..] for the warp's n-tiles
// nt_j = nt0 + nt_step * j (those < n_tiles).  A is row-major (m, k) with
// row stride lda; B is stored n-major (n, k) with row stride ldb; K is a
// multiple of 16 and both are zero past the real depth.
template <int NT>
__device__ __forceinline__ void mma_tile(float (&acc)[NT][4],
                                         const __nv_bfloat16* A, int lda, int m0,
                                         const __nv_bfloat16* B, int ldb, int K,
                                         int nt0, int nt_step, int n_tiles) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* ar0 = A + (m0 + g) * lda + 2 * t;
  const __nv_bfloat16* ar1 = ar0 + 8 * lda;
  for (int kk = 0; kk < K; kk += 16) {
    const uint32_t af[4] = {ld32(ar0 + kk), ld32(ar1 + kk), ld32(ar0 + kk + 8),
                            ld32(ar1 + kk + 8)};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int nt = nt0 + nt_step * j;
      if (nt < n_tiles) {
        const __nv_bfloat16* br = B + (nt * 8 + g) * ldb + kk + 2 * t;
        mma16816(acc[j], af, ld32(br), ld32(br + 8));
      }
    }
  }
}

__device__ __forceinline__ uint32_t pack2(const __nv_bfloat16* lo,
                                          const __nv_bfloat16* hi) {
  return uint32_t(*reinterpret_cast<const uint16_t*>(lo)) |
         (uint32_t(*reinterpret_cast<const uint16_t*>(hi)) << 16);
}

// mma_tile with B stored k-major (k, n), row stride ldb: each B fragment
// pairs two rows, so it is packed from 16-bit loads.
template <int NT>
__device__ __forceinline__ void mma_tile_kn(float (&acc)[NT][4],
                                            const __nv_bfloat16* A, int lda, int m0,
                                            const __nv_bfloat16* B, int ldb, int K,
                                            int nt0, int nt_step, int n_tiles) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* ar0 = A + (m0 + g) * lda + 2 * t;
  const __nv_bfloat16* ar1 = ar0 + 8 * lda;
  for (int kk = 0; kk < K; kk += 16) {
    const uint32_t af[4] = {ld32(ar0 + kk), ld32(ar1 + kk), ld32(ar0 + kk + 8),
                            ld32(ar1 + kk + 8)};
    const __nv_bfloat16* bk = B + (kk + 2 * t) * ldb + g;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int nt = nt0 + nt_step * j;
      if (nt < n_tiles) {
        const __nv_bfloat16* bc = bk + nt * 8;
        mma16816(acc[j], af, pack2(bc, bc + ldb),
                 pack2(bc + 8 * ldb, bc + 9 * ldb));
      }
    }
  }
}

// Call f(row, col, value) for each accumulator element of the warp's tile
// (rows m0 + g and m0 + g + 8; columns 8 nt_j + 2t and + 1).
template <int NT, typename F>
__device__ __forceinline__ void for_each_acc(const float (&acc)[NT][4], int m0,
                                             int nt0, int nt_step, int n_tiles,
                                             F f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int nt = nt0 + nt_step * j;
    if (nt >= n_tiles) continue;
    const int n = nt * 8 + 2 * t;
    f(m0 + g, n, acc[j][0]);
    f(m0 + g, n + 1, acc[j][1]);
    f(m0 + g + 8, n, acc[j][2]);
    f(m0 + g + 8, n + 1, acc[j][3]);
  }
}

}  // namespace mbconv
