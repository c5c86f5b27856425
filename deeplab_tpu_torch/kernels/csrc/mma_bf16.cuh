// Warp-level bf16 tensor-core helpers shared by the MBConv kernels
// (fused_mbconv.cu, fused_mbconv_train.cu): mma.sync m16n8k16 with f32
// accumulation, fragment loads from shared memory (32-bit loads or
// ldmatrix), 16-byte cp.async copies and the swizzles of the tiles they
// fill.
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Swizzles: the x tile, e and the w1 stages have unpadded rows, their
// 16-byte chunks (8 floats for e) permuted by row so that the 8 rows an
// ldmatrix phase reads, and the 4 rows a half-warp's float2 stores write,
// fall in distinct banks.
// w1 stage row k of CK bf16: chunk c at c ^ w1_swz(k).
template <int CK>
__device__ __forceinline__ int w1_swz(int k) {
  return CK == 32 ? (k >> 1) & 3 : (k >> 2) & 1;
}
// e row R of CK floats: float column c at c ^ e_swz(R).
template <int CK>
__device__ __forceinline__ int e_swz(int R) {
  return CK == 32 ? (R & 3) << 3 : ((R >> 1) & 1) << 3;
}
// x tile row R: 16-byte chunk c at c ^ xs_swz(R) where the row has 4 (mod
// 8) chunks of 16 bytes (cin_p = 32, 96, 160, ...; swz set), else at c in
// a row padded by one chunk.
__device__ __forceinline__ int xs_chunk(int swz, int R, int c) {
  return swz ? c ^ ((R >> 1) & 3) : c;
}

// 16-byte async copy; bytes < 16 zero-fill the rest (0: all zero, no read)
__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes));
}
// 8-byte async copy (through L1), zero-filled like cp16
__device__ __forceinline__ void cp8(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

}  // namespace mbconv
