// bf16 tensor-core helpers shared by the kernels of fused_mbconv.cu,
// fused_mbconv_train.cu and fused_sepconv.cu: mma.sync m16n8k16 with f32
// accumulation, fragment loads from shared memory (32-bit loads or
// ldmatrix), 16-byte cp.async copies and the swizzles of the tiles they
// fill; and Hopper's warpgroup products (wgmma) with their shared-memory
// descriptors.
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

// Hopper's warpgroup products (wgmma): four warps multiply a 64-row A tile
// by an N-column B tile, both read by the tensor cores from shared memory
// through descriptors, asynchronously; the f32 sums stay in registers
// (thread t of warp w: rows 16w + t/4 and + 8, columns 8j + 2(t%4) and + 1
// for d[4j .. 4j+3]).  A and B are K-major with the 128-, 64- or 32-byte
// swizzle (CK = 64, 32, 16) the chunks already have.
__device__ __forceinline__ uint64_t gmma_desc(const void* p, int ck) {
  const uint32_t a = mbconv::smem_u32(p);
  const uint64_t sbo = 8 * ck * 2;            // bytes between 8-row groups
  const uint64_t swz = ck == 64 ? 1 : ck == 32 ? 2 : 3;  // 128-, 64-, 32-byte
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | ((sbo >> 4) << 32) | (swz << 62);
}
// The swizzle of a row of CK bf16 (A chunks and wpw slots): 16-byte chunk
// c of row r lies at c ^ swz<CK>(r), wgmma's 128-, 64- and 32-byte
// patterns, under which ldmatrix-style 8-row reads hit 8 bank groups.
template <int CK>
__device__ __forceinline__ int swz(int r) {
  return CK == 64 ? r & 7 : CK == 32 ? (r >> 1) & 3 : (r >> 2) & 1;
}
__device__ __forceinline__ void gmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void gmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void gmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accumulator registers across these points
template <int R>
__device__ __forceinline__ void pin(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void gmma_m64n32(float (&d)[16], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void gmma_m64n64(float (&d)[32], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void gmma_m64n96(float (&d)[48], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, %48, %49, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void gmma_m64n128(float (&d)[64], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void gmma_m64n160(float (&d)[80], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, %80, %81, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "l"(da), "l"(db), "r"(1));
}
// m64nNk16 by N (the widths above)
template <int N>
__device__ __forceinline__ void gmma_m64(float (&d)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 32) gmma_m64n32(d, da, db);
  else if constexpr (N == 64) gmma_m64n64(d, da, db);
  else if constexpr (N == 96) gmma_m64n96(d, da, db);
  else if constexpr (N == 128) gmma_m64n128(d, da, db);
  else gmma_m64n160(d, da, db);
}

}  // namespace mbconv
