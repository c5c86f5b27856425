// Fused eval-mode depthwise 3x3 + BN affine + relu6 for Hopper (sm_90a).
//
// Replaces the TPU kernel deeplab_tpu/kernels/fused_dw.py::fused_dw_bn_relu6
// (pl.pallas_call at line 66).  Per output pixel and channel c:
//   acc = sum_{dy, dx} x[y + (dy-1)*rate, x + (dx-1)*rate, c] * k[dy, dx, c]
//         (stride 1, SAME zero padding, dilation rate, f32; dy outer)
//   out = acc * scale[c] + shift[c], clipped to [0, 6] when relu6
// on NHWC memory (the NCHW activation in channels-last memory), f32 or bf16 in
// and out, taps and the folded BN affine in f32.
//
// What bounds it on the H100.  18 f32 flops and 2 more per output value
// against one value read and one written: 5 flops per byte in f32, far under
// the card's ridge, so the bound is the bytes, (B*H*W*C) * (in + out) at
// 3.35 TB/s: 0.040 ms for MobileNetV2 block 0 of a B=8 512x512 request,
// (8, 256, 256, 32) f32.
//
// Design: a stencil that streams.  A block owns a strip of `sw` output
// columns, `th` output rows and a chunk of `cv` vectors of channels (a
// vector is 16 bytes where C allows: 4 f32 or 8 bf16 channels), and walks
// down its rows.  Its input rows (the strip and a halo of `rate` columns on
// each side, zero outside the image) pass through a ring of 2*rate + 1 +
// `prefetch` rows in shared memory, filled by cp.async 16-byte copies with
// zero fill: while output row y is computed from ring rows y, y + rate and
// y + 2*rate (relative to the block's first input row), the copies of the
// next `prefetch` input rows are in flight, so loads and arithmetic overlap
// and each input byte of the strip is read from device memory once (the
// halo columns and the th-row segments' 2*rate halo rows are re-read, from
// L2 where neighbouring blocks run together).  One barrier a row.  A thread
// owns one vector of channels of one column for the whole walk, so its 9
// taps and the affine sit in registers, its ring reads are 16-byte and
// conflict-free (a warp reads 512 contiguous bytes), and its stores are
// 16-byte and coalesced.  No division per item: a thread's column and
// vector are fixed, the ring slots advance with the row.
//
// The launch plan (strip width, rows a block, channel chunk, prefetch depth,
// threads and shared memory) is decided in plain Python by
// kernels/fused_dw.py::dw_plan and checked here; the grid is (strips along
// W, row segments along H, channel chunks x B).
//
// Rounding points are the plain version's (kernels/fused_dw.py): the 9
// products summed in f32 in its order, then the affine, each operation
// rounded on its own (this file is built with -fmad=false), so the two agree
// bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

extern __shared__ __align__(16) unsigned char dyn_smem[];

namespace {

typedef __nv_bfloat16 bf16;
using mbconv::cp16;
using mbconv::cp8;
using mbconv::cp_commit;
using mbconv::cp_wait;
using mbconv::smem_u32;

constexpr int MAX_THREADS = 256;
constexpr int MAX_PREFETCH = 4;
constexpr int SMEM_MAX = 232448;

enum { ERR_ARGS = 100001, ERR_PLAN = 100002 };

struct Args {
  const void* x;            // (B, H, W, C)
  const float* taps;        // (3, 3, C) = (9, C), (dy, dx) row-major
  const float* scale;       // (C)
  const float* shift;       // (C)
  void* out;                // (B, H, W, C), dtype of x
  int H, W, C, rate, relu6;
  int sw, th, cv, prefetch, chunks;
};

// VEC elements of T as one load or store of VEC * sizeof(T) bytes, and as
// 32-bit words in registers (a bf16 pair a word, the low half first)
template <int BYTES> struct Raw;
template <> struct Raw<16> { typedef uint4 t; };
template <> struct Raw<8> { typedef uint2 t; };
template <> struct Raw<4> { typedef uint32_t t; };
template <> struct Raw<2> { typedef unsigned short t; };

__device__ __forceinline__ void to_words(const uint4& r, uint32_t (&w)[4]) {
  w[0] = r.x; w[1] = r.y; w[2] = r.z; w[3] = r.w;
}
__device__ __forceinline__ void to_words(const uint2& r, uint32_t (&w)[2]) {
  w[0] = r.x; w[1] = r.y;
}
__device__ __forceinline__ void to_words(uint32_t r, uint32_t (&w)[1]) {
  w[0] = r;
}
__device__ __forceinline__ void to_words(unsigned short r,
                                         uint32_t (&w)[1]) {
  w[0] = r;
}
__device__ __forceinline__ void from_words(const uint32_t (&w)[4], uint4& r) {
  r = make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void from_words(const uint32_t (&w)[2], uint2& r) {
  r = make_uint2(w[0], w[1]);
}
__device__ __forceinline__ void from_words(const uint32_t (&w)[1],
                                           uint32_t& r) {
  r = w[0];
}
__device__ __forceinline__ void from_words(const uint32_t (&w)[1],
                                           unsigned short& r) {
  r = static_cast<unsigned short>(w[0]);
}

// element k of the words, in f32 (bf16 widens exactly), and back
template <typename T>
__device__ __forceinline__ float elem(const uint32_t* w, int k);
template <> __device__ __forceinline__ float elem<float>(const uint32_t* w,
                                                         int k) {
  return __uint_as_float(w[k]);
}
template <> __device__ __forceinline__ float elem<bf16>(const uint32_t* w,
                                                        int k) {
  return __uint_as_float(k & 1 ? w[k >> 1] & 0xffff0000u : w[k >> 1] << 16);
}
template <typename T>
__device__ __forceinline__ void put(uint32_t* w, int k, float v);
template <> __device__ __forceinline__ void put<float>(uint32_t* w, int k,
                                                       float v) {
  w[k] = __float_as_uint(v);
}
template <> __device__ __forceinline__ void put<bf16>(uint32_t* w, int k,
                                                      float v) {
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(v));
  w[k >> 1] = k & 1 ? (w[k >> 1] & 0xffffu) | (h << 16) : h;
}

__device__ __forceinline__ void cp4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes));
}

// one vector into the ring: cp.async with zero fill (16, 8 or 4 bytes), or
// a plain load and store (2 bytes: one bf16 channel a thread)
template <int BYTES>
__device__ __forceinline__ void copy_vec(void* dst, const void* src, bool ok) {
  if constexpr (BYTES == 16) {
    cp16(dst, src, ok ? 16 : 0);
  } else if constexpr (BYTES == 8) {
    cp8(dst, src, ok ? 8 : 0);
  } else if constexpr (BYTES == 4) {
    cp4(dst, src, ok ? 4 : 0);
  } else {
    *static_cast<unsigned short*>(dst) =
        ok ? __ldg(static_cast<const unsigned short*>(src)) : 0;
  }
}

// wait until at most n commit groups of this thread are pending (n < 4)
__device__ __forceinline__ void wait_pending(int n) {
  switch (n) {
    case 0: cp_wait<0>(); break;
    case 1: cp_wait<1>(); break;
    case 2: cp_wait<2>(); break;
    default: cp_wait<3>(); break;
  }
}

// 16-byte bf16 vectors keep 72 taps in registers: two blocks of 256 threads
// an SM (at most 128 registers a thread); the others three (at most 85)
template <typename T, int VEC>
__global__ void __launch_bounds__(MAX_THREADS,
                                  (sizeof(T) == 2 && VEC == 8) ? 2 : 3)
fused_dw_kernel(Args a) {
  constexpr int BYTES = VEC * sizeof(T);
  constexpr int NW = (BYTES + 3) / 4;
  typedef typename Raw<BYTES>::t R;
  const int r = a.rate, CV = a.cv, SW = a.sw, P = a.prefetch;
  const int PW = SW + 2 * r;                // ring row: pixels
  const int D = 2 * r + 1 + P;              // ring rows
  const int row_vecs = PW * CV;
  R* ring = reinterpret_cast<R*>(dyn_smem); // [D][PW][CV] vectors
  const int x0 = blockIdx.x * SW, y0 = blockIdx.y * a.th;
  const int b = blockIdx.z / a.chunks;
  const int c0 = (blockIdx.z - b * a.chunks) * CV * VEC;
  const int px = threadIdx.x / CV, cv = threadIdx.x - px * CV;
  const int c = c0 + cv * VEC;
  const bool cok = c < a.C;                 // C % VEC == 0: all VEC or none
  const int rows_out = min(a.th, a.H - y0);
  const int rows_in = rows_out + 2 * r;
  const size_t img = (size_t)a.H * a.W * a.C;
  const T* xb = static_cast<const T*>(a.x) + b * img;
  T* ob = static_cast<T*>(a.out) + b * img;

  float tap[9][VEC], sc[VEC], sh[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
#pragma unroll
    for (int t = 0; t < 9; ++t)
      tap[t][k] = cok ? a.taps[t * a.C + c + k] : 0.f;
    sc[k] = cok ? a.scale[c + k] : 0.f;
    sh[k] = cok ? a.shift[c + k] : 0.f;
  }

  // input row i of the block (image row y0 - r + i) into ring slot `slot`
  auto issue = [&](int i, int slot) {
    if (i < rows_in) {
      const int gy = y0 - r + i;
      const bool yok = gy >= 0 && gy < a.H && cok;
      const T* src = xb + ((size_t)(yok ? gy : 0) * a.W) * a.C + c;
      R* dst = ring + (size_t)slot * row_vecs + cv;
      for (int p = px; p < PW; p += SW) {
        const int gx = x0 - r + p;
        const bool ok = yok && gx >= 0 && gx < a.W;
        copy_vec<BYTES>(dst + p * CV, ok ? src + (size_t)gx * a.C : xb, ok);
      }
    }
    cp_commit();
  };

  int next = 0;                              // slot of input row 2r + P + j
  for (int i = 0; i < 2 * r + P; ++i) {
    issue(i, next);
    next = next + 1 == D ? 0 : next + 1;
  }
  const bool store = cok && x0 + px < a.W;
  int s0 = 0;                                // slot of input row j
  for (int j = 0; j < rows_out; ++j) {
    wait_pending(P - 1);                     // input row j + 2r has landed
    __syncthreads();                         // and row j - 1 is done with
    issue(j + 2 * r + P, next);
    next = next + 1 == D ? 0 : next + 1;
    if (store) {
      float acc[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
      int s = s0;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const R* row = ring + (size_t)s * row_vecs + px * CV + cv;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          uint32_t w[NW];
          to_words(row[dx * r * CV], w);
#pragma unroll
          for (int k = 0; k < VEC; ++k)
            acc[k] += elem<T>(w, k) * tap[dy * 3 + dx][k];
        }
        s += r;
        if (s >= D) s -= D;
      }
      uint32_t w[NW];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        float y = acc[k] * sc[k] + sh[k];
        if (a.relu6) y = fminf(fmaxf(y, 0.f), 6.f);
        put<T>(w, k, y);
      }
      R o;
      from_words(w, o);
      *reinterpret_cast<R*>(ob + ((size_t)(y0 + j) * a.W + x0 + px) * a.C +
                            c) = o;
    }
    s0 = s0 + 1 == D ? 0 : s0 + 1;
  }
}

template <typename T, int VEC>
int launch(Args a, int B, int threads, int smem, cudaStream_t st) {
  constexpr int BYTES = VEC * sizeof(T);
  const int r = a.rate;
  // the plan of kernels/fused_dw.py::dw_plan, checked
  if (a.sw < 1 || a.th < 1 || a.cv < 1 || a.prefetch < 1 ||
      a.prefetch > MAX_PREFETCH || threads != a.sw * a.cv ||
      threads > MAX_THREADS || a.C % VEC ||
      (long long)smem != (long long)(2 * r + 1 + a.prefetch) *
                             (a.sw + 2 * r) * a.cv * BYTES ||
      smem > SMEM_MAX)
    return ERR_PLAN;
  const int strips_x = (a.W + a.sw - 1) / a.sw;
  const int strips_y = (a.H + a.th - 1) / a.th;
  a.chunks = (a.C / VEC + a.cv - 1) / a.cv;
  if (strips_y > 65535 || (long long)B * a.chunks > 65535) return ERR_PLAN;
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)fused_dw_kernel<T, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return int(e);
  const dim3 grid(strips_x, strips_y, B * a.chunks);
  fused_dw_kernel<T, VEC><<<grid, threads, smem, st>>>(a);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns 0, one of the ERR_* codes, or the cudaError_t of the launch (the
// caller raises on non-zero).  vec: channels a vector, with C % vec == 0
// and x, out aligned to vec * sizeof(element); the rest is dw_plan's.
int fused_dw_launch(const void* x, const float* taps, const float* scale,
                    const float* shift, void* out, int B, int H, int W, int C,
                    int rate, int relu6, int x_bf16, int vec, int sw, int th,
                    int cv, int prefetch, int threads, int smem,
                    void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || rate < 1 ||
      (long long)H * W * C > (1LL << 31))
    return ERR_ARGS;
  Args a;
  a.x = x; a.taps = taps; a.scale = scale; a.shift = shift; a.out = out;
  a.H = H; a.W = W; a.C = C; a.rate = rate; a.relu6 = relu6;
  a.sw = sw; a.th = th; a.cv = cv; a.prefetch = prefetch; a.chunks = 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    switch (vec) {
      case 8: return launch<bf16, 8>(a, B, threads, smem, st);
      case 4: return launch<bf16, 4>(a, B, threads, smem, st);
      case 2: return launch<bf16, 2>(a, B, threads, smem, st);
      case 1: return launch<bf16, 1>(a, B, threads, smem, st);
    }
    return ERR_ARGS;
  }
  switch (vec) {
    case 4: return launch<float, 4>(a, B, threads, smem, st);
    case 2: return launch<float, 2>(a, B, threads, smem, st);
    case 1: return launch<float, 1>(a, B, threads, smem, st);
  }
  return ERR_ARGS;
}

const char* fused_dw_error(int code) {
  switch (code) {
    case ERR_ARGS: return "arguments the fused_dw kernel does not take";
    case ERR_PLAN: return "a launch plan the fused_dw kernel does not take";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
