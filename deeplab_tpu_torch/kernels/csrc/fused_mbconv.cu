// Fused eval-mode inverted-residual (MBConv) block for Hopper (sm_90a).
//
// Replaces the TPU kernel deeplab_tpu/kernels/fused_mbconv.py::fused_mbconv
// (pl.pallas_call at line 121).  Per output pixel it computes
//   e   = relu6(x @ w1 + b1)                      (1x1 expand, Cin -> Ce)
//   d   = relu6(bdw + sum_taps e[shifted] * wdw)  (3x3 depthwise, dilation rate,
//                                                  SAME zero padding of e)
//   out = d @ w2 + b2 [+ x]                       (1x1 project, Ce -> Cout)
// with BN folded into w1/b1, wdw/bdw and w2/b2 by the caller.
//
// What bounds it on the H100.  At the main path's shapes (64x64 maps, Ce up
// to 960) the work is ~2*Ce*(Cin+Cout) tensor-core flops plus 18*Ce CUDA-core
// flops per pixel, against (Cin+Cout)*4 bytes of f32 input and output per
// pixel: ~2,300 flops per byte for the widest block, far above the card's
// ~295 flops/byte ridge, so the block is compute-bound once the 6x-expanded
// tensor stays on chip.  An unfused composition would write and re-read that
// tensor (Ce*4 bytes per pixel, several times); keeping it out of device
// memory is the point of the kernel.
//
// Design.  The TPU kernel keeps an 8-row strip of the expanded tensor in VMEM
// (megabytes for Ce = 960); a block here has 227 KB of shared memory.  The
// depthwise conv is per channel, so the expanded channels tile exactly:
//   - each block owns one 8x8 output tile of one image and stages the x halo
//     tile ((8+2*rate)^2 pixels x Cin, as bf16: the matmul operand) once;
//   - it walks Ce in chunks of 32: expand (mma.sync bf16, f32 accumulate) over
//     the halo pixels -> relu6 -> zero outside the image -> shared memory;
//     the depthwise taps in f32 -> relu6 -> bf16 in shared memory; then that
//     chunk's share of the project product accumulates in f32 registers;
//   - bias, residual (in f32, from the unrounded x) and the output cast once
//     at the end.
// The halo pixels' expand is recomputed by neighbouring tiles (1.6x at rate 1,
// 2.3x at rate 2, 4x at rate 4): the price of a tile small enough for shared
// memory and a 64 x Cout f32 accumulator in registers.  mma.sync with plain
// shared-memory fragment loads, no TMA, wgmma or pipelining: a simple kernel
// first.  Blocks are independent and run in any order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int TH = 8, TW = 8, NO = TH * TW;  // output tile (pixels)
constexpr int CK = 32;                       // expanded channels per chunk
constexpr int NWARPS = 8, NTHREADS = 32 * NWARPS;

struct Args {
  const void* x;               // (B, H, W, Cin) f32 or bf16
  const __nv_bfloat16* w1;     // (Cin, Ce)
  const float* b1;             // (Ce)
  const float* wdw;            // (9, Ce)
  const float* bdw;            // (Ce)
  const __nv_bfloat16* w2;     // (Ce, Cout)
  const float* b2;             // (Cout)
  void* out;                   // (B, H, W, Cout), dtype of x
  int B, H, W, Cin, Ce, Cout, rate, skip;
  int tiles_x;
  int cin_p, xs_ld, nh, nh_p, hw;  // padded Cin, row stride, halo geometry
};

constexpr int ES_LD = CK + 4;  // f32 row stride of the expanded chunk
constexpr int DS_LD = CK + 8;  // bf16 row stride of the depthwise output

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

struct Smem {  // byte offsets into dynamic shared memory
  size_t es, wds, b1s, bds, xs, w1s, ds, w2s, total;
};

__host__ __device__ inline Smem smem_layout(const Args& a) {
  Smem s;
  size_t o = 0;
  s.es = o;  o += align16(sizeof(float) * a.nh_p * ES_LD);
  s.wds = o; o += align16(sizeof(float) * 9 * CK);
  s.b1s = o; o += align16(sizeof(float) * CK);
  s.bds = o; o += align16(sizeof(float) * CK);
  s.xs = o;  o += align16(2 * size_t(a.nh_p) * a.xs_ld);
  s.w1s = o; o += align16(2 * size_t(CK) * a.xs_ld);
  s.ds = o;  o += align16(2 * size_t(NO) * DS_LD);
  s.w2s = o; o += align16(2 * size_t(a.Cout) * DS_LD);
  s.total = o;
  return s;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
__device__ __forceinline__ __nv_bfloat16 to_bf16(float v) { return __float2bfloat16(v); }
__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 v) { return v; }

using mbconv::ld32;
using mbconv::mma16816;
using mbconv::relu6;

// NT: project n-tiles (of 8 output channels) per warp; 8 warps = 4 m-tiles
// (16 pixels each) x 2 interleaved n-tile groups.
template <typename T, int NT>
__global__ void __launch_bounds__(NTHREADS, 1)
fused_mbconv_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem L = smem_layout(a);
  float* es = reinterpret_cast<float*>(smem + L.es);
  float* wds = reinterpret_cast<float*>(smem + L.wds);
  float* b1s = reinterpret_cast<float*>(smem + L.b1s);
  float* bds = reinterpret_cast<float*>(smem + L.bds);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + L.xs);
  __nv_bfloat16* w1s = reinterpret_cast<__nv_bfloat16*>(smem + L.w1s);
  __nv_bfloat16* ds = reinterpret_cast<__nv_bfloat16*>(smem + L.ds);
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem + L.w2s);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y;
  const int ty0 = (blockIdx.x / a.tiles_x) * TH, tx0 = (blockIdx.x % a.tiles_x) * TW;
  const int r = a.rate, hw = a.hw;
  const T* x = static_cast<const T*>(a.x);
  const size_t img = size_t(b) * a.H * a.W;

  // halo pixel hp -> image pixel index, or -1 outside the image / padding
  auto halo_pix = [&](int hp) -> int {
    if (hp >= a.nh) return -1;
    const int gy = ty0 - r + hp / hw, gx = tx0 - r + hp % hw;
    if (gy < 0 || gy >= a.H || gx < 0 || gx >= a.W) return -1;
    return gy * a.W + gx;
  };

  // stage the x halo tile as bf16 (zero outside the image and past Cin)
  for (int i = tid; i < a.nh_p * a.cin_p; i += NTHREADS) {
    const int hp = i / a.cin_p, k = i % a.cin_p;
    const int pix = halo_pix(hp);
    __nv_bfloat16 v = __float2bfloat16(0.f);
    if (pix >= 0 && k < a.Cin) v = to_bf16(x[(img + pix) * a.Cin + k]);
    xs[hp * a.xs_ld + k] = v;
  }

  const int n_tiles_out = a.Cout / 8;
  const int mw = warp & 3;  // project m-tile of this warp
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;

  for (int c0 = 0; c0 < a.Ce; c0 += CK) {
    // this chunk's weights; channels past Ce are zero and contribute nothing
    for (int i = tid; i < CK * a.cin_p; i += NTHREADS) {
      const int n = i % CK, k = i / CK;
      __nv_bfloat16 v = __float2bfloat16(0.f);
      if (c0 + n < a.Ce && k < a.Cin) v = a.w1[size_t(k) * a.Ce + c0 + n];
      w1s[n * a.xs_ld + k] = v;
    }
    for (int i = tid; i < a.Cout * CK; i += NTHREADS) {
      const int n = i % a.Cout, k = i / a.Cout;
      __nv_bfloat16 v = __float2bfloat16(0.f);
      if (c0 + k < a.Ce) v = a.w2[size_t(c0 + k) * a.Cout + n];
      w2s[n * DS_LD + k] = v;
    }
    for (int i = tid; i < 11 * CK; i += NTHREADS) {
      const int c = i % CK, row = i / CK;
      const bool in = c0 + c < a.Ce;
      if (row < 9) wds[row * CK + c] = in ? a.wdw[row * a.Ce + c0 + c] : 0.f;
      else if (row == 9) b1s[c] = in ? a.b1[c0 + c] : 0.f;
      else bds[c] = in ? a.bdw[c0 + c] : 0.f;
    }
    __syncthreads();

    // expand: es[hp][n] = relu6(xs[hp] . w1s[n] + b1), 0 outside the image
    for (int mt = warp; mt < a.nh_p / 16; mt += NWARPS) {
      float c[CK / 8][4];
#pragma unroll
      for (int nt = 0; nt < CK / 8; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) c[nt][q] = 0.f;
      const __nv_bfloat16* ar0 = xs + (mt * 16 + g) * a.xs_ld + 2 * t;
      const __nv_bfloat16* ar1 = ar0 + 8 * a.xs_ld;
      for (int kk = 0; kk < a.cin_p; kk += 16) {
        const uint32_t af[4] = {ld32(ar0 + kk), ld32(ar1 + kk),
                                ld32(ar0 + kk + 8), ld32(ar1 + kk + 8)};
#pragma unroll
        for (int nt = 0; nt < CK / 8; ++nt) {
          const __nv_bfloat16* br = w1s + (nt * 8 + g) * a.xs_ld + kk + 2 * t;
          mma16816(c[nt], af, ld32(br), ld32(br + 8));
        }
      }
      const int h0 = mt * 16 + g, h1 = h0 + 8;
      const bool v0 = halo_pix(h0) >= 0, v1 = halo_pix(h1) >= 0;
#pragma unroll
      for (int nt = 0; nt < CK / 8; ++nt) {
        const int n = nt * 8 + 2 * t;
        es[h0 * ES_LD + n] = v0 ? relu6(c[nt][0] + b1s[n]) : 0.f;
        es[h0 * ES_LD + n + 1] = v0 ? relu6(c[nt][1] + b1s[n + 1]) : 0.f;
        es[h1 * ES_LD + n] = v1 ? relu6(c[nt][2] + b1s[n]) : 0.f;
        es[h1 * ES_LD + n + 1] = v1 ? relu6(c[nt][3] + b1s[n + 1]) : 0.f;
      }
    }
    __syncthreads();

    // depthwise taps in f32 (dx outer, dy inner), relu6, bf16 for the project
    for (int i = tid; i < NO * CK; i += NTHREADS) {
      const int c = i % CK, p = i / CK;
      const int oy = p / TW, ox = p % TW;
      float s = bds[c];
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const int hp = (oy + k * r) * hw + ox + j * r;
          s += es[hp * ES_LD + c] * wds[(k * 3 + j) * CK + c];
        }
      ds[p * DS_LD + c] = __float2bfloat16(relu6(s));
    }
    __syncthreads();

    // project: acc[p][n] += ds[p] . w2s[n] over this chunk
#pragma unroll
    for (int kk = 0; kk < CK; kk += 16) {
      const __nv_bfloat16* ar0 = ds + (mw * 16 + g) * DS_LD + kk + 2 * t;
      const __nv_bfloat16* ar1 = ar0 + 8 * DS_LD;
      const uint32_t af[4] = {ld32(ar0), ld32(ar1), ld32(ar0 + 8), ld32(ar1 + 8)};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int nt = (warp >> 2) + 2 * j;
        if (nt < n_tiles_out) {
          const __nv_bfloat16* br = w2s + (nt * 8 + g) * DS_LD + kk + 2 * t;
          mma16816(acc[j], af, ld32(br), ld32(br + 8));
        }
      }
    }
    __syncthreads();
  }

  // epilogue: bias, residual in f32, cast, store
  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int nt = (warp >> 2) + 2 * j;
    if (nt >= n_tiles_out) continue;
    const int n = nt * 8 + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = mw * 16 + g + 8 * h;
      const int gy = ty0 + p / TW, gx = tx0 + p % TW;
      if (gy >= a.H || gx >= a.W) continue;
      const size_t pix = img + size_t(gy) * a.W + gx;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float v = acc[j][2 * h + q] + a.b2[n + q];
        if (a.skip) v += to_f32(x[pix * a.Cin + n + q]);
        out[pix * a.Cout + n + q] = from_f32<T>(v);
      }
    }
  }
}

template <typename T, int NT>
cudaError_t launch_nt(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_layout(a).total;
  if (smem > 232448) return cudaErrorInvalidConfiguration;
  auto kern = fused_mbconv_kernel<T, NT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  const int tiles_y = (a.H + TH - 1) / TH;
  kern<<<dim3(a.tiles_x * tiles_y, a.B), NTHREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const Args& a, cudaStream_t stream) {
  const int need = (a.Cout / 8 + 1) / 2;  // n-tiles per warp group
  if (need <= 2) return launch_nt<T, 2>(a, stream);
  if (need <= 4) return launch_nt<T, 4>(a, stream);
  if (need <= 6) return launch_nt<T, 6>(a, stream);
  if (need <= 10) return launch_nt<T, 10>(a, stream);
  if (need <= 20) return launch_nt<T, 20>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Returns 0 or the cudaError_t of the launch (the caller raises on non-zero).
int fused_mbconv_launch(const void* x, const void* w1, const void* b1,
                        const void* wdw, const void* bdw, const void* w2,
                        const void* b2, void* out, int B, int H, int W, int Cin,
                        int Ce, int Cout, int rate, int skip, int x_bf16,
                        void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Ce <= 0 || Cout <= 0 ||
      Cout % 8 || rate < 1 || (skip && Cin != Cout))
    return int(cudaErrorInvalidValue);
  Args a;
  a.x = x;
  a.w1 = static_cast<const __nv_bfloat16*>(w1);
  a.b1 = static_cast<const float*>(b1);
  a.wdw = static_cast<const float*>(wdw);
  a.bdw = static_cast<const float*>(bdw);
  a.w2 = static_cast<const __nv_bfloat16*>(w2);
  a.b2 = static_cast<const float*>(b2);
  a.out = out;
  a.B = B; a.H = H; a.W = W; a.Cin = Cin; a.Ce = Ce; a.Cout = Cout;
  a.rate = rate; a.skip = skip;
  a.tiles_x = (W + TW - 1) / TW;
  a.cin_p = (Cin + 15) / 16 * 16;
  a.xs_ld = a.cin_p + 8;
  a.hw = TW + 2 * rate;
  a.nh = (TH + 2 * rate) * a.hw;
  a.nh_p = (a.nh + 15) / 16 * 16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = x_bf16 ? launch_t<__nv_bfloat16>(a, s) : launch_t<float>(a, s);
  return int(e);
}

const char* fused_mbconv_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
