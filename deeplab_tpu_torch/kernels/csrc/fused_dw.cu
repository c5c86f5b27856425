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
// 3.35 TB/s.  A composition of a grouped conv, the affine and the clamp moves
// the activation through device memory three times; the kernel reads it once
// and writes it once.
//
// Design (a simple kernel first): a block owns an 8 x 32 output tile of one
// image and a chunk of up to 32 channels.  It stages its taps and affine, then
// the input tile with its halo of `rate` pixels on each side (zero outside the
// image) in shared memory, 4 channels a thread by 16-byte (f32) or 8-byte
// (bf16) loads when C % 4 == 0 (one channel a thread otherwise), and then each
// thread computes 4 (or 1) channels of one output pixel from shared memory.
// Neighbouring threads take neighbouring channels, so loads and stores are
// coalesced and the shared-memory reads are conflict-free.  The chunk shrinks
// when a large rate's halo would not fit in shared memory.  Blocks are
// independent and run in any order.
//
// Rounding points are the plain version's (kernels/fused_dw.py): the 9
// products summed in f32 in its order, then the affine, each operation
// rounded on its own (this file is built with -fmad=false), so the two agree
// bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

extern __shared__ __align__(16) unsigned char dyn_smem[];

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TH = 8, TW = 32;              // output tile
constexpr int CMAX = 32;                    // channels per block
constexpr int NTHREADS = 256;
constexpr int SMEM_MAX = 227 * 1024;

enum { ERR_ARGS = 100001, ERR_SMEM = 100002 };

struct Args {
  const void* x;            // (B, H, W, C)
  const float* taps;        // (3, 3, C) = (9, C), (dy, dx) row-major
  const float* scale;       // (C)
  const float* shift;       // (C)
  void* out;                // (B, H, W, C), dtype of x
  int H, W, C, rate, relu6, CC, tiles_x;
};

template <int VEC> struct Vec { float v[VEC]; };

__device__ __forceinline__ void load(const float* p, Vec<4>& o) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  o.v[0] = t.x; o.v[1] = t.y; o.v[2] = t.z; o.v[3] = t.w;
}
__device__ __forceinline__ void load(const bf16* p, Vec<4>& o) {
  const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  o.v[0] = __low2float(a); o.v[1] = __high2float(a);
  o.v[2] = __low2float(b); o.v[3] = __high2float(b);
}
__device__ __forceinline__ void load(const float* p, Vec<1>& o) {
  o.v[0] = __ldg(p);
}
__device__ __forceinline__ void load(const bf16* p, Vec<1>& o) {
  o.v[0] = __bfloat162float(
      __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

__device__ __forceinline__ void store(float* p, const Vec<4>& o) {
  *reinterpret_cast<float4*>(p) = make_float4(o.v[0], o.v[1], o.v[2], o.v[3]);
}
__device__ __forceinline__ void store(bf16* p, const Vec<4>& o) {
  uint2 t;
  *reinterpret_cast<__nv_bfloat162*>(&t.x) =
      __floats2bfloat162_rn(o.v[0], o.v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&t.y) =
      __floats2bfloat162_rn(o.v[2], o.v[3]);
  *reinterpret_cast<uint2*>(p) = t;
}
__device__ __forceinline__ void store(float* p, const Vec<1>& o) {
  *p = o.v[0];
}
__device__ __forceinline__ void store(bf16* p, const Vec<1>& o) {
  *p = __float2bfloat16_rn(o.v[0]);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(NTHREADS) fused_dw_kernel(Args a) {
  const int CC = a.CC, CV = CC / VEC, r = a.rate;
  const int SW = TW + 2 * r, SH = TH + 2 * r;
  float* tp = reinterpret_cast<float*>(dyn_smem);  // [9][CC], scale, shift
  float* tile = tp + 11 * CC;                       // [SH][SW][CC]
  const int b = blockIdx.z, c0 = blockIdx.y * CC;
  const int y0 = (blockIdx.x / a.tiles_x) * TH;
  const int x0 = (blockIdx.x % a.tiles_x) * TW;
  for (int i = threadIdx.x; i < 11 * CC; i += NTHREADS) {
    const int k = i / CC, c = c0 + i % CC;
    float v = 0.f;
    if (c < a.C)
      v = k < 9 ? a.taps[k * a.C + c] : (k == 9 ? a.scale[c] : a.shift[c]);
    tp[i] = v;
  }
  const T* xb = static_cast<const T*>(a.x) + (size_t)b * a.H * a.W * a.C;
  for (int i = threadIdx.x; i < SH * SW * CV; i += NTHREADS) {
    const int cv = i % CV, pix = i / CV;
    const int sx = pix % SW, sy = pix / SW;
    const int gy = y0 - r + sy, gx = x0 - r + sx, c = c0 + cv * VEC;
    Vec<VEC> v;
    if (gy >= 0 && gy < a.H && gx >= 0 && gx < a.W && c < a.C) {
      load(xb + ((size_t)gy * a.W + gx) * a.C + c, v);
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) v.v[k] = 0.f;
    }
    float* d = tile + (size_t)pix * CC + cv * VEC;
#pragma unroll
    for (int k = 0; k < VEC; ++k) d[k] = v.v[k];
  }
  __syncthreads();
  T* ob = static_cast<T*>(a.out) + (size_t)b * a.H * a.W * a.C;
  for (int i = threadIdx.x; i < TH * TW * CV; i += NTHREADS) {
    const int cv = i % CV, pix = i / CV;
    const int ox = pix % TW, oy = pix / TW, cc = cv * VEC;
    const int gy = y0 + oy, gx = x0 + ox, c = c0 + cc;
    if (gy >= a.H || gx >= a.W || c >= a.C) continue;
    Vec<VEC> acc;
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc.v[k] = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float* s =
            tile + ((size_t)(oy + dy * r) * SW + ox + dx * r) * CC + cc;
        const float* t = tp + (dy * 3 + dx) * CC + cc;
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc.v[k] += s[k] * t[k];
      }
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      float y = acc.v[k] * tp[9 * CC + cc + k] + tp[10 * CC + cc + k];
      if (a.relu6) y = fminf(fmaxf(y, 0.f), 6.f);
      acc.v[k] = y;
    }
    store(ob + ((size_t)gy * a.W + gx) * a.C + c, acc);
  }
}

size_t smem_bytes(int CC, int rate) {
  return sizeof(float) * (size_t)CC *
         (11 + (size_t)(TH + 2 * rate) * (TW + 2 * rate));
}

template <typename T, int VEC>
int launch(Args a, int B, cudaStream_t st) {
  int CC = a.C < CMAX ? (a.C + VEC - 1) / VEC * VEC : CMAX;
  while (smem_bytes(CC, a.rate) > (size_t)SMEM_MAX && CC > VEC) {
    CC = (CC / 2 + VEC - 1) / VEC * VEC;
  }
  const size_t smem = smem_bytes(CC, a.rate);
  if (smem > (size_t)SMEM_MAX) return ERR_SMEM;
  a.CC = CC;
  a.tiles_x = (a.W + TW - 1) / TW;
  const int tiles_y = (a.H + TH - 1) / TH;
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)fused_dw_kernel<T, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return int(e);
  const dim3 grid(a.tiles_x * tiles_y, (a.C + CC - 1) / CC, B);
  fused_dw_kernel<T, VEC><<<grid, NTHREADS, smem, st>>>(a);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns 0, one of the ERR_* codes, or the cudaError_t of the launch (the
// caller raises on non-zero).  vec4: C % 4 == 0 and x, out 16-byte aligned.
int fused_dw_launch(const void* x, const float* taps, const float* scale,
                    const float* shift, void* out, int B, int H, int W, int C,
                    int rate, int relu6, int x_bf16, int vec4, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || rate < 1 || B > 65535 ||
      (vec4 && C % 4) || (long long)H * W > (1LL << 30))
    return ERR_ARGS;
  Args a;
  a.x = x; a.taps = taps; a.scale = scale; a.shift = shift; a.out = out;
  a.H = H; a.W = W; a.C = C; a.rate = rate; a.relu6 = relu6;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return vec4 ? launch<bf16, 4>(a, B, st) : launch<bf16, 1>(a, B, st);
  return vec4 ? launch<float, 4>(a, B, st) : launch<float, 1>(a, B, st);
}

const char* fused_dw_error(int code) {
  switch (code) {
    case ERR_ARGS: return "arguments the fused_dw kernel does not take";
    case ERR_SMEM: return "the halo tile does not fit in shared memory";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
