// Fused eval-mode stride-1 SepConv_BN for Hopper (sm_90a).
//
// Replaces the TPU kernel deeplab_tpu/kernels/fused_mbconv.py::fused_sepconv
// (pl.pallas_call at line 208).  Per output pixel it computes
//   v   = pre_relu ? relu(x) : x
//   d   = bdw + sum_taps v[shifted] * wdw         (3x3 depthwise, dilation rate,
//                                                  SAME zero padding of v, f32)
//   d   = act_mid ? relu(d) : d, rounded to bf16  (the pointwise operand)
//   out = d @ wpw + bpw, act_out ? relu : id      (1x1 pointwise, Cin -> Cout,
//                                                  f32 accumulation)
// with both BNs folded into wdw/bdw and wpw/bpw by the caller.
//
// What bounds it on the H100.  The work is 2*Cin*Cout tensor-core flops and
// 18*Cin f32 flops per pixel against (Cin + Cout) activation values read and
// written.  With f32 activations that is Cin*Cout / (2*(Cin + Cout)) flops
// per byte: 182 for the middle flow's 728 -> 728, under the card's ~295
// ridge, so most of the Xception net's launches are bound by bytes; the exit
// flow's 1536 -> 2048 (439) is bound by the tensor cores.  A composition of
// two library calls writes the depthwise output (Cin values per pixel, up to
// 2048) to device memory and reads it back; keeping it on chip is the point
// of the kernel.
//
// Design (a simple kernel first: mma.sync, no TMA, wgmma or pipelining):
//   - a block owns 64 consecutive output pixels (over the flattened B*H*W,
//     so any H and W) and a tile of up to 256 output channels, and first
//     tabulates its pixels' 9 tap sources (-1 outside the image);
//   - it walks Cin in chunks of 32: stages the chunk of wpw (bf16, zero past
//     Cin and Cout, by 16-byte loads) in shared memory; computes the chunk's
//     depthwise for its 64 pixels in f32, one channel per thread, each tap
//     read from device memory (L1/L2) and checked against the image edge, so
//     every rate works however large against the map (the TPU kernel's halo
//     comes only from the neighbouring row tiles); writes the bf16 result as
//     the A operand; then that chunk's share of the pointwise accumulates in
//     f32 registers;
//   - bias, the output activation and the cast once at the end.
// The depthwise is recomputed once per output-channel tile (at most 8 times,
// for Cout = 2048): 18 f32 flops against 512 tensor-core flops per (pixel,
// input channel) and tile.  Blocks are independent and run in any order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BM = 64;                      // output pixels per block
constexpr int CK = 32;                      // input channels per chunk
constexpr int NWARPS = 8, NTHREADS = 32 * NWARPS;
constexpr int PSTEP = NTHREADS / CK;        // pixels in flight per pass
constexpr int LD = CK + 8;                  // bf16 row stride of the A tile

struct Args {
  const void* x;               // (B, H, W, Cin) f32 or bf16
  const float* wdw;            // (9, Cin), (dy, dx) row-major
  const float* bdw;            // (Cin)
  const __nv_bfloat16* wpw;    // (Cin, Cout)
  const float* bpw;            // (Cout)
  void* out;                   // (B, H, W, Cout), dtype of x
  int H, W, Cin, Cout, rate, pre_relu, act_mid, act_out;
  int P;                       // B * H * W
};

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float ld_x(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld_x(const __nv_bfloat16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

// Four 8x8 bf16 tiles of a k-major (k, n) shared-memory matrix, transposed
// into mma.sync B fragments: lanes 8i..8i+7 give the row addresses of tile i.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// NT: pointwise n-tiles (of 8 output channels) per warp; 8 warps = 4 m-tiles
// (16 pixels each) x 2 interleaved n-tile groups, so a block owns 16*NT
// output channels.  The tile's tap table (the 9 neighbours of each of its
// 64 pixels, -1 outside the image) is built once; every global load is
// unconditional (an out-of-range tap reads pixel 0 and is then zeroed), so
// a thread issues its loads back to back.
template <typename T, int NT>
__global__ void __launch_bounds__(NTHREADS, 2)
fused_sepconv_kernel(const Args a) {
  constexpr int BN = 16 * NT;
  constexpr int LDB = BN + 8;                // bf16 row stride of the wpw chunk
  constexpr int VECS = CK * BN / 8;          // 16-byte vectors per wpw chunk
  __shared__ __align__(16) __nv_bfloat16 as[BM * LD];   // depthwise, (m, k)
  __shared__ __align__(16) __nv_bfloat16 bs[CK * LDB];  // wpw chunk, (k, n)
  __shared__ int taps[BM * 9];                          // (pixel, dx*3 + dy)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int mw = warp & 3, ng = warp >> 2;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int n_tiles = min(BN, a.Cout - n0) / 8;
  const int r = a.rate;
  const T* x = static_cast<const T*>(a.x);
  const int c = tid % CK;                   // this thread's chunk channel

  for (int i = tid; i < BM * 9; i += NTHREADS) {
    const int p = i / 9, q = i % 9, m = m0 + p;
    int src = -1;
    if (m < a.P) {
      const int HW = a.H * a.W;
      const int b = m / HW, rem = m - b * HW;
      const int y = rem / a.W + (q % 3 - 1) * r, xx = rem % a.W + (q / 3 - 1) * r;
      if (y >= 0 && y < a.H && xx >= 0 && xx < a.W) src = b * HW + y * a.W + xx;
    }
    taps[i] = src;
  }
  __syncthreads();

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;

  for (int c0 = 0; c0 < a.Cin; c0 += CK) {
    // the wpw chunk, k-major, by 16-byte vectors (Cout % 8 == 0); zero past
    // Cin and Cout
#pragma unroll
    for (int j = 0; j < (VECS + NTHREADS - 1) / NTHREADS; ++j) {
      const int v = tid + j * NTHREADS;
      if (v < VECS) {
        const int k = v / (BN / 8), n = (v % (BN / 8)) * 8;
        const bool ok = c0 + k < a.Cin && n0 + n < a.Cout;
        uint4 w = __ldg(reinterpret_cast<const uint4*>(
            a.wpw + (ok ? size_t(c0 + k) * a.Cout + n0 + n : 0)));
        if (!ok) w = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(bs + k * LDB + n) = w;
      }
    }

    // depthwise in f32 (dx outer, dy inner: the plain version's order)
    const int ch = c0 + c;
    const bool live = ch < a.Cin;
    const T* xc = x + (live ? ch : 0);
    float w9[9];
#pragma unroll
    for (int q = 0; q < 9; ++q) w9[q] = __ldg(a.wdw + q * a.Cin + (live ? ch : 0));
    const float bias = __ldg(a.bdw + (live ? ch : 0));
#pragma unroll 2
    for (int j = 0; j < BM / PSTEP; ++j) {
      const int p = tid / CK + j * PSTEP;
      float v[9];
#pragma unroll
      for (int q = 0; q < 9; ++q) {          // q = dx*3 + dy
        const int src = taps[p * 9 + q];
        const float t = ld_x(xc + size_t(src < 0 ? 0 : src) * a.Cin);
        v[q] = src < 0 ? 0.f : t;
      }
      float s = bias;
#pragma unroll
      for (int q = 0; q < 9; ++q) {
        const float t = a.pre_relu ? fmaxf(v[q], 0.f) : v[q];
        s += t * w9[(q % 3) * 3 + q / 3];    // wdw rows are dy*3 + dx
      }
      if (a.act_mid) s = fmaxf(s, 0.f);
      as[p * LD + c] = __float2bfloat16(live && m0 + p < a.P ? s : 0.f);
    }
    __syncthreads();

    // pointwise: acc[p][n] += as[p] . bs[:, n] over this chunk
#pragma unroll
    for (int kk = 0; kk < CK; kk += 16) {
      const __nv_bfloat16* ar0 = as + (mw * 16 + (lane >> 2)) * LD + kk + 2 * (lane & 3);
      const __nv_bfloat16* ar1 = ar0 + 8 * LD;
      const uint32_t af[4] = {mbconv::ld32(ar0), mbconv::ld32(ar1),
                              mbconv::ld32(ar0 + 8), mbconv::ld32(ar1 + 8)};
      const int krow = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        const int nta = ng + 2 * j, ntb = nta + 2;
        if (nta < n_tiles) {
          uint32_t b[4];
          ldsm_x4_trans(b, bs + krow * LDB + (lane < 16 ? nta : ntb) * 8);
          mbconv::mma16816(acc[j], af, b[0], b[1]);
          if (ntb < n_tiles) mbconv::mma16816(acc[j + 1], af, b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }

  T* out = static_cast<T*>(a.out);
  mbconv::for_each_acc<NT>(acc, mw * 16, ng, 2, n_tiles,
                           [&](int row, int n, float v) {
    const int m = m0 + row;
    if (m >= a.P) return;
    v += a.bpw[n0 + n];
    if (a.act_out) v = fmaxf(v, 0.f);
    out[size_t(m) * a.Cout + n0 + n] = from_f32<T>(v);
  });
}

template <typename T, int NT>
cudaError_t launch_nt(const Args& a, cudaStream_t stream) {
  constexpr int BN = 16 * NT;
  const dim3 grid((a.P + BM - 1) / BM, (a.Cout + BN - 1) / BN);
  fused_sepconv_kernel<T, NT><<<grid, NTHREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const Args& a, cudaStream_t stream) {
  if (a.Cout <= 64) return launch_nt<T, 4>(a, stream);
  if (a.Cout <= 128) return launch_nt<T, 8>(a, stream);
  return launch_nt<T, 16>(a, stream);
}

}  // namespace

extern "C" {

// Returns 0 or the cudaError_t of the launch (the caller raises on non-zero).
int fused_sepconv_launch(const void* x, const void* wdw, const void* bdw,
                         const void* wpw, const void* bpw, void* out, int B,
                         int H, int W, int Cin, int Cout, int rate,
                         int pre_relu, int act_mid, int act_out, int x_bf16,
                         void* stream) {
  const long long P = (long long)B * H * W;
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || Cout % 8 ||
      rate < 1 || P >= (1LL << 31))
    return int(cudaErrorInvalidValue);
  Args a;
  a.x = x;
  a.wdw = static_cast<const float*>(wdw);
  a.bdw = static_cast<const float*>(bdw);
  a.wpw = static_cast<const __nv_bfloat16*>(wpw);
  a.bpw = static_cast<const float*>(bpw);
  a.out = out;
  a.H = H; a.W = W; a.Cin = Cin; a.Cout = Cout; a.rate = rate;
  a.pre_relu = pre_relu; a.act_mid = act_mid; a.act_out = act_out;
  a.P = int(P);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = x_bf16 ? launch_t<__nv_bfloat16>(a, s) : launch_t<float>(a, s);
  return int(e);
}

const char* fused_sepconv_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
