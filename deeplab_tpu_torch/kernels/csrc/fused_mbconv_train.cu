// Training-mode inverted-residual (MBConv) block for Hopper (sm_90a): the five
// phases of the forward and the custom backward.
//
// Replaces the TPU kernel deeplab_tpu/kernels/fused_mbconv_train.py::block_train,
// one kernel (plus a deterministic reduction) per pl.pallas_call phase:
//   F1  (_run_f1, :254)   per-channel sum / sum of squares of eq = q(x @ w1)
//   F2  (_run_f2, :302)   dq = q(depthwise(aq)), aq = relu6(q(q(eq*a1)+c1)) on a
//                         halo (zero outside the image: SAME pads the depthwise
//                         input), and dq's sums
//   F3  (_run_f3, :345)   y_raw = q(relu6(q(q(dq*a2)+c2)) @ w2)
//   B2  (_run_b2, :404)   gy = gA3*g + k0 + k1*y_raw; ddh = (q(gy) @ w2^T) *
//                         relu6'(v2) (saved, f32); T1 = sum ddh, T2 = sum
//                         ddh*dhat; dW2 = sum q(b) (x) q(gy)
//   B34 (_run_b34, :535)  dd = a2*ddh + m0 + m1*dq on a halo; da = transposed
//                         taps of dd; dv1 = da*relu6'(v1); U1/U2 sums, dWdw,
//                         dx main = q(q(a1*dv1) @ w1^T), dW1^T = sum q(a1*dv1) (x) x
// (q rounds to bf16.)  The glue between phases stays in PyTorch.
//
// What bounds it on the H100.  Per pixel a block of width Ce does about
// 2*Ce*(Cin+Cout) tensor-core flops per phase that multiplies, 18*Ce f32 tap
// flops in F2 and B34, and moves (Cin or Cout)*2 bytes of narrow activations
// plus the Ce-wide dq (bf16) and ddh (f32) that the design saves.  At Ce = 6*Cin
// the bf16 products lie above the card's ~295 flop/byte ridge, while F3 and
// the saved-tensor reads sit below it: each phase's bound is the larger of
// its bytes at 3.35 TB/s and its flops at 989 (bf16) and 67 (f32) TFLOP/s.
//
// Design (simple first, no TMA/wgmma/pipelining).  The TPU phases walk 8-row
// planes with a VMEM-resident accumulator carried across a sequential grid;
// here blocks run in any order, so:
//   - halo phases (F2, B34) give each block one 8x8 output tile of one image,
//     stage x with a +-rate halo once as bf16, and walk Ce in chunks of 32
//     (expand with mma.sync bf16 / f32 accumulate -> shared memory -> taps in
//     f32), as fused_mbconv.cu does; B34 accumulates dx over all of Ce in f32
//     registers and rounds once;
//   - pixel-local phases (F1, F3) take groups of 64 consecutive pixels;
//   - weight gradients (dW2 in B2, dW1^T after B34) give each block a chunk of
//     32 expanded channels and a strided share of the pixel groups, with the
//     chunk's gradient in registers;
//   - every sum over pixels is written as per-block partials and reduced by a
//     second pass in a fixed order: no float atomics, so results repeat bit for
//     bit from run to run.
// B2 first writes gyq = q(gy) once (pixels x Cout, bf16), then reads it by
// 16-byte copies in every chunk; it saves ddh (f32) so that B34 needs neither
// g nor y_raw nor a second product with w2 on its halo; B34 saves q(a1*dv1)
// for the dW1^T product.  Built with
// -fmad=false: the elementwise chains round where the plain versions round.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;
using mbconv::for_each_acc;
using mbconv::mma_tile;
using mbconv::mma_tile_kn;
using mbconv::qbf;
using mbconv::relu6;

constexpr int TH = 8, TW = 8, NO = TH * TW;  // halo phases: output tile
constexpr int CK = 32;                       // expanded channels per chunk
constexpr int GP = 64;                       // pixel-local phases: pixels/group
constexpr int NWARPS = 8, NTHREADS = 32 * NWARPS;
constexpr int F_LD = CK + 4;                 // f32 (pixel, channel) row stride
constexpr int H_LD = CK + 8;                 // bf16 (pixel, channel) row stride
constexpr int P_LD = GP + 8;                 // bf16 (channel, pixel) row stride
constexpr size_t SMEM_MAX = 232448;
constexpr int RED_Y = 8;                     // row groups of the reduction
constexpr int TARGET_CTAS = 264;             // two per SM of the H100's 132

enum Phase { F1 = 0, F2 = 1, F3 = 2, B2 = 3, B34 = 4 };

struct Args {
  const bf16 *x, *w1, *w2, *dq, *g, *y;
  const float *a1, *c1, *wdw, *a2, *c2, *mu1, *rstd1, *mu2, *rstd2;
  const float *gA3, *k0, *k1, *m0, *m1, *ddh;
  bf16 *dq_out, *y_out, *dxp, *dvl, *gyq;
  float *ddh_out, *part, *part2;
  int B, H, W, Cin, Ce, Cout, rate;
  long long P;
  int n_groups, n_chunks, splits, tiles_x, tiles_y, n_tiles;
  int cin_p, xs_ld, hw, nh, nh_p, cout_k, cout_ld;
};

struct Bump {
  size_t o = 0;
  __host__ __device__ size_t take(size_t bytes) {
    const size_t r = o;
    o += (bytes + 15) & ~size_t(15);
    return r;
  }
};

// shared-memory layouts (byte offsets), one per kernel
struct LF1 { size_t xs, w1s, es, total; };
struct LF2 { size_t xs, w1s, es, wds, ds, total; };
struct LF3 { size_t bs, w2s, total; };
struct LB2 { size_t gyq, w2c, bqT, dqf, t1s, t2s, total; };
struct LB34 { size_t xs, w1s, w1c, es, dds, eqc, dvs, wds, reds, total; };
struct LWG { size_t dvT, xT, total; };

__host__ __device__ inline LF1 lay_f1(const Args& a) {
  Bump b; LF1 l;
  l.xs = b.take(2 * size_t(GP) * a.xs_ld);
  l.w1s = b.take(2 * size_t(CK) * a.xs_ld);
  l.es = b.take(4 * size_t(GP) * F_LD);
  l.total = b.o;
  return l;
}
__host__ __device__ inline LF2 lay_f2(const Args& a) {
  Bump b; LF2 l;
  l.xs = b.take(2 * size_t(a.nh_p) * a.xs_ld);
  l.w1s = b.take(2 * size_t(CK) * a.xs_ld);
  l.es = b.take(4 * size_t(a.nh_p) * F_LD);
  l.wds = b.take(4 * 9 * CK);
  l.ds = b.take(4 * size_t(NO) * F_LD);
  l.total = b.o;
  return l;
}
__host__ __device__ inline LF3 lay_f3(const Args& a) {
  Bump b; LF3 l;
  l.bs = b.take(2 * size_t(GP) * H_LD);
  l.w2s = b.take(2 * size_t(a.Cout) * H_LD);
  l.total = b.o;
  return l;
}
__host__ __device__ inline LB2 lay_b2(const Args& a) {
  Bump b; LB2 l;
  l.gyq = b.take(2 * size_t(GP) * a.cout_ld);
  l.w2c = b.take(2 * size_t(CK) * a.cout_ld);
  l.bqT = b.take(2 * size_t(CK) * P_LD);
  l.dqf = b.take(4 * size_t(GP) * F_LD);
  l.t1s = b.take(4 * size_t(GP) * F_LD);
  l.t2s = b.take(4 * size_t(GP) * F_LD);
  l.total = b.o;
  return l;
}
__host__ __device__ inline LB34 lay_b34(const Args& a) {
  Bump b; LB34 l;
  l.xs = b.take(2 * size_t(a.nh_p) * a.xs_ld);
  l.w1s = b.take(2 * size_t(CK) * a.xs_ld);
  l.w1c = b.take(2 * size_t(a.Cin) * H_LD);
  l.es = b.take(4 * size_t(a.nh_p) * F_LD);
  l.dds = b.take(4 * size_t(a.nh_p) * F_LD);
  l.eqc = b.take(4 * size_t(NO) * F_LD);
  l.dvs = b.take(2 * size_t(NO) * H_LD);
  l.wds = b.take(4 * 9 * CK);
  l.reds = b.take(4 * size_t(NTHREADS / CK) * 11 * CK);
  l.total = b.o;
  return l;
}
__host__ __device__ inline LWG lay_wg(const Args& a) {
  Bump b; LWG l;
  l.dvT = b.take(2 * size_t(CK) * P_LD);
  l.xT = b.take(2 * size_t(a.Cin) * P_LD);
  l.total = b.o;
  return l;
}

__device__ __forceinline__ bf16 bzero() { return __float2bfloat16(0.f); }

// halo pixel hp of the tile at (ty0, tx0) -> image pixel index, or -1
__device__ __forceinline__ int halo_pix(const Args& a, int hp, int ty0, int tx0) {
  if (hp >= a.nh) return -1;
  const int gy = ty0 - a.rate + hp / a.hw, gx = tx0 - a.rate + hp % a.hw;
  if (gy < 0 || gy >= a.H || gx < 0 || gx >= a.W) return -1;
  return gy * a.W + gx;
}

// x with its +-rate halo as bf16 rows (zero outside the image and past Cin)
__device__ void stage_x_halo(const Args& a, bf16* xs, size_t img, int ty0, int tx0) {
  for (int i = threadIdx.x; i < a.nh_p * a.cin_p; i += NTHREADS) {
    const int hp = i / a.cin_p, k = i % a.cin_p;
    const int pix = halo_pix(a, hp, ty0, tx0);
    bf16 v = bzero();
    if (pix >= 0 && k < a.Cin) v = a.x[(img + pix) * a.Cin + k];
    xs[hp * a.xs_ld + k] = v;
  }
}

// this chunk's expand weights, n-major: w1s[n][k] = w1[k][c0 + n]
__device__ void stage_w1(const Args& a, bf16* w1s, int c0) {
  for (int i = threadIdx.x; i < CK * a.cin_p; i += NTHREADS) {
    const int n = i % CK, k = i / CK;
    bf16 v = bzero();
    if (c0 + n < a.Ce && k < a.Cin) v = a.w1[size_t(k) * a.Ce + c0 + n];
    w1s[n * a.xs_ld + k] = v;
  }
}

__device__ void stage_taps(const Args& a, float* wds, int c0) {
  for (int i = threadIdx.x; i < 9 * CK; i += NTHREADS) {
    const int c = i % CK, row = i / CK;
    wds[i] = c0 + c < a.Ce ? a.wdw[row * a.Ce + c0 + c] : 0.f;
  }
}

// expand over the halo pixels: epi(hp, n, f32 product) for each (pixel, chunk
// channel); warps take 16-pixel m-tiles in turn
template <typename Epi>
__device__ void expand_halo(const Args& a, const bf16* xs, const bf16* w1s, Epi epi) {
  const int warp = threadIdx.x >> 5;
  for (int mt = warp; mt < a.nh_p / 16; mt += NWARPS) {
    float acc[CK / 8][4] = {};
    mma_tile<CK / 8>(acc, xs, a.xs_ld, mt * 16, w1s, a.xs_ld, a.cin_p, 0, 1, CK / 8);
    for_each_acc<CK / 8>(acc, mt * 16, 0, 1, CK / 8, epi);
  }
}

// ---------------------------------------------------------------- F1 ----
__global__ void __launch_bounds__(NTHREADS) f1_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const LF1 L = lay_f1(a);
  bf16* xs = reinterpret_cast<bf16*>(smem + L.xs);
  bf16* w1s = reinterpret_cast<bf16*>(smem + L.w1s);
  float* es = reinterpret_cast<float*>(smem + L.es);
  const int tid = threadIdx.x, warp = tid >> 5;
  const long long p0 = (long long)blockIdx.x * GP;
  for (int i = tid; i < GP * a.cin_p; i += NTHREADS) {
    const int p = i / a.cin_p, k = i % a.cin_p;
    bf16 v = bzero();
    if (p0 + p < a.P && k < a.Cin) v = a.x[(p0 + p) * a.Cin + k];
    xs[p * a.xs_ld + k] = v;
  }
  const int mw = warp & 3, nt0 = (warp >> 2) * 2;
  for (int c0 = 0; c0 < a.Ce; c0 += CK) {
    stage_w1(a, w1s, c0);
    __syncthreads();
    float acc[2][4] = {};
    mma_tile<2>(acc, xs, a.xs_ld, mw * 16, w1s, a.xs_ld, a.cin_p, nt0, 1, CK / 8);
    for_each_acc<2>(acc, mw * 16, nt0, 1, CK / 8, [&](int p, int n, float v) {
      es[p * F_LD + n] = p0 + p < a.P ? qbf(v) : 0.f;
    });
    __syncthreads();
    if (tid < 64) {
      const int c = tid & 31;
      const bool sq = tid >= 32;
      float s = 0.f;
      for (int p = 0; p < GP; ++p) {
        const float v = es[p * F_LD + c];
        s += sq ? v * v : v;
      }
      if (c0 + c < a.Ce)
        a.part[(long long)blockIdx.x * 2 * a.Ce + (sq ? a.Ce : 0) + c0 + c] = s;
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------- F2 ----
__global__ void __launch_bounds__(NTHREADS) f2_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const LF2 L = lay_f2(a);
  bf16* xs = reinterpret_cast<bf16*>(smem + L.xs);
  bf16* w1s = reinterpret_cast<bf16*>(smem + L.w1s);
  float* es = reinterpret_cast<float*>(smem + L.es);
  float* wds = reinterpret_cast<float*>(smem + L.wds);
  float* ds = reinterpret_cast<float*>(smem + L.ds);
  const int tid = threadIdx.x, b = blockIdx.y, r = a.rate, hw = a.hw;
  const int ty0 = (blockIdx.x / a.tiles_x) * TH, tx0 = (blockIdx.x % a.tiles_x) * TW;
  const size_t img = size_t(b) * a.H * a.W;
  const long long prow = ((long long)b * gridDim.x + blockIdx.x) * 2 * a.Ce;
  stage_x_halo(a, xs, img, ty0, tx0);
  for (int c0 = 0; c0 < a.Ce; c0 += CK) {
    stage_w1(a, w1s, c0);
    stage_taps(a, wds, c0);
    __syncthreads();
    expand_halo(a, xs, w1s, [&](int hp, int n, float v) {
      float act = 0.f;
      if (c0 + n < a.Ce && halo_pix(a, hp, ty0, tx0) >= 0)
        act = relu6(qbf(qbf(qbf(v) * a.a1[c0 + n]) + a.c1[c0 + n]));
      es[hp * F_LD + n] = act;
    });
    __syncthreads();
    // taps in f32, dx outer and dy inner (the plain version's order)
    for (int i = tid; i < NO * CK; i += NTHREADS) {
      const int c = i % CK, p = i / CK, oy = p / TW, ox = p % TW;
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int k = 0; k < 3; ++k)
          s += es[((oy + k * r) * hw + ox + j * r) * F_LD + c] * wds[(k * 3 + j) * CK + c];
      const float d = qbf(s);
      const int gy = ty0 + oy, gx = tx0 + ox;
      const bool valid = gy < a.H && gx < a.W;
      if (valid && c0 + c < a.Ce)
        a.dq_out[(img + size_t(gy) * a.W + gx) * a.Ce + c0 + c] = __float2bfloat16(d);
      ds[p * F_LD + c] = valid ? d : 0.f;
    }
    __syncthreads();
    if (tid < 64) {
      const int c = tid & 31;
      const bool sq = tid >= 32;
      float s = 0.f;
      for (int p = 0; p < NO; ++p) {
        const float v = ds[p * F_LD + c];
        s += sq ? v * v : v;
      }
      if (c0 + c < a.Ce) a.part[prow + (sq ? a.Ce : 0) + c0 + c] = s;
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------- F3 ----
// NT: project n-tiles per warp (4 pixel m-tiles x 2 interleaved n groups)
template <int NT>
__global__ void __launch_bounds__(NTHREADS) f3_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const LF3 L = lay_f3(a);
  bf16* bs = reinterpret_cast<bf16*>(smem + L.bs);
  bf16* w2s = reinterpret_cast<bf16*>(smem + L.w2s);
  const int tid = threadIdx.x, warp = tid >> 5;
  const long long p0 = (long long)blockIdx.x * GP;
  const int mw = warp & 3, nt0 = warp >> 2, n_tiles = a.Cout / 8;
  float acc[NT][4] = {};
  for (int c0 = 0; c0 < a.Ce; c0 += CK) {
    for (int i = tid; i < a.Cout * CK; i += NTHREADS) {
      const int n = i % a.Cout, k = i / a.Cout;
      w2s[n * H_LD + k] = c0 + k < a.Ce ? a.w2[size_t(c0 + k) * a.Cout + n] : bzero();
    }
    for (int i = tid; i < GP * CK; i += NTHREADS) {
      const int p = i / CK, c = i % CK, ch = c0 + c;
      float v = 0.f;
      if (p0 + p < a.P && ch < a.Ce) {
        const float d = __bfloat162float(a.dq[(p0 + p) * a.Ce + ch]);
        v = relu6(qbf(qbf(d * a.a2[ch]) + a.c2[ch]));
      }
      bs[p * H_LD + c] = __float2bfloat16(v);
    }
    __syncthreads();
    mma_tile<NT>(acc, bs, H_LD, mw * 16, w2s, H_LD, CK, nt0, 2, n_tiles);
    __syncthreads();
  }
  for_each_acc<NT>(acc, mw * 16, nt0, 2, n_tiles, [&](int p, int n, float v) {
    if (p0 + p < a.P) a.y_out[(p0 + p) * a.Cout + n] = __float2bfloat16(v);
  });
}

// ---------------------------------------------------------------- B2 ----
// gyq = q(gA3*g + k0 + k1*y_raw), once per pixel and output channel, 8 values
// (16 bytes) a thread; Cout is a multiple of 8
__global__ void __launch_bounds__(NTHREADS) gy_kernel(const Args a) {
  const long long i8 = ((long long)blockIdx.x * NTHREADS + threadIdx.x) * 8;
  if (i8 >= a.P * a.Cout) return;
  const int n0 = int(i8 % a.Cout);
  const uint4 gv = *reinterpret_cast<const uint4*>(a.g + i8);
  const uint4 yv = *reinterpret_cast<const uint4*>(a.y + i8);
  const bf16* gp = reinterpret_cast<const bf16*>(&gv);
  const bf16* yp = reinterpret_cast<const bf16*>(&yv);
  uint4 ov;
  bf16* op = reinterpret_cast<bf16*>(&ov);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int n = n0 + k;
    op[k] = __float2bfloat16(a.gA3[n] * __bfloat162float(gp[k]) + a.k0[n] +
                             a.k1[n] * __bfloat162float(yp[k]));
  }
  *reinterpret_cast<uint4*>(a.gyq + i8) = ov;
}

// grid (Ce chunks, pixel splits).  NT2: dW2 n-tiles per warp (2 channel
// m-tiles x 4 interleaved n groups).
template <int NT2>
__global__ void __launch_bounds__(NTHREADS) b2_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const LB2 L = lay_b2(a);
  bf16* gyq = reinterpret_cast<bf16*>(smem + L.gyq);
  bf16* w2c = reinterpret_cast<bf16*>(smem + L.w2c);
  bf16* bqT = reinterpret_cast<bf16*>(smem + L.bqT);
  float* dqf = reinterpret_cast<float*>(smem + L.dqf);
  float* t1s = reinterpret_cast<float*>(smem + L.t1s);
  float* t2s = reinterpret_cast<float*>(smem + L.t2s);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int c0 = blockIdx.x * CK, split = blockIdx.y;
  const int Ce = a.Ce, Cout = a.Cout, nv = a.cout_k / 8;
  // w2 rows of this chunk: the B operand of ddh = gyq @ w2^T, n-major (c, k)
  for (int i = tid; i < CK * a.cout_k; i += NTHREADS) {
    const int n = i / a.cout_k, k = i % a.cout_k;
    w2c[n * a.cout_ld + k] =
        c0 + n < Ce && k < Cout ? a.w2[size_t(c0 + n) * Cout + k] : bzero();
  }
  const int mw = warp & 3, ntd = (warp >> 2) * 2;  // ddh: pixel m-tile
  const int mw2 = warp & 1, nt2 = warp >> 1;       // dW2: channel m-tile
  float accw[NT2][4] = {};
  float tacc = 0.f;
  for (int grp = split; grp < a.n_groups; grp += a.splits) {
    const long long p0 = (long long)grp * GP;
    // this group's gyq rows, 16 bytes a thread (zero past P and Cout)
    for (int i = tid; i < GP * nv; i += NTHREADS) {
      const int p = i / nv, n0 = (i % nv) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (p0 + p < a.P && n0 < Cout)
        v = *reinterpret_cast<const uint4*>(a.gyq + (p0 + p) * Cout + n0);
      *reinterpret_cast<uint4*>(gyq + p * a.cout_ld + n0) = v;
    }
    for (int i = tid; i < GP * CK; i += NTHREADS) {
      const int p = i / CK, c = i % CK, ch = c0 + c;
      float d = 0.f, bv = 0.f;
      if (p0 + p < a.P && ch < Ce) {
        d = __bfloat162float(a.dq[(p0 + p) * Ce + ch]);
        bv = relu6(qbf(qbf(d * a.a2[ch]) + a.c2[ch]));
      }
      dqf[p * F_LD + c] = d;
      bqT[c * P_LD + p] = __float2bfloat16(bv);
    }
    __syncthreads();
    {
      float acc[2][4] = {};
      mma_tile<2>(acc, gyq, a.cout_ld, mw * 16, w2c, a.cout_ld, a.cout_k, ntd, 1, CK / 8);
      for_each_acc<2>(acc, mw * 16, ntd, 1, CK / 8, [&](int p, int c, float v) {
        float t1 = 0.f, t2 = 0.f;
        const int ch = c0 + c;
        if (p0 + p < a.P && ch < Ce) {
          const float d = dqf[p * F_LD + c];
          const float v2 = qbf(qbf(d * a.a2[ch]) + a.c2[ch]);
          const float ddh = v2 > 0.f && v2 < 6.f ? v : 0.f;
          a.ddh_out[(p0 + p) * Ce + ch] = ddh;
          t1 = ddh;
          t2 = ddh * ((d - a.mu2[ch]) * a.rstd2[ch]);
        }
        t1s[p * F_LD + c] = t1;
        t2s[p * F_LD + c] = t2;
      });
    }
    // dW2 += q(b)^T gyq: A (channel, pixel) from bqT, B (pixel, n) from gyq
    mma_tile_kn<NT2>(accw, bqT, P_LD, mw2 * 16, gyq, a.cout_ld, GP, nt2, 4, Cout / 8);
    __syncthreads();
    if (tid < 64) {
      const float* src = tid < 32 ? t1s : t2s;
      for (int p = 0; p < GP; ++p) tacc += src[p * F_LD + (tid & 31)];
    }
    __syncthreads();
  }
  if (tid < 64 && c0 + (tid & 31) < Ce)
    a.part2[(long long)split * 2 * Ce + (tid >= 32 ? Ce : 0) + c0 + (tid & 31)] = tacc;
  for_each_acc<NT2>(accw, mw2 * 16, nt2, 4, Cout / 8, [&](int m, int n, float v) {
    if (c0 + m < Ce)
      a.part[(long long)split * Ce * Cout + (long long)(c0 + m) * Cout + n] = v;
  });
}

// --------------------------------------------------------------- B34 ----
// NTX: dx n-tiles per warp (4 pixel m-tiles x 2 interleaved n groups)
template <int NTX>
__global__ void __launch_bounds__(NTHREADS) b34_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const LB34 L = lay_b34(a);
  bf16* xs = reinterpret_cast<bf16*>(smem + L.xs);
  bf16* w1s = reinterpret_cast<bf16*>(smem + L.w1s);
  bf16* w1c = reinterpret_cast<bf16*>(smem + L.w1c);
  float* es = reinterpret_cast<float*>(smem + L.es);
  float* dds = reinterpret_cast<float*>(smem + L.dds);
  float* eqc = reinterpret_cast<float*>(smem + L.eqc);
  bf16* dvs = reinterpret_cast<bf16*>(smem + L.dvs);
  float* wds = reinterpret_cast<float*>(smem + L.wds);
  float* reds = reinterpret_cast<float*>(smem + L.reds);
  const int tid = threadIdx.x, warp = tid >> 5, b = blockIdx.y;
  const int r = a.rate, hw = a.hw, Ce = a.Ce, Cin = a.Cin;
  const int ty0 = (blockIdx.x / a.tiles_x) * TH, tx0 = (blockIdx.x % a.tiles_x) * TW;
  const size_t img = size_t(b) * a.H * a.W;
  const long long prow = ((long long)b * gridDim.x + blockIdx.x) * 11 * Ce;
  const int mw = warp & 3, ntx0 = warp >> 2, n_tiles_x = Cin / 8;
  float acc[NTX][4] = {};
  stage_x_halo(a, xs, img, ty0, tx0);
  for (int c0 = 0; c0 < Ce; c0 += CK) {
    stage_w1(a, w1s, c0);
    stage_taps(a, wds, c0);
    // w1 columns of this chunk: the B operand of dx = dvl @ w1^T, n-major (k, c)
    for (int i = tid; i < Cin * CK; i += NTHREADS) {
      const int n = i / CK, k = i % CK;
      w1c[n * H_LD + k] = c0 + k < Ce ? a.w1[size_t(n) * Ce + c0 + k] : bzero();
    }
    // dd on the halo, zero outside the image
    for (int i = tid; i < a.nh_p * CK; i += NTHREADS) {
      const int hp = i / CK, c = i % CK, ch = c0 + c;
      const int pix = halo_pix(a, hp, ty0, tx0);
      float v = 0.f;
      if (pix >= 0 && ch < Ce) {
        const size_t o = (img + pix) * Ce + ch;
        v = a.a2[ch] * a.ddh[o] + a.m0[ch] + a.m1[ch] * __bfloat162float(a.dq[o]);
      }
      dds[hp * F_LD + c] = v;
    }
    __syncthreads();
    expand_halo(a, xs, w1s, [&](int hp, int n, float v) {
      const int ch = c0 + n;
      float eq = 0.f, act = 0.f;
      if (ch < Ce) {
        eq = qbf(v);
        if (halo_pix(a, hp, ty0, tx0) >= 0)
          act = relu6(qbf(qbf(eq * a.a1[ch]) + a.c1[ch]));
      }
      es[hp * F_LD + n] = act;
      const int hy = hp / hw - r, hx = hp % hw - r;
      if (hp < a.nh && hy >= 0 && hy < TH && hx >= 0 && hx < TW)
        eqc[(hy * TW + hx) * F_LD + n] = eq;
    });
    __syncthreads();
    // transposed taps (dx outer, dy inner), relu6' mask, BN1 grad terms.
    // Thread tid takes channel tid % 32 at pixels tid / 32 + 8k, and keeps
    // its share of this tile's U1, U2 and dWdw[t] = sum dd(p) aq(p + t).
    float red[11] = {};
    const int c = tid % CK, ch = c0 + c;
#pragma unroll 1
    for (int p = tid / CK; p < NO; p += NTHREADS / CK) {
      const int oy = p / TW, ox = p % TW;
      float da = 0.f;
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int k = 0; k < 3; ++k)
          da += dds[((oy + (2 - k) * r) * hw + ox + (2 - j) * r) * F_LD + c] *
                wds[(k * 3 + j) * CK + c];
      const int gy = ty0 + oy, gx = tx0 + ox;
      const bool valid = gy < a.H && gx < a.W && ch < Ce;
      float dvl = 0.f;
      if (valid) {
        const float eq = eqc[p * F_LD + c];
        const float v1 = qbf(qbf(eq * a.a1[ch]) + a.c1[ch]);
        const float dv1 = v1 > 0.f && v1 < 6.f ? da : 0.f;
        red[0] += dv1;
        red[1] += dv1 * ((eq - a.mu1[ch]) * a.rstd1[ch]);
        dvl = a.a1[ch] * dv1;
      }
      // dd is zero outside the image, so invalid pixels add nothing here
      const float ddc = dds[((oy + r) * hw + ox + r) * F_LD + c];
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int j = 0; j < 3; ++j)
          red[2 + k * 3 + j] += ddc * es[((oy + k * r) * hw + ox + j * r) * F_LD + c];
      const bf16 dq = __float2bfloat16(dvl);
      dvs[p * H_LD + c] = dq;
      if (valid) a.dvl[(img + size_t(gy) * a.W + gx) * Ce + ch] = dq;
    }
#pragma unroll
    for (int row = 0; row < 11; ++row)
      reds[((tid / CK) * 11 + row) * CK + c] = red[row];
    __syncthreads();
    mma_tile<NTX>(acc, dvs, H_LD, mw * 16, w1c, H_LD, CK, ntx0, 2, n_tiles_x);
    // this tile's per-channel sums, the 8 pixel groups added in order
    for (int idx = tid; idx < 11 * CK; idx += NTHREADS) {
      const int row = idx / CK, cc = idx % CK;
      float sum = 0.f;
#pragma unroll
      for (int grp = 0; grp < NTHREADS / CK; ++grp) sum += reds[(grp * 11 + row) * CK + cc];
      if (c0 + cc < Ce) a.part[prow + row * Ce + c0 + cc] = sum;
    }
    __syncthreads();
  }
  for_each_acc<NTX>(acc, mw * 16, ntx0, 2, n_tiles_x, [&](int p, int n, float v) {
    const int gy = ty0 + p / TW, gx = tx0 + p % TW;
    if (gy < a.H && gx < a.W)
      a.dxp[(img + size_t(gy) * a.W + gx) * Cin + n] = __float2bfloat16(v);
  });
}

// ----------------------------------------------- weight gradient dW1^T ----
// grid (Ce chunks, pixel splits): dW1^T[c][k] = sum_p dvl[p][c] * x[p][k]
template <int NTW>
__global__ void __launch_bounds__(NTHREADS) wg_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const LWG L = lay_wg(a);
  bf16* dvT = reinterpret_cast<bf16*>(smem + L.dvT);
  bf16* xT = reinterpret_cast<bf16*>(smem + L.xT);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int c0 = blockIdx.x * CK, split = blockIdx.y, Ce = a.Ce, Cin = a.Cin;
  const int mw2 = warp & 1, nt2 = warp >> 1;
  float acc[NTW][4] = {};
  for (int grp = split; grp < a.n_groups; grp += a.splits) {
    const long long p0 = (long long)grp * GP;
    for (int i = tid; i < GP * CK; i += NTHREADS) {
      const int p = i / CK, c = i % CK;
      dvT[c * P_LD + p] = p0 + p < a.P && c0 + c < Ce ? a.dvl[(p0 + p) * Ce + c0 + c] : bzero();
    }
    for (int i = tid; i < GP * Cin; i += NTHREADS) {
      const int p = i / Cin, k = i % Cin;
      xT[k * P_LD + p] = p0 + p < a.P ? a.x[(p0 + p) * Cin + k] : bzero();
    }
    __syncthreads();
    mma_tile<NTW>(acc, dvT, P_LD, mw2 * 16, xT, P_LD, GP, nt2, 4, Cin / 8);
    __syncthreads();
  }
  for_each_acc<NTW>(acc, mw2 * 16, nt2, 4, Cin / 8, [&](int m, int n, float v) {
    if (c0 + m < Ce)
      a.part2[(long long)split * Ce * Cin + (long long)(c0 + m) * Cin + n] = v;
  });
}

// -------------------------------------------- deterministic reduction ----
// out[col] = sum over rows of part[row][col], in a fixed order
__global__ void reduce_rows(const float* part, long long rows, long long cols,
                            float* out) {
  __shared__ float sh[RED_Y][32];
  const long long col = (long long)blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (col < cols)
    for (long long r = threadIdx.y; r < rows; r += RED_Y) s += part[r * cols + col];
  sh[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < cols) {
    float t = 0.f;
    for (int k = 0; k < RED_Y; ++k) t += sh[k][threadIdx.x];
    out[col] = t;
  }
}

// ------------------------------------------------------------ host side ----

template <int... Ns> struct NTList {};

template <typename F>
cudaError_t pick(int, F, NTList<>) { return cudaErrorInvalidValue; }

template <typename F, int N, int... Ns>
cudaError_t pick(int need, F launch, NTList<N, Ns...>) {
  if (need <= N) return launch(std::integral_constant<int, N>{});
  return pick(need, launch, NTList<Ns...>{});
}

template <typename K>
cudaError_t run(K kern, dim3 grid, size_t smem, const Args& a, cudaStream_t s) {
  if (smem > SMEM_MAX) return cudaErrorInvalidConfiguration;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(smem));
  if (e != cudaSuccess) return e;
  kern<<<grid, NTHREADS, smem, s>>>(a);
  return cudaGetLastError();
}

cudaError_t reduce(const float* part, long long rows, long long cols, float* out,
                   cudaStream_t s) {
  reduce_rows<<<dim3(unsigned((cols + 31) / 32)), dim3(32, RED_Y), 0, s>>>(
      part, rows, cols, out);
  return cudaGetLastError();
}

// geometry from dims = (B, H, W, Cin, Ce, Cout, rate); false if unsupported
bool geometry(int phase, const int* d, Args& a) {
  a = Args{};
  a.B = d[0]; a.H = d[1]; a.W = d[2]; a.Cin = d[3]; a.Ce = d[4]; a.Cout = d[5];
  a.rate = d[6];
  if (a.B <= 0 || a.H <= 0 || a.W <= 0 || a.Ce <= 0 || a.rate < 1) return false;
  if ((phase == F3 || phase == B2) && (a.Cout <= 0 || a.Cout % 8 || a.Cout > 320))
    return false;
  if ((phase == F1 || phase == F2 || phase == B34) &&
      (a.Cin <= 0 || a.Cin % 8 || a.Cin > 160))
    return false;
  a.P = (long long)a.B * a.H * a.W;
  a.n_groups = int((a.P + GP - 1) / GP);
  a.n_chunks = (a.Ce + CK - 1) / CK;
  const int want = (TARGET_CTAS + a.n_chunks - 1) / a.n_chunks;
  a.splits = want < a.n_groups ? want : a.n_groups;
  a.tiles_x = (a.W + TW - 1) / TW;
  a.tiles_y = (a.H + TH - 1) / TH;
  a.n_tiles = a.B * a.tiles_x * a.tiles_y;
  a.cin_p = (a.Cin + 15) / 16 * 16;
  a.xs_ld = a.cin_p + 8;
  a.hw = TW + 2 * a.rate;
  a.nh = (TH + 2 * a.rate) * a.hw;
  a.nh_p = (a.nh + 15) / 16 * 16;
  a.cout_k = (a.Cout + 15) / 16 * 16;
  a.cout_ld = a.cout_k + 8;
  return true;
}

struct Scratch { size_t dvl, part, part2, total; };

Scratch scratch_plan(int phase, const Args& a) {
  Scratch s{0, 0, 0, 0};
  size_t dvl = 0, part = 0, part2 = 0;  // bytes
  const size_t Ce = a.Ce;
  switch (phase) {
    case F1: part = 4 * size_t(a.n_groups) * 2 * Ce; break;
    case F2: part = 4 * size_t(a.n_tiles) * 2 * Ce; break;
    case B2:
      dvl = 2 * size_t(a.P) * a.Cout;  // gyq
      part = 4 * size_t(a.splits) * Ce * a.Cout;
      part2 = 4 * size_t(a.splits) * 2 * Ce;
      break;
    case B34:
      dvl = 2 * size_t(a.P) * Ce;
      part = 4 * size_t(a.n_tiles) * 11 * Ce;
      part2 = 4 * size_t(a.splits) * Ce * a.Cin;
      break;
    default: break;
  }
  auto al = [](size_t n) { return (n + 255) & ~size_t(255); };
  s.dvl = 0;
  s.part = al(dvl);
  s.part2 = s.part + al(part);
  s.total = s.part2 + al(part2);
  return s;
}

}  // namespace

extern "C" {

// Scratch bytes phase `phase` needs at dims (B, H, W, Cin, Ce, Cout, rate),
// or -1 when the kernel does not take the shape.
long long mbt_scratch_bytes(int phase, const int* dims) {
  Args a;
  if (phase < F1 || phase > B34 || !geometry(phase, dims, a)) return -1;
  return (long long)scratch_plan(phase, a).total;
}

// Launch phase `phase` on `stream`.  ptrs, in order (scratch last, where the
// phase needs one):
//   F1:  x, w1, out(2, Ce), scratch
//   F2:  x, w1, a1, c1, wdw, out(2, Ce), dq, scratch
//   F3:  dq, a2, c2, w2, y
//   B2:  dq, g, y, a2, c2, mu2, rstd2, w2, gA3, k0, k1, t(2, Ce), dw2, ddh, scratch
//   B34: x, dq, ddh, w1, a1, c1, wdw, a2, m0, m1, mu1, rstd1, u(11, Ce), dxp,
//        dw1t, scratch
// Returns 0 or the cudaError_t of the first launch that failed.
int mbt_launch(int phase, void** ptrs, int n_ptrs, const int* dims, void* stream) {
  static const int want[] = {4, 8, 5, 15, 16};
  Args a;
  if (phase < F1 || phase > B34 || n_ptrs != want[phase] || !geometry(phase, dims, a))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto P = [&](int i) { return ptrs[i]; };
  const Scratch sp = scratch_plan(phase, a);
  unsigned char* scratch =
      n_ptrs > 0 ? static_cast<unsigned char*>(ptrs[n_ptrs - 1]) : nullptr;
  if (sp.total) {
    a.dvl = reinterpret_cast<bf16*>(scratch + sp.dvl);
    a.gyq = a.dvl;  // B2 keeps gyq where B34 keeps dvl
    a.part = reinterpret_cast<float*>(scratch + sp.part);
    a.part2 = reinterpret_cast<float*>(scratch + sp.part2);
  }
  const long long Ce = a.Ce;
  const dim3 tiles(a.tiles_x * a.tiles_y, a.B);
  cudaError_t e = cudaSuccess;
  switch (phase) {
    case F1: {
      a.x = (const bf16*)P(0); a.w1 = (const bf16*)P(1);
      e = run(f1_kernel, dim3(a.n_groups), lay_f1(a).total, a, s);
      if (e == cudaSuccess) e = reduce(a.part, a.n_groups, 2 * Ce, (float*)P(2), s);
      break;
    }
    case F2: {
      a.x = (const bf16*)P(0); a.w1 = (const bf16*)P(1);
      a.a1 = (const float*)P(2); a.c1 = (const float*)P(3); a.wdw = (const float*)P(4);
      a.dq_out = (bf16*)P(6);
      e = run(f2_kernel, tiles, lay_f2(a).total, a, s);
      if (e == cudaSuccess) e = reduce(a.part, a.n_tiles, 2 * Ce, (float*)P(5), s);
      break;
    }
    case F3: {
      a.dq = (const bf16*)P(0); a.a2 = (const float*)P(1); a.c2 = (const float*)P(2);
      a.w2 = (const bf16*)P(3); a.y_out = (bf16*)P(4);
      e = pick((a.Cout / 8 + 1) / 2, [&](auto n) {
        return run(f3_kernel<decltype(n)::value>, dim3(a.n_groups), lay_f3(a).total, a, s);
      }, NTList<2, 4, 6, 10, 20>{});
      break;
    }
    case B2: {
      a.dq = (const bf16*)P(0); a.g = (const bf16*)P(1); a.y = (const bf16*)P(2);
      a.a2 = (const float*)P(3); a.c2 = (const float*)P(4);
      a.mu2 = (const float*)P(5); a.rstd2 = (const float*)P(6);
      a.w2 = (const bf16*)P(7); a.gA3 = (const float*)P(8);
      a.k0 = (const float*)P(9); a.k1 = (const float*)P(10);
      a.ddh_out = (float*)P(13);
      e = run(gy_kernel, dim3(unsigned((a.P * a.Cout / 8 + NTHREADS - 1) / NTHREADS)),
              0, a, s);
      if (e == cudaSuccess)
        e = pick((a.Cout / 8 + 3) / 4, [&](auto n) {
        return run(b2_kernel<decltype(n)::value>, dim3(a.n_chunks, a.splits),
                   lay_b2(a).total, a, s);
      }, NTList<1, 2, 3, 5, 10>{});
      if (e == cudaSuccess) e = reduce(a.part2, a.splits, 2 * Ce, (float*)P(11), s);
      if (e == cudaSuccess)
        e = reduce(a.part, a.splits, Ce * a.Cout, (float*)P(12), s);
      break;
    }
    case B34: {
      a.x = (const bf16*)P(0); a.dq = (const bf16*)P(1); a.ddh = (const float*)P(2);
      a.w1 = (const bf16*)P(3); a.a1 = (const float*)P(4); a.c1 = (const float*)P(5);
      a.wdw = (const float*)P(6); a.a2 = (const float*)P(7);
      a.m0 = (const float*)P(8); a.m1 = (const float*)P(9);
      a.mu1 = (const float*)P(10); a.rstd1 = (const float*)P(11);
      a.dxp = (bf16*)P(13);
      e = pick((a.Cin / 8 + 1) / 2, [&](auto n) {
        return run(b34_kernel<decltype(n)::value>, tiles, lay_b34(a).total, a, s);
      }, NTList<2, 4, 6, 10>{});
      if (e == cudaSuccess) e = reduce(a.part, a.n_tiles, 11 * Ce, (float*)P(12), s);
      if (e == cudaSuccess)
        e = pick((a.Cin / 8 + 3) / 4, [&](auto n) {
          return run(wg_kernel<decltype(n)::value>, dim3(a.n_chunks, a.splits),
                     lay_wg(a).total, a, s);
        }, NTList<1, 2, 3, 5>{});
      if (e == cudaSuccess)
        e = reduce(a.part2, a.splits, Ce * a.Cin, (float*)P(14), s);
      break;
    }
    default: e = cudaErrorInvalidValue;
  }
  return int(e);
}

const char* mbt_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
