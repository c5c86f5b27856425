// Fused eval-mode inverted-residual (MBConv) block for Hopper (sm_90a).
//
// Replaces the TPU kernel deeplab_tpu/kernels/fused_mbconv.py::fused_mbconv
// (pl.pallas_call at line 121).  Per output pixel it computes
//   e   = relu6(x @ w1 + b1)                      (1x1 expand, Cin -> Ce)
//   d   = relu6(bdw + sum_taps e[shifted] * wdw)  (3x3 depthwise, dilation rate,
//                                                  SAME zero padding of e)
//   out = d @ w2 + b2 [+ x]                       (1x1 project, Ce -> Cout)
// with BN folded into w1/b1, wdw/bdw and w2/b2 by the caller.  The matmuls
// take bf16 operands and accumulate in f32; e and the depthwise stay in f32;
// d is rounded to bf16 for the project; the residual is the unrounded x, in
// f32, before the output cast.
//
// What bounds it on the H100.  At the main path's shapes (64x64 and 128x128
// maps, Ce up to 960) the block does ~2*Ce*(Cin+Cout) tensor-core flops per
// output pixel against (Cin+Cout)*4 bytes of f32 input and output: ~2,300
// flops per byte for the widest block, far above the card's ~295 flops/byte
// ridge.  So once the 6x-expanded tensor stays on chip the block is bound by
// the tensor cores, and the time beyond that bound is what the tiling adds:
// the expand recomputed on each tile's halo, the weights restaged per tile,
// and the barriers and latencies between the phases of a chunk.
//
// Design (the launch plan, `mbconv_plan` in kernels/fused_mbconv.py, picks
// the tile, chunk and ring depth per shape from a cost model fitted to
// measured times; this file checks the plan):
//  - one block of 16 warps (512 threads, at most 128 registers each) per
//    (TH x TW output tile, image), TH x TW in {16x16, 8x16, 8x8}.  Larger
//    tiles cut the halo recompute and the weight restaging per pixel; the
//    f32 project accumulator (16 pixels x 8 NT channels a warp, Cout split
//    over 16 * 16 / (TH*TW) warp columns) and shared memory bound them;
//  - the tile expands only its in-image halo box (a rectangle: the halo
//    clipped to the image), packed into whole m-tiles of 16 pixels, so the
//    zero padding costs no tensor-core work.  Expanded pixels per output
//    pixel on a 64x64 map (mbconv_halo): rate 1 1.64x at 8x8, 1.25x at
//    16x16; rate 2 2.13x at 8x8, 1.44x at 16x16; rate 4 3.52x at 8x8,
//    2.58x at 8x16 (full boxes: 4x and 3x).  The rate-4 blocks (Cin = 160)
//    fit 8x16 with two stages of chunks of 32, or 8x8 (Cout = 320): their
//    x tile alone is 123 KB at 8x16;
//  - Ce runs in chunks of CK (32, or 16 where shared memory is short)
//    through a ring of 2 or 3 shared-memory stages, each chunk's w1 / b1 /
//    w2 / wdw / bdw slice brought in with 16-byte cp.async (zero-filled
//    past Ce) two chunks ahead of its use.  The slices are contiguous runs
//    of the (Cin, Ce), (Ce, Cout) and (9, Ce) arrays, so they need no
//    repacking;
//  - both products run on mma.sync m16n8k16 (bf16, f32 accumulate) fed by
//    ldmatrix without bank conflicts: the x tile, e and the w1 stages keep
//    unpadded rows with their 16-byte chunks XOR-swizzled by row (the x
//    tile where its rows hold 4 (mod 8) chunks, as at Cin = 32, 96 and 160;
//    padded by one chunk otherwise), which is what lets the rate-4 blocks
//    take chunks of 32 at 8x16; B operands stay k-major in shared memory
//    and are read with ldmatrix.trans.  An expand unit is 32 halo pixels x 16 channels (two
//    m-tiles sharing each B fragment: four independent accumulators);
//  - the depthwise reads e through a tap table built once per block (the e
//    row of each tap of each pixel, a zero row outside the image), a
//    channel pair a thread, each pair of pixels' 18 loads issued before
//    their sums;
//  - two barriers a chunk: after one, every warp runs its share of chunk c's
//    project and of chunk c+1's expand (different buffers); after the other,
//    chunk c+1's depthwise;
//  - bias, residual (in f32, from the unrounded x) and the output cast once
//    at the end, two channels a store.
// Measured (PERF.md): ~6% of the tensor-core bound per launch; the
// phases of a chunk are short and separated by barriers, and the rate-4
// blocks re-read their 129 KB x tile from shared memory for each of 60
// chunks.  Not done: wgmma (its 64-row A tiles would need the halo box in
// whole 64-pixel tiles and its B operand in the wgmma shared-memory layout)
// and TMA (the chunks are small strided slices).  Blocks are independent
// and run in any order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int NWARPS = 16, NTHREADS = 32 * NWARPS;
constexpr int SMEM_MAX = 232448;

enum {
  ERR_ARGS = 100001,  // an argument the kernel does not take
  ERR_PLAN = 100002,  // a launch plan this file does not agree with
};

struct Args {
  const void* x;               // (B, H, W, Cin) f32 or bf16
  const __nv_bfloat16* w1;     // (Cin, Ce)
  const float* b1;             // (Ce)
  const float* wdw;            // (9, Ce)
  const float* bdw;            // (Ce)
  const __nv_bfloat16* w2;     // (Ce, Cout)
  const float* b2;             // (Cout)
  void* out;                   // (B, H, W, Cout), dtype of x
  int B, H, W, Cin, Ce, Cout, rate, skip, x_bf16;
  int th, tw, tiles_x, stages;
  int cin_p, xs_ld, w2_ld;     // padded Cin, row strides (elements)
  int xs_swz;                  // x tile rows swizzled (else padded)
  int x_vec, w1_vec, wdw_vec;  // 16-byte copies possible
  // byte offsets into dynamic shared memory
  int o_xs, o_es, o_ds, o_tab, o_stage, stage_bytes;
  int zrow;                    // the zero row of e (outside the image)
  int s_w1, s_b1, s_w2, s_wdw, s_bdw;  // within a stage
};

__host__ __device__ inline int align16(int n) { return (n + 15) & ~15; }

inline int imin(int p, int q) { return p < q ? p : q; }

// The layout mbconv_smem (kernels/fused_mbconv.py) computes; returns the
// total bytes.
__host__ inline int smem_layout(Args& a, int ck) {
  const int rows = align16(imin(a.th + 2 * a.rate, a.H) *
                           imin(a.tw + 2 * a.rate, a.W));
  int o = 0;
  a.o_xs = o;  o += align16(2 * rows * a.xs_ld);
  a.o_es = o;  o += align16(4 * (rows + 1) * ck);  // + a zero row
  a.o_ds = o;  o += align16(2 * a.th * a.tw * (ck + 8));
  a.o_tab = o; o += align16(2 * 9 * a.th * a.tw);
  a.zrow = rows;
  a.o_stage = o;
  int s = 0;
  a.s_w1 = s;  s += align16(2 * a.cin_p * ck);
  a.s_b1 = s;  s += align16(4 * ck);
  a.s_w2 = s;  s += align16(2 * ck * a.w2_ld);
  a.s_wdw = s; s += align16(4 * 9 * ck);
  a.s_bdw = s; s += align16(4 * ck);
  a.stage_bytes = s;
  return o + a.stages * s;
}

using mbconv::relu6;

using mbconv::cp16;
using mbconv::cp_commit;
using mbconv::cp_wait;
using mbconv::e_swz;
using mbconv::ldm_x4;
using mbconv::ldm_x4_t;
using mbconv::w1_swz;
using mbconv::xs_chunk;

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  mbconv::mma16816(d, a, b0, b1);
}

struct Stage {
  __nv_bfloat16* w1;  // [cin_p][CK], chunks swizzled (w1_swz)
  float* b1;          // [CK]
  __nv_bfloat16* w2;  // [CK][w2_ld]
  float* wdw;         // [9][CK]
  float* bdw;         // [CK]
};

__device__ __forceinline__ Stage stage_at(const Args& a, unsigned char* smem,
                                          int s) {
  unsigned char* base = smem + a.o_stage + s * a.stage_bytes;
  Stage st;
  st.w1 = reinterpret_cast<__nv_bfloat16*>(base + a.s_w1);
  st.b1 = reinterpret_cast<float*>(base + a.s_b1);
  st.w2 = reinterpret_cast<__nv_bfloat16*>(base + a.s_w2);
  st.wdw = reinterpret_cast<float*>(base + a.s_wdw);
  st.bdw = reinterpret_cast<float*>(base + a.s_bdw);
  return st;
}

// f32 row slice [c0, c0 + CK) of a (rows, Ce) array -> dst[rows][CK], zero
// past Ce.  16-byte copies with a partial tail where `vec`, else plain loads.
template <int CK>
__device__ __forceinline__ void load_f32_rows(float* dst, const float* src,
                                              int nrows, int Ce, int c0,
                                              bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < nrows * (CK / 4); i += NTHREADS) {
      const int row = i / (CK / 4), q = i % (CK / 4), col = c0 + 4 * q;
      const int bytes = max(0, min(16, 4 * (Ce - col)));
      cp16(dst + row * CK + 4 * q,
           bytes ? (const void*)(src + (size_t)row * Ce + col) : (const void*)src,
           bytes);
    }
  } else {
    for (int i = threadIdx.x; i < nrows * CK; i += NTHREADS) {
      const int row = i / CK, c = i % CK;
      dst[i] = c0 + c < Ce ? src[(size_t)row * Ce + c0 + c] : 0.f;
    }
  }
}

// One chunk's weights into a stage (rows of w1 past Cin are zeroed once by
// the caller).
template <int CK>
__device__ __forceinline__ void load_chunk(const Args& a, const Stage& st,
                                           int c0) {
  const int tid = threadIdx.x;
  if (a.w1_vec) {
    for (int i = tid; i < a.Cin * (CK / 8); i += NTHREADS) {
      const int k = i / (CK / 8), q = i % (CK / 8), col = c0 + 8 * q;
      const bool in = col < a.Ce;   // Ce % 8 == 0: whole vectors
      cp16(st.w1 + k * CK + 8 * (q ^ w1_swz<CK>(k)),
           in ? (const void*)(a.w1 + (size_t)k * a.Ce + col) : (const void*)a.w1,
           in ? 16 : 0);
    }
  } else {
    for (int i = tid; i < a.Cin * CK; i += NTHREADS) {
      const int k = i / CK, c = i % CK;
      st.w1[k * CK + 8 * ((c >> 3) ^ w1_swz<CK>(k)) + (c & 7)] =
          c0 + c < a.Ce ? a.w1[(size_t)k * a.Ce + c0 + c]
                        : __float2bfloat16(0.f);
    }
  }
  const int vq = a.Cout / 8;
  for (int i = tid; i < CK * vq; i += NTHREADS) {
    const int k = i / vq, q = i % vq;
    const bool in = c0 + k < a.Ce;
    cp16(st.w2 + k * a.w2_ld + 8 * q,
         in ? (const void*)(a.w2 + (size_t)(c0 + k) * a.Cout + 8 * q)
            : (const void*)a.w2,
         in ? 16 : 0);
  }
  load_f32_rows<CK>(st.wdw, a.wdw, 9, a.Ce, c0, a.wdw_vec);
  load_f32_rows<CK>(st.b1, a.b1, 1, a.Ce, c0, true);
  load_f32_rows<CK>(st.bdw, a.bdw, 1, a.Ce, c0, true);
}

// One m-tile of 16 pixels and NT n-tiles of 8 output channels per warp;
// WN warp columns split Cout, NWARPS / WN warp rows split the tile's pixels.
template <int CK, int WN, int NT>
__global__ void __launch_bounds__(NTHREADS, 1)
fused_mbconv_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int WM = NWARPS / WN, TP = WM * 16;
  constexpr int LD = CK + 8;  // row stride of d (bf16); e and w1 rows: CK
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + a.o_xs);
  float* es = reinterpret_cast<float*>(smem + a.o_es);
  __nv_bfloat16* ds = reinterpret_cast<__nv_bfloat16*>(smem + a.o_ds);
  // e row of each tap of each tile pixel (the zero row outside the image)
  short* tab = reinterpret_cast<short*>(smem + a.o_tab);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y;
  const int ty0 = (blockIdx.x / a.tiles_x) * a.th;
  const int tx0 = (blockIdx.x % a.tiles_x) * a.tw;
  const int r = a.rate, H = a.H, W = a.W;
  // the in-image halo box [sy0, sy1) x [sx0, sx1); its pixels are the rows
  // of the x tile and of e, row-major
  const int sy0 = max(ty0 - r, 0), sy1 = min(ty0 + a.th + r, H);
  const int sx0 = max(tx0 - r, 0), sx1 = min(tx0 + a.tw + r, W);
  const int hx = sx1 - sx0, nv = (sy1 - sy0) * hx, mt_n = (nv + 15) >> 4;
  const size_t img = (size_t)b * H * W;
  const int n_chunks = (a.Ce + CK - 1) / CK, S = a.stages;

  // weights of the first S chunks in flight, one commit group each
  for (int s = 0; s < S; ++s) {
    if (s < n_chunks) load_chunk<CK>(a, stage_at(a, smem, s), s * CK);
    cp_commit();
  }
  // the depthwise's tap table and e's zero row: the same for every chunk
  for (int i = tid; i < TP * 9; i += NTHREADS) {
    const int p = i / 9, tap = i % 9, ti = tap / 3, tj = tap % 3;
    const int yy = ty0 + p / a.tw + (ti - 1) * r;
    const int xx = tx0 + p % a.tw + (tj - 1) * r;
    tab[i] = (short)(yy >= 0 && yy < H && xx >= 0 && xx < W
                         ? (yy - sy0) * hx + xx - sx0 : a.zrow);
  }
  for (int i = tid; i < CK; i += NTHREADS) es[a.zrow * CK + i] = 0.f;
  // rows of w1 past Cin (the padding of the k dimension) are zero
  for (int s = 0; s < S; ++s) {
    __nv_bfloat16* w1s = stage_at(a, smem, s).w1;
    for (int i = tid; i < (a.cin_p - a.Cin) * CK; i += NTHREADS)
      w1s[a.Cin * CK + i] = __float2bfloat16(0.f);
  }
  // the x tile as bf16 (zero past Cin)
  if (a.x_vec) {
    const int vq = a.cin_p / 8;
#pragma unroll 4
    for (int i = tid; i < nv * vq; i += NTHREADS) {
      const int hp = i / vq, q = i % vq, k = 8 * q;
      const size_t pix = img + (size_t)(sy0 + hp / hx) * W + sx0 + hp % hx;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (k < a.Cin) {
        if (a.x_bf16) {
          v = *reinterpret_cast<const uint4*>(
              static_cast<const __nv_bfloat16*>(a.x) + pix * a.Cin + k);
        } else {
          const float4* p = reinterpret_cast<const float4*>(
              static_cast<const float*>(a.x) + pix * a.Cin + k);
          const float4 u = p[0], w = p[1];
          __nv_bfloat162 h0 = __floats2bfloat162_rn(u.x, u.y);
          __nv_bfloat162 h1 = __floats2bfloat162_rn(u.z, u.w);
          __nv_bfloat162 h2 = __floats2bfloat162_rn(w.x, w.y);
          __nv_bfloat162 h3 = __floats2bfloat162_rn(w.z, w.w);
          v.x = *reinterpret_cast<uint32_t*>(&h0);
          v.y = *reinterpret_cast<uint32_t*>(&h1);
          v.z = *reinterpret_cast<uint32_t*>(&h2);
          v.w = *reinterpret_cast<uint32_t*>(&h3);
        }
      }
      *reinterpret_cast<uint4*>(xs + hp * a.xs_ld +
                                8 * xs_chunk(a.xs_swz, hp, q)) = v;
    }
  } else {
    for (int i = tid; i < nv * a.cin_p; i += NTHREADS) {
      const int hp = i / a.cin_p, k = i % a.cin_p;
      const size_t pix = img + (size_t)(sy0 + hp / hx) * W + sx0 + hp % hx;
      __nv_bfloat16 v = __float2bfloat16(0.f);
      if (k < a.Cin)
        v = a.x_bf16 ? static_cast<const __nv_bfloat16*>(a.x)[pix * a.Cin + k]
                     : __float2bfloat16(
                           static_cast<const float*>(a.x)[pix * a.Cin + k]);
      xs[hp * a.xs_ld + 8 * xs_chunk(a.xs_swz, hp, k >> 3) + (k & 7)] = v;
    }
  }

  // expand of chunk c: e[hp][n] = relu6(x[hp] . w1[:, n] + b1[n]) for the
  // tile's halo pixels; units of 32 pixels (two m-tiles sharing each B
  // fragment, four independent accumulators) x 16 channels over the warps
  const int mp_n = (mt_n + 1) >> 1;
  auto expand = [&](int c) {
    const Stage st = stage_at(a, smem, c % S);
    for (int u = warp; u < mp_n * (CK / 16); u += NWARPS) {
      const int mt = 2 * (u / (CK / 16)), nh = u % (CK / 16);
      const bool two = mt + 1 < mt_n;  // warp-uniform
      float acc[2][2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[m][j][q] = 0.f;
      // ldmatrix addresses: A rows mt*16 + (lane & 15), k half (lane >> 4);
      // B (k-major) rows kk + (lane & 15), n half (lane >> 4)
      const int ra = mt * 16 + (lane & 15);  // rows ra and ra + 16 swizzle
      const __nv_bfloat16* pa = xs + ra * a.xs_ld;  // alike
      const int kb = lane & 15;  // w1 row kk + kb; w1_swz(kk + kb) = w1_swz(kb)
      const __nv_bfloat16* pb =
          st.w1 + kb * CK + 8 * ((2 * nh + (lane >> 4)) ^ w1_swz<CK>(kb));
#pragma unroll 2
      for (int kk = 0; kk < a.cin_p; kk += 16) {
        uint32_t a0[4], a1[4], bf[4];
        const int ca = 8 * xs_chunk(a.xs_swz, ra, (kk >> 3) + (lane >> 4));
        ldm_x4(a0, pa + ca);
        ldm_x4_t(bf, pb + kk * CK);
        mma(acc[0][0], a0, bf[0], bf[1]);
        mma(acc[0][1], a0, bf[2], bf[3]);
        if (two) {
          ldm_x4(a1, pa + 16 * a.xs_ld + ca);
          mma(acc[1][0], a1, bf[0], bf[1]);
          mma(acc[1][1], a1, bf[2], bf[3]);
        }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        if (m == 1 && !two) break;
        const int h0 = (mt + m) * 16 + g;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = nh * 16 + j * 8 + 2 * t;
          const float c0v = st.b1[n], c1v = st.b1[n + 1];
          // rows h0 and h0 + 8 swizzle alike
          const int ne = n ^ e_swz<CK>(h0);
          *reinterpret_cast<float2*>(es + h0 * CK + ne) = make_float2(
              relu6(acc[m][j][0] + c0v), relu6(acc[m][j][1] + c1v));
          *reinterpret_cast<float2*>(es + (h0 + 8) * CK + ne) = make_float2(
              relu6(acc[m][j][2] + c0v), relu6(acc[m][j][3] + c1v));
        }
      }
    }
  };

  // depthwise of chunk c: d[p][ch] = bf16(relu6(bdw + taps)), dx outer and
  // dy inner, zero outside the image (the table's zero row); a channel pair
  // a thread, two pixels' 18 loads issued before their sums and stores
  auto depthwise = [&](int c) {
    const Stage st = stage_at(a, smem, c % S);
    constexpr int CP = CK / 2, STEP = NTHREADS / CP;
    constexpr int NK = TP / STEP, G = NK < 2 ? NK : 2;
    const int ch = 2 * (tid % CP);
    float2 w[9];
#pragma unroll
    for (int i = 0; i < 9; ++i)
      w[i] = *reinterpret_cast<const float2*>(st.wdw + i * CK + ch);
    const float2 bias = *reinterpret_cast<const float2*>(st.bdw + ch);
#pragma unroll
    for (int k0 = 0; k0 < NK; k0 += G) {
      float2 v[G][9];
#pragma unroll
      for (int q = 0; q < G; ++q) {
        const short* tp = tab + (tid / CP + (k0 + q) * STEP) * 9;
        int off[9];
#pragma unroll
        for (int i = 0; i < 9; ++i) off[i] = tp[i];
#pragma unroll
        for (int i = 0; i < 9; ++i)
          v[q][i] = *reinterpret_cast<const float2*>(
              es + off[i] * CK + (ch ^ e_swz<CK>(off[i])));
      }
#pragma unroll
      for (int q = 0; q < G; ++q) {
        float s0 = bias.x, s1 = bias.y;
#pragma unroll
        for (int j = 0; j < 3; ++j)
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            s0 += v[q][i * 3 + j].x * w[i * 3 + j].x;
            s1 += v[q][i * 3 + j].y * w[i * 3 + j].y;
          }
        const int p = tid / CP + (k0 + q) * STEP;
        *reinterpret_cast<__nv_bfloat162*>(ds + p * LD + ch) =
            __floats2bfloat162_rn(relu6(s0), relu6(s1));
      }
    }
  };

  // project of chunk c into the f32 accumulators
  const int wm = warp % WM, wn = warp / WM;
  const int n_tiles = a.Cout / 8;
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;

  auto project = [&](int c) {
    const Stage st = stage_at(a, smem, c % S);
#pragma unroll
    for (int kk = 0; kk < CK; kk += 16) {
      uint32_t af[4];
      ldm_x4(af, ds + (wm * 16 + (lane & 15)) * LD + kk + (lane >> 4) * 8);
      const __nv_bfloat16* pb = st.w2 + (kk + (lane & 15)) * a.w2_ld +
                                (lane >> 4) * 8;
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        const int nt = wn * NT + j;
        if (nt < n_tiles) {  // the pair's columns stay inside the padded row
          uint32_t bf[4];
          ldm_x4_t(bf, pb + nt * 8);
          mma(acc[j], af, bf[0], bf[1]);
          if (nt + 1 < n_tiles) mma(acc[j + 1], af, bf[2], bf[3]);
        }
      }
    }
  };

  auto wait_ring = [&]() {  // all but the newest S - 2 commit groups landed
    if (S == 3) cp_wait<1>(); else cp_wait<0>();
  };

  wait_ring();
  __syncthreads();
  expand(0);
  __syncthreads();
  depthwise(0);
  for (int c = 0; c < n_chunks; ++c) {
    wait_ring();       // chunk c + 1's weights
    __syncthreads();   // d of chunk c complete; e free
    project(c);
    if (c + 1 < n_chunks) expand(c + 1);
    __syncthreads();   // stage c % S and d free; e of chunk c + 1 complete
    if (c + S < n_chunks) load_chunk<CK>(a, stage_at(a, smem, c % S), (c + S) * CK);
    cp_commit();
    if (c + 1 < n_chunks) depthwise(c + 1);
  }
  cp_wait<0>();

  // epilogue: bias, residual in f32, cast, two channels a store
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int nt = wn * NT + j;
      if (nt >= n_tiles) continue;
      const int n = nt * 8 + 2 * t;
      const float bb0 = a.b2[n], bb1 = a.b2[n + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = wm * 16 + g + 8 * h;
        const int gy = ty0 + p / a.tw, gx = tx0 + p % a.tw;
        if (gy >= H || gx >= W) continue;
        const size_t pix = img + (size_t)gy * W + gx;
        float v0 = acc[j][2 * h] + bb0, v1 = acc[j][2 * h + 1] + bb1;
        if (a.x_bf16) {
          const __nv_bfloat16* xr =
              static_cast<const __nv_bfloat16*>(a.x) + pix * a.Cin + n;
          if (a.skip) {
            v0 += __bfloat162float(xr[0]);
            v1 += __bfloat162float(xr[1]);
          }
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(a.out) + pix * a.Cout + n) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          const float* xr = static_cast<const float*>(a.x) + pix * a.Cin + n;
          if (a.skip) {
            v0 += xr[0];
            v1 += xr[1];
          }
          *reinterpret_cast<float2*>(static_cast<float*>(a.out) +
                                     pix * a.Cout + n) = make_float2(v0, v1);
        }
      }
    }
}

template <int CK, int WN, int NT>
cudaError_t launch_k(const Args& a, int smem, cudaStream_t stream) {
  auto kern = fused_mbconv_kernel<CK, WN, NT>;
  // the largest size set for this instantiation, per device
  static int smem_set[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64 || smem > smem_set[dev]) {
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    if (dev < 64) smem_set[dev] = smem;
  }
  const int tiles_y = (a.H + a.th - 1) / a.th;
  kern<<<dim3(a.tiles_x * tiles_y, a.B), NTHREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// The instantiations: MBCONV_NT in kernels/fused_mbconv.py.
template <int CK>
cudaError_t launch_tile(const Args& a, int nt, int smem, cudaStream_t s) {
  const int tp = a.th * a.tw;
  if (tp == 64) {            // 4 warp rows x 4 warp columns
    if (nt == 2) return launch_k<CK, 4, 2>(a, smem, s);
    if (nt == 4) return launch_k<CK, 4, 4>(a, smem, s);
    if (nt == 10) return launch_k<CK, 4, 10>(a, smem, s);
  } else if (tp == 128) {    // 8 x 2
    if (nt == 2) return launch_k<CK, 2, 2>(a, smem, s);
    if (nt == 4) return launch_k<CK, 2, 4>(a, smem, s);
    if (nt == 6) return launch_k<CK, 2, 6>(a, smem, s);
    if (nt == 10) return launch_k<CK, 2, 10>(a, smem, s);
  } else if (tp == 256) {    // 16 x 1
    if (nt == 2) return launch_k<CK, 1, 2>(a, smem, s);
    if (nt == 4) return launch_k<CK, 1, 4>(a, smem, s);
    if (nt == 8) return launch_k<CK, 1, 8>(a, smem, s);
    if (nt == 12) return launch_k<CK, 1, 12>(a, smem, s);
  }
  return (cudaError_t)ERR_PLAN;
}

}  // namespace

extern "C" {

// Returns 0 or an error code (fused_mbconv_error names it).  The plan
// (th, tw, ck, stages, nt, smem) is kernels/fused_mbconv.py's mbconv_plan;
// a plan whose shared memory this file's layout does not reproduce, or
// whose tile or accumulator it does not instantiate, is refused.
int fused_mbconv_launch(const void* x, const void* w1, const void* b1,
                        const void* wdw, const void* bdw, const void* w2,
                        const void* b2, void* out, int B, int H, int W, int Cin,
                        int Ce, int Cout, int rate, int skip, int x_bf16,
                        int th, int tw, int ck, int stages, int nt, int smem,
                        void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Ce <= 0 || Cout <= 0 ||
      Cout % 8 || rate < 1 || (skip && Cin != Cout))
    return ERR_ARGS;
  if ((uintptr_t)w2 % 16 || (uintptr_t)b1 % 16 || (uintptr_t)bdw % 16 ||
      (uintptr_t)out % 8)
    return ERR_ARGS;
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
  a.rate = rate; a.skip = skip; a.x_bf16 = x_bf16;
  a.th = th; a.tw = tw; a.stages = stages;
  a.tiles_x = (W + tw - 1) / tw;
  a.cin_p = (Cin + 15) / 16 * 16;
  a.xs_swz = (a.cin_p / 8) % 8 == 4;
  a.xs_ld = a.xs_swz ? a.cin_p : a.cin_p + 8;
  a.w2_ld = Cout + ((Cout / 8) % 2 == 0 ? 8 : 16);
  a.x_vec = Cin % 8 == 0 && (uintptr_t)x % 16 == 0;
  a.w1_vec = Ce % 8 == 0 && (uintptr_t)w1 % 16 == 0;
  a.wdw_vec = Ce % 4 == 0 && (uintptr_t)wdw % 16 == 0;
  const bool tile_ok = (th == 16 && tw == 16) || (th == 8 && tw == 16) ||
                       (th == 8 && tw == 8);
  if (!tile_ok || (ck != 16 && ck != 32) || stages < 2 || stages > 3 ||
      smem_layout(a, ck) != smem || smem > SMEM_MAX ||
      nt * (NWARPS * 16 / (th * tw)) * 8 < Cout)
    return ERR_PLAN;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = ck == 32 ? launch_tile<32>(a, nt, smem, s)
                                 : launch_tile<16>(a, nt, smem, s);
  return int(e);
}

const char* fused_mbconv_error(int code) {
  switch (code) {
    case ERR_ARGS: return "arguments the fused_mbconv kernel does not take";
    case ERR_PLAN: return "a launch plan the fused_mbconv kernel does not agree with";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
