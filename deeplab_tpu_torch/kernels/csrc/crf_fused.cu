// The dense CRF's cell-plane kernels for Hopper (sm_90a): splat, norm-pass
// slice, spatial blur, mean-field step, and the plain color blur and slice.
//
// Replaces the TPU kernels of deeplab_tpu/kernels/crf_fused.py:
//   splat_planes          (pl.pallas_call at line 702)
//   slice_attrs_planes    (line 890)
//   gaussian_blur_planes  (line 568, the fused row kernel; where its
//                          geometry does not fit, the y pass at line 628
//                          and the x pass at line 638)
//   mf_step_planes        (line 988; both forms: the unary rebuilt from the
//                          label row, or read from an explicit (Z, L, P)
//                          stream)
//   slice_planes          (line 731)
//
// Layouts (deeplab_tpu_torch/kernels/crf_fused.py): a cell plane is (Z, ch, P)
// with P = cs_y * cs_x pixels, row-major in the cell; a cell's bilateral grid
// is (D, C) with d = b*L + l and c = r*nc + g.  The TPU pads C and D to its
// tiles; these kernels do not.
//
// What bounds them on the H100, and the design.
//
// The TPU builds per-pixel hat-factor matrices t_rg (C x P) and t_lb (D x P)
// and contracts them on its matrix unit, because gathers and scatters are slow
// there.  A pixel's hat weights have at most 2 nonzeros per color channel, so
// a pixel touches 4 (r, g) bins x 2 b bins: the dense form does ~C/4 = 56x
// more work than the data needs at nc = 15.  Here the splat scatters and the
// slice gathers the 8 corners of each pixel.  Counted that way, every kernel
// does a few operations per byte it must move and is bound by device memory:
// its bound is (bytes in + bytes out) / 3.35 TB/s.
//
//  - splat: one block per (cell, group of labels) accumulates its share of
//    the cell's grid in f32 in shared memory with shared-memory atomics (an
//    f32 grid of 315 x 225 is 283 KB, more than a block's 227 KB, so the labels
//    are split into groups that fit), then writes it once.  Work items are
//    (pixel, label) with the label fastest, so the lanes of a warp that add
//    to one bin are few (the pixels of a smooth region share bins).
//  - grid blur (inside slice_attrs and mf_step): one block per (cell, label)
//    stages that label's grid planes in shared memory, runs the joint (r, g) blur as a
//    stencil over the nonzero ones of the TPU's bf16-rounded kron weights,
//    then the b band in f32, and writes the blurred grid in bf16 to device
//    memory (scratch, L2-resident at the main path's sizes).  Once per cell,
//    not once per pixel chunk as on the TPU.
//  - slice_attrs / mf_step / slice pixel pass: one thread per pixel works out
//    its 8 corners once, gathers them for each label from the blurred grid in
//    device memory (the neighbouring pixels of a block share most corners,
//    so the gathers hit L1), and does the messages and the softmax in f32
//    with its L logits in shared memory.  Staging a cell's grid in shared
//    memory (142 KB at nc = 15, L = 21) measured slower: one block per SM.
//    The explicit-unary step reads one more bf16 (L, P) stream; it is its
//    own instantiation, so the labels form's inner loop carries no test of
//    it (a runtime test there measured 9% slower).  slice_planes
//    (the XLA engine's color blur and slice) is the grid blur of an f32 grid
//    followed by the same gather, with f32 outputs and no messages.
//  - spatial blur, the row kernel (the TPU's _blur_row_kernel).  It moves
//    2 bf16 bytes in and 2 out per (pixel, label): 177 MB per production
//    launch, 0.053 ms at 3.35 TB/s; its ~36 f32 multiply-adds per output
//    (17 taps down a column over cs_x + 2r columns, 17 along the row) take
//    ~0.05 ms at the f32 rate, so it is bound by both.  The launch plan
//    (blur_plan in kernels/crf_fused.py) sets the geometry:
//      * one block per (cell, strip, group of labels), a strip being the
//        whole cell wherever it fits, so the 2r halo rows are read once per
//        cell (1.41x at 64x128, r = 8) and not once per 32-row strip;
//      * as few label groups as keep the blocks within one wave of two an
//        SM (at B=8 in production one group of all 21 labels); the cell's
//        f32 gn tile is staged once for the group;
//      * a and gn read in 16-byte vectors (8 bf16, 2 x 4 f32) wherever the
//        halo is a whole number of vectors (cs_x and r multiples of 8;
//        elementwise otherwise), the next label's a held in registers
//        while this label's x pass runs;
//      * A and T in shared memory as bf16 (exact: both hold bf16-rounded
//        values; half the footprint, ~88 KB a block at 64x128);
//      * the y pass one register window a thread, a column pair by 16 rows
//        (16 + 2r rows read for 32 outputs), one thread per window (288 at
//        64x128); the x pass 8 outputs a thread from 16-byte reads of T,
//        written with one 16-byte store;
//      * the tap count a template parameter: 17 on the main path, every
//        other count up to 33 in the generic instantiation (8-row
//        windows).
//    Its multiply-adds are explicit fused ones: a product of two bf16
//    values is exact in f32, so fmaf(t, v, acc) rounds as the plain
//    versions' multiply then add (unless the product falls below f32's
//    normal range), and the kernel equals the chained y and x plain passes
//    bit for bit.  It takes cells whose width is a multiple of 4 and radii
//    up to 16; gaussian_blur_planes sends it cells whose height is a
//    multiple of 16.
//  - spatial blur in two passes, for every other geometry (cs_y = 75, 50 or
//    72 from VOC image heights; radii past 16): the y pass, one block per
//    (cell, label, strip of rows), stages bf16(Q * gn) with r halo rows from
//    the cells above and below and sums each output down its column; the x
//    pass, one block per (cell, label, strip of rows), stages the rows with
//    r halo columns from the cells left and right and sums along the row.
//    Threads take (row, column) pairs, neighbouring threads neighbouring
//    columns; the taps sit in shared memory, so any radius up to 128 runs
//    without a register window.  Each pass reads its input about once (the
//    halo adds 2r rows or columns a strip) and writes a bf16 (B*Z, L, P)
//    tensor: together twice the row kernel's device-memory traffic, but
//    every input read about once where the row kernel at cs_y = 75 (a strip
//    of one row) reads each 1 + 2r times.
//
// Measured on the H100 (PERF.md): each kernel takes several times its bound;
// making them fast is later work.
//
// Rounding points are the TPU's, so that a kernel and its plain version differ
// only in summation order: bf16 operands whose products are exact in f32,
// f32 accumulation, and bf16 roundings where the TPU rounds.  This file is
// compiled with -fmad=false (kernels/build.py), so an f32 a*b + c rounds twice
// as it does in the plain version.  Blocks are independent and run in any
// order; shared-memory atomics make the splat's f32 sums vary in their last
// bit from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Dynamic shared memory of every kernel here, cast to what each one stages.
extern __shared__ __align__(16) unsigned char dyn_smem[];

namespace {

typedef __nv_bfloat16 bf16;

constexpr int MAX_CTAPS = 7;    // color band taps (radius <= 3)
constexpr int MAX_STAPS = 33;   // the row kernel's taps (radius <= 16)
constexpr int MAX_YX_TAPS = 257;  // the two-pass blur: radius <= 128
constexpr int ATTR_ROWS = 8, ATTR_GN = 3, ATTR_BN = 4, ATTR_BSELF = 5,
              ATTR_LABEL = 6, ATTR_BSCALE = 7;
constexpr int SPLAT_GROUP = 48 * 1024;  // splat: shared-memory grid per block
constexpr int SMEM_MAX = 227 * 1024;

enum {
  ERR_ARGS = 100001,      // an argument the kernels do not take
  ERR_SMEM = 100002,      // a tile that does not fit in shared memory
  ERR_PLAN = 100003,      // a launch plan this file does not agree with
};

struct ColorTaps {
  int n;                            // 2R + 1
  int nrg;                          // nonzero joint (r, g) weights
  signed char dr[MAX_CTAPS * MAX_CTAPS], dg[MAX_CTAPS * MAX_CTAPS];
  float rg[MAX_CTAPS * MAX_CTAPS];  // bf16(t_i * t_j) at offset (dr, dg)
  float b[MAX_CTAPS];               // f32 band taps of the b axis
};

struct SpatialTaps {
  int n;                 // 2r + 1
  float t[MAX_STAPS];    // bf16-rounded
};

struct LongTaps {
  int n;                 // 2r + 1
  float t[MAX_YX_TAPS];  // bf16-rounded
};

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The two hat weights max(1 - |bin - c|, 0) of coordinate c, on bins i and
// i + 1, computed as the dense form computes them.
struct Hat {
  int i;
  float w0, w1;
};
__device__ __forceinline__ Hat hat(float c) {
  Hat h;
  const float f = floorf(c);
  h.i = (int)f;
  h.w0 = fmaxf(1.f - fabsf(f - c), 0.f);
  h.w1 = fmaxf(1.f - fabsf((f + 1.f) - c), 0.f);
  return h;
}

// Labels per block so that `per_label` bytes each fit in `budget`, spread
// evenly over the fewest groups.
int label_group(int L, size_t per_label, size_t budget) {
  int gmax = (int)(budget / per_label);
  if (gmax < 1) gmax = 1;
  const int groups = (L + gmax - 1) / gmax;
  return (L + groups - 1) / groups;
}

cudaError_t set_smem(const void* fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// ---------------------------------------------------------------- splat ----
// G[z, b*L + l, r*nc + g] += bf16(bf16(v * s) * bf16(w_b)) * bf16(w_r * w_g),
// s the ATTR_BSCALE row of packed attrs planes, 1 for plain rgb planes
template <typename TV, typename TO>
__global__ void splat_kernel(const float* __restrict__ rgb, int rows,
                             const TV* __restrict__ vals, TO* __restrict__ out,
                             int P, int L, int nc, float inv_step, int Lg) {
  float* acc = reinterpret_cast<float*>(dyn_smem);  // [nc][Lc][C]
  const int z = blockIdx.x, l0 = blockIdx.y * Lg;
  const int Lc = min(Lg, L - l0);
  const int C = nc * nc, n = nc * Lc * C;
  for (int i = threadIdx.x; i < n; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();
  const float* px = rgb + (size_t)z * rows * P;
  const int items = P * Lc;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int p = it / Lc, lg = it - p * Lc;
    const float s = rows == ATTR_ROWS ? px[ATTR_BSCALE * P + p] : 1.f;
    const float v = ld(vals + ((size_t)z * L + l0 + lg) * P + p);
    const float vb = bf16r(v * s);
    if (vb == 0.f) continue;
    const Hat hr = hat(px[p] * inv_step), hg = hat(px[P + p] * inv_step),
              hb = hat(px[2 * P + p] * inv_step);
#pragma unroll
    for (int kb = 0; kb < 2; ++kb) {
      const int b = hb.i + kb;
      const float wb = kb ? hb.w1 : hb.w0;
      if (b < 0 || b >= nc || wb == 0.f) continue;
      const float t = bf16r(vb * bf16r(wb));
      float* row = acc + (size_t)(b * Lc + lg) * C;
#pragma unroll
      for (int kr = 0; kr < 2; ++kr) {
        const int r = hr.i + kr;
        const float wr = kr ? hr.w1 : hr.w0;
        if (r < 0 || r >= nc || wr == 0.f) continue;
#pragma unroll
        for (int kg = 0; kg < 2; ++kg) {
          const int g = hg.i + kg;
          const float wg = kg ? hg.w1 : hg.w0;
          if (g < 0 || g >= nc || wg == 0.f) continue;
          atomicAdd(row + r * nc + g, t * bf16r(wr * wg));
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int c = i % C, bl = i / C, lg = bl % Lc, b = bl / Lc;
    st(out + ((size_t)z * nc * L + b * L + l0 + lg) * C + c, acc[i]);
  }
}

// ------------------------------------------------------------ grid blur ----
// out[z, b*L + l, (r, g)] = bf16( sum_off t_b[off] *
//     sum_{dr, dg} bf16(G[z, (b+off)*L + l, (r-dr, g-dg)]) * W[dr][dg] )
template <typename TI>
__global__ void grid_blur_kernel(const TI* __restrict__ g,
                                 bf16* __restrict__ out, int L, int nc,
                                 ColorTaps taps) {
  const int z = blockIdx.x, l = blockIdx.y;
  const int C = nc * nc, R = taps.n / 2;
  float* src = reinterpret_cast<float*>(dyn_smem);  // [nc][C], bf16-rounded
  float* blr = src + (size_t)nc * C;                // after the (r, g) blur
  const size_t base = (size_t)z * nc * L * C + (size_t)l * C;  // + b*L*C
  // a thread owns grid columns c = (r, g) across the nc b planes
  for (int c = threadIdx.x; c < C; c += blockDim.x)
    for (int b = 0; b < nc; ++b)
      src[b * C + c] = bf16r(ld(g + base + (size_t)b * L * C + c));
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int r2 = c / nc, g2 = c - r2 * nc;
    for (int b = 0; b < nc; ++b) {
      const float* sp = src + b * C;
      float a = 0.f;
      for (int t = 0; t < taps.nrg; ++t) {  // (dr, dg) row-major, zeros left out
        const int r1 = r2 - taps.dr[t], g1 = g2 - taps.dg[t];
        if (r1 < 0 || r1 >= nc || g1 < 0 || g1 >= nc) continue;
        a += sp[r1 * nc + g1] * taps.rg[t];
      }
      blr[b * C + c] = a;
    }
    // the b band reads only this thread's column: no barrier needed
    for (int b = 0; b < nc; ++b) {
      float a = 0.f;
      for (int off = -R; off <= R; ++off) {
        const int b2 = b + off;
        if (b2 < 0 || b2 >= nc) continue;
        a += blr[b2 * C + c] * taps.b[off + R];
      }
      out[base + (size_t)b * L * C + c] = __float2bfloat16_rn(a);
    }
  }
}

// A pixel's 8 grid corners: offsets in a (D, C) grid at label 0 (label l
// adds l*C) and weights bf16(w_r * w_g), kb-major then r, g; corners off the
// grid get weight 0.  wb: the f32 hat weights of its two b bins.
struct Corners {
  int off[8];
  float w[8];
  float wb[2];
};

__device__ __forceinline__ Corners corners(const Hat& hr, const Hat& hg,
                                           const Hat& hb, int L, int nc) {
  Corners k;
  const int C = nc * nc;
#pragma unroll
  for (int kb = 0; kb < 2; ++kb) {
    const int b = hb.i + kb;
    const bool bok = b >= 0 && b < nc;
    k.wb[kb] = bok ? (kb ? hb.w1 : hb.w0) : 0.f;
#pragma unroll
    for (int kr = 0; kr < 2; ++kr) {
      const int r = hr.i + kr;
      const float wr = kr ? hr.w1 : hr.w0;
#pragma unroll
      for (int kg = 0; kg < 2; ++kg) {
        const int g = hg.i + kg;
        const float wg = kg ? hg.w1 : hg.w0;
        const bool ok = bok && r >= 0 && r < nc && g >= 0 && g < nc;
        const int j = kb * 4 + kr * 2 + kg;
        k.off[j] = ok ? b * L * C + r * nc + g : 0;
        k.w[j] = ok ? bf16r(wr * wg) : 0.f;
      }
    }
  }
  return k;
}

// Slice at one pixel, label offset lC = l*C: per b bin the sum over the 4
// (r, g) corners of grid * weight in f32, then the b hat weights, in the
// TPU's order (the zero-weight corners add exact zeros).
__device__ __forceinline__ float slice_at(const bf16* gb, const Corners& k,
                                          int lC) {
  float m[2];
#pragma unroll
  for (int kb = 0; kb < 2; ++kb) {
    m[kb] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      m[kb] += ld(gb + lC + k.off[kb * 4 + j]) * k.w[kb * 4 + j];
  }
  return m[0] * k.wb[0] + m[1] * k.wb[1];
}

// ------------------------------------------------------ slice_attrs pass ----
struct AttrsArgs {
  const float* rgb;       // (BZ, 3, P)
  const bf16* gblur;      // (BZ, nc, C) blurred norm grid
  const float* gn;        // (Z, 1, P)
  const int* labels;      // (BZ, 1, P)
  float* attrs;           // (BZ, 8, P)
  bf16* q0;               // (BZ, L, P)
  float* attrs_sub;       // (BZ, 8, Ps) or null
  bf16* q0_sub;           // (BZ, L, Ps) or null
  int Z, P, L, nc, stride, cs_y, cs_x, h, w, nx;
  float inv_step, b0, b1, q0_lab, q0_other;
};

__global__ void slice_attrs_kernel(AttrsArgs a) {
  const int z = blockIdx.x, P = a.P, C = a.nc * a.nc;
  const bf16* gb = a.gblur + (size_t)z * a.nc * C;
  const int zz = z % a.Z, iy = zz / a.nx, ix = zz % a.nx;
  const int s = a.stride, xs = a.cs_x / s, Ps = P / (s * s);
  const int p = blockIdx.y * blockDim.x + threadIdx.x;
  if (p < P) {
    float col[3], per[3];
    Hat h[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      col[k] = a.rgb[((size_t)z * 3 + k) * P + p];
      const float c = col[k] * a.inv_step;
      h[k] = hat(c);
      const float s1 = c - floorf(c), s0 = 1.f - s1;
      per[k] = (s0 * s0 + s1 * s1) * a.b0 + 2.f * s0 * s1 * a.b1;
    }
    const float filt = slice_at(gb, corners(h[0], h[1], h[2], 1, a.nc), 0);
    const float bself = per[0] * per[1] * per[2];
    const int py = p / a.cs_x, px = p - py * a.cs_x;
    const float valid =
        (iy * a.cs_y + py < a.h && ix * a.cs_x + px < a.w) ? 1.f : 0.f;
    const float fl = s > 1 ? bself : 1e-20f;
    const float bn = 1.f / sqrtf(fmaxf(filt - bself, fl));
    const float bscale = bn * valid * (float)(s * s);
    const float lab = (float)a.labels[(size_t)z * P + p];
    const float row[ATTR_ROWS] = {col[0], col[1], col[2],
                                  a.gn[(size_t)zz * P + p], bn, bself, lab,
                                  bscale};
    const bool on_sub = s > 1 && py % s == 0 && px % s == 0;
    const int ps = (py / s) * xs + px / s;
#pragma unroll
    for (int k = 0; k < ATTR_ROWS; ++k) {
      a.attrs[((size_t)z * ATTR_ROWS + k) * P + p] = row[k];
      if (on_sub) a.attrs_sub[((size_t)z * ATTR_ROWS + k) * Ps + ps] = row[k];
    }
    for (int l = 0; l < a.L; ++l) {
      const bf16 q = __float2bfloat16_rn((float)l == lab ? a.q0_lab
                                                         : a.q0_other);
      a.q0[((size_t)z * a.L + l) * P + p] = q;
      if (on_sub) a.q0_sub[((size_t)z * a.L + l) * Ps + ps] = q;
    }
  }
}

// ----------------------------------------------------------- mf_step pass ----
struct StepArgs {
  const float* attrs;     // (Z, 8, P)
  const bf16* gblur;      // (Z, D, C) blurred grid
  const bf16* fg;         // (Z, L, P) spatial filter of Q * gn
  const bf16* q;          // (Z, L, P)
  bf16* out;              // (Z, L, P)
  bf16* out_sub;          // (Z, L, Ps) or null
  const bf16* unary;      // (Z, L, P) explicit energies, or null: the
                          // two-level unary from the label row
  int P, L, nc, stride, cs_x;
  float inv_step, cg, cb, n_energy, p_energy;
};

template <bool UNARY>
__global__ void __launch_bounds__(256) mf_step_kernel(StepArgs a) {
  const int z = blockIdx.x, P = a.P, L = a.L, C = a.nc * a.nc;
  // gathers from the cell's blurred grid in device memory (L2-resident);
  // shared memory holds each thread's L logits, [L][blockDim] (a register
  // array of them spilled to local memory)
  const bf16* gb = a.gblur + (size_t)z * a.nc * L * C;
  float* lg = reinterpret_cast<float*>(dyn_smem) + threadIdx.x;
  const int s = a.stride, xs = a.cs_x / s, Ps = P / (s * s);
  const int T = blockDim.x;
  const float* at = a.attrs + (size_t)z * ATTR_ROWS * P;
  const int p = blockIdx.y * blockDim.x + threadIdx.x;
  if (p < P) {
    const Hat hr = hat(at[p] * a.inv_step), hg = hat(at[P + p] * a.inv_step),
              hb = hat(at[2 * P + p] * a.inv_step);
    const Corners k = corners(hr, hg, hb, L, a.nc);
    const float gn = at[ATTR_GN * P + p], bn = at[ATTR_BN * P + p];
    const float bself = at[ATTR_BSELF * P + p], lab = at[ATTR_LABEL * P + p];
    float mx = -INFINITY;
#pragma unroll 4
    for (int l = 0; l < L; ++l) {
      const size_t o = ((size_t)z * L + l) * P + p;
      const float filt = slice_at(gb, k, l * C);
      const float q = __bfloat162float(a.q[o]);
      const float msg_g = (__bfloat162float(a.fg[o]) - q * gn) * gn;
      const float msg_b = fmaxf(filt - bself * bn * q, 0.f) * bn;
      const float u = UNARY ? __bfloat162float(a.unary[o])
                            : ((float)l == lab ? a.p_energy : a.n_energy);
      const float v = -u + a.cg * msg_g + a.cb * msg_b;
      lg[l * T] = v;
      mx = fmaxf(mx, v);
    }
    float sum = 0.f;
    for (int l = 0; l < L; ++l) {
      const float e = expf(lg[l * T] - mx);
      lg[l * T] = e;
      sum += e;
    }
    const int py = p / a.cs_x, px = p - py * a.cs_x;
    const bool on_sub = a.out_sub && py % s == 0 && px % s == 0;
    const int ps = (py / s) * xs + px / s;
    for (int l = 0; l < L; ++l) {
      const bf16 v = __float2bfloat16_rn(lg[l * T] / sum);
      a.out[((size_t)z * L + l) * P + p] = v;
      if (on_sub) a.out_sub[((size_t)z * L + l) * Ps + ps] = v;
    }
  }
}

// ------------------------------------------------------------- slice pass ----
// out[z, l, p] = the slice at pixel p of the blurred grid's label-l planes, f32
struct SliceArgs {
  const float* rgb;       // (Z, 3, P)
  const bf16* gblur;      // (Z, D, C) blurred grid
  float* out;             // (Z, L, P)
  int P, L, nc;
  float inv_step;
};

__global__ void __launch_bounds__(256) slice_kernel(SliceArgs a) {
  const int z = blockIdx.x, P = a.P, L = a.L, C = a.nc * a.nc;
  const bf16* gb = a.gblur + (size_t)z * a.nc * L * C;
  const float* px = a.rgb + (size_t)z * 3 * P;
  const int p = blockIdx.y * blockDim.x + threadIdx.x;
  if (p < P) {
    const Hat hr = hat(px[p] * a.inv_step), hg = hat(px[P + p] * a.inv_step),
              hb = hat(px[2 * P + p] * a.inv_step);
    const Corners k = corners(hr, hg, hb, L, a.nc);
    float* o = a.out + (size_t)z * L * P + p;
    for (int l = 0; l < L; ++l) o[(size_t)l * P] = slice_at(gb, k, l * C);
  }
}

// --------------------------------------------------------- spatial blur ----
// The row kernel.  One block per (cell, strip of ty rows, group of lg
// labels): the gn tile once, then per label A = bf16(a * gn) with an r-pixel
// halo from the neighbouring cells, the y pass into T and the x pass out.
// A and T hold bf16 (exact: both are bf16-rounded values).  Rows of the
// three tiles have a pitch of wp elements (cs_x + 2r rounded up to 8).
// at most 384 threads a block; the main path's instantiation two blocks an
// SM (85 registers a thread), the generic one one (its window is larger)
constexpr int BLUR_MAX_THREADS = 384;
constexpr int BLUR_PREFETCH = 6;  // 16-byte words of a a thread prefetches

// Rows of a y-pass thread's register window: 16 for the main path's 17
// taps, 8 for the generic tap count (blur_ry in kernels/crf_fused.py).
__host__ __device__ constexpr int blur_ry(int ntaps_template) {
  return ntaps_template == 17 ? 16 : 8;
}

struct BlurArgs {
  const bf16* a;          // (B*Z, L, P)
  const float* gn;        // (Z, 1, P), one plane per image position
  bf16* out;              // (B*Z, L, P)
  int ny, nx, cs_y, cs_x, L, ty, lg, wp, vec;  // blockDim.x: the plan's
  SpatialTaps taps;
};

// Bytes of a block's tiles: blur_smem in kernels/crf_fused.py.
inline size_t blur_smem(int ty, int wp, int r, int ry) {
  const int ty_p = (ty + ry - 1) / ry * ry;
  return (size_t)(ty_p + 2 * r) * wp * (sizeof(float) + sizeof(bf16)) +
         (size_t)ty_p * wp * sizeof(bf16);
}

// the four bf16 pairs of a 16-byte word
__device__ __forceinline__ __nv_bfloat162* bf2x4(uint4* u) {
  return reinterpret_cast<__nv_bfloat162*>(u);
}

// Every tap sum runs in tap order with one rounding a term: the
// products of two bf16 values are exact in f32, so fmaf(t, v, acc) equals
// acc + t*v rounded once, as the plain versions' separate multiply and add
// (the file's -fmad=false keeps every other a*b + c in two roundings).
// NT: the tap count (17 on the main path), or 0 for any count up to
// MAX_STAPS with the count read at run time.
template <int NT>
__global__ void __launch_bounds__(BLUR_MAX_THREADS, NT ? 2 : 1)
blur_kernel(BlurArgs a) {
  constexpr int KMAX = NT ? NT : MAX_STAPS, RY = blur_ry(NT);
  const int nthr = blockDim.x;
  const int n = NT ? NT : a.taps.n, r = n / 2;
  const int wp = a.wp, Wd = a.cs_x + 2 * r;
  const int Z = a.ny * a.nx, P = a.cs_y * a.cs_x;
  const int z = blockIdx.x, bimg = z / Z, zz = z % Z;
  const int iy = zz / a.nx, ix = zz % a.nx;
  const int y0 = blockIdx.y * a.ty, rows = min(a.ty, a.cs_y - y0);
  const int ty_p = (rows + RY - 1) / RY * RY;
  const int H2 = rows + 2 * r;
  const int ty_alloc = (a.ty + RY - 1) / RY * RY;
  float* G = reinterpret_cast<float*>(dyn_smem);          // [ty+2r][wp] gn
  bf16* A = reinterpret_cast<bf16*>(G + (size_t)(ty_alloc + 2 * r) * wp);
  bf16* T = A + (size_t)(ty_alloc + 2 * r) * wp;          // [ty][wp]
  const int V = a.vec ? 8 : 1;       // elements a staging item covers
  const int units = Wd / V;          // items a row
  const int tid = threadIdx.x;

  // source of staging item (row yy, unit u): plane offset of its cell and
  // pixel, or -1 outside the image
  auto src = [&](int i, int* zz2_out) -> int {
    const int yy = i / units, xx = (i - yy * units) * V;
    const int cy = y0 + yy - r, cx = xx - r;
    const int dy = cy < 0 ? -1 : (cy >= a.cs_y ? 1 : 0);
    const int dx = cx < 0 ? -1 : (cx >= a.cs_x ? 1 : 0);
    const int iy2 = iy + dy, ix2 = ix + dx;
    if (iy2 < 0 || iy2 >= a.ny || ix2 < 0 || ix2 >= a.nx) return -1;
    *zz2_out = iy2 * a.nx + ix2;
    return (cy - dy * a.cs_y) * a.cs_x + cx - dx * a.cs_x;
  };

  // the gn tile, once for the block's labels
  for (int i = tid; i < H2 * units; i += nthr) {
    const int yy = i / units, xx = (i - yy * units) * V;
    int zz2 = 0;
    const int p = src(i, &zz2);
    float* dst = G + yy * wp + xx;
    if (V == 8) {
      float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
      if (p >= 0) {
        const float4* s4 =
            reinterpret_cast<const float4*>(a.gn + (size_t)zz2 * P + p);
        lo = s4[0];
        hi = s4[1];
      }
      reinterpret_cast<float4*>(dst)[0] = lo;
      reinterpret_cast<float4*>(dst)[1] = hi;
    } else {
      *dst = p >= 0 ? a.gn[(size_t)zz2 * P + p] : 0.f;
    }
  }

  // With 16-byte staging, a thread holds its words of the next label's a in
  // registers: their loads are in flight during this label's x pass.  Its
  // words' places do not depend on the label: their offsets in a (label 0;
  // -1 outside the image) and in the tile are worked out once.
  const int items = H2 * units;
  const bool prefetch = V == 8 && items <= BLUR_PREFETCH * nthr;
  uint4 next[BLUR_PREFETCH];
  int src_at[BLUR_PREFETCH], tile_at[BLUR_PREFETCH];
#pragma unroll
  for (int q = 0; q < BLUR_PREFETCH; ++q) {
    const int i = tid + q * nthr;
    int zz2 = 0;
    const int p = prefetch && i < items ? src(i, &zz2) : -1;
    src_at[q] = p >= 0 ? (bimg * Z + zz2) * a.L * P + p : -1;
    const int yy = i / units;
    tile_at[q] = i < items ? yy * wp + (i - yy * units) * 8 : -1;
  }
  auto fetch = [&](int l) {
#pragma unroll
    for (int q = 0; q < BLUR_PREFETCH; ++q) {
      next[q] = make_uint4(0, 0, 0, 0);
      if (src_at[q] >= 0)
        next[q] = *reinterpret_cast<const uint4*>(a.a + src_at[q] +
                                                  (size_t)l * P);
    }
  };
  const int l0 = blockIdx.z * a.lg, l_end = min(a.L, l0 + a.lg);
  if (prefetch) fetch(l0);
  __syncthreads();   // the gn tile
  for (int l = l0; l < l_end; ++l) {
    // A = bf16(a * gn), zero outside the image
    if (prefetch) {
#pragma unroll
      for (int q = 0; q < BLUR_PREFETCH; ++q) {
        if (tile_at[q] < 0) break;
        const float4* g = reinterpret_cast<const float4*>(G + tile_at[q]);
        const float4 g0 = g[0], g1 = g[1];
        const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
        uint4 v;
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const float2 f = __bfloat1622float2(bf2x4(&next[q])[h]);
          bf2x4(&v)[h] =
              __floats2bfloat162_rn(f.x * gv[2 * h], f.y * gv[2 * h + 1]);
        }
        *reinterpret_cast<uint4*>(A + tile_at[q]) = v;
      }
    }
    for (int i = tid; !prefetch && i < items; i += nthr) {
      const int yy = i / units, xx = (i - yy * units) * V;
      int zz2 = 0;
      const int p = src(i, &zz2);
      const size_t plane = ((size_t)bimg * Z + zz2) * a.L + l;
      bf16* dst = A + yy * wp + xx;
      const float* g = G + yy * wp + xx;
      if (V == 8) {
        uint4 v = make_uint4(0, 0, 0, 0);
        if (p >= 0) {
          uint4 s = *reinterpret_cast<const uint4*>(a.a + plane * P + p);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float2 f = __bfloat1622float2(bf2x4(&s)[q]);
            bf2x4(&v)[q] =
                __floats2bfloat162_rn(f.x * g[2 * q], f.y * g[2 * q + 1]);
          }
        }
        *reinterpret_cast<uint4*>(dst) = v;
      } else {
        *dst = __float2bfloat16_rn(
            p >= 0 ? __bfloat162float(a.a[plane * P + p]) * *g : 0.f);
      }
    }
    __syncthreads();
    // y pass: a column pair and RY rows a thread, from a register
    // window of RY + n - 1 rows; T = bf16(sum) in tap order
    const int pairs = Wd / 2, segs = ty_p / RY;
    for (int i = tid; i < pairs * segs; i += nthr) {
      const int seg = i / pairs, cp = i - seg * pairs;
      const bf16* col = A + (size_t)seg * RY * wp + 2 * cp;
      float2 win[RY + KMAX - 1];
#pragma unroll
      for (int m = 0; m < RY + KMAX - 1; ++m)
        if (NT || m < RY + n - 1)
          win[m] = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(col + m * wp));
#pragma unroll
      for (int j = 0; j < RY; ++j) {
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int k = 0; k < KMAX; ++k)
          if (NT || k < n) {
            s0 = __fmaf_rn(a.taps.t[k], win[j + k].x, s0);
            s1 = __fmaf_rn(a.taps.t[k], win[j + k].y, s1);
          }
        *reinterpret_cast<__nv_bfloat162*>(
            T + (size_t)(seg * RY + j) * wp + 2 * cp) =
            __floats2bfloat162_rn(s0, s1);
      }
    }
    __syncthreads();
    if (prefetch && l + 1 < l_end) fetch(l + 1);
    // x pass: 8 outputs a thread (4 where cs_x % 8 != 0) from 16-byte (8-
    // byte) reads of T, written with one store
    bf16* o = a.out + ((size_t)z * a.L + l) * P + (size_t)y0 * a.cs_x;
    if (a.cs_x % 8 == 0) {
      const int xq = a.cs_x / 8;
      for (int i = tid; i < rows * xq; i += nthr) {
        const int yy = i / xq, x0 = (i - yy * xq) * 8;
        const uint4* row = reinterpret_cast<const uint4*>(T + yy * wp + x0);
        constexpr int NV = (8 + KMAX - 1 + 7) / 8;
        float win[8 * NV];
#pragma unroll
        for (int q = 0; q < NV; ++q)
          if (NT || 8 * q < 8 + n - 1) {
            uint4 v = row[q];
#pragma unroll
            for (int h = 0; h < 4; ++h) {
              const float2 f = __bfloat1622float2(bf2x4(&v)[h]);
              win[8 * q + 2 * h] = f.x;
              win[8 * q + 2 * h + 1] = f.y;
            }
          }
        float acc[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float s = 0.f;
#pragma unroll
          for (int k = 0; k < KMAX; ++k)
            if (NT || k < n) s = __fmaf_rn(a.taps.t[k], win[j + k], s);
          acc[j] = s;
        }
        uint4 w;
#pragma unroll
        for (int h = 0; h < 4; ++h)
          bf2x4(&w)[h] = __floats2bfloat162_rn(acc[2 * h], acc[2 * h + 1]);
        *reinterpret_cast<uint4*>(o + yy * a.cs_x + x0) = w;
      }
    } else {
      const int xq = a.cs_x / 4;
      for (int i = tid; i < rows * xq; i += nthr) {
        const int yy = i / xq, x0 = (i - yy * xq) * 4;
        const uint2* row = reinterpret_cast<const uint2*>(T + yy * wp + x0);
        constexpr int NV = (4 + KMAX - 1 + 3) / 4;
        float win[4 * NV];
#pragma unroll
        for (int q = 0; q < NV; ++q)
          if (NT || 4 * q < 4 + n - 1) {
            const uint2 u = row[q];
            const float2 f0 = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&u.x));
            const float2 f1 = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&u.y));
            win[4 * q] = f0.x; win[4 * q + 1] = f0.y;
            win[4 * q + 2] = f1.x; win[4 * q + 3] = f1.y;
          }
        __nv_bfloat162 h[2];
#pragma unroll
        for (int j = 0; j < 4; j += 2) {
          float s0 = 0.f, s1 = 0.f;
#pragma unroll
          for (int k = 0; k < KMAX; ++k)
            if (NT || k < n) {
              s0 = __fmaf_rn(a.taps.t[k], win[j + k], s0);
              s1 = __fmaf_rn(a.taps.t[k], win[j + 1 + k], s1);
            }
          h[j / 2] = __floats2bfloat162_rn(s0, s1);
        }
        uint2 w;
        w.x = *reinterpret_cast<uint32_t*>(&h[0]);
        w.y = *reinterpret_cast<uint32_t*>(&h[1]);
        *reinterpret_cast<uint2*>(o + yy * a.cs_x + x0) = w;
      }
    }
  }
}

// The two-pass blur's arguments; `in` is a for the y pass, its output for
// the x pass.
struct BlurPassArgs {
  const bf16* in;         // (B*Z, L, P)
  const float* gn;        // y pass: (Z, 1, P), one plane per image position,
                          // or (B*Z, 1, P) when gn_per_image; x: unused
  bf16* out;              // (B*Z, L, P)
  int ny, nx, cs_y, cs_x, L, TY, gn_per_image;
  LongTaps taps;
};

__device__ __forceinline__ void stage_taps(const LongTaps& taps, float* t) {
  for (int i = threadIdx.x; i < taps.n; i += blockDim.x) t[i] = taps.t[i];
}

// y pass: rows y0 - r .. y0 + rows + r - 1 of this cell's columns, found
// by image row in the cells above and below (zero outside the image), then
// each output the taps down its column in tap order.
__global__ void blur_y_kernel(BlurPassArgs a) {
  float* tap = reinterpret_cast<float*>(dyn_smem);
  const int n = a.taps.n, r = n / 2;
  float* A = tap + ((n + 3) & ~3);   // [rows + 2r][cs_x]  bf16(a * gn)
  const int Z = a.ny * a.nx, P = a.cs_y * a.cs_x, H = a.ny * a.cs_y;
  const int z = blockIdx.x / a.L, l = blockIdx.x % a.L;
  const int bimg = z / Z, zz = z % Z, iy = zz / a.nx, ix = zz % a.nx;
  const int y0 = blockIdx.y * a.TY, rows = min(a.TY, a.cs_y - y0);
  const float* gn = a.gn + (a.gn_per_image ? (size_t)bimg * Z * P : 0);
  stage_taps(a.taps, tap);
  for (int i = threadIdx.x; i < (rows + 2 * r) * a.cs_x; i += blockDim.x) {
    const int yy = i / a.cs_x, x = i - yy * a.cs_x;
    const int gy = iy * a.cs_y + y0 + yy - r;
    float v = 0.f;
    if (gy >= 0 && gy < H) {
      const int iy2 = gy / a.cs_y, p = (gy - iy2 * a.cs_y) * a.cs_x + x;
      const int zz2 = iy2 * a.nx + ix;
      const size_t z2 = (size_t)bimg * Z + zz2;
      v = bf16r(__bfloat162float(a.in[(z2 * a.L + l) * P + p]) *
                gn[(size_t)zz2 * P + p]);
    }
    A[i] = v;
  }
  __syncthreads();
  bf16* o = a.out + ((size_t)z * a.L + l) * P + (size_t)y0 * a.cs_x;
  for (int i = threadIdx.x; i < rows * a.cs_x; i += blockDim.x) {
    const float* col = A + i;        // output (yy, x) reads A[yy + k][x]
    float acc = 0.f;
    for (int k = 0; k < n; ++k) acc += tap[k] * col[k * a.cs_x];
    o[i] = __float2bfloat16_rn(acc);
  }
}

// x pass: the strip's rows with r halo columns from the cells left and
// right (zero outside the image), then each output the taps along its row.
__global__ void blur_x_kernel(BlurPassArgs a) {
  float* tap = reinterpret_cast<float*>(dyn_smem);
  const int n = a.taps.n, r = n / 2, W2 = a.cs_x + 2 * r;
  float* T = tap + ((n + 3) & ~3);   // [rows][cs_x + 2r]
  const int Z = a.ny * a.nx, P = a.cs_y * a.cs_x, W = a.nx * a.cs_x;
  const int z = blockIdx.x / a.L, l = blockIdx.x % a.L;
  const int bimg = z / Z, zz = z % Z, iy = zz / a.nx, ix = zz % a.nx;
  const int y0 = blockIdx.y * a.TY, rows = min(a.TY, a.cs_y - y0);
  stage_taps(a.taps, tap);
  for (int i = threadIdx.x; i < rows * W2; i += blockDim.x) {
    const int yy = i / W2, gx = ix * a.cs_x + i - yy * W2 - r;
    float v = 0.f;
    if (gx >= 0 && gx < W) {
      const int ix2 = gx / a.cs_x;
      const size_t z2 = (size_t)bimg * Z + iy * a.nx + ix2;
      v = __bfloat162float(a.in[(z2 * a.L + l) * P + (size_t)(y0 + yy) *
                                a.cs_x + gx - ix2 * a.cs_x]);
    }
    T[i] = v;
  }
  __syncthreads();
  bf16* o = a.out + ((size_t)z * a.L + l) * P + (size_t)y0 * a.cs_x;
  for (int i = threadIdx.x; i < rows * a.cs_x; i += blockDim.x) {
    const int yy = i / a.cs_x;
    const float* row = T + yy * W2 + (i - yy * a.cs_x);
    float acc = 0.f;
    for (int k = 0; k < n; ++k) acc += tap[k] * row[k];
    o[i] = __float2bfloat16_rn(acc);
  }
}

// One pass of the two-pass blur.  Strips of at most 32 rows (fewer where
// the tile would not fit in shared memory), evened out over the cell: the y
// pass stages rows + 2r rows of cs_x, the x pass rows of cs_x + 2r.
int launch_blur_pass(const bf16* in, const float* gn, int gn_per_image,
                     bf16* out, const float* taps, int ntaps, int B, int ny,
                     int nx, int cs_y, int cs_x, int L, bool y_pass,
                     cudaStream_t st) {
  const int r = ntaps / 2;
  if (!taps || ntaps < 1 || ntaps > MAX_YX_TAPS || ntaps % 2 == 0 ||
      B < 1 || ny < 1 || nx < 1 || L < 1 || cs_y < 1 || cs_x < 1 ||
      r > cs_y || r > cs_x || (y_pass && !gn))
    return ERR_ARGS;
  BlurPassArgs args;
  args.in = in; args.gn = gn; args.out = out;
  args.ny = ny; args.nx = nx; args.cs_y = cs_y; args.cs_x = cs_x; args.L = L;
  args.gn_per_image = gn_per_image;
  args.taps.n = ntaps;
  for (int i = 0; i < ntaps; ++i) args.taps.t[i] = taps[i];
  size_t smem = 0;
  int TY = 0;
  for (int most = 32; most >= 1; most /= 2) {
    const int strips = (cs_y + most - 1) / most;
    TY = (cs_y + strips - 1) / strips;
    const size_t tile = y_pass ? (size_t)(TY + 2 * r) * cs_x
                               : (size_t)TY * (cs_x + 2 * r);
    smem = sizeof(float) * (((ntaps + 3) & ~3) + tile);
    if (smem <= (size_t)SMEM_MAX) break;
  }
  if (smem > (size_t)SMEM_MAX) return ERR_SMEM;
  args.TY = TY;
  cudaError_t e = set_smem(
      y_pass ? (const void*)blur_y_kernel : (const void*)blur_x_kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * ny * nx * L, (cs_y + TY - 1) / TY);
  if (y_pass)
    blur_y_kernel<<<grid, 256, smem, st>>>(args);
  else
    blur_x_kernel<<<grid, 256, smem, st>>>(args);
  return cudaGetLastError();
}

bool read_color_taps(const float* pack, int n, ColorTaps* t) {
  if (n < 1 || n > MAX_CTAPS || n % 2 == 0 || !pack) return false;
  const int R = n / 2;
  t->n = n;
  t->nrg = 0;
  for (int i = 0; i < n * n; ++i) {
    if (pack[i] == 0.f) continue;   // adds an exact zero
    t->dr[t->nrg] = (signed char)(i / n - R);
    t->dg[t->nrg] = (signed char)(i % n - R);
    t->rg[t->nrg++] = pack[i];
  }
  for (int i = 0; i < n; ++i) t->b[i] = pack[n * n + i];
  return true;
}

// Blur the (Z, nc*L, C) grids into `out` (bf16).
template <typename TI>
cudaError_t launch_grid_blur(const TI* g, bf16* out, int Z, int L, int nc,
                             const ColorTaps& taps, cudaStream_t st) {
  // one label a block: more blocks in flight measured faster than label
  // groups sharing the staging
  const size_t smem = (size_t)2 * nc * nc * nc * sizeof(float);
  if (smem > (size_t)SMEM_MAX) return (cudaError_t)ERR_SMEM;
  cudaError_t e = set_smem((const void*)grid_blur_kernel<TI>, smem);
  if (e != cudaSuccess) return e;
  grid_blur_kernel<TI><<<dim3(Z, L), 256, smem, st>>>(g, out, L, nc, taps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* crf_error(int code) {
  switch (code) {
    case ERR_ARGS: return "arguments the CRF kernels do not take";
    case ERR_SMEM: return "tile does not fit in shared memory";
    case ERR_PLAN: return "a launch plan the CRF kernels do not agree with";
    default: return cudaGetErrorString((cudaError_t)code);
  }
}

int crf_splat_launch(const float* rgb, int rows, const void* values,
                     int values_bf16, void* out, int out_bf16, int Z, int P,
                     int L, int nc, float inv_step, void* stream) {
  if (Z <= 0 || P <= 0 || L <= 0 || nc <= 0 || values_bf16 != out_bf16 ||
      (rows != 3 && rows != ATTR_ROWS))
    return ERR_ARGS;
  const size_t per_label = (size_t)nc * nc * nc * sizeof(float);
  if (per_label > (size_t)SMEM_MAX) return ERR_SMEM;
  const int Lg = label_group(L, per_label, SPLAT_GROUP);
  const size_t smem = per_label * Lg;
  const dim3 grid(Z, (L + Lg - 1) / Lg);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (values_bf16) {
    e = set_smem((const void*)splat_kernel<bf16, bf16>, smem);
    if (e != cudaSuccess) return e;
    splat_kernel<bf16, bf16><<<grid, 256, smem, st>>>(
        rgb, rows, (const bf16*)values, (bf16*)out, P, L, nc, inv_step, Lg);
  } else {
    e = set_smem((const void*)splat_kernel<float, float>, smem);
    if (e != cudaSuccess) return e;
    splat_kernel<float, float><<<grid, 256, smem, st>>>(
        rgb, rows, (const float*)values, (float*)out, P, L, nc, inv_step, Lg);
  }
  return cudaGetLastError();
}

int crf_slice_attrs_launch(const float* rgb, const float* grid, void* scratch,
                           const float* gn, const int* labels, float* attrs,
                           void* q0, float* attrs_sub, void* q0_sub,
                           const float* ctaps, int ntaps, int BZ, int Z, int P,
                           int L, int nc, int stride, int cs_y, int cs_x,
                           int h, int w, int nx, float inv_step, float q0_lab,
                           float q0_other, void* stream) {
  ColorTaps taps;
  if (!read_color_taps(ctaps, ntaps, &taps) || BZ <= 0 || Z <= 0 ||
      BZ % Z || P != cs_y * cs_x || stride < 1 || cs_y % stride ||
      cs_x % stride || L < 1 || nc < 1 ||
      (stride > 1 && (!attrs_sub || !q0_sub)))
    return ERR_ARGS;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e =
      launch_grid_blur<float>(grid, (bf16*)scratch, BZ, 1, nc, taps, st);
  if (e != cudaSuccess) return e;
  AttrsArgs a;
  a.rgb = rgb; a.gblur = (const bf16*)scratch; a.gn = gn; a.labels = labels;
  a.attrs = attrs; a.q0 = (bf16*)q0; a.attrs_sub = attrs_sub;
  a.q0_sub = (bf16*)q0_sub;
  a.Z = Z; a.P = P; a.L = L; a.nc = nc; a.stride = stride; a.cs_y = cs_y;
  a.cs_x = cs_x; a.h = h; a.w = w; a.nx = nx;
  a.inv_step = inv_step;
  const int R = ntaps / 2;
  a.b0 = taps.b[R];
  a.b1 = ntaps > 1 ? taps.b[R + 1] : 0.f;
  a.q0_lab = q0_lab; a.q0_other = q0_other;
  slice_attrs_kernel<<<dim3(BZ, (P + 255) / 256), 256, 0, st>>>(a);
  return cudaGetLastError();
}

int crf_blur_launch(const void* a, const float* gn, void* out,
                    const float* taps, int ntaps, int B, int ny, int nx,
                    int cs_y, int cs_x, int L, int ty, int lg, int threads,
                    int smem, void* stream) {
  const int r = ntaps / 2, Z = ny * nx;
  if (!taps || ntaps < 1 || ntaps > MAX_STAPS || ntaps % 2 == 0 || B < 1 ||
      Z < 1 || L < 1 || r > cs_y || r > cs_x || cs_x % 4)
    return ERR_ARGS;
  // the plan (blur_plan in kernels/crf_fused.py): strips of ty rows, lg
  // labels and `threads` threads a block, its shared memory as this file
  // lays it out
  const int wp = (cs_x + 2 * r + 7) / 8 * 8;
  const int ry = blur_ry(ntaps == 17 ? 17 : 0);
  if (ty < 1 || ty > cs_y || lg < 1 || lg > L || threads < 32 ||
      threads > BLUR_MAX_THREADS || threads % 32 ||
      (size_t)smem != blur_smem(ty, wp, r, ry) || smem > SMEM_MAX)
    return ERR_PLAN;
  BlurArgs args;
  args.a = (const bf16*)a; args.gn = gn; args.out = (bf16*)out;
  args.ny = ny; args.nx = nx; args.cs_y = cs_y;
  args.cs_x = cs_x; args.L = L; args.ty = ty; args.lg = lg; args.wp = wp;
  // 16-byte staging where the halo is whole vectors, and the offsets of a
  // (int in the kernel) fit
  args.vec = cs_x % 8 == 0 && r % 8 == 0 && (uintptr_t)a % 16 == 0 &&
             (uintptr_t)gn % 16 == 0 && (uintptr_t)out % 16 == 0 &&
             (size_t)B * Z * L * cs_y * cs_x < ((size_t)1 << 31);
  args.taps.n = ntaps;
  for (int i = 0; i < ntaps; ++i) args.taps.t[i] = taps[i];
  const dim3 grid(B * Z, (cs_y + ty - 1) / ty, (L + lg - 1) / lg);
  const void* fn = ntaps == 17 ? (const void*)blur_kernel<17>
                               : (const void*)blur_kernel<0>;
  cudaError_t e = set_smem(fn, smem);
  if (e != cudaSuccess) return e;
  if (ntaps == 17)
    blur_kernel<17><<<grid, threads, smem, (cudaStream_t)stream>>>(args);
  else
    blur_kernel<0><<<grid, threads, smem, (cudaStream_t)stream>>>(args);
  return cudaGetLastError();
}

int crf_blur_y_launch(const void* a, const float* gn, int gn_per_image,
                      void* out, const float* taps, int ntaps, int B, int ny,
                      int nx, int cs_y, int cs_x, int L, void* stream) {
  return launch_blur_pass((const bf16*)a, gn, gn_per_image,
                          (bf16*)out, taps, ntaps, B, ny, nx, cs_y, cs_x, L,
                          true, (cudaStream_t)stream);
}

int crf_blur_x_launch(const void* in, void* out, const float* taps,
                      int ntaps, int B, int ny, int nx, int cs_y, int cs_x,
                      int L, void* stream) {
  return launch_blur_pass((const bf16*)in, nullptr, 0,
                          (bf16*)out, taps, ntaps, B, ny, nx, cs_y, cs_x, L,
                          false, (cudaStream_t)stream);
}

int crf_mf_step_launch(const float* attrs, const void* grid, void* scratch,
                       const void* fg, const void* q, void* out, void* out_sub,
                       const void* unary, const float* ctaps, int ntaps,
                       int Z, int P, int L, int nc, int stride, int cs_x,
                       float inv_step, float cg,
                       float cb, float n_energy, float p_energy,
                       void* stream) {
  ColorTaps taps;
  if (!read_color_taps(ctaps, ntaps, &taps) || Z <= 0 || P <= 0 || L < 1 ||
      nc < 1 || stride < 1 ||
      (stride > 1 && (!out_sub || cs_x % stride || P % cs_x)))
    return ERR_ARGS;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = launch_grid_blur<bf16>((const bf16*)grid, (bf16*)scratch, Z,
                                         L, nc, taps, st);
  if (e != cudaSuccess) return e;
  StepArgs a;
  a.attrs = attrs; a.gblur = (const bf16*)scratch; a.fg = (const bf16*)fg;
  a.q = (const bf16*)q; a.out = (bf16*)out;
  a.out_sub = stride > 1 ? (bf16*)out_sub : nullptr;
  a.unary = (const bf16*)unary;
  a.P = P; a.L = L; a.nc = nc; a.stride = stride; a.cs_x = cs_x > 0 ? cs_x : P;
  a.inv_step = inv_step; a.cg = cg; a.cb = cb; a.n_energy = n_energy;
  a.p_energy = p_energy;
  const size_t smem = sizeof(float) * (size_t)L * 256;
  if (smem > (size_t)SMEM_MAX) return ERR_SMEM;
  const dim3 blocks(Z, (P + 255) / 256);
  if (unary) {
    e = set_smem((const void*)mf_step_kernel<true>, smem);
    if (e != cudaSuccess) return e;
    mf_step_kernel<true><<<blocks, 256, smem, st>>>(a);
  } else {
    e = set_smem((const void*)mf_step_kernel<false>, smem);
    if (e != cudaSuccess) return e;
    mf_step_kernel<false><<<blocks, 256, smem, st>>>(a);
  }
  return cudaGetLastError();
}

int crf_slice_launch(const float* rgb, const float* grid, void* scratch,
                     float* out, const float* ctaps, int ntaps, int Z, int P,
                     int L, int nc, float inv_step, void* stream) {
  ColorTaps taps;
  if (!read_color_taps(ctaps, ntaps, &taps) || Z <= 0 || P <= 0 || L < 1 ||
      nc < 1)
    return ERR_ARGS;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e =
      launch_grid_blur<float>(grid, (bf16*)scratch, Z, L, nc, taps, st);
  if (e != cudaSuccess) return e;
  SliceArgs a;
  a.rgb = rgb; a.gblur = (const bf16*)scratch; a.out = out;
  a.P = P; a.L = L; a.nc = nc; a.inv_step = inv_step;
  slice_kernel<<<dim3(Z, (P + 255) / 256), 256, 0, st>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
