// The dense CRF's cell-plane kernels for Hopper (sm_90a): splat, norm-pass
// slice, spatial blur and mean-field step.
//
// Replaces the TPU kernels of deeplab_tpu/kernels/crf_fused.py:
//   splat_planes          (pl.pallas_call at line 702)
//   slice_attrs_planes    (line 890)
//   gaussian_blur_planes  (line 568, the fused row kernel)
//   mf_step_planes        (line 988)
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
//  - slice_attrs / mf_step pixel pass: one thread per pixel works out its 8
//    corners once, gathers them for each label from the blurred grid in
//    device memory (the neighbouring pixels of a block share most corners,
//    so the gathers hit L1), and does the messages and the softmax in f32
//    with its L logits in shared memory.  Staging a cell's grid in shared
//    memory (142 KB at nc = 15, L = 21) measured slower: one block per SM.
//  - spatial blur: one block per (cell, label, strip of TY rows) stages
//    bf16(Q * gn) with an r-pixel halo from the neighbouring cells (zero
//    outside the image), runs the y pass into a bf16 strip (4 rows a thread,
//    each halo value read once per 4 outputs) and the x pass out (4 columns
//    a thread from a register window filled with 16-byte loads; the tile's
//    row pitch is rounded up to 4 floats, so the cells' width must be a
//    multiple of 4).
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
constexpr int MAX_STAPS = 33;   // spatial taps (radius <= 16); the blur's
                                // windows hold MAX_STAPS + 3 = 9 float4
constexpr int ATTR_ROWS = 8, ATTR_GN = 3, ATTR_BN = 4, ATTR_BSELF = 5,
              ATTR_LABEL = 6, ATTR_BSCALE = 7;
constexpr int SPLAT_GROUP = 48 * 1024;  // splat: shared-memory grid per block
constexpr int SMEM_MAX = 227 * 1024;

enum {
  ERR_ARGS = 100001,      // an argument the kernels do not take
  ERR_SMEM = 100002,      // a tile that does not fit in shared memory
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
  int P, L, nc, stride, cs_x;
  float inv_step, cg, cb, n_energy, p_energy;
};

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
      const float u = (float)l == lab ? a.p_energy : a.n_energy;
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

// --------------------------------------------------------- spatial blur ----
struct BlurArgs {
  const bf16* a;          // (B*Z, L, P)
  const float* gn;        // (Z, 1, P), one plane per image position
  bf16* out;              // (B*Z, L, P)
  int ny, nx, cs_y, cs_x, L, TY;
  SpatialTaps taps;
};

__global__ void blur_kernel(BlurArgs a) {
  float* bsm = reinterpret_cast<float*>(dyn_smem);
  const int r = a.taps.n / 2, W2 = a.cs_x + 2 * r, H2 = a.TY + 2 * r;
  // row pitch rounded up to 4 floats, so that every row is 16-byte aligned;
  // the pad columns are never summed
  const int Wp = (W2 + 3) & ~3;
  const int Z = a.ny * a.nx, P = a.cs_y * a.cs_x;
  float* A = bsm;                    // [H2][Wp]  bf16(a * gn) with halo
  float* T = bsm + (size_t)H2 * Wp;  // [TY][Wp]  y pass, bf16-rounded
  const int z = blockIdx.x / a.L, l = blockIdx.x % a.L;
  const int bimg = z / Z, zz = z % Z, iy = zz / a.nx, ix = zz % a.nx;
  const int y0 = blockIdx.y * a.TY;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  // rows of the halo tile over warps, columns over lanes
  for (int yy = warp; yy < H2; yy += nw) {
    const int cy = y0 + yy - r;
    const int dy = cy < 0 ? -1 : (cy >= a.cs_y ? 1 : 0);
    const int iy2 = iy + dy, py = cy - dy * a.cs_y;
    for (int xx = lane; xx < W2; xx += 32) {
      const int cx = xx - r;
      const int dx = cx < 0 ? -1 : (cx >= a.cs_x ? 1 : 0);
      const int ix2 = ix + dx;
      float v = 0.f;
      if (iy2 >= 0 && iy2 < a.ny && ix2 >= 0 && ix2 < a.nx) {
        const int p2 = py * a.cs_x + (cx - dx * a.cs_x);
        const int zz2 = iy2 * a.nx + ix2;
        const size_t z2 = (size_t)bimg * Z + zz2;
        v = bf16r(__bfloat162float(a.a[(z2 * a.L + l) * P + p2]) *
                  a.gn[(size_t)zz2 * P + p2]);
      }
      A[yy * Wp + xx] = v;
    }
  }
  __syncthreads();
  // y pass: each thread 4 rows of one column, reading each halo value once
  // per 4 outputs; sums in tap order
  for (int y4 = warp * 4; y4 < a.TY; y4 += nw * 4) {
    for (int xx = lane; xx < W2; xx += 32) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int m = 0; m < a.taps.n + 3 && y4 + m < H2; ++m) {
        const float v = A[(y4 + m) * Wp + xx];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = m - j;
          if (k >= 0 && k < a.taps.n) acc[j] += a.taps.t[k] * v;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (y4 + j < a.TY) T[(y4 + j) * Wp + xx] = bf16r(acc[j]);
    }
  }
  __syncthreads();
  // x pass: 4 consecutive outputs a thread (cs_x % 4 == 0) from a window
  // read with 16-byte loads (a quarter warp's loads hit distinct banks)
  bf16* o = a.out + ((size_t)z * a.L + l) * P + (size_t)y0 * a.cs_x;
  const int xq = a.cs_x / 4;
  for (int i = threadIdx.x; i < a.TY * xq; i += blockDim.x) {
    const int yy = i / xq, x0 = (i - yy * xq) * 4;
    const float4* row = reinterpret_cast<const float4*>(T + yy * Wp + x0);
    float win[MAX_STAPS + 3];
#pragma unroll
    for (int q = 0; q < (MAX_STAPS + 3) / 4; ++q)
      if (4 * q < a.taps.n + 3) {
        const float4 v = row[q];
        win[4 * q] = v.x; win[4 * q + 1] = v.y;
        win[4 * q + 2] = v.z; win[4 * q + 3] = v.w;
      }
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < MAX_STAPS; ++k)
      if (k < a.taps.n) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] += a.taps.t[k] * win[j + k];
      }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      o[yy * a.cs_x + x0 + j] = __float2bfloat16_rn(acc[j]);
  }
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
                    int cs_y, int cs_x, int L, void* stream) {
  const int r = ntaps / 2, Z = ny * nx;
  if (!taps || ntaps < 1 || ntaps > MAX_STAPS || ntaps % 2 == 0 || B < 1 ||
      Z < 1 || L < 1 || r > cs_y || r > cs_x || cs_x % 4)
    return ERR_ARGS;
  BlurArgs args;
  args.a = (const bf16*)a; args.gn = gn; args.out = (bf16*)out;
  args.ny = ny; args.nx = nx; args.cs_y = cs_y;
  args.cs_x = cs_x; args.L = L;
  args.taps.n = ntaps;
  for (int i = 0; i < ntaps; ++i) args.taps.t[i] = taps[i];
  int TY = 32;
  while (cs_y % TY) TY /= 2;
  args.TY = TY;
  // rows of cs_x + 2r floats rounded up to 4: the x pass's 16-byte loads
  // then end within the row (its last one at float cs_x + 2r + 1 for odd r)
  const size_t smem =
      sizeof(float) * (size_t)(2 * TY + 2 * r) * ((cs_x + 2 * r + 3) & ~3);
  if (smem > (size_t)SMEM_MAX) return ERR_SMEM;
  cudaError_t e = set_smem((const void*)blur_kernel, smem);
  if (e != cudaSuccess) return e;
  blur_kernel<<<dim3(B * Z * L, cs_y / TY), 256, smem,
                (cudaStream_t)stream>>>(args);
  return cudaGetLastError();
}

int crf_mf_step_launch(const float* attrs, const void* grid, void* scratch,
                       const void* fg, const void* q, void* out, void* out_sub,
                       const float* ctaps, int ntaps, int Z, int P, int L,
                       int nc, int stride, int cs_x, float inv_step, float cg,
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
  a.P = P; a.L = L; a.nc = nc; a.stride = stride; a.cs_x = cs_x > 0 ? cs_x : P;
  a.inv_step = inv_step; a.cg = cg; a.cb = cb; a.n_energy = n_energy;
  a.p_energy = p_energy;
  const size_t smem = sizeof(float) * (size_t)L * 256;
  if (smem > (size_t)SMEM_MAX) return ERR_SMEM;
  e = set_smem((const void*)mf_step_kernel, smem);
  if (e != cudaSuccess) return e;
  mf_step_kernel<<<dim3(Z, (P + 255) / 256), 256, smem, st>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
