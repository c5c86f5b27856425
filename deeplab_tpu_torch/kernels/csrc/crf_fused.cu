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
//  - splat (splat_plan in kernels/crf_fused.py): one block per (cell,
//    group of labels).  It sorts each chunk of the cell's pixels by base
//    bin in shared memory (a counting sort: a histogram with
//    warp-aggregated integer atomics, one scan, a scatter) and cuts each
//    bin's run into pieces of at most 32 pixels; a thread sums a piece's
//    8 corners for one label in registers, then adds each to the group's
//    f32 grid in shared memory.  Why: on sm_90 a shared-memory f32
//    atomicAdd is a compare-and-swap loop (ATOMS.CAST.SPIN in the SASS), so
//    8 adds per (pixel, label), lanes contending on the bins that a smooth
//    region's pixels share, cost 0.26 of a 0.42 ms launch (production B=8:
//    0.16 ms with the adds taken out, measured in PERF.md), with each item
//    redoing its pixel's hats.  Here the hats and
//    weights are worked out once per pixel and block, the adds fall to 8 per
//    (piece, label), and the lanes of a warp (labels fastest) add to
//    different label planes.  The grid is zeroed and written once, two
//    values a store (a 16-byte store would read 8 neighbouring words a lane
//    from shared memory: 8-way bank conflicts).  The labels split into as
//    few groups as the f32 grid leaves room for (2 at 21 labels, nc = 15:
//    148.5 KB of grid for 11); each group sorts the cell again.  1024
//    threads (an earlier 512 measured 25% slower on the noise scene:
//    latency-bound compare-and-swap loops), and an explicit interleaving
//    of the 8 loops measured slower than the compiler's.
//  - grid blur of the norm pass: one block per cell stages its grid planes
//    in shared memory, runs the joint (r, g) blur as a stencil over the
//    nonzero ones of the TPU's bf16-rounded kron weights, then the b band in
//    f32, and writes the blurred grid in bf16 to device memory (scratch);
//    slice_attrs: one thread per pixel works out its 8 corners once and
//    gathers them from that scratch.
//  - slice_planes (the XLA engine's color blur and slice; slice_plan in
//    kernels/crf_fused.py): one kernel.  Its floor is the (r, g) stencil's
//    f32 multiply-adds, 49 a grid value at nc = 21 (467 M a 21-label launch
//    at 512x512, 14 us at 67 TFLOP/s), not its 38 MB of grid.  One block
//    per (cell, group of labels): the group's f32 planes by cp.async (the
//    next round's while this one is blurred, where they fit), rounded to
//    bf16 once into zero-padded planes, blurred two labels a round in
//    shared memory (an item walks 3 output rows, so a window load feeds up
//    to 3 rows' taps), the blurred group kept label-innermost so that the
//    pixel pass reads a corner's labels with one 8- or 16-byte load.  Label
//    groups give two blocks an SM; the one-label norm pass splits a cell's
//    pixels over as many blocks as keep one an SM.  No blurred grid goes
//    to device memory and back (the two-kernel form's 19 MB a launch and
//    its 2-byte gathers).
//  - mf_step (step_plan in kernels/crf_fused.py), fused where the cell's
//    grid fits in shared memory and its logits in registers (L <= 32):
//    one block per cell stages the z-blurred grid with cp.async (142 KB at
//    nc = 15, L = 21), blurs it in place 6 labels a round through an f32
//    scratch of the (r, g) pass, then runs the pixel pass from shared
//    memory: one launch, and no blurred grid written to and read back from
//    device memory (36 MB a launch at B=8).  The blur keeps each item's
//    2re+1 source rows in a register window along g, 8 outputs a thread,
//    so a shared-memory load feeds 2re+1 taps (not one load a tap).  The pixel pass is a thread per pixel with its logits in
//    registers; 21 labels, the main path's, have an instantiation of
//    their own whose label loops unroll with no test of L, so the 42 loads
//    of q and fg issue ahead of the arithmetic (0.40 -> 0.26 ms a launch,
//    measured in PERF.md; 1024 threads at 64 registers).  Where the cells are
//    fewer than the SMs (B = 1), a cell takes several blocks, each blurring
//    the grid again.  Splitting a pixel over two lanes, or staging q and fg
//    through shared memory with cp.async, measured slower.
//    Otherwise (nc = 21 with 21 labels: a 389 KB grid; or L > 32) two
//    kernels: the blur per (cell, chunk of 4 labels), 1024 threads, into
//    device scratch laid out in chunks, each label-innermost
//    ([chunk][b][r][g][4], written 8 coalesced bytes a grid point from a
//    tile in shared memory; a label a block with 2-byte stores measured
//    2.6x slower), so that a corner's 4 labels are one 8-byte load in the
//    pixel pass, which has the 21-label instantiation too.  Both forms
//    blur in grid_blur_kernel's order, (dr, dg) row-major (a zero tap or
//    an off-grid source adds an exact zero; exact bf16 products summed
//    with fmaf, as the file's -fmad=false multiply then add), then the b
//    band with separate multiply and add, and the softmax in the plain
//    version's order: the two forms give one Q bit for bit.  The
//    explicit-unary step reads one more bf16 (L, P) stream; it is its own
//    instantiation.
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
//    bit for bit.  It takes cells whose width is a multiple of 4, any height
//    (a strip's halo rows are found by image row; the y pass's windows round
//    a strip up to whole windows, and the rows they read past the staged
//    rows + 2r feed only outputs at or past `rows`, which are never
//    stored), radii up to 16 and gn (Z, 1, P): gaussian_blur_planes sends
//    it every such call (row_kernel_fits), the VOC photos' 75- and 50-row
//    cells included, each cell a block whose halo is read once.
//  - spatial blur in two passes (pass_plan in kernels/crf_fused.py), for
//    radii 17-128 and for gn (B*Z, 1, P): the y pass, then the x pass, each
//    moving 2 bf16 bytes in and 2 out per (pixel, label) like the row
//    kernel.  One block per (cell, strip, group of labels), the strip the
//    whole cell where it fits; 16-byte staging with no division per element;
//    bf16 tiles; the y pass's gn tile staged once a group and the next
//    label's a held in registers during this label's sums; each thread
//    streams down a column pair (y) or along 8 outputs of a row (x) so that
//    a shared-memory load feeds all its taps; the taps compile-time kernel
//    parameters for 41 taps (r = 20), else slid through registers.  Each pass
//    equals its plain version bit for bit.

// Measured on the H100 (PERF.md): each kernel takes several times its bound.
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

cudaError_t set_smem(const void* fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// ---------------------------------------------------------------- splat ----
// G[z, b*L + l, r*nc + g] += bf16(bf16(v * s) * bf16(w_b)) * bf16(w_r * w_g),
// s the ATTR_BSCALE row of packed attrs planes, 1 for plain rgb planes.
//
// One block per (cell, group of lg labels); the cell's pixels in chunks of
// pc (splat_plan in kernels/crf_fused.py).  Per chunk:
//  1. each pixel's base bin (b0, r0, g0), as a key over (nc + 1)^3 (bins
//     -1 .. nc-1), and its weights, once for the block; a histogram of the
//     keys with warp-aggregated integer atomics (__match_any_sync);
//  2. one exclusive scan of (pixels | pieces << 16) per key: a piece is at
//     most k pixels of one key, so it shares all 8 corner addresses;
//  3. each pixel's weights, and bf16(v * s) of the group's labels, to its
//     place in key order;
//  4. one item per (piece, label), labels fastest: the piece's 8 corner
//     sums in registers, in sorted order, then one shared-memory f32 add a
//     corner.  On sm_90 that add is a compare-and-swap loop (atomicAdd
//     compiles to ATOMS.CAST.SPIN), which every contending lane retries:
//     8 of them per (piece, label) and not per (pixel, label), and
//     neighbouring lanes on different label planes or, in the norm pass,
//     on pieces far apart in key order.
// A chunk of the norm pass (one label) of which a third of the pixels or
// more are alone in their bins skips 2-4: each pixel adds its own corners
// (a noise image's chunk: there is little to sum first, and the sort
// measured slower than the adds it saves).  The group's f32 grid is zeroed once and written
// once, two values a store.
constexpr int SPLAT_THREADS = 1024;
constexpr int SPLAT_MAX_PPT = 2;     // pixels of a chunk a thread holds
constexpr int SPLAT_PIECE = 32;      // pixels of one key a thread sums (k)

struct SplatArgs {
  const float* rgb;       // (Z, rows, P) rgb or packed attrs planes
  const void* vals;       // (Z, L, P) f32 or bf16
  void* out;              // (Z, nc*L, C) f32 or bf16
  int rows, P, L, nc, lg, pc;   // lg, pc: the plan's
  float inv_step;
};

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// Histogram entries: (nc + 1)^3 keys, padded so that each thread owns a
// whole number of groups of four.
__host__ __device__ inline int splat_hist_len(int nc) {
  const int keys = (nc + 1) * (nc + 1) * (nc + 1);
  const int per = ((keys + SPLAT_THREADS - 1) / SPLAT_THREADS + 3) / 4 * 4;
  return per * SPLAT_THREADS;
}

// Byte offsets of a splat block's shared memory (splat_smem in
// kernels/crf_fused.py): the f32 grid [nc][lg][C], the key histogram, the
// pieces ((b0+1) << 20 | (r0+1) << 10 | (g0+1), first | len << 16), the
// sorted weights (bf16 w_r*w_g x4,
// bf16 w_b x2), the sorted bf16(v * s) [pc][lg], the scan's warp sums.
struct SplatLayout {
  size_t hist, piece, wrg, wb, vals, scan, total;
};
__host__ __device__ inline SplatLayout splat_layout(int nc, int lg, int pc) {
  SplatLayout s;
  s.hist = align16((size_t)4 * nc * lg * nc * nc);
  s.piece = s.hist + (size_t)4 * splat_hist_len(nc);
  s.wrg = s.piece + (size_t)8 * pc;
  s.wb = s.wrg + (size_t)8 * pc;
  s.vals = align16(s.wb + (size_t)4 * pc);
  s.scan = align16(s.vals + (size_t)2 * pc * lg);
  s.total = s.scan + 4 * 32;
  return s;
}

__device__ __forceinline__ uint32_t pack_bf2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ float2 unpack_bf2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

// Exclusive prefix sum of v over the block; *total gets the sum.  warp: 32
// ints of shared memory.  Two barriers.
__device__ int block_scan(int v, int* warp, int* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp[w] = x;
  __syncthreads();
  if (w == 0) {
    int t = lane < nw ? warp[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += y;
    }
    if (lane < nw) warp[lane] = t;
  }
  __syncthreads();
  *total = warp[nw - 1];
  return (w ? warp[w - 1] : 0) + x - v;
}

// Two values a store: the f32 grid's run of n values at src to dst (a
// global element offset off from a 16-byte aligned base).  Reading two
// neighbouring words a lane keeps shared memory to two-way conflicts.
__device__ __forceinline__ void store_run(const float* src, float* dst,
                                          size_t off, int n, int tid, int T) {
  const int head = (int)(off & 1);
  if (tid == 0 && head && n > 0) dst[0] = src[0];
  for (int i = head + 2 * tid; i + 1 < n; i += 2 * T)
    *reinterpret_cast<float2*>(dst + i) = make_float2(src[i], src[i + 1]);
  if (tid == 0 && n > head && (n - head) % 2) dst[n - 1] = src[n - 1];
}
__device__ __forceinline__ void store_run(const float* src, bf16* dst,
                                          size_t off, int n, int tid, int T) {
  const int head = (int)(off & 1);
  if (tid == 0 && head && n > 0) dst[0] = __float2bfloat16_rn(src[0]);
  for (int i = head + 2 * tid; i + 1 < n; i += 2 * T)
    *reinterpret_cast<__nv_bfloat162*>(dst + i) =
        __floats2bfloat162_rn(src[i], src[i + 1]);
  if (tid == 0 && n > head && (n - head) % 2)
    dst[n - 1] = __float2bfloat16_rn(src[n - 1]);
}

template <typename TV, typename TO>
__global__ void __launch_bounds__(SPLAT_THREADS, 1) splat_kernel(SplatArgs a) {
  const int z = blockIdx.x, l0 = blockIdx.y * a.lg;
  const int Lc = min(a.lg, a.L - l0), nc = a.nc, C = nc * nc, nk = nc + 1;
  const int P = a.P, tid = threadIdx.x, lane = tid & 31, K = SPLAT_PIECE;
  const SplatLayout lay = splat_layout(nc, a.lg, a.pc);
  float* grid = reinterpret_cast<float*>(dyn_smem);            // [nc][Lc][C]
  int* hist = reinterpret_cast<int*>(dyn_smem + lay.hist);
  int2* piece = reinterpret_cast<int2*>(dyn_smem + lay.piece);
  uint2* wrg = reinterpret_cast<uint2*>(dyn_smem + lay.wrg);
  uint32_t* wbs = reinterpret_cast<uint32_t*>(dyn_smem + lay.wb);
  bf16* vs = reinterpret_cast<bf16*>(dyn_smem + lay.vals);      // [pc][lg]
  int* warp_sums = reinterpret_cast<int*>(dyn_smem + lay.scan);
  const int hist_len = splat_hist_len(nc), per = hist_len / SPLAT_THREADS;
  const int n = nc * Lc * C;
  for (int i = tid; i < (n + 3) / 4; i += SPLAT_THREADS)
    reinterpret_cast<float4*>(grid)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float* px = a.rgb + (size_t)z * a.rows * P;
  const TV* vals = static_cast<const TV*>(a.vals) + ((size_t)z * a.L + l0) * P;
  const float hi = (float)nc;
  // (piece slot, label) of this thread, labels fastest.  Where a warp's
  // lanes are mostly pieces (fewer than 4 labels), the slots spread over
  // the pieces, lanes slots / 32 pieces apart: the pieces are in key order,
  // and neighbouring keys share corners, so neighbouring lanes would
  // contend.  (With more labels, a warp holds a few pieces, and spreading
  // them measured slower: their sorted records no longer share loads.)
  const int slots = SPLAT_THREADS / Lc, slot = tid / Lc, lgt = tid - slot * Lc;
  const int spread = Lc < 4 ? slots / 32 : 0, first_slot =
      slot < spread * 32 ? (slot % 32) * spread + slot / 32 : slot;
  for (int i = tid; i < hist_len / 4; i += SPLAT_THREADS)
    reinterpret_cast<int4*>(hist)[i] = make_int4(0, 0, 0, 0);
  __syncthreads();
  for (int c0 = 0; c0 < P; c0 += a.pc) {
    const int np = min(a.pc, P - c0);
    // 1. keys, weights and the histogram (every load issued first, the
    // first label's values among them)
    int key[SPLAT_MAX_PPT], pos[SPLAT_MAX_PPT];
    uint32_t w01[SPLAT_MAX_PPT], w23[SPLAT_MAX_PPT], wbb[SPLAT_MAX_PPT];
    float sc[SPLAT_MAX_PPT], cr[SPLAT_MAX_PPT], cg[SPLAT_MAX_PPT],
        cb[SPLAT_MAX_PPT], v0[SPLAT_MAX_PPT];
#pragma unroll
    for (int j = 0; j < SPLAT_MAX_PPT; ++j) {
      const int i = tid + j * SPLAT_THREADS, p = c0 + i;
      const bool in = i < np;
      cr[j] = in ? px[p] * a.inv_step : -2.f;
      cg[j] = in ? px[P + p] * a.inv_step : -2.f;
      cb[j] = in ? px[2 * P + p] * a.inv_step : -2.f;
      sc[j] = in && a.rows == ATTR_ROWS ? px[ATTR_BSCALE * P + p] : 1.f;
      v0[j] = in ? ld(vals + p) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < SPLAT_MAX_PPT; ++j) {
      key[j] = -1;
      pos[j] = 0;
      w01[j] = w23[j] = wbb[j] = 0u;
      if (j * SPLAT_THREADS >= np) continue;    // the same in the whole block
      // bins -1 .. nc-1 (a pixel past them touches no bin of the grid)
      if (cr[j] >= -1.f && cr[j] < hi && cg[j] >= -1.f && cg[j] < hi &&
          cb[j] >= -1.f && cb[j] < hi) {
        const Hat hr = hat(cr[j]), hg = hat(cg[j]), hb = hat(cb[j]);
        key[j] = ((hb.i + 1) * nk + hr.i + 1) * nk + hg.i + 1;
        w01[j] = pack_bf2(bf16r(hr.w0 * hg.w0), bf16r(hr.w0 * hg.w1));
        w23[j] = pack_bf2(bf16r(hr.w1 * hg.w0), bf16r(hr.w1 * hg.w1));
        wbb[j] = pack_bf2(hb.w0, hb.w1);      // rounds them: bf16(w_b)
      }
      // one integer atomic a group of equal keys in a warp
      const unsigned peers = __match_any_sync(0xffffffffu, key[j]);
      const int leader = __ffs(peers) - 1;
      int base = 0;
      if (lane == leader && key[j] >= 0)
        base = atomicAdd(hist + key[j], __popc(peers));
      base = __shfl_sync(0xffffffffu, base, leader);
      pos[j] = base + __popc(peers & ((1u << lane) - 1u));
    }
    __syncthreads();
    // A one-label chunk with many pixels alone in their bins (noise: little
    // to sum before the adds) skips the sort: each pixel adds its own 8
    // corners.
    if (Lc == 1 && 3 * __syncthreads_count(key[0] >= 0 && hist[key[0]] == 1) >=
                       min(np, SPLAT_THREADS)) {
      for (int i = tid; i < hist_len / 4; i += SPLAT_THREADS)
        reinterpret_cast<int4*>(hist)[i] = make_int4(0, 0, 0, 0);
#pragma unroll
      for (int j = 0; j < SPLAT_MAX_PPT; ++j) {
        if (key[j] < 0) continue;
        const float2 wb = unpack_bf2(wbb[j]), f01 = unpack_bf2(w01[j]),
                     f23 = unpack_bf2(w23[j]);
        const float v = bf16r(v0[j] * sc[j]);
        const float t[2] = {bf16r(v * wb.x), bf16r(v * wb.y)};
        const float w[4] = {f01.x, f01.y, f23.x, f23.y};
        const int b0 = key[j] / (nk * nk) - 1, r0 = (key[j] / nk) % nk - 1,
                  g0 = key[j] % nk - 1;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int b = b0 + c / 4, r = r0 + (c / 2) % 2, g = g0 + c % 2;
          const float m = t[c / 4] * w[c % 4];   // exact: two bf16 values
          if (b >= 0 && b < nc && r >= 0 && r < nc && g >= 0 && g < nc &&
              m != 0.f)
            atomicAdd(grid + (size_t)b * C + r * nc + g, m);
        }
      }
      __syncthreads();
      continue;
    }
    // 2. the scan: thread t owns keys t, t + T, ... (conflict-free reads);
    // any order of keys groups equal keys
    int run = 0;
    for (int q = 0; q < per; ++q) {
      const int c = hist[q * SPLAT_THREADS + tid];
      run += c | (((c + K - 1) / K) << 16);
    }
    int total;
    run = block_scan(run, warp_sums, &total);
    for (int q = 0; q < per; ++q) {
      const int kk = q * SPLAT_THREADS + tid, c = hist[kk];
      const int first = run & 0xffff;
      hist[kk] = first;
      // the key's bins, packed once here and not divided out per item
      const int bins = c ? (kk / (nk * nk)) << 20 | ((kk / nk) % nk) << 10 |
                               kk % nk
                         : 0;
      for (int i = 0, pi = run >> 16; i < c; i += K, ++pi)
        piece[pi] = make_int2(bins, (first + i) | (min(K, c - i) << 16));
      run += c | (((c + K - 1) / K) << 16);
    }
    const int npieces = total >> 16;
    __syncthreads();
    // 3. weights and values in key order
#pragma unroll
    for (int j = 0; j < SPLAT_MAX_PPT; ++j) {
      if (key[j] < 0) continue;
      pos[j] += hist[key[j]];
      wrg[pos[j]] = make_uint2(w01[j], w23[j]);
      wbs[pos[j]] = wbb[j];
    }
    // four labels' loads in flight at once
    for (int lg0 = 0; lg0 < Lc; lg0 += 4) {
      float v[4][SPLAT_MAX_PPT];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int j = 0; j < SPLAT_MAX_PPT; ++j)
          v[u][j] = lg0 + u == 0 ? v0[j]
                    : lg0 + u < Lc && key[j] >= 0
                        ? ld(vals + (size_t)(lg0 + u) * P + c0 + tid +
                             j * SPLAT_THREADS)
                        : 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int j = 0; j < SPLAT_MAX_PPT; ++j)
          if (lg0 + u < Lc && key[j] >= 0)
            vs[pos[j] * a.lg + lg0 + u] = __float2bfloat16_rn(v[u][j] * sc[j]);
    }
    __syncthreads();
    // 4. per (piece, label): 8 corner sums, then 8 atomics; the histogram
    // cleared for the next chunk (read for the last time in 3)
    for (int i = tid; i < hist_len / 4; i += SPLAT_THREADS)
      reinterpret_cast<int4*>(hist)[i] = make_int4(0, 0, 0, 0);
    if (slot < slots) {
      for (int pi = first_slot; pi < npieces; pi += slots) {
        const int2 pc = piece[pi];
        const int first = pc.y & 0xffff, last = first + (pc.y >> 16);
        float m[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) m[j] = 0.f;
        for (int q = first; q < last; ++q) {
          const uint2 w = wrg[q];
          const float2 wb = unpack_bf2(wbs[q]);
          const float v = __bfloat162float(vs[q * a.lg + lgt]);
          const float t0 = bf16r(v * wb.x), t1 = bf16r(v * wb.y);
          const float2 f01 = unpack_bf2(w.x), f23 = unpack_bf2(w.y);
          // products of two bf16 values are exact: one rounding a term
          m[0] = __fmaf_rn(t0, f01.x, m[0]);
          m[1] = __fmaf_rn(t0, f01.y, m[1]);
          m[2] = __fmaf_rn(t0, f23.x, m[2]);
          m[3] = __fmaf_rn(t0, f23.y, m[3]);
          m[4] = __fmaf_rn(t1, f01.x, m[4]);
          m[5] = __fmaf_rn(t1, f01.y, m[5]);
          m[6] = __fmaf_rn(t1, f23.x, m[6]);
          m[7] = __fmaf_rn(t1, f23.y, m[7]);
        }
        const int b0 = (pc.x >> 20) - 1, r0 = (pc.x >> 10 & 1023) - 1,
                  g0 = (pc.x & 1023) - 1;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int b = b0 + j / 4, r = r0 + (j / 2) % 2, g = g0 + j % 2;
          if (b >= 0 && b < nc && r >= 0 && r < nc && g >= 0 && g < nc &&
              m[j] != 0.f)
            atomicAdd(grid + (size_t)(b * Lc + lgt) * C + r * nc + g, m[j]);
        }
      }
    }
    __syncthreads();
  }
  // each b plane of the group: Lc*C values, contiguous in the grid and out
  TO* out = static_cast<TO*>(a.out);
  for (int b = 0; b < nc; ++b) {
    const size_t off = ((size_t)(z * nc + b) * a.L + l0) * C;
    store_run(grid + (size_t)b * Lc * C, out + off, off, Lc * C, tid,
              SPLAT_THREADS);
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

// A pixel's 8 grid corners: offsets of label 0 in a grid whose b planes lie
// bstride elements apart and whose (r, g) points lie cstride apart (the
// (D, C) layout: L*C and 1), and weights bf16(w_r * w_g), kb-major then r,
// g; corners off the grid get weight 0.  wb: the f32 hat weights of its two
// b bins.
struct Corners {
  int off[8];
  float w[8];
  float wb[2];
};

__device__ __forceinline__ Corners corners(const Hat& hr, const Hat& hg,
                                           const Hat& hb, int nc, int bstride,
                                           int cstride) {
  Corners k;
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
        k.off[j] = ok ? b * bstride + (r * nc + g) * cstride : 0;
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
    const float filt =
        slice_at(gb, corners(h[0], h[1], h[2], a.nc, C, 1), 0);
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

// ---------------------------------------------------------------- mf_step ----
// The step's color blur and pixel pass (step_plan in kernels/crf_fused.py;
// the design and its measurements are in the header above).  Fused: one
// block per cell (or per cell and split) stages the z-blurred grid with
// cp.async, blurs it in place lb labels a round through an f32 scratch of
// the (r, g) pass, then slices every pixel from shared memory.  Two
// kernels: the grid blur per (cell, chunk of STEP_LC labels) into device
// scratch [chunk][b][r][g][STEP_LC], then the pixel pass.  Both blur in
// the order of the grid blur above: (dr, dg) row-major over a window of
// radius re (the taps' outer zeros trimmed; a zero tap or an off-grid
// source adds an exact zero), exact bf16 products summed with fmaf, then
// the b band in f32 with separate multiply and add, rounded to bf16.  So
// the two forms give one blurred grid bit for bit, and the same Q.
constexpr int STEP_THREADS = 512;   // the fused kernel: a pixel a thread
constexpr int STEP_L21 = 21;        // the label count of its own instantiation
constexpr int STEP_THREADS_L21 = 1024;  // ... which holds 64 registers
constexpr int STEP_PIX_THREADS = 256;   // the two-kernel pixel pass
constexpr int STEP_BLUR_THREADS = 1024;  // the two-kernel grid blur (1024:
                                         // 1.6x faster than 256 at nc 21)
constexpr int STEP_LMAX = 32;       // labels whose logits sit in registers
constexpr int STEP_LC = 4;          // labels a chunk of the slice
constexpr int STEP_SEG = 8;         // blur outputs a thread holds along g

struct StepArgs {
  const float* attrs;     // (Z, 8, P)
  const bf16* grid;       // (Z, D, C) z-blurred grid
  bf16* scratch;          // two-kernel form: (Z, nc*C, lp) blurred grid
  const bf16* fg;         // (Z, L, P) spatial filter of Q * gn
  const bf16* q;          // (Z, L, P)
  bf16* out;              // (Z, L, P)
  bf16* out_sub;          // (Z, L, Ps) or null
  const bf16* unary;      // (Z, L, P) explicit energies, or null: the
                          // two-level unary from the label row
  int P, L, nc, stride, cs_x, lb, ncp, lp, splits;
  float inv_step, cg, cb, n_energy, p_energy;
};

// The color taps on a dense window of radius re: w[(dr+re)(2re+1) + dg+re]
// the bf16 joint weights (zeros kept), b the f32 band.
struct StepTaps {
  int re;
  float w[MAX_CTAPS * MAX_CTAPS];
  float b[MAX_CTAPS];
};

StepTaps step_taps(const ColorTaps& t) {
  StepTaps s;
  int re = 1;   // a radius-0 band runs on the radius-1 instantiation
  const int R = t.n / 2;
  auto reach = [&re](int d) { re = d > re ? d : -d > re ? -d : re; };
  for (int i = 0; i < t.nrg; ++i) {
    reach(t.dr[i]);
    reach(t.dg[i]);
  }
  for (int i = 0; i < t.n; ++i)
    if (t.b[i] != 0.f) reach(i - R);
  s.re = re;
  const int n = 2 * s.re + 1;
  for (int i = 0; i < n * n; ++i) s.w[i] = 0.f;
  for (int i = 0; i < n; ++i) {
    const int off = i - s.re;
    s.b[i] = (off >= -R && off <= R) ? t.b[off + R] : 0.f;
  }
  for (int i = 0; i < t.nrg; ++i)
    s.w[(t.dr[i] + s.re) * n + t.dg[i] + s.re] = t.rg[i];
  return s;
}

// (r, g) pass of nl labels into Tb[lg][b][r][ncp] f32, one item per (label,
// b, r, segment of STEP_SEG along g); source (lg, b, r, g) at
// src[lg*ls + b*bs + r*nc + g], bf16.  The item's 2re+1 source rows sit in
// a register window, so each shared-memory load feeds 2re+1 taps.
template <int RE>
__device__ void blur_rg(const bf16* src, int ls, int bs, int nl, int nc,
                        int ncp, float* Tb, const StepTaps& t) {
  constexpr int NW = 2 * RE + 1, WIN = STEP_SEG + 2 * RE;
  const int nseg = ncp / STEP_SEG, items = nl * nc * nc * nseg;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int seg = it % nseg, rest = it / nseg, r = rest % nc;
    const int b = (rest / nc) % nc, lg = rest / (nc * nc);
    const bf16* sp = src + (size_t)lg * ls + (size_t)b * bs;
    const int g0 = seg * STEP_SEG;
    float acc[STEP_SEG];
#pragma unroll
    for (int j = 0; j < STEP_SEG; ++j) acc[j] = 0.f;
#pragma unroll
    for (int dr = -RE; dr <= RE; ++dr) {
      const int rr = r - dr;
      const bool rok = rr >= 0 && rr < nc;
      float win[WIN];   // win[m]: source column g0 + m - RE
#pragma unroll
      for (int m = 0; m < WIN; ++m) {
        const int gg = g0 + m - RE;
        win[m] = rok && gg >= 0 && gg < nc
                     ? __bfloat162float(sp[rr * nc + gg]) : 0.f;
      }
#pragma unroll
      for (int dg = -RE; dg <= RE; ++dg) {
        const float w = t.w[(dr + RE) * NW + dg + RE];
#pragma unroll
        for (int j = 0; j < STEP_SEG; ++j)
          acc[j] = __fmaf_rn(w, win[j - dg + RE], acc[j]);
      }
    }
    float4* o = reinterpret_cast<float4*>(
        Tb + (((size_t)lg * nc + b) * nc + r) * ncp + g0);
    o[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    o[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
}

// The b band of Tb, rounded to bf16: output (lg, b, r, g) to
// dst[lg*dl + b*db + (r*nc + g)*dc].
template <int RE>
__device__ void blur_b(const float* Tb, int nl, int nc, int ncp,
                       const StepTaps& t, bf16* dst, int dl, int db, int dc) {
  const int nseg = ncp / STEP_SEG, items = nl * nc * nc * nseg;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int seg = it % nseg, rest = it / nseg, r = rest % nc;
    const int b = (rest / nc) % nc, lg = rest / (nc * nc);
    const int g0 = seg * STEP_SEG;
    float acc[STEP_SEG];
#pragma unroll
    for (int j = 0; j < STEP_SEG; ++j) acc[j] = 0.f;
#pragma unroll
    for (int off = -RE; off <= RE; ++off) {
      const int b2 = b + off;
      if (b2 < 0 || b2 >= nc) continue;
      const float tb = t.b[off + RE];
      const float4* x = reinterpret_cast<const float4*>(
          Tb + (((size_t)lg * nc + b2) * nc + r) * ncp + g0);
      const float4 x0 = x[0], x1 = x[1];
      const float v[STEP_SEG] = {x0.x, x0.y, x0.z, x0.w,
                                 x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int j = 0; j < STEP_SEG; ++j)
        acc[j] = __fadd_rn(acc[j], __fmul_rn(v[j], tb));
    }
    bf16* o = dst + (size_t)lg * dl + (size_t)b * db;
#pragma unroll
    for (int j = 0; j < STEP_SEG; ++j)
      if (g0 + j < nc)
        o[(size_t)(r * nc + g0 + j) * dc] = __float2bfloat16_rn(acc[j]);
  }
}

// The slice of labels l0 .. l0 + nl - 1 (nl <= STEP_LC, l0 a multiple of
// STEP_LC) at one pixel into f[], per label as slice_at: per b bin the 4
// (r, g) corners in f32 (exact products), then the b hat weights.
// In shared memory, the (D, C) layout: one 2-byte load a corner and label.
struct SmemGrid {
  const bf16* g;
  int L, C;
  __device__ Corners at(const Hat& hr, const Hat& hg, const Hat& hb,
                        int nc) const {
    return corners(hr, hg, hb, nc, L * C, 1);
  }
  __device__ void slice(const Corners& k, int l0, int nl, float* f) const {
#pragma unroll
    for (int j = 0; j < STEP_LC; ++j) {
      if (j >= nl) break;
      const bf16* gl = g + (l0 + j) * C;
      float m[2];
#pragma unroll
      for (int kb = 0; kb < 2; ++kb) {
        m[kb] = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          m[kb] = __fmaf_rn(__bfloat162float(gl[k.off[kb * 4 + c]]),
                            k.w[kb * 4 + c], m[kb]);
      }
      f[j] = m[0] * k.wb[0] + m[1] * k.wb[1];
    }
  }
};

// In device scratch, in chunks of STEP_LC labels, each label-innermost
// ([chunk][b][r][g][STEP_LC]): one 8-byte load a corner for STEP_LC labels.
// chunk: the elements of one chunk, nc^3 * STEP_LC.
struct VecGrid {
  const bf16* g;
  int C, chunk;
  __device__ Corners at(const Hat& hr, const Hat& hg, const Hat& hb,
                        int nc) const {
    return corners(hr, hg, hb, nc, C * STEP_LC, STEP_LC);
  }
  __device__ void slice(const Corners& k, int l0, int nl, float* f) const {
    const bf16* gc = g + (size_t)(l0 / STEP_LC) * chunk;
    float m[2][STEP_LC];
#pragma unroll
    for (int kb = 0; kb < 2; ++kb) {
#pragma unroll
      for (int j = 0; j < STEP_LC; ++j) m[kb][j] = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint2 u =
            *reinterpret_cast<const uint2*>(gc + k.off[kb * 4 + c]);
        const float2 v01 = unpack_bf2(u.x), v23 = unpack_bf2(u.y);
        const float v[STEP_LC] = {v01.x, v01.y, v23.x, v23.y};
        const float w = k.w[kb * 4 + c];
#pragma unroll
        for (int j = 0; j < STEP_LC; ++j)
          m[kb][j] = __fmaf_rn(v[j], w, m[kb][j]);
      }
    }
#pragma unroll
    for (int j = 0; j < STEP_LC; ++j)
      if (j < nl) f[j] = m[0][j] * k.wb[0] + m[1][j] * k.wb[1];
  }
};

// The step's per-pixel prologue: hats, corners, the attrs it reads, where
// its Q goes.
struct StepPixel {
  Corners k;
  float gn, bn, bself, lab;
  size_t base;      // (z, label 0, p) in the (Z, L, P) planes
  long long sub;    // (z, label 0, its subsampled place), or -1: none
};

template <typename Grid>
__device__ __forceinline__ StepPixel step_prologue(const StepArgs& a, int z,
                                                   int p, const Grid& grid) {
  const int P = a.P;
  const float* at = a.attrs + (size_t)z * ATTR_ROWS * P;
  StepPixel s;
  const Hat hr = hat(at[p] * a.inv_step), hg = hat(at[P + p] * a.inv_step),
            hb = hat(at[2 * P + p] * a.inv_step);
  s.k = grid.at(hr, hg, hb, a.nc);
  s.gn = at[ATTR_GN * P + p];
  s.bn = at[ATTR_BN * P + p];
  s.bself = at[ATTR_BSELF * P + p];
  s.lab = at[ATTR_LABEL * P + p];
  s.base = (size_t)z * a.L * P + p;
  const int st = a.stride, py = p / a.cs_x, px = p - py * a.cs_x;
  s.sub = a.out_sub && py % st == 0 && px % st == 0
              ? (long long)z * a.L * (P / (st * st)) +
                    (py / st) * (a.cs_x / st) + px / st
              : -1;
  return s;
}

// Label l's logit at the pixel: messages and unary in f32, as the plain
// version orders them.
template <bool UNARY>
__device__ __forceinline__ float step_logit(const StepArgs& a,
                                            const StepPixel& s, int l,
                                            float filt) {
  const size_t o = s.base + (size_t)l * a.P;
  const float q = __bfloat162float(a.q[o]);
  const float msg_g = (__bfloat162float(a.fg[o]) - q * s.gn) * s.gn;
  const float msg_b = fmaxf(filt - s.bself * s.bn * q, 0.f) * s.bn;
  const float u = UNARY ? __bfloat162float(a.unary[o])
                        : ((float)l == s.lab ? a.p_energy : a.n_energy);
  return -u + a.cg * msg_g + a.cb * msg_b;
}

__device__ __forceinline__ void step_store(const StepArgs& a,
                                           const StepPixel& s, int l,
                                           float v, int ps) {
  const bf16 q = __float2bfloat16_rn(v);
  a.out[s.base + (size_t)l * a.P] = q;
  if (s.sub >= 0) a.out_sub[s.sub + (long long)l * ps] = q;
}

// One pixel of the step on one thread, its logits in registers: NL labels
// (a compile-time count: its loops unroll with no test of L, so the loads
// of q and fg issue ahead of the arithmetic), or with NL = 0 the run-time
// L <= STEP_LMAX.  The softmax in the plain version's order: the max, then
// the e summed in label order, then each e divided by the sum.
template <bool UNARY, int NL, typename Grid>
__device__ __forceinline__ void step_pixel(const StepArgs& a, int z, int p,
                                           const Grid& grid) {
  constexpr int NR = NL ? NL : STEP_LMAX;
  const int L = NL ? NL : a.L;
  const StepPixel s = step_prologue(a, z, p, grid);
  float lg[NR];
  float mx = -INFINITY, sum = 0.f;
#pragma unroll
  for (int l0 = 0; l0 < NR; l0 += STEP_LC) {
    if (l0 < L) {
      float f[STEP_LC];
      grid.slice(s.k, l0, min(STEP_LC, L - l0), f);
#pragma unroll
      for (int j = 0; j < STEP_LC; ++j)
        if (l0 + j < L) {
          lg[l0 + j] = step_logit<UNARY>(a, s, l0 + j, f[j]);
          mx = fmaxf(mx, lg[l0 + j]);
        }
    }
  }
#pragma unroll
  for (int l = 0; l < NR; ++l)
    if (l < L) {
      lg[l] = expf(lg[l] - mx);
      sum += lg[l];
    }
  const int ps = a.P / (a.stride * a.stride);
#pragma unroll
  for (int l = 0; l < NR; ++l)
    if (l < L) step_store(a, s, l, lg[l] / sum, ps);
}

// One pixel on one thread, its logits in shared memory, lgs[l * blockDim.x]
// (any L; the two-kernel form's pixel pass where L > STEP_LMAX).
template <bool UNARY, typename Grid>
__device__ __forceinline__ void step_pixel_smem(const StepArgs& a, int z,
                                                int p, const Grid& grid,
                                                float* lgs) {
  const int L = a.L, T = blockDim.x;
  const StepPixel s = step_prologue(a, z, p, grid);
  float mx = -INFINITY, sum = 0.f;
  for (int l0 = 0; l0 < L; l0 += STEP_LC) {
    float f[STEP_LC];
    grid.slice(s.k, l0, min(STEP_LC, L - l0), f);
    for (int j = 0; j < STEP_LC && l0 + j < L; ++j) {
      const float v = step_logit<UNARY>(a, s, l0 + j, f[j]);
      lgs[(l0 + j) * T] = v;
      mx = fmaxf(mx, v);
    }
  }
  for (int l = 0; l < L; ++l) {
    const float e = expf(lgs[l * T] - mx);
    lgs[l * T] = e;
    sum += e;
  }
  const int ps = a.P / (a.stride * a.stride);
  for (int l = 0; l < L; ++l) step_store(a, s, l, lgs[l * T] / sum, ps);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(gmem));
}

// Bytes of the fused kernel's shared memory (step_fused_smem in
// kernels/crf_fused.py): the cell's bf16 grid with room to keep its 16-byte
// alignment, then the (r, g) pass's f32 [lb][nc][nc][ncp].
__host__ __device__ inline size_t step_grid_bytes(int nc, int L) {
  return align16((size_t)2 * ((size_t)nc * L * nc * nc + 8));
}
__host__ __device__ inline size_t step_fused_smem(int nc, int L, int lb,
                                                  int ncp) {
  return step_grid_bytes(nc, L) + (size_t)4 * lb * nc * nc * ncp;
}

// One block of T threads per (cell, split): block (z, s) stages and blurs
// cell z's grid and takes its pixels s*T .. s*T + T - 1, then every
// splits*T further.
template <int RE, bool UNARY, int NL>
__global__ void __launch_bounds__(NL ? STEP_THREADS_L21 : STEP_THREADS, 1)
mf_step_fused_kernel(StepArgs a, StepTaps t) {
  const int z = blockIdx.x, L = a.L, nc = a.nc, C = nc * nc;
  const int n = nc * L * C, tid = threadIdx.x;
  constexpr int T = NL ? STEP_THREADS_L21 : STEP_THREADS;
  // stage the cell's grid with cp.async, at the same offset within 16
  // bytes as in device memory (staging it a blur round at a time, the
  // round's blur starting while later copies are in flight, measured
  // slower)
  const bf16* src = a.grid + (size_t)z * n;
  const int mis = (int)(((uintptr_t)src & 15) / 2);
  bf16* G = reinterpret_cast<bf16*>(dyn_smem) + mis;
  float* Tb = reinterpret_cast<float*>(dyn_smem + step_grid_bytes(nc, L));
  const int head = min(n, (8 - mis) & 7), body = (n - head) / 8 * 8;
  for (int i = tid; i < body / 8; i += T)
    cp_async16(G + head + 8 * i, src + head + 8 * i);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int i = tid; i < head; i += T) G[i] = src[i];
  for (int i = head + body + tid; i < n; i += T) G[i] = src[i];
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  // the color blur in place, lb labels a round
  for (int l0 = 0; l0 < L; l0 += a.lb) {
    const int nl = min(a.lb, L - l0);
    blur_rg<RE>(G + l0 * C, C, L * C, nl, nc, a.ncp, Tb, t);
    __syncthreads();
    blur_b<RE>(Tb, nl, nc, a.ncp, t, G + l0 * C, C, L * C, 1);
    __syncthreads();
  }
  const SmemGrid grid{G, L, C};
  for (int p = blockIdx.y * T + tid; p < a.P; p += T * a.splits)
    step_pixel<UNARY, NL>(a, z, p, grid);
}

// Two-kernel form, 1: the blur of one (cell, chunk of STEP_LC labels) into
// the chunk-major scratch, label by label through a tile of the chunk in
// shared memory ([b][r][g][STEP_LC], labels past L zero), then stored whole,
// 8 bytes a grid point.
inline size_t step_blur_smem(int nc, int ncp) {
  return align16((size_t)2 * nc * nc * nc) + (size_t)4 * nc * nc * ncp +
         (size_t)2 * STEP_LC * nc * nc * nc;
}

template <int RE>
__global__ void __launch_bounds__(STEP_BLUR_THREADS)
grid_blur_li_kernel(StepArgs a, StepTaps t) {
  const int z = blockIdx.x, ch = blockIdx.y, L = a.L, nc = a.nc, C = nc * nc;
  const int n3 = nc * C;
  bf16* S = reinterpret_cast<bf16*>(dyn_smem);                // [nc][C]
  float* Tb = reinterpret_cast<float*>(dyn_smem + align16((size_t)2 * n3));
  bf16* O = reinterpret_cast<bf16*>(Tb + (size_t)nc * nc * a.ncp);
  for (int j = 0; j < STEP_LC; ++j) {
    const int l = ch * STEP_LC + j;
    if (l >= L) {
      for (int i = threadIdx.x; i < n3; i += blockDim.x)
        O[i * STEP_LC + j] = __float2bfloat16_rn(0.f);
      continue;
    }
    const bf16* src = a.grid + (size_t)z * nc * L * C + (size_t)l * C;
    for (int i = threadIdx.x; i < n3; i += blockDim.x) {
      const int b = i / C;
      S[i] = src[(size_t)b * L * C + i - b * C];
    }
    __syncthreads();
    blur_rg<RE>(S, 0, C, 1, nc, a.ncp, Tb, t);
    __syncthreads();
    blur_b<RE>(Tb, 1, nc, a.ncp, t, O + j, 0, C * STEP_LC, STEP_LC);
    __syncthreads();
  }
  __syncthreads();
  uint2* dst = reinterpret_cast<uint2*>(
      a.scratch + ((size_t)z * (a.lp / STEP_LC) + ch) * n3 * STEP_LC);
  for (int i = threadIdx.x; i < n3; i += blockDim.x)
    dst[i] = reinterpret_cast<const uint2*>(O)[i];
}

// Two-kernel form, 2: the pixel pass, a pixel a thread; NL >= 0: the
// logits in registers (NL labels, or with 0 any L <= STEP_LMAX), NL < 0: in
// shared memory (any L).
template <bool UNARY, int NL>
__global__ void __launch_bounds__(STEP_PIX_THREADS)
mf_step_pixel_kernel(StepArgs a) {
  const int z = blockIdx.x, n3 = a.nc * a.nc * a.nc;
  const int p = blockIdx.y * STEP_PIX_THREADS + threadIdx.x;
  const VecGrid grid{a.scratch + (size_t)z * n3 * a.lp, a.nc * a.nc,
                     n3 * STEP_LC};
  if (p >= a.P) return;
  if (NL >= 0)
    step_pixel<UNARY, NL < 0 ? 0 : NL>(a, z, p, grid);
  else
    step_pixel_smem<UNARY>(a, z, p, grid,
                           reinterpret_cast<float*>(dyn_smem) + threadIdx.x);
}

// ------------------------------------------------------------ slice_planes ----
// out[z, l, p] = the slice at pixel p of the color-blurred grid's label-l
// planes, f32 (slice_plan in kernels/crf_fused.py).  One block per (cell,
// group of lg labels, pixel split), the group's labels lb at a time:
//  1. a round's f32 planes by cp.async into X (16-byte copies, 4-byte ones
//     for the ends of a plane's run of C floats; each label's planes at the
//     same offset within 16 bytes as in device memory, X's pitch xp being
//     C*L modulo 4);
//  2. rounded to bf16 once into S, a thread a grid row, each plane with
//     SLICE_PAD zero rows and columns around it (with PAD; so that the
//     (r, g) pass loads its windows as unconditional 4-byte pairs) or none
//     (grids too large for the padding); X lies in Tb's place, so the next
//     round's copy waits for the b band;
//  3. the (r, g) pass of the round (blur_rg_pad, or blur_rg_rows without
//     padding) into Tb, then its b band (blur_b_round, the step's blur_b
//     with a grid point's pair of labels one store) into O, the group's
//     blurred grid label-innermost [b][r][g][LGP] bf16;
//  4. a thread a pixel: its hats and corners once, then per corner the
//     group's labels as one LGP-wide load from O, summed as slice_at sums;
//     each label's row of P f32 outputs written coalesced.
// Both passes keep blur_rg's order for every output, (dr, dg) row-major
// with a zero tap or an off-grid source adding an exact zero, so the
// blurred grid equals grid_blur_kernel's bit for bit and the outputs equal
// the two-kernel form this kernel replaced.
constexpr int SLICE_THREADS = 512;
constexpr int SLICE_LG_MAX = 8;     // labels a group: one 16-byte load
constexpr int SLICE_LB = 2;         // labels a blur round, at most
constexpr int SLICE_RR = 3;         // (r, g) pass: output rows an item
constexpr int SLICE_PIX = 4;        // pixels a thread loads ahead
constexpr int SLICE_PAD = MAX_CTAPS / 2;   // zero rows and columns around S

struct SliceArgs {
  const float* rgb;       // (Z, 3, P)
  const float* grid;      // (Z, nc*L, C) z-blurred, f32
  float* out;             // (Z, L, P)
  int P, L, nc, lg, lb, splits, ncp;
  int xp, prow, spitch;   // X's run pitch; S's rows and row pitch a plane
  int s_off, tb_off;      // byte offsets (O at 0); X in Tb's place
  float inv_step;
};

// The slice_plan's shared-memory layout (slice_smem in kernels/crf_fused.py):
// O [nc^3][LGP] bf16; S [lb][nc][prow][spitch] bf16 (padded, or prow =
// spitch = nc); Tb [lb][nc][nc][ncp] f32, and in its place X, lb labels of
// nc runs of xp floats and 4 of room for their offset.
struct SliceLayout {
  int xp, prow, spitch;
  size_t s_off, tb_off, total;
};

__host__ __device__ inline int slice_lgp(int lg) {
  return lg <= 1 ? 1 : lg <= 2 ? 2 : lg <= 4 ? 4 : 8;
}

// Floats of a staged label: nc runs of xp, a whole number of 16-byte words
// with room for the runs' offset.
__host__ __device__ inline int slice_xl(int nc, int xp) {
  return (nc * xp + 3) / 4 * 4 + 4;
}

inline SliceLayout slice_layout(int nc, int L, int lg, int lb, bool pad) {
  const int C = nc * nc, ncp = (nc + STEP_SEG - 1) / STEP_SEG * STEP_SEG;
  SliceLayout s;
  s.xp = C + ((L - 1) * C) % 4;
  s.prow = pad ? (nc + SLICE_RR - 1) / SLICE_RR * SLICE_RR + 2 * SLICE_PAD
               : nc;
  s.spitch = pad ? ncp + 2 * SLICE_PAD : nc;
  s.s_off = align16((size_t)2 * slice_lgp(lg) * nc * C);
  s.tb_off = s.s_off + align16((size_t)2 * lb * nc * s.prow * s.spitch);
  const size_t tb = (size_t)4 * lb * nc * nc * ncp;
  const size_t x = (size_t)4 * lb * slice_xl(nc, s.xp);
  s.total = s.tb_off + (x > tb ? x : tb);
  return s;
}

// The (r, g) pass of nl labels as blur_rg computes it, an item per (label,
// b, SLICE_RR rows, segment of STEP_SEG along g), from S's zero-padded
// planes ([label][b][prow][spitch], row r and column g at r + SLICE_PAD, g +
// SLICE_PAD): the item walks its 2re + SLICE_RR source rows from the bottom
// up, each row's window loaded once, as 4-byte pairs, and fed to every
// output row it reaches, so that each output still sums its taps in (dr,
// dg) row-major order.  Output (label, b, r, g) to
// Tb[((label*nc + b)*nc + r)*ncp + g].
template <int RE>
__device__ void blur_rg_pad(const bf16* S, int nl, int nc, int ncp, int prow,
                            int spitch, float* Tb, const StepTaps& t) {
  constexpr int RR = SLICE_RR, NW = 2 * RE + 1, WIN = STEP_SEG + 2 * RE;
  // the window's first column in S is g0 + SLICE_PAD - RE: from the even
  // column at or below it, NP pairs
  constexpr int OFF = SLICE_PAD - RE, SH = OFF & 1, NP = (SH + WIN + 1) / 2;
  const int nseg = ncp / STEP_SEG, nrb = (nc + RR - 1) / RR;
  const int items = nl * nc * nrb * nseg;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int seg = it % nseg, rest = it / nseg, rb = rest % nrb;
    const int plane = rest / nrb;    // label * nc + b
    const int g0 = seg * STEP_SEG, r0 = rb * RR;
    const bf16* sp = S + (size_t)plane * prow * spitch + g0 + OFF - SH;
    float acc[RR][STEP_SEG];
#pragma unroll
    for (int i = 0; i < RR; ++i)
#pragma unroll
      for (int j = 0; j < STEP_SEG; ++j) acc[i][j] = 0.f;
#pragma unroll
    for (int q = 0; q < RR + 2 * RE; ++q) {
      const int rr = r0 + RR - 1 + RE - q;    // source row, bottom up
      const uint32_t* row = reinterpret_cast<const uint32_t*>(
          sp + (size_t)(rr + SLICE_PAD) * spitch);
      float e[2 * NP];
#pragma unroll
      for (int k = 0; k < NP; ++k) {
        const float2 f = unpack_bf2(row[k]);
        e[2 * k] = f.x;
        e[2 * k + 1] = f.y;
      }
#pragma unroll
      for (int i = 0; i < RR; ++i) {
        const int dr = i + q - (RR - 1) - RE;   // output r0 + i - rr
        if (dr < -RE || dr > RE) continue;
#pragma unroll
        for (int dg = -RE; dg <= RE; ++dg) {
          const float w = t.w[(dr + RE) * NW + dg + RE];
#pragma unroll
          for (int j = 0; j < STEP_SEG; ++j)   // source column g0 + j - dg
            acc[i][j] = __fmaf_rn(w, e[SH + j - dg + RE], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RR; ++i) {
      if (r0 + i >= nc) break;
      float4* o = reinterpret_cast<float4*>(
          Tb + ((size_t)plane * nc + r0 + i) * ncp + g0);
      o[0] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      o[1] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
}

// blur_rg_pad's pass on unpadded planes, S [label][b][nc][nc]: each window
// value loaded element by element, zero off the grid.
template <int RE>
__device__ void blur_rg_rows(const bf16* S, int nl, int nc, int ncp,
                             float* Tb, const StepTaps& t) {
  constexpr int RR = SLICE_RR, NW = 2 * RE + 1, WIN = STEP_SEG + 2 * RE;
  const int nseg = ncp / STEP_SEG, nrb = (nc + RR - 1) / RR;
  const int items = nl * nc * nrb * nseg;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int seg = it % nseg, rest = it / nseg, rb = rest % nrb;
    const int plane = rest / nrb;
    const int g0 = seg * STEP_SEG, r0 = rb * RR;
    const bf16* sp = S + (size_t)plane * nc * nc;
    float acc[RR][STEP_SEG];
#pragma unroll
    for (int i = 0; i < RR; ++i)
#pragma unroll
      for (int j = 0; j < STEP_SEG; ++j) acc[i][j] = 0.f;
#pragma unroll
    for (int q = 0; q < RR + 2 * RE; ++q) {
      const int rr = r0 + RR - 1 + RE - q;    // source row, bottom up
      const bool rok = rr >= 0 && rr < nc;
      float win[WIN];   // win[m]: source column g0 + m - RE
#pragma unroll
      for (int m = 0; m < WIN; ++m) {
        const int gg = g0 + m - RE;
        win[m] = rok && gg >= 0 && gg < nc
                     ? __bfloat162float(sp[rr * nc + gg]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RR; ++i) {
        const int dr = i + q - (RR - 1) - RE;   // output r0 + i - rr
        if (dr < -RE || dr > RE) continue;
#pragma unroll
        for (int dg = -RE; dg <= RE; ++dg) {
          const float w = t.w[(dr + RE) * NW + dg + RE];
#pragma unroll
          for (int j = 0; j < STEP_SEG; ++j)
            acc[i][j] = __fmaf_rn(w, win[j - dg + RE], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RR; ++i) {
      if (r0 + i >= nc) break;
      float4* o = reinterpret_cast<float4*>(
          Tb + ((size_t)plane * nc + r0 + i) * ncp + g0);
      o[0] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      o[1] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
}

// blur_b for a round of nb <= SLICE_LB labels of the slice: an item per (b,
// r, segment of STEP_SEG along g) sums the round's labels in the same order
// (off ascending, separate multiply and add), and a grid point's pair of
// labels, adjacent in O's label-innermost layout (j0 even), is one 4-byte
// store.  Output (label j, b, r, g) to O[(b*C + r*nc + g)*lgp + j0 + j].
template <int RE>
__device__ void blur_b_round(const float* Tb, int nb, int nc, int ncp,
                             const StepTaps& t, bf16* O, int j0, int lgp) {
  const int nseg = ncp / STEP_SEG, items = nc * nc * nseg, C = nc * nc;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int seg = it % nseg, rest = it / nseg, r = rest % nc;
    const int b = rest / nc, g0 = seg * STEP_SEG;
    float acc[SLICE_LB][STEP_SEG];
#pragma unroll
    for (int l = 0; l < SLICE_LB; ++l)
#pragma unroll
      for (int j = 0; j < STEP_SEG; ++j) acc[l][j] = 0.f;
#pragma unroll
    for (int off = -RE; off <= RE; ++off) {
      const int b2 = b + off;
      if (b2 < 0 || b2 >= nc) continue;
      const float tb = t.b[off + RE];
#pragma unroll
      for (int l = 0; l < SLICE_LB; ++l) {
        if (l >= nb) break;
        const float4* x = reinterpret_cast<const float4*>(
            Tb + (((size_t)l * nc + b2) * nc + r) * ncp + g0);
        const float4 x0 = x[0], x1 = x[1];
        const float v[STEP_SEG] = {x0.x, x0.y, x0.z, x0.w,
                                   x1.x, x1.y, x1.z, x1.w};
#pragma unroll
        for (int j = 0; j < STEP_SEG; ++j)
          acc[l][j] = __fadd_rn(acc[l][j], __fmul_rn(v[j], tb));
      }
    }
    bf16* o = O + (size_t)(b * C + r * nc + g0) * lgp + j0;
#pragma unroll
    for (int j = 0; j < STEP_SEG; ++j) {
      if (g0 + j >= nc) break;
      if (nb == 2)
        *reinterpret_cast<uint32_t*>(o + (size_t)j * lgp) =
            pack_bf2(acc[0][j], acc[1][j]);
      else
        o[(size_t)j * lgp] = __float2bfloat16_rn(acc[0][j]);
    }
  }
}

// The LGP labels of one grid point of O, as f32.
template <int LGP>
__device__ __forceinline__ void load_labels(const bf16* p, float* v) {
  if constexpr (LGP == 1) {
    v[0] = __bfloat162float(*p);
  } else {
    uint32_t w[LGP / 2];
    if constexpr (LGP == 2) {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    } else if constexpr (LGP == 4) {
      const uint2 q = *reinterpret_cast<const uint2*>(p);
      w[0] = q.x;
      w[1] = q.y;
    } else {
      const uint4 q = *reinterpret_cast<const uint4*>(p);
      w[0] = q.x;
      w[1] = q.y;
      w[2] = q.z;
      w[3] = q.w;
    }
#pragma unroll
    for (int h = 0; h < LGP / 2; ++h) {
      const float2 f = unpack_bf2(w[h]);
      v[2 * h] = f.x;
      v[2 * h + 1] = f.y;
    }
  }
}

template <int RE, int LGP, bool PAD>
__global__ void __launch_bounds__(SLICE_THREADS)
slice_fused_kernel(SliceArgs a, StepTaps t) {
  const int z = blockIdx.x, nc = a.nc, C = nc * nc, L = a.L, P = a.P;
  const int l0 = blockIdx.y * a.lg, nl = min(a.lg, L - l0);
  const int tid = threadIdx.x, T = blockDim.x;
  bf16* O = reinterpret_cast<bf16*>(dyn_smem);
  bf16* S = reinterpret_cast<bf16*>(dyn_smem + a.s_off);
  float* Tb = reinterpret_cast<float*>(dyn_smem + a.tb_off);
  // label j's plane b: a run of C floats at src + b*L*C + j*C; label jj of
  // a round at X + jj*slice_xl + its offset within 16 bytes
  const float* src = a.grid + ((size_t)z * nc * L + l0) * C;
  float* X = Tb;
  const int xl = slice_xl(nc, a.xp);
  auto mis = [&](int j) { return (int)(((uintptr_t)(src + j * C) >> 2) & 3); };
  // a round's copies as one loop over its planes' words: plane (label jj,
  // b) takes VPP items, its 16-byte words then its 4-byte ends
  const int VPP = C / 4 + 6;
  auto stage = [&](int j0) {   // the round of labels j0 .. j0 + lb - 1
    const int nb = min(a.lb, nl - j0);
    for (int w = tid; w < nb * nc * VPP; w += T) {
      const int plane = w / VPP, k = w - plane * VPP;
      const int jj = plane / nc, b = plane - jj * nc;
      const int m = mis(j0 + jj);
      const float* s = src + (size_t)(j0 + jj) * C + (size_t)b * L * C;
      float* d = X + jj * xl + m + b * a.xp;
      const int head = min(C, (4 - ((m + b * a.xp) & 3)) & 3);
      const int body = (C - head) / 4, ends = C - 4 * body;
      if (k < body) {
        cp_async16(d + head + 4 * k, s + head + 4 * k);
      } else if (k - body < ends) {
        const int i = k - body, e = i < head ? i : 4 * body + i;
        cp_async4(d + e, s + e);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  stage(0);
  // S's zero rows and columns (its interior is rewritten every round)
  if (PAD) {
    const int sn = a.lb * nc * a.prow * a.spitch;
    for (int i = tid; i < sn / 2; i += T)
      reinterpret_cast<uint32_t*>(S)[i] = 0u;
  }
  constexpr int SP = PAD ? SLICE_PAD : 0;
  for (int j0 = 0; j0 < nl; j0 += a.lb) {
    const int nb = min(a.lb, nl - j0);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();   // the round's planes; S and Tb free
    // S = bf16(X), a thread a grid row (label jj, plane b, row r)
    for (int row = tid; row < nb * nc * nc; row += T) {
      const int plane = row / nc, r = row - plane * nc;
      const int jj = plane / nc, b = plane - jj * nc;
      const float* x = X + jj * xl + mis(j0 + jj) + b * a.xp + r * nc;
      bf16* d = S + ((size_t)plane * a.prow + r + SP) * a.spitch + SP;
      for (int g = 0; g < nc; ++g) d[g] = __float2bfloat16_rn(x[g]);
    }
    __syncthreads();   // S; X free
    if (PAD)
      blur_rg_pad<RE>(S, nb, nc, a.ncp, a.prow, a.spitch, Tb, t);
    else
      blur_rg_rows<RE>(S, nb, nc, a.ncp, Tb, t);
    __syncthreads();
    blur_b_round<RE>(Tb, nb, nc, a.ncp, t, O, j0, LGP);
    if (j0 + a.lb < nl) {
      __syncthreads();   // Tb read: X takes its place
      stage(j0 + a.lb);
    }
  }
  __syncthreads();
  // 3. the pixels of this split, a thread each, SLICE_PIX at a time: their
  // rgb loads issue together, ahead of the arithmetic
  const float* px = a.rgb + (size_t)z * 3 * P;
  float* out = a.out + ((size_t)z * L + l0) * P;
  const int step = T * a.splits;
  for (int p0 = blockIdx.z * T + tid; p0 < P; p0 += SLICE_PIX * step) {
    float rgb[SLICE_PIX][3];
#pragma unroll
    for (int u = 0; u < SLICE_PIX; ++u) {
      const int p = p0 + u * step;
#pragma unroll
      for (int c = 0; c < 3; ++c) rgb[u][c] = p < P ? px[c * P + p] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < SLICE_PIX; ++u) {
      const int p = p0 + u * step;
      if (p >= P) break;
      const Hat hr = hat(rgb[u][0] * a.inv_step),
                hg = hat(rgb[u][1] * a.inv_step),
                hb = hat(rgb[u][2] * a.inv_step);
      const Corners k = corners(hr, hg, hb, nc, C * LGP, LGP);
      float m[2][LGP];
#pragma unroll
      for (int kb = 0; kb < 2; ++kb) {
#pragma unroll
        for (int j = 0; j < LGP; ++j) m[kb][j] = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float v[LGP];
          load_labels<LGP>(O + k.off[kb * 4 + c], v);
          const float w = k.w[kb * 4 + c];
#pragma unroll
          for (int j = 0; j < LGP; ++j)
            m[kb][j] = __fmaf_rn(v[j], w, m[kb][j]);
        }
      }
#pragma unroll
      for (int j = 0; j < LGP; ++j)
        if (j < nl)
          out[(size_t)j * P + p] = m[0][j] * k.wb[0] + m[1][j] * k.wb[1];
    }
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

// The two-pass blur (pass_plan in kernels/crf_fused.py).  One block per
// (cell, strip of ty rows, group of lg labels), the strip the whole cell
// wherever its tile fits in shared memory.  Per label the block stages its
// tile with 16-byte loads (8 bf16; elementwise where the cells' width is
// not a multiple of 8), sums, and writes its outputs from registers.
//  - y pass: the strip's rows and r halo rows above and below, found by
//    image row in the cells above and below through a table of the tile's
//    rows built once per block (zero outside the image); the f32 gn tile
//    staged once for the group; A = bf16(a * gn) in shared memory as bf16.
//    A thread takes a column pair and PASS_RY rows, and streams down the
//    column pair: each 4-byte load feeds up to 2 * PASS_RY taps.
//  - x pass: the strip's rows with halo columns (r rounded up to 8, so that
//    16-byte words never straddle two cells) from the cells left and right.
//    A thread takes 8 outputs of a row and streams along it, 16 bytes a
//    load, each value feeding up to 8 taps.
// Output (j) sums tap k of the value at j + k in tap order with one fmaf a
// term (the products of two bf16 values are exact), as the plain versions
// do: each pass equals its plain version bit for bit.  NT, the tap count,
// is a template parameter for the common counts (17: r = 8; 41: r = 20),
// whose taps are compile-time-indexed kernel parameters; with NT = 0 any
// count up to MAX_YX_TAPS, the taps staged in shared memory and slid
// through a register window of the PASS_RY (or 8) taps a value meets.
constexpr int PASS_RY = 8;             // y-pass rows a thread
constexpr int PASS_MAX_THREADS = 512;
constexpr int PASS_PREFETCH = 8;       // 16-byte words of a a y-pass thread
                                       // holds for the next label

struct PassArgs {
  const bf16* in;         // (B*Z, L, P): a for the y pass, its output for x
  const float* gn;        // y: (Z, 1, P), or (B*Z, 1, P) when gn_per_image
  bf16* out;              // (B*Z, L, P)
  int ny, nx, cs_y, cs_x, L, ty, lg, wp, halo, gn_per_image, vec;
  LongTaps taps;
};

// The pass_plan's shared-memory layout (pass_smem in kernels/crf_fused.py):
// the taps (f32, padded to 4), then for the y pass the tile's row table
// (cell and row offset, 2 ints a row) and the f32 gn and bf16 A tiles of
// round_up(ty, PASS_RY) + 2r rows of wp; for the x pass the bf16 tile of ty
// rows of wp = round_up(cs_x, 8) + 2 * halo.
struct PassLayout {
  int rows, wp, halo;
  size_t table, tile, total;
};

inline PassLayout pass_layout(int ty, int cs_x, int ntaps, bool y_pass) {
  PassLayout s;
  const int r = ntaps / 2, cx = (cs_x + 7) / 8 * 8;
  s.halo = (r + 7) / 8 * 8;
  s.table = align16((size_t)4 * ((ntaps + 3) / 4 * 4));
  if (y_pass) {
    s.rows = (ty + PASS_RY - 1) / PASS_RY * PASS_RY + 2 * r;
    s.wp = cx;
    s.tile = s.table + align16((size_t)8 * s.rows);
    s.total = s.tile + (size_t)s.rows * s.wp * (sizeof(float) + sizeof(bf16));
  } else {
    s.rows = ty;
    s.wp = cx + 2 * s.halo;
    s.tile = s.table;
    s.total = s.tile + (size_t)s.rows * s.wp * sizeof(bf16);
  }
  return s;
}

__device__ __forceinline__ void store_outputs(bf16* o, const float* v, int n,
                                              int avail, bool vec) {
  // n (2 or 8) consecutive outputs, of which `avail` lie in the cell
  if (vec && avail >= n) {
    if (n == 8) {
      uint4 w;
      w.x = pack_bf2(v[0], v[1]); w.y = pack_bf2(v[2], v[3]);
      w.z = pack_bf2(v[4], v[5]); w.w = pack_bf2(v[6], v[7]);
      *reinterpret_cast<uint4*>(o) = w;
    } else {
      *reinterpret_cast<uint32_t*>(o) = pack_bf2(v[0], v[1]);
    }
    return;
  }
  for (int j = 0; j < n && j < avail; ++j) o[j] = __float2bfloat16_rn(v[j]);
}

template <int NT>
__global__ void __launch_bounds__(PASS_MAX_THREADS)
blur_y_kernel(PassArgs a) {
  constexpr int RY = PASS_RY;
  const int n = NT ? NT : a.taps.n, r = n / 2;
  const int Z = a.ny * a.nx, P = a.cs_y * a.cs_x, wp = a.wp;
  const int z = blockIdx.x, bimg = z / Z, zz = z % Z;
  const int iy = zz / a.nx, ix = zz % a.nx;
  const int y0 = blockIdx.y * a.ty, rows = min(a.ty, a.cs_y - y0);
  const int H = (rows + RY - 1) / RY * RY + 2 * r;   // tile rows staged
  const int Ha = (a.ty + RY - 1) / RY * RY + 2 * r;  // tile rows allocated
  const int tid = threadIdx.x, T = blockDim.x;
  float* tap = reinterpret_cast<float*>(dyn_smem);
  int* rcell = reinterpret_cast<int*>(
      dyn_smem + align16((size_t)4 * ((n + 3) / 4 * 4)));
  int* roff = rcell + Ha;
  float* G = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(rcell) + align16((size_t)8 * Ha));
  bf16* A = reinterpret_cast<bf16*>(G + (size_t)Ha * wp);
  if (!NT)
    for (int i = tid; i < n; i += T) tap[i] = a.taps.t[i];
  // the tile's rows: image row iy*cs_y + y0 + yy - r, in cell rcell (of the
  // batch) at row offset roff, or rcell -1 outside the image
  for (int yy = tid; yy < H; yy += T) {
    const int gy = iy * a.cs_y + y0 + yy - r;
    int cell = -1, off = 0;
    if (gy >= 0 && gy < a.ny * a.cs_y) {
      const int iy2 = gy / a.cs_y;
      cell = bimg * Z + iy2 * a.nx + ix;
      off = (gy - iy2 * a.cs_y) * a.cs_x;
    }
    rcell[yy] = cell;
    roff[yy] = off;
  }
  __syncthreads();
  const int V = a.vec ? 8 : 1, units = wp / V;
  const int gbase = a.gn_per_image ? 0 : bimg * Z;   // gn plane of a cell
  for (int i = tid; i < H * units; i += T) {
    const int yy = i / units, x = (i - yy * units) * V;
    const int cell = rcell[yy];
    float* d = G + (size_t)yy * wp + x;
    if (V == 8) {
      float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
      if (cell >= 0) {
        const float4* s = reinterpret_cast<const float4*>(
            a.gn + (size_t)(cell - gbase) * P + roff[yy] + x);
        lo = s[0];
        hi = s[1];
      }
      reinterpret_cast<float4*>(d)[0] = lo;
      reinterpret_cast<float4*>(d)[1] = hi;
    } else {
      *d = cell >= 0 && x < a.cs_x
               ? a.gn[(size_t)(cell - gbase) * P + roff[yy] + x] : 0.f;
    }
  }
  const int npairs = (a.cs_x + 1) / 2, segs = (rows + RY - 1) / RY;
  const int l_end = min(a.L, (int)blockIdx.z * a.lg + a.lg);
  // With 16-byte staging of at most PASS_PREFETCH words a thread, the next
  // label's words are loaded into registers while this label's sums run.
  const int words = H * units;
  const bool prefetch = V == 8 && words <= PASS_PREFETCH * T;
  uint4 next[PASS_PREFETCH];
  auto fetch = [&](int l) {
#pragma unroll
    for (int q = 0; q < PASS_PREFETCH; ++q) {
      const int i = tid + q * T;
      next[q] = make_uint4(0, 0, 0, 0);
      if (i < words) {
        const int yy = i / units, cell = rcell[yy];
        if (cell >= 0)
          next[q] = *reinterpret_cast<const uint4*>(
              a.in + ((size_t)cell * a.L + l) * P + roff[yy] +
              (i - yy * units) * 8);
      }
    }
  };
  if (prefetch) fetch(blockIdx.z * a.lg);
  for (int l = blockIdx.z * a.lg; l < l_end; ++l) {
    __syncthreads();   // the gn tile; the previous label's sums
    // A = bf16(a * gn), zero outside the image
#pragma unroll
    for (int q = 0; q < PASS_PREFETCH; ++q) {
      const int i = tid + q * T;
      if (!prefetch || i >= words) break;
      const int yy = i / units, x = (i - yy * units) * 8;
      const float4* g4 = reinterpret_cast<const float4*>(
          G + (size_t)yy * wp + x);
      const float4 ga = g4[0], gb = g4[1];
      const float g[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
      const uint32_t sw[4] = {next[q].x, next[q].y, next[q].z, next[q].w};
      uint32_t vw[4];
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const float2 f = unpack_bf2(sw[h]);
        vw[h] = pack_bf2(f.x * g[2 * h], f.y * g[2 * h + 1]);
      }
      *reinterpret_cast<uint4*>(A + (size_t)yy * wp + x) =
          make_uint4(vw[0], vw[1], vw[2], vw[3]);
    }
    for (int i = tid; !prefetch && i < words; i += T) {
      const int yy = i / units, x = (i - yy * units) * V;
      const int cell = rcell[yy];
      const float* g = G + (size_t)yy * wp + x;
      bf16* d = A + (size_t)yy * wp + x;
      if (V == 8) {
        uint4 v = make_uint4(0, 0, 0, 0);
        if (cell >= 0) {
          const uint4 s = *reinterpret_cast<const uint4*>(
              a.in + ((size_t)cell * a.L + l) * P + roff[yy] + x);
          const uint32_t sw[4] = {s.x, s.y, s.z, s.w};
          uint32_t vw[4];
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const float2 f = unpack_bf2(sw[h]);
            vw[h] = pack_bf2(f.x * g[2 * h], f.y * g[2 * h + 1]);
          }
          v = make_uint4(vw[0], vw[1], vw[2], vw[3]);
        }
        *reinterpret_cast<uint4*>(d) = v;
      } else {
        *d = __float2bfloat16_rn(
            cell >= 0 && x < a.cs_x
                ? __bfloat162float(
                      a.in[((size_t)cell * a.L + l) * P + roff[yy] + x]) * *g
                : 0.f);
      }
    }
    __syncthreads();
    if (prefetch && l + 1 < l_end) fetch(l + 1);
    bf16* o = a.out + ((size_t)z * a.L + l) * P + (size_t)y0 * a.cs_x;
    for (int i = tid; i < npairs * segs; i += T) {
      const int seg = i / npairs, cp = i - seg * npairs;
      const bf16* col = A + (size_t)seg * RY * wp + 2 * cp;
      float s0[RY], s1[RY];
#pragma unroll
      for (int j = 0; j < RY; ++j) s0[j] = s1[j] = 0.f;
      if (NT) {
#pragma unroll
        for (int m = 0; m < RY + (NT ? NT : 1) - 1; ++m) {
          const float2 v = unpack_bf2(
              *reinterpret_cast<const uint32_t*>(col + (size_t)m * wp));
#pragma unroll
          for (int j = 0; j < RY; ++j) {
            const int k = m - j;
            if (k >= 0 && k < NT) {
              s0[j] = __fmaf_rn(a.taps.t[k], v.x, s0[j]);
              s1[j] = __fmaf_rn(a.taps.t[k], v.y, s1[j]);
            }
          }
        }
      } else {
        float tw[RY];   // tw[j] = tap[m - j], 0 outside the taps
#pragma unroll
        for (int j = 0; j < RY; ++j) tw[j] = 0.f;
        for (int m = 0; m < RY + n - 1; ++m) {
#pragma unroll
          for (int j = RY - 1; j > 0; --j) tw[j] = tw[j - 1];
          tw[0] = m < n ? tap[m] : 0.f;
          const float2 v = unpack_bf2(
              *reinterpret_cast<const uint32_t*>(col + (size_t)m * wp));
#pragma unroll
          for (int j = 0; j < RY; ++j) {
            s0[j] = __fmaf_rn(tw[j], v.x, s0[j]);
            s1[j] = __fmaf_rn(tw[j], v.y, s1[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < RY; ++j) {
        const int yy = seg * RY + j;
        if (yy < rows) {
          const float v[2] = {s0[j], s1[j]};
          store_outputs(o + (size_t)yy * a.cs_x + 2 * cp, v, 2,
                        a.cs_x - 2 * cp, a.cs_x % 2 == 0);
        }
      }
    }
  }
}

template <int NT>
__global__ void __launch_bounds__(PASS_MAX_THREADS)
blur_x_kernel(PassArgs a) {
  const int n = NT ? NT : a.taps.n, r = n / 2, halo = a.halo, wp = a.wp;
  const int Z = a.ny * a.nx, P = a.cs_y * a.cs_x, W = a.nx * a.cs_x;
  const int z = blockIdx.x, bimg = z / Z, zz = z % Z;
  const int iy = zz / a.nx, ix = zz % a.nx;
  const int y0 = blockIdx.y * a.ty, rows = min(a.ty, a.cs_y - y0);
  const int tid = threadIdx.x, T = blockDim.x;
  float* tap = reinterpret_cast<float*>(dyn_smem);
  bf16* Tt = reinterpret_cast<bf16*>(
      dyn_smem + align16((size_t)4 * ((n + 3) / 4 * 4)));   // [ty][wp]
  if (!NT)
    for (int i = tid; i < n; i += T) tap[i] = a.taps.t[i];
  const int units = wp / 8, xq = (a.cs_x + 7) / 8;
  // tile column t is cell column t - halo; a 16-byte word at a multiple of
  // 8 lies in one cell when cs_x is a multiple of 8
  const int d = halo - r;   // the first element a thread's outputs read
  const int l_end = min(a.L, (int)blockIdx.z * a.lg + a.lg);
  for (int l = blockIdx.z * a.lg; l < l_end; ++l) {
    if (l > (int)blockIdx.z * a.lg) __syncthreads();   // previous sums
    for (int i = tid; i < rows * units; i += T) {
      const int yy = i / units, t = (i - yy * units) * 8;
      const size_t row = (size_t)(y0 + yy) * a.cs_x;
      bf16* dst = Tt + (size_t)yy * wp + t;
      if (a.vec) {
        const int c = t - halo;
        const int dx = c < 0 ? -1 : (c >= a.cs_x ? 1 : 0), ix2 = ix + dx;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (ix2 >= 0 && ix2 < a.nx)
          v = *reinterpret_cast<const uint4*>(
              a.in + ((size_t)(bimg * Z + iy * a.nx + ix2) * a.L + l) * P +
              row + c - dx * a.cs_x);
        *reinterpret_cast<uint4*>(dst) = v;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int gx = ix * a.cs_x + t + e - halo;
          bf16 v = __float2bfloat16_rn(0.f);
          if (gx >= 0 && gx < W) {
            const int ix2 = gx / a.cs_x;
            v = a.in[((size_t)(bimg * Z + iy * a.nx + ix2) * a.L + l) * P +
                     row + gx - ix2 * a.cs_x];
          }
          dst[e] = v;
        }
      }
    }
    __syncthreads();
    bf16* o = a.out + ((size_t)z * a.L + l) * P + (size_t)y0 * a.cs_x;
    for (int i = tid; i < rows * xq; i += T) {
      const int yy = i / xq, x0 = (i - yy * xq) * 8;
      const uint4* src = reinterpret_cast<const uint4*>(
          Tt + (size_t)yy * wp + x0);
      float acc[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = 0.f;
      if (NT) {
        // value e' of the words is tap k of output j where e' = d + j + k
        constexpr int R = (NT ? NT : 1) / 2, DC = (8 - R % 8) % 8;
        constexpr int NW = (DC + (NT ? NT : 1) + 6) / 8 + 1;
#pragma unroll
        for (int q = 0; q < NW; ++q) {
          const uint4 u = src[q];
          const uint32_t uw[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float2 f2 = unpack_bf2(uw[e / 2]);
            const float v = e % 2 ? f2.y : f2.x;
            const int m = 8 * q + e - DC;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int k = m - j;
              if (k >= 0 && k < NT) acc[j] = __fmaf_rn(a.taps.t[k], v, acc[j]);
            }
          }
        }
      } else {
        float tw[8];   // tw[j] = tap[m - j], 0 outside the taps
#pragma unroll
        for (int j = 0; j < 8; ++j) tw[j] = 0.f;
        const int nw = (d + n + 6) / 8 + 1;
        for (int q = 0; q < nw; ++q) {
          const uint4 u = src[q];
          const uint32_t uw[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int m = 8 * q + e - d;
            if (m < 0 || m >= n + 7) continue;
            const float2 f2 = unpack_bf2(uw[e / 2]);
            const float v = e % 2 ? f2.y : f2.x;
#pragma unroll
            for (int j = 7; j > 0; --j) tw[j] = tw[j - 1];
            tw[0] = m < n ? tap[m] : 0.f;
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[j] = __fmaf_rn(tw[j], v, acc[j]);
          }
        }
      }
      store_outputs(o + (size_t)yy * a.cs_x + x0, acc, 8, a.cs_x - x0,
                    a.vec != 0);
    }
  }
}

// One pass of the two-pass blur, in the launch plan's geometry.
int launch_blur_pass(const bf16* in, const float* gn, int gn_per_image,
                     bf16* out, const float* taps, int ntaps, int B, int ny,
                     int nx, int cs_y, int cs_x, int L, int ty, int lg,
                     int threads, int smem, bool y_pass, cudaStream_t st) {
  const int r = ntaps / 2;
  if (!taps || ntaps < 1 || ntaps > MAX_YX_TAPS || ntaps % 2 == 0 ||
      B < 1 || ny < 1 || nx < 1 || L < 1 || cs_y < 1 || cs_x < 1 ||
      r > cs_y || r > cs_x || (y_pass && !gn))
    return ERR_ARGS;
  // the plan (pass_plan in kernels/crf_fused.py): strips of ty rows, lg
  // labels and `threads` threads a block, its shared memory as pass_layout
  // lays it out
  const PassLayout lay = pass_layout(ty, cs_x, ntaps, y_pass);
  if (ty < 1 || ty > cs_y || lg < 1 || lg > L || threads < 32 ||
      threads > PASS_MAX_THREADS || threads % 32 ||
      (size_t)smem != lay.total || smem > SMEM_MAX)
    return ERR_PLAN;
  PassArgs args;
  args.in = in; args.gn = gn; args.out = out;
  args.ny = ny; args.nx = nx; args.cs_y = cs_y; args.cs_x = cs_x; args.L = L;
  args.ty = ty; args.lg = lg; args.wp = lay.wp; args.halo = lay.halo;
  args.gn_per_image = gn_per_image;
  // 16-byte staging and stores where rows are whole words
  args.vec = cs_x % 8 == 0 && (uintptr_t)in % 16 == 0 &&
             (uintptr_t)out % 16 == 0 && (!y_pass || (uintptr_t)gn % 16 == 0);
  args.taps.n = ntaps;
  for (int i = 0; i < ntaps; ++i) args.taps.t[i] = taps[i];
  const void* fn =
      y_pass ? (ntaps == 41 ? (const void*)blur_y_kernel<41>
                            : (const void*)blur_y_kernel<0>)
             : (ntaps == 41 ? (const void*)blur_x_kernel<41>
                            : (const void*)blur_x_kernel<0>);
  cudaError_t e = set_smem(fn, smem);
  if (e != cudaSuccess) return e;
  void* kargs[] = {&args};
  return cudaLaunchKernel(fn,
                          dim3(B * ny * nx, (cs_y + ty - 1) / ty,
                               (L + lg - 1) / lg),
                          dim3(threads), kargs, smem, st);
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

template <int RE>
cudaError_t launch_step(const StepArgs& a, const StepTaps& t, int Z, int fused,
                        int smem, cudaStream_t st) {
  cudaError_t e;
  if (fused) {
    const dim3 blocks(Z, a.splits);
    const bool l21 = a.L == STEP_L21;
    const int threads = l21 ? STEP_THREADS_L21 : STEP_THREADS;
    const void* fn =
        a.unary ? (l21 ? (const void*)mf_step_fused_kernel<RE, true, STEP_L21>
                       : (const void*)mf_step_fused_kernel<RE, true, 0>)
                : (l21 ? (const void*)mf_step_fused_kernel<RE, false, STEP_L21>
                       : (const void*)mf_step_fused_kernel<RE, false, 0>);
    if ((e = set_smem(fn, smem)) != cudaSuccess) return e;
    if (a.unary && l21)
      mf_step_fused_kernel<RE, true, STEP_L21><<<blocks, threads, smem, st>>>(a, t);
    else if (a.unary)
      mf_step_fused_kernel<RE, true, 0><<<blocks, threads, smem, st>>>(a, t);
    else if (l21)
      mf_step_fused_kernel<RE, false, STEP_L21><<<blocks, threads, smem, st>>>(a, t);
    else
      mf_step_fused_kernel<RE, false, 0><<<blocks, threads, smem, st>>>(a, t);
    return cudaGetLastError();
  }
  if ((e = set_smem((const void*)grid_blur_li_kernel<RE>, smem)) !=
      cudaSuccess)
    return e;
  grid_blur_li_kernel<RE><<<dim3(Z, a.lp / STEP_LC), STEP_BLUR_THREADS, smem,
                            st>>>(a, t);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  // logits in registers up to STEP_LMAX labels (21 in an instantiation of
  // their own), else in shared memory
  const int mode = a.L == STEP_L21 ? STEP_L21 : a.L <= STEP_LMAX ? 0 : -1;
  const size_t psmem =
      mode >= 0 ? 0 : sizeof(float) * (size_t)a.L * STEP_PIX_THREADS;
  if (psmem > (size_t)SMEM_MAX) return (cudaError_t)ERR_SMEM;
  const void* fns[2][3] = {
      {(const void*)mf_step_pixel_kernel<false, STEP_L21>,
       (const void*)mf_step_pixel_kernel<false, 0>,
       (const void*)mf_step_pixel_kernel<false, -1>},
      {(const void*)mf_step_pixel_kernel<true, STEP_L21>,
       (const void*)mf_step_pixel_kernel<true, 0>,
       (const void*)mf_step_pixel_kernel<true, -1>}};
  const int u = a.unary ? 1 : 0, m = mode == STEP_L21 ? 0 : mode == 0 ? 1 : 2;
  if ((e = set_smem(fns[u][m], psmem)) != cudaSuccess) return e;
  const dim3 blocks(Z, (a.P + STEP_PIX_THREADS - 1) / STEP_PIX_THREADS);
  void* args[] = {const_cast<StepArgs*>(&a)};
  return cudaLaunchKernel(fns[u][m], blocks, dim3(STEP_PIX_THREADS), args,
                          psmem, st);
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
                     int L, int nc, float inv_step, int lg, int pc, int k,
                     int smem, void* stream) {
  if (Z <= 0 || P <= 0 || L <= 0 || nc <= 0 ||
      values_bf16 != out_bf16 || (rows != 3 && rows != ATTR_ROWS) ||
      (uintptr_t)out % 16)
    return ERR_ARGS;
  // the plan (splat_plan in kernels/crf_fused.py): lg labels a block, chunks
  // of pc pixels, pieces of at most k, its shared memory as laid out here
  if (lg < 1 || lg > L || pc < 4 || pc % 4 || nc > 1022 ||
      pc > SPLAT_MAX_PPT * SPLAT_THREADS || k != SPLAT_PIECE ||
      (size_t)smem != splat_layout(nc, lg, pc).total || smem > SMEM_MAX)
    return ERR_PLAN;
  SplatArgs a;
  a.rgb = rgb; a.vals = values; a.out = out;
  a.rows = rows; a.P = P; a.L = L; a.nc = nc; a.lg = lg; a.pc = pc;
  a.inv_step = inv_step;
  const dim3 grid(Z, (L + lg - 1) / lg);
  cudaStream_t st = (cudaStream_t)stream;
  const void* fn = values_bf16 ? (const void*)splat_kernel<bf16, bf16>
                               : (const void*)splat_kernel<float, float>;
  cudaError_t e = set_smem(fn, smem);
  if (e != cudaSuccess) return e;
  if (values_bf16)
    splat_kernel<bf16, bf16><<<grid, SPLAT_THREADS, smem, st>>>(a);
  else
    splat_kernel<float, float><<<grid, SPLAT_THREADS, smem, st>>>(a);
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
                      int nx, int cs_y, int cs_x, int L, int ty, int lg,
                      int threads, int smem, void* stream) {
  return launch_blur_pass((const bf16*)a, gn, gn_per_image, (bf16*)out,
                          taps, ntaps, B, ny, nx, cs_y, cs_x, L, ty, lg,
                          threads, smem, true, (cudaStream_t)stream);
}

int crf_blur_x_launch(const void* in, void* out, const float* taps,
                      int ntaps, int B, int ny, int nx, int cs_y, int cs_x,
                      int L, int ty, int lg, int threads, int smem,
                      void* stream) {
  return launch_blur_pass((const bf16*)in, nullptr, 0, (bf16*)out, taps,
                          ntaps, B, ny, nx, cs_y, cs_x, L, ty, lg, threads,
                          smem, false, (cudaStream_t)stream);
}

int crf_mf_step_launch(const float* attrs, const void* grid, void* scratch,
                       const void* fg, const void* q, void* out, void* out_sub,
                       const void* unary, const float* ctaps, int ntaps,
                       int Z, int P, int L, int nc, int stride, int cs_x,
                       int fused, int lb, int splits, int lp, int smem,
                       float inv_step,
                       float cg, float cb, float n_energy, float p_energy,
                       void* stream) {
  ColorTaps taps;
  if (!read_color_taps(ctaps, ntaps, &taps) || Z <= 0 || P <= 0 || L < 1 ||
      nc < 1 || stride < 1 ||
      (stride > 1 && (!out_sub || cs_x % stride || P % cs_x)))
    return ERR_ARGS;
  const int ncp = (nc + STEP_SEG - 1) / STEP_SEG * STEP_SEG;
  // the plan (step_plan in kernels/crf_fused.py): the fused kernel with lb
  // labels a blur round and `splits` blocks a cell, or the two kernels
  // with a scratch of lp labels a grid point; its shared memory as laid
  // out here
  if ((fused ? (lb < 1 || lb > L || L > STEP_LMAX || splits < 1 ||
                splits > 65535 ||
                (size_t)smem != step_fused_smem(nc, L, lb, ncp))
             : (lp != (L + STEP_LC - 1) / STEP_LC * STEP_LC || !scratch ||
                (uintptr_t)scratch % 16 ||
                (size_t)smem != step_blur_smem(nc, ncp))) ||
      smem > SMEM_MAX)
    return ERR_PLAN;
  const StepTaps t = step_taps(taps);
  StepArgs a;
  a.attrs = attrs; a.grid = (const bf16*)grid; a.scratch = (bf16*)scratch;
  a.fg = (const bf16*)fg; a.q = (const bf16*)q; a.out = (bf16*)out;
  a.out_sub = stride > 1 ? (bf16*)out_sub : nullptr;
  a.unary = (const bf16*)unary;
  a.P = P; a.L = L; a.nc = nc; a.stride = stride; a.cs_x = cs_x > 0 ? cs_x : P;
  a.lb = lb; a.ncp = ncp; a.lp = lp; a.splits = splits;
  a.inv_step = inv_step; a.cg = cg; a.cb = cb; a.n_energy = n_energy;
  a.p_energy = p_energy;
  cudaStream_t st = (cudaStream_t)stream;
  switch (t.re) {
    case 1: return launch_step<1>(a, t, Z, fused, smem, st);
    case 2: return launch_step<2>(a, t, Z, fused, smem, st);
    case 3: return launch_step<3>(a, t, Z, fused, smem, st);
    default: return ERR_ARGS;
  }
}

int crf_slice_launch(const float* rgb, const float* grid, float* out,
                     const float* ctaps, int ntaps, int Z, int P, int L,
                     int nc, float inv_step, int lg, int lb, int lgp,
                     int pad, int splits, int smem,
                     void* stream) {
  ColorTaps taps;
  if (!read_color_taps(ctaps, ntaps, &taps) || Z <= 0 || P <= 0 || L < 1 ||
      nc < 1 || (uintptr_t)grid % 4)
    return ERR_ARGS;
  // the plan (slice_plan in kernels/crf_fused.py): groups of lg labels
  // blurred lb a round, LGP-wide grid points, S padded or not, `splits`
  // blocks a (cell, group), its shared memory as slice_layout lays it out
  if (lg < 1 || lg > L || lg > SLICE_LG_MAX || lb < 1 || lb > lg ||
      lb > SLICE_LB ||
      lgp != slice_lgp(lg) || splits < 1 || splits > 65535 ||
      (size_t)smem != slice_layout(nc, L, lg, lb, pad).total ||
      smem > SMEM_MAX)
    return ERR_PLAN;
  const SliceLayout lay = slice_layout(nc, L, lg, lb, pad);
  const StepTaps t = step_taps(taps);
  SliceArgs a;
  a.rgb = rgb; a.grid = grid; a.out = out;
  a.P = P; a.L = L; a.nc = nc; a.lg = lg; a.lb = lb; a.splits = splits;
  a.ncp = (nc + STEP_SEG - 1) / STEP_SEG * STEP_SEG;
  a.xp = lay.xp; a.prow = lay.prow; a.spitch = lay.spitch;
  a.s_off = (int)lay.s_off; a.tb_off = (int)lay.tb_off;
  a.inv_step = inv_step;
#define SLICE_FNS(PAD)                                                        \
  {{(const void*)slice_fused_kernel<1, 1, PAD>,                                \
    (const void*)slice_fused_kernel<1, 2, PAD>,                                \
    (const void*)slice_fused_kernel<1, 4, PAD>,                                \
    (const void*)slice_fused_kernel<1, 8, PAD>},                               \
   {(const void*)slice_fused_kernel<2, 1, PAD>,                                \
    (const void*)slice_fused_kernel<2, 2, PAD>,                                \
    (const void*)slice_fused_kernel<2, 4, PAD>,                                \
    (const void*)slice_fused_kernel<2, 8, PAD>},                               \
   {(const void*)slice_fused_kernel<3, 1, PAD>,                                \
    (const void*)slice_fused_kernel<3, 2, PAD>,                                \
    (const void*)slice_fused_kernel<3, 4, PAD>,                                \
    (const void*)slice_fused_kernel<3, 8, PAD>}}
  const void* fns[2][3][4] = {SLICE_FNS(false), SLICE_FNS(true)};
#undef SLICE_FNS
  if (t.re < 1 || t.re > 3) return ERR_ARGS;
  const void* fn = fns[pad ? 1 : 0][t.re - 1]
                      [lgp == 1 ? 0 : lgp == 2 ? 1 : lgp == 4 ? 2 : 3];
  cudaError_t e = set_smem(fn, smem);
  if (e != cudaSuccess) return e;
  void* args[] = {&a, const_cast<StepTaps*>(&t)};
  return cudaLaunchKernel(fn, dim3(Z, (L + lg - 1) / lg, splits),
                          dim3(SLICE_THREADS), args, smem,
                          (cudaStream_t)stream);
}

}  // extern "C"
