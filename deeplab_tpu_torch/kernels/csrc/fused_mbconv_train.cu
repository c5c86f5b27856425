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
// The halo phases F2 and B34 stay far above that bound (about 12x, PERF.md),
// held there by shared memory rather than by device memory: each chunk of
// Ce re-reads the tile's x box through ldmatrix for the expand (the TPU
// design recomputes the expand rather than save a Ce-wide tensor, and so
// does this one), and the taps read aq and dd nine times a value, phases
// that run between barriers with one block of 16 warps per SM (measured
// per chunk: taps and expand about even at rate 4, the taps two thirds of
// it at rates 1 and 2).
//
// Design.  The TPU phases walk 8-row planes with a VMEM-resident accumulator
// carried across a sequential grid; here blocks run in any order, so:
//   - the halo phases F2 and B34 take the toolbox of fused_mbconv.cu.  A
//     launch plan in plain Python (train_plan in kernels/fused_mbconv_train.py)
//     picks the output tile (16x16, 8x16 or 8x8), the chunk of Ce (32 or 16)
//     and the ring depth (2 or 3) per shape and phase; the launcher refuses a
//     plan whose shared memory lay_halo does not reproduce.  A block of 16
//     warps per (tile, image) expands only the tile's in-image halo box,
//     packed into whole m-tiles of 16 pixels, so the zero padding costs no
//     tensor-core work and dd is read only inside the image.  Expanded
//     pixels per output pixel on a 64x64 map (train_halo): rate 1 1.25x at
//     16x16; rate 2 1.44x at 16x16; rate 4 1.89x at 16x16 and 2.58x at 8x16
//     (fixed 8x8 tiles over full boxes would expand 1.56x, 2.25x, 4.00x).
//     The rate-4 blocks (Cin = 160) fit F2 at 16x16 and B34 at 8x16, both in
//     chunks of 16;
//   - every copy is a 16-byte cp.async (8 bytes for dq's rows): the x tile
//     once per block, each chunk's w1 slice (contiguous runs of (Cin, Ce),
//     read k-major by ldmatrix.trans, no repacking), taps and per-channel
//     vectors through the ring, chunk c + 1's dd rows while chunk c + 1's
//     expand runs; the thread that copies a dd quad converts it (dd =
//     a2*ddh + m0 + m1*dq), so that needs no barrier of its own;
//   - the expand runs on mma.sync m16n8k16 fed by ldmatrix from XOR-swizzled
//     tiles (the x tile, the w1 stages);
//   - aq is held as bf16 (relu6 of a bf16 value is one), dd as f32, in
//     unpadded rows: a warp's taps read neighbouring box rows, which then
//     fall in disjoint banks.  A tap table built once per block holds each
//     tap's row offset (the zero row outside the image), two 16-byte loads
//     a pixel.  F2 takes four channels a thread, B34 (eleven sums a
//     channel) two; the tile's sums are added in registers, across the
//     lanes of a warp by fixed shuffles and across the warps in warp order:
//     one partial per (tile, channel) and a second pass, no atomics;
//   - two barriers a chunk: [taps of chunk c] [their sums into the partials,
//     the expand of chunk c + 1 (B34: with its dd copied and converted),
//     chunk c + S's stage copied];
//   - B34 writes dvl = q(a1*dv1) (pixels x Ce, bf16) and leaves its two
//     products to GEMM kernels that read dvl, x and w1 as they lie, with
//     ldmatrix (.trans where the operand is pixel-major) from cp.async rings:
//     dx = dvl @ w1^T (128 pixels a block; holding dx's accumulator through
//     the taps cost the halo kernel its registers) and dW1^T = dvl^T x (128
//     channels a block over pixel splits), each warp two m-tiles and half
//     of Cin;
//   - F1 is bound by operations (2 P Cin Ce on the tensor cores against P Cin
//     bytes of x).  Its plan (train_plan "f1") gives a block of one, two or
//     four warpgroups a chunk of 64, 128 or 256 expanded channels and
//     every splits-th 64-pixel tile, the splits sized to one wave.  The
//     chunk's w1 slice is transposed once into K-major rows (64-byte
//     swizzle) and stays in shared memory: w1 is read once a block, not
//     once per 64 pixels.  x tiles come through a cp.async ring of 4; the
//     product runs on wgmma
//     (m64n64k16, both operands from shared memory); the sums of q(acc) and
//     q(acc)^2 come from the accumulator registers (a thread's rows, the
//     lanes by fixed shuffles, the warps in warp order), with no f32 tile;
//   - F3 is bound by bytes: dq (P x Ce, bf16) is its largest stream.  Its
//     plan (train_plan "f3") gives a block 128 pixels and, on two
//     warpgroups, up to 160 columns of Cout, or on four up to 320, Ce in
//     chunks of 64 through a ring.  dq's rows and those of w2^T come in by
//     16-byte cp.async, K-major with wgmma's 128-byte swizzle (w2 reaches
//     the kernel as the transpose of a contiguous (Cout, Ce) tensor, as the
//     block keeps it; the wrapper copies another layout once); the product
//     runs on wgmma (m64nNk16, N up to 160),
//     issued before, and waited for after, the thread that copied a dq
//     chunk of the next chunk applies relu6(q(q(dq*a2) + c2)) to it in
//     place: one barrier a chunk.  A block reads w2 from L2 once per 128
//     pixels (the first port: once per 64; mma.sync from ldmatrix ran the
//     product at about 145 TFLOP/s, PERF.md);
//   - B2 is bound by bytes: its largest stream is ddh, P x Ce f32 written
//     (151 MB at the 128x128 block, B=16), then dq read and gyq = q(gy)
//     (P x Cout bf16, written once by gy_kernel) read once per chunk of
//     Ce.  Its plan (train_plan "b2") gives each block of 16 warps a chunk
//     of CEB = 64 or 128 expanded channels (the widest whose dW2, CEB x
//     Cout f32, fits the warps' registers: gyq read Ce / CEB times, not
//     Ce / 32) and every splits-th group of 64 pixels, the splits sized to
//     one wave.  Each group's gyq and dq rows come in by 16-byte cp.async
//     through a ring of 2 or 3 stages while earlier groups compute; ddh's
//     product (gyq @ w2^T, w2's rows held n-major) and dW2's (q(b)^T gyq,
//     both operands read with ldmatrix.trans) run on mma.sync from
//     swizzle-free padded rows (odd counts of 16-byte units); ddh leaves
//     through a staging tile in 16-byte rows; T1/T2 stay in registers,
//     summed across lanes by fixed shuffles and across warps in warp order;
//   - every sum over pixels is written as per-block partials and reduced by a
//     second pass in a fixed order: no float atomics, so results repeat bit for
//     bit from run to run.
// B2 saves ddh (f32) so that B34 needs neither g nor y_raw nor a second
// product with w2 on its halo.  Built with -fmad=false: the elementwise
// chains round where the plain versions round.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;
using mbconv::cp16;
using mbconv::cp8;
using mbconv::cp_commit;
using mbconv::cp_wait;
using mbconv::gmma_commit;
using mbconv::gmma_desc;
using mbconv::gmma_fence;
using mbconv::gmma_m64;
using mbconv::gmma_m64n64;
using mbconv::gmma_wait;
using mbconv::ldm_x4;
using mbconv::ldm_x4_t;
using mbconv::mma16816;
using mbconv::pin;
using mbconv::qbf;
using mbconv::relu6;
using mbconv::swz;
using mbconv::w1_swz;
using mbconv::xs_chunk;

constexpr int GP = 64;                       // pixels a group: F1's tiles, B2's and
                                             // dW1^T's walks
constexpr int NWARPS = 8, NTHREADS = 32 * NWARPS;
constexpr size_t SMEM_MAX = 232448;
constexpr int RED_Y = 8;                     // row groups of the reduction
// F2 and B34 (train_plan): 16 warps a block; dW1^T: 8 warps, 128 channels of
// Ce and 64 pixels a step, a ring of 3
constexpr int HALO_WARPS = 16, HALO_THREADS = 32 * HALO_WARPS;
constexpr int WG_THREADS = 256, WG_M = 128, WG_GP = 64, WG_STAGES = 3;
// dx = dvl @ w1^T (B34's second kernel): 8 warps, 128 pixels a block, Ce in
// chunks of 64 through a ring of 3
constexpr int DX_THREADS = 256, DX_M = 128, DX_K = 64, DX_STAGES = 3;
// F1: warpgroups of 64 expanded channels, k-pieces of 32 (64-byte rows), a
// ring of 4 x tiles
constexpr int F1_KP = 32, F1_STAGES = 4;

enum Phase { F1 = 0, F2 = 1, F3 = 2, B2 = 3, B34 = 4 };

enum {
  ERR_ARGS = 100001,  // an argument the kernel does not take
  ERR_PLAN = 100002,  // a launch plan this file does not agree with
};

struct Args {
  const bf16 *x, *w1, *w2, *dq, *g, *y;
  const float *a1, *c1, *wdw, *a2, *c2, *mu1, *rstd1, *mu2, *rstd2;
  const float *gA3, *k0, *k1, *m0, *m1, *ddh;
  bf16 *dq_out, *y_out, *dxp, *dvl, *gyq;
  float *ddh_out, *part, *part2;
  int B, H, W, Cin, Ce, Cout, rate;
  long long P;
  int n_groups, n_chunks, splits, tiles_x, tiles_y, n_tiles;
  int cin_p, kp, cout_k;
  // the plan and the geometry it implies
  int th, tw, twl, ck, stages, nt, smem, warps;
  int rows, xt_ld, xt_swz;
};

__host__ __device__ inline int a16(int n) { return (n + 15) & ~15; }
__device__ __forceinline__ bf16 bzero() { return __float2bfloat16(0.f); }

__device__ __forceinline__ float2 bf2f(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}
__device__ __forceinline__ uint32_t f2bf(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// this thread's cp.async groups of a ring of S: all but the newest S - 2
// landed
__device__ __forceinline__ void wait_ring(int S) {
  if (S >= 4) cp_wait<2>(); else if (S == 3) cp_wait<1>(); else cp_wait<0>();
}

// ---------------------------------------------------------------- F1 ----
// The plan (train_plan "f1"): a block of WGS (1, 2 or 4) warpgroups per
// (chunk of ck = 64 WGS expanded channels, pixel split).  Its shared memory (lay_f1;
// f1_smem in kernels/fused_mbconv_train.py), every part a whole number of
// KB: the chunk's w1 slice, transposed once into K-major rows w1t[n][k]
// (pieces of 32 k, 64-byte rows swizzled for wgmma), zero past Cin and Ce;
// a ring of F1_STAGES 64-pixel x tiles in the same layout; the warps' sums.
struct LF1 { int w1t, ring, stage_bytes, red, total; };
__host__ __device__ inline LF1 lay_f1(const Args& a) {
  LF1 l;
  l.w1t = 0;
  l.ring = 2 * a.ck * a.kp;
  l.stage_bytes = 2 * GP * a.kp;
  l.red = l.ring + F1_STAGES * l.stage_bytes;
  l.total = l.red + 4 * 2 * 64 * (a.ck / 16);  // [warps][2][64] f32
  return l;
}

// Grid (Ce chunks, pixel splits).  The split walks its 64-pixel tiles
// (every splits-th: the chunks' blocks of a split read each x tile from L2
// at about the same time) through the ring, one barrier a tile.  Each
// warpgroup multiplies the tile by its 64 channels with wgmma m64n64k16,
// both operands from shared memory, into one of two accumulators; while
// it runs, the previous tile's q(acc) and q(acc)^2 go into per-column sums
// in registers (a thread's columns 8j + 2t, + 1 over its rows g, g + 8;
// zero rows past P and zero channels past Cin add nothing); at the end
// across the 8 rows of a warp by fixed shuffles and across the 4 warps of
// a warpgroup in warp order: one partial per (split, channel).
template <int WGS>
__global__ void __launch_bounds__(128 * WGS) f1_kernel(const Args a) {
  // the wgmma operands' swizzle wants 1024-byte alignment (the other
  // kernels' arrays ask for 16)
  extern __shared__ __align__(1024) unsigned char smem1k[];
  unsigned char* smem = smem1k;
  constexpr int NB = 64 * WGS, THREADS = 128 * WGS;
  const LF1 L = lay_f1(a);
  bf16* w1t = reinterpret_cast<bf16*>(smem + L.w1t);
  float* red = reinterpret_cast<float*>(smem + L.red);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, t = lane & 3;
  const int c0 = blockIdx.x * NB, split = blockIdx.y;
  constexpr int S = F1_STAGES;
  const int Ce = a.Ce, Cin = a.Cin, KP = a.kp, vq = KP / 8;
  const int n_mine = (a.n_groups - split + a.splits - 1) / a.splits;

  // tile i's x rows: 16-byte chunk c of row r's piece p (input channels
  // 32p + 8c ..) at chunk c ^ swz<32>(r); four threads a row's 64 bytes, a
  // warp 8 rows of one piece (512 contiguous bytes of shared memory)
  auto issue = [&](int i) {
    if (i >= n_mine) return;
    const long long p0 = (long long)(split + (long long)i * a.splits) * GP;
    bf16* xs = reinterpret_cast<bf16*>(smem + L.ring + (i % S) * L.stage_bytes);
    for (int e = tid; e < GP * vq; e += THREADS) {
      const int c = e & 3, r = (e >> 2) & (GP - 1), q = 4 * (e >> 8) + c;
      const bool in = p0 + r < a.P && 8 * q < Cin;
      cp16(xs + (q >> 2) * (GP * F1_KP) + r * F1_KP + 8 * (c ^ swz<F1_KP>(r)),
           in ? (const void*)(a.x + (p0 + r) * Cin + 8 * q) : (const void*)a.x,
           in ? 16 : 0);
    }
  };
  for (int i = 0; i < S - 2; ++i) {
    issue(i);
    cp_commit();
  }
  // the chunk's w1 slice, once: rows k, k + 1 of 8 channels a thread, into
  // w1t[n][k] as pairs (k, k + 1) of row n
  for (int e = tid; e < (KP / 2) * (NB / 8); e += THREADS) {
    const int kh = e % (KP / 2), q = e / (KP / 2), k = 2 * kh, col = c0 + 8 * q;
    uint4 u0 = make_uint4(0, 0, 0, 0), u1 = u0;
    if (col < Ce && k < Cin) {  // Cin is even: row k + 1 lies in w1 too
      u0 = *reinterpret_cast<const uint4*>(a.w1 + size_t(k) * Ce + col);
      u1 = *reinterpret_cast<const uint4*>(a.w1 + size_t(k + 1) * Ce + col);
    }
    const bf16* r0 = reinterpret_cast<const bf16*>(&u0);
    const bf16* r1 = reinterpret_cast<const bf16*>(&u1);
    bf16* piece = w1t + (k >> 5) * (NB * F1_KP);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = 8 * q + j;
      __nv_bfloat162 v;
      v.x = r0[j];
      v.y = r1[j];
      *reinterpret_cast<__nv_bfloat162*>(
          piece + n * F1_KP + 8 * (((k & 31) >> 3) ^ swz<F1_KP>(n)) + (k & 7)) = v;
    }
  }

  float s[16], ss[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] = ss[i] = 0.f;
  const bf16* wb = w1t + wg * 64 * F1_KP;  // this warpgroup's 64 rows of each piece
  // q(acc) and q(acc)^2 into the sums: d[4j + 2h + e] is row 16 (warp % 4)
  // + g + 8h, column 8j + 2t + e
  auto sums = [&](const float (&d)[32]) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 v = bf2f(f2bf(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]));
        s[2 * j] += v.x;
        s[2 * j + 1] += v.y;
        ss[2 * j] += v.x * v.x;
        ss[2 * j + 1] += v.y * v.y;
      }
  };
  float d0[32], d1[32];
  // tile i: its product into `dc` by wgmma, issued; then tile i - 1's sums
  // from `dp` once its product is done (wgmma.wait_group 1) beside it
  auto step = [&](float (&dc)[32], float (&dp)[32], int i) {
    cp_wait<S - 3>();  // tile i landed
    // the landed copies and w1t's stores, seen by wgmma's reads of shared
    // memory
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // ... for every thread; tile i - 2's products done
    issue(i + S - 2);  // into the stage tile i - 2 left
    cp_commit();
    const bf16* xs = reinterpret_cast<const bf16*>(smem + L.ring + (i % S) * L.stage_bytes);
#pragma unroll
    for (int q = 0; q < 32; ++q) dc[q] = 0.f;
    pin(dc);
    gmma_fence();
    for (int kk = 0; kk < KP; kk += 16) {
      const int pc = kk >> 5, off = kk & 31;
      gmma_m64n64(dc, gmma_desc(xs + pc * (GP * F1_KP) + off, F1_KP),
                  gmma_desc(wb + pc * (NB * F1_KP) + off, F1_KP));
    }
    gmma_commit();
    if (i > 0) {
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      pin(dp);
      sums(dp);
    }
  };
  for (int i = 0; i < n_mine; i += 2) {
    step(d0, d1, i);
    if (i + 1 < n_mine) step(d1, d0, i + 1);
  }
  gmma_wait();
  if (n_mine > 0) {
    if (n_mine & 1) {
      pin(d0);
      sums(d0);
    } else {
      pin(d1);
      sums(d1);
    }
  }
  cp_wait<0>();
  // over the warp's 8 row groups g by fixed shuffles; lanes 0-3 keep them
#pragma unroll
  for (int i = 0; i < 16; ++i) {
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      s[i] += __shfl_xor_sync(0xffffffffu, s[i], o);
      ss[i] += __shfl_xor_sync(0xffffffffu, ss[i], o);
    }
  }
  if (lane < 4)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int col = 8 * (i >> 1) + 2 * t + (i & 1);
      red[(warp * 2 + 0) * 64 + col] = s[i];
      red[(warp * 2 + 1) * 64 + col] = ss[i];
    }
  __syncthreads();
  // over the warpgroup's 4 warps in warp order
  for (int e = tid; e < 2 * NB; e += THREADS) {
    const int w = e / NB, c = e % NB, g4 = c >> 6;
    float v = 0.f;
#pragma unroll
    for (int m = 0; m < 4; ++m) v += red[((g4 * 4 + m) * 2 + w) * 64 + (c & 63)];
    if (c0 + c < Ce) a.part[(long long)split * 2 * Ce + w * Ce + c0 + c] = v;
  }
}

// ---------------------------------------------------------------- F3 ----
// The plan (train_plan "f3"): a block of 2 x CW warpgroups per (F3_PM = 128
// pixels, split of Cout into NBLK = CW N columns): warpgroup w takes the 64
// pixels w % 2 and the N columns w / 2; so at CW = 1 two warpgroups share
// the columns, and at CW = 2 four warpgroups take both halves of each.  Ce
// runs in chunks of 64.  Its shared memory (lay_f3; f3_smem in
// kernels/fused_mbconv_train.py): a2 and c2 for every chunk (zero past Ce),
// f32 and bf16, then `stages` ring buffers of one chunk: dq's rows (F3_PM x
// 64) and w2^T's rows (NBLK x 64), both K-major with wgmma's 128-byte
// swizzle.
constexpr int F3_PM = 128, F3_CK = 64;
struct LF3 { int vec, ring, s_b, stage_bytes, total; };
__host__ __device__ inline int a1k(int n) { return (n + 1023) & ~1023; }
__host__ __device__ inline LF3 lay_f3(const Args& a) {
  LF3 l;
  const int nblk = 8 * a.nt * a.tw;
  l.vec = 0;
  l.ring = a1k((4 + 2) * 2 * a.n_chunks * F3_CK);  // f32, then bf16
  l.s_b = 2 * F3_PM * F3_CK;
  l.stage_bytes = l.s_b + 2 * nblk * F3_CK;
  l.total = l.ring + a.stages * l.stage_bytes;
  return l;
}

// 1-D grid of (pixel tile, Cout split), the splits of a tile adjacent so
// that they read its dq rows from L2.  Per chunk, one barrier: barrier
// [chunk c + S - 1's copies issued into the stage chunk c - 1 left; each
// warpgroup's product of chunk c by wgmma m64nNk16, issued; beside it,
// this thread's copies of chunk c + 1 landed and relu6(q(q(dq*a2) + c2))
// applied to them in place, once per element; the product waited for].
// y = q(acc), rounded once.
// (Two-warpgroup blocks of the narrower widths keep to 128 registers: two
// blocks an SM; four warpgroups, to 128: one.)
template <int N, int CW>
__global__ void __launch_bounds__(CW * 256, CW == 1 && N <= 96 ? 2 : 1)
    f3_kernel(const Args a) {
  extern __shared__ __align__(1024) unsigned char smem1k[];
  unsigned char* smem = smem1k;
  constexpr int PM = F3_PM, CK = F3_CK, NBLK = CW * N, Q = CK / 8;
  constexpr int THREADS = CW * 256;
  constexpr int PER = PM * Q / THREADS;  // dq chunks a thread copies
  const LF3 L = lay_f3(a);
  const int nch = a.n_chunks, VC = nch * CK;
  float* vec = reinterpret_cast<float*>(smem + L.vec);
  bf16* vecb = reinterpret_cast<bf16*>(vec + 2 * VC);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wg = warp >> 2;
  const int split = blockIdx.x % a.splits;
  const long long p0 = (long long)(blockIdx.x / a.splits) * PM;
  const int n0 = split * NBLK, Ce = a.Ce, Cout = a.Cout, S = a.stages;
  bool exact = true;  // a2, c2 hold bf16 values (block_train's affine)
  for (int i = tid; i < 2 * VC; i += THREADS) {
    const int c = i < VC ? i : i - VC;
    const float v = c < Ce ? (i < VC ? a.a2 : a.c2)[c] : 0.f;
    vec[i] = v;
    vecb[i] = __float2bfloat16(v);
    exact = exact && qbf(v) == v;
  }
  // then b = relu6(q(q(dq*a2) + c2)) in bf16x2 arithmetic: the product of
  // two bf16 values and the sum of two are exact in f32, so one bf16
  // rounding each is what the f32 chain rounds
  exact = __syncthreads_and(exact);
  auto stage = [&](int c) { return smem + L.ring + (c % S) * L.stage_bytes; };
  // this thread's dq chunks, once: chunk q of row r, its source at chunk 0
  // (null past P) and its place in a stage
  const bf16* dsrc[PER];
  int doff[PER], dq8[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int e = tid + k * THREADS, r = e / Q, q = e % Q;
    dsrc[k] = p0 + r < a.P ? a.dq + (p0 + r) * Ce + 8 * q : nullptr;
    doff[k] = r * CK + 8 * (q ^ swz<CK>(r));
    dq8[k] = 8 * q;
  }
  // chunk c's dq rows and w2^T rows (w2t: Cout x Ce), zero past P, Ce and
  // Cout; 16-byte chunk q of row r at q ^ swz<64>(r)
  auto issue = [&](int c) {
    if (c >= nch) return;
    unsigned char* st = stage(c);
    bf16* ds = reinterpret_cast<bf16*>(st);
    bf16* ws = reinterpret_cast<bf16*>(st + L.s_b);
    const int k0 = c * CK;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const bool in = dsrc[k] != nullptr && k0 + dq8[k] < Ce;
      cp16(ds + doff[k], in ? (const void*)(dsrc[k] + k0) : (const void*)a.dq,
           in ? 16 : 0);
    }
    for (int e = tid; e < NBLK * Q; e += THREADS) {
      const int n = e / Q, q = e % Q;
      const bool in = n0 + n < Cout && k0 + 8 * q < Ce;
      cp16(ws + n * CK + 8 * (q ^ swz<CK>(n)),
           in ? (const void*)(a.w2 + size_t(n0 + n) * Ce + k0 + 8 * q) : (const void*)a.w2,
           in ? 16 : 0);
    }
  };
  // b = relu6(q(q(dq*a2) + c2)) on this thread's own dq chunks of chunk c
  // (zero past Ce, where a2 and c2 are zero)
  auto prologue = [&](int c) {
    bf16* ds = reinterpret_cast<bf16*>(stage(c));
    const int k0 = c * CK;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      uint4* p = reinterpret_cast<uint4*>(ds + doff[k]);
      uint4 u = *p;
      uint32_t* w = reinterpret_cast<uint32_t*>(&u);
      if (exact) {
        const uint4 a8 = *reinterpret_cast<const uint4*>(vecb + k0 + dq8[k]);
        const uint4 c8 = *reinterpret_cast<const uint4*>(vecb + VC + k0 + dq8[k]);
        const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a8);
        const __nv_bfloat162* pc = reinterpret_cast<const __nv_bfloat162*>(&c8);
        const __nv_bfloat162 zero = __float2bfloat162_rn(0.f);
        const __nv_bfloat162 six = __float2bfloat162_rn(6.f);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          __nv_bfloat162 d = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
          d = __hmax2(__hmin2(__hadd2(__hmul2(d, pa[i]), pc[i]), six), zero);
          w[i] = *reinterpret_cast<const uint32_t*>(&d);
        }
      } else {
        const float* pa = vec + k0 + dq8[k];
        const float* pc = pa + VC;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 d = bf2f(w[i]);
          w[i] = f2bf(relu6(qbf(qbf(d.x * pa[2 * i]) + pc[2 * i])),
                      relu6(qbf(qbf(d.y * pa[2 * i + 1]) + pc[2 * i + 1])));
        }
      }
      *p = u;
    }
  };

  for (int c = 0; c < S - 1; ++c) {
    issue(c);
    cp_commit();
  }
  __syncthreads();  // the vectors
  // this warpgroup's rows of A and of B (w2^T) in each stage
  const int arow = 64 * (wg % 2), bcol = N * (wg / 2);
  const bool live = n0 + bcol < Cout;  // its columns reach into Cout
  float d[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  wait_ring(S);  // this thread's copies of chunk 0 landed
  prologue(0);
  for (int c = 0; c < nch; ++c) {
    // the prologue's stores and the landed copies, seen by wgmma's reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // chunk c ready; chunk c - 1's products done, its stage free
    issue(c + S - 1);
    cp_commit();
    if (live) {
      const bf16* As = reinterpret_cast<const bf16*>(stage(c)) + arow * CK;
      const bf16* Bs = reinterpret_cast<const bf16*>(stage(c) + L.s_b) + bcol * CK;
      pin(d);
      gmma_fence();
#pragma unroll
      for (int kk = 0; kk < CK; kk += 16)
        gmma_m64<N>(d, gmma_desc(As + kk, CK), gmma_desc(Bs + kk, CK));
      gmma_commit();
    }
    // chunk c + 1's prologue beside chunk c's products (no one reads its
    // stage before the next barrier)
    if (c + 1 < nch) {
      wait_ring(S);
      prologue(c + 1);
    }
    if (live) {
      gmma_wait();
      pin(d);
    }
  }
  cp_wait<0>();
  // d[4j + 2h + e]: row 16 (warp % 4) + g + 8h, column 8j + 2t + e
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = n0 + bcol + 8 * j + 2 * t;
    if (col >= Cout) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = p0 + arow + 16 * (warp & 3) + g + 8 * h;
      if (row < a.P)
        *reinterpret_cast<uint32_t*>(a.y_out + row * Cout + col) =
            f2bf(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
    }
  }
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

// B2's plan (train_plan "b2"): a block of 16 warps per (chunk of CEB
// expanded channels, pixel split), walking its split's 64-pixel groups
// (every splits-th) with the chunk's dW2 (CEB x Cout) in registers.  Its
// shared memory (lay_b2; b2_smem in kernels/fused_mbconv_train.py):
// the chunk's w2 rows, n-major with rows of Cout padded to 16 plus 8
// (an odd count of 16-byte units: ldmatrix rows in distinct banks); the
// chunk's a2, c2, mu2, rstd2; the group's ddh staging (f32) and q(b)
// (bf16) tiles; the warps' T1/T2 sums; then `stages` ring buffers of one
// group's gyq and dq rows.
constexpr int B2_GP = 64, B2_WARPS = 16, B2_THREADS = 32 * B2_WARPS;
static_assert(B2_THREADS == 8 * B2_GP, "gyq's copy takes 8 threads a row");

struct LB2 {
  int w2c, vec, stg, bq, red, stage, s_dq, stage_bytes, total;
  int gld, dld, sld;  // row strides (elements) of gyq and w2, dq and q(b), ddh
};

__host__ __device__ inline LB2 lay_b2(const Args& a) {
  LB2 l;
  const int ceb = a.ck;
  l.gld = a.cout_k + 8;
  l.dld = ceb + 8;
  l.sld = ceb + 8;
  int o = 0;
  l.w2c = o; o += a16(2 * ceb * l.gld);
  l.vec = o; o += a16(4 * 4 * ceb);
  l.stg = o; o += a16(4 * B2_GP * l.sld);
  l.bq = o;  o += a16(2 * B2_GP * l.dld);
  l.red = o; o += a16(4 * 4 * 2 * ceb);
  l.stage = o;
  l.s_dq = a16(2 * B2_GP * l.gld);
  l.stage_bytes = l.s_dq + a16(2 * B2_GP * l.dld);
  l.total = o + a.stages * l.stage_bytes;
  return l;
}

// grid (Ce chunks, pixel splits), 16 warps a block.  ddh = gyq @ w2^T: each
// warp one pixel m-tile x a quarter of the chunk (NTD n-tiles); dW2 +=
// q(b)^T gyq: each warp one channel m-tile x NT2 n-tiles of Cout.  Per
// group, two barriers: [ddh's product; mask, T sums, ddh and q(b) into
// shared memory] [dW2's product; ddh's rows out in 16-byte stores; the
// ring copy of group i + S - 1].
template <int CEB, int NT2>
__global__ void __launch_bounds__(B2_THREADS, 1) b2_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NTD = CEB / 32;
  constexpr int WM2 = CEB / 16;
  const LB2 L = lay_b2(a);
  bf16* w2c = reinterpret_cast<bf16*>(smem + L.w2c);
  float* vec = reinterpret_cast<float*>(smem + L.vec);  // a2, c2, mu2, rstd2
  float* stg = reinterpret_cast<float*>(smem + L.stg);
  bf16* bq = reinterpret_cast<bf16*>(smem + L.bq);
  float* red = reinterpret_cast<float*>(smem + L.red);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int c0 = blockIdx.x * CEB, split = blockIdx.y;
  const int Ce = a.Ce, Cout = a.Cout, S = a.stages, gv = a.cout_k / 8;
  const int GLD = L.gld, DLD = L.dld, SLD = L.sld, n_out = Cout / 8;
  const int n_mine =
      split < a.n_groups ? (a.n_groups - split + a.splits - 1) / a.splits : 0;

  // the chunks' blocks of a split walk its groups in the same order, so
  // that they find each group's gyq rows in L2
  auto group_p0 = [&](int i) {
    return (long long)(split + (long long)i * a.splits) * B2_GP;
  };
  // group i's gyq rows (zero past P and Cout) and dq rows (zero past P, Ce)
  auto issue = [&](int i) {
    if (i >= n_mine) return;
    const long long p0 = group_p0(i);
    unsigned char* st = smem + L.stage + (i % S) * L.stage_bytes;
    bf16* gs = reinterpret_cast<bf16*>(st);
    bf16* ds = reinterpret_cast<bf16*>(st + L.s_dq);
    // 8 threads a row (512 threads, 64 rows): no division
    {
      const int p = tid >> 3;
      for (int q = tid & 7; q < gv; q += 8) {
        const bool in = p0 + p < a.P && 8 * q < Cout;
        cp16(gs + p * GLD + 8 * q,
             in ? (const void*)(a.gyq + (p0 + p) * Cout + 8 * q) : (const void*)a.gyq,
             in ? 16 : 0);
      }
    }
    for (int v = tid; v < B2_GP * (CEB / 8); v += B2_THREADS) {
      const int p = v / (CEB / 8), q = v % (CEB / 8);
      const bool in = p0 + p < a.P && c0 + 8 * q < Ce;
      cp16(ds + p * DLD + 8 * q,
           in ? (const void*)(a.dq + (p0 + p) * Ce + c0 + 8 * q) : (const void*)a.dq,
           in ? 16 : 0);
    }
  };

  // the chunk's w2 rows (with group 0's copies) and vectors
  for (int v = tid; v < CEB * gv; v += B2_THREADS) {
    const int c = v / gv, q = v % gv;
    const bool in = c0 + c < Ce && 8 * q < Cout;
    cp16(w2c + c * GLD + 8 * q,
         in ? (const void*)(a.w2 + (size_t)(c0 + c) * Cout + 8 * q) : (const void*)a.w2,
         in ? 16 : 0);
  }
  for (int i = tid; i < 4 * CEB; i += B2_THREADS) {
    const int which = i / CEB, c = i % CEB;
    const float* src = which == 0 ? a.a2 : which == 1 ? a.c2 : which == 2 ? a.mu2 : a.rstd2;
    vec[i] = c0 + c < Ce ? src[c0 + c] : 0.f;
  }
  for (int i = 0; i < S - 1; ++i) {
    issue(i);
    cp_commit();
  }

  const int wmd = warp & 3, wnd = warp >> 2;     // ddh: pixel m-tile, quarter
  const int wm2 = warp % WM2, wn2 = warp / WM2;  // dW2: channel m-tile, n group
  float accw[NT2][4];
  float tsum[NTD][2][2];  // [n-tile][T1, T2][column]
#pragma unroll
  for (int j = 0; j < NT2; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) accw[j][q] = 0.f;
#pragma unroll
  for (int j = 0; j < NTD; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) tsum[j][q >> 1][q & 1] = 0.f;

  for (int i = 0; i < n_mine; ++i) {
    if (S == 3) cp_wait<1>(); else cp_wait<0>();  // group i landed
    __syncthreads();  // ... for every thread; group i - 1 done
    const long long p0 = group_p0(i);
    const unsigned char* st = smem + L.stage + (i % S) * L.stage_bytes;
    const bf16* gs = reinterpret_cast<const bf16*>(st);
    const bf16* ds = reinterpret_cast<const bf16*>(st + L.s_dq);

    // ddh's product: 16 pixels x CEB / 4 channels a warp, k over Cout
    float acc[NTD][4];
#pragma unroll
    for (int j = 0; j < NTD; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < a.cout_k; kk += 16) {
      uint32_t af[4];
      ldm_x4(af, gs + (wmd * 16 + (lane & 15)) * GLD + kk + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NTD; j += 2) {
        uint32_t bf[4];
        const int c = (wnd * NTD + j) * 8 + (lane & 7) + ((lane >> 4) << 3);
        ldm_x4(bf, w2c + c * GLD + kk + ((lane >> 3) & 1) * 8);
        mma16816(acc[j], af, bf[0], bf[1]);
        mma16816(acc[j + 1], af, bf[2], bf[3]);
      }
    }
    // ddh = product * relu6'(v2); T1, T2 in registers; ddh and q(b) staged
#pragma unroll
    for (int j = 0; j < NTD; ++j) {
      const int c = (wnd * NTD + j) * 8 + 2 * t;
      const float2 va = *reinterpret_cast<const float2*>(vec + c);
      const float2 vc = *reinterpret_cast<const float2*>(vec + CEB + c);
      const float2 vm = *reinterpret_cast<const float2*>(vec + 2 * CEB + c);
      const float2 vr = *reinterpret_cast<const float2*>(vec + 3 * CEB + c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = wmd * 16 + g + 8 * h;
        const bool pin = p0 + p < a.P;
        const float2 d = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(ds + p * DLD + c));
        float o[2], bb[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float dv = e ? d.y : d.x;
          const bool live = pin && c0 + c + e < Ce;
          const float v2 = qbf(qbf(dv * (e ? va.y : va.x)) + (e ? vc.y : vc.x));
          const float dh = live && v2 > 0.f && v2 < 6.f ? acc[j][2 * h + e] : 0.f;
          tsum[j][0][e] += dh;
          tsum[j][1][e] += dh * ((dv - (e ? vm.y : vm.x)) * (e ? vr.y : vr.x));
          o[e] = dh;
          bb[e] = live ? relu6(v2) : 0.f;
        }
        *reinterpret_cast<float2*>(stg + p * SLD + c) = make_float2(o[0], o[1]);
        *reinterpret_cast<__nv_bfloat162*>(bq + p * DLD + c) =
            __floats2bfloat162_rn(bb[0], bb[1]);
      }
    }
    __syncthreads();

    // dW2 += q(b)^T gyq: A (channel, pixel) and B (pixel, n) both stored
    // pixel-major, read with ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < B2_GP; kk += 16) {
      uint32_t af[4];
      ldm_x4_t(af, bq + (kk + (lane & 7) + ((lane >> 4) << 3)) * DLD + wm2 * 16 +
                       ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int j = 0; j < NT2; j += 2) {
        const int nt = wn2 * NT2 + j;
        if (nt < n_out) {
          uint32_t bf[4];
          ldm_x4_t(bf, gs + (kk + (lane & 15)) * GLD + (nt + (lane >> 4)) * 8);
          mma16816(accw[j], af, bf[0], bf[1]);
          if (j + 1 < NT2 && nt + 1 < n_out) mma16816(accw[j + 1], af, bf[2], bf[3]);
        }
      }
    }
    // ddh's rows out, 16 bytes a store
    for (int v = tid; v < B2_GP * (CEB / 4); v += B2_THREADS) {
      const int p = v / (CEB / 4), q = v % (CEB / 4);
      if (p0 + p < a.P && c0 + 4 * q < Ce)
        *reinterpret_cast<float4*>(a.ddh_out + (p0 + p) * Ce + c0 + 4 * q) =
            *reinterpret_cast<const float4*>(stg + p * SLD + 4 * q);
    }
    // group i + S - 1 into the stage group i - 1 left, after this group's
    // work (measured 1-3% faster than before it)
    issue(i + S - 1);
    cp_commit();
  }
  cp_wait<0>();

  // T1, T2: over a warp's 8 pixel rows by fixed shuffles, then over the 4
  // pixel m-tiles in warp order: one partial per (split, channel)
#pragma unroll
  for (int j = 0; j < NTD; ++j)
#pragma unroll
    for (int w = 0; w < 2; ++w)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = tsum[j][w][e];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0) red[(wmd * 2 + w) * CEB + (wnd * NTD + j) * 8 + 2 * t + e] = v;
      }
  __syncthreads();
  for (int i = tid; i < 2 * CEB; i += B2_THREADS) {
    const int w = i / CEB, c = i % CEB;
    if (c0 + c < Ce) {
      float s = 0.f;
      for (int m = 0; m < 4; ++m) s += red[(m * 2 + w) * CEB + c];
      a.part2[(long long)split * 2 * Ce + w * Ce + c0 + c] = s;
    }
  }
#pragma unroll
  for (int j = 0; j < NT2; ++j) {
    const int nt = wn2 * NT2 + j;
    if (nt >= n_out) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = c0 + wm2 * 16 + g + 8 * h;
      if (row < Ce)
        *reinterpret_cast<float2*>(a.part + ((long long)split * Ce + row) * Cout +
                                   nt * 8 + 2 * t) =
            make_float2(accw[j][2 * h], accw[j][2 * h + 1]);
    }
  }
}

// ------------------------------------------------ halo phases F2, B34 ----
// One block of 16 warps per (TH x TW output tile, image); the plan
// (train_plan in kernels/fused_mbconv_train.py) gives the tile, chunk CK and
// ring depth, and lay_halo reproduces its shared memory.

// Rows of aq (bf16) and dd (f32) hold CK values, unpadded: a row of aq is
// ESW = CK / 2 32-bit words, a row of dd twice that, so that one table
// entry, a row's word offset T in aq, addresses both (dd at 2T).  The taps
// read a warp's pixels from neighbouring box rows, which unpadded rows of
// 8 or 16 words (32 for dd) put in disjoint banks.
__host__ __device__ inline int esw(int ck) { return ck / 2; }
constexpr int TAB_LD = 16;  // the tap table: 9 entries a pixel in 32 bytes

struct Halo {  // a block's view of its shared memory
  bf16* xs;     // [rows][xt_ld] x over the in-image halo box, swizzled
  bf16* es;     // [rows + 1][CK] aq of the chunk; row `rows` zero
  float* dds;   // [rows + 1][CK] dd; row `rows` zero                (B34)
  bf16* dqr;    // [rows][CK] dq's raw rows of the chunk            (B34)
  bf16* eqc;    // [TP][CK] eq at the tile's pixels                  (B34)
  short* tab;   // [TP][16] word offset in aq of each tap's box row, that
                // of the zero row outside the image
  short* ctab;  // [rows] tile pixel of each box row, or -1          (B34)
  float* red;   // [16 warps][2 or 11][CK] the warps' sums of a chunk
  int zoff;     // the zero row's word offset
};

// The layout train_smem (kernels/fused_mbconv_train.py) computes.  Stage s
// at stage + s * stage_bytes: w1 slice [cin_p][CK] (w1_swz), taps [9][CK],
// then vectors of CK f32: a1, c1 (F2); a1, c1, a2, m0, m1, mu1, rstd1 (B34).
struct LHalo {
  int xs, es, dds, dqr, eqc, tab, ctab, red, stage, stage_bytes;
  int s_wdw, s_vec, total;
};

__host__ __device__ inline LHalo lay_halo(int phase, const Args& a) {
  const int ck = a.ck, tp = a.th * a.tw, rows = a.rows;
  LHalo l{};
  int o = 0;
  l.xs = o; o += a16(2 * rows * a.xt_ld);
  l.es = o; o += a16(2 * (rows + 1) * ck);
  if (phase == B34) {
    l.dds = o; o += a16(4 * (rows + 1) * ck);
    l.dqr = o; o += a16(2 * rows * ck);
    l.eqc = o; o += a16(2 * tp * ck);
  }
  l.tab = o; o += a16(2 * TAB_LD * tp);
  if (phase == B34) { l.ctab = o; o += a16(2 * rows); }
  l.red = o; o += a16(4 * (phase == B34 ? 11 : 2) * HALO_WARPS * ck);
  l.stage = o;
  l.s_wdw = a16(2 * a.cin_p * ck);
  l.s_vec = l.s_wdw + a16(4 * 9 * ck);
  l.stage_bytes = l.s_vec + (phase == B34 ? 7 : 2) * a16(4 * ck);
  l.total = o + a.stages * l.stage_bytes;
  return l;
}

__device__ __forceinline__ Halo halo_view(int phase, const Args& a,
                                          unsigned char* smem) {
  const LHalo l = lay_halo(phase, a);
  Halo h;
  h.xs = reinterpret_cast<bf16*>(smem + l.xs);
  h.es = reinterpret_cast<bf16*>(smem + l.es);
  h.dds = reinterpret_cast<float*>(smem + l.dds);
  h.dqr = reinterpret_cast<bf16*>(smem + l.dqr);
  h.eqc = reinterpret_cast<bf16*>(smem + l.eqc);
  h.tab = reinterpret_cast<short*>(smem + l.tab);
  h.ctab = reinterpret_cast<short*>(smem + l.ctab);
  h.red = reinterpret_cast<float*>(smem + l.red);
  h.zoff = a.rows * esw(a.ck);
  return h;
}

struct HStage {
  bf16* w1;     // [cin_p][CK], 16-byte chunks swizzled (w1_swz)
  float* wdw;   // [9][CK]
  float* vec;   // [n][CK]
};

__device__ __forceinline__ HStage hstage(int phase, const Args& a,
                                         unsigned char* smem, int s) {
  const LHalo l = lay_halo(phase, a);
  unsigned char* base = smem + l.stage + s * l.stage_bytes;
  return {reinterpret_cast<bf16*>(base), reinterpret_cast<float*>(base + l.s_wdw),
          reinterpret_cast<float*>(base + l.s_vec)};
}

// The tile's geometry: its in-image halo box [sy0, sy1) x [sx0, sx1), whose
// pixels, row-major, are the rows of the x tile, aq and dd.
struct Tile {
  int ty0, tx0, sy0, sx0, hx, nv;
  size_t img;
};

__device__ __forceinline__ Tile tile_of(const Args& a) {
  Tile t;
  t.ty0 = (blockIdx.x / a.tiles_x) * a.th;
  t.tx0 = (blockIdx.x % a.tiles_x) * a.tw;
  const int r = a.rate;
  t.sy0 = max(t.ty0 - r, 0);
  t.sx0 = max(t.tx0 - r, 0);
  const int sy1 = min(t.ty0 + a.th + r, a.H), sx1 = min(t.tx0 + a.tw + r, a.W);
  t.hx = sx1 - t.sx0;
  t.nv = (sy1 - t.sy0) * t.hx;
  t.img = size_t(blockIdx.y) * a.H * a.W;
  return t;
}

__device__ __forceinline__ size_t box_pix(const Args& a, const Tile& t, int hp) {
  return t.img + size_t(t.sy0 + hp / t.hx) * a.W + t.sx0 + hp % t.hx;
}

// f32 rows [c0, c0 + CK) of a (n, Ce) array into dst[n][CK], zero past Ce
// (Ce % 8 == 0: whole 16-byte vectors)
template <int CK>
__device__ __forceinline__ void cp_rows(float* dst, const float* src, int n,
                                        int Ce, int c0) {
  for (int i = threadIdx.x; i < n * (CK / 4); i += HALO_THREADS) {
    const int row = i / (CK / 4), q = i % (CK / 4), col = c0 + 4 * q;
    const bool in = col < Ce;
    cp16(dst + row * CK + 4 * q, in ? (const void*)(src + size_t(row) * Ce + col)
                                    : (const void*)src, in ? 16 : 0);
  }
}

// chunk c0's w1 slice (contiguous runs of (Cin, Ce): k-major, no repacking),
// taps and per-channel vectors into a stage
template <int CK>
__device__ __forceinline__ void load_stage(int phase, const Args& a,
                                           const HStage& st, int c0) {
  for (int i = threadIdx.x; i < a.Cin * (CK / 8); i += HALO_THREADS) {
    const int k = i / (CK / 8), q = i % (CK / 8), col = c0 + 8 * q;
    const bool in = col < a.Ce;
    cp16(st.w1 + k * CK + 8 * (q ^ w1_swz<CK>(k)),
         in ? (const void*)(a.w1 + size_t(k) * a.Ce + col) : (const void*)a.w1,
         in ? 16 : 0);
  }
  cp_rows<CK>(st.wdw, a.wdw, 9, a.Ce, c0);
  const float* vecs[7] = {a.a1, a.c1, a.a2, a.m0, a.m1, a.mu1, a.rstd1};
  const int nvec = phase == B34 ? 7 : 2;
  for (int v = 0; v < nvec; ++v) cp_rows<CK>(st.vec + v * CK, vecs[v], 1, a.Ce, c0);
}

// Once per block: the x tile (16-byte copies, zero past Cin), the tap table,
// the zero rows, w1's rows past Cin in every stage, and (B34) the box-row
// table.
template <int CK>
__device__ void halo_setup(int phase, const Args& a, const Tile& t, const Halo& h,
                           unsigned char* smem) {
  const int tid = threadIdx.x, vq = a.cin_p / 8;
  for (int i = tid; i < t.nv * vq; i += HALO_THREADS) {
    const int hp = i / vq, q = i % vq;
    const bool in = 8 * q < a.Cin;
    cp16(h.xs + hp * a.xt_ld + 8 * xs_chunk(a.xt_swz, hp, q),
         in ? (const void*)(a.x + box_pix(a, t, hp) * a.Cin + 8 * q)
            : (const void*)a.x, in ? 16 : 0);
  }
  const int tp = a.th * a.tw, r = a.rate;
  for (int i = tid; i < tp * 9; i += HALO_THREADS) {
    const int p = i / 9, tap = i % 9, ti = tap / 3, tj = tap % 3;
    const int py = t.ty0 + (p >> a.twl), px = t.tx0 + (p & (a.tw - 1));
    const int yy = py + (ti - 1) * r, xx = px + (tj - 1) * r;
    const bool in = yy >= 0 && yy < a.H && xx >= 0 && xx < a.W && py < a.H && px < a.W;
    h.tab[p * TAB_LD + tap] =
        (short)(in ? ((yy - t.sy0) * t.hx + xx - t.sx0) * esw(CK) : h.zoff);
  }
  for (int i = tid; i < CK; i += HALO_THREADS) {
    h.es[a.rows * CK + i] = bzero();
    if (phase == B34) h.dds[a.rows * CK + i] = 0.f;
  }
  for (int s = 0; s < a.stages; ++s) {
    bf16* w1s = hstage(phase, a, smem, s).w1;
    for (int i = tid; i < (a.cin_p - a.Cin) * CK; i += HALO_THREADS)
      w1s[a.Cin * CK + i] = bzero();
  }
  if (phase == B34)
    for (int hp = tid; hp < a.rows; hp += HALO_THREADS) {
      int p = -1;
      if (hp < t.nv) {
        const int py = t.sy0 + hp / t.hx - t.ty0, px = t.sx0 + hp % t.hx - t.tx0;
        if (py >= 0 && py < a.th && px >= 0 && px < a.tw) p = py * a.tw + px;
      }
      h.ctab[hp] = (short)p;
    }
}

// The expand of a chunk over the tile's halo box: epi(row, n, v0, v1) with
// the f32 products of channels n, n + 1 (n even) at box row `row`.  Units of
// 32 box rows (two m-tiles sharing each B fragment) x 16 channels over the
// warps; A (the x tile) by ldmatrix, B (the k-major w1 slice) by
// ldmatrix.trans.
template <int CK, typename Epi>
__device__ __forceinline__ void expand_box(const Args& a, const Halo& h,
                                           const HStage& st, int nv, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mt_n = (nv + 15) >> 4, mp_n = (mt_n + 1) >> 1;
  for (int u = warp; u < mp_n * (CK / 16); u += HALO_WARPS) {
    const int mt = 2 * (u / (CK / 16)), nh = u % (CK / 16);
    const bool two = mt + 1 < mt_n;  // warp-uniform
    float acc[2][2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][j][q] = 0.f;
    const int ra = mt * 16 + (lane & 15);  // rows ra and ra + 16 swizzle alike
    const bf16* pa = h.xs + ra * a.xt_ld;
    const int kb = lane & 15;
    const bf16* pb = st.w1 + kb * CK + 8 * ((2 * nh + (lane >> 4)) ^ w1_swz<CK>(kb));
#pragma unroll 2
    for (int kk = 0; kk < a.cin_p; kk += 16) {
      uint32_t a0[4], a1[4], bf[4];
      const int ca = 8 * xs_chunk(a.xt_swz, ra, (kk >> 3) + (lane >> 4));
      ldm_x4(a0, pa + ca);
      ldm_x4_t(bf, pb + kk * CK);
      mma16816(acc[0][0], a0, bf[0], bf[1]);
      mma16816(acc[0][1], a0, bf[2], bf[3]);
      if (two) {
        ldm_x4(a1, pa + 16 * a.xt_ld + ca);
        mma16816(acc[1][0], a1, bf[0], bf[1]);
        mma16816(acc[1][1], a1, bf[2], bf[3]);
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      if (m == 1 && !two) break;
      const int r0 = (mt + m) * 16 + g;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = nh * 16 + j * 8 + 2 * t;
        epi(r0, n, acc[m][j][0], acc[m][j][1]);
        epi(r0 + 8, n, acc[m][j][2], acc[m][j][3]);
      }
    }
  }
}

// aq = relu6(q(q(q(v) * a1) + c1)) of channels n, n + 1 into row R of aq;
// eq = q(v) back to the caller
template <int CK>
__device__ __forceinline__ void put_aq(const Halo& h, const HStage& st, int R, int n,
                                       float v0, float v1, float& eq0, float& eq1) {
  eq0 = qbf(v0);
  eq1 = qbf(v1);
  const float2 a1 = *reinterpret_cast<const float2*>(st.vec + n);
  const float2 c1 = *reinterpret_cast<const float2*>(st.vec + CK + n);
  reinterpret_cast<__nv_bfloat162*>(h.es)[R * esw(CK) + (n >> 1)] =
      __floats2bfloat162_rn(relu6(qbf(qbf(eq0 * a1.x) + c1.x)),
                            relu6(qbf(qbf(eq1 * a1.y) + c1.y)));
}

// a pixel's 9 tap offsets from its row of the tap table (two 16-byte loads)
__device__ __forceinline__ void taps_of(const Halo& h, int p, int (&off)[9]) {
  const int4* t4 = reinterpret_cast<const int4*>(h.tab + p * TAB_LD);
  const int4 u = t4[0], v = t4[1];
  const int w[5] = {u.x, u.y, u.z, u.w, v.x};
#pragma unroll
  for (int i = 0; i < 9; ++i)
    off[i] = (i & 1) ? int(unsigned(w[i >> 1]) >> 16) : (w[i >> 1] & 0xffff);
}

// warp sum over the lanes that share a channel pair (lane % CP), in a fixed
// butterfly order
template <int CP>
__device__ __forceinline__ float lane_sum(float v) {
#pragma unroll
  for (int o = CP; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// this chunk's per-channel tile sums: rows x CK of the warps' sums added in
// warp order, into part[tile][rows][Ce]
template <int CK>
__device__ __forceinline__ void finish_sums(const Args& a, const Halo& h, int nrow,
                                            int c0) {
  const int tid = threadIdx.x;
  if (tid >= nrow * CK) return;
  const int row = tid / CK, c = tid % CK;
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < HALO_WARPS; ++w) s += h.red[(w * nrow + row) * CK + c];
  if (c0 + c < a.Ce)
    a.part[((long long)blockIdx.y * gridDim.x + blockIdx.x) * nrow * a.Ce +
           (long long)row * a.Ce + c0 + c] = s;
}

// ---------------------------------------------------------------- F2 ----
// Per chunk: [taps of chunk c -> dq and its sums] barrier [the sums of c
// into the partials, the expand of chunk c + 1 -> aq, chunk c + S's stage
// copied] barrier.
template <int CK, int TP>
__global__ void __launch_bounds__(HALO_THREADS, 1) f2_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Halo h = halo_view(F2, a, smem);
  const Tile t = tile_of(a);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_chunks = (a.Ce + CK - 1) / CK, S = a.stages;
  for (int s = 0; s < S; ++s) {
    if (s == 0) halo_setup<CK>(F2, a, t, h, smem);
    if (s < n_chunks) load_stage<CK>(F2, a, hstage(F2, a, smem, s), s * CK);
    cp_commit();
  }
  auto wait_ring = [&]() { if (S == 3) cp_wait<1>(); else cp_wait<0>(); };
  auto expand = [&](int c) {
    const HStage st = hstage(F2, a, smem, c % S);
    expand_box<CK>(a, h, st, t.nv, [&](int R, int n, float v0, float v1) {
      float e0, e1;
      put_aq<CK>(h, st, R, n, v0, v1, e0, e1);
    });
  };
  // taps in f32, dx outer and dy inner (the plain version's order); four
  // channels a thread, pixels warp * SUB + lane / CQ + k * STEP (the tile's
  // rows are TW = 8 or 16 pixels: TP = 64 is 8x8, else TW = 16)
  constexpr int CQ = CK / 4, SUB = 32 / CQ, STEP = HALO_WARPS * SUB;
  constexpr int TWL = TP == 64 ? 3 : 4;
  const int cq = lane % CQ, ch = 4 * cq;
  const uint2* ew = reinterpret_cast<const uint2*>(h.es) + cq;  // aq at word T
  auto taps = [&](int c) {
    const HStage st = hstage(F2, a, smem, c % S);
    const int c0 = c * CK;
    float4 w[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) w[i] = *reinterpret_cast<const float4*>(st.wdw + i * CK + ch);
    float sm[4] = {}, sq[4] = {};
#pragma unroll
    for (int k = 0; k < (TP + STEP - 1) / STEP; ++k) {
      const int p = warp * SUB + lane / CQ + k * STEP;
      if (TP % STEP && p >= TP) break;  // warp-uniform
      int off[9];
      taps_of(h, p, off);
      float4 v[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) {
        // word offset T of a row: a uint2 index T / 2 (rows hold an even
        // number of words)
        const uint2 u = ew[off[i] >> 1];
        const float2 lo = bf2f(u.x), hi = bf2f(u.y);
        v[i] = make_float4(lo.x, lo.y, hi.x, hi.y);
      }
      float d[4] = {};
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const float4 e = v[i * 3 + j], f = w[i * 3 + j];
          d[0] += e.x * f.x;
          d[1] += e.y * f.y;
          d[2] += e.z * f.z;
          d[3] += e.w * f.w;
        }
      if (off[4] != h.zoff) {  // the pixel lies in the image
        const __nv_bfloat162 q01 = __floats2bfloat162_rn(d[0], d[1]);
        const __nv_bfloat162 q23 = __floats2bfloat162_rn(d[2], d[3]);
        const float2 f01 = __bfloat1622float2(q01), f23 = __bfloat1622float2(q23);
        const float df[4] = {f01.x, f01.y, f23.x, f23.y};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          sm[r] += df[r];
          sq[r] += df[r] * df[r];
        }
        if (c0 + ch < a.Ce) {
          const size_t pix = t.img + size_t(t.ty0 + (p >> TWL)) * a.W + t.tx0 +
                             (p & ((1 << TWL) - 1));
          uint2 o;
          o.x = *reinterpret_cast<const uint32_t*>(&q01);
          o.y = *reinterpret_cast<const uint32_t*>(&q23);
          *reinterpret_cast<uint2*>(a.dq_out + pix * a.Ce + c0 + ch) = o;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      sm[r] = lane_sum<CQ>(sm[r]);
      sq[r] = lane_sum<CQ>(sq[r]);
    }
    if (lane < CQ) {
      float* rd = h.red + warp * 2 * CK;
      *reinterpret_cast<float4*>(rd + ch) = make_float4(sm[0], sm[1], sm[2], sm[3]);
      *reinterpret_cast<float4*>(rd + CK + ch) = make_float4(sq[0], sq[1], sq[2], sq[3]);
    }
  };

  wait_ring();
  __syncthreads();
  expand(0);
  for (int c = 0; c < n_chunks; ++c) {
    __syncthreads();   // aq of chunk c complete; the sums of c - 1 read
    taps(c);
    wait_ring();       // chunk c + 1's stage
    __syncthreads();   // taps done: aq free, the warps' sums complete
    finish_sums<CK>(a, h, 2, c * CK);
    if (c + 1 < n_chunks) expand(c + 1);
    if (c + S < n_chunks) load_stage<CK>(F2, a, hstage(F2, a, smem, c % S), (c + S) * CK);
    cp_commit();
  }
  cp_wait<0>();
}

// --------------------------------------------------------------- B34 ----
// Per chunk: [transposed taps of chunk c -> dv1, dvl (to device memory for
// dx and dW1^T); U1, U2 and dWdw sums] barrier [the sums of c into the
// partials, chunk c + 1's dd copied in flight while its expand runs -> aq
// and eq, then converted; chunk c + S's stage copied] barrier.
template <int CK, int TP>
__global__ void __launch_bounds__(HALO_THREADS, 1) b34_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Halo h = halo_view(B34, a, smem);
  const Tile t = tile_of(a);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_chunks = (a.Ce + CK - 1) / CK, S = a.stages;
  constexpr int DS = CK;  // dd row stride (f32)

  // dd's raw rows of chunk c: ddh (f32) into dds, dq (bf16) into dqr, four
  // channels a copy; the thread that copies a quad converts it
  auto copy_dd = [&](int c) {
    const int c0 = c * CK;
    for (int i = tid; i < t.nv * (CK / 4); i += HALO_THREADS) {
      const int hp = i / (CK / 4), q = i % (CK / 4), col = c0 + 4 * q;
      const bool in = col < a.Ce;
      const size_t o = box_pix(a, t, hp) * a.Ce + col;
      cp16(h.dds + hp * DS + 4 * q, in ? (const void*)(a.ddh + o) : (const void*)a.ddh,
           in ? 16 : 0);
      cp8(h.dqr + hp * CK + 4 * q, in ? (const void*)(a.dq + o) : (const void*)a.dq,
          in ? 8 : 0);
    }
  };
  // dd = a2*ddh + m0 + m1*dq on the thread's own quads (zero past Ce)
  auto convert_dd = [&](int c) {
    const HStage st = hstage(B34, a, smem, c % S);
    for (int i = tid; i < t.nv * (CK / 4); i += HALO_THREADS) {
      const int hp = i / (CK / 4), q = i % (CK / 4);
      float4* dp = reinterpret_cast<float4*>(h.dds + hp * DS + 4 * q);
      const float4 d = *dp;
      const uint2 rq = *reinterpret_cast<const uint2*>(h.dqr + hp * CK + 4 * q);
      const float2 q01 = bf2f(rq.x), q23 = bf2f(rq.y);
      const float4 a2 = *reinterpret_cast<const float4*>(st.vec + 2 * CK + 4 * q);
      const float4 m0 = *reinterpret_cast<const float4*>(st.vec + 3 * CK + 4 * q);
      const float4 m1 = *reinterpret_cast<const float4*>(st.vec + 4 * CK + 4 * q);
      *dp = make_float4(a2.x * d.x + m0.x + m1.x * q01.x, a2.y * d.y + m0.y + m1.y * q01.y,
                        a2.z * d.z + m0.z + m1.z * q23.x, a2.w * d.w + m0.w + m1.w * q23.y);
    }
  };
  auto expand = [&](int c) {
    const HStage st = hstage(B34, a, smem, c % S);
    expand_box<CK>(a, h, st, t.nv, [&](int R, int n, float v0, float v1) {
      float e0, e1;
      put_aq<CK>(h, st, R, n, v0, v1, e0, e1);
      const int p = h.ctab[R];
      if (p >= 0)
        *reinterpret_cast<__nv_bfloat162*>(h.eqc + p * CK + n) =
            __floats2bfloat162_rn(e0, e1);
    });
  };

  // transposed taps of dd (dx outer, dy inner), the relu6' mask, U1/U2 and
  // dWdw[t] = sum dd(p) aq(p + t); a channel pair a thread
  constexpr int CP = CK / 2, SUB = 32 / CP, STEP = HALO_WARPS * SUB;
  constexpr int TWL = TP == 64 ? 3 : 4;  // TW = 8 or 16 pixels
  const int cp = lane % CP, ch = 2 * cp;
  const uint32_t* ew = reinterpret_cast<const uint32_t*>(h.es) + cp;
  const float2* dw = reinterpret_cast<const float2*>(h.dds) + cp;  // dd at 2T
  auto taps = [&](int c) {
    const HStage st = hstage(B34, a, smem, c % S);
    const int c0 = c * CK;
    // the taps are read from shared memory where they are used: these sums
    // hold most of the registers
    const float2* w = reinterpret_cast<const float2*>(st.wdw + ch);
    float red[11][2];
#pragma unroll
    for (int k = 0; k < 11; ++k) red[k][0] = red[k][1] = 0.f;
#pragma unroll
    for (int k = 0; k < TP / STEP; ++k) {
      const int p = warp * SUB + lane / CP + k * STEP;
      int off[9];
      taps_of(h, p, off);
      float da0 = 0.f, da1 = 0.f;
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const float2 d = dw[off[(2 - i) * 3 + (2 - j)]];
          const float2 wk = w[(i * 3 + j) * (CK / 2)];
          da0 += d.x * wk.x;
          da1 += d.y * wk.y;
        }
      const float2 ddc = dw[off[4]];  // zero outside the image
      const float2 a1 = *reinterpret_cast<const float2*>(st.vec + ch);
      const float2 c1 = *reinterpret_cast<const float2*>(st.vec + CK + ch);
      const float2 mu = *reinterpret_cast<const float2*>(st.vec + 5 * CK + ch);
      const float2 rs = *reinterpret_cast<const float2*>(st.vec + 6 * CK + ch);
      const bool valid = off[4] != h.zoff;  // the pixel lies in the image
      // eq is set only at the tile's pixels in the image
      const float2 eq = valid ? bf2f(*reinterpret_cast<const uint32_t*>(h.eqc + p * CK + ch))
                              : make_float2(0.f, 0.f);
      const float v10 = qbf(qbf(eq.x * a1.x) + c1.x), v11 = qbf(qbf(eq.y * a1.y) + c1.y);
      const float dv0 = valid && v10 > 0.f && v10 < 6.f ? da0 : 0.f;
      const float dv1 = valid && v11 > 0.f && v11 < 6.f ? da1 : 0.f;
      red[0][0] += dv0;
      red[0][1] += dv1;
      red[1][0] += dv0 * ((eq.x - mu.x) * rs.x);
      red[1][1] += dv1 * ((eq.y - mu.y) * rs.y);
      if (valid && c0 + ch < a.Ce) {
        const size_t pix = t.img + size_t(t.ty0 + (p >> TWL)) * a.W + t.tx0 +
                           (p & ((1 << TWL) - 1));
        *reinterpret_cast<__nv_bfloat162*>(a.dvl + pix * a.Ce + c0 + ch) =
            __floats2bfloat162_rn(a1.x * dv0, a1.y * dv1);
      }
      // dd is zero outside the image, so pixels outside add nothing here
#pragma unroll
      for (int i = 0; i < 9; ++i) {
        const float2 e = bf2f(ew[off[i]]);
        red[2 + i][0] += ddc.x * e.x;
        red[2 + i][1] += ddc.y * e.y;
      }
    }
#pragma unroll
    for (int k = 0; k < 11; ++k) {
      const float r0 = lane_sum<CP>(red[k][0]), r1 = lane_sum<CP>(red[k][1]);
      if (lane < CP) {
        h.red[(warp * 11 + k) * CK + ch] = r0;
        h.red[(warp * 11 + k) * CK + ch + 1] = r1;
      }
    }
  };

  // prologue: the x tile, chunk 0's dd and the first S stages in flight
  for (int s = 0; s < S; ++s) {
    if (s == 0) {
      halo_setup<CK>(B34, a, t, h, smem);
      copy_dd(0);
    }
    if (s < n_chunks) load_stage<CK>(B34, a, hstage(B34, a, smem, s), s * CK);
    cp_commit();
  }
  cp_wait<0>();
  __syncthreads();   // every thread's copies landed: the x tile, stage 0
  convert_dd(0);
  expand(0);
  for (int c = 0; c < n_chunks; ++c) {
    __syncthreads();   // aq, eq, dd of chunk c complete
    taps(c);
    __syncthreads();   // the warps' sums complete; aq, dd and stage c free
    finish_sums<CK>(a, h, 11, c * CK);
    if (c + 1 < n_chunks) copy_dd(c + 1);
    cp_commit();
    if (c + 1 < n_chunks) expand(c + 1);
    if (c + S < n_chunks) load_stage<CK>(B34, a, hstage(B34, a, smem, c % S), (c + S) * CK);
    cp_commit();
    // this thread's dd quads of chunk c + 1 (the stage of c + 1 landed one
    // chunk ago: every thread waited for it before this chunk's barriers)
    if (S == 3) cp_wait<1>(); else cp_wait<0>();
    if (c + 1 < n_chunks) convert_dd(c + 1);
  }
  cp_wait<0>();
}

// ------------------------------------------------------- dx = dvl @ w1^T ----
// B34's main part of dx: a GEMM of depth Ce over dvl (pixels x Ce, which
// b34_kernel writes) and w1 (Cin x Ce), rounded once.  A block of 8 warps
// takes 128 pixels and all of Cin: 4 pairs of pixel m-tiles x 2 halves of
// Cin, NT n-tiles a warp (as dW1^T's).  Ce runs in chunks of 64 through a
// cp.async ring of DX_STAGES, both operands as they lie (rows of 64
// channels, 16-byte chunks XOR-swizzled by row), A by ldmatrix and B (w1's
// rows are Cin) by ldmatrix without a transpose.
template <int NT>
__global__ void __launch_bounds__(DX_THREADS) dx_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const long long p0 = (long long)blockIdx.x * DX_M;
  const int Ce = a.Ce, Cin = a.Cin, n_chunks = (Ce + DX_K - 1) / DX_K;
  const int a_bytes = 2 * DX_M * DX_K, st_bytes = a_bytes + 2 * a.cin_p * DX_K;
  auto As = [&](int s) { return reinterpret_cast<bf16*>(smem + s * st_bytes); };
  auto Bs = [&](int s) { return reinterpret_cast<bf16*>(smem + s * st_bytes + a_bytes); };
  constexpr int Q = DX_K / 8;  // 16-byte chunks a row
  // rows of w1 past Cin are zero in every stage
  for (int s = 0; s < DX_STAGES; ++s)
    for (int i = tid; i < (a.cin_p - Cin) * DX_K; i += DX_THREADS)
      Bs(s)[Cin * DX_K + i] = bzero();
  auto load = [&](int c) {
    const int s = c % DX_STAGES, c0 = c * DX_K;
    bf16* A = As(s);
    for (int e = tid; e < DX_M * Q; e += DX_THREADS) {
      const int p = e / Q, q = e % Q, col = c0 + 8 * q;
      const bool in = p0 + p < a.P && col < Ce;
      cp16(A + p * DX_K + 8 * (q ^ (p & 7)),
           in ? (const void*)(a.dvl + (p0 + p) * Ce + col) : (const void*)a.dvl,
           in ? 16 : 0);
    }
    bf16* B = Bs(s);
    for (int e = tid; e < Cin * Q; e += DX_THREADS) {
      const int n = e / Q, q = e % Q, col = c0 + 8 * q;
      const bool in = col < Ce;
      cp16(B + n * DX_K + 8 * (q ^ (n & 7)),
           in ? (const void*)(a.w1 + size_t(n) * Ce + col) : (const void*)a.w1,
           in ? 16 : 0);
    }
  };
  const int wm = warp & 3, wn = warp >> 2;  // pixels 32 wm.., n-tiles wn*NT..
  float acc[2][NT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][j][q] = 0.f;
  for (int c = 0; c < DX_STAGES - 1; ++c) {
    if (c < n_chunks) load(c);
    cp_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    cp_wait<DX_STAGES - 2>();
    __syncthreads();   // chunk c landed (and the zero rows); c - 1's stage free
    if (c + DX_STAGES - 1 < n_chunks) load(c + DX_STAGES - 1);
    cp_commit();
    const bf16* A = As(c % DX_STAGES);
    const bf16* B = Bs(c % DX_STAGES);
#pragma unroll
    for (int kk = 0; kk < DX_K; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int ra = wm * 32 + m * 16 + (lane & 15), qa = (kk >> 3) + (lane >> 4);
        ldm_x4(af[m], A + ra * DX_K + 8 * (qa ^ (ra & 7)));
      }
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        const int nt = wn * NT + j;
        if (nt * 8 >= a.cin_p) continue;  // past w1's rows (pairs stay below)
        uint32_t bf[4];
        const int n = nt * 8 + ((lane >> 4) & 1) * 8 + (lane & 7);
        const int kc = (kk >> 3) + ((lane >> 3) & 1);
        ldm_x4(bf, B + n * DX_K + 8 * (kc ^ (n & 7)));
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          mma16816(acc[m][j], af[m], bf[0], bf[1]);
          mma16816(acc[m][j + 1], af[m], bf[2], bf[3]);
        }
      }
    }
  }
  cp_wait<0>();
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = (wn * NT + j) * 8 + 2 * tq;
      if (n >= Cin) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const long long p = p0 + wm * 32 + m * 16 + g + 8 * hh;
        if (p < a.P)
          *reinterpret_cast<__nv_bfloat162*>(a.dxp + p * Cin + n) =
              __floats2bfloat162_rn(acc[m][j][2 * hh], acc[m][j][2 * hh + 1]);
      }
    }
}

// ----------------------------------------------- weight gradient dW1^T ----
// dW1^T[c][k] = sum_p dvl[p][c] x[p][k]: a GEMM of depth P over groups of 64
// pixels, both operands pixel-major as B34 and the caller left them, read
// by ldmatrix.trans from 16-byte cp.async copies (a ring of WG_STAGES).
// Grid (Ce / 128, pixel splits); 8 warps: 4 pairs of channel m-tiles x 2
// halves of Cin, NT n-tiles a warp; the split's sums into part2.  Two
// blocks an SM (at most 128 registers a thread) hide the ring's latency:
// the widest instance runs in 0.74 of its time at one.
template <int NT>
__global__ void __launch_bounds__(WG_THREADS, 2) wg_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int c0 = blockIdx.x * WG_M, split = blockIdx.y, Ce = a.Ce, Cin = a.Cin;
  const int dv_bytes = a16(2 * WG_GP * WG_M), st_bytes = dv_bytes + a16(2 * WG_GP * a.xt_ld);
  auto dvs = [&](int s) { return reinterpret_cast<bf16*>(smem + s * st_bytes); };
  auto xgs = [&](int s) { return reinterpret_cast<bf16*>(smem + s * st_bytes + dv_bytes); };
  const int n_mine = (a.n_groups - split + a.splits - 1) / a.splits;
  // group i of this split: dvl rows (64 x 128 channels, chunk ^ row) and x
  // rows (64 x cin_p, the x tile's swizzle), zero past P, Ce and Cin
  auto load = [&](int i) {
    const int s = i % WG_STAGES;
    const long long p0 = (long long)(split + i * a.splits) * WG_GP;
    bf16* dv = dvs(s);
    for (int e = tid; e < WG_GP * (WG_M / 8); e += WG_THREADS) {
      const int p = e / (WG_M / 8), q = e % (WG_M / 8), col = c0 + 8 * q;
      const bool in = p0 + p < a.P && col < Ce;
      cp16(dv + p * WG_M + 8 * (q ^ (p & 7)),
           in ? (const void*)(a.dvl + (p0 + p) * Ce + col) : (const void*)a.dvl,
           in ? 16 : 0);
    }
    bf16* xg = xgs(s);
    const int vq = a.cin_p / 8;
    for (int e = tid; e < WG_GP * vq; e += WG_THREADS) {
      const int p = e / vq, q = e % vq;
      const bool in = p0 + p < a.P && 8 * q < Cin;
      cp16(xg + p * a.xt_ld + 8 * xs_chunk(a.xt_swz, p, q),
           in ? (const void*)(a.x + (p0 + p) * Cin + 8 * q) : (const void*)a.x,
           in ? 16 : 0);
    }
  };
  const int wm = warp & 3, wn = warp >> 2;  // channels c0 + 32 wm, n-tiles wn*NT
  float acc[2][NT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][j][q] = 0.f;
  for (int i = 0; i < WG_STAGES - 1; ++i) {
    if (i < n_mine) load(i);
    cp_commit();
  }
  for (int i = 0; i < n_mine; ++i) {
    cp_wait<WG_STAGES - 2>();
    __syncthreads();   // group i landed; group i - 1's stage free
    if (i + WG_STAGES - 1 < n_mine) load(i + WG_STAGES - 1);
    cp_commit();
    const bf16* dv = dvs(i % WG_STAGES);
    const bf16* xg = xgs(i % WG_STAGES);
#pragma unroll
    for (int kk = 0; kk < WG_GP; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        // A (channel m, pixel k) stored pixel-major: ldmatrix.trans
        const int p = kk + ((lane >> 4) & 1) * 8 + (lane & 7);
        const int q = (wm * 32 + m * 16) / 8 + ((lane >> 3) & 1);
        ldm_x4_t(af[m], dv + p * WG_M + 8 * (q ^ (p & 7)));
      }
      const int pb = kk + (lane & 15);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        if ((wn * NT + j) * 8 >= a.cin_p) continue;  // past the x rows
        uint32_t bf[4];
        const int q = (wn * NT + j) + (lane >> 4);
        ldm_x4_t(bf, xg + pb * a.xt_ld + 8 * xs_chunk(a.xt_swz, pb, q));
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          mma16816(acc[m][j], af[m], bf[0], bf[1]);
          mma16816(acc[m][j + 1], af[m], bf[2], bf[3]);
        }
      }
    }
  }
  cp_wait<0>();
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = (wn * NT + j) * 8 + 2 * tq;
      if (n >= Cin) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = c0 + wm * 32 + m * 16 + g + 8 * hh;
        if (row < Ce)
          *reinterpret_cast<float2*>(a.part2 + ((long long)split * Ce + row) * Cin + n) =
              make_float2(acc[m][j][2 * hh], acc[m][j][2 * hh + 1]);
      }
    }
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

template <typename K>
cudaError_t run(K kern, dim3 grid, size_t smem, const Args& a, cudaStream_t s,
                int threads = NTHREADS) {
  if (smem > SMEM_MAX) return cudaErrorInvalidConfiguration;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(smem));
  if (e != cudaSuccess) return e;
  kern<<<grid, threads, smem, s>>>(a);
  return cudaGetLastError();
}

cudaError_t reduce(const float* part, long long rows, long long cols, float* out,
                   cudaStream_t s) {
  reduce_rows<<<dim3(unsigned((cols + 31) / 32)), dim3(32, RED_Y), 0, s>>>(
      part, rows, cols, out);
  return cudaGetLastError();
}

// dims = (B, H, W, Cin, Ce, Cout, rate, then the phase's plan: th, tw, ck,
// stages, nt, smem, warps, splits)
constexpr int N_DIMS = 15;

// geometry from dims; false if the kernel does not take the shape
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
  a.cin_p = (a.Cin + 15) / 16 * 16;
  a.kp = (a.Cin + 31) / 32 * 32;
  a.cout_k = (a.Cout + 15) / 16 * 16;
  if (phase == F2 || phase == B34) {
    if (a.Ce % 8) return false;  // whole 16-byte vectors of every Ce-wide row
    a.th = d[7]; a.tw = d[8]; a.ck = d[9]; a.stages = d[10]; a.nt = d[11];
    a.smem = d[12]; a.warps = d[13];
    if (a.th <= 0 || a.tw <= 0) return false;
    a.twl = a.tw == 16 ? 4 : 3;
    a.tiles_x = (a.W + a.tw - 1) / a.tw;
    a.tiles_y = (a.H + a.th - 1) / a.th;
    a.n_tiles = a.B * a.tiles_x * a.tiles_y;
    const int r = a.rate;
    a.rows = a16((a.th + 2 * r < a.H ? a.th + 2 * r : a.H) *
                 (a.tw + 2 * r < a.W ? a.tw + 2 * r : a.W));
    a.xt_swz = (a.cin_p / 8) % 8 == 4;
    a.xt_ld = a.xt_swz ? a.cin_p : a.cin_p + 8;
    if (phase == B34) a.splits = d[14];
  }
  if (phase == B2 || phase == F1 || phase == F3) {
    if (a.Ce % 8) return false;  // whole 16-byte vectors of Ce-wide rows
    a.th = d[7]; a.tw = d[8];
    a.ck = d[9]; a.stages = d[10]; a.nt = d[11]; a.smem = d[12];
    a.warps = d[13]; a.splits = d[14];
    if (a.ck <= 0) return false;
    a.n_chunks = (a.Ce + a.ck - 1) / a.ck;
  }
  return true;
}

// B2's instantiations (CEB, NT2): B2_NT in kernels/fused_mbconv_train.py
#define B2_CASES(X) X(128, 2) X(128, 4) X(128, 6) X(128, 10) \
                    X(64, 1) X(64, 2) X(64, 3) X(64, 5) X(64, 10)

bool b2_plan_ok(const Args& a) {
  bool inst = false;
#define B2_INST(C, N) inst = inst || (a.ck == C && a.nt == N);
  B2_CASES(B2_INST)
#undef B2_INST
  const int wn2 = B2_WARPS / (a.ck / 16);
  return inst && a.stages >= 2 && a.stages <= 3 && a.warps == B2_WARPS &&
         a.nt * wn2 * 8 >= a.Cout && a.splits >= 1 && a.splits <= 65535 &&
         a.splits <= a.n_groups && a.smem == lay_b2(a).total &&
         size_t(a.smem) <= SMEM_MAX;
}

// F1's plan (train_plan "f1"): 64 channels a warpgroup, one, two or four
// warpgroups, the ring of F1_STAGES tiles, splits within the tiles
bool f1_plan_ok(const Args& a) {
  return (a.ck == 64 || a.ck == 128 || a.ck == 256) && a.warps == a.ck / 16 && a.nt == 0 &&
         a.stages == F1_STAGES && a.splits >= 1 && a.splits <= 65535 &&
         a.splits <= a.n_groups && a.n_chunks <= 65535 &&
         a.smem == lay_f1(a).total && size_t(a.smem) <= SMEM_MAX;
}

// F3's instantiations (NT, CW): n-tiles of 8 a warpgroup (N = 8 NT),
// column groups; F3_CASES in kernels/fused_mbconv_train.py
#define F3_CASES(X) X(4, 1) X(8, 1) X(12, 1) X(20, 1) X(8, 2) X(12, 2) X(20, 2)

// F3's plan: an instantiated (NT, CW) (CW in the plan's tw), 128 pixels a
// block (its th), chunks of 64, 4 warps a warpgroup, a ring of 2 to 4, the
// splits of Cout the block's columns imply
bool f3_plan_ok(const Args& a) {
  bool inst = false;
#define F3_INST(N, C) inst = inst || (a.nt == N && a.tw == C);
  F3_CASES(F3_INST)
#undef F3_INST
  const int nblk = 8 * a.nt * a.tw;
  const long long blocks = (a.P + F3_PM - 1) / F3_PM * a.splits;
  return inst && a.th == F3_PM && a.ck == F3_CK && a.warps == 8 * a.tw && a.stages >= 2 &&
         a.stages <= 4 && a.splits == (a.Cout + nblk - 1) / nblk &&
         blocks <= 0x7fffffffLL && a.smem == lay_f3(a).total &&
         size_t(a.smem) <= SMEM_MAX;
}

int wg_smem(const Args& a) {
  return WG_STAGES * (a16(2 * WG_GP * WG_M) + a16(2 * WG_GP * a.xt_ld));
}

int dx_smem(const Args& a) { return DX_STAGES * (2 * DX_M * DX_K + 2 * a.cin_p * DX_K); }

// the plan train_plan chose, checked: a tile, chunk, ring and accumulator
// this file instantiates, and the shared memory its layout reproduces
bool plan_ok(int phase, const Args& a) {
  const bool tile = (a.th == 16 && a.tw == 16) || (a.th == 8 && a.tw == 16) ||
                    (a.th == 8 && a.tw == 8);
  if (!tile || (a.ck != 16 && a.ck != 32) || a.stages < 2 || a.stages > 3 ||
      a.warps != HALO_WARPS || a.smem != lay_halo(phase, a).total ||
      size_t(a.smem) > SMEM_MAX || (a.rows + 1) * esw(a.ck) > 32767)
    return false;
  if (phase != B34) return true;
  // dx and dW1^T: NT n-tiles a warp, two warps across Cin
  const bool nt = a.nt == 2 || a.nt == 4 || a.nt == 6 || a.nt == 10;
  return nt && 2 * a.nt * 8 >= a.Cin && a.splits >= 1 && a.splits <= 65535 &&
         size_t(wg_smem(a)) <= SMEM_MAX && size_t(dx_smem(a)) <= SMEM_MAX;
}

// The instantiations: TRAIN_TILES and TRAIN_CHUNKS in
// kernels/fused_mbconv_train.py; TP = TH * TW.
template <template <int, int> class K>
cudaError_t launch_halo(const Args& a, cudaStream_t s) {
  const dim3 grid(a.tiles_x * a.tiles_y, a.B);
  const int tp = a.th * a.tw;
#define HALO_CASE(CK_, TP_)                                                   \
  if (a.ck == CK_ && tp == TP_)                                               \
    return run(K<CK_, TP_>::fn(), grid, a.smem, a, s, HALO_THREADS);
  HALO_CASE(16, 64) HALO_CASE(16, 128) HALO_CASE(16, 256)
  HALO_CASE(32, 64) HALO_CASE(32, 128) HALO_CASE(32, 256)
#undef HALO_CASE
  return (cudaError_t)ERR_PLAN;
}
template <int CK_, int TP_> struct F2K {
  static auto fn() { return f2_kernel<CK_, TP_>; }
};
template <int CK_, int TP_> struct B34K {
  static auto fn() { return b34_kernel<CK_, TP_>; }
};

struct Scratch { size_t dvl, part, part2, total; };

Scratch scratch_plan(int phase, const Args& a) {
  Scratch s{0, 0, 0, 0};
  size_t dvl = 0, part = 0, part2 = 0;  // bytes
  const size_t Ce = a.Ce;
  switch (phase) {
    case F1: part = 4 * size_t(a.splits) * 2 * Ce; break;
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

// Scratch bytes phase `phase` needs at dims (B, H, W, Cin, Ce, Cout, rate,
// plan...), or -1 when the kernel does not take the shape.
long long mbt_scratch_bytes(int phase, const int* dims) {
  Args a;
  if (phase < F1 || phase > B34 || !geometry(phase, dims, a)) return -1;
  return (long long)scratch_plan(phase, a).total;
}

// Launch phase `phase` on `stream`.  ptrs, in order (scratch last, where the
// phase needs one):
//   F1:  x, w1, out(2, Ce), scratch
//   F2:  x, w1, a1, c1, wdw, out(2, Ce), dq, scratch
//   F3:  dq, a2, c2, w2^T (Cout x Ce), y
//   B2:  dq, g, y, a2, c2, mu2, rstd2, w2, gA3, k0, k1, t(2, Ce), dw2, ddh, scratch
//   B34: x, dq, ddh, w1, a1, c1, wdw, a2, m0, m1, mu1, rstd1, u(11, Ce), dxp,
//        dw1t, scratch
// dims: N_DIMS ints (geometry above).  Returns 0, ERR_ARGS, ERR_PLAN (a plan
// of train_plan that this file does not reproduce) or the cudaError_t of the
// first launch that failed.
int mbt_launch(int phase, void** ptrs, int n_ptrs, const int* dims, void* stream) {
  static const int want[] = {4, 8, 5, 15, 16};
  Args a;
  if (phase < F1 || phase > B34 || n_ptrs != want[phase] || !geometry(phase, dims, a))
    return ERR_ARGS;
  if ((phase == F2 || phase == B34) && !plan_ok(phase, a)) return ERR_PLAN;
  if (phase == B2 && !b2_plan_ok(a)) return ERR_PLAN;
  if (phase == F1 && !f1_plan_ok(a)) return ERR_PLAN;
  if (phase == F3 && !f3_plan_ok(a)) return ERR_PLAN;
  for (int i = 0; i < n_ptrs; ++i)  // 16-byte copies
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return ERR_ARGS;
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
  cudaError_t e = cudaSuccess;
  switch (phase) {
    case F1: {
      a.x = (const bf16*)P(0); a.w1 = (const bf16*)P(1);
      const dim3 grid(a.n_chunks, a.splits);
      e = a.ck == 64    ? run(f1_kernel<1>, grid, a.smem, a, s, 128)
          : a.ck == 128 ? run(f1_kernel<2>, grid, a.smem, a, s, 256)
                        : run(f1_kernel<4>, grid, a.smem, a, s, 512);
      if (e == cudaSuccess) e = reduce(a.part, a.splits, 2 * Ce, (float*)P(2), s);
      break;
    }
    case F2: {
      a.x = (const bf16*)P(0); a.w1 = (const bf16*)P(1);
      a.a1 = (const float*)P(2); a.c1 = (const float*)P(3); a.wdw = (const float*)P(4);
      a.dq_out = (bf16*)P(6);
      e = launch_halo<F2K>(a, s);
      if (e == cudaSuccess) e = reduce(a.part, a.n_tiles, 2 * Ce, (float*)P(5), s);
      break;
    }
    case F3: {
      a.dq = (const bf16*)P(0); a.a2 = (const float*)P(1); a.c2 = (const float*)P(2);
      a.w2 = (const bf16*)P(3); a.y_out = (bf16*)P(4);
      const dim3 grid(unsigned((a.P + F3_PM - 1) / F3_PM * a.splits));
      e = (cudaError_t)ERR_PLAN;
#define F3_RUN(N, C) \
  if (a.nt == N && a.tw == C) e = run(f3_kernel<8 * N, C>, grid, a.smem, a, s, C * 256);
      F3_CASES(F3_RUN)
#undef F3_RUN
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
      if (e == cudaSuccess) {
        e = (cudaError_t)ERR_PLAN;
#define B2_RUN(C, N)                                                        \
  if (a.ck == C && a.nt == N)                                               \
    e = run(b2_kernel<C, N>, dim3(a.n_chunks, a.splits), a.smem, a, s,     \
            B2_THREADS);
        B2_CASES(B2_RUN)
#undef B2_RUN
      }
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
      e = launch_halo<B34K>(a, s);
      if (e == cudaSuccess) e = reduce(a.part, a.n_tiles, 11 * Ce, (float*)P(12), s);
      if (e == cudaSuccess) {
        const dim3 dgrid(unsigned((a.P + DX_M - 1) / DX_M));
        const dim3 wgrid((a.Ce + WG_M - 1) / WG_M, a.splits);
        const int ds = dx_smem(a), ws = wg_smem(a);
        switch (a.nt) {
#define NT_CASE(N)                                                            \
  case N:                                                                     \
    e = run(dx_kernel<N>, dgrid, ds, a, s, DX_THREADS);                       \
    if (e == cudaSuccess) e = run(wg_kernel<N>, wgrid, ws, a, s, WG_THREADS); \
    break;
          NT_CASE(2) NT_CASE(4) NT_CASE(6) NT_CASE(10)
#undef NT_CASE
          default: e = (cudaError_t)ERR_PLAN;
        }
      }
      if (e == cudaSuccess)
        e = reduce(a.part2, a.splits, Ce * a.Cin, (float*)P(14), s);
      break;
    }
    default: e = (cudaError_t)ERR_ARGS;
  }
  return int(e);
}

const char* mbt_error(int code) {
  switch (code) {
    case ERR_ARGS: return "arguments the fused_mbconv_train kernels do not take";
    case ERR_PLAN: return "a launch plan the fused_mbconv_train kernels do not agree with";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
