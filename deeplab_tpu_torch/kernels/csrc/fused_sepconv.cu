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
// of the kernel.  On chip, every block of 64 output pixels reads all of the
// wpw it multiplies (1.06 MB at 728 -> 728) from L2, and the depthwise taps
// read each staged value nine times from shared memory.
//
// Design (the launch plan, `sepconv_plan` in kernels/fused_mbconv.py, picks
// the Cin chunk, ring depth, pass width and Cout groups per shape from a
// cost model fitted to measured times; this file reproduces its shared
// memory and refuses a plan it does not agree with):
//  - one block of 8 warps per (8 x 8 output tile, image, group of output
//    channels); the plan splits Cout into groups across blocks where A
//    (below) would not fit for all of Cout (Cin 1536), or where that fills
//    the card better than it costs;
//  - Cin runs in chunks of CK (64, 32 or 16).  Each chunk's in-image halo box
//    of x (f32 or bf16, as it lies), its depthwise taps and the k-slice of
//    wpw it multiplies come in by 16-byte cp.async, one commit group an
//    interval, through rings of 2 or 3 stages.  The box is the tile's
//    taps' rows times their columns, clipped to the image: along each axis
//    the union of the three bands the taps reach (one span 8 + 2*rate long
//    where rate <= 8, else three bands of 8 apart), so it never grows with
//    the rate: at most 24 x 24 pixels (the ASPP's rates 6/12/18 on a 32x32
//    map, 36 on 64x64).  Box pixels per output pixel on a 32x32 map
//    (sepconv_halo): rate 1 1.41x, rate 2 1.89x, rates 6, 12 and 18 4.52x,
//    5.06x and 3.52x, where the whole map would be 16.00x;
//  - the depthwise reads its taps from the staged box through a tap table
//    built once per block (the box pixel of each tap of each output pixel,
//    a zero row outside the image), four channels a thread, a column of
//    taps at a time, and sums in f32, dx outer and dy inner (the plain
//    version's order); the bf16 result goes to shared memory as the
//    pointwise's A operand, once per pixel and input channel: all of Cin
//    where the block's Cout takes more than one pass (93 KB at Cin 728),
//    else a ring of two chunks;
//  - the pointwise walks the block's output channels in passes of NP (128
//    or 256) columns.  Each warpgroup multiplies the 64-row A chunk by its
//    N = NP / 2 columns with wgmma (m64nNk16, bf16, f32 accumulation), both
//    operands read by the tensor cores from shared memory: A and wpw's
//    k-slices (wpw transposed by the wrapper, n-major rows of CK) are
//    K-major with the 128-, 64- or 32-byte swizzle of their 16-byte
//    chunks.
//    Each interval issues its products first and waits for them last, so
//    the tensor cores run beside that interval's copies and depthwise (at
//    the middle flow mma.sync at 8 warps ran at a quarter of its rate and
//    took a third of an interval, clock64 stamps, PERF.md).  One barrier
//    an interval, no division in it (slots, chunks and passes are
//    counters).  (Bulk copies, cp.async.bulk a row or a box pixel from one
//    warp, ran the middle flow 1.8x slower: PERF.md.);
//  - each pass ends with bias and activation into the warp's own staging
//    rows (over the x ring, free by then), 16 rows x 8 NT columns at a
//    time, then 16-byte row stores to device memory, with no block barrier.
// Blocks are independent and run in any order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;
using mbconv::cp16;
using mbconv::cp_commit;
using mbconv::cp_wait;
using mbconv::gmma_commit;
using mbconv::gmma_desc;
using mbconv::gmma_fence;
using mbconv::gmma_m64n128;
using mbconv::gmma_m64n64;
using mbconv::gmma_wait;
using mbconv::pin;
using mbconv::swz;

constexpr int NWARPS = 8, NTHREADS = 32 * NWARPS;
constexpr int TILE = 8;     // output tiles of 8 x 8 pixels: wgmma's 64 rows
constexpr int SMEM_MAX = 232448;
constexpr int ST_PAD = 8;  // staging row padding (elements)

enum {
  ERR_ARGS = 100001,  // an argument the kernel does not take
  ERR_PLAN = 100002,  // a launch plan this file does not agree with
};

struct Args {
  const void* x;               // (B, H, W, Cin) f32 or bf16
  const float* wdw;            // (9, Cin), (dy, dx) row-major
  const float* bdw;            // (Cin)
  const bf16* wpw;             // (Cout, Cin): wpw^T, rows of k
  const float* bpw;            // (Cout)
  void* out;                   // (B, H, W, Cout), dtype of x
  int B, H, W, Cin, Cout, rate, pre_relu, act_mid, act_out;
  int th, tw, tiles_x, stages, groups, cg, a_slots, rows, n_chunks;
  // byte offsets into dynamic shared memory
  int o_tab, o_box, o_a, o_xr, o_wr, xstage, x_wd, wstage, wstg;
};

__host__ __device__ inline int align16(int n) { return (n + 15) & ~15; }
__host__ __device__ inline int align1024(int n) { return (n + 1023) & ~1023; }

// The in-image reach of a tile's taps along one axis: the union of the
// bands [t0 + k*r, t0 + k*r + t), k = -1, 0, 1, clipped to [0, n) -- one
// span where r <= t, else three disjoint bands (some possibly empty).
struct Bands {
  int lo[3], len[3], n;
};

__host__ __device__ inline Bands bands_of(int t0, int t, int r, int n) {
  Bands b;
  b.n = 0;
  for (int k = 0; k < 3; ++k) {
    int lo, hi;
    if (r <= t) {
      lo = k == 0 ? t0 - r : 0;
      hi = k == 0 ? t0 + t + r : 0;
    } else {
      lo = t0 + (k - 1) * r;
      hi = lo + t;
    }
    lo = lo < 0 ? 0 : lo;
    hi = hi > n ? n : hi;
    b.lo[k] = lo;
    b.len[k] = hi > lo ? hi - lo : 0;
    b.n += b.len[k];
  }
  return b;
}

// position of coordinate v in the bands, or -1
__device__ __forceinline__ int band_pos(const Bands& b, int v) {
  int off = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (v >= b.lo[k] && v < b.lo[k] + b.len[k]) return off + v - b.lo[k];
    off += b.len[k];
  }
  return -1;
}

// coordinate at position i (0 <= i < b.n)
__device__ __forceinline__ int band_at(const Bands& b, int i) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (i < b.len[k]) return b.lo[k] + i;
    i -= b.len[k];
  }
  return b.lo[2] + i;
}

// The largest box (pixels) over the tiles of the map: sepconv_box in
// kernels/fused_mbconv.py.
inline int max_box(int H, int W, int th, int tw, int r) {
  int my = 0, mx = 0;
  for (int y0 = 0; y0 < H; y0 += th) {
    const int n = bands_of(y0, th, r, H).n;
    my = n > my ? n : my;
  }
  for (int x0 = 0; x0 < W; x0 += tw) {
    const int n = bands_of(x0, tw, r, W).n;
    mx = n > mx ? n : mx;
  }
  return my * mx;
}

// pass width NP: two warpgroups of N = 16 NT columns
__host__ __device__ constexpr int pass_np(int NT) { return 32 * NT; }

// The layout sepconv_smem (kernels/fused_mbconv.py) computes; returns the
// total bytes.  esz: bytes of an x (and output) element.  The warps'
// output staging (16 rows of a warp's NT n-tiles each) reuses the x ring,
// which no pass reads after the first's depthwise.
__host__ inline int smem_layout(Args& a, int ck, int nt, int esz) {
  const int M = TILE * TILE, NP = pass_np(nt);
  int o = 0;
  a.o_tab = o; o += align16(4 * 9 * M);
  a.o_box = o; o += align16(4 * a.rows);
  o = align1024(o);                            // the wgmma operands' swizzle
  a.o_a = o;   o += align16(2 * a.a_slots * M * ck);
  a.x_wd = align16((a.rows + 1) * ck * esz);   // box, then wdw [9][CK], bdw [CK]
  a.xstage = a.x_wd + align16(4 * 10 * ck);
  a.wstg = 16 * (nt * 8 + ST_PAD) * esz;       // one warp's staging
  const int staging = NWARPS * a.wstg;
  const int xr = a.stages * a.xstage;
  a.o_xr = o;  o += align16(xr > staging ? xr : staging);
  a.wstage = 2 * ck * NP;
  o = align1024(o);
  a.o_wr = o;  o += a.stages * a.wstage;
  return o;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

__device__ __forceinline__ float4 relu4(float4 v) {
  return make_float4(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f), fmaxf(v.z, 0.f),
                     fmaxf(v.w, 0.f));
}

// T: the x and output element type; CK input channels a chunk; each of the
// two warpgroups multiplies the tile's M = 64 pixels by N = 16 NT output
// channels a pass (NP = 32 NT).
template <typename T, int CK, int NT>
__global__ void __launch_bounds__(NTHREADS, NT == 4 ? 2 : 1)
fused_sepconv_kernel(const Args a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr int M = TILE * TILE, NP = pass_np(NT);
  constexpr int ESZ = sizeof(T), EPV = 16 / ESZ;  // elements a 16-byte vector
  constexpr int VPP = CK / EPV;                    // vectors a box pixel
  constexpr int CQ = CK / 4;                       // channel quads a chunk
  constexpr int PSTEP = NTHREADS / CQ;             // depthwise pixels in flight
  constexpr int KV = CK / 8;                       // 16-byte chunks a wpw row
  int* tab = reinterpret_cast<int*>(smem + a.o_tab);
  int* boxpix = reinterpret_cast<int*>(smem + a.o_box);
  bf16* As = reinterpret_cast<bf16*>(smem + a.o_a);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int grp = blockIdx.x % a.groups, tile = blockIdx.x / a.groups;
  const int b = blockIdx.y;
  const int ty0 = (tile / a.tiles_x) * a.th, tx0 = (tile % a.tiles_x) * a.tw;
  const int H = a.H, W = a.W, r = a.rate, S = a.stages;
  const int n_lo = grp * a.cg;
  const int n_hi = min(n_lo + a.cg, a.Cout);
  const int passes = (n_hi - n_lo + NP - 1) / NP;
  const int n_chunks = a.n_chunks, total = passes * n_chunks;
  const Bands by = bands_of(ty0, a.th, r, H), bx = bands_of(tx0, a.tw, r, W);
  const int nx = bx.n, nv = by.n * bx.n;
  const T* x = static_cast<const T*>(a.x);

  // the tap table (tap q = dy*3 + dx) and the box's pixels; zero rows
  for (int i = tid; i < M * 9; i += NTHREADS) {
    const int p = i / 9, q = i % 9;
    const int py = ty0 + p / a.tw, px = tx0 + p % a.tw;
    const int yy = py + (q / 3 - 1) * r, xx = px + (q % 3 - 1) * r;
    int row = a.rows;
    if (py < H && px < W && yy >= 0 && yy < H && xx >= 0 && xx < W) {
      const int iy = band_pos(by, yy), ix = band_pos(bx, xx);
      if (iy >= 0 && ix >= 0) row = iy * nx + ix;
    }
    tab[i] = row;
  }
  for (int i = tid; i < nv; i += NTHREADS)
    boxpix[i] = (b * H + band_at(by, i / nx)) * W + band_at(bx, i % nx);
  for (int s = 0; s < S; ++s) {
    T* zr = reinterpret_cast<T*>(smem + a.o_xr + s * a.xstage) + a.rows * CK;
    for (int i = tid; i < CK; i += NTHREADS) zr[i] = T(0.f);
  }
  __syncthreads();

  // The commit group of interval i holds x chunk i + S - 1 and wpw slice
  // i + S - 2, S - 1 intervals before their use.  The streams keep their
  // chunk, pass and slot as counters: no division in the loop.
  int x_seq = 0, x_slot = 0;
  int w_seq = 0, w_q = 0, w_slot = 0, w_n0 = n_lo;
  auto issue = [&](int i) {
    if (i + S - 1 == x_seq && x_seq < n_chunks) {
      unsigned char* st = smem + a.o_xr + x_slot * a.xstage;
      T* xs = reinterpret_cast<T*>(st);
      const int c0 = x_seq * CK;
      for (int e = tid; e < nv * VPP; e += NTHREADS) {
        const int hp = e / VPP, v = e % VPP, ch = c0 + v * EPV;
        const bool in = ch < a.Cin;  // Cin % 8 == 0: whole vectors
        cp16(xs + hp * CK + v * EPV,
             in ? (const void*)(x + (size_t)boxpix[hp] * a.Cin + ch) : a.x,
             in ? 16 : 0);
      }
      float* wd = reinterpret_cast<float*>(st + a.x_wd);
      for (int e = tid; e < 10 * CQ; e += NTHREADS) {
        const int row = e / CQ, q = e % CQ, ch = c0 + 4 * q;
        const bool in = ch < a.Cin;
        const float* src = row < 9 ? a.wdw + (size_t)row * a.Cin + ch : a.bdw + ch;
        cp16(wd + row * CK + 4 * q, in ? (const void*)src : (const void*)a.wdw,
             in ? 16 : 0);
      }
      ++x_seq;
      x_slot = x_slot + 1 == S ? 0 : x_slot + 1;
    }
    if (i + S - 2 == w_seq && w_seq < total) {
      const int w = min(NP, n_hi - w_n0), k0 = w_q * CK;
      bf16* ws = reinterpret_cast<bf16*>(smem + a.o_wr + w_slot * a.wstage);
      const bf16* src = a.wpw + (size_t)w_n0 * a.Cin + k0;  // wpw^T rows
      for (int e = tid; e < NP * KV; e += NTHREADS) {
        const int n = e / KV, c = e % KV;
        if (n >= w) continue;  // columns past the pass: never stored
        const bool in = k0 + 8 * c < a.Cin;
        cp16(ws + n * CK + 8 * (c ^ swz<CK>(n)),
             in ? (const void*)(src + (size_t)n * a.Cin + 8 * c) : (const void*)a.wpw,
             in ? 16 : 0);
      }
      ++w_seq;
      w_slot = w_slot + 1 == S ? 0 : w_slot + 1;
      if (++w_q == n_chunks) {
        w_q = 0;
        w_n0 += NP;
      }
    }
  };

  // depthwise of the chunk in x slot xslot into A slot aslot (rows
  // swizzled for ldmatrix):
  // four channels a thread, its PP pixels' sums side by side, the taps
  // walked a column (dx) at a time so that only that column's weights and
  // values are live
  constexpr int PP = (M + PSTEP - 1) / PSTEP;
  auto depthwise = [&](int xslot, int aslot) {
    const unsigned char* st = smem + a.o_xr + xslot * a.xstage;
    const T* xs = reinterpret_cast<const T*>(st);
    const float* wd = reinterpret_cast<const float*>(st + a.x_wd);
    bf16* Ak = As + aslot * M * CK;
    const int c4 = tid % CQ, p0 = tid / CQ;
    const float4 bias = load4(wd + 9 * CK + 4 * c4);
    float4 s[PP];
#pragma unroll
    for (int jp = 0; jp < PP; ++jp) s[jp] = bias;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      float4 w[3];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) w[dy] = load4(wd + (dy * 3 + dx) * CK + 4 * c4);
#pragma unroll
      for (int jp = 0; jp < PP; ++jp) {
        const int p = min(p0 + jp * PSTEP, M - 1);
        float4 v[3];
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
          v[dy] = load4(xs + tab[p * 9 + dy * 3 + dx] * CK + 4 * c4);
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const float4 u = a.pre_relu ? relu4(v[dy]) : v[dy];
          s[jp].x += u.x * w[dy].x;
          s[jp].y += u.y * w[dy].y;
          s[jp].z += u.z * w[dy].z;
          s[jp].w += u.w * w[dy].w;
        }
      }
    }
#pragma unroll
    for (int jp = 0; jp < PP; ++jp) {
      const int p = p0 + jp * PSTEP;
      if (p >= M) break;
      const float4 o = a.act_mid ? relu4(s[jp]) : s[jp];
      const __nv_bfloat162 lo = __floats2bfloat162_rn(o.x, o.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(o.z, o.w);
      uint2 u;
      u.x = *reinterpret_cast<const uint32_t*>(&lo);
      u.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(Ak + p * CK + 8 * ((c4 >> 1) ^ swz<CK>(p)) +
                                4 * (c4 & 1)) = u;
    }
  };

  float acc[2][NT][4];

  // pointwise of one step: acc += A slot x wpw slot, each warpgroup's N
  // columns by wgmma, issued here and waited for by product_wait
  auto product = [&](int aslot, int wslot) {
    const bf16* Ak = As + aslot * M * CK;
    const bf16* Bw = reinterpret_cast<const bf16*>(smem + a.o_wr + wslot * a.wstage) +
                     (warp >> 2) * (16 * NT) * CK;
    float(&d)[8 * NT] = reinterpret_cast<float(&)[8 * NT]>(acc);
    pin(d);
    gmma_fence();
#pragma unroll
    for (int kk = 0; kk < CK; kk += 16) {
      if constexpr (NT == 8)
        gmma_m64n128(d, gmma_desc(Ak + kk, CK), gmma_desc(Bw + kk, CK));
      else
        gmma_m64n64(d, gmma_desc(Ak + kk, CK), gmma_desc(Bw + kk, CK));
    }
    gmma_commit();
  };
  auto product_wait = [&]() {
    gmma_wait();
    pin(reinterpret_cast<float(&)[8 * NT]>(acc));
  };

  // bias, activation and the cast into the warp's staging rows (one
  // m-tile at a time), then 16-byte row stores: no block barrier
  auto epilogue = [&](int n0) {
    const int w = min(NP, n_hi - n0);
    constexpr int LDS = NT * 8 + ST_PAD;
    T* stg = reinterpret_cast<T*>(smem + a.o_xr + warp * a.wstg);
    T* out = static_cast<T*>(a.out);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      // round m: the warp's 16 rows, NT n-tiles from column c_lo (wgmma's
      // d[4j + q] is n-tile j: acc[j / NT][j % NT][q])
      const int r_lo = (warp & 3) * 16;
      const int c_lo = (warp >> 2) * 16 * NT + m * 8 * NT;
      const int vw = max(0, min(NT * 8, w - c_lo)) / EPV;  // vectors a row
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = c_lo + j * 8 + 2 * t;
        if (col >= w) continue;
        const float b0 = __ldg(a.bpw + n0 + col), b1 = __ldg(a.bpw + n0 + col + 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v0 = acc[m][j][2 * h] + b0, v1 = acc[m][j][2 * h + 1] + b1;
          if (a.act_out) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          store2(stg + (g + 8 * h) * LDS + j * 8 + 2 * t, v0, v1);
        }
      }
      __syncwarp();
      // VWM vectors a full row, 32 / VWM rows a warp-wide store (tiles are
      // 8 pixels wide)
      constexpr int VWM = NT * 8 / EPV, RPS = 32 / VWM;
      const int v = lane % VWM;
#pragma unroll
      for (int r0 = 0; r0 < 16; r0 += RPS) {
        const int row = r0 + lane / VWM;
        const int p = r_lo + row;
        const int py = ty0 + (p >> 3), px = tx0 + (p & 7);
        if (v < vw && py < H && px < W)
          *reinterpret_cast<uint4*>(out + ((size_t)(b * H + py) * W + px) * a.Cout +
                                    n0 + c_lo + v * EPV) =
              *reinterpret_cast<const uint4*>(stg + row * LDS + v * EPV);
      }
      __syncwarp();
    }
  };

  // prologue: the groups of intervals 1 - S .. -1 (x chunks 0 .. S - 2,
  // wpw slices 0 .. S - 3)
  for (int i = 1 - S; i < 0; ++i) {
    issue(i);
    cp_commit();
  }
  // the depthwise's and the products' slots, position and pass: counters
  int d_xslot = 0, d_aslot = 0;
  int p_q = 0, p_aslot = 0, p_wslot = 0, p_n0 = n_lo;
  for (int i = 0; i <= total; ++i) {
    // x chunk i and wpw slice i - 1 landed (their group is S - 1 old)
    if (S == 3) cp_wait<1>(); else cp_wait<0>();
    // the depthwise's A stores and the landed copies, seen by wgmma's
    // (asynchronous) reads of shared memory
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // ... for every thread; interval i - 1 done
    if (i >= 1) {     // the products first: wgmma runs beside what follows
      if (p_q == 0) {
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[m][j][q] = 0.f;
      }
      product(p_aslot, p_wslot);
    }
    issue(i);
    cp_commit();
    if (i < n_chunks) {
      depthwise(d_xslot, d_aslot);
      d_xslot = d_xslot + 1 == S ? 0 : d_xslot + 1;
      d_aslot = d_aslot + 1 == a.a_slots ? 0 : d_aslot + 1;
    }
    if (i >= 1) {
      product_wait();
      p_aslot = p_aslot + 1 == a.a_slots ? 0 : p_aslot + 1;
      p_wslot = p_wslot + 1 == S ? 0 : p_wslot + 1;
      if (++p_q == n_chunks) {
        epilogue(p_n0);
        p_q = 0;
        p_n0 += NP;
      }
    }
  }
  cp_wait<0>();
}

template <typename T, int CK, int NT>
cudaError_t launch_k(const Args& a, int smem, cudaStream_t stream) {
  auto kern = fused_sepconv_kernel<T, CK, NT>;
  // the largest size set for this instantiation, per device
  static int smem_set[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64 || smem > smem_set[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    if (dev < 64) smem_set[dev] = smem;
  }
  const int tiles_y = (a.H + a.th - 1) / a.th;
  kern<<<dim3(a.tiles_x * tiles_y * a.groups, a.B), NTHREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// The instantiations: SEPCONV_CHUNKS and SEPCONV_NT in
// kernels/fused_mbconv.py.
template <typename T>
cudaError_t launch_t(const Args& a, int ck, int nt, int smem, cudaStream_t s) {
#define SEP_CASE(CK_, NT_) \
  if (ck == CK_ && nt == NT_) return launch_k<T, CK_, NT_>(a, smem, s);
  SEP_CASE(64, 4) SEP_CASE(64, 8) SEP_CASE(32, 4) SEP_CASE(32, 8)
  SEP_CASE(16, 4) SEP_CASE(16, 8)
#undef SEP_CASE
  return (cudaError_t)ERR_PLAN;
}

}  // namespace

extern "C" {

// Returns 0 or an error code (fused_sepconv_error names it).  The plan
// (th, tw, ck, stages, nt, groups, cg, smem) is kernels/fused_mbconv.py's
// sepconv_plan; a plan whose shared memory this file's layout does not
// reproduce, or whose tile, chunk or accumulator it does not instantiate,
// is refused.
int fused_sepconv_launch(const void* x, const void* wdw, const void* bdw,
                         const void* wpw, const void* bpw, void* out, int B,
                         int H, int W, int Cin, int Cout, int rate,
                         int pre_relu, int act_mid, int act_out, int x_bf16,
                         int th, int tw, int ck, int stages, int nt,
                         int groups, int cg, int smem, void* stream) {
  const long long P = (long long)B * H * W;
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || Cin <= 0 || Cin % 8 ||
      Cout <= 0 || Cout % 8 || rate < 1 || P >= (1LL << 31))
    return ERR_ARGS;
  const void* ptrs[] = {x, wdw, bdw, wpw, out};
  for (const void* p : ptrs)
    if ((uintptr_t)p % 16) return ERR_ARGS;
  Args a;
  a.x = x;
  a.wdw = static_cast<const float*>(wdw);
  a.bdw = static_cast<const float*>(bdw);
  a.wpw = static_cast<const bf16*>(wpw);
  a.bpw = static_cast<const float*>(bpw);
  a.out = out;
  a.B = B; a.H = H; a.W = W; a.Cin = Cin; a.Cout = Cout; a.rate = rate;
  a.pre_relu = pre_relu; a.act_mid = act_mid; a.act_out = act_out;
  a.th = th; a.tw = tw; a.stages = stages; a.groups = groups; a.cg = cg;
  const bool tile_ok = th == TILE && tw == TILE;
  if (!tile_ok || (ck != 16 && ck != 32 && ck != 64) || (nt != 4 && nt != 8) ||
      stages < 2 || stages > 3 || groups < 1 || cg <= 0 || cg % 8 ||
      (long long)groups * cg < Cout || (long long)(groups - 1) * cg >= Cout)
    return ERR_PLAN;
  a.tiles_x = (W + tw - 1) / tw;
  const long long blocks = (long long)a.tiles_x * ((H + th - 1) / th) * groups;
  if (blocks >= (1LL << 31)) return ERR_PLAN;
  a.n_chunks = (Cin + ck - 1) / ck;
  const int NP = pass_np(nt);
  a.a_slots = (cg + NP - 1) / NP > 1 ? a.n_chunks : 2;
  a.rows = max_box(H, W, th, tw, rate);
  if (smem_layout(a, ck, nt, x_bf16 ? 2 : 4) != smem || smem > SMEM_MAX)
    return ERR_PLAN;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = x_bf16 ? launch_t<bf16>(a, ck, nt, smem, s)
                               : launch_t<float>(a, ck, nt, smem, s);
  return int(e);
}

const char* fused_sepconv_error(int code) {
  switch (code) {
    case ERR_ARGS: return "arguments the fused_sepconv kernel does not take";
    case ERR_PLAN: return "a launch plan the fused_sepconv kernel does not agree with";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
