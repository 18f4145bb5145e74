// 3x3x3, stride-1, zero-pad-1, channel-last 3D convolution for Hopper (sm_90a)
// as an implicit GEMM on the tensor cores (mma.sync, TF32), with an optional
// fused epilogue (bias + LeakyReLU(0.2) + per-channel sum and sum of squares
// of the stored values).
//
// Replaces two TPU kernels of the JAX package (spsg_tpu/ops/pallas_conv.py):
//   _fwd_kernel            (launcher _conv3x3_fwd_impl)        -> STATS = false
//   _fwd_act_stats_kernel  (launcher _conv3x3_act_stats_impl)  -> STATS = true
// As in the JAX package the STATS = false kernel also computes the input
// gradient of both: dx = conv(dy, w flipped in space, Cin and Cout swapped).
// The weight gradient is csrc/conv3x3_dw.cu.
// Both compute y[b,z,y,x,:] = sum over the 27 taps (dz,dy,dx) and Cin of
// x[b,z+dz-1,y+dy-1,x+dx-1,c] * w[dz,dy,dx,c,:], accumulated in float32 and
// stored in the input type (float32 or bfloat16).
//
// What bounds it on an H100: operations. At the generator's shapes a voxel
// costs 2*27*Cin*Cout flops against (Cin+Cout) stored elements, hundreds of
// flops per byte. float32 storage is computed as 3xTF32 (below), three tensor
// core passes per product, so its least time is 3*flops / 495 TFLOP/s (dense
// TF32); bfloat16 storage takes one pass.
//
// The GEMM. M = the voxels of a block's tile (one z-plane, TY x TX: 64, 128
// or, for N <= 16, 256 voxels), N = up to 104 output channels (Cout padded to
// 8; one block spans all of Cout <= 104, x is staged once per tile, unless the
// tile plan splits N in two to fill the card), K = 27 taps x Cin walked in
// units of (8 input channels, dz): a unit stages one halo plane of the input
// and the 9 x 8 x N weights of its (dy,dx) taps, then runs one k8 step per tap.
// 128 threads = 4 warps; a warp owns MT m16 tiles (rows) x NT n8 tiles (all of
// the block's N) and issues mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32. Cin is
// padded to 8 per unit (zeros in shared memory): Cin = 1 or 3 (dx of the
// heads) wastes up to 8x of the MMA work; taps are not packed into k, those
// layers are bound by bytes and by per-block overheads, not by the MMAs.
//
// 3xTF32 (float32 storage). Each operand v is split at fragment load into
// hi = v with its 13 low bits cleared (TF32, truncated) and lo = v - hi (exact)
// with its 13 low bits cleared; the product is lo*hi' + hi*lo' + hi*hi' (in
// that order), lo*lo' and the bits below lo dropped: ~2^-20 relative per
// product, ~5e-6 absolute on unit-variance outputs against the 1e-4 tolerance
// (one TF32 pass alone is ~1e-3 off; tests/test_torch_conv3x3_tf32.py emulates
// both on the CPU). The split costs 3 instructions a value; cvt.rna.tf32.f32
// (round to nearest) compiles to 4 for each of the two roundings and was
// slower at every shape, for accuracy the tolerance does not need. It is done at fragment
// load: splitting once at staging (hi / lo arrays in shared memory) doubles the
// shared-memory reads and halves the resident blocks, and was slower at every
// shape. The tensor core truncates as it accumulates, so the passes of a group
// of taps go into temporaries that start from 0 and are added to the float32
// accumulators with a rounded add (see TG below).
// bfloat16 storage: a bfloat16 value is exactly a TF32 value, so one pass with
// exact products gives the float32 sum of the stored inputs.
//
// Shared memory, per stage: the halo plane [TY+2][TX+2][KSTR] (channel
// innermost; KSTR = 12 floats, so the 8 rows x 4 k of an A-fragment load hit
// 32 distinct banks; 8 bfloat16 = 16 bytes) and the weights [9 taps][8][NS],
// NS >= N and NS = 8 (mod 32) (B-fragment loads: 4 k x 8 n on 32 banks).
// Two stages (double buffering across units; three or four were slower: fewer
// resident blocks). Budget, float32: 128 voxels, N = 104: 2 x (10*18*12*4 +
// 72*104*4) = 2 x 38,592 = 77,184 bytes (two blocks an SM); 128 voxels,
// N = 40: 2 x 20,160 = 40,320; 256 voxels, N = 16: 2 x (18*18*12*4 + 72*40*4)
// = 54,144. The halo's zeros (volume edge, channels past Cin, columns past
// Cout) are written by the copies themselves; there is no padded copy of x.
// Offsets into x and y are 64 bit.
//
// Staging: cp.async, 16-byte copies where a row (Cin or Cout floats) allows
// them and the pointer is 16-byte aligned, else 4-byte copies, with src-size 0
// (zero fill) at the edges; unit u+1 is in flight while unit u is computed.
// bfloat16 (off the generator's path) is staged with plain loads and stores in
// the same two-stage loop. Planes outside the volume are neither staged nor
// computed.
//
// Registers: tiles of up to 10 accumulator fragments (MT*NT) are held to 128
// registers a thread, 4 blocks an SM; the N = 104 tiles take what they need
// (up to 255; ptxas reports a few bytes of spills in some variants, listed by
// chip_smoke.py's build phase).
//
// Tile plan (make_plan): M and the split of N are chosen at launch from the SM
// count and cudaOccupancyMaxActiveBlocksPerMultiprocessor by a cost model
// (padded work of a block x the resident slots the grid occupies in whole
// waves), so the small (32,16,16) layers at batch 1 get 256 blocks for 132 SMs.
//
// Epilogue from the accumulator fragment (rows gid, gid+8; columns 2*tig,
// 2*tig+1): bias, LeakyReLU with the slope from v > 0, round to the stored
// type, store. Statistics: blocks run in no order, so each block reduces the
// stored values of its tile (registers -> warp shuffles -> shared memory, all
// in a fixed order) and writes one partial row; reduce_partials_kernel sums
// the rows in a fixed order. No atomics: results repeat bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int KC = 8;  // input channels per unit: the k of one mma
constexpr int kStages = 2;
constexpr int kMaxNT = 13;  // n8 tiles a block spans at most (104 channels)
// registers: tiles of up to 10 accumulator fragments are held to 128 a thread
// (4 blocks an SM); wider tiles are not capped
constexpr int kSmallTiles = 10;
template <int MT, int NT>
constexpr int min_blocks() { return MT * NT <= kSmallTiles ? 4 : 1; }

template <typename T>
struct Store;
template <>
struct Store<float> {
  static constexpr int KSTR = 12;  // plane elements per voxel (8 used)
  static constexpr bool kSplit = true;
};
template <>
struct Store<__nv_bfloat16> {
  static constexpr int KSTR = 8;
  static constexpr bool kSplit = false;
};

// row stride (elements) of the staged weights: >= npad and = 8 (mod 32)
__host__ __device__ inline int wstride(int npad) { return ((npad + 23) / 32) * 32 + 8; }

__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// value as it will read back from storage of type T
__device__ __forceinline__ float stored(float v, const float*) { return v; }
__device__ __forceinline__ float stored(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void st1(float* p, float v) { *p = v; }
__device__ __forceinline__ void st1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// A fragments of one tap: a0 (gid, tig), a1 (gid+8, tig), a2 (gid, tig+4),
// a3 (gid+8, tig+4) of each m16 tile, split (float32) or as they are (a
// bfloat16 is a TF32 value)
template <typename T, int MT>
__device__ __forceinline__ void load_a(const T* pl, const int (&aoff)[MT][2], int toff,
                                       uint32_t (&hi)[MT][4], uint32_t (&lo)[MT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const float v[4] = {ldf(pl + aoff[mt][0] + toff), ldf(pl + aoff[mt][1] + toff),
                        ldf(pl + aoff[mt][0] + toff + 4), ldf(pl + aoff[mt][1] + toff + 4)};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (Store<T>::kSplit)
        split(v[j], hi[mt][j], lo[mt][j]);
      else
        hi[mt][j] = __float_as_uint(v[j]);
    }
  }
}

// B fragment of one n8 tile: b0 (k = tig, n = gid), b1 (k = tig + 4, n = gid)
template <typename T>
__device__ __forceinline__ void load_b(const T* p, int ns, uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  const float b[2] = {ldf(p), ldf(p + 4 * ns)};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if constexpr (Store<T>::kSplit)
      split(b[j], hi[j], lo[j]);
    else
      hi[j] = __float_as_uint(b[j]);
  }
}

// d += a * b: 3xTF32 (lo*hi + hi*lo, then hi*hi) for float32, one pass for bfloat16
template <typename T>
__device__ __forceinline__ void passes(float (&d)[4], const uint32_t (&ahi)[4],
                                       const uint32_t (&alo)[4], const uint32_t (&bhi)[2],
                                       const uint32_t (&blo)[2]) {
  if constexpr (Store<T>::kSplit) {
    mma(d, alo, bhi[0], bhi[1]);
    mma(d, ahi, blo[0], blo[1]);
  }
  mma(d, ahi, bhi[0], bhi[1]);
}

struct Geom {
  int Z, Y, X, Cin, Cout;
  int b, z, y0, x0, co0;  // this block
  int HY, HX, NS;
  bool vec_x, vec_w;  // 16-byte copies allowed
};

// Stage unit (c0, dz): the halo plane gz = z + dz - 1 (known to lie in the
// volume) and the weights of its 9 taps for channels c0..c0+7, columns
// co0..co0+NPAD-1; zeros wherever the source is outside.
template <typename T, int NPAD>
__device__ __forceinline__ void stage_unit(T* plane, T* wts, const T* __restrict__ x,
                                           const T* __restrict__ w, const Geom& g, int c0,
                                           int dz, int tid) {
  constexpr int KSTR = Store<T>::KSTR;
  const int gz = g.z + dz - 1;
  const long long zoff = ((long long)g.b * g.Z + gz) * g.Y;
  const int warp = tid >> 5, lane = tid & 31;
  // the plane row by row, one warp a row; along a row (x, channel part) with
  // the part fastest: 2 parts of 4 channels (16-byte copies) or 8 of 1
  const int shift = g.vec_x ? 1 : 3;
  for (int hy = warp; hy < g.HY; hy += kWarps) {
    const int gy = g.y0 + hy - 1;
    const bool rowok = gy >= 0 && gy < g.Y;
    const T* row = x + (rowok ? (zoff + gy) * g.X * (long long)g.Cin : 0);
    T* dst = plane + hy * g.HX * KSTR;
    for (int j = lane; j < (g.HX << shift); j += 32) {
      const int hx = j >> shift, part = j & ((1 << shift) - 1);
      const int gx = g.x0 + hx - 1, c = c0 + (part << (3 - shift));
      const bool ok = rowok && gx >= 0 && gx < g.X && c < g.Cin;
      const T* src = ok ? row + (long long)gx * g.Cin + c : x;
      if constexpr (Store<T>::kSplit) {
        if (g.vec_x)
          cp16(dst + hx * KSTR + part * 4, src, ok);
        else
          cp4(dst + hx * KSTR + part, src, ok);
      } else {
        dst[hx * KSTR + part] = ok ? *src : __float2bfloat16_rn(0.f);
      }
    }
  }
  if constexpr (Store<T>::kSplit) {
    if (g.vec_w) {  // Cout % 4 == 0
      constexpr int Q = NPAD / 4;
      for (int i = tid; i < 9 * KC * Q; i += kThreads) {
        const int r = i / Q, q = i - r * Q;  // r = tap * 8 + k
        const int c = c0 + (r & 7), co = g.co0 + q * 4;
        const bool ok = c < g.Cin && co < g.Cout;
        const T* src = ok ? w + ((long long)(dz * 9 + (r >> 3)) * g.Cin + c) * g.Cout + co : w;
        cp16(wts + r * g.NS + q * 4, src, ok);
      }
    } else {
      for (int i = tid; i < 9 * KC * NPAD; i += kThreads) {
        const int r = i / NPAD, n = i - r * NPAD;
        const int c = c0 + (r & 7), co = g.co0 + n;
        const bool ok = c < g.Cin && co < g.Cout;
        const T* src = ok ? w + ((long long)(dz * 9 + (r >> 3)) * g.Cin + c) * g.Cout + co : w;
        cp4(wts + r * g.NS + n, src, ok);
      }
    }
  } else {  // bfloat16: plain loads and stores, element by element
    const T zero = __float2bfloat16_rn(0.f);
    for (int i = tid; i < 9 * KC * NPAD; i += kThreads) {
      const int r = i / NPAD, n = i - r * NPAD;
      const int c = c0 + (r & 7), co = g.co0 + n;
      const bool ok = c < g.Cin && co < g.Cout;
      wts[r * g.NS + n] =
          ok ? w[((long long)(dz * 9 + (r >> 3)) * g.Cin + c) * g.Cout + co] : zero;
    }
  }
}

template <typename T, int MT, int NT, bool STATS>
__global__ void __launch_bounds__(kThreads, min_blocks<MT, NT>())
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const float* __restrict__ bias, T* __restrict__ y,
               float* __restrict__ partials, int Z, int Y, int X, int Cin, int Cout,
               int TX, int tilesX, int tilesY) {
  constexpr int NPAD = NT * 8;
  constexpr int BM = kWarps * MT * 16;  // voxels of the tile
  constexpr int KSTR = Store<T>::KSTR;
  // The tensor core truncates as it accumulates, so the passes of TG taps
  // start from 0 in temporaries that join the sum by a rounded float add: the
  // truncation does not build up over the 27 * Cin / 8 steps (one accumulator
  // over all of them missed the 1e-4 tolerance at Cin = 100). float32 tiles of 4 or more
  // fragments take all 9 taps of a unit (fewest adds; the fragments are
  // independent chains in flight); smaller tiles and bfloat16 a row of 3.
  constexpr int TG = Store<T>::kSplit && MT * NT >= 4 ? 9 : 3;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;  // fragment row (A, C) / column (B)
  const int tig = lane & 3;   // fragment k (A, B) / column pair (C)

  Geom g;
  g.Z = Z; g.Y = Y; g.X = X; g.Cin = Cin; g.Cout = Cout;
  int t = blockIdx.x;
  const int tileX = t % tilesX;
  t /= tilesX;
  const int tileY = t % tilesY;
  t /= tilesY;
  g.z = t % Z;
  g.b = t / Z;
  const int TY = BM / TX;
  g.x0 = tileX * TX;
  g.y0 = tileY * TY;
  g.co0 = blockIdx.y * NPAD;
  g.HX = TX + 2;
  g.HY = TY + 2;
  g.NS = wstride(NPAD);
  // 16-byte copies: float32 rows of a multiple of 4 elements, aligned
  g.vec_x = Store<T>::kSplit && Cin % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  g.vec_w = Store<T>::kSplit && Cout % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const int plane_elems = g.HY * g.HX * KSTR;
  const int stage_elems = plane_elems + 9 * KC * g.NS;

  // plane offset of this thread's A rows (tap (0,0), k = tig): rows gid, gid+8
  // of each of its m16 tiles; row r of the tile is voxel (r / TX, r % TX)
  int aoff[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (warp * MT + mt) * 16 + gid + 8 * h;
      const int ty = r / TX, tx = r - ty * TX;
      aoff[mt][h] = (ty * g.HX + tx) * KSTR + tig;
    }

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.f;

  // units (chunk of 8 input channels, dz), dz fastest; a plane outside the
  // volume contributes nothing and is skipped
  const int units = 3 * ((Cin + KC - 1) / KC);
  auto live = [&](int u) {
    const int gz = g.z + u % 3 - 1;
    return u < units && gz >= 0 && gz < Z;
  };
  // one commit group a unit (empty where nothing is staged), so that
  // wait_group<kStages - 1> always means "unit u has landed"
  auto stage = [&](int u) {
    if (live(u)) {
      T* base = smem + (u % kStages) * stage_elems;
      stage_unit<T, NPAD>(base, base + plane_elems, x, w, g, (u / 3) * KC, u % 3, tid);
    }
    cp_commit();
  };

#pragma unroll
  for (int u = 0; u < kStages - 1; ++u) stage(u);
  for (int u = 0; u < units; ++u) {
    // the buffer of unit u + kStages - 1 was read by unit u - 1, before the
    // barrier that closed it
    stage(u + kStages - 1);
    cp_wait<kStages - 1>();
    __syncthreads();
    if (live(u)) {
      const T* pl = smem + (u % kStages) * stage_elems;
      const T* wt = pl + plane_elems;
      // TG taps (3 or 9) into one set of temporaries
      float d[MT][NT][4];
#pragma unroll 1
      for (int dy = 0; dy < 3; ++dy) {
        if (TG == 3 || dy == 0) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int j = 0; j < 4; ++j) d[mt][nt][j] = 0.f;
        }
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          uint32_t ahi[MT][4], alo[MT][4];
          load_a<T, MT>(pl, aoff, (dy * g.HX + dx) * KSTR, ahi, alo);
          const T* wrow = wt + ((dy * 3 + dx) * KC + tig) * g.NS + gid;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            uint32_t bhi[2], blo[2];
            load_b<T>(wrow + nt * 8, g.NS, bhi, blo);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) passes<T>(d[mt][nt], ahi[mt], alo[mt], bhi, blo);
          }
        }
        if (TG == 3 || dy == 2) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[mt][nt][j] += d[mt][nt][j];
        }
      }
    }
    __syncthreads();  // unit u's buffer is refilled by the stage of unit u + kStages
  }
  cp_wait<0>();  // only empty groups are left; none is outstanding at exit

  // epilogue: (bias, LeakyReLU), round to the stored type, store; the sums
  // take the stored values, 0 outside the volume and the channel range
  const bool pairs = (Cout & 1) == 0;  // c0, c1 are two adjacent channels
  const long long plane0 = ((long long)g.b * Z + g.z) * Y;
  float s[NT][2], ss[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = ss[nt][0] = ss[nt][1] = 0.f;
  float bv[NT][2];
  if (STATS) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int co = g.co0 + nt * 8 + 2 * tig + j;
        bv[nt][j] = co < Cout ? bias[co] : 0.f;
      }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (warp * MT + mt) * 16 + gid + 8 * h;
      const int ty = r / TX, tx = r - ty * TX;
      const int gy = g.y0 + ty, gx = g.x0 + tx;
      const bool ok = gy < Y && gx < X;
      T* dst = y + ((plane0 + gy) * X + gx) * (long long)Cout;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int co = g.co0 + nt * 8 + 2 * tig;
        float v[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float a = acc[mt][nt][2 * h + j];
          if (STATS) {
            a += bv[nt][j];
            a = a > 0.f ? a : 0.2f * a;
          }
          v[j] = stored(a, y);
        }
        if (ok) {
          if (pairs) {
            if (co < Cout) st2(dst + co, v[0], v[1]);
          } else {
            if (co < Cout) st1(dst + co, v[0]);
            if (co + 1 < Cout) st1(dst + co + 1, v[1]);
          }
        }
        if (STATS) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float e = (ok && co + j < Cout) ? v[j] : 0.f;
            s[nt][j] += e;
            ss[nt][j] = fmaf(e, e, ss[nt][j]);
          }
        }
      }
    }

  if (STATS) {
    // over the 8 row groups of the warp (lanes with the same tig), fixed order
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          s[nt][j] += __shfl_xor_sync(0xffffffffu, s[nt][j], off);
          ss[nt][j] += __shfl_xor_sync(0xffffffffu, ss[nt][j], off);
        }
    // the staging buffers are free after the loop's last barrier
    float* red = reinterpret_cast<float*>(smem_raw);  // [kWarps][2][NPAD]
    if (gid == 0) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = nt * 8 + 2 * tig + j;
          red[(warp * 2 + 0) * NPAD + n] = s[nt][j];
          red[(warp * 2 + 1) * NPAD + n] = ss[nt][j];
        }
    }
    __syncthreads();
    for (int i = tid; i < 2 * NPAD; i += kThreads) {
      const int k = i / NPAD, n = i - k * NPAD;
      float a = 0.f;
#pragma unroll
      for (int wp = 0; wp < kWarps; ++wp) a += red[(wp * 2 + k) * NPAD + n];
      if (g.co0 + n < Cout) partials[((long long)blockIdx.x * 2 + k) * Cout + g.co0 + n] = a;
    }
  }
}

// out[col] = sum over rows of partials[row][col], rows taken in a fixed order
__global__ void __launch_bounds__(256)
reduce_partials_kernel(const float* __restrict__ partials, long long rows, int cols,
                       float* __restrict__ out) {
  __shared__ float sh[256];
  const int col = blockIdx.x;
  float s = 0.f;
  for (long long i = threadIdx.x; i < rows; i += 256) s += partials[i * cols + col];
  sh[threadIdx.x] = s;
  __syncthreads();
  for (int k = 128; k > 0; k >>= 1) {
    if (threadIdx.x < k) sh[threadIdx.x] += sh[threadIdx.x + k];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[col] = sh[0];
}

template <typename T>
using KernelFn = void (*)(const T*, const T*, const float*, T*, float*, int, int, int, int, int,
                          int, int, int);

constexpr int kNTs[] = {1, 2, 3, 4, 5, 7, kMaxNT};  // instantiated n8 tile counts

template <typename T, int MT, bool STATS>
KernelFn<T> kernel_nt(int NT) {
  switch (NT) {
    case 1: return conv3x3_kernel<T, MT, 1, STATS>;
    case 2: return conv3x3_kernel<T, MT, 2, STATS>;
    case 3: return conv3x3_kernel<T, MT, 3, STATS>;
    case 4: return conv3x3_kernel<T, MT, 4, STATS>;
    case 5: return conv3x3_kernel<T, MT, 5, STATS>;
    case 7: return conv3x3_kernel<T, MT, 7, STATS>;
    default: return conv3x3_kernel<T, MT, kMaxNT, STATS>;
  }
}

// warps of 4 m16 tiles (256-voxel blocks) only for N <= 16: they take fewer
// splits per MMA, but from N = 24 their registers halve the resident blocks
constexpr int kMaxNT4 = 2;

template <typename T, bool STATS>
KernelFn<T> kernel_for(int MT, int NT) {
  if (MT == 4) return NT == 1 ? conv3x3_kernel<T, 4, 1, STATS> : conv3x3_kernel<T, 4, 2, STATS>;
  return MT == 1 ? kernel_nt<T, 1, STATS>(NT) : kernel_nt<T, 2, STATS>(NT);
}

struct Plan {
  int MT, NT;  // m16 tiles a warp, n8 tiles a block (template values)
  int ngy;     // blocks along the output channels
  int TX, TY;  // tile extent in voxels
  int tilesX, tilesY;
  long long gridx;
};

int tile_x(int X) { return X >= 16 ? 16 : 8; }

template <typename T>
size_t smem_bytes(int MT, int NT, int TX) {
  const int BM = kWarps * MT * 16;
  const size_t plane = (size_t)(BM / TX + 2) * (TX + 2) * Store<T>::KSTR;
  const size_t wts = (size_t)9 * KC * wstride(NT * 8);
  return kStages * (plane + wts) * sizeof(T);
}

// Resident blocks an SM of the current device holds of the float32 / STATS
// variant (the plan must not depend on the storage type or the epilogue: the
// statistics' row count is asked for without them); cached per device.
int occupancy(int MT, int NT, int TX) {
  static int cache[16][3][kMaxNT + 1][2];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 16) dev = 0;
  int& slot = cache[dev][MT / 2][NT][TX == 16];
  if (slot > 0) return slot;
  KernelFn<float> k = kernel_for<float, true>(MT, NT);
  const size_t smem = smem_bytes<float>(MT, NT, TX);
  int n = 0;
  if (cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, kThreads, smem) != cudaSuccess) {
    cudaGetLastError();  // a heuristic input only: assume one block
    n = 1;
  }
  slot = n > 0 ? n : 1;
  return slot;
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    cudaGetLastError();
    n = 1;
  }
  return n > 0 ? n : 1;
}

int round_nt(int n) {
  for (int c : kNTs)
    if (n <= c) return c;
  return kMaxNT;
}

// Tile plan: among M in {256 (N <= 16), 128, 64} voxels and N split in {1, 2} x the least
// number of parts, the least cost = (resident slots the grid occupies, in whole
// waves) x (work of one block: its MMA work plus 16 x its staged elements).
// Idle slots count as lost, so a grid smaller than the card is charged for it.
Plan make_plan(int B, int Z, int Y, int X, int Cout) {
  const int ntiles = (Cout + 7) / 8;
  const int min_parts = (ntiles + kMaxNT - 1) / kMaxNT;
  const int sms = sm_count();
  Plan best{};
  double best_cost = -1.0;
  for (int MT = 4; MT >= 1; MT /= 2)
    for (int split = 1; split <= 2; ++split) {
      Plan p;
      p.MT = MT;
      p.NT = round_nt((ntiles + min_parts * split - 1) / (min_parts * split));
      if (MT == 4 && p.NT > kMaxNT4) continue;
      p.ngy = (ntiles + p.NT - 1) / p.NT;
      p.TX = tile_x(X);
      p.TY = kWarps * MT * 16 / p.TX;
      p.tilesX = (X + p.TX - 1) / p.TX;
      p.tilesY = (Y + p.TY - 1) / p.TY;
      p.gridx = (long long)B * Z * p.tilesY * p.tilesX;
      const double blocks = (double)p.gridx * p.ngy;
      const double slots = (double)sms * occupancy(MT, p.NT, p.TX);
      const double waves = (double)(long long)((blocks + slots - 1) / slots);
      const double per_block = (double)(kWarps * MT * 16) * p.NT * 8 * 72 +
                               16.0 * ((p.TY + 2) * (p.TX + 2) * 8 + 72 * p.NT * 8);
      const double cost = waves * slots * per_block;
      if (best_cost < 0 || cost < best_cost) {
        best_cost = cost;
        best = p;
      }
    }
  return best;
}

template <typename T, bool STATS>
int launch(const Plan& p, const void* x, const void* w, const void* bias, void* y,
           void* partials, int Z, int Y, int X, int Cin, int Cout, cudaStream_t stream) {
  KernelFn<T> kern = kernel_for<T, STATS>(p.MT, p.NT);
  const size_t smem = smem_bytes<T>(p.MT, p.NT, p.TX);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)p.gridx, (unsigned)p.ngy);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(bias),
      static_cast<T*>(y), static_cast<float*>(partials), Z, Y, X, Cin, Cout, p.TX, p.tilesX,
      p.tilesY);
  return (int)cudaGetLastError();
}

}  // namespace

// Rows of the statistics scratch buffer (rows, 2, Cout) that
// spsg_conv3x3_launch needs for these shapes on the current device; <= 0 on a
// bad shape.
extern "C" long long spsg_conv3x3_partial_rows(int B, int Z, int Y, int X, int Cout) {
  if (B < 1 || Z < 1 || Y < 1 || X < 1 || Cout < 1) return -1;
  const Plan p = make_plan(B, Z, Y, X, Cout);
  return p.gridx <= 2147483647LL ? p.gridx : -1;
}

// x (B,Z,Y,X,Cin), w (3,3,3,Cin,Cout), y (B,Z,Y,X,Cout), all of `dtype`
// (0 float32, 1 bfloat16), contiguous, on the current device.
// with_stats = 0: y = conv(x, w); bias, partials, stats are not read.
// with_stats = 1: y = leaky_relu(conv(x, w) + bias, 0.2) stored in `dtype`;
//   stats (2, Cout) float32 = per-channel sum and sum of squares of the stored
//   values; bias (Cout) float32; partials (partial_rows, 2, Cout) float32 scratch.
// Returns the cudaError_t of the launches (0 = success), -1 on bad arguments.
extern "C" int spsg_conv3x3_launch(const void* x, const void* w, const void* bias, void* y,
                                   void* partials, void* stats, int B, int Z, int Y, int X,
                                   int Cin, int Cout, int dtype, int with_stats,
                                   void* stream_ptr) {
  if (B < 1 || Z < 1 || Y < 1 || X < 1 || Cin < 1 || Cout < 1) return -1;
  if (dtype != 0 && dtype != 1) return -1;
  const Plan p = make_plan(B, Z, Y, X, Cout);
  if (p.gridx > 2147483647LL || p.ngy > 65535) return -1;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int err;
  if (with_stats) {
    err = dtype == 0
              ? launch<float, true>(p, x, w, bias, y, partials, Z, Y, X, Cin, Cout, stream)
              : launch<__nv_bfloat16, true>(p, x, w, bias, y, partials, Z, Y, X, Cin, Cout,
                                            stream);
    if (err != 0) return err;
    reduce_partials_kernel<<<2 * Cout, 256, 0, stream>>>(
        static_cast<const float*>(partials), p.gridx, 2 * Cout, static_cast<float*>(stats));
    return (int)cudaGetLastError();
  }
  err = dtype == 0
            ? launch<float, false>(p, x, w, nullptr, y, nullptr, Z, Y, X, Cin, Cout, stream)
            : launch<__nv_bfloat16, false>(p, x, w, nullptr, y, nullptr, Z, Y, X, Cin, Cout,
                                           stream);
  return err;
}
