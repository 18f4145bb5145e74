// Weight gradient of the 3x3x3, stride-1, zero-pad-1, channel-last 3D
// convolution for Hopper (sm_90a), as a split-K GEMM on the tensor cores
// (mma.sync, TF32). The weight gradient of the generator's other convs (the
// library convs: 5^3 and 4^3 stride 2) follows K2 below, from "Weight
// gradient of the generator's library convs".
//
// Replaces the TPU kernel _dw_kernel (spsg_tpu/ops/pallas_conv.py:104,
// launcher _conv3x3_dw_impl) of the JAX package. For tap = (dz, dy, dx):
//   dW[tap, ci, co] = sum over (b, z, y, x) of
//                     xpad[b, z+dz, y+dy, x+dx, ci] * dy[b, z, y, x, co]
// with xpad the input with a zero halo of one voxel, accumulated in float32
// whatever the storage type (float32 or bfloat16); the output is float32
// (3,3,3,Cin,Cout), tap-major in (dz, dy, dx) order.
//
// What bounds it on an H100: operations (2*27*Cin*Cout flops per voxel
// against Cin+Cout loaded elements), except for the one-channel heads, which
// are bound by bytes. float32 storage is computed as 3xTF32 (as in
// conv3x3.cu: three tensor-core passes a product, so its least time is
// 3*flops / 495 TFLOP/s); bfloat16 storage takes one exact pass.
//
// The GEMM. dW as a matrix is (27*Cin) x Cout, at most 2,700 x 100, and the
// reduction runs over the voxels, ~10^5-10^6 of them: K is the voxel axis.
//   * M = (tap, input channel): a block owns one chunk of KC = 8 input
//     channels for all 27 taps, 216 rows as 14 m16 tiles of two taps each
//     (the 28th tap slot is computed and dropped). N = output channels: a
//     block owns NT n8 tiles (NT <= 7, Cout padded to 8); Cout > 56 is split
//     over 2 or more blocks. 7 warps; warp w owns the m16 tiles of taps
//     4w .. 4w+3, all NT n8 tiles, and issues
//     mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32: A[(tap, ci), v] =
//     xpad[v + tap, ci], B[v, co] = dy[v, co].
//   * K is walked in tiles of TY x TX voxels of one (b, z) plane, k8 steps of
//     8 voxels along x (TX = 16, or 8 for X < 16): 256 voxels, or 128 for
//     NT = 5, whose 256-voxel stages would cost it its second resident block.
//     Per tile the block stages the halo slab [3][TY+2][TX+2][8] of x and the
//     tile [TY*TX][NPAD] of dy, both channel-last, so each voxel tile's dy is
//     staged once per input-channel chunk and x once per output-channel chunk
//     (the FMA kernel this replaced staged both once per (8 x <= 56)-channel
//     pair: 13 times at 100 -> 100). The B fragment (dy) of a k8 step serves
//     the warp's two m16 tiles, the A fragments (x, a shifted view of the slab
//     per tap) its NT n8 tiles.
//   * Split K: gridDim.x = the (Cin chunk, Cout chunk) units, fastest, so that
//     the blocks of one voxel range run together and share its x and dy lines
//     in L2; gridDim.y = S contiguous shares of the tiles. Each block writes
//     its sums to its own slice of a (S, 27, Cin, Cout) scratch buffer and
//     sum_slices_kernel adds the S slices in a fixed order: no float atomics,
//     results repeat bit for bit. S is the least number of shares that keeps a
//     block's share at <= kMaxTilesPerBlock tiles (so a block's work does not
//     grow with the batch: a larger batch gets more blocks) and fills the
//     card's resident slots (SM count x cudaOccupancyMaxActiveBlocksPerMultiprocessor)
//     in nearly whole waves, within a 32 MB scratch buffer.
//
// Accumulation. The tensor core rounds each mma's sum toward zero, and K here
// is 10^5-10^6 long: one accumulator across all of it is ~3e-4 of max|dW| off
// at 32,768 voxels already (tests/test_torch_conv3x3_dw_tf32.py emulates the
// kernel's order of sums on the CPU). The passes of one voxel tile (48 or 96
// mmas) go into temporaries that start at 0 and join the float32 accumulators
// with a rounded float add once per tile (1.7e-6 in the same emulation); the
// slices join in order in sum_slices_kernel.
//
// 3xTF32 (float32 storage), as in conv3x3.cu (helpers in tf32_mma.cuh): each
// operand v is split at fragment load into hi = v with its 13 low bits
// cleared and lo = v - hi cleared the same way; the product is lo*hi' +
// hi*lo' + hi*hi' (in that order). bfloat16 storage: a bfloat16 value is a
// TF32 value, one pass.
// (Leaving lo's low bits in place gave bit-identical results, so the tensor
// core reads a TF32 operand truncated, but no faster kernel.)
//
// Shared memory, per stage: the slab, 8 floats a position (A loads: 8 rows
// (ci) x 4 k (consecutive positions) on 32 distinct banks, for every tap's
// shift and at any k8 step, since a k8 step never crosses a tile row), and dy
// at a row stride DS = NPAD or NPAD + 8, = 8 or 24 (mod 32) (B loads: 4 k x
// 8 n on 32 distinct banks). Two stages: the next tile is copied with cp.async
// while this one is computed, in 16-, 8- or 4-byte copies as Cin or Cout and
// the pointer allow, with zero fill at the volume's edges; channels past Cin /
// Cout are zeroed once and never copied (no padded copy of x). bfloat16 is
// staged with plain loads, converted to float, in the same two-stage loop (off
// the generator's path). Offsets into x and dy are 64 bit.
//
// Measured and not kept (H100, PERF.md): accumulators in shared memory
// (fewer registers, no faster), loading the next k8 step's fragments ahead
// (slower), 256-voxel tiles for NT = 5 (one resident block: slower), a cap of
// 64 tiles a block lifted (no faster). One-channel heads (Cout = 1) take the
// same kernel with one n8 tile: faster than the FMA loop it replaced.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kWarps = 7;  // 14 m16 tiles of tap pairs, two a warp
constexpr int kThreads = kWarps * 32;
constexpr int MT = 2;       // m16 tiles a warp
constexpr int KC = 8;       // input channels a block
constexpr int kStages = 2;
constexpr int kMaxNT = 7;
constexpr long long kMaxTilesPerBlock = 64;
constexpr long long kScratchBytes = 32LL << 20;

// registers: up to 5 n8 tiles are held to 128 a thread (2 blocks an SM)
template <int NT>
constexpr int min_blocks() { return NT <= 5 ? 2 : 1; }

template <typename T>
struct Store;
template <>
struct Store<float> {
  static constexpr bool kSplit = true;
};
template <>
struct Store<__nv_bfloat16> {
  static constexpr bool kSplit = false;
};

// row stride (floats) of the staged dy tile: >= npad and = 8 or 24 (mod 32)
__host__ __device__ inline int dstride(int npad) { return (npad / 8) % 2 ? npad : npad + 8; }

// fragment values as TF32 bits: split (float32) or as they are (bfloat16)
template <typename T>
__device__ __forceinline__ void frag(float v, uint32_t& hi, uint32_t& lo) {
  if constexpr (Store<T>::kSplit) {
    split(v, hi, lo);
  } else {
    hi = __float_as_uint(v);
    lo = 0u;
  }
}

// d += a * b: 3xTF32 (lo*hi + hi*lo, then hi*hi) for float32, one pass for bfloat16
template <typename T>
__device__ __forceinline__ void passes(float (&d)[4], const uint32_t (&ahi)[4],
                                       const uint32_t (&alo)[4], uint32_t bhi0, uint32_t bhi1,
                                       uint32_t blo0, uint32_t blo1) {
  if constexpr (Store<T>::kSplit) {
    mma(d, alo, bhi0, bhi1);
    mma(d, ahi, blo0, blo1);
  }
  mma(d, ahi, bhi0, bhi1);
}

struct Geom {
  int Z, Y, X, Cin, Cout;
  int TX, TY, HX, HY, tilesX, tilesY, txs;  // txs = log2(TX)
  int c0, co0, DS;
  int xe, de;  // floats a copy of x / dy: 4 (16 bytes), 2 or 1 (bfloat16: 1)
  int xn, dn;  // copies a slab position / a dy voxel: the channels that exist
};

// E floats from src to dst (cp.async with zero fill where !ok), or one
// bfloat16 converted to float
template <int E, typename T>
__device__ __forceinline__ void copy(float* dst, const T* src, bool ok) {
  if constexpr (Store<T>::kSplit) {
    if constexpr (E == 4)
      cp16(dst, src, ok);
    else if constexpr (E == 2)
      cp8(dst, src, ok);
    else
      cp4(dst, src, ok);
  } else {
    *dst = ok ? __bfloat162float(*src) : 0.f;
  }
}

// the halo slab [3][HY][HX][8] of x around plane z, rows y0-1 .., columns
// x0-1 ..; positions outside the volume are zero-filled, channels past Cin
// are never written (zeroed once at the start)
template <int E, typename T>
__device__ __forceinline__ void stage_slab(float* xs, const T* __restrict__ x, const Geom& g, int b,
                                           int z, int y0, int x0, int tid) {
  const int npos = 3 * g.HY * g.HX;
  for (int p = tid; p < npos; p += kThreads) {
    const int row = p / g.HX, hx = p - row * g.HX;
    const int hz = row / g.HY, hy = row - hz * g.HY;
    const int gz = z + hz - 1, gy = y0 + hy - 1, gx = x0 + hx - 1;
    const bool ok = gz >= 0 && gz < g.Z && gy >= 0 && gy < g.Y && gx >= 0 && gx < g.X;
    const T* src =
        x + (ok ? ((((long long)b * g.Z + gz) * g.Y + gy) * g.X + gx) * (long long)g.Cin + g.c0 : 0);
    float* dst = xs + p * KC;
#pragma unroll
    for (int k = 0; k < KC / E; ++k)
      if (k < g.xn) copy<E>(dst + k * E, src + k * E, ok);
  }
}

// the tile [TY*TX][DS] of dy, channels co0 .. co0+NPAD-1; voxels outside the
// volume zero-filled, channels past Cout never written
template <int E, int NPAD, typename T>
__device__ __forceinline__ void stage_dy(float* ds, const T* __restrict__ dy, const Geom& g,
                                         long long plane, int y0, int x0, int tid) {
  constexpr int Q = NPAD / E;
  for (int i = tid; i < g.TY * g.TX * Q; i += kThreads) {
    const int v = i / Q, q = i - v * Q;
    if (q >= g.dn) continue;
    const int vy = v >> g.txs, vx = v & (g.TX - 1);
    const int gy = y0 + vy, gx = x0 + vx;
    const bool ok = gy < g.Y && gx < g.X;
    const T* src = dy + (ok ? ((plane + gy) * g.X + gx) * (long long)g.Cout + g.co0 + q * E : 0);
    copy<E>(ds + v * g.DS + q * E, src, ok);
  }
}

// Stage voxel tile t: the slab of x (channels c0 .. c0+7) into xs and the
// tile of dy (channels co0 .. co0+NPAD-1) into ds.
template <typename T, int NPAD>
__device__ __forceinline__ void stage_tile(float* xs, float* ds, const T* __restrict__ x,
                                           const T* __restrict__ dy, const Geom& g, long long t,
                                           int tid) {
  long long r = t;
  const int tileX = (int)(r % g.tilesX);
  r /= g.tilesX;
  const int tileY = (int)(r % g.tilesY);
  r /= g.tilesY;
  const int z = (int)(r % g.Z);
  const int b = (int)(r / g.Z);
  const int x0 = tileX * g.TX, y0 = tileY * g.TY;
  const long long plane = ((long long)b * g.Z + z) * g.Y;
  if constexpr (Store<T>::kSplit) {
    if (g.xe == 4)
      stage_slab<4>(xs, x, g, b, z, y0, x0, tid);
    else if (g.xe == 2)
      stage_slab<2>(xs, x, g, b, z, y0, x0, tid);
    else
      stage_slab<1>(xs, x, g, b, z, y0, x0, tid);
    if (g.de == 4)
      stage_dy<4, NPAD>(ds, dy, g, plane, y0, x0, tid);
    else if (g.de == 2)
      stage_dy<2, NPAD>(ds, dy, g, plane, y0, x0, tid);
    else
      stage_dy<1, NPAD>(ds, dy, g, plane, y0, x0, tid);
  } else {
    stage_slab<1>(xs, x, g, b, z, y0, x0, tid);
    stage_dy<1, NPAD>(ds, dy, g, plane, y0, x0, tid);
  }
}

// floats a copy can move: rows of n elements of type T at p
template <typename T>
__device__ __forceinline__ int copy_width(const T* p, int n) {
  if (!Store<T>::kSplit) return 1;
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  return n % 4 == 0 && a % 16 == 0 ? 4 : n % 2 == 0 && a % 8 == 0 ? 2 : 1;
}

template <typename T, int NT>
__global__ void __launch_bounds__(kThreads, min_blocks<NT>())
conv3x3_dw_kernel(const T* __restrict__ x, const T* __restrict__ dy, float* __restrict__ partials,
                  int Z, int Y, int X, int Cin, int Cout, int TX, int TY, int tilesX, int tilesY,
                  long long tiles, int coBlocks) {
  constexpr int NPAD = NT * 8;
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;  // fragment row (A, C) / column (B)
  const int tig = lane & 3;   // fragment k (A, B) / column pair (C)

  Geom g;
  g.Z = Z; g.Y = Y; g.X = X; g.Cin = Cin; g.Cout = Cout;
  g.TX = TX; g.TY = TY; g.HX = TX + 2; g.HY = TY + 2;
  g.tilesX = tilesX; g.tilesY = tilesY;
  g.txs = 31 - __clz(TX);
  g.c0 = (blockIdx.x / coBlocks) * KC;
  g.co0 = (blockIdx.x % coBlocks) * NPAD;
  g.DS = dstride(NPAD);
  g.xe = copy_width(x, Cin);
  g.de = copy_width(dy, Cout);
  g.xn = (min(KC, Cin - g.c0) + g.xe - 1) / g.xe;
  g.dn = (min(NPAD, Cout - g.co0) + g.de - 1) / g.de;
  const int xs_elems = 3 * g.HY * g.HX * KC;
  const int stage_elems = xs_elems + TY * TX * g.DS;
  // channels past Cin / Cout are never staged: zeros from here on
  for (int i = tid; i < kStages * stage_elems; i += kThreads) smem[i] = 0.f;
  __syncthreads();

  const long long S = gridDim.y;
  const long long t_begin = tiles * (long long)blockIdx.y / S;
  const long long t_end = tiles * ((long long)blockIdx.y + 1) / S;

  // slab offset of this thread's A rows at voxel (0, 0), k = tig: row gid of
  // m16 tile mt is (tap 4*warp + 2*mt, ci gid), row gid + 8 the next tap; the
  // 28th tap slot reads tap 26's rows and is not stored
  int aoff[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int tap = 4 * warp + 2 * mt + h;
      if (tap > 26) tap = 26;
      const int dz = tap / 9, ky = (tap / 3) % 3, kx = tap % 3;
      aoff[mt][h] = (((dz * g.HY + ky) * g.HX + kx) + tig) * KC + gid;
    }

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.f;

  // one commit group a tile (empty past the share), so that wait_group<1>
  // always means "tile t has landed"
  auto stage = [&](long long t) {
    if (t < t_end) {
      float* base = smem + ((t - t_begin) % kStages) * stage_elems;
      stage_tile<T, NPAD>(base, base + xs_elems, x, dy, g, t, tid);
    }
    cp_commit();
  };

  stage(t_begin);
  for (long long t = t_begin; t < t_end; ++t) {
    // the buffer of tile t + 1 was read by tile t - 1, before the barrier
    // that closed it
    stage(t + 1);
    cp_wait<kStages - 1>();
    __syncthreads();
    const float* xs = smem + ((t - t_begin) % kStages) * stage_elems;
    const float* ds = xs + xs_elems;
    // the passes of one tile into temporaries from 0 (the tensor core
    // truncates as it accumulates), joined to acc by a rounded add
    float d[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) d[mt][nt][j] = 0.f;
    for (int vy = 0; vy < TY; ++vy) {
#pragma unroll 2
      for (int kx = 0; kx < TX; kx += 8) {
        // B fragments: b0 (k = tig, n = gid), b1 (k = tig + 4, n = gid)
        const float* drow = ds + (vy * TX + kx + tig) * g.DS + gid;
        uint32_t bhi[NT][2], blo[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          frag<T>(drow[nt * 8], bhi[nt][0], blo[nt][0]);
          frag<T>(drow[4 * g.DS + nt * 8], bhi[nt][1], blo[nt][1]);
        }
        const float* xb = xs + (vy * g.HX + kx) * KC;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          // a0 (gid, tig), a1 (gid+8, tig), a2 (gid, tig+4), a3 (gid+8, tig+4)
          const float v[4] = {xb[aoff[mt][0]], xb[aoff[mt][1]], xb[aoff[mt][0] + 4 * KC],
                              xb[aoff[mt][1] + 4 * KC]};
          uint32_t ahi[4], alo[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) frag<T>(v[j], ahi[j], alo[j]);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            passes<T>(d[mt][nt], ahi, alo, bhi[nt][0], bhi[nt][1], blo[nt][0], blo[nt][1]);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mt][nt][j] += d[mt][nt][j];
    __syncthreads();  // tile t's buffer is refilled by the stage of tile t + 2
  }
  cp_wait<0>();

  // c0 (row gid, col 2*tig), c1 (gid, 2*tig+1), c2 (gid+8, 2*tig), c3 (gid+8, 2*tig+1)
  float* dst = partials + (long long)blockIdx.y * 27 * Cin * Cout;
  const int ci = g.c0 + gid;
  if (ci < Cin) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int tap = 4 * warp + 2 * mt + h;
        if (tap > 26) continue;
        float* row = dst + ((long long)tap * Cin + ci) * Cout;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int co = g.co0 + nt * 8 + 2 * tig;
          if (co < Cout) row[co] = acc[mt][nt][2 * h];
          if (co + 1 < Cout) row[co + 1] = acc[mt][nt][2 * h + 1];
        }
      }
  }
}

// out[j] = sum over the S slices of partials[s][j], slices taken in order
__global__ void __launch_bounds__(256)
sum_slices_kernel(const float* __restrict__ partials, int S, long long n,
                  float* __restrict__ out) {
  const long long j = (long long)blockIdx.x * 256 + threadIdx.x;
  if (j >= n) return;
  float s = 0.f;
  for (int k = 0; k < S; ++k) s += partials[(long long)k * n + j];
  out[j] = s;
}

template <typename T>
using KernelFn = void (*)(const T*, const T*, float*, int, int, int, int, int, int, int, int, int,
                          long long, int);

constexpr int kNTs[] = {1, 2, 3, 5, kMaxNT};  // instantiated n8 tile counts

template <typename T>
KernelFn<T> kernel_nt(int NT) {
  switch (NT) {
    case 1: return conv3x3_dw_kernel<T, 1>;
    case 2: return conv3x3_dw_kernel<T, 2>;
    case 3: return conv3x3_dw_kernel<T, 3>;
    case 5: return conv3x3_dw_kernel<T, 5>;
    default: return conv3x3_dw_kernel<T, kMaxNT>;
  }
}

const void* kernel_for(int dtype, int NT) {
  return dtype == 0 ? reinterpret_cast<const void*>(kernel_nt<float>(NT))
                    : reinterpret_cast<const void*>(kernel_nt<__nv_bfloat16>(NT));
}

// voxels of a K tile: 256, except where a second stage of them would cost the
// NT = 5 tiles their second resident block
int tile_voxels(int NT) { return NT == 5 ? 128 : 256; }

int round_nt(int n) {
  for (int c : kNTs)
    if (n <= c) return c;
  return kMaxNT;
}

struct Plan {
  int NT;  // n8 tiles a block (template value)
  int TX, TY;
  int tilesX, tilesY;
  long long tiles;
  int ciBlocks, coBlocks;
  size_t smem;
};

Plan make_plan(int B, int Z, int Y, int X, int Cin, int Cout) {
  Plan p;
  const int octs_o = (Cout + 7) / 8;
  const int parts = (octs_o + kMaxNT - 1) / kMaxNT;
  p.NT = round_nt((octs_o + parts - 1) / parts);
  p.coBlocks = (octs_o + p.NT - 1) / p.NT;
  p.ciBlocks = (Cin + KC - 1) / KC;
  p.TX = X >= 16 ? 16 : 8;  // a multiple of 8: k8 steps stay inside a tile row
  p.TY = tile_voxels(p.NT) / p.TX;
  if (p.TY > Y) p.TY = Y;
  p.tilesX = (X + p.TX - 1) / p.TX;
  p.tilesY = (Y + p.TY - 1) / p.TY;
  p.tiles = (long long)B * Z * p.tilesY * p.tilesX;
  p.smem = sizeof(float) * kStages *
           ((size_t)3 * (p.TY + 2) * (p.TX + 2) * KC + (size_t)p.TY * p.TX * dstride(p.NT * 8));
  return p;
}

// Number of voxel shares S: from the least that keeps a block's share within
// kMaxTilesPerBlock tiles, the first that fills the card's block slots in
// nearly whole waves (>= 90 %), else the one that fills them best; bounded by
// the number of tiles and by the scratch buffer. <= 0 on a CUDA error.
int choose_splits(const Plan& p, int dtype, int Cin, int Cout) {
  int dev = 0, sms = 0, occ = 0;
  const void* kern = kernel_for(dtype, p.NT);
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return -1;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem) !=
      cudaSuccess)
    return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, kThreads, p.smem) != cudaSuccess)
    return -1;
  if (sms < 1 || occ < 1) return -1;
  const double slots = (double)sms * occ;
  const long long units = (long long)p.ciBlocks * p.coBlocks;
  long long maxS = kScratchBytes / (27LL * Cin * Cout * (long long)sizeof(float));
  if (maxS < 1) maxS = 1;
  if (maxS > p.tiles) maxS = p.tiles;
  if (maxS > 65535) maxS = 65535;
  long long minS = (p.tiles + kMaxTilesPerBlock - 1) / kMaxTilesPerBlock;
  if (minS > maxS) minS = maxS;
  long long bestS = minS;
  double bestEff = -1.0;
  for (long long s = minS; s <= maxS; ++s) {
    const double waves = (double)(units * s) / slots;
    const double full = (double)(long long)(waves + 0.999999);
    const double eff = waves / (full < 1.0 ? 1.0 : full);
    if (eff > bestEff + 1e-9) { bestEff = eff; bestS = s; }
    if (eff >= 0.9) { bestS = s; break; }
  }
  return (int)bestS;
}

bool bad_shape(int B, int Z, int Y, int X, int Cin, int Cout, int dtype) {
  return B < 1 || Z < 1 || Y < 1 || X < 1 || Cin < 1 || Cout < 1 || (dtype != 0 && dtype != 1);
}

bool bad_plan(const Plan& p) {
  return (long long)p.ciBlocks * p.coBlocks > 2147483647LL;
}

}  // namespace

// Slices of the scratch buffer (slices, 27, Cin, Cout) float32 that
// spsg_conv3x3_dw_launch needs for these shapes on the current device;
// <= 0 on a bad shape or a CUDA error.
extern "C" int spsg_conv3x3_dw_slices(int B, int Z, int Y, int X, int Cin, int Cout, int dtype) {
  if (bad_shape(B, Z, Y, X, Cin, Cout, dtype)) return -1;
  const Plan p = make_plan(B, Z, Y, X, Cin, Cout);
  if (bad_plan(p)) return -1;
  return choose_splits(p, dtype, Cin, Cout);
}

// x (B,Z,Y,X,Cin) and dy (B,Z,Y,X,Cout) of `dtype` (0 float32, 1 bfloat16),
// contiguous, on the current device; dw (27, Cin, Cout) float32;
// partials (slices, 27, Cin, Cout) float32 scratch with `slices` as
// spsg_conv3x3_dw_slices gave it (not read when slices == 1).
// Returns the cudaError_t of the launches (0 = success), -1 on bad arguments.
extern "C" int spsg_conv3x3_dw_launch(const void* x, const void* dy, void* partials, void* dw,
                                      int B, int Z, int Y, int X, int Cin, int Cout, int dtype,
                                      int slices, void* stream_ptr) {
  if (bad_shape(B, Z, Y, X, Cin, Cout, dtype)) return -1;
  const Plan p = make_plan(B, Z, Y, X, Cin, Cout);
  if (bad_plan(p)) return -1;
  if (slices < 1 || slices > p.tiles || slices > 65535) return -1;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  float* dst = static_cast<float*>(slices == 1 ? dw : partials);
  const void* kern = kernel_for(dtype, p.NT);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  int Zv = Z, Yv = Y, Xv = X, Civ = Cin, Cov = Cout;
  int TX = p.TX, TY = p.TY, tilesX = p.tilesX, tilesY = p.tilesY, coBlocks = p.coBlocks;
  long long tiles = p.tiles;
  void* args[] = {&x,  &dy, &dst,    &Zv,     &Yv,    &Xv,       &Civ,
                  &Cov, &TX, &TY, &tilesX, &tilesY, &tiles, &coBlocks};
  dim3 grid((unsigned)((long long)p.ciBlocks * p.coBlocks), (unsigned)slices);
  err = cudaLaunchKernel(kern, grid, dim3(kThreads), args, p.smem, stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (slices > 1) {
    const long long n = 27LL * Cin * Cout;
    sum_slices_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
        static_cast<const float*>(partials), slices, n, static_cast<float*>(dw));
    return (int)cudaGetLastError();
  }
  return 0;
}

// ===========================================================================
// Weight gradient of the generator's library convs (ops/libconv_dw.py): the
// cubic convs that are not 3x3x3 / stride 1, as the generator has them the
// 5^3 / stride-1 / pad-2 entry convs (geo_0a 1 -> 10, encoder_0a 4 -> 20) and
// the 4^3 / stride-2 / pad-1 downsamplers (geo_0b, geo_1a, encoder_0b,
// encoder_geo, encoder_1a); any kernel size K <= 8, stride 1 or 2, symmetric
// padding, any Cin and Cout, float32 storage only. No TPU kernel stands behind
// it: the JAX package left these convs to XLA. For tap = (kz, ky, kx):
//   dW[co, ci, kz, ky, kx] = sum over (b, z, y, x) of
//                            xpad[b, S*z+kz, S*y+ky, S*x+kx, ci] * dy[b, z, y, x, co]
// x (B,Z,Y,X,Cin) and dy (B,OZ,OY,OX,Cout) channel-last; dW in PyTorch's
// weight layout (Cout, Cin, K, K, K).
//
// What bounds it on an H100: operations (2*K^3*Cin*Cout flops per output
// voxel against Cin*S^3 + Cout loaded elements), computed as 3xTF32 on the
// tensor cores as K2 above (mma.sync m16n8k8, lo*hi + hi*lo + hi*hi): its least
// time is 3*flops / 495 TFLOP/s.
//
// The GEMM: dW as a matrix is (K^3*Cin) x Cout, 125 x 10 to 3,840 x 100 in the
// generator, and K (the reduction) is the output voxels, 16k-1M at batch 2.
// What differs from K2, for these shapes:
//   * Rows are (tap, input channel) packed densely into m16 tiles: a block owns
//     a chunk of CC input channels for all K^3 taps, K^3*CC rows, row
//     r = tap*CC + c. K2's chunk of 8 channels a tap would leave 7/8 of every
//     mma empty at Cin 1 and half at Cin 4. CC is chosen per shape (the least
//     m16 tile passes over the whole M, then the larger CC, so that dy is
//     staged by fewer blocks): 1 at geo_0a (125 rows in 8 m16 tiles), 4 at
//     encoder_0a (500 rows in 32), so that a block owns all of M there and reads
//     dy (84 MB for encoder_0a at batch 2, x is 17 MB) once; 2 or 4 on the
//     downsamplers, whose larger operand is x, split by the chunks.
//   * 8 warps; warp w owns MT consecutive m16 tiles (MT = 1-4, ceil(tiles/8);
//     rows past K^3*CC are computed and dropped) and the block's NT n8 tiles of
//     output channels (NT <= 7; Cout > 56 is split over 2 or more blocks).
//   * The stride-2 taps read a strided input: the block stages its slab split
//     by parity, [kz][y parity][x parity][hy][hx][CC], so that tap (kz, ky, kx)
//     of output voxel (vy, vx) is the element (vy + ky/2, vx + kx/2) of the
//     sub-slab of parity (ky%2, kx%2): consecutive voxels of a k8 step are
//     consecutive positions, as in a stride-1 slab. A sub-slab's size is padded
//     to 16 (mod 32) floats, so that the two parities a row group reads fall on
//     different banks. Stride 1 is the one-parity case.
//   * Voxel tiles of TY x TX output voxels of one (b, z) plane, TX = 16 (8 for
//     OX < 16): 128 voxels at stride 1, 64 at stride 2 (the slab of 4 input
//     planes is the larger there).
// Kept from K2: a per-tile float32 join of temporaries that start at 0 (the
// tensor core truncates as it accumulates; tests/test_torch_libconv_dw.py
// emulates this order of sums), split K over voxel shares with every block's
// sums in its own slice of a scratch buffer, added in a fixed order by
// libconv_dw_join_kernel, which also writes PyTorch's layout (no float atomics:
// results repeat bit for bit); cp.async two-stage staging with zero fill at the
// volume's edges; 64-bit offsets into x and dy.

namespace {
namespace libconv {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 2;
constexpr int kMaxNT = 7;
constexpr int kMaxK = 8;  // K^3 rows fit the 8 warps' m16 tiles with CC = 1
constexpr long long kMaxTilesPerBlock = 64;
constexpr long long kScratchBytes = 32LL << 20;

// registers: MT * NT <= 6 is held to 128 a thread (2 blocks an SM)
template <int MT, int NT>
constexpr int min_blocks() { return MT * NT <= 6 ? 2 : 1; }

struct Plan {
  int B, Z, Y, X, Cin;     // input
  int OZ, OY, OX, Cout;    // output
  int K, S, P;             // kernel size, stride, padding
  int MT, NT;              // m16 tiles a warp, n8 tiles a block (template values)
  int CC, ciBlocks, coBlocks, rows;  // rows = K^3 * CC
  int TX, TY, txs, tilesX, tilesY;
  long long tiles;
  int HY, HX, PS, PL;      // sub-slab rows / columns, floats a sub-slab / a slab plane
  int DS;                  // row stride of the staged dy tile
  int xe, de;              // floats a copy of x / dy: 4, 2 or 1
  int xs_elems, stage_elems;
  size_t smem;
};

// E floats from src to dst with cp.async, zero fill where !ok
template <int E>
__device__ __forceinline__ void copy(float* dst, const float* src, bool ok) {
  if constexpr (E == 4)
    cp16(dst, src, ok);
  else if constexpr (E == 2)
    cp8(dst, src, ok);
  else
    cp4(dst, src, ok);
}

// the input slab of output plane (b, oz), rows oy0 .., columns ox0 .., by
// parity; positions outside the volume zero-filled, channels past Cin not
// written (zeroed once at the start)
template <int E>
__device__ __forceinline__ void stage_slab(float* xs, const float* __restrict__ x, const Plan& p,
                                           int b, int oz, int oy0, int ox0, int c0, int xn,
                                           int tid) {
  const int npos = p.K * p.S * p.S * p.HY * p.HX;
  for (int i = tid; i < npos; i += kThreads) {
    int r = i;
    const int hx = r % p.HX;
    r /= p.HX;
    const int hy = r % p.HY;
    r /= p.HY;
    const int px = r % p.S;
    r /= p.S;
    const int py = r % p.S;
    const int kz = r / p.S;
    const int iz = p.S * oz - p.P + kz;
    const int iy = p.S * (oy0 + hy) - p.P + py;
    const int ix = p.S * (ox0 + hx) - p.P + px;
    const bool ok = iz >= 0 && iz < p.Z && iy >= 0 && iy < p.Y && ix >= 0 && ix < p.X;
    const float* src =
        x + (ok ? ((((long long)b * p.Z + iz) * p.Y + iy) * p.X + ix) * (long long)p.Cin + c0 : 0);
    float* dst = xs + kz * p.PL + (py * p.S + px) * p.PS + (hy * p.HX + hx) * p.CC;
    for (int k = 0; k < xn; ++k) copy<E>(dst + k * E, src + k * E, ok);
  }
}

// the tile [TY*TX][DS] of dy, channels co0 .. co0+NPAD-1; voxels outside the
// volume zero-filled, channels past Cout not written
template <int E, int NPAD>
__device__ __forceinline__ void stage_dy(float* ds, const float* __restrict__ dy, const Plan& p,
                                         long long plane, int oy0, int ox0, int co0, int dn,
                                         int tid) {
  constexpr int Q = NPAD / E;
  for (int i = tid; i < p.TY * p.TX * Q; i += kThreads) {
    const int v = i / Q, q = i - v * Q;
    if (q >= dn) continue;
    const int oy = oy0 + (v >> p.txs), ox = ox0 + (v & (p.TX - 1));
    const bool ok = oy < p.OY && ox < p.OX;
    const float* src = dy + (ok ? ((plane + oy) * p.OX + ox) * (long long)p.Cout + co0 + q * E : 0);
    copy<E>(ds + v * p.DS + q * E, src, ok);
  }
}

// Stage voxel tile t: the slab of x (channels c0 .. c0+CC-1) into xs and the
// tile of dy into ds.
template <int NPAD>
__device__ __forceinline__ void stage_tile(float* xs, float* ds, const float* __restrict__ x,
                                           const float* __restrict__ dy, const Plan& p,
                                           long long t, int c0, int co0, int xn, int dn,
                                           int tid) {
  long long r = t;
  const int tileX = (int)(r % p.tilesX);
  r /= p.tilesX;
  const int tileY = (int)(r % p.tilesY);
  r /= p.tilesY;
  const int oz = (int)(r % p.OZ);
  const int b = (int)(r / p.OZ);
  const int ox0 = tileX * p.TX, oy0 = tileY * p.TY;
  if (p.xe == 4)
    stage_slab<4>(xs, x, p, b, oz, oy0, ox0, c0, xn, tid);
  else if (p.xe == 2)
    stage_slab<2>(xs, x, p, b, oz, oy0, ox0, c0, xn, tid);
  else
    stage_slab<1>(xs, x, p, b, oz, oy0, ox0, c0, xn, tid);
  const long long plane = ((long long)b * p.OZ + oz) * p.OY;
  if (p.de == 4)
    stage_dy<4, NPAD>(ds, dy, p, plane, oy0, ox0, co0, dn, tid);
  else if (p.de == 2)
    stage_dy<2, NPAD>(ds, dy, p, plane, oy0, ox0, co0, dn, tid);
  else
    stage_dy<1, NPAD>(ds, dy, p, plane, oy0, ox0, co0, dn, tid);
}

// d += a * b as 3xTF32: lo*hi + hi*lo, then hi*hi
__device__ __forceinline__ void passes3(float (&d)[4], const uint32_t (&ahi)[4],
                                        const uint32_t (&alo)[4], const uint32_t (&bhi)[2],
                                        const uint32_t (&blo)[2]) {
  mma(d, alo, bhi[0], bhi[1]);
  mma(d, ahi, blo[0], blo[1]);
  mma(d, ahi, bhi[0], bhi[1]);
}

template <int MT, int NT>
__global__ void __launch_bounds__(kThreads, min_blocks<MT, NT>())
libconv_dw_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                  float* __restrict__ partials, const Plan p) {
  constexpr int NPAD = NT * 8;
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;  // fragment row (A, C) / column (B)
  const int tig = lane & 3;   // fragment k (A, B) / column pair (C)

  const int c0 = (blockIdx.x / p.coBlocks) * p.CC;
  const int co0 = (blockIdx.x % p.coBlocks) * NPAD;
  const int xn = (min(p.CC, p.Cin - c0) + p.xe - 1) / p.xe;
  const int dn = (min(NPAD, p.Cout - co0) + p.de - 1) / p.de;
  // channels past Cin / Cout are never staged: zeros from here on
  for (int i = tid; i < kStages * p.stage_elems; i += kThreads) smem[i] = 0.f;
  __syncthreads();

  const long long S = gridDim.y;
  const long long t_begin = p.tiles * (long long)blockIdx.y / S;
  const long long t_end = p.tiles * ((long long)blockIdx.y + 1) / S;

  // slab offset of this thread's A rows at voxel (0, 0), k = tig: row gid (h 0)
  // and gid + 8 (h 1) of m16 tile warp*MT + mt; rows past K^3*CC read the
  // slab's start and are not stored
  int aoff[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (warp * MT + mt) * 16 + gid + 8 * h;
      int off = 0;
      if (r < p.rows) {
        const int tap = r / p.CC, c = r - tap * p.CC;
        const int kz = tap / (p.K * p.K), ky = (tap / p.K) % p.K, kx = tap % p.K;
        off = kz * p.PL + ((ky % p.S) * p.S + kx % p.S) * p.PS +
              ((ky / p.S) * p.HX + kx / p.S) * p.CC + c;
      }
      aoff[mt][h] = off + tig * p.CC;
    }

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.f;

  // one commit group a tile (empty past the share), so that wait_group<1>
  // always means "tile t has landed"
  auto stage = [&](long long t) {
    if (t < t_end) {
      float* base = smem + ((t - t_begin) % kStages) * p.stage_elems;
      stage_tile<NPAD>(base, base + p.xs_elems, x, dy, p, t, c0, co0, xn, dn, tid);
    }
    cp_commit();
  };

  const int k4 = 4 * p.CC;  // slab offset of the voxel 4 further along x
  stage(t_begin);
  for (long long t = t_begin; t < t_end; ++t) {
    // the buffer of tile t + 1 was read by tile t - 1, before the barrier
    // that closed it
    stage(t + 1);
    cp_wait<kStages - 1>();
    __syncthreads();
    const float* xs = smem + ((t - t_begin) % kStages) * p.stage_elems;
    const float* ds = xs + p.xs_elems;
    // the passes of one tile into temporaries from 0, joined to acc by a
    // rounded add
    float d[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) d[mt][nt][j] = 0.f;
    for (int vy = 0; vy < p.TY; ++vy) {
      for (int vx = 0; vx < p.TX; vx += 8) {
        // B fragments: b0 (k = tig, n = gid), b1 (k = tig + 4, n = gid)
        const float* drow = ds + (vy * p.TX + vx + tig) * p.DS + gid;
        uint32_t bhi[NT][2], blo[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          split(drow[nt * 8], bhi[nt][0], blo[nt][0]);
          split(drow[4 * p.DS + nt * 8], bhi[nt][1], blo[nt][1]);
        }
        const float* xb = xs + (vy * p.HX + vx) * p.CC;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          // a0 (gid, tig), a1 (gid+8, tig), a2 (gid, tig+4), a3 (gid+8, tig+4)
          const float v[4] = {xb[aoff[mt][0]], xb[aoff[mt][1]], xb[aoff[mt][0] + k4],
                              xb[aoff[mt][1] + k4]};
          uint32_t ahi[4], alo[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) split(v[j], ahi[j], alo[j]);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) passes3(d[mt][nt], ahi, alo, bhi[nt], blo[nt]);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mt][nt][j] += d[mt][nt][j];
    __syncthreads();  // tile t's buffer is refilled by the stage of tile t + 2
  }
  cp_wait<0>();

  // c0 (row gid, col 2*tig), c1 (gid, 2*tig+1), c2 (gid+8, 2*tig), c3 (gid+8, 2*tig+1);
  // the slice is (K^3, Cin, Cout)
  float* dst = partials + (long long)blockIdx.y * p.K * p.K * p.K * p.Cin * p.Cout;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (warp * MT + mt) * 16 + gid + 8 * h;
      if (r >= p.rows) continue;
      const int tap = r / p.CC, ci = c0 + r - tap * p.CC;
      if (ci >= p.Cin) continue;
      float* row = dst + ((long long)tap * p.Cin + ci) * p.Cout;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int co = co0 + nt * 8 + 2 * tig;
        if (co < p.Cout) row[co] = acc[mt][nt][2 * h];
        if (co + 1 < p.Cout) row[co + 1] = acc[mt][nt][2 * h + 1];
      }
    }
}

// dw[co, ci, tap] = sum over the S slices of partials[s][tap, ci, co], slices
// taken in order
__global__ void __launch_bounds__(256)
libconv_dw_join_kernel(const float* __restrict__ partials, int S, int K3, int Cin, int Cout,
                       float* __restrict__ dw) {
  const long long n = (long long)K3 * Cin * Cout;
  const long long j = (long long)blockIdx.x * 256 + threadIdx.x;
  if (j >= n) return;
  float s = 0.f;
  for (int k = 0; k < S; ++k) s += partials[(long long)k * n + j];
  const int co = (int)(j % Cout);
  const long long r = j / Cout;
  const int ci = (int)(r % Cin), tap = (int)(r / Cin);
  dw[((long long)co * Cin + ci) * K3 + tap] = s;
}

using KernelFn = void (*)(const float*, const float*, float*, const Plan);

constexpr int kNTs[] = {1, 2, 3, 5, kMaxNT};  // instantiated n8 tile counts

template <int NT>
KernelFn kernel_mt(int MT) {
  switch (MT) {
    case 1: return libconv_dw_kernel<1, NT>;
    case 2: return libconv_dw_kernel<2, NT>;
    case 3: return libconv_dw_kernel<3, NT>;
    default: return libconv_dw_kernel<4, NT>;
  }
}

// MT <= 4 for NT <= 3, MT <= 2 for NT 5 and 7 (make_plan keeps to these)
KernelFn kernel_for(int MT, int NT) {
  switch (NT) {
    case 1: return kernel_mt<1>(MT);
    case 2: return kernel_mt<2>(MT);
    case 3: return kernel_mt<3>(MT);
    case 5: return MT == 1 ? libconv_dw_kernel<1, 5> : libconv_dw_kernel<2, 5>;
    default: return MT == 1 ? libconv_dw_kernel<1, kMaxNT> : libconv_dw_kernel<2, kMaxNT>;
  }
}

int round_nt(int n) {
  for (int c : kNTs)
    if (n <= c) return c;
  return kMaxNT;
}

// m16 tiles a warp allows with NT n8 tiles: 4, or 2 from NT 5 on (registers)
int max_mt(int NT) { return NT <= 3 ? 4 : 2; }

// floats a copy can move: rows of n elements at p, chunks of c of them
int copy_width(const void* p, int n, int c) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  return n % 4 == 0 && c % 4 == 0 && a % 16 == 0 ? 4 : n % 2 == 0 && c % 2 == 0 && a % 8 == 0 ? 2 : 1;
}

int out_extent(int n, int K, int S, int P) { return (n + 2 * P - K) / S + 1; }

bool bad_shape(int B, int Z, int Y, int X, int Cin, int Cout, int K, int S, int P) {
  if (B < 1 || Z < 1 || Y < 1 || X < 1 || Cin < 1 || Cout < 1) return true;
  if (K < 1 || K > kMaxK || (S != 1 && S != 2) || P < 0 || P >= K) return true;
  return out_extent(Z, K, S, P) < 1 || out_extent(Y, K, S, P) < 1 || out_extent(X, K, S, P) < 1;
}

Plan make_plan(int B, int Z, int Y, int X, int Cin, int Cout, int K, int S, int P,
               const void* x, const void* dy) {
  Plan p;
  p.B = B; p.Z = Z; p.Y = Y; p.X = X; p.Cin = Cin; p.Cout = Cout; p.K = K; p.S = S; p.P = P;
  p.OZ = out_extent(Z, K, S, P);
  p.OY = out_extent(Y, K, S, P);
  p.OX = out_extent(X, K, S, P);
  const int octs = (Cout + 7) / 8;
  const int parts = (octs + kMaxNT - 1) / kMaxNT;
  p.NT = round_nt((octs + parts - 1) / parts);
  p.coBlocks = (octs + p.NT - 1) / p.NT;
  // input channels a block: the least m16 tile passes over all of M
  // (chunks x tiles a warp), then the most channels
  const int K3 = K * K * K;
  const int rows_max = kWarps * 16 * max_mt(p.NT);
  int best = 1;
  long long best_cost = -1;
  for (int c = 1; c <= Cin && K3 * c <= rows_max; ++c) {
    const long long cost = (long long)((Cin + c - 1) / c) * ((K3 * c + kWarps * 16 - 1) / (kWarps * 16));
    if (best_cost < 0 || cost <= best_cost) { best_cost = cost; best = c; }
  }
  p.CC = best;
  p.ciBlocks = (Cin + p.CC - 1) / p.CC;
  p.rows = K3 * p.CC;
  p.MT = ((p.rows + 15) / 16 + kWarps - 1) / kWarps;
  p.TX = p.OX >= 16 ? 16 : 8;  // a multiple of 8: k8 steps stay inside a tile row
  p.txs = p.TX == 16 ? 4 : 3;
  p.TY = (S == 1 ? 128 : 64) / p.TX;
  if (p.TY > p.OY) p.TY = p.OY;
  p.tilesX = (p.OX + p.TX - 1) / p.TX;
  p.tilesY = (p.OY + p.TY - 1) / p.TY;
  p.tiles = (long long)B * p.OZ * p.tilesY * p.tilesX;
  p.HY = p.TY + (K - 1) / S;
  p.HX = p.TX + (K - 1) / S;
  p.PS = (p.HY * p.HX * p.CC + 3) / 4 * 4;
  if (S > 1) p.PS += (48 - p.PS % 32) % 32;  // 16 (mod 32)
  p.PL = S * S * p.PS;
  p.DS = dstride(p.NT * 8);
  p.xe = copy_width(x, Cin, p.CC);
  p.de = copy_width(dy, Cout, p.NT * 8);
  p.xs_elems = K * p.PL;
  p.stage_elems = p.xs_elems + p.TY * p.TX * p.DS;
  p.smem = sizeof(float) * kStages * (size_t)p.stage_elems;
  return p;
}

bool bad_plan(const Plan& p) {
  return p.MT > max_mt(p.NT) || p.smem > 232448 ||
         (long long)p.ciBlocks * p.coBlocks > 2147483647LL;
}

// Number of voxel shares S, as K2's choose_splits: from the least that keeps a
// block's share within kMaxTilesPerBlock tiles, the first that fills the
// card's block slots in nearly whole waves (>= 90 %), else the one that fills
// them best; bounded by the tiles and the scratch buffer. <= 0 on a CUDA error.
int choose_splits(const Plan& p) {
  int dev = 0, sms = 0, occ = 0;
  const void* kern = reinterpret_cast<const void*>(kernel_for(p.MT, p.NT));
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return -1;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem) !=
      cudaSuccess)
    return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, kThreads, p.smem) != cudaSuccess)
    return -1;
  if (sms < 1 || occ < 1) return -1;
  const double slots = (double)sms * occ;
  const long long units = (long long)p.ciBlocks * p.coBlocks;
  long long maxS = kScratchBytes / ((long long)p.K * p.K * p.K * p.Cin * p.Cout * sizeof(float));
  if (maxS < 1) maxS = 1;
  if (maxS > p.tiles) maxS = p.tiles;
  if (maxS > 65535) maxS = 65535;
  long long minS = (p.tiles + kMaxTilesPerBlock - 1) / kMaxTilesPerBlock;
  if (minS > maxS) minS = maxS;
  long long bestS = minS;
  double bestEff = -1.0;
  for (long long s = minS; s <= maxS; ++s) {
    const double waves = (double)(units * s) / slots;
    const double full = (double)(long long)(waves + 0.999999);
    const double eff = waves / (full < 1.0 ? 1.0 : full);
    if (eff > bestEff + 1e-9) { bestEff = eff; bestS = s; }
    if (eff >= 0.9) { bestS = s; break; }
  }
  return (int)bestS;
}

}  // namespace libconv
}  // namespace

// Slices of the scratch buffer (slices, K^3, Cin, Cout) float32 that
// spsg_libconv_dw_launch needs for these shapes and pointers on the current
// device; <= 0 on a shape it does not take or a CUDA error.
extern "C" int spsg_libconv_dw_slices(const void* x, const void* dy, int B, int Z, int Y, int X,
                                      int Cin, int Cout, int K, int S, int P) {
  namespace lc = libconv;
  if (lc::bad_shape(B, Z, Y, X, Cin, Cout, K, S, P)) return -1;
  const lc::Plan p = lc::make_plan(B, Z, Y, X, Cin, Cout, K, S, P, x, dy);
  if (lc::bad_plan(p)) return -1;
  return lc::choose_splits(p);
}

// x (B,Z,Y,X,Cin) and dy (B,OZ,OY,OX,Cout) float32, contiguous, on the current
// device, OZ = (Z + 2P - K)/S + 1 and so on; partials (slices, K^3, Cin, Cout)
// float32 scratch with `slices` as spsg_libconv_dw_slices gave it; dw (Cout,
// Cin, K, K, K) float32. Returns the cudaError_t of the launches (0 =
// success), -1 on bad arguments.
extern "C" int spsg_libconv_dw_launch(const void* x, const void* dy, void* partials, void* dw,
                                      int B, int Z, int Y, int X, int Cin, int Cout, int K, int S,
                                      int P, int slices, void* stream_ptr) {
  namespace lc = libconv;
  if (lc::bad_shape(B, Z, Y, X, Cin, Cout, K, S, P)) return -1;
  const lc::Plan p = lc::make_plan(B, Z, Y, X, Cin, Cout, K, S, P, x, dy);
  if (lc::bad_plan(p)) return -1;
  if (slices < 1 || slices > p.tiles || slices > 65535) return -1;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const void* kern = reinterpret_cast<const void*>(lc::kernel_for(p.MT, p.NT));
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  const float* xf = static_cast<const float*>(x);
  const float* dyf = static_cast<const float*>(dy);
  float* part = static_cast<float*>(partials);
  void* args[] = {&xf, &dyf, &part, const_cast<lc::Plan*>(&p)};
  dim3 grid((unsigned)((long long)p.ciBlocks * p.coBlocks), (unsigned)slices);
  err = cudaLaunchKernel(kern, grid, dim3(lc::kThreads), args, p.smem, stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int K3 = K * K * K;
  const long long n = (long long)K3 * Cin * Cout;
  lc::libconv_dw_join_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      part, slices, K3, Cin, Cout, static_cast<float*>(dw));
  return (int)cudaGetLastError();
}
