// Weight gradient of the 3x3x3, stride-1, zero-pad-1, channel-last 3D
// convolution for Hopper (sm_90a).
//
// Replaces the TPU kernel _dw_kernel (launcher _conv3x3_dw_impl) of the JAX
// package (spsg_tpu/ops/pallas_conv.py). For tap = (dz, dy, dx):
//   dW[tap, ci, co] = sum over (b, z, y, x) of
//                     xpad[b, z+dz, y+dy, x+dx, ci] * dy[b, z, y, x, co]
// with xpad the input with a zero halo of one voxel, accumulated in float32
// whatever the storage type (float32 or bfloat16); the output is float32
// (3,3,3,Cin,Cout), tap-major in (dz, dy, dx) order.
//
// What bounds it on an H100: operations (2*27*Cin*Cout flops per voxel against
// Cin+Cout loaded elements), except for the one-channel heads. Like the
// forward kernel this first version computes in float32 FMA on the CUDA cores.
//
// Design. The TPU kernel walks a sequential grid and adds into one resident
// output block; blocks of a GPU run in no order, so this is a split-K product
// instead: the reduction runs over ~10^6 voxels, the output has at most
// 27*100*100 elements.
//   * A block owns a piece 27 taps x KC input channels x NC output channels of
//     dW (KC = 8 or 16, NC = 8..56); gridDim.y / gridDim.z cover Cin / Cout and
//     gridDim.x splits the voxel tiles into S contiguous shares.
//   * A thread owns one tap, 8 input and 8 output channels of that piece: 64
//     sums in registers, which no other thread shares, so nothing is reduced
//     across threads.
//   * Per tile of TY x TX (= 256) voxels of one (b, z) the block stages the
//     halo slab [3][TY+2][TX+2][KC] of x (zeros written where it leaves the
//     volume or the channel range: no padded copy of the input) and the tile
//     [TY*TX][NC] of dy in shared memory, both channel-last like the arrays in
//     device memory. Per voxel a thread then reads its 8 + 8 operands as four
//     16-byte loads (threads of the same tap or the same output channels read
//     the same words: broadcast) for 64 FMAs.
//   * Every block writes its sums to its own slice of a (S, 27, Cin, Cout)
//     scratch buffer and a second kernel adds the S slices in a fixed order:
//     per-block partials plus a second pass, no float atomics, so results
//     repeat bit for bit. S is chosen from the device's SM count and the
//     kernel's occupancy so that the grid fills the card in whole waves, and
//     so that the scratch buffer stays within 32 MB.
//   * Ragged Cin / Cout are padded with zeros in shared memory up to the next
//     multiple of 8, never in device memory; offsets are 64 bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 192;   // 27 taps x at most 7 (input octet, output octet) pairs
constexpr int kTileVoxels = 256;
constexpr long long kScratchBytes = 32LL << 20;

__device__ __forceinline__ float ldf(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// four consecutive elements; p is aligned to four elements
__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// elements c .. c+3 of a row of n channels starting at p, zeros beyond n
template <typename T>
__device__ __forceinline__ float4 load_quad(const T* p, int c, int n, bool vec) {
  if (vec && c + 3 < n) return ld4(p + c);
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (c < n) v.x = ldf(p + c);
  if (c + 1 < n) v.y = ldf(p + c + 1);
  if (c + 2 < n) v.z = ldf(p + c + 2);
  if (c + 3 < n) v.w = ldf(p + c + 3);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 2)
conv3x3_dw_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                  float* __restrict__ partials, int Z, int Y, int X, int Cin, int Cout,
                  int TX, int TY, int tilesX, int tilesY, long long tiles, int KO, int NO,
                  int xvec, int dvec) {
  extern __shared__ __align__(16) float smem[];
  const int HX = TX + 2;
  const int HY = TY + 2;
  const int KC = KO * 8;
  const int NC = NO * 8;
  const int npos = 3 * HY * HX;
  float* xsm = smem;               // [3][HY][HX][KC]
  float* dsm = smem + npos * KC;   // [TY*TX][NC]

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int P = KO * NO;
  const int tap = tid / P;
  const int pr = tid - tap * P;
  const int ko = pr / NO;
  const int no = pr - ko * NO;
  const int dz = tap / 9;
  const int ky = (tap / 3) % 3;
  const int dx = tap % 3;
  const int c0 = blockIdx.y * KC;
  const int co0 = blockIdx.z * NC;
  const bool active = tap < 27 && (c0 + ko * 8 < Cin) && (co0 + no * 8 < Cout);

  const long long S = gridDim.x;
  const long long t_begin = tiles * (long long)blockIdx.x / S;
  const long long t_end = tiles * ((long long)blockIdx.x + 1) / S;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int xq = KC / 4;  // quads of channels per slab position
  const int dq = NC / 4;  // quads of channels per dy voxel

  for (long long t = t_begin; t < t_end; ++t) {
    long long r = t;
    const int tileX = (int)(r % tilesX);
    r /= tilesX;
    const int tileY = (int)(r % tilesY);
    r /= tilesY;
    const int z = (int)(r % Z);
    const int b = (int)(r / Z);
    const int x0 = tileX * TX;
    const int y0 = tileY * TY;

    if (t > t_begin) __syncthreads();  // the previous tile has been consumed

    // halo slab of x, zeros outside the volume and the channel range
#pragma unroll 4
    for (int i = tid; i < npos * xq; i += nthreads) {
      const int pos = i / xq;
      const int q = i - pos * xq;
      const int hx = pos % HX;
      const int rr = pos / HX;
      const int hy = rr % HY;
      const int hz = rr / HY;
      const int gz = z + hz - 1;
      const int gy = y0 + hy - 1;
      const int gx = x0 + hx - 1;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gz >= 0 && gz < Z && gy >= 0 && gy < Y && gx >= 0 && gx < X)
        v = load_quad(x + ((((long long)b * Z + gz) * Y + gy) * X + gx) * (long long)Cin,
                      c0 + q * 4, Cin, xvec != 0);
      *reinterpret_cast<float4*>(xsm + pos * KC + q * 4) = v;
    }
    // tile of dy, zeros outside the volume and the channel range
    const long long plane = ((long long)b * Z + z) * Y;
#pragma unroll 4
    for (int i = tid; i < TY * TX * dq; i += nthreads) {
      const int v = i / dq;
      const int q = i - v * dq;
      const int vy = v / TX;
      const int vx = v - vy * TX;
      const int gy = y0 + vy;
      const int gx = x0 + vx;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gy < Y && gx < X)
        val = load_quad(dy + ((plane + gy) * X + gx) * (long long)Cout, co0 + q * 4, Cout,
                        dvec != 0);
      *reinterpret_cast<float4*>(dsm + v * NC + q * 4) = val;
    }
    __syncthreads();

    if (active) {
      const float* xb = xsm + ((dz * HY + ky) * HX + dx) * KC + ko * 8;
      const float* db = dsm + no * 8;
      for (int vy = 0; vy < TY; ++vy) {
        const float* xr = xb + vy * HX * KC;
        const float* dr = db + vy * TX * NC;
#pragma unroll 4
        for (int vx = 0; vx < TX; ++vx) {
          const float4 a0 = *reinterpret_cast<const float4*>(xr + vx * KC);
          const float4 a1 = *reinterpret_cast<const float4*>(xr + vx * KC + 4);
          const float4 d0 = *reinterpret_cast<const float4*>(dr + vx * NC);
          const float4 d1 = *reinterpret_cast<const float4*>(dr + vx * NC + 4);
          const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float d[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], d[j], acc[i][j]);
        }
      }
    }
  }

  if (active) {
    float* dst = partials + (long long)blockIdx.x * 27 * Cin * Cout;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int ci = c0 + ko * 8 + i;
      if (ci >= Cin) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int co = co0 + no * 8 + j;
        if (co < Cout) dst[((long long)tap * Cin + ci) * Cout + co] = acc[i][j];
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

struct Plan {
  int TX, TY;
  int tilesX, tilesY;
  long long tiles;
  int KO, NO;          // octets of input / output channels per block
  int ciBlocks, coBlocks;
  int threads;
  size_t smem;
};

Plan make_plan(int B, int Z, int Y, int X, int Cin, int Cout) {
  Plan p;
  p.TX = X >= 32 ? 32 : X >= 16 ? 16 : 8;
  p.TY = kTileVoxels / p.TX;
  if (p.TY > Y) p.TY = Y;
  p.tilesX = (X + p.TX - 1) / p.TX;
  p.tilesY = (Y + p.TY - 1) / p.TY;
  p.tiles = (long long)B * Z * p.tilesY * p.tilesX;
  const int octs_o = (Cout + 7) / 8;
  const int octs_i = (Cin + 7) / 8;
  // output octets per block: at most 7, the choice that pads Cout least (ties: more)
  int best = 1, waste = 1 << 30;
  for (int n = 1; n <= 7; ++n) {
    const int w = (octs_o + n - 1) / n * n - octs_o;
    if (w <= waste) { waste = w; best = n; }
  }
  p.NO = best;
  // two input octets where that pads Cin no further and the block stays within 7 pairs
  p.KO = (2 * p.NO <= 7 && octs_i % 2 == 0) ? 2 : 1;
  p.ciBlocks = (octs_i + p.KO - 1) / p.KO;
  p.coBlocks = (octs_o + p.NO - 1) / p.NO;
  p.threads = (27 * p.KO * p.NO + 31) / 32 * 32;
  p.smem = sizeof(float) * ((size_t)3 * (p.TY + 2) * (p.TX + 2) * p.KO * 8 +
                            (size_t)p.TY * p.TX * p.NO * 8);
  return p;
}

const void* kernel_for(int dtype) {
  return dtype == 0 ? reinterpret_cast<const void*>(&conv3x3_dw_kernel<float>)
                    : reinterpret_cast<const void*>(&conv3x3_dw_kernel<__nv_bfloat16>);
}

// Number of voxel shares S: the smallest that fills the card's block slots in
// nearly whole waves (>= 90 %), else the one that fills them best; bounded by
// the number of tiles and by the scratch buffer. <= 0 on a CUDA error.
int choose_splits(const Plan& p, int dtype, int Cin, int Cout) {
  int dev = 0, sms = 0, occ = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return -1;
  if (cudaFuncSetAttribute(kernel_for(dtype), cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)p.smem) != cudaSuccess)
    return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel_for(dtype), p.threads,
                                                    p.smem) != cudaSuccess)
    return -1;
  if (sms < 1 || occ < 1) return -1;
  const double slots = (double)sms * occ;
  const long long units = (long long)p.ciBlocks * p.coBlocks;
  long long maxS = kScratchBytes / (27LL * Cin * Cout * (long long)sizeof(float));
  if (maxS < 1) maxS = 1;
  if (maxS > p.tiles) maxS = p.tiles;
  const long long want = (long long)(4.0 * slots / (double)units) + 1;
  if (maxS > want) maxS = want;
  if (maxS > 65535) maxS = 65535;
  int bestS = 1;
  double bestEff = -1.0;
  for (long long s = 1; s <= maxS; ++s) {
    const double waves = (double)(units * s) / slots;
    const double full = (double)(long long)(waves + 0.999999);
    const double eff = waves / (full < 1.0 ? 1.0 : full);
    if (eff > bestEff + 1e-9) { bestEff = eff; bestS = (int)s; }
    if (eff >= 0.9) { bestS = (int)s; break; }
  }
  return bestS;
}

bool bad_shape(int B, int Z, int Y, int X, int Cin, int Cout, int dtype) {
  return B < 1 || Z < 1 || Y < 1 || X < 1 || Cin < 1 || Cout < 1 || (dtype != 0 && dtype != 1);
}

}  // namespace

// Slices of the scratch buffer (slices, 27, Cin, Cout) float32 that
// spsg_conv3x3_dw_launch needs for these shapes on the current device;
// <= 0 on a bad shape or a CUDA error.
extern "C" int spsg_conv3x3_dw_slices(int B, int Z, int Y, int X, int Cin, int Cout, int dtype) {
  if (bad_shape(B, Z, Y, X, Cin, Cout, dtype)) return -1;
  const Plan p = make_plan(B, Z, Y, X, Cin, Cout);
  if (p.coBlocks > 65535 || p.ciBlocks > 65535) return -1;
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
  if (p.coBlocks > 65535 || p.ciBlocks > 65535) return -1;
  if (slices < 1 || slices > p.tiles || slices > 65535) return -1;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  float* dst = static_cast<float*>(slices == 1 ? dw : partials);
  // 16-byte (float32) / 8-byte (bfloat16) loads of four channels where rows are aligned
  const uintptr_t quad = dtype == 0 ? 16 : 8;
  int xvec = (Cin % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % quad == 0);
  int dvec = (Cout % 4 == 0) && (reinterpret_cast<uintptr_t>(dy) % quad == 0);
  int Zv = Z, Yv = Y, Xv = X, Civ = Cin, Cov = Cout;
  int TX = p.TX, TY = p.TY, tilesX = p.tilesX, tilesY = p.tilesY, KO = p.KO, NO = p.NO;
  long long tiles = p.tiles;
  void* args[] = {&x,  &dy,     &dst,    &Zv,    &Yv, &Xv, &Civ,  &Cov, &TX,
                  &TY, &tilesX, &tilesY, &tiles, &KO, &NO, &xvec, &dvec};
  dim3 grid((unsigned)slices, (unsigned)p.ciBlocks, (unsigned)p.coBlocks);
  cudaError_t err = cudaFuncSetAttribute(
      kernel_for(dtype), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernel(kernel_for(dtype), grid, dim3((unsigned)p.threads), args, p.smem,
                         stream);
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
