// 3x3x3, stride-1, zero-pad-1, channel-last 3D convolution for Hopper (sm_90a),
// with an optional fused epilogue (bias + LeakyReLU(0.2) + per-channel sum and
// sum of squares of the stored values).
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
// What bounds it on an H100: operations. At the generator's shapes the
// arithmetic intensity is 2*27*Cin*Cout flops per (Cin+Cout) stored elements,
// i.e. hundreds of flops per byte. This first version keeps the arithmetic in
// float32 FMA on the CUDA cores for both storage types (no tensor cores), so
// it sits well below the card's bf16 tensor-core rate; `wgmma` is later work.
//
// Design:
//   * One block of 128 threads computes, for one (b, z), a tile of TY x TX
//     voxels and up to NG*8 output channels. A thread owns RM voxels (same x,
//     rows TYB apart) times NG*8 channels in registers.
//   * The input is never padded in memory: the block stages a halo slab
//     [KC channels][3][TY+2][TX+2] in shared memory and writes zeros where the
//     slab leaves the volume or the channel range.
//   * The weight matrix (27*Cin x Cout, up to 1 MB) does not fit shared memory,
//     so the block loops over Cin in chunks of KC channels and stages the
//     27 x KC x NG*8 weights of one chunk beside the slab.
//   * In the inner loop a warp reads its voxels' values from consecutive shared
//     memory words and all threads read the same weights (broadcast float4).
//   * Ragged Cin / Cout / X / Y are masked, never padded; offsets are 64 bit.
//   * Statistics: blocks run in no order, so each block reduces its tile
//     (registers -> warp shuffles -> shared memory, all in a fixed order) and
//     writes one partial row; a second small kernel sums the rows in a fixed
//     order. No atomics: results repeat bit for bit from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// input channels per shared-memory chunk: divides the forward's 10, 20, 25, 40, 100;
// the backward (dx: the cotangent's channels are the input) also brings 1, 3 and 14,
// whose last chunk is ragged and masked like any other edge
constexpr int KC = 5;

__device__ __forceinline__ float ldf(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// value as it will read back from storage of type T
__device__ __forceinline__ float stored(float v, const float*) { return v; }
__device__ __forceinline__ float stored(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void st1(float* p, float v) { *p = v; }
__device__ __forceinline__ void st1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, float a, float b, float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<unsigned int*>(&lo);
  u.y = *reinterpret_cast<unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

template <typename T, int NG, int RM, bool STATS>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const float* __restrict__ bias, T* __restrict__ y,
               float* __restrict__ partials, int Z, int Y, int X, int Cin,
               int Cout, int TX, int tilesX, int tilesY) {
  constexpr int NG8 = NG * 8;
  extern __shared__ __align__(16) float smem[];
  const int TYB = kThreads / TX;  // thread rows
  const int TY = TYB * RM;        // voxel rows of the tile
  const int HX = TX + 2;
  const int HY = TY + 2;
  const int slab = 3 * HY * HX;           // floats of one input channel
  float* wsm = smem;                      // [27][KC][NG8], 16-byte aligned
  float* xsm = smem + 27 * KC * NG8;      // [KC][3][HY][HX]
  float* red = xsm + KC * slab;           // STATS: [kWarps][2][NG8]
  float* bsm = red + kWarps * 2 * NG8;    // STATS: [NG8]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int tx = tid % TX;
  const int ty = tid / TX;

  int t = blockIdx.x;
  const int tileX = t % tilesX;
  t /= tilesX;
  const int tileY = t % tilesY;
  t /= tilesY;
  const int z = t % Z;
  const int b = t / Z;
  const int x0 = tileX * TX;
  const int y0 = tileY * TY;
  const int co0 = blockIdx.y * NG8;

  if (STATS) {
    if (tid < NG8) bsm[tid] = (co0 + tid < Cout) ? bias[co0 + tid] : 0.f;
  }

  float acc[RM][NG8];
#pragma unroll
  for (int j = 0; j < RM; ++j)
#pragma unroll
    for (int n = 0; n < NG8; ++n) acc[j][n] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += KC) {
    if (c0 > 0) __syncthreads();  // the previous chunk has been consumed

    // halo slab: one warp per (dz, hy) row; along the row (x, c) is contiguous
    // in memory apart from the channels outside this chunk
    for (int row = warp; row < 3 * HY; row += kWarps) {
      const int dz = row / HY;
      const int hy = row - dz * HY;
      const int gz = z + dz - 1;
      const int gy = y0 + hy - 1;
      const bool rowok = (gz >= 0) && (gz < Z) && (gy >= 0) && (gy < Y);
      const long long rowoff =
          rowok ? (((long long)b * Z + gz) * Y + gy) * (long long)X * Cin : 0;
      float* dst = xsm + row * HX;
      for (int j = lane; j < HX * KC; j += 32) {
        const int hx = j / KC;
        const int c = j - hx * KC;
        const int gx = x0 + hx - 1;
        const int gc = c0 + c;
        float v = 0.f;
        if (rowok && gx >= 0 && gx < X && gc < Cin)
          v = ldf(x + rowoff + (long long)gx * Cin + gc);
        dst[c * slab + hx] = v;
      }
    }
    // weights of this chunk
    for (int i = tid; i < 27 * KC * NG8; i += kThreads) {
      const int n = i % NG8;
      const int r = i / NG8;
      const int c = r % KC;
      const int tap = r / KC;
      const int gc = c0 + c;
      const int co = co0 + n;
      float v = 0.f;
      if (gc < Cin && co < Cout) v = ldf(w + ((long long)tap * Cin + gc) * Cout + co);
      wsm[i] = v;
    }
    __syncthreads();

#pragma unroll 1
    for (int dz = 0; dz < 3; ++dz) {
#pragma unroll 1
      for (int dy = 0; dy < 3; ++dy) {
        const float* xrow = xsm + (dz * HY + ty + dy) * HX + tx;
        const float* wrow = wsm + (dz * 3 + dy) * 3 * KC * NG8;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
          for (int c = 0; c < KC; ++c) {
            float a[RM];
#pragma unroll
            for (int j = 0; j < RM; ++j) a[j] = xrow[c * slab + j * TYB * HX + dx];
            const float4* wv = reinterpret_cast<const float4*>(wrow + (dx * KC + c) * NG8);
#pragma unroll
            for (int g = 0; g < NG * 2; ++g) {
              const float4 q = wv[g];
#pragma unroll
              for (int j = 0; j < RM; ++j) {
                acc[j][g * 4 + 0] = fmaf(a[j], q.x, acc[j][g * 4 + 0]);
                acc[j][g * 4 + 1] = fmaf(a[j], q.y, acc[j][g * 4 + 1]);
                acc[j][g * 4 + 2] = fmaf(a[j], q.z, acc[j][g * 4 + 2]);
                acc[j][g * 4 + 3] = fmaf(a[j], q.w, acc[j][g * 4 + 3]);
              }
            }
          }
        }
      }
    }
  }

  // epilogue: (bias, LeakyReLU), round to the stored type, store; acc keeps
  // the stored values (0 outside the volume / channel range) for the sums
  const bool vec4 = (Cout & 3) == 0;
  const long long plane = ((long long)b * Z + z) * Y;
  const int gx = x0 + tx;
#pragma unroll
  for (int j = 0; j < RM; ++j) {
    const int gy = y0 + ty + j * TYB;
    const bool ok = (gy < Y) && (gx < X);
#pragma unroll
    for (int n = 0; n < NG8; ++n) {
      float v = acc[j][n];
      if (STATS) {
        v += bsm[n];
        v = v > 0.f ? v : 0.2f * v;
      }
      v = stored(v, y);
      acc[j][n] = (ok && (co0 + n < Cout)) ? v : 0.f;
    }
    if (ok) {
      T* dst = y + ((plane + gy) * X + gx) * (long long)Cout + co0;
      if (vec4) {
#pragma unroll
        for (int g = 0; g < NG * 2; ++g)
          if (co0 + g * 4 < Cout)
            st4(dst + g * 4, acc[j][g * 4], acc[j][g * 4 + 1], acc[j][g * 4 + 2],
                acc[j][g * 4 + 3]);
      } else {
#pragma unroll
        for (int n = 0; n < NG8; ++n)
          if (co0 + n < Cout) st1(dst + n, acc[j][n]);
      }
    }
  }

  if (STATS) {
#pragma unroll
    for (int n = 0; n < NG8; ++n) {
      float s = 0.f, ss = 0.f;
#pragma unroll
      for (int j = 0; j < RM; ++j) {
        s += acc[j][n];
        ss = fmaf(acc[j][n], acc[j][n], ss);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
        ss += __shfl_xor_sync(0xffffffffu, ss, off);
      }
      if (lane == 0) {
        red[(warp * 2 + 0) * NG8 + n] = s;
        red[(warp * 2 + 1) * NG8 + n] = ss;
      }
    }
    __syncthreads();
    if (tid < 2 * NG8) {
      const int k = tid / NG8;
      const int n = tid - k * NG8;
      float s = 0.f;
#pragma unroll
      for (int wp = 0; wp < kWarps; ++wp) s += red[(wp * 2 + k) * NG8 + n];
      if (co0 + n < Cout)
        partials[((long long)blockIdx.x * 2 + k) * Cout + co0 + n] = s;
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

struct Plan {
  int NG;      // 8-channel groups per block (template value)
  int RM;      // voxels per thread (template value, fixed by NG)
  int ngy;     // blocks along the output channels
  int TX, TY;  // tile extent in voxels
  int tilesX, tilesY;
  long long gridx;
};

Plan make_plan(int B, int Z, int Y, int X, int Cout) {
  Plan p;
  const int groups = (Cout + 7) / 8;
  int ngy = (groups + 6) / 7;
  const int per = (groups + ngy - 1) / ngy;
  p.NG = per <= 1 ? 1 : per <= 2 ? 2 : per <= 3 ? 3 : per <= 5 ? 5 : 7;
  p.ngy = (groups + p.NG - 1) / p.NG;
  p.RM = p.NG <= 3 ? 4 : 2;
  p.TX = X >= 32 ? 32 : X >= 16 ? 16 : 8;
  p.TY = (kThreads / p.TX) * p.RM;
  p.tilesX = (X + p.TX - 1) / p.TX;
  p.tilesY = (Y + p.TY - 1) / p.TY;
  p.gridx = (long long)B * Z * p.tilesY * p.tilesX;
  return p;
}

template <typename T, int NG, bool STATS>
int launch(const Plan& p, const void* x, const void* w, const void* bias, void* y,
           void* partials, int Z, int Y, int X, int Cin, int Cout, cudaStream_t stream) {
  constexpr int RM = NG <= 3 ? 4 : 2;
  constexpr int NG8 = NG * 8;
  auto kern = conv3x3_kernel<T, NG, RM, STATS>;
  const int HX = p.TX + 2, HY = p.TY + 2;
  const size_t smem =
      sizeof(float) * (size_t)(27 * KC * NG8 + KC * 3 * HY * HX + kWarps * 2 * NG8 + NG8);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)p.gridx, (unsigned)p.ngy);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(bias),
      static_cast<T*>(y), static_cast<float*>(partials), Z, Y, X, Cin, Cout, p.TX,
      p.tilesX, p.tilesY);
  return (int)cudaGetLastError();
}

template <typename T, bool STATS>
int dispatch(const Plan& p, const void* x, const void* w, const void* bias, void* y,
             void* partials, int Z, int Y, int X, int Cin, int Cout, cudaStream_t stream) {
  switch (p.NG) {
    case 1: return launch<T, 1, STATS>(p, x, w, bias, y, partials, Z, Y, X, Cin, Cout, stream);
    case 2: return launch<T, 2, STATS>(p, x, w, bias, y, partials, Z, Y, X, Cin, Cout, stream);
    case 3: return launch<T, 3, STATS>(p, x, w, bias, y, partials, Z, Y, X, Cin, Cout, stream);
    case 5: return launch<T, 5, STATS>(p, x, w, bias, y, partials, Z, Y, X, Cin, Cout, stream);
    default: return launch<T, 7, STATS>(p, x, w, bias, y, partials, Z, Y, X, Cin, Cout, stream);
  }
}

}  // namespace

// Rows of the statistics scratch buffer (rows, 2, Cout) that
// spsg_conv3x3_launch needs for these shapes; <= 0 on a bad shape.
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
  if (p.gridx > 2147483647LL) return -1;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int err;
  if (with_stats) {
    err = dtype == 0
              ? dispatch<float, true>(p, x, w, bias, y, partials, Z, Y, X, Cin, Cout, stream)
              : dispatch<__nv_bfloat16, true>(p, x, w, bias, y, partials, Z, Y, X, Cin, Cout,
                                              stream);
    if (err != 0) return err;
    reduce_partials_kernel<<<2 * Cout, 256, 0, stream>>>(
        static_cast<const float*>(partials), p.gridx, 2 * Cout, static_cast<float*>(stats));
    return (int)cudaGetLastError();
  }
  err = dtype == 0
            ? dispatch<float, false>(p, x, w, nullptr, y, nullptr, Z, Y, X, Cin, Cout, stream)
            : dispatch<__nv_bfloat16, false>(p, x, w, nullptr, y, nullptr, Z, Y, X, Cin, Cout,
                                             stream);
  return err;
}
