// The depth chain's kernels for Hopper (sm_90a): the bilateral filter (K9),
// one round of the median hole fill (K10) with the fill loop around it, and
// the unprojection with the cross-product normals (K11). The wrappers and the
// plain PyTorch versions they must match to the bit are in ops/depth.py
// (bilateral_filter_plain, median_fill_plain, fill_depth_holes_plain,
// unproject_normals_plain).
//
// None replaces a Pallas kernel: the JAX package left the depth chain to XLA
// (spsg_tpu/ops/depth.py: bilateral_filter :34, median_fill :56,
// fill_depth_holes :77 with its lax.while_loop :87-95, depth_to_camera_space
// :103, camera_space_normals :121), as window stacks of shifted slabs. In
// PyTorch the same stacks are 81 and 121 slabs a pass and a sort a fill round,
// and the loop's "any hole left" test reads a flag back to the host every
// round. Here each stage is one thread per pixel and the loop never waits for
// the host.
//
// Compiled with -fmad=false (ops/_build.py): no a * b + c is fused but where
// the source says __fmaf_rn, which is exactly where XLA fuses the JAX
// package's arithmetic on the CPU and the plain version calls
// ops/xla_arith.py's fma32 (ROADMAP.md, Queue C, "agreed arithmetic"):
// exp's reduction and polynomial, the millimetres, the cross product and the
// squared norm. Divisions and roots are IEEE (__fdiv_rn, __fsqrt_rn), exp is
// XLA's polynomial (exp32 below, never expf), and every sum is taken in the
// plain version's order, so each output equals the plain version's to the bit.
//
// K9 depth_bilateral_kernel, a 16x16 tile of pixels a block, the tile and its
// 4-pixel apron in shared memory. Per pixel, the 81 taps of the 9x9 window in
// row-major order: w = w_spatial[t] * exp32((d * -d) * range_scale), d = the
// neighbour minus the centre, where the neighbour is not 0 (outside the image
// counts as 0), else 0; the weights and the products w * neighbour summed in
// XLA's blocks of 32 taps (ops/xla_arith.py block_sum: for 81 taps [0,25),
// [25,57), [57,81), each left to right, then the three block sums left to
// right); out = num / max(wsum, 1e-12) where wsum > 0 and the centre is not
// 0, else 0. The spatial weights come from the wrapper (exp32 on the host).
// Optionally it flags each frame that holds a hole (the fill's "had").
// Bound: operations, ~81 exp32 of ~25 float32 operations and 6 more a tap:
// ~0.4 GFLOP at the step's 2 x 320x256, a few microseconds at 67 TFLOP/s;
// the image is read and written once (1.3 MB).
//
// K10 depth_median_round_kernel, a 16x16 tile a block with its 5-pixel
// apron: a pixel that is not a hole is copied; a hole takes the upper median
// of the valid pixels of its 11x11 window in millimetres m = floor(fma(depth,
// 1000, 1/2)) (computed once a pixel, as it is staged), by counting, not by
// sorting: with n valid pixels and pick = min((n + 1) / 2, max(n - 1, 0)),
// the value m_j of a valid neighbour with less_j <= pick < less_or_equal_j
// (less_j = the valid pixels below m_j, less_or_equal_j = those at or below),
// which is the element `pick` of the sorted window, ties and all; the hole
// becomes 0.001f * m_j, or stays 0 where there is none (n = 0). A round reads
// one buffer and writes the other: in place, a hole filled early in a round
// would feed its neighbours in the same round. Bound: operations, up to 121
// compares of 121 values a hole (the first round at the step's frames: ~23k
// holes, ~0.35 G compares; 5 us at 67 TFLOP/s) and the frame read and written
// once a round.
//
// The fill loop (spsg_depth_fill), all on the stream, no host read: the
// bilateral filter of every frame (flagging the frames with holes), round 0
// on it (a frame without holes takes its own depth instead, as if untouched),
// then rounds 1 .. max_iters, each first reading the flag "a hole is left
// after the previous round" that the previous round wrote; where it is 0 the
// round returns at once (a round without holes changes nothing, so the rounds
// that run are those of the plain loop, which stops at the first round after
// which no frame that had holes has one, or after max_iters). A last kernel
// finds the buffer of the last round that ran, writes the output (a frame
// without holes: its own depth) and all_valid (no hole left in the frame).
//
// K11 depth_normals_kernel, one thread per pixel: the camera-space point of
// the pixel and its four neighbours (x = depth * (gx - mx) / fx, y likewise,
// z = depth; (0, 0, 0) where depth is 0), a = p(y+1) - p(y-1), b = p(x+1) -
// p(x-1), n = (fma(a1, b2, -(a2 b1)), fma(a2, b0, -(a0 b2)), fma(a0, b1,
// -(a1 b0))), l2 = fma(n2, n2, fma(n1, n1, n0 n0)), the normal n / -sqrt(max(
// l2, 1e-24)) where l2 > 0 and the x of the centre or of a neighbour is not 0,
// else 0; 0 on the image's border. Bound: bytes (the depth read, 12 bytes a
// pixel written).

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;  // a block's pixels on each axis
constexpr int kThreads = kTile * kTile;

// XLA's CPU exp for float32 (ops/xla_arith.py exp32; Cephes' expf), each
// constant a float32
constexpr float kExpLo = -87.80000305175781f;
constexpr float kExpHi = 88.80000305175781f;
constexpr float kLog2e = 1.4426950216293335f;
constexpr float kLn2Hi = 0.693359375f;
constexpr float kLn2Lo = -0.00021219444170128554f;
constexpr float kP0 = 0.00019875691214110702f, kP1 = 0.001398199936375022f,
                kP2 = 0.008333452045917511f, kP3 = 0.04166579619050026f,
                kP4 = 0.1666666567325592f, kP5 = 0.5f;
constexpr float kTinyNormal = 1.1754943508222875e-38f;  // 2^-126

// torch.clamp: NaN stays NaN
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ float exp32(float x) {
  x = clampf(x, kExpLo, kExpHi);
  const float n = clampf(floorf(__fmaf_rn(x, kLog2e, 0.5f)), -127.f, 127.f);
  float r = __fmaf_rn(n, -kLn2Hi, x);
  r = __fmaf_rn(n, -kLn2Lo, r);
  float y = __fmaf_rn(r, kP0, kP1);
  y = __fmaf_rn(y, r, kP2);
  y = __fmaf_rn(y, r, kP3);
  y = __fmaf_rn(y, r, kP4);
  y = __fmaf_rn(y, r, kP5);
  y = __fmaf_rn(y, r * r, r) + 1.f;
  const float out = y * __int_as_float(((int)n + 127) << 23);
  return out < kTinyNormal ? 0.f : out;
}

// The frame b's tile with an apron of r pixels into shared memory, `fill`
// outside the image; tw = kTile + 2 r.
__device__ __forceinline__ void stage(const float* __restrict__ img, float* tile, int b, int H,
                                      int W, int r, float fill) {
  const int tw = kTile + 2 * r;
  const int x0 = blockIdx.x * kTile - r, y0 = blockIdx.y * kTile - r;
  const float* frame = img + (long long)b * H * W;
  for (int i = threadIdx.y * kTile + threadIdx.x; i < tw * tw; i += kThreads) {
    const int y = y0 + i / tw, x = x0 + i % tw;
    tile[i] = (y >= 0 && y < H && x >= 0 && x < W) ? __ldg(frame + (long long)y * W + x) : fill;
  }
}

__global__ void __launch_bounds__(kThreads) depth_bilateral_kernel(
    const float* __restrict__ depth, const float* __restrict__ w_spatial, float* __restrict__ out,
    int* __restrict__ had, int H, int W, int r, float range_scale) {
  extern __shared__ float tile[];
  __shared__ int any_hole;
  const int b = blockIdx.z;
  if (threadIdx.x == 0 && threadIdx.y == 0) any_hole = 0;
  stage(depth, tile, b, H, W, r, 0.f);
  __syncthreads();
  const int x = blockIdx.x * kTile + threadIdx.x, y = blockIdx.y * kTile + threadIdx.y;
  const int tw = kTile + 2 * r, k = 2 * r + 1, n = k * k;
  if (x < W && y < H) {
    const float* win = tile + threadIdx.y * tw + threadIdx.x;
    const float c = win[r * tw + r];
    // block_sum's blocks: block i is [max(0, 32 i - front), min(n, 32 (i + 1) - front))
    const int front = ((n + 31) / 32 * 32 - n) / 2;
    float wsum = 0.f, num = 0.f, wpart = 0.f, npart = 0.f;
    bool first = true;
    for (int i = 0, t = 0; i < k; ++i) {
      for (int j = 0; j < k; ++j, ++t) {
        const float v = win[i * tw + j];
        const float d = v - c;
        const float w = v != 0.f ? __ldg(w_spatial + t) * exp32((d * -d) * range_scale) : 0.f;
        const float wv = w * v;
        if (t == 0 || (t + front) % 32 == 0) {
          if (t > 0) {
            wsum = first ? wpart : wsum + wpart;
            num = first ? npart : num + npart;
            first = false;
          }
          wpart = w;
          npart = wv;
        } else {
          wpart = wpart + w;
          npart = npart + wv;
        }
      }
    }
    wsum = first ? wpart : wsum + wpart;
    num = first ? npart : num + npart;
    const float o = wsum > 0.f ? __fdiv_rn(num, wsum < 1e-12f ? 1e-12f : wsum) : 0.f;
    out[((long long)b * H + y) * W + x] = c != 0.f ? o : 0.f;
    if (had != nullptr && c == 0.f) any_hole = 1;
  }
  if (had != nullptr) {
    __syncthreads();
    if (threadIdx.x == 0 && threadIdx.y == 0 && any_hole) had[b] = 1;
  }
}

// One round of the median fill. The frame b is read from `src`, or from `alt`
// where had[b] is 0 (round 0 of the fill: a frame without holes is not
// filtered); with `left_in`, the round returns at once where *left_in is 0;
// with `left_out`, it sets *left_out to 1 where a hole is left.
__global__ void __launch_bounds__(kThreads) depth_median_round_kernel(
    const float* __restrict__ src, const float* __restrict__ alt, const int* __restrict__ had,
    const int* __restrict__ left_in, int* __restrict__ left_out, float* __restrict__ dst, int H,
    int W, int r) {
  if (left_in != nullptr && *left_in == 0) return;
  extern __shared__ float mm[];  // tw * tw millimetres (inf: not valid), then the depths
  __shared__ int any_hole;
  const int b = blockIdx.z;
  const float* img = (had != nullptr && had[b] == 0) ? alt : src;
  const int tw = kTile + 2 * r, k = 2 * r + 1;
  float* raw = mm + tw * tw;
  if (threadIdx.x == 0 && threadIdx.y == 0) any_hole = 0;
  stage(img, raw, b, H, W, r, 0.f);
  __syncthreads();
  for (int i = threadIdx.y * kTile + threadIdx.x; i < tw * tw; i += kThreads) {
    const float v = raw[i];
    mm[i] = v != 0.f ? floorf(__fmaf_rn(v, 1000.f, 0.5f)) : INFINITY;
  }
  __syncthreads();
  const int x = blockIdx.x * kTile + threadIdx.x, y = blockIdx.y * kTile + threadIdx.y;
  if (x < W && y < H) {
    const int centre = (threadIdx.y + r) * tw + threadIdx.x + r;
    float o = raw[centre];
    if (o == 0.f) {
      const float* mwin = mm + threadIdx.y * tw + threadIdx.x;
      const float* dwin = raw + threadIdx.y * tw + threadIdx.x;
      int nvalid = 0;
      for (int i = 0; i < k; ++i)
        for (int j = 0; j < k; ++j) nvalid += dwin[i * tw + j] != 0.f;
      const int pick = min((nvalid + 1) / 2, max(nvalid - 1, 0));
      float val = INFINITY;
      // each valid neighbour in window order until one is element `pick`
      for (int c = 0; c < k * k && val == INFINITY; ++c) {
        const int cc = (c / k) * tw + c % k;
        if (dwin[cc] == 0.f) continue;
        const float m = mwin[cc];
        if (!(m < INFINITY)) continue;  // not finite: the element would not count
        int less = 0, leq = 0;
        for (int i = 0; i < k; ++i) {
          for (int j = 0; j < k; ++j) {
            const float q = mwin[i * tw + j];
            less += q < m;
            leq += q <= m;
          }
        }
        if (less <= pick && pick < leq) val = m;
      }
      o = (nvalid > 0 && val < INFINITY) ? 0.001f * val : 0.f;
      if (o == 0.f) any_hole = 1;
    }
    dst[((long long)b * H + y) * W + x] = o;
  }
  if (left_out != nullptr) {
    __syncthreads();
    if (threadIdx.x == 0 && threadIdx.y == 0 && any_hole) *left_out = 1;
  }
}

// The fill's output: the buffer of the last round that ran (round L writes
// bufs[L % 2]; L = the rounds after round 0 whose flag was set, at most
// max_iters), the depth itself for a frame without holes, and all_valid[b] =
// 0 where a hole is left (set to 1 before).
__global__ void __launch_bounds__(kThreads) depth_fill_finish_kernel(
    const float* __restrict__ depth, const float* __restrict__ buf0,
    const float* __restrict__ buf1, const int* __restrict__ had, const int* __restrict__ left,
    int max_iters, float* __restrict__ out, uint8_t* __restrict__ all_valid, int H, int W) {
  __shared__ int any_hole;
  const int b = blockIdx.z;
  int rounds = 0;
  while (rounds < max_iters && left[rounds] != 0) ++rounds;
  const float* res = had[b] == 0 ? depth : (rounds % 2 == 0 ? buf0 : buf1);
  if (threadIdx.x == 0 && threadIdx.y == 0) any_hole = 0;
  __syncthreads();
  const int x = blockIdx.x * kTile + threadIdx.x, y = blockIdx.y * kTile + threadIdx.y;
  if (x < W && y < H) {
    const long long i = ((long long)b * H + y) * W + x;
    const float v = res[i];
    out[i] = v;
    if (v == 0.f) any_hole = 1;
  }
  __syncthreads();
  if (threadIdx.x == 0 && threadIdx.y == 0 && any_hole) all_valid[b] = 0;
}

struct Point {
  float x, y, z;
};

// The camera-space point of pixel (x, y) of a frame: (0, 0, 0) where its depth is 0
__device__ __forceinline__ Point unproject(const float* __restrict__ frame, int W, int x, int y,
                                           float fx, float fy, float mx, float my) {
  const float d = __ldg(frame + (long long)y * W + x);
  if (d == 0.f) return {0.f, 0.f, 0.f};
  return {__fdiv_rn(d * ((float)x - mx), fx), __fdiv_rn(d * ((float)y - my), fy), d};
}

__global__ void __launch_bounds__(kThreads) depth_normals_kernel(
    const float* __restrict__ depth, const float* __restrict__ intrinsics,
    float* __restrict__ normals, int H, int W) {
  const int b = blockIdx.z;
  const int x = blockIdx.x * kTile + threadIdx.x, y = blockIdx.y * kTile + threadIdx.y;
  if (x >= W || y >= H) return;
  float* o = normals + (((long long)b * H + y) * W + x) * 3;
  float n0 = 0.f, n1 = 0.f, n2 = 0.f;
  if (x > 0 && x < W - 1 && y > 0 && y < H - 1) {
    const float fx = __ldg(intrinsics + 4 * b), fy = __ldg(intrinsics + 4 * b + 1),
                mx = __ldg(intrinsics + 4 * b + 2), my = __ldg(intrinsics + 4 * b + 3);
    const float* frame = depth + (long long)b * H * W;
    const Point cc = unproject(frame, W, x, y, fx, fy, mx, my);
    const Point pc = unproject(frame, W, x, y + 1, fx, fy, mx, my);
    const Point mc = unproject(frame, W, x, y - 1, fx, fy, mx, my);
    const Point cp = unproject(frame, W, x + 1, y, fx, fy, mx, my);
    const Point cm = unproject(frame, W, x - 1, y, fx, fy, mx, my);
    const float a0 = pc.x - mc.x, a1 = pc.y - mc.y, a2 = pc.z - mc.z;
    const float b0 = cp.x - cm.x, b1 = cp.y - cm.y, b2 = cp.z - cm.z;
    const float c0 = __fmaf_rn(a1, b2, -(a2 * b1));
    const float c1 = __fmaf_rn(a2, b0, -(a0 * b2));
    const float c2 = __fmaf_rn(a0, b1, -(a1 * b0));
    const float l2 = __fmaf_rn(c2, c2, __fmaf_rn(c1, c1, c0 * c0));
    const bool some_valid =
        cc.x != 0.f || pc.x != 0.f || cp.x != 0.f || mc.x != 0.f || cm.x != 0.f;
    if (l2 > 0.f && some_valid) {
      const float nl = -__fsqrt_rn(l2 < 1e-24f ? 1e-24f : l2);
      n0 = __fdiv_rn(c0, nl);
      n1 = __fdiv_rn(c1, nl);
      n2 = __fdiv_rn(c2, nl);
    }
  }
  o[0] = n0;
  o[1] = n1;
  o[2] = n2;
}

dim3 grid_for(int B, int H, int W) {
  return dim3((unsigned)((W + kTile - 1) / kTile), (unsigned)((H + kTile - 1) / kTile),
              (unsigned)B);
}

bool bad_shape(int B, int H, int W, int r) {
  return B <= 0 || H <= 0 || W <= 0 || B > 65535 || r < 0 || r > 16 ||
         (long long)B * H * W >= (1LL << 31);
}

size_t tile_bytes(int r) { return sizeof(float) * (kTile + 2 * r) * (kTile + 2 * r); }

cudaError_t launch_bilateral(const float* depth, const float* w_spatial, float* out, int* had,
                             int B, int H, int W, int r, float range_scale,
                             cudaStream_t stream) {
  depth_bilateral_kernel<<<grid_for(B, H, W), dim3(kTile, kTile), tile_bytes(r), stream>>>(
      depth, w_spatial, out, had, H, W, r, range_scale);
  return cudaGetLastError();
}

cudaError_t launch_round(const float* src, const float* alt, const int* had, const int* left_in,
                         int* left_out, float* dst, int B, int H, int W, int r,
                         cudaStream_t stream) {
  depth_median_round_kernel<<<grid_for(B, H, W), dim3(kTile, kTile), 2 * tile_bytes(r),
                              stream>>>(src, alt, had, left_in, left_out, dst, H, W, r);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after its launches (0 = launched). Images
// are (B, H, W) float32, contiguous; r is the window's radius (the bilateral
// filter's ceil(2 sigma_d), the median's structure radius); w_spatial holds
// the (2 r + 1)^2 spatial weights in row-major window order.

int spsg_depth_bilateral(const float* depth, const float* w_spatial, float* out, int B, int H,
                         int W, int r, float range_scale, cudaStream_t stream) {
  if (bad_shape(B, H, W, r)) return (int)cudaErrorInvalidValue;
  return (int)launch_bilateral(depth, w_spatial, out, nullptr, B, H, W, r, range_scale, stream);
}

int spsg_depth_median_round(const float* src, float* dst, int B, int H, int W, int r,
                            cudaStream_t stream) {
  if (bad_shape(B, H, W, r)) return (int)cudaErrorInvalidValue;
  return (int)launch_round(src, nullptr, nullptr, nullptr, nullptr, dst, B, H, W, r, stream);
}

// The fill loop: K9 into buf1 (flagging the frames with holes in flags[0, B)),
// round 0 from it into buf0, rounds 1 .. max_iters between buf0 and buf1
// (round k writes buf[k % 2] and sets flags[B + k] where a hole is left), then
// `out` and `all_valid` (B bytes). `flags`: B + max_iters + 1 ints, zeroed
// here.
int spsg_depth_fill(const float* depth, const float* w_spatial, float* buf0, float* buf1,
                    int* flags, float* out, uint8_t* all_valid, int B, int H, int W,
                    int r_bilateral, float range_scale, int r_median, int max_iters,
                    cudaStream_t stream) {
  if (bad_shape(B, H, W, r_bilateral) || bad_shape(B, H, W, r_median) || max_iters < 0)
    return (int)cudaErrorInvalidValue;
  int* had = flags;
  int* left = flags + B;
  cudaError_t err = cudaMemsetAsync(flags, 0, sizeof(int) * (B + max_iters + 1), stream);
  if (err == cudaSuccess) err = cudaMemsetAsync(all_valid, 1, B, stream);
  if (err == cudaSuccess)
    err = launch_bilateral(depth, w_spatial, buf1, had, B, H, W, r_bilateral, range_scale, stream);
  if (err == cudaSuccess)
    err = launch_round(buf1, depth, had, nullptr, left, buf0, B, H, W, r_median, stream);
  for (int k = 1; k <= max_iters && err == cudaSuccess; ++k)
    err = launch_round(k % 2 ? buf0 : buf1, nullptr, nullptr, left + k - 1, left + k,
                       k % 2 ? buf1 : buf0, B, H, W, r_median, stream);
  if (err != cudaSuccess) return (int)err;
  depth_fill_finish_kernel<<<grid_for(B, H, W), dim3(kTile, kTile), 0, stream>>>(
      depth, buf0, buf1, had, left, max_iters, out, all_valid, H, W);
  return (int)cudaGetLastError();
}

int spsg_depth_normals(const float* depth, const float* intrinsics, float* normals, int B, int H,
                       int W, cudaStream_t stream) {
  if (bad_shape(B, H, W, 0)) return (int)cudaErrorInvalidValue;
  depth_normals_kernel<<<grid_for(B, H, W), dim3(kTile, kTile), 0, stream>>>(depth, intrinsics,
                                                                            normals, H, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
