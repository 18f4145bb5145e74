// The depth chain's kernels for Hopper (sm_90a): the bilateral filter (K9),
// the median hole fill (K10: one round, and every round of the fill in one
// cooperative launch) and the unprojection with the cross-product normals
// (K11). The wrappers and the plain PyTorch versions they must match to the
// bit are in ops/depth.py (bilateral_filter_plain, median_fill_plain,
// fill_depth_holes_plain, unproject_normals_plain).
//
// None replaces a Pallas kernel: the JAX package left the depth chain to XLA
// (spsg_tpu/ops/depth.py: bilateral_filter :34, median_fill :56,
// fill_depth_holes :77 with its lax.while_loop :87-95, depth_to_camera_space
// :103, camera_space_normals :121), as window stacks of shifted slabs. In
// PyTorch the same stacks are 81 and 121 slabs a pass and a sort a fill round,
// and the loop's "any hole left" test reads a flag back to the host every
// round. Here the loop never waits for the host.
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
// K9 depth_bilateral_kernel<R>, 32x8 pixels a block (a warp a row, so the
// window's shared-memory reads are conflict-free), the tile and its R-pixel
// apron in shared memory. The radius is a template parameter: R = 4, the only
// radius the port calls (ceil(2 sigma_d) at sigma_d = 2), has its 81 taps
// unrolled, the spatial weights in the kernel's parameter space (the constant
// bank) and the blocks of the sum fixed at compile time; R = 0 is the same
// kernel for any other radius, read at run time, its weights in __constant__
// memory. Per pixel, the taps of the window in row-major order: w = w_spatial
// [t] * exp32((d * -d) * range_scale), d = the neighbour minus the centre,
// where the neighbour is not 0 (outside the image counts as 0), else 0; the
// weights and the products w * neighbour summed in XLA's blocks of 32 taps
// (ops/xla_arith.py block_sum: for 81 taps [0,25), [25,57), [57,81), each left
// to right, then the three block sums left to right); out = num / max(wsum,
// 1e-12) where wsum > 0 and the centre is not 0, else 0. A hole's centre
// takes no tap at all: its output is 0 whatever they give. In the fill it
// also writes its output into both buffers, flags each frame that holds a hole
// (the fill's "had") and appends every pixel it leaves at 0 to round 0's hole
// list. Bound: operations, ~81 exp32 of ~25 float32 operations and 6 more a
// valid tap (~0.3 GFLOP at the step's 2 x 320x256: 4.7 us at 67 TFLOP/s); the
// image is read and written once (1.3 MB).
//
// K10, the median fill, works on holes only, a warp a hole, over a list of
// holes kept on the card. A hole takes the upper median of the valid pixels of
// its 11x11 window in millimetres m = floor(fma(depth, 1000, 1/2)): with n
// valid pixels and pick = min((n + 1) / 2, max(n - 1, 0)), element `pick` of
// the window's 121 millimetres sorted as torch.sort sorts them (holes and the
// outside of the image +inf, every NaN after +inf), ties and all; the hole
// becomes 0.001f * m where that element is finite and n > 0, else stays 0.
// The warp holds the window in registers, tap t = lane + 32 s in slot s of
// lane `lane` (4 slots: 128 places, the last 7 +inf, which moves no finite
// element), each value as an order-preserving 32-bit key (a float's bits with
// the sign bit set where it is positive, all bits flipped where it is
// negative, 0xffffffff for every NaN). Warp counts of the -inf and the finite
// keys say whether element `pick` is finite; if it is, a radix select over
// the finite keys finds it: from the highest bit where they differ down to
// the lowest, the warp counts (__reduce_add_sync) the remaining candidates
// with a 0 there and goes to the half that holds the rank (millimetres are
// integers, so ~10 bits differ in a window, not 32). A median is a pure
// selection, so this is the plain version's element to the bit.
//
// The fill (spsg_depth_fill): K9 on every frame, then depth_fill_kernel, one
// cooperative launch (cudaLaunchCooperativeKernel, the grid sized to the
// blocks that can be resident at once) that runs every round with a
// grid-wide barrier between rounds and then writes the output. Invariant: both
// ping-pong buffers hold every pixel that is not on the current list (K9
// establishes it by writing the filtered frames into both). Round k reads
// buf[(k + 1) % 2], writes buf[k % 2] and walks its list (round 0's: K9's; an
// entry of a frame without holes is skipped: that frame comes out as its own
// depth): a pixel that round k - 1 filled (not 0 in the buffer it reads) is
// copied into the buffer it writes; a pixel still a hole is appended to round
// k + 1's list and takes its median, which is written to the other buffer.
// A round never reads a value that it writes. The lists are appended a block
// at a time (the block's entries gathered in shared memory, one atomicAdd on
// the list's count on the card), so their order changes from run to run and a
// pixel's value does not. Round k + 1 runs where round k left a hole and k <
// max_iters: these are the rounds of the plain loop, which stops at the first
// round after which no frame that had holes has one, or after max_iters
// rounds after the first. Every block reads the same flag after the barrier,
// so the rounds end uniformly. Last, out = the buffer of the last round (a
// frame without holes: its own depth), all_valid = no hole left in the frame.
// A single round (spsg_depth_median_round) is depth_holes_kernel (the frame
// copied, its holes listed) and depth_median_round_kernel, the same round.
// Bound of a fill: bytes, the frames read once and written once (1.3 MB at
// the step's 2 x 320x256, 0.39 us at 3.35 TB/s); the selections, 121 compares
// a hole a round that runs (~2.8 M in the step's first round), need less.
//
// K11 depth_normals_kernel, one thread per pixel: the camera-space point of
// the pixel and its four neighbours (x = depth * (gx - mx) / fx, y likewise,
// z = depth; (0, 0, 0) where depth is 0), a = p(y+1) - p(y-1), b = p(x+1) -
// p(x-1), n = (fma(a1, b2, -(a2 b1)), fma(a2, b0, -(a0 b2)), fma(a0, b1,
// -(a1 b0))), l2 = fma(n2, n2, fma(n1, n1, n0 n0)), the normal n / -sqrt(max(
// l2, 1e-24)) where l2 > 0 and the x of the centre or of a neighbour is not 0,
// else 0; 0 on the image's border. Bound: bytes (the depth read, 12 bytes a
// pixel written).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>
#include <string.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 16;           // K11: a 16x16 tile of pixels a block
constexpr int kBx = 32, kBy = 8;    // K9: a warp a row of 32 pixels, 8 rows a block
constexpr int kMaxRadius = 16;
constexpr int kRadius = 4;          // the port's bilateral radius
constexpr int kTaps = (2 * kRadius + 1) * (2 * kRadius + 1);
constexpr int kSlots = 4;           // the median's slots a lane at the port's radius 5: 121 taps
constexpr int kSlotsMax = ((2 * kMaxRadius + 1) * (2 * kMaxRadius + 1) + 31) / 32;

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

// K9's spatial weights at kRadius, passed by value: the kernel's parameter
// space, which the unrolled taps read at constant offsets
struct Spatial {
  float w[kTaps];
};
// the generic instantiation's weights (any radius up to kMaxRadius)
__constant__ float c_spatial[(2 * kMaxRadius + 1) * (2 * kMaxRadius + 1)];

// a block's entries for a hole list, gathered before one atomicAdd
struct Compact {
  int idx[kThreads];
  int n, base;
};

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

// Appends p of every thread with `want` to `list` (its length in *count, on
// the card): the block's entries gathered in cs.idx, one atomicAdd a block;
// with list == nullptr they are only gathered. cs.n is 0 and visible to the
// block on entry; on return cs.n and cs.idx hold the block's entries. Every
// thread of the block calls it (warps of 32 consecutive threads).
__device__ __forceinline__ void block_append(bool want, int p, int* __restrict__ list,
                                             int* __restrict__ count, Compact& cs, int tid) {
  const int lane = tid & 31;
  const unsigned m = __ballot_sync(kFull, want);
  int off = 0;
  if (lane == 0 && m != 0u) off = atomicAdd(&cs.n, __popc(m));
  off = __shfl_sync(kFull, off, 0);
  if (want) cs.idx[off + __popc(m & ((1u << lane) - 1u))] = p;
  __syncthreads();
  const int n = cs.n;
  if (list != nullptr) {
    if (tid == 0 && n > 0) cs.base = atomicAdd(count, n);
    __syncthreads();
    for (int i = tid; i < n; i += kThreads) list[cs.base + i] = cs.idx[i];
  }
}

// ------------------------------------------------------------------- K9

template <int R>
__device__ __forceinline__ float spatial_weight(const Spatial& s, int t) {
  if constexpr (R > 0) {
    return s.w[t];
  } else {
    return c_spatial[t];
  }
}

// One valid pixel's filtered depth; win is its window's corner in the tile
// (row pitch kBx + 2 r), c its depth
template <int R>
__device__ __forceinline__ float bilateral_pixel(const float* win, int r_run, float c,
                                                 const Spatial& s, float range_scale) {
  const int r = R > 0 ? R : r_run;
  const int tw = kBx + 2 * r, k = 2 * r + 1, n = k * k;
  // block_sum's blocks: block i is [max(0, 32 i - front), min(n, 32 (i + 1) - front))
  const int front = ((n + 31) / 32 * 32 - n) / 2;
  float wsum = 0.f, num = 0.f, wpart = 0.f, npart = 0.f;
  bool first = true;
#pragma unroll
  for (int t = 0; t < n; ++t) {
    const float v = win[(t / k) * tw + t % k];
    const float d = v - c;
    const float w = v != 0.f ? spatial_weight<R>(s, t) * exp32((d * -d) * range_scale) : 0.f;
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
  wsum = first ? wpart : wsum + wpart;
  num = first ? npart : num + npart;
  return wsum > 0.f ? __fdiv_rn(num, wsum < 1e-12f ? 1e-12f : wsum) : 0.f;
}

// R > 0: the radius R at compile time; R = 0: r_run. With `had`, flags the
// frames that hold a hole; with `out2`, writes the output there too; with
// `list`, appends every pixel whose output is 0 (its length in *count).
template <int R>
__global__ void __launch_bounds__(kThreads) depth_bilateral_kernel(
    const float* __restrict__ depth, const Spatial s, float* __restrict__ out,
    float* __restrict__ out2, int* __restrict__ had, int* __restrict__ list,
    int* __restrict__ count, int H, int W, int r_run, float range_scale) {
  extern __shared__ float tile[];  // (kBy + 2 r) rows of kBx + 2 r
  __shared__ int any_hole;
  __shared__ Compact cs;
  const int r = R > 0 ? R : r_run;
  const int tw = kBx + 2 * r, th = kBy + 2 * r;
  const int b = blockIdx.z, tid = threadIdx.y * kBx + threadIdx.x;
  if (tid == 0) {
    any_hole = 0;
    cs.n = 0;
  }
  const int x0 = blockIdx.x * kBx - r, y0 = blockIdx.y * kBy - r;
  const float* frame = depth + (long long)b * H * W;
  for (int i = tid; i < tw * th; i += kThreads) {
    const int y = y0 + i / tw, x = x0 + i % tw;
    tile[i] = (y >= 0 && y < H && x >= 0 && x < W) ? __ldg(frame + (long long)y * W + x) : 0.f;
  }
  __syncthreads();
  const int x = blockIdx.x * kBx + threadIdx.x, y = blockIdx.y * kBy + threadIdx.y;
  const bool inside = x < W && y < H;
  int p = 0;
  float o = 0.f;
  if (inside) {
    p = (int)(((long long)b * H + y) * W + x);
    const float* win = tile + threadIdx.y * tw + threadIdx.x;
    const float c = win[r * tw + r];
    if (c != 0.f) {
      o = bilateral_pixel<R>(win, r, c, s, range_scale);
    } else if (had != nullptr) {
      any_hole = 1;
    }
    out[p] = o;
    if (out2 != nullptr) out2[p] = o;
  }
  if (list != nullptr) block_append(inside && o == 0.f, p, list, count, cs, tid);
  if (had != nullptr) {
    __syncthreads();
    if (tid == 0 && any_hole) had[b] = 1;
  }
}

// ------------------------------------------------------------------- K10

// an order-preserving key: torch.sort's order of floats, every NaN last
__device__ __forceinline__ unsigned order_key(float m) {
  const unsigned u = __float_as_uint(m);
  return m != m ? kFull : ((u & 0x80000000u) ? ~u : (u | 0x80000000u));
}

__device__ __forceinline__ float key_value(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// The median of the hole at (y, x) of `frame` (every lane of the warp calls
// it and gets the same value): S slots a lane hold the (2 r + 1)^2 window.
// The element of rank pick is -inf, finite, or +inf / NaN as pick falls among
// the -inf keys, the finite ones or past them (warp counts); only a finite one
// is selected, by the radix select over the finite keys, from the highest bit
// where they differ to the lowest (the bits below it are common to them all).
template <int S>
__device__ float warp_median(const float* __restrict__ frame, int H, int W, int y, int x, int r,
                             int lane) {
  const int k = 2 * r + 1, n = k * k;
  unsigned key[S];
  bool fin[S];
  unsigned valid = 0, counts = 0, kand = kFull, kor = 0;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int t = lane + 32 * s;
    float m = INFINITY;
    if (t < n) {
      const int yy = y - r + t / k, xx = x - r + t % k;
      if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
        // a buffer that an earlier round of this launch wrote: through L2
        const float v = __ldcg(frame + (long long)yy * W + xx);
        if (v != 0.f) {
          ++valid;
          m = floorf(__fmaf_rn(v, 1000.f, 0.5f));
        }
      }
    }
    key[s] = order_key(m);
    fin[s] = fabsf(m) < INFINITY;
    // the finite keys, and the -inf ones in the high half
    counts += fin[s] ? 1u : (m == -INFINITY ? 0x10000u : 0u);
    if (fin[s]) {
      kand &= key[s];
      kor |= key[s];
    }
  }
  const int nvalid = (int)__reduce_add_sync(kFull, valid);
  counts = __reduce_add_sync(kFull, counts);
  const int nfin = (int)(counts & 0xffffu), nlow = (int)(counts >> 16);
  const int pick = min((nvalid + 1) / 2, max(nvalid - 1, 0));
  // -inf, +inf or NaN (or no valid pixel: then nfin = 0): the hole stays 0
  if (pick < nlow || pick >= nlow + nfin) return 0.f;
  unsigned rank = (unsigned)(pick - nlow);
  kand = __reduce_and_sync(kFull, kand);
  kor = __reduce_or_sync(kFull, kor);
  unsigned res = kand;
  const unsigned diff = kand ^ kor;
  if (diff != 0u) {
    const int top = 31 - __clz(diff), bottom = __ffs(diff) - 1;
    unsigned decided = top == 31 ? 0u : (kFull << (top + 1));
    res = kand & decided;
    for (int bit = top; bit >= bottom; --bit) {
      const unsigned bm = 1u << bit;
      unsigned zeros = 0;
#pragma unroll
      for (int s = 0; s < S; ++s)
        zeros += fin[s] && ((key[s] & decided) == res) && !(key[s] & bm);
      zeros = __reduce_add_sync(kFull, zeros);
      if (rank >= zeros) {
        rank -= zeros;
        res |= bm;
      }
      decided |= bm;
    }
    res |= kand & ((1u << bottom) - 1u);
  }
  return 0.001f * key_value(res);
}

// One round over a hole list, by the whole grid (every thread calls it). Each
// block takes chunks of the list (as many entries as the list has over the
// grid's blocks, at most kThreads): a thread an entry reads its pixel in
// `src` (an entry of a frame with had 0 is skipped), copies it into `dst`
// where it is not 0, else gathers it as a hole (onto list_out, where there is
// one); then a warp a hole writes its median into `dst`. *left is set where a
// median is 0.
template <int S>
__device__ void median_round(const float* __restrict__ src, float* __restrict__ dst,
                             const int* __restrict__ had, const int* __restrict__ list_in,
                             const int* __restrict__ n_in_ptr, int* __restrict__ list_out,
                             int* __restrict__ n_out, int* __restrict__ left, int H, int W,
                             int r, Compact& cs, int& s_left) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int HW = H * W;
  const int n_in = __ldcg(n_in_ptr);
  const int grid = (int)gridDim.x;
  const int chunk = max(1, min(kThreads, (n_in + grid - 1) / grid));
  if (tid == 0) s_left = 0;
  for (long long base = (long long)blockIdx.x * chunk; base < n_in;
       base += (long long)grid * chunk) {
    if (tid == 0) cs.n = 0;
    __syncthreads();
    bool hole = false;
    int p = 0;
    if (tid < chunk && base + tid < n_in) {
      p = __ldcg(list_in + base + tid);
      if (had == nullptr || __ldg(had + p / HW) != 0) {
        const float v = __ldcg(src + p);
        if (v != 0.f) {
          dst[p] = v;
        } else {
          hole = true;
        }
      }
    }
    block_append(hole, p, list_out, n_out, cs, tid);
    const int nh = cs.n;
    for (int i = warp; i < nh; i += kWarps) {
      const int q = cs.idx[i];
      const int b = q / HW, yx = q - b * HW, y = yx / W;
      const float o = warp_median<S>(src + (long long)b * HW, H, W, y, yx - y * W, r, lane);
      if (lane == 0) {
        dst[q] = o;
        if (o == 0.f) s_left = 1;
      }
    }
    __syncthreads();
  }
  if (tid == 0 && left != nullptr && s_left) *left = 1;
}

struct FillArgs {
  const float* depth;
  const int* had;
  float* buf0;
  float* buf1;
  int* list0;
  int* list1;
  int* counts;  // counts[k]: the length of round k's list, k = 0 .. max_iters
  int* left;    // left[k]: a hole is left after round k
  float* out;
  uint8_t* all_valid;
  int B, H, W, r, max_iters;
};

// Every round of the fill and its output, in one cooperative launch
template <int S>
__global__ void __launch_bounds__(kThreads) depth_fill_kernel(const FillArgs a) {
  __shared__ Compact cs;
  __shared__ int s_left;
  cg::grid_group grid = cg::this_grid();
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < a.B; i += kThreads) a.all_valid[i] = 1;
  int k = 0;
  for (;; ++k) {
    const bool odd = k & 1;
    median_round<S>(odd ? a.buf0 : a.buf1, odd ? a.buf1 : a.buf0, a.had, odd ? a.list1 : a.list0,
                    a.counts + k, k < a.max_iters ? (odd ? a.list0 : a.list1) : nullptr,
                    a.counts + k + 1, a.left + k, a.H, a.W, a.r, cs, s_left);
    grid.sync();
    if (k == a.max_iters || __ldcg(a.left + k) == 0) break;
  }
  const float* res = (k & 1) ? a.buf1 : a.buf0;
  const int HW = a.H * a.W;
  const long long n = (long long)a.B * HW;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    const int b = (int)(i / HW);
    const float v = __ldg(a.had + b) != 0 ? __ldcg(res + i) : __ldg(a.depth + i);
    a.out[i] = v;
    if (v == 0.f) a.all_valid[b] = 0;
  }
}

// The single round's list: every pixel of `src` copied into `dst`, its holes
// appended to `list`
__global__ void __launch_bounds__(kThreads) depth_holes_kernel(const float* __restrict__ src,
                                                               float* __restrict__ dst,
                                                               int* __restrict__ list,
                                                               int* __restrict__ count,
                                                               long long n) {
  __shared__ Compact cs;
  const int tid = threadIdx.x;
  if (tid == 0) cs.n = 0;
  __syncthreads();
  const long long i = (long long)blockIdx.x * kThreads + tid;
  const float v = i < n ? __ldg(src + i) : 1.f;
  if (i < n) dst[i] = v;
  block_append(i < n && v == 0.f, (int)i, list, count, cs, tid);
}

template <int S>
__global__ void __launch_bounds__(kThreads) depth_median_round_kernel(
    const float* __restrict__ src, float* __restrict__ dst, const int* __restrict__ list,
    const int* __restrict__ count, int H, int W, int r) {
  __shared__ Compact cs;
  __shared__ int s_left;
  median_round<S>(src, dst, nullptr, list, count, nullptr, nullptr, nullptr, H, W, r, cs, s_left);
}

// ------------------------------------------------------------------- K11

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

// ------------------------------------------------------------------- host

bool bad_shape(int B, int H, int W, int r) {
  return B <= 0 || H <= 0 || W <= 0 || B > 65535 || r < 0 || r > kMaxRadius ||
         (H + kBy - 1) / kBy > 65535 || (long long)B * H * W >= (1LL << 31);
}

// The blocks of kThreads of `fn` that can be resident at once on the current
// device (SMs x blocks an SM); 0 where the runtime cannot say
int resident_blocks(const void* fn) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, 0) != cudaSuccess)
    return 0;
  return sms * per_sm;
}

// the median's slots a lane for radius r (4 for the port's 5)
int median_slots(int r) { return (2 * r + 1) * (2 * r + 1) <= 32 * kSlots ? kSlots : kSlotsMax; }

cudaError_t launch_bilateral(const float* depth, const float* w_spatial, float* out, float* out2,
                             int* had, int* list, int* count, int B, int H, int W, int r,
                             float range_scale, cudaStream_t stream) {
  const dim3 grid((unsigned)((W + kBx - 1) / kBx), (unsigned)((H + kBy - 1) / kBy), (unsigned)B);
  const size_t smem = sizeof(float) * (kBx + 2 * r) * (kBy + 2 * r);
  Spatial s;
  if (r == kRadius) {
    memcpy(s.w, w_spatial, sizeof(s.w));
    depth_bilateral_kernel<kRadius><<<grid, dim3(kBx, kBy), smem, stream>>>(
        depth, s, out, out2, had, list, count, H, W, r, range_scale);
  } else {
    memset(&s, 0, sizeof(s));
    const cudaError_t err =
        cudaMemcpyToSymbolAsync(c_spatial, w_spatial, sizeof(float) * (2 * r + 1) * (2 * r + 1),
                                0, cudaMemcpyHostToDevice, stream);
    if (err != cudaSuccess) return err;
    depth_bilateral_kernel<0><<<grid, dim3(kBx, kBy), smem, stream>>>(
        depth, s, out, out2, had, list, count, H, W, r, range_scale);
  }
  return cudaGetLastError();
}

dim3 grid_for(int B, int H, int W) {
  return dim3((unsigned)((W + kTile - 1) / kTile), (unsigned)((H + kTile - 1) / kTile),
              (unsigned)B);
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after its launches, or the error of a
// refused launch (0 = launched). Images are (B, H, W) float32, contiguous; r
// is the window's radius (the bilateral filter's ceil(2 sigma_d), the
// median's structure radius); w_spatial (host memory) holds the (2 r + 1)^2
// spatial weights in row-major window order.

int spsg_depth_bilateral(const float* depth, const float* w_spatial, float* out, int B, int H,
                         int W, int r, float range_scale, cudaStream_t stream) {
  if (bad_shape(B, H, W, r)) return (int)cudaErrorInvalidValue;
  return (int)launch_bilateral(depth, w_spatial, out, nullptr, nullptr, nullptr, nullptr, B, H, W,
                               r, range_scale, stream);
}

// One round: `dst` takes `src` with every hole filled from `src`. `list`:
// B H W ints and `count` one int, scratch.
int spsg_depth_median_round(const float* src, float* dst, int* list, int* count, int B, int H,
                            int W, int r, cudaStream_t stream) {
  if (bad_shape(B, H, W, r)) return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * H * W;
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  depth_holes_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      src, dst, list, count, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const bool few = median_slots(r) == kSlots;
  const void* fn = few ? (const void*)depth_median_round_kernel<kSlots>
                       : (const void*)depth_median_round_kernel<kSlotsMax>;
  const int blocks = resident_blocks(fn);
  if (blocks <= 0) return (int)cudaErrorInvalidConfiguration;
  if (few)
    depth_median_round_kernel<kSlots><<<blocks, kThreads, 0, stream>>>(src, dst, list, count, H,
                                                                       W, r);
  else
    depth_median_round_kernel<kSlotsMax><<<blocks, kThreads, 0, stream>>>(src, dst, list, count,
                                                                          H, W, r);
  return (int)cudaGetLastError();
}

// The fill: K9 into buf0 and buf1 (flagging the frames with holes, listing
// round 0's holes), then depth_fill_kernel (every round, `out`, `all_valid`:
// B bytes). `lists`: 2 B H W ints; `flags`: B + 2 max_iters + 3 ints (had,
// the lists' counts, the rounds' flags), zeroed here.
int spsg_depth_fill(const float* depth, const float* w_spatial, float* buf0, float* buf1,
                    int* lists, int* flags, float* out, uint8_t* all_valid, int B, int H, int W,
                    int r_bilateral, float range_scale, int r_median, int max_iters,
                    cudaStream_t stream) {
  if (bad_shape(B, H, W, r_bilateral) || bad_shape(B, H, W, r_median) || max_iters < 0)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * H * W;
  FillArgs a;
  a.depth = depth;
  a.had = flags;
  a.buf0 = buf0;
  a.buf1 = buf1;
  a.list0 = lists;
  a.list1 = lists + n;
  a.counts = flags + B;
  a.left = flags + B + max_iters + 2;
  a.out = out;
  a.all_valid = all_valid;
  a.B = B;
  a.H = H;
  a.W = W;
  a.r = r_median;
  a.max_iters = max_iters;
  cudaError_t err = cudaMemsetAsync(flags, 0, sizeof(int) * (B + 2 * max_iters + 3), stream);
  if (err == cudaSuccess)
    err = launch_bilateral(depth, w_spatial, buf1, buf0, flags, a.list0, a.counts, B, H, W,
                           r_bilateral, range_scale, stream);
  if (err != cudaSuccess) return (int)err;
  const void* fn = median_slots(r_median) == kSlots ? (const void*)depth_fill_kernel<kSlots>
                                                    : (const void*)depth_fill_kernel<kSlotsMax>;
  const int blocks = resident_blocks(fn);
  if (blocks <= 0) return (int)cudaErrorInvalidConfiguration;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(fn, dim3((unsigned)blocks), dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) return (int)err;
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
