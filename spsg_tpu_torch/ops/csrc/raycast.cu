// The differentiable TSDF raycaster's three kernels for Hopper (sm_90a):
// the ray march (K4), the shade gather (K5) and the averaged backward
// scatter (K6). Wrappers, plain PyTorch versions and the semantics they share
// are in ops/raycast.py.
//
// None replaces a Pallas kernel: the JAX package left the raycaster to XLA
// (spsg_tpu/ops/raycast.py: find_surface_crossings :404-696, _forward_images
// :704-724, _raycast_attrs_bwd :739-776), as a lockstep while_loop of gathers.
// Translated op for op into PyTorch that loop would read "is any ray still
// marching" back to the host at every round, and the scatter has no fused
// ATen form. The CUDA shape is the original reference's: one thread per ray.
//
// Compiled with -fmad=false (ops/_build.py): a * b + c is rounded twice, as in
// the plain version (separate PyTorch ops). Sample positions, the trilinear
// sum and the bisection then round as they do there, and hit / hit_idx come
// out identical to the plain version.
//
// K4 raycast_march_kernel, one thread per ray (b, p). The ray set-up (origin,
// direction, cam_z, t0, t_stop) is computed by the wrapper in PyTorch and read
// here. Samples lie on the lattice t_k = t0 + k * step, with k an exact float
// (the JAX package's single-rounding lattice, :533-538); k = 0 is the first
// sample and k runs to k_max (the plain march's cap, n_iter_max * march_block)
// or until t_k > t_stop. Each sample is the trilinear SDF of its cell, read
// from the 8 corners of sdf / valid directly (the JAX package packs an 8x
// cell table first: 33.5 MB a (128,64,64) grid), NaN when a corner is invalid
// or not finite or the cell leaves the grid. The first k with
//   prev * v < 0, |prev - v| < thresh, |v| < thresh
// (NaN compares false) is the crossing: t_lo = t_k - step (a float
// subtraction), t_hi = t_k. Then `bisections` steps of regula falsi with the
// 1e-12 denominator guard, the nearest voxel floor(p + 0.5) of the refined
// position, hit = found & every bisection sample valid & in the grid & the
// voxel valid, depth = alpha * cam_z. Rays without a crossing run the same
// arithmetic on zeros (alpha 0, hit_idx of the origin's voxel), as there.
// Bound: the samples' gathers (8 corners of 4 + 1 bytes each; neighbouring
// rays read neighbouring cells, so most come from L1/L2) and the loop's
// latency; the least bytes are sdf + valid read once and the outputs written
// once.
//
// K5 raycast_shade_kernel, one thread per pixel: colour (3), normal (3) and
// semantic (14) of the hit voxel (0 where an attribute is absent: null
// pointer), -inf where there is no hit, a -inf normal where the voxel's normal
// is exactly zero, and the depth image. Bound: bytes (the gathered rows and
// the images written).
//
// K6 raycast_scatter_kernel + raycast_divide_kernel: every hit pixel adds its
// 21 cotangent channels (colour 3, normal 3, semantic 14, depth 1; a
// non-finite entry or a null pointer adds 0) and a count of 1 to its voxel's
// row of a float32 (B, N, 22) accumulator that the wrapper has zeroed, with
// atomicAdd; then one thread per voxel divides the row by max(count, 1) into
// d_color, d_normal, d_semantic and d_sdf (the depth channel). The order of
// the atomic adds changes from run to run, so the sums of voxels hit by more
// than one pixel are not bitwise repeatable (a few ulps). Bound: bytes (the
// accumulator is zeroed, added into and read once).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kClasses = 14;
constexpr int kChannels = 3 + 3 + kClasses + 1;  // + the count = the row of 22

struct Grid {
  const float* sdf;      // this batch row's (Z, Y, X)
  const uint8_t* valid;  // (Z, Y, X), 0 / 1
  int Z, Y, X;
};

// Trilinear SDF at (px, py, pz); NaN where the sample is invalid. The weights
// and their sum in the JAX package's order (_cell_trilerp :214-231).
__device__ float trilerp(const Grid& g, float px, float py, float pz) {
  const float bx = floorf(px), by = floorf(py), bz = floorf(pz);
  const float wx = px - bx, wy = py - by, wz = pz - bz;
  const int ix = (int)bx, iy = (int)by, iz = (int)bz;
  if (!(ix >= 0 && iy >= 0 && iz >= 0 && ix < g.X - 1 && iy < g.Y - 1 && iz < g.Z - 1))
    return NAN;
  const long long plane = (long long)g.Y * g.X;
  const long long base = iz * plane + (long long)iy * g.X + ix;
  float c[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {  // bit0 = x, bit1 = y, bit2 = z
    const long long at = base + ((j >> 2) & 1) * plane + ((j >> 1) & 1) * g.X + (j & 1);
    const float v = g.sdf[at];
    if (!g.valid[at] || !isfinite(v)) return NAN;
    c[j] = v;
  }
  const float ux = 1.f - wx, uy = 1.f - wy, uz = 1.f - wz;
  const float w000 = ux * uy * uz, w001 = wx * uy * uz, w010 = ux * wy * uz, w011 = wx * wy * uz;
  const float w100 = ux * uy * wz, w101 = wx * uy * wz, w110 = ux * wy * wz, w111 = wx * wy * wz;
  const float val = w000 * c[0] + w001 * c[1] + w010 * c[2] + w011 * c[3] + w100 * c[4] +
                    w101 * c[5] + w110 * c[6] + w111 * c[7];
  return isfinite(val) ? val : NAN;
}

__global__ void raycast_march_kernel(
    const float* __restrict__ sdf, const uint8_t* __restrict__ valid,
    const float* __restrict__ origin, const float* __restrict__ dir,
    const float* __restrict__ cam_z, const float* __restrict__ t0s,
    const float* __restrict__ t_stops, uint8_t* __restrict__ hit_out,
    float* __restrict__ alpha_out, float* __restrict__ depth_out, int* __restrict__ idx_out,
    int* __restrict__ samples_out, int B, int Z, int Y, int X, int P, float step, float thresh,
    int k_max, int bisections) {
  const long long ray = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= (long long)B * P) return;
  const int b = (int)(ray / P);
  const long long n = (long long)Z * Y * X;
  const Grid g{sdf + b * n, valid + b * n, Z, Y, X};
  const float ox = origin[3 * b], oy = origin[3 * b + 1], oz = origin[3 * b + 2];
  const float dx = dir[3 * ray], dy = dir[3 * ray + 1], dz = dir[3 * ray + 2];
  const float t0 = t0s[ray], t_stop = t_stops[ray];

  float prev = trilerp(g, ox + t0 * dx, oy + t0 * dy, oz + t0 * dz);
  bool found = false;
  float t_lo = 0.f, d_lo = 0.f, t_hi = 0.f, d_hi = 0.f;
  int k = 1;
  for (; k <= k_max; ++k) {
    const float t = t0 + (float)k * step;
    if (!(t <= t_stop)) break;
    const float v = trilerp(g, ox + t * dx, oy + t * dy, oz + t * dz);
    if (prev * v < 0.f && fabsf(prev - v) < thresh && fabsf(v) < thresh) {
      found = true;
      t_lo = t - step;
      d_lo = prev;
      t_hi = t;
      d_hi = v;
      ++k;
      break;
    }
    prev = v;
  }
  // lattice samples evaluated (k = 0 included), for measuring the work
  if (samples_out) samples_out[ray] = k;

  // regula falsi (reference findIntersectionBisection); on zeros when nothing
  // was found, like the JAX package
  float a = t_lo, da = d_lo, bb = t_hi, db = d_hi;
  bool ok = found;
  float cmid = bb;
  for (int i = 0; i < bisections; ++i) {
    const float diff = da - db;
    const float denom = fabsf(diff) > 1e-12f ? diff : 1e-12f;
    cmid = a + (da / denom) * (bb - a);
    float dmid = trilerp(g, ox + cmid * dx, oy + cmid * dy, oz + cmid * dz);
    const bool okm = !isnan(dmid);
    ok = ok && okm;
    if (!okm) dmid = 0.f;
    if (da * dmid > 0.f) {
      a = cmid;
      da = dmid;
    } else {
      bb = cmid;
      db = dmid;
    }
  }
  const float alpha = cmid;
  const int ix = (int)floorf(ox + alpha * dx + 0.5f);
  const int iy = (int)floorf(oy + alpha * dy + 0.5f);
  const int iz = (int)floorf(oz + alpha * dz + 0.5f);
  const bool inb = ix >= 0 && iy >= 0 && iz >= 0 && ix < X && iy < Y && iz < Z;
  const int cx = min(max(ix, 0), X - 1), cy = min(max(iy, 0), Y - 1), cz = min(max(iz, 0), Z - 1);
  const int idx = (cz * Y + cy) * X + cx;
  hit_out[ray] = (found && ok && inb && g.valid[idx]) ? 1 : 0;
  alpha_out[ray] = alpha;
  depth_out[ray] = alpha * cam_z[ray];
  idx_out[ray] = idx;
}

__global__ void raycast_shade_kernel(
    const float* __restrict__ color, const float* __restrict__ normal,
    const float* __restrict__ semantic, const uint8_t* __restrict__ hit,
    const int* __restrict__ hit_idx, const float* __restrict__ depth,
    float* __restrict__ color_im, float* __restrict__ normal_im, float* __restrict__ sem_im,
    float* __restrict__ depth_im, int B, int N, int P) {
  const long long px = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (px >= (long long)B * P) return;
  const long long row = (px / P) * N + hit_idx[px];
  const bool h = hit[px] != 0;
  float n[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    color_im[3 * px + c] = h ? (color ? color[3 * row + c] : 0.f) : -INFINITY;
    n[c] = normal ? normal[3 * row + c] : 0.f;
  }
  const bool nz = n[0] != 0.f || n[1] != 0.f || n[2] != 0.f;
#pragma unroll
  for (int c = 0; c < 3; ++c) normal_im[3 * px + c] = (h && nz) ? n[c] : -INFINITY;
#pragma unroll
  for (int c = 0; c < kClasses; ++c)
    sem_im[kClasses * px + c] = h ? (semantic ? semantic[kClasses * row + c] : 0.f) : -INFINITY;
  depth_im[px] = h ? depth[px] : -INFINITY;
}

__device__ __forceinline__ void add_finite(float* at, const float* g, long long i) {
  if (g) {
    const float v = g[i];
    if (isfinite(v) && v != 0.f) atomicAdd(at, v);
  }
}

__global__ void raycast_scatter_kernel(
    const float* __restrict__ g_color, const float* __restrict__ g_normal,
    const float* __restrict__ g_sem, const float* __restrict__ g_depth,
    const uint8_t* __restrict__ hit, const int* __restrict__ hit_idx, float* __restrict__ acc,
    int B, int N, int P) {
  const long long px = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (px >= (long long)B * P || !hit[px]) return;
  float* a = acc + ((px / P) * N + hit_idx[px]) * (kChannels + 1);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    add_finite(a + c, g_color, 3 * px + c);
    add_finite(a + 3 + c, g_normal, 3 * px + c);
  }
#pragma unroll
  for (int c = 0; c < kClasses; ++c) add_finite(a + 6 + c, g_sem, kClasses * px + c);
  add_finite(a + 6 + kClasses, g_depth, px);
  atomicAdd(a + kChannels, 1.f);
}

__global__ void raycast_divide_kernel(const float* __restrict__ acc, float* __restrict__ d_sdf,
                                      float* __restrict__ d_color, float* __restrict__ d_normal,
                                      float* __restrict__ d_sem, long long voxels) {
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= voxels) return;
  const float* a = acc + v * (kChannels + 1);
  const float count = fmaxf(a[kChannels], 1.f);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    d_color[3 * v + c] = a[c] / count;
    d_normal[3 * v + c] = a[3 + c] / count;
  }
#pragma unroll
  for (int c = 0; c < kClasses; ++c) d_sem[kClasses * v + c] = a[6 + c] / count;
  d_sdf[v] = a[6 + kClasses] / count;
}

unsigned blocks_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after its launches (0 = launched). The
// march's `samples` (per ray, the lattice samples it evaluated) may be null.

int spsg_raycast_march(const float* sdf, const uint8_t* valid, const float* origin,
                       const float* dir, const float* cam_z, const float* t0,
                       const float* t_stop, uint8_t* hit, float* alpha, float* depth,
                       int* hit_idx, int* samples, int B, int Z, int Y, int X, int P,
                       float step, float thresh, int k_max, int bisections,
                       cudaStream_t stream) {
  if (B <= 0 || P <= 0 || Z < 2 || Y < 2 || X < 2 || (long long)Z * Y * X >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  raycast_march_kernel<<<blocks_for((long long)B * P), kThreads, 0, stream>>>(
      sdf, valid, origin, dir, cam_z, t0, t_stop, hit, alpha, depth, hit_idx, samples, B, Z, Y,
      X, P, step, thresh, k_max, bisections);
  return (int)cudaGetLastError();
}

int spsg_raycast_shade(const float* color, const float* normal, const float* semantic,
                       const uint8_t* hit, const int* hit_idx, const float* depth,
                       float* color_im, float* normal_im, float* sem_im, float* depth_im, int B,
                       int N, int P, cudaStream_t stream) {
  if (B <= 0 || P <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  raycast_shade_kernel<<<blocks_for((long long)B * P), kThreads, 0, stream>>>(
      color, normal, semantic, hit, hit_idx, depth, color_im, normal_im, sem_im, depth_im, B, N,
      P);
  return (int)cudaGetLastError();
}

int spsg_raycast_scatter(const float* g_color, const float* g_normal, const float* g_sem,
                         const float* g_depth, const uint8_t* hit, const int* hit_idx,
                         float* acc, float* d_sdf, float* d_color, float* d_normal,
                         float* d_sem, int B, int N, int P, cudaStream_t stream) {
  if (B <= 0 || P <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  raycast_scatter_kernel<<<blocks_for((long long)B * P), kThreads, 0, stream>>>(
      g_color, g_normal, g_sem, g_depth, hit, hit_idx, acc, B, N, P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long voxels = (long long)B * N;
  raycast_divide_kernel<<<blocks_for(voxels), kThreads, 0, stream>>>(acc, d_sdf, d_color,
                                                                     d_normal, d_sem, voxels);
  return (int)cudaGetLastError();
}

}  // extern "C"
