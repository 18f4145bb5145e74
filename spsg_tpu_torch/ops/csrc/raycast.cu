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
// K4, two launches.
//   raycast_march_map_kernel, one block of 512 threads per 8^3 coarse block:
//   a bit per cell, set when the cell is fully valid (all 8 corners valid and
//   finite, base corner below the grid's last plane on every axis: the JAX
//   package's cell_ok of build_march_cells :163), and a flag byte per coarse
//   block that holds a fully valid cell (cell_ok reduced per block as
//   build_block_windows :280 does, with coarse_block = 8).
//   raycast_march_kernel, one thread per ray (b, p), a warp an 8x4 pixel tile
//   (its rays leave the camera side by side, read neighbouring cells and stop
//   at similar k). The ray set-up (origin, direction, cam_z, t0, t_stop) is
//   computed by the wrapper in PyTorch and read here. Samples lie on the
//   lattice t_k = t0 + k * step, with k an exact float (the JAX package's
//   single-rounding lattice, :533-538); k = 0 is the first sample and k runs
//   to k_max (the plain march's cap, n_iter_max * march_block) or until
//   t_k > t_stop. Each sample is the trilinear SDF of its cell, NaN when a
//   corner is invalid or not finite or the cell leaves the grid. A sample
//   whose cell is not fully valid is provably NaN: where its block's flag is
//   0 (the JAX package's conservative skip, :66-77, _skip_hop :305) or its
//   own bit is 0, it loads no corner and sets prev to NaN, as its evaluation
//   would. A sample whose bit is 1 has 8 valid, finite corners, so it reads
//   them from sdf alone (one 4-byte load a corner, no valid byte). The
//   first k with
//     prev * v < 0, |prev - v| < thresh, |v| < thresh
//   (NaN compares false) is the crossing: t_lo = t_k - step (a float
//   subtraction), t_hi = t_k. Then `bisections` steps of regula falsi with
//   the 1e-12 denominator guard (each bisection sample gated by its cell's
//   bit as the march's are), the nearest voxel floor(p + 0.5) of the
//   refined position, hit = found & every bisection sample valid & in the
//   grid & the voxel valid (read from `valid`: a valid voxel whose SDF is not
//   finite counts), depth = alpha * cam_z. Rays without a crossing run the
//   same arithmetic on zeros (alpha 0, hit_idx of the origin's voxel), as
//   there. Bound: the least work is the samples whose cell is fully valid at
//   ~50 float32 operations each, or sdf + valid read once and the outputs
//   written once; what holds it back is the walk itself (position, floor,
//   flag and bit for every lattice sample, a warp as long as its longest
//   ray) and the pre-pass.
//
// K5 raycast_shade_kernel, one thread per pixel: colour (3), normal (3) and
// semantic (14) of the hit voxel (0 where an attribute is absent: null
// pointer), -inf where there is no hit, a -inf normal where the voxel's normal
// is exactly zero, and the depth image. Bound: bytes (the gathered rows and
// the images written).
//
// K6, three launches, no (B, N, 22) accumulator. raycast_scatter_zero_kernel
// zeroes a (B, N) int32 slot per voxel and a row of 24 floats per pixel with
// 16-byte stores. raycast_scatter_kernel, one thread per pixel: lanes of a
// warp that hit one voxel (__match_any_sync) sum their 21 cotangent channels
// (colour 3, normal 3, semantic 14, depth 1; a non-finite entry or a null
// pointer adds 0, and the pixel still counts) and their count by a tree of
// shuffles; the group's first lane claims the voxel's slot (atomicCAS: the
// first pixel to claim it owns it) and adds the sums and the count into the
// owner's row with 16-byte atomic adds. The rows (16 MB at the
// path's shape) fit in L2; a first version that added straight into the
// 88 MB of zeroed gradients spent most of its time in the atomics.
// raycast_scatter_finalize_kernel, one thread per voxel, writes every
// gradient once: the owner's sums divided by the count where it is above 1
// (sum first, then divide, as scatter_plain and the JAX package do), zeros
// elsewhere, staged in shared memory and stored 16 bytes at a time. The order
// of the atomic adds changes from run to run, so the sums of voxels hit by
// more than one pixel are not bitwise repeatable (a few ulps). Bound: bytes
// (the gradients written once, the cotangents read once).

#include <cuda_runtime.h>

#include <algorithm>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kClasses = 14;
constexpr int kChannels = 3 + 3 + kClasses + 1;
constexpr int kEdge = 8;  // coarse block edge in voxels (ops/raycast.py COARSE_BLOCK)
constexpr int kCellWords = kEdge * kEdge * kEdge / 32;  // a block's cell bits in words
constexpr int kTileX = 8, kTileY = 4;  // a warp's pixels

// The pixel of this thread when a warp takes an 8x4 tile of a W-wide image
// (P pixels a batch row): its flat index b * P + y * W + x, or -1 past the
// image. Launch B * tiles_for(P, W) * 32 threads.
__device__ __forceinline__ long long tile_pixel(int B, int P, int W) {
  const int H = P / W;
  const int tiles_x = (W + kTileX - 1) / kTileX;
  const long long tiles = (long long)tiles_x * ((H + kTileY - 1) / kTileY);
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  const long long b = warp / tiles;
  const int tile = (int)(warp % tiles);
  const int x = (tile % tiles_x) * kTileX + lane % kTileX;
  const int y = (tile / tiles_x) * kTileY + lane / kTileX;
  if (b >= B || x >= W || y >= H) return -1;
  return b * P + (long long)y * W + x;
}

long long tiles_for(int P, int W) {
  return (long long)((W + kTileX - 1) / kTileX) * ((P / W + kTileY - 1) / kTileY);
}

// Trilinear SDF of the fully valid cell at base (ix, iy, iz) with weights
// (wx, wy, wz). The 8 loads are issued before any test. The weights and their
// sum in the JAX package's order (_cell_trilerp :214-231).
__device__ __forceinline__ float cell_trilerp(const float* __restrict__ g, int Y, int X,
                                              int ix, int iy, int iz, float wx, float wy,
                                              float wz) {
  const long long plane = (long long)Y * X;
  const float* c0 = g + iz * plane + (long long)iy * X + ix;
  const float* c1 = c0 + plane;
  const float c000 = __ldg(c0), c001 = __ldg(c0 + 1), c010 = __ldg(c0 + X),
              c011 = __ldg(c0 + X + 1);
  const float c100 = __ldg(c1), c101 = __ldg(c1 + 1), c110 = __ldg(c1 + X),
              c111 = __ldg(c1 + X + 1);
  const float ux = 1.f - wx, uy = 1.f - wy, uz = 1.f - wz;
  const float w000 = ux * uy * uz, w001 = wx * uy * uz, w010 = ux * wy * uz, w011 = wx * wy * uz;
  const float w100 = ux * uy * wz, w101 = wx * uy * wz, w110 = ux * wy * wz, w111 = wx * wy * wz;
  const float val = w000 * c000 + w001 * c001 + w010 * c010 + w011 * c011 + w100 * c100 +
                    w101 * c101 + w110 * c110 + w111 * c111;
  return isfinite(val) ? val : NAN;
}

struct Grid {
  const float* sdf;        // this batch row's (Z, Y, X)
  const uint8_t* blocks;   // this batch row's (nbz, nby, nbx) flags
  const uint32_t* cells;   // this batch row's (nbz, nby, nbx, kCellWords) bits
  int Z, Y, X, nby, nbx;
};

// The cell of (px, py, pz): its base corner and weights, and its block; false
// where the cell leaves the grid.
struct Cell {
  int ix, iy, iz, blk;
  float wx, wy, wz;
};

__device__ __forceinline__ bool locate(const Grid& g, float px, float py, float pz, Cell& c) {
  const float bx = floorf(px), by = floorf(py), bz = floorf(pz);
  c.ix = (int)bx;
  c.iy = (int)by;
  c.iz = (int)bz;
  // unsigned: a negative index fails too
  if (!((unsigned)c.ix < (unsigned)(g.X - 1) && (unsigned)c.iy < (unsigned)(g.Y - 1) &&
        (unsigned)c.iz < (unsigned)(g.Z - 1)))
    return false;
  const unsigned ux = c.ix, uy = c.iy, uz = c.iz;
  c.blk = ((uz / kEdge) * g.nby + uy / kEdge) * g.nbx + ux / kEdge;
  c.wx = px - bx;
  c.wy = py - by;
  c.wz = pz - bz;
  return true;
}

// The cell's bit: all 8 corners valid and finite
__device__ __forceinline__ bool cell_ok(const Grid& g, const Cell& c) {
  const unsigned ux = c.ix, uy = c.iy, uz = c.iz;  // not negative: locate checked
  const unsigned l = ((uz % kEdge) * kEdge + uy % kEdge) * kEdge + ux % kEdge;
  return (__ldg(g.cells + c.blk * kCellWords + l / 32) >> (l % 32)) & 1u;
}

__device__ __forceinline__ float cell_value(const Grid& g, const Cell& c) {
  return cell_trilerp(g.sdf, g.Y, g.X, c.ix, c.iy, c.iz, c.wx, c.wy, c.wz);
}

// Trilinear SDF at (px, py, pz); NaN where the sample is invalid.
__device__ __forceinline__ float trilerp(const Grid& g, float px, float py, float pz) {
  Cell c;
  return locate(g, px, py, pz, c) && cell_ok(g, c) ? cell_value(g, c) : NAN;
}

// A lattice sample of the march: trilerp, NaN without a corner load where the
// cell is not fully valid: its coarse block holds no fully valid cell (the
// block's flag, kept in `last_blk` / `last_occ`), or its own bit is 0.
// `evaluated` counts the samples that load corners.
__device__ __forceinline__ float march_sample(const Grid& g, float px, float py, float pz,
                                              int& last_blk, bool& last_occ, int& evaluated) {
  Cell c;
  if (!locate(g, px, py, pz, c)) return NAN;
  if (c.blk != last_blk) {
    last_blk = c.blk;
    last_occ = __ldg(g.blocks + c.blk) != 0;
  }
  if (!last_occ || !cell_ok(g, c)) return NAN;
  ++evaluated;
  return cell_value(g, c);
}

__global__ void __launch_bounds__(kEdge * kEdge * kEdge) raycast_march_map_kernel(
    const float* __restrict__ sdf, const uint8_t* __restrict__ valid,
    uint8_t* __restrict__ blocks, uint32_t* __restrict__ cells,
    int Z, int Y, int X, int nbz, int nby, int nbx) {
  constexpr int E1 = kEdge + 1;  // the block's voxels and the next plane on each axis
  __shared__ uint8_t ok[E1][E1][E1];
  int r = blockIdx.x;
  const int gx = r % nbx;
  r /= nbx;
  const int gy = r % nby;
  r /= nby;
  const int gz = r % nbz;
  const int b = r / nbz;
  const long long n = (long long)Z * Y * X;
  sdf += b * n;
  valid += b * n;
  for (int i = threadIdx.x; i < E1 * E1 * E1; i += blockDim.x) {
    const int lx = i % E1, ly = (i / E1) % E1, lz = i / (E1 * E1);
    const int x = gx * kEdge + lx, y = gy * kEdge + ly, z = gz * kEdge + lz;
    uint8_t o = 0;
    if (x < X && y < Y && z < Z) {
      const long long at = ((long long)z * Y + y) * X + x;
      const float v = sdf[at];  // loaded with valid, not after it
      o = valid[at] && isfinite(v);
    }
    ok[lz][ly][lx] = o;
  }
  __syncthreads();
  const int lx = threadIdx.x % kEdge, ly = (threadIdx.x / kEdge) % kEdge,
            lz = threadIdx.x / (kEdge * kEdge);
  const int x = gx * kEdge + lx, y = gy * kEdge + ly, z = gz * kEdge + lz;
  bool cell = x < X - 1 && y < Y - 1 && z < Z - 1;
#pragma unroll
  for (int j = 0; j < 8; ++j) cell = cell && ok[lz + (j >> 2)][ly + ((j >> 1) & 1)][lx + (j & 1)];
  // thread t is cell bit t of the block: a warp's ballot is one word
  const unsigned word = __ballot_sync(0xffffffffu, cell);
  if (threadIdx.x % 32 == 0) cells[(long long)blockIdx.x * kCellWords + threadIdx.x / 32] = word;
  const int any = __syncthreads_or(cell);
  if (threadIdx.x == 0) blocks[blockIdx.x] = any ? 1 : 0;
}

__global__ void raycast_march_kernel(
    const float* __restrict__ sdf, const uint8_t* __restrict__ valid,
    const uint8_t* __restrict__ blocks, const uint32_t* __restrict__ cells,
    const float* __restrict__ origin,
    const float* __restrict__ dir, const float* __restrict__ cam_z,
    const float* __restrict__ t0s, const float* __restrict__ t_stops, uint8_t* __restrict__ hit_out,
    float* __restrict__ alpha_out, float* __restrict__ depth_out, int* __restrict__ idx_out,
    int* __restrict__ samples_out, int* __restrict__ evaluated_out, int B, int Z, int Y, int X,
    int P, int W, float step, float thresh, int k_max, int bisections) {
  const long long ray = tile_pixel(B, P, W);
  if (ray < 0) return;
  const int b = (int)(ray / P);
  const long long n = (long long)Z * Y * X;
  const int nby = (Y + kEdge - 1) / kEdge, nbx = (X + kEdge - 1) / kEdge;
  const long long nb = (long long)((Z + kEdge - 1) / kEdge) * nby * nbx;
  const Grid g{sdf + b * n, blocks + b * nb, cells + b * nb * kCellWords, Z, Y, X, nby, nbx};
  const float ox = origin[3 * b], oy = origin[3 * b + 1], oz = origin[3 * b + 2];
  const float dx = dir[3 * ray], dy = dir[3 * ray + 1], dz = dir[3 * ray + 2];
  const float t0 = t0s[ray], t_stop = t_stops[ray];

  int last_blk = -1, evaluated = 0;
  bool last_occ = false;
  float prev =
      march_sample(g, ox + t0 * dx, oy + t0 * dy, oz + t0 * dz, last_blk, last_occ, evaluated);
  bool found = false;
  float t_lo = 0.f, d_lo = 0.f, t_hi = 0.f, d_hi = 0.f;
  int k = 1;
  for (; k <= k_max; ++k) {
    const float t = t0 + (float)k * step;
    if (!(t <= t_stop)) break;
    const float v =
        march_sample(g, ox + t * dx, oy + t * dy, oz + t * dz, last_blk, last_occ, evaluated);
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
  // the lattice index at exit (k = 0 included) and the samples that loaded
  // corners, for measuring the work
  if (samples_out) samples_out[ray] = k;
  if (evaluated_out) evaluated_out[ray] = evaluated;

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
  hit_out[ray] = (found && ok && inb && valid[b * n + idx]) ? 1 : 0;
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

// K6's scratch: per voxel its slot (0 if no pixel hit it, else 1 + the pixel
// that owns it), then per pixel a row of kRow floats (the 21 channels, the
// count, 2 of padding: 16-byte aligned rows) that only its owner uses
constexpr int kRow = 24;

__global__ void raycast_scatter_zero_kernel(float4* __restrict__ p, long long n4) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x)
    p[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ float finite_or_zero(const float* g, long long i, bool h) {
  if (!h || !g) return 0.f;
  const float v = g[i];
  return isfinite(v) ? v : 0.f;
}

// an atomic add of 4 channels whose result is unused (sm_90, global memory,
// 16-byte aligned)
__device__ __forceinline__ void red_add4(float* at, const float* x) {
  if (x[0] != 0.f || x[1] != 0.f || x[2] != 0.f || x[3] != 0.f)
    atomicAdd(reinterpret_cast<float4*>(at), make_float4(x[0], x[1], x[2], x[3]));
}

__global__ void raycast_scatter_kernel(
    const float* __restrict__ g_color, const float* __restrict__ g_normal,
    const float* __restrict__ g_sem, const float* __restrict__ g_depth,
    const uint8_t* __restrict__ hit, const int* __restrict__ hit_idx, int* __restrict__ slot,
    float* __restrict__ acc, int B, int N, int P) {
  const long long px = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool h = px < (long long)B * P && hit[px];
  const long long v = h ? (px / P) * N + hit_idx[px] : 0;
  float x[kRow];  // colour 3, normal 3, semantic 14, depth 1, the count, padding
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    x[c] = finite_or_zero(g_color, 3 * px + c, h);
    x[3 + c] = finite_or_zero(g_normal, 3 * px + c, h);
  }
#pragma unroll
  for (int c = 0; c < kClasses; ++c) x[6 + c] = finite_or_zero(g_sem, kClasses * px + c, h);
  x[6 + kClasses] = finite_or_zero(g_depth, px, h);
  x[kChannels] = 1.f;
  x[kChannels + 1] = x[kChannels + 2] = 0.f;
  // lanes that hit one voxel sum their channels and counts into the group's
  // first lane (a tree over their ranks); lanes without a hit are groups of
  // their own
  const unsigned lane = threadIdx.x % 32;
  const unsigned long long key = h ? (unsigned long long)v : (~0ull << 32) | lane;
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  const int rank = __popc(peers & ((1u << lane) - 1u));
  const int size = __popc(peers);
  const int most = __reduce_max_sync(0xffffffffu, size);
  const unsigned above = lane == 31 ? 0u : peers & ~((2u << lane) - 1u);
  for (int d = 1; d < most; d *= 2) {
    unsigned m = above;  // the d-th peer above this lane
    for (int j = 1; j < d; ++j) m &= m - 1u;
    const int src = m ? __ffs(m) - 1 : (int)lane;
    const bool take = rank % (2 * d) == 0 && rank + d < size;
#pragma unroll
    for (int c = 0; c <= kChannels; ++c) {
      const float y = __shfl_sync(0xffffffffu, x[c], src);
      if (take) x[c] += y;
    }
  }
  if (!h || rank != 0) return;
  // the first pixel to claim the voxel owns it; everyone adds into its row
  const int old = atomicCAS(slot + v, 0, (int)px + 1);
  float* row = acc + (old ? old - 1 : px) * kRow;
#pragma unroll
  for (int c = 0; c < kRow; c += 4) red_add4(row + c, x + c);
}

// one thread per voxel: the owner's sums divided by the count where it is
// above 1, or zeros. The block's rows are staged in shared memory in the
// gradients' layout and written out with 16-byte stores (a thread's own rows,
// 12 and 56 bytes apart, would cost a write transaction per few bytes)
__global__ void __launch_bounds__(kThreads) raycast_scatter_finalize_kernel(
    const int* __restrict__ slot, const float* __restrict__ acc, float* __restrict__ d_sdf,
    float* __restrict__ d_color, float* __restrict__ d_normal, float* __restrict__ d_sem,
    long long voxels) {
  __shared__ __align__(16) float s_col[3 * kThreads];
  __shared__ __align__(16) float s_nrm[3 * kThreads];
  __shared__ __align__(16) float s_sem[kClasses * kThreads];
  __shared__ __align__(16) float s_sdf[kThreads];
  const long long v0 = (long long)blockIdx.x * kThreads;
  const int n = (int)min((long long)kThreads, voxels - v0);
  const int i = threadIdx.x;
  if (i < n) {
    const int s = slot[v0 + i];
    float y[kRow];
    if (s) {
      const float4* row = reinterpret_cast<const float4*>(acc + (long long)(s - 1) * kRow);
#pragma unroll
      for (int c = 0; c < kRow / 4; ++c) {
        const float4 q = row[c];
        y[4 * c] = q.x;
        y[4 * c + 1] = q.y;
        y[4 * c + 2] = q.z;
        y[4 * c + 3] = q.w;
      }
      const float count = y[kChannels];
      if (count > 1.f) {
#pragma unroll
        for (int c = 0; c < kChannels; ++c) y[c] /= count;
      }
    } else {
#pragma unroll
      for (int c = 0; c < kChannels; ++c) y[c] = 0.f;
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      s_col[3 * i + c] = y[c];
      s_nrm[3 * i + c] = y[3 + c];
    }
#pragma unroll
    for (int c = 0; c < kClasses; ++c) s_sem[kClasses * i + c] = y[6 + c];
    s_sdf[i] = y[6 + kClasses];
  }
  __syncthreads();
  const float* src[4] = {s_col, s_nrm, s_sem, s_sdf};
  float* dst[4] = {d_color + 3 * v0, d_normal + 3 * v0, d_sem + kClasses * v0, d_sdf + v0};
  const int width[4] = {3, 3, kClasses, 1};
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int m = width[a] * n;
    if (n == kThreads) {  // a whole block: 16-byte aligned (the wrapper checks the bases)
      for (int j = i; j < m / 4; j += kThreads)
        reinterpret_cast<float4*>(dst[a])[j] = reinterpret_cast<const float4*>(src[a])[j];
    } else {
      for (int j = i; j < m; j += kThreads) dst[a][j] = src[a][j];
    }
  }
}

unsigned blocks_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after its launches (0 = launched). The
// march's `samples` (per ray, the lattice index at exit) and `evaluated` (per
// ray, the samples that loaded corners) may be null; `blocks` (B, ceil(Z/8),
// ceil(Y/8), ceil(X/8)) uint8 and `cells` (the same blocks, 16 uint32 words
// each: bit x + 8 y + 64 z of a block's cells) are its scratch, written here.
// P = W * H pixels a batch row.

int spsg_raycast_march(const float* sdf, const uint8_t* valid, const float* origin,
                       const float* dir, const float* cam_z, const float* t0,
                       const float* t_stop, uint8_t* blocks, uint32_t* cells,
                       uint8_t* hit, float* alpha, float* depth, int* hit_idx, int* samples,
                       int* evaluated,
                       int B, int Z, int Y, int X, int P, int W, float step, float thresh,
                       int k_max, int bisections, cudaStream_t stream) {
  if (B <= 0 || P <= 0 || W <= 0 || P % W != 0 || Z < 2 || Y < 2 || X < 2 ||
      (long long)Z * Y * X >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int nbz = (Z + kEdge - 1) / kEdge, nby = (Y + kEdge - 1) / kEdge,
            nbx = (X + kEdge - 1) / kEdge;
  raycast_march_map_kernel<<<(unsigned)((long long)B * nbz * nby * nbx), kEdge * kEdge * kEdge,
                              0, stream>>>(sdf, valid, blocks, cells, Z, Y, X, nbz, nby, nbx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  raycast_march_kernel<<<blocks_for((long long)B * tiles_for(P, W) * 32), kThreads, 0, stream>>>(
      sdf, valid, blocks, cells, origin, dir, cam_z, t0, t_stop, hit, alpha, depth, hit_idx,
      samples, evaluated, B, Z, Y, X, P, W, step, thresh, k_max, bisections);
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

// `scratch`: B * N int32 slots (rounded up to a multiple of 4), then B * P
// rows of kRow floats; zeroed / written here.
int spsg_raycast_scatter(const float* g_color, const float* g_normal, const float* g_sem,
                         const float* g_depth, const uint8_t* hit, const int* hit_idx,
                         int* scratch, float* d_sdf, float* d_color, float* d_normal,
                         float* d_sem, int B, int N, int P, cudaStream_t stream) {
  const long long voxels = (long long)B * N, slots = (voxels + 3) / 4 * 4;
  if (B <= 0 || P <= 0 || N <= 0 || (long long)B * P >= (1LL << 31) - 1 ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const float* grads[4] = {d_sdf, d_color, d_normal, d_sem};
  for (const float* p : grads)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  float* acc = reinterpret_cast<float*>(scratch + slots);
  const long long n4 = (slots + (long long)B * P * kRow) / 4;
  raycast_scatter_zero_kernel<<<(unsigned)std::min<long long>((n4 + 255) / 256, 2048), 256, 0,
                                stream>>>(reinterpret_cast<float4*>(scratch), n4);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  raycast_scatter_kernel<<<blocks_for((long long)B * P), kThreads, 0, stream>>>(
      g_color, g_normal, g_sem, g_depth, hit, hit_idx, scratch, acc, B, N, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  raycast_scatter_finalize_kernel<<<blocks_for(voxels), kThreads, 0, stream>>>(
      scratch, acc, d_sdf, d_color, d_normal, d_sem, voxels);
  return (int)cudaGetLastError();
}

}  // extern "C"
