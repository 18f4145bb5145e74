// The TSDF raycaster's five kernels for Hopper (sm_90a): the ray march (K4),
// the shade gather (K5), the averaged backward scatter (K6), the occupancy
// march (K7) and the ray set-up (K12). Wrappers, plain PyTorch versions and the
// semantics they share are in ops/raycast.py.
//
// None replaces a Pallas kernel: the JAX package left the raycaster to XLA
// (spsg_tpu/ops/raycast.py: find_surface_crossings :404-696 with its set-up
// :436-447, _camera_rays :127, _ray_aabb :236, _valid_bounds :253; _forward_images
// :704-724, _raycast_attrs_bwd :739-776, raycast_occ :878-987), as lockstep
// while_loops of gathers.
// Translated op for op into PyTorch that loop would read "is any ray still
// marching" back to the host at every round, and the scatter has no fused
// ATen form. The CUDA shape is the original reference's: one thread per ray.
//
// Compiled with -fmad=false (ops/_build.py): no a * b + c is fused but where
// the source says __fmaf_rn, which is exactly where XLA fuses the JAX
// package's arithmetic on the CPU and the plain version calls
// ops/xla_arith.py's fma32 (the lattice t0 + k * step, the positions o + t * d,
// the trilinear sum, the bisection's a + r * (b - a)). Every sample then
// rounds as it does there, and hit / hit_idx / alpha / depth come out
// identical to the plain version's and to the JAX package's.
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
//   K12's, read here. Samples lie on the
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
// K5 raycast_shade_kernel: colour (3), normal (3) and semantic (14) of the
// hit voxel (0 where an attribute is absent: null pointer), -inf where there
// is no hit, a -inf normal where the voxel's normal is exactly zero, and the
// depth image; a copy and a select, no arithmetic on the values. Bound: bytes
// (the gathered rows and the images written); the images are most of them.
// A block takes kShadePixels consecutive flat pixels (b * P + p), so each
// output's share of the block is one contiguous span. Phase 1, a thread a
// pixel: hit, hit_idx and depth read coalesced, the depth image written, the
// pixel's source row (or -1: no hit) staged in shared memory. Phase 2: each
// span is walked in order, one element a thread a round, element e = pixel
// e / C, channel e % C, so a warp's stores are coalesced and neighbouring
// lanes read neighbouring floats of a row; an element is loaded only where
// the pixel has a hit and the attribute is present. The normals go to shared
// memory and, phase 3, take -inf where the pixel's triple is zero. The last
// block is guarded where B * P is no multiple of its pixels. A first version
// (a thread a pixel, 20 scalar loads and 21 scalar stores at strides of 12,
// 12 and 56 bytes) issued ~10x the write sectors it owned.
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
//
// K7, two launches: does any lattice sample of the ray lie in an occupied
// voxel (the reference's raycast_occ_cuda_kernel, a binary image for the
// missing-colour weights). The ray set-up is the march's (ops/raycast.py
// march_setup on the occupied voxels: their box, t0 snapped to the lattice,
// t_stop); samples t_k = t0 + k * step for k = 0, 1, ... while t_k <= t_stop
// and k < k_max, each the nearest voxel v = floor(p + 0.5) of p = o + t_k * d,
// looked up in the occupancy bytes (a bool tensor as it is) where it lies in
// the grid; the first occupied one ends the ray with a 1. Rounding as in the
// plain version (the lattice and o + t * d each one FMA, + 0.5 rounded once),
// so every sample is the voxel occ_march_plain reads.
//   raycast_occ_map_kernel, one block per (batch row, coarse z, coarse y) of
//   a map of 8^3 coarse blocks with a ring of one block around the grid
//   (block c in [-1, nb] on each axis): its flag is set when an occupied voxel
//   lies within one voxel of the block, in [8c - 1, 8c + 8] on every axis (the
//   block dilated by one voxel). It ORs the region's ten-by-ten rows into one
//   byte per x (16 voxels a load where rows are 16-byte aligned), then each
//   flag ORs its ten x. A first version (a byte a load, two integer divisions
//   per voxel) took 0.017 ms at the training step's (2,128,64,64) on an NVIDIA
//   H100 80GB HBM3 at 700 W, more than the march it serves.
//   raycast_occ_kernel, one thread per ray, a warp an 8x4 pixel tile
//   (tile_pixel, as K4). At sample k it computes v and its block c =
//   floor(v / 8). Where c's flag is 0 (or c lies beyond the ring, where no
//   voxel of the grid is within one voxel) the ray hops: from c's box
//   [8c - 0.5, 8c + 7.5) (the points whose nearest voxel is in c) it steps,
//   as a 3D DDA does, into the block behind the nearest exit face (x, then y,
//   on a tie), up to kHopBlocks times, while that block's flag is 0, and then
//   skips every sample up to the last box's exit t_exit in one step: k <-
//   floor((min(t_exit, t_stop) - t0) / step) + 1, at least k + 1, at most
//   k_max, then lowered while t_{k-1} > t_stop so that the exit index stays
//   the plain version's. Where the flag is 1 it evaluates kGroup samples
//   k .. k + kGroup - 1 at once (all loads issued before any test) and takes
//   the first occupied one. The time of a launch is that of its longest rays
//   (a chain of dependent steps each), so the hop passes many empty blocks a
//   step and the group takes many samples a load round trip.
// Why no skipped sample can be occupied: sample k lies in c's box, and the
// ray from it to t_exit runs through the boxes the hop visited, so every
// skipped sample, t_k <= t_exit, lies in one of them but for rounding.
// t_exit, the lattice and the positions each carry a few float32 roundings
// of relative size 2^-24 of t and |o|, so below 1/4 voxel where both are
// below 2^18, as a hop requires (a ray beyond takes the group path; at the
// path's shape the errors are ~1e-4 voxel). Where the ray passes within
// rounding of an edge or corner, the DDA may visit the neighbour on one side
// and the ray's exact path the one on the other, but the exact path then
// stays within rounding of the visited boxes. A position within 1 voxel of a
// visited box has its nearest voxel in [8c - 1, 8c + 8] of that box, which
// its dilated flag covers, so that voxel is empty. Rays parallel to an axis
// never leave a box through it (that axis gives t = inf). `samples` (per
// ray, the lattice index at exit: the first occupied sample + 1, or the
// first k beyond t_stop or the cap) is the plain version's, since a hop
// never passes t_stop's index or the cap; `evaluated` counts the samples
// whose voxel was loaded (a group's samples in the grid, also those past its
// first occupied one), the work figure.
// Bound: the grid read once, the set-up and the image; or, at ~20 float32
// operations each, the samples up to each ray's first occupied one whose
// (undilated) coarse block holds an occupied voxel (counted in chip_smoke.py
// from the plain version); an earlier bound counted every sample to the exit.
//
// K12, two launches and no other stream operation: the ray set-up of the
// march and of K7 (ops/raycast.py march_setup), the last stage before them
// that ran as a chain of ~40 small tensor ops. Every site in the form of
// ROADMAP.md Queue C's "agreed arithmetic" table: the camera ray by a real
// division, its norm the fma chain from x * x with a correctly rounded root,
// the rotation fma(r2, c2, fma(r1, c1, r0 c0)), the box's slab test, skip and
// t0 = fma(skip, step, t_start); the outputs are march_setup_plain's to the
// bit. raycast_box_kernel, 64 blocks a batch row, reduces the valid voxels, 16
// bytes a thread, to a partial box each (least and largest x, y, z; integers,
// exact), written plainly into scratch. raycast_rays_kernel, a thread a ray,
// is a programmatic dependent launch: it starts while the first kernel runs,
// computes the part of its ray that does not depend on the box (direction,
// cam_z, the direction's reciprocals, t_start, t_end), waits for the first
// kernel (griddepcontrol.wait), reduces the 64 partials of its batch row(s)
// from L2 and finishes the ray (slab test, skip, t0, t_stop). Bound: bytes
// (the valid grid read once, 24 bytes a ray written, 0.00149 ms at the step's
// shape); issuing the ~13 IEEE divisions and 2 roots of a ray, not in that
// count, takes an estimated ~1.7 us at the step's shape. The first version (a memset of
// each bound, an atomicMin / atomicMax pre-pass, a kernel a ray: four stream
// operations in a row, 0.0132 ms) paid four fills and drains; a single
// cooperative launch (box, then rays, a grid barrier, then the finish) was
// slower than these two (0.0116 against 0.0079 ms, PERF.md), because its
// blocks did the box and their rays one after the other. As tensor ops
// (float64 emulation of each fused multiply-add) the set-up took 2.7 ms a
// call on the card (PERF.md).

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kClasses = 14;
constexpr int kChannels = 3 + 3 + kClasses + 1;
constexpr int kEdge = 8;  // coarse block edge in voxels (ops/raycast.py COARSE_BLOCK)
constexpr int kCellWords = kEdge * kEdge * kEdge / 32;  // a block's cell bits in words
constexpr int kTileX = 8, kTileY = 4;  // a warp's pixels
constexpr int kGroup = 8;  // K7: samples evaluated at once where a block is walked
constexpr int kHopBlocks = 32;  // K7: blocks a hop may pass beyond the first
constexpr float kHopLimit = 262144.f;  // K7 hops only where t and |o| are below 2^18
// K5's block: consecutive flat pixels and threads; 64 x 64 was the fastest
// of 32 to 1024 pixels and 1/4 to 2 threads a pixel on an NVIDIA H100 80GB
// HBM3 at 700 W (PERF.md)
constexpr int kShadePixels = 64;
constexpr int kShadeThreads = 64;

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
// sum in the JAX package's order (_cell_trilerp :214-231), the sum as XLA fuses
// it on the CPU: fma(w000, c000, w001 * c001), then each product added by an
// FMA (the source is built with -fmad=false: no other product is fused).
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
  float val = __fmaf_rn(w000, c000, w001 * c001);
  val = __fmaf_rn(w010, c010, val);
  val = __fmaf_rn(w011, c011, val);
  val = __fmaf_rn(w100, c100, val);
  val = __fmaf_rn(w101, c101, val);
  val = __fmaf_rn(w110, c110, val);
  val = __fmaf_rn(w111, c111, val);
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
  // positions o + t d and the lattice t0 + k step each one FMA, as XLA forms them
  float prev = march_sample(g, __fmaf_rn(t0, dx, ox), __fmaf_rn(t0, dy, oy),
                            __fmaf_rn(t0, dz, oz), last_blk, last_occ, evaluated);
  bool found = false;
  float t_lo = 0.f, d_lo = 0.f, t_hi = 0.f, d_hi = 0.f;
  int k = 1;
  for (; k <= k_max; ++k) {
    const float t = __fmaf_rn((float)k, step, t0);
    if (!(t <= t_stop)) break;
    const float v = march_sample(g, __fmaf_rn(t, dx, ox), __fmaf_rn(t, dy, oy),
                                 __fmaf_rn(t, dz, oz), last_blk, last_occ, evaluated);
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
    cmid = __fmaf_rn(da / denom, bb - a, a);
    float dmid = trilerp(g, __fmaf_rn(cmid, dx, ox), __fmaf_rn(cmid, dy, oy),
                         __fmaf_rn(cmid, dz, oz));
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
  const int ix = (int)floorf(__fmaf_rn(alpha, dx, ox) + 0.5f);
  const int iy = (int)floorf(__fmaf_rn(alpha, dy, oy) + 0.5f);
  const int iz = (int)floorf(__fmaf_rn(alpha, dz, oz) + 0.5f);
  const bool inb = ix >= 0 && iy >= 0 && iz >= 0 && ix < X && iy < Y && iz < Z;
  const int cx = min(max(ix, 0), X - 1), cy = min(max(iy, 0), Y - 1), cz = min(max(iz, 0), Z - 1);
  const int idx = (cz * Y + cy) * X + cx;
  hit_out[ray] = (found && ok && inb && valid[b * n + idx]) ? 1 : 0;
  alpha_out[ray] = alpha;
  depth_out[ray] = alpha * cam_z[ray];
  idx_out[ray] = idx;
}

// Element e of the block's span of a C-channel attribute: channel e % C of
// pixel e / C's row; -inf where the pixel has no hit (row -1), 0 where the
// attribute is absent. Loads only where both are there.
template <int C>
__device__ __forceinline__ float shade_value(const float* __restrict__ attr,
                                             const long long* rows, int e) {
  const int j = e / C;
  const long long row = rows[j];
  if (row < 0) return -INFINITY;
  return attr ? __ldg(attr + row * C + (e - j * C)) : 0.f;
}

// Element e of the block's normal span from the staged normals: -inf where
// the pixel has no hit or its normal is exactly zero
__device__ __forceinline__ float shade_normal(const float* nrm, const long long* rows, int e) {
  const int j = e / 3;
  const float* n = nrm + 3 * j;
  return rows[j] >= 0 && (n[0] != 0.f || n[1] != 0.f || n[2] != 0.f) ? nrm[e] : -INFINITY;
}

__global__ void __launch_bounds__(kShadeThreads) raycast_shade_kernel(
    const float* __restrict__ color, const float* __restrict__ normal,
    const float* __restrict__ semantic, const uint8_t* __restrict__ hit,
    const int* __restrict__ hit_idx, const float* __restrict__ depth,
    float* __restrict__ color_im, float* __restrict__ normal_im, float* __restrict__ sem_im,
    float* __restrict__ depth_im, long long pixels, int N, int P) {
  __shared__ long long rows[kShadePixels];
  __shared__ float nrm[3 * kShadePixels];
  const long long g0 = (long long)blockIdx.x * kShadePixels;
  const int n = (int)min((long long)kShadePixels, pixels - g0);
  const int t = threadIdx.x;
  for (int j = t; j < n; j += kShadeThreads) {
    const long long g = g0 + j;
    const bool h = hit[g] != 0;
    const int idx = hit_idx[g];
    const float d = depth[g];
    rows[j] = h ? g / P * N + idx : -1;
    depth_im[g] = h ? d : -INFINITY;
  }
  __syncthreads();
  color_im += 3 * g0;
  normal_im += 3 * g0;
  sem_im += kClasses * g0;
  for (int e = t; e < 3 * n; e += kShadeThreads) {
    color_im[e] = shade_value<3>(color, rows, e);
    nrm[e] = shade_value<3>(normal, rows, e);
  }
  for (int e = t; e < kClasses * n; e += kShadeThreads)
    sem_im[e] = shade_value<kClasses>(semantic, rows, e);
  __syncthreads();
  for (int e = t; e < 3 * n; e += kShadeThreads) normal_im[e] = shade_normal(nrm, rows, e);
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

// K7's map: one block per (b, gz, gy), the ring included (gz in [-1, nbz],
// gy in [-1, nby]); dynamic shared memory of X bytes, rounded up to words.
__global__ void __launch_bounds__(kThreads) raycast_occ_map_kernel(
    const uint8_t* __restrict__ occ, uint8_t* __restrict__ map, int Z, int Y, int X, int nbz,
    int nby, int nbx) {
  extern __shared__ uint32_t col_words[];
  uint8_t* col = reinterpret_cast<uint8_t*>(col_words);  // per x: an occupied voxel in the rows
  int r = blockIdx.x;
  const int gy = r % (nby + 2) - 1;
  r /= nby + 2;
  const int gz = r % (nbz + 2) - 1;
  const int b = r / (nbz + 2);
  const uint8_t* g = occ + (long long)b * Z * Y * X;
  // the rows within one voxel of the block's planes, clipped to the grid
  const int z0 = max(kEdge * gz - 1, 0), z1 = min(kEdge * gz + kEdge, Z - 1);
  const int y0 = max(kEdge * gy - 1, 0), y1 = min(kEdge * gy + kEdge, Y - 1);
  const int ny = y1 - y0 + 1;
  const int rows = z1 < z0 || ny <= 0 ? 0 : (z1 - z0 + 1) * ny;
  for (int i = threadIdx.x; i < (X + 3) / 4; i += blockDim.x) col_words[i] = 0;
  __syncthreads();
  if (X % 16 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0) {
    // 16 voxels a load; a row's loads side by side
    const int nc = X / 16;
#pragma unroll 4
    for (int e = threadIdx.x; e < rows * nc; e += blockDim.x) {
      const int row = e / nc, c = e - row * nc;
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(
                                g + ((long long)(z0 + row / ny) * Y + y0 + row % ny) * X) + c);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (w[q])
          for (int j = 0; j < 4; ++j)
            if ((w[q] >> (8 * j)) & 0xffu) col[16 * c + 4 * q + j] = 1;
    }
  } else {
#pragma unroll 4
    for (int e = threadIdx.x; e < rows * X; e += blockDim.x) {
      const int row = e / X, x = e - row * X;
      if (__ldg(g + ((long long)(z0 + row / ny) * Y + y0 + row % ny) * X + x)) col[x] = 1;
    }
  }
  __syncthreads();
  uint8_t* out = map + ((long long)(b * (nbz + 2) + gz + 1) * (nby + 2) + gy + 1) * (nbx + 2);
  for (int c = (int)threadIdx.x - 1; c <= nbx; c += blockDim.x) {
    const int x0 = max(kEdge * c - 1, 0), x1 = min(kEdge * c + kEdge, X - 1);
    uint8_t any = 0;
    for (int x = x0; x <= x1; ++x) any |= col[x];
    out[c + 1] = any;
  }
}

// The ray length at which p = o + t d leaves [8c - 0.5, 8c + 7.5) on one
// axis: inf where d is 0 (the ray never leaves through it)
__device__ __forceinline__ float face_t(float c, float o, float d, float inv) {
  if (d > 0.f) return (kEdge * c + (kEdge - 0.5f) - o) * inv;
  if (d < 0.f) return (kEdge * c - 0.5f - o) * inv;
  return INFINITY;
}

// The flag of block (cx, cy, cz) of K7's map (0 beyond the ring)
__device__ __forceinline__ bool occ_flag(const uint8_t* __restrict__ map, float cx, float cy,
                                         float cz, int nbx, int nby, int nbz) {
  return cx >= -1.f && cy >= -1.f && cz >= -1.f && cx <= (float)nbx && cy <= (float)nby &&
         cz <= (float)nbz &&
         __ldg(map + ((int)(cz + 1.f) * (nby + 2) + (int)(cy + 1.f)) * (nbx + 2) +
               (int)(cx + 1.f));
}

__global__ void raycast_occ_kernel(
    const uint8_t* __restrict__ occ, const uint8_t* __restrict__ map,
    const float* __restrict__ origin, const float* __restrict__ dir,
    const float* __restrict__ t0s, const float* __restrict__ t_stops,
    uint8_t* __restrict__ hit_out, int* __restrict__ samples_out,
    int* __restrict__ evaluated_out, int B, int Z, int Y, int X, int P, int W, float step,
    int k_max) {
  const long long ray = tile_pixel(B, P, W);
  if (ray < 0) return;
  const int b = (int)(ray / P);
  const int nbz = (Z + kEdge - 1) / kEdge, nby = (Y + kEdge - 1) / kEdge,
            nbx = (X + kEdge - 1) / kEdge;
  occ += (long long)b * Z * Y * X;
  map += (long long)b * (nbz + 2) * (nby + 2) * (nbx + 2);
  const float ox = origin[3 * b], oy = origin[3 * b + 1], oz = origin[3 * b + 2];
  const float dx = dir[3 * ray], dy = dir[3 * ray + 1], dz = dir[3 * ray + 2];
  // 1 / d rounded once (as 1.f / d) and, per axis, the step of a hop and the
  // offset of the exit face from 8c
  const float ix = __frcp_rn(dx), iy = __frcp_rn(dy), iz = __frcp_rn(dz);
  const int sx = dx > 0.f ? 1 : -1, sy = dy > 0.f ? 1 : -1, sz = dz > 0.f ? 1 : -1;
  const float fx_off = dx > 0.f ? kEdge - 0.5f : -0.5f, fy_off = dy > 0.f ? kEdge - 0.5f : -0.5f,
              fz_off = dz > 0.f ? kEdge - 0.5f : -0.5f;
  const float t0 = t0s[ray], t_stop = t_stops[ray];
  const bool o_ok = fabsf(ox) < kHopLimit && fabsf(oy) < kHopLimit && fabsf(oz) < kHopLimit;
  uint8_t hit = 0;
  int k = 0, evaluated = 0;
  while (k < k_max) {
    // the lattice and the positions each one FMA, as XLA forms them
    const float t = __fmaf_rn((float)k, step, t0);
    if (!(t <= t_stop)) break;
    float cx = floorf(floorf(__fmaf_rn(t, dx, ox) + 0.5f) * 0.125f);
    float cy = floorf(floorf(__fmaf_rn(t, dy, oy) + 0.5f) * 0.125f);
    float cz = floorf(floorf(__fmaf_rn(t, dz, oz) + 0.5f) * 0.125f);
    if (!occ_flag(map, cx, cy, cz, nbx, nby, nbz) && o_ok && t < kHopLimit) {
      // a hop: past c's box, then past each next block along the ray (the
      // axis of the nearest face; x, then y, on a tie) while its flag is 0.
      // Block indices as ints (|c| < 2^16 here), the axis chosen by selects:
      // the step is the hot loop of an empty grid
      int bx = (int)cx, by = (int)cy, bz = (int)cz;
      float tx = face_t(cx, ox, dx, ix), ty = face_t(cy, oy, dy, iy),
            tz = face_t(cz, oz, dz, iz);
      float t_exit = fminf(fminf(tx, ty), tz);  // fminf drops a NaN of 0 * inf
      for (int s = 0; s < kHopBlocks && t_exit <= t_stop; ++s) {
        const bool ax = tx == t_exit, ay = !ax && ty == t_exit, az = !ax && !ay;
        const int nx = bx + (ax ? sx : 0), ny = by + (ay ? sy : 0), nz = bz + (az ? sz : 0);
        if ((unsigned)(nx + 1) <= (unsigned)(nbx + 1) && (unsigned)(ny + 1) <= (unsigned)(nby + 1) &&
            (unsigned)(nz + 1) <= (unsigned)(nbz + 1) &&
            __ldg(map + ((nz + 1) * (nby + 2) + ny + 1) * (nbx + 2) + nx + 1))
          break;
        bx = nx, by = ny, bz = nz;
        // face_t of the axis stepped (its d is not 0)
        const float c = (float)(ax ? bx : ay ? by : bz);
        const float tn = (kEdge * c + (ax ? fx_off : ay ? fy_off : fz_off) - (ax ? ox : ay ? oy : oz)) *
                         (ax ? ix : ay ? iy : iz);
        tx = ax ? tn : tx;
        ty = ay ? tn : ty;
        tz = az ? tn : tz;
        t_exit = fminf(fminf(tx, ty), tz);
      }
      const float kf = fmaxf(floorf((fminf(t_exit, t_stop) - t0) / step) + 1.f, (float)(k + 1));
      int kn = kf < (float)k_max ? (int)kf : k_max;
      while (kn - 1 > k && !(__fmaf_rn((float)(kn - 1), step, t0) <= t_stop)) --kn;
      k = kn;
      continue;
    }
    // a group: positions and loads first, then the first occupied sample
    uint8_t got[kGroup];
    int taken = 0;
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const float tj = __fmaf_rn((float)(k + j), step, t0);
      const bool take = k + j < k_max && tj <= t_stop;
      const float fx = floorf(__fmaf_rn(tj, dx, ox) + 0.5f);
      const float fy = floorf(__fmaf_rn(tj, dy, oy) + 0.5f);
      const float fz = floorf(__fmaf_rn(tj, dz, oz) + 0.5f);
      const bool load = take && fx >= 0.f && fy >= 0.f && fz >= 0.f && fx < (float)X &&
                        fy < (float)Y && fz < (float)Z;
      got[j] = load ? __ldg(occ + ((long long)(int)fz * Y + (int)fy) * X + (int)fx) : 0;
      taken += take;
      evaluated += load;
    }
    int first = kGroup;
#pragma unroll
    for (int j = kGroup - 1; j >= 0; --j)
      if (got[j]) first = j;
    if (first < kGroup) {
      hit = 1;
      k += first + 1;
      break;
    }
    k += taken;
    if (taken < kGroup) break;
  }
  hit_out[ray] = hit;
  if (samples_out) samples_out[ray] = k;
  if (evaluated_out) evaluated_out[ray] = evaluated;
}

// torch.minimum / torch.maximum: NaN if either is NaN
__device__ __forceinline__ float min_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fminf(a, b);
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fmaxf(a, b);
}

// ------------------------------------------------------------------- K12

constexpr int kSetupThreads = 256;
constexpr int kSetupWarps = kSetupThreads / 32;
constexpr int kBoxBlocks = 64;  // blocks a batch row of the box pass (ops/raycast.py SETUP_BOX_BLOCKS)
constexpr unsigned kFull = 0xffffffffu;

struct SetupArgs {
  const uint8_t* valid;  // (B, Z, Y, X)
  const float* view;     // (B, 4, 4)
  const float* intr;     // (B, 4)
  int* part;             // [b][field][block]: the box blocks' least x, y, z and largest x, y, z
  float *origin, *dir, *cam_z, *t0, *t_stop;
  int B, Z, Y, X, P, W;
  bool vec;  // X % 16 == 0 and valid 16-byte aligned
  float depth_min, depth_max, step, inv_step;
};

// What a ray needs of its set-up once the box is known: the reciprocals of
// its direction (1e12 where |d| <= 1e-9) and [t_start, t_end]
struct RayPart {
  float inv[3];
  float t_start, t_end;
};

// A box with no voxel: least INT_MAX, largest -1
__device__ __forceinline__ void box_empty(int v[6]) {
  v[0] = v[1] = v[2] = INT_MAX;
  v[3] = v[4] = v[5] = -1;
}

__device__ __forceinline__ void box_add(int v[6], int x0, int x1, int y, int z) {
  v[0] = min(v[0], x0);
  v[1] = min(v[1], y);
  v[2] = min(v[2], z);
  v[3] = max(v[3], x1);
  v[4] = max(v[4], y);
  v[5] = max(v[5], z);
}

// bit 7 of each byte of u set where that byte is not 0
__device__ __forceinline__ unsigned nonzero_bytes(unsigned u) {
  return (((u & 0x7f7f7f7fu) + 0x7f7f7f7fu) | u) & 0x80808080u;
}

// The box of the block (every thread gets it): warp minima and maxima, then
// the warps'. Every thread of the block calls it.
__device__ __forceinline__ void block_box(int v[6], int (*s_red)[6], int tid) {
#pragma unroll
  for (int f = 0; f < 6; ++f) {
    v[f] = f < 3 ? __reduce_min_sync(kFull, v[f]) : __reduce_max_sync(kFull, v[f]);
    if (tid % 32 == 0) s_red[tid / 32][f] = v[f];
  }
  __syncthreads();
#pragma unroll
  for (int f = 0; f < 6; ++f)
    for (int w = 0; w < kSetupWarps; ++w)
      v[f] = f < 3 ? min(v[f], s_red[w][f]) : max(v[f], s_red[w][f]);
  __syncthreads();
}

// The share of block r (of kBoxBlocks) of batch row b's valid voxels: 16
// bytes a thread where a.vec (the first and last nonzero byte of a run from
// its four words' nonzero-byte masks), else a row of X bytes a thread. Exact:
// integers.
__device__ __forceinline__ void reduce_rows(const SetupArgs& a, int b, int r, int tid, int v[6]) {
  const uint8_t* g = a.valid + (long long)b * a.Z * a.Y * a.X;
  const int stride = kBoxBlocks * kSetupThreads;
  if (a.vec) {
    const int runs = a.X / 16, n = a.Z * a.Y * runs;
#pragma unroll 4
    for (int i = r * kSetupThreads + tid; i < n; i += stride) {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(g) + i);
      const unsigned long long lo = nonzero_bytes(w.x) | (unsigned long long)nonzero_bytes(w.y) << 32;
      const unsigned long long hi = nonzero_bytes(w.z) | (unsigned long long)nonzero_bytes(w.w) << 32;
      if ((lo | hi) == 0ull) continue;
      const int row = i / runs, x = (i - row * runs) * 16;
      const int first = lo ? (__ffsll((long long)lo) - 1) >> 3 : 8 + ((__ffsll((long long)hi) - 1) >> 3);
      const int last = hi ? 8 + ((63 - __clzll((long long)hi)) >> 3) : (63 - __clzll((long long)lo)) >> 3;
      box_add(v, x + first, x + last, row % a.Y, row / a.Y);
    }
  } else {
    for (int row = r * kSetupThreads + tid; row < a.Z * a.Y; row += stride) {
      const uint8_t* q = g + (long long)row * a.X;
      int x0 = INT_MAX, x1 = -1;
      for (int x = 0; x < a.X; ++x) {
        if (__ldg(q + x)) {
          x0 = min(x0, x);
          x1 = x;
        }
      }
      if (x1 >= 0) box_add(v, x0, x1, row % a.Y, row / a.Y);
    }
  }
}

// The part of ray (b, p) that does not depend on the box, in the arithmetic of
// ops/raycast.py::march_setup_plain (ROADMAP.md Queue C, "agreed arithmetic"):
// camera ray ((x - mx) / fx, (y - my) / fy, 1) over its norm sqrt(fma(1, 1,
// fma(cy, cy, cx cx))) (cam_z = 1 / norm), rotated by fma(r2, c2, fma(r1, c1,
// r0 c0)) a row and normalised again, the reciprocals of the direction (1 / d
// where |d| > 1e-9, else 1e12), t_start, t_end = depth_min, depth_max over
// cam_z. Writes dir and cam_z; p = 0 writes the row's origin.
__device__ __forceinline__ RayPart ray_part(const SetupArgs& a, int ray) {
  const int b = ray / a.P, p = ray - b * a.P;
  const float* m = a.view + 16 * b;
  if (p == 0)
    for (int i = 0; i < 3; ++i) a.origin[3 * b + i] = __ldg(m + 4 * i + 3);
  const float fx = __ldg(a.intr + 4 * b), fy = __ldg(a.intr + 4 * b + 1),
              mx = __ldg(a.intr + 4 * b + 2), my = __ldg(a.intr + 4 * b + 3);
  const float cx = __fdiv_rn((float)(p % a.W) - mx, fx), cy = __fdiv_rn((float)(p / a.W) - my, fy);
  const float cn = __fsqrt_rn(__fmaf_rn(1.f, 1.f, __fmaf_rn(cy, cy, cx * cx)));
  const float c0 = __fdiv_rn(cx, cn), c1 = __fdiv_rn(cy, cn), c2 = __fdiv_rn(1.f, cn);
  float w[3];
  for (int i = 0; i < 3; ++i)
    w[i] = __fmaf_rn(__ldg(m + 4 * i + 2), c2,
                     __fmaf_rn(__ldg(m + 4 * i + 1), c1, __ldg(m + 4 * i) * c0));
  const float wn = __fsqrt_rn(__fmaf_rn(w[2], w[2], __fmaf_rn(w[1], w[1], w[0] * w[0])));
  RayPart r;
  for (int i = 0; i < 3; ++i) {
    const float d = __fdiv_rn(w[i], wn);
    a.dir[3 * (long long)ray + i] = d;
    r.inv[i] = fabsf(d) > 1e-9f ? __fdiv_rn(1.f, d) : 1e12f;
  }
  a.cam_z[ray] = c2;
  r.t_start = __fdiv_rn(a.depth_min, c2);
  r.t_end = __fdiv_rn(a.depth_max, c2);
  return r;
}

// The rest of ray (b, p) against the box [lo, hi] (widened by 1.5): the slab
// test with NaN-propagating min / max, skip = max(floor((t_enter - t_start) *
// inv_step), 0), t0 = fma(skip, step, t_start), t_stop = min(t_end, t_exit +
// step)
__device__ __forceinline__ void ray_finish(const SetupArgs& a, int ray, int b, const RayPart& r,
                                           const float* lo, const float* hi) {
  const float* m = a.view + 16 * b;
  float enter = 0.f, leave = 0.f;
  for (int i = 0; i < 3; ++i) {
    const float o = __ldg(m + 4 * i + 3);
    const float ta = (lo[i] - o) * r.inv[i], tb = (hi[i] - o) * r.inv[i];
    enter = i == 0 ? min_nan(ta, tb) : max_nan(enter, min_nan(ta, tb));
    leave = i == 0 ? max_nan(ta, tb) : min_nan(leave, max_nan(ta, tb));
  }
  float skip = floorf((enter - r.t_start) * a.inv_step);
  skip = skip < 0.f ? 0.f : skip;
  a.t0[ray] = __fmaf_rn(skip, a.step, r.t_start);
  a.t_stop[ray] = min_nan(r.t_end, leave + a.step);
}

// K12's first kernel, kBoxBlocks blocks a batch row: block r of row b
// reduces its share of the row's valid voxels to a partial box (least x, y, z,
// largest x, y, z; INT_MAX / -1 where it saw none), written plainly into its
// slot of `part`. It lets the second kernel launch at once
// (griddepcontrol.launch_dependents, programmatic dependent launch).
__global__ void __launch_bounds__(kSetupThreads) raycast_box_kernel(const SetupArgs a) {
  __shared__ int s_red[kSetupWarps][6];
  asm volatile("griddepcontrol.launch_dependents;");
  const int tid = threadIdx.x, b = blockIdx.x / kBoxBlocks, r = blockIdx.x % kBoxBlocks;
  int v[6];
  box_empty(v);
  reduce_rows(a, b, r, tid, v);
  block_box(v, s_red, tid);
  if (tid == 0)
    for (int f = 0; f < 6; ++f) a.part[(b * 6 + f) * kBoxBlocks + r] = v[f];
}

// K12's second kernel, a thread a ray (b, p), launched while the first runs:
// ray_part, then griddepcontrol.wait (the first kernel done and its partials
// visible), then, for each batch row the block's rays touch, the row's box
// from its kBoxBlocks partials (read through L2), widened as the plain
// version widens it (min(lo, dim) - 1.5, hi + 1.5: an empty row gives dim -
// 1.5 and -2.5), and ray_finish. At most 40 registers: 6 blocks an SM hold
// the step's 163,840 rays in one wave beside the first kernel's blocks.
__global__ void __launch_bounds__(kSetupThreads, 6) raycast_rays_kernel(const SetupArgs a) {
  __shared__ int s_red[kSetupWarps][6];
  const int tid = threadIdx.x;
  const int n = a.B * a.P;
  const int first = blockIdx.x * kSetupThreads, last = min(n, first + kSetupThreads);
  const int ray = first + tid;
  const RayPart part = ray < n ? ray_part(a, ray) : RayPart{};
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int dims[3] = {a.X, a.Y, a.Z};
  for (int b = first / a.P; b <= (last - 1) / a.P; ++b) {
    int v[6];
    box_empty(v);
    if (tid < kBoxBlocks) {
      const int* q = a.part + b * 6 * kBoxBlocks + tid;
#pragma unroll
      for (int f = 0; f < 6; ++f) {
        const int u = __ldcg(q + f * kBoxBlocks);
        v[f] = f < 3 ? min(v[f], u) : max(v[f], u);
      }
    }
    block_box(v, s_red, tid);
    float lo[3], hi[3];
    for (int i = 0; i < 3; ++i) {
      lo[i] = (float)min(v[i], dims[i]) - 1.5f;
      hi[i] = (float)v[3 + i] + 1.5f;
    }
    if (ray < last && ray / a.P == b) ray_finish(a, ray, b, part, lo, hi);
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
  const long long pixels = (long long)B * P;
  raycast_shade_kernel<<<(unsigned)((pixels + kShadePixels - 1) / kShadePixels), kShadeThreads, 0,
                         stream>>>(color, normal, semantic, hit, hit_idx, depth, color_im,
                                   normal_im, sem_im, depth_im, pixels, N, P);
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

// K7. `occ` (B, Z, Y, X) bytes, 0 = empty; `map` (B, nbz + 2, nby + 2,
// nbx + 2) bytes, nb = ceil(dim / 8), written here (the dilated block flags,
// ring included); `samples` and `evaluated` may be null.
int spsg_raycast_occ_hop(const uint8_t* occ, const float* origin, const float* dir,
                         const float* t0, const float* t_stop, uint8_t* map, uint8_t* hit,
                         int* samples, int* evaluated, int B, int Z, int Y, int X, int P, int W,
                         float step, int k_max, cudaStream_t stream) {
  if (B <= 0 || P <= 0 || W <= 0 || P % W != 0 || Z < 1 || Y < 1 || X < 1 ||
      (long long)Z * Y * X >= (1LL << 31) || X > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const int nbz = (Z + kEdge - 1) / kEdge, nby = (Y + kEdge - 1) / kEdge;
  raycast_occ_map_kernel<<<(unsigned)((long long)B * (nbz + 2) * (nby + 2)), kThreads,
                           (X + 3) / 4 * 4, stream>>>(occ, map, Z, Y, X, nbz, nby, (X + kEdge - 1) / kEdge);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  raycast_occ_kernel<<<blocks_for((long long)B * tiles_for(P, W) * 32), kThreads, 0, stream>>>(
      occ, map, origin, dir, t0, t_stop, hit, samples, evaluated, B, Z, Y, X, P, W, step, k_max);
  return (int)cudaGetLastError();
}

// K12. `valid` (B, Z, Y, X) bytes, 0 = not valid; `view` (B, 4, 4) camera ->
// grid and `intr` (B, 4) = fx, fy, mx, my, float32; `partials` (at least 6 B
// kBoxBlocks ints) scratch, written here; writes origin (B, 3), dir (B, P, 3),
// cam_z, t0 and t_stop (B, P). inv_step: the float32 reciprocal of the
// float32 step (the JAX package's division by it as XLA compiles it). Two
// launches, the second a programmatic dependent launch; no memset, no
// atomics, nothing read back.
int spsg_raycast_setup_pdl(const uint8_t* valid, const float* view, const float* intr,
                           int* partials, int partial_ints, float* origin, float* dir,
                           float* cam_z, float* t0, float* t_stop, int B, int Z, int Y, int X,
                           int P, int W, float depth_min, float depth_max, float step,
                           float inv_step, cudaStream_t stream) {
  if (B <= 0 || P <= 0 || W <= 0 || P % W != 0 || Z < 1 || Y < 1 || X < 1 ||
      (long long)Z * Y * X >= (1LL << 31) || (long long)B * P >= (1LL << 30) ||
      (long long)B * kBoxBlocks >= (1LL << 31) || (long long)partial_ints < 6LL * B * kBoxBlocks)
    return (int)cudaErrorInvalidValue;
  const SetupArgs a{valid, view, intr, partials, origin, dir, cam_z, t0, t_stop, B, Z, Y, X, P, W,
                    X % 16 == 0 && reinterpret_cast<uintptr_t>(valid) % 16 == 0, depth_min,
                    depth_max, step, inv_step};
  raycast_box_kernel<<<(unsigned)(B * kBoxBlocks), kSetupThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(((long long)B * P + kSetupThreads - 1) / kSetupThreads));
  cfg.blockDim = dim3(kSetupThreads);
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, raycast_rays_kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
