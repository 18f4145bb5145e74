// K8: the TSDF integrate of dataset generation for Hopper (sm_90a). The
// wrapper and the plain PyTorch version it must match are in
// datagen/fusion.py (integrate, integrate_plain).
//
// It replaces no Pallas kernel: the JAX package left the integrate to XLA
// (spsg_tpu/datagen/fusion.py: integrate :77-138, one jitted grid-wide update
// a frame). Translated op for op into PyTorch, a frame is ~35 elementwise
// passes and two gathers over the whole grid (at 2 cm voxels a room is ~11 M
// voxels, a 46 MB field a pass) and ~1-2 GB of temporaries. Here it is one
// pass in place: a voxel's position in the camera comes from its indices and
// the frame's map (kernel arguments, no memory), so a voxel that projects
// outside the image, or onto an invalid depth, reads and writes nothing.
//
// Compiled with -fmad=false (ops/_build.py): a * b + c is rounded twice, as
// in the plain version (separate PyTorch ops), and every sum and product is
// taken in the plain version's order, so the result matches it to the bit:
//   p   = ((M[r][0] x + M[r][1] y) + M[r][2] z) + M[r][3]   (r = 0, 1, 2)
//   u   = rint(fx px / safe_z + mx), v likewise (rint: half to even, as
//         torch.round); in_img decided on the float, before any int cast
//   d   = depth[v W + u]; d_ok = in_img, finite, in [depth_min, depth_max]
//   free_ctr += d_ok & pz < d
//   sdf = clamp(d - pz, +-trunc), trunc = trunc0 + d voxel; update if
//         d - pz > -trunc; weight w = max(4.5 fma(-(d - 0.4), f32(1/3.6), 1), 1)
//         (the JAX package's (d - 0.4) / 3.6 as XLA compiles it)
//   first observation (sdf not finite): sdf, colour set; else
//   sdf = (sdf w0 + s w) / (w0 + w), colour floor((0.5 + 0.5 old) + 0.5 c);
//   weight min(w0 + w, 255)
// The colour is read at the depth image's flat index clipped to the colour
// image's length (the JAX package's take(..., mode="clip")), whatever its
// size.
//
// Bound: bytes. The state of the voxels with d_ok (sdf, weight, free_ctr and
// the colour: 24 bytes read and written) and both images read once; the
// projection is ~40 float32 operations a voxel over the whole grid, far below
// the card's rate. Design: a thread takes kVox voxels of one row, 32 apart,
// so a warp's loads and stores of a row are coalesced; the depth image
// (320x256x4 B) and the colour stay in L2 and are read through __ldg. One
// launch a frame.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRows = 8;  // rows (y) a block
constexpr int kVox = 4;   // voxels a thread along x
constexpr float kInvDepthRange = 0.277777791f;  // float32(1 / 3.6)

struct Frame {
  float m[12];  // rows 0-2 of M = inv(cam2world) @ inv(world2grid)
  float fx, fy, mx, my;
  float depth_min, depth_max, trunc0, voxelsize;
};

__global__ void __launch_bounds__(kWarp* kRows)
    tsdf_integrate_kernel(float* __restrict__ sdf, float* __restrict__ weight,
                          float* __restrict__ color, int* __restrict__ free_ctr,
                          const float* __restrict__ depth, const float* __restrict__ rgb,
                          long long n_rgb, int Z, int Y, int X, int H, int W, Frame f) {
  const int y = blockIdx.y * kRows + threadIdx.y;
  const int z = blockIdx.z;
  if (y >= Y || z >= Z) return;
  const float yf = (float)y, zf = (float)z;
  // the products of y and z, each rounded once as in the plain version
  const float ay[3] = {f.m[1] * yf, f.m[5] * yf, f.m[9] * yf};
  const float az[3] = {f.m[2] * zf, f.m[6] * zf, f.m[10] * zf};
  const long long row = ((long long)z * Y + y) * X;
#pragma unroll
  for (int k = 0; k < kVox; ++k) {
    const int x = blockIdx.x * (kWarp * kVox) + k * kWarp + threadIdx.x;
    if (x >= X) break;
    const float xf = (float)x;
    const float px = ((f.m[0] * xf + ay[0]) + az[0]) + f.m[3];
    const float py = ((f.m[4] * xf + ay[1]) + az[1]) + f.m[7];
    const float pz = ((f.m[8] * xf + ay[2]) + az[2]) + f.m[11];
    const float safe_z = fabsf(pz) > 1e-9f ? pz : 1e-9f;
    const float uf = rintf(f.fx * px / safe_z + f.mx);
    const float vf = rintf(f.fy * py / safe_z + f.my);
    if (!(uf >= 0.f && vf >= 0.f && uf < (float)W && vf < (float)H && pz > 0.f)) continue;
    const int flat = (int)vf * W + (int)uf;
    const float d = __ldg(depth + flat);
    if (!(isfinite(d) && d >= f.depth_min && d <= f.depth_max)) continue;
    const long long i = row + x;
    if (pz < d) free_ctr[i] += 1;
    const float trunc = f.trunc0 + d * f.voxelsize;
    float s = d - pz;
    if (!(s > -trunc)) continue;
    s = fminf(fmaxf(s, -trunc), trunc);
    // 1 - (d - 0.4) / 3.6 as the JAX package computes it (XLA: a product with
    // f32(1 / 3.6) contracted into one fused multiply-add); fmaf is kept
    // under -fmad=false
    const float w_upd = fmaxf(4.5f * fmaf(-(d - 0.4f), kInvDepthRange, 1.0f), 1.0f);
    const float old_s = sdf[i], old_w = weight[i];
    const bool first = !isfinite(old_s);
    sdf[i] = first ? s : (old_s * old_w + s * w_upd) / (old_w + w_upd);
    weight[i] = fminf(old_w + w_upd, 255.0f);
    if (rgb != nullptr) {
      const long long ci = 3 * ((long long)flat < n_rgb ? (long long)flat : n_rgb - 1);
      float* c = color + 3 * i;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float cv = __ldg(rgb + ci + ch);
        c[ch] = first ? cv : floorf((0.5f + 0.5f * c[ch]) + 0.5f * cv);
      }
    }
  }
}

}  // namespace

extern "C" {

// Integrates one frame into the grid in place; returns cudaGetLastError()
// after the launch (0 = launched). `rgb` may be null (no colour); n_rgb is
// its pixel count. `params`: host pointer to the 20 floats of Frame.
int spsg_tsdf_integrate(float* sdf, float* weight, float* color, int* free_ctr,
                        const float* depth, const float* rgb, long long n_rgb, int Z, int Y,
                        int X, int H, int W, const float* params, cudaStream_t stream) {
  if (Z <= 0 || Y <= 0 || X <= 0 || H <= 0 || W <= 0 || Z > 65535 ||
      (long long)H * W >= (1LL << 31) || (rgb != nullptr && n_rgb <= 0))
    return (int)cudaErrorInvalidValue;
  Frame f;
  const float* p = params;
  for (int k = 0; k < 12; ++k) f.m[k] = p[k];
  f.fx = p[12], f.fy = p[13], f.mx = p[14], f.my = p[15];
  f.depth_min = p[16], f.depth_max = p[17], f.trunc0 = p[18], f.voxelsize = p[19];
  const dim3 block(kWarp, kRows);
  const dim3 grid((unsigned)((X + kWarp * kVox - 1) / (kWarp * kVox)),
                  (unsigned)((Y + kRows - 1) / kRows), (unsigned)Z);
  tsdf_integrate_kernel<<<grid, block, 0, stream>>>(sdf, weight, color, free_ctr, depth, rgb,
                                                    n_rgb, Z, Y, X, H, W, f);
  return (int)cudaGetLastError();
}

}  // extern "C"
