// Native isosurface extraction from dense TSDF grids (host-side C++).
//
// Native replacement for the reference's marching-cubes extension
// (torch/utils/marching_cubes/marching_cubes.cpp): mesh a truncated SDF at an
// isovalue with per-vertex trilinearly-interpolated colors, welded vertices
// and a validity rule (all 8 cube corners must be within truncation, i.e.
// observed). Two from-scratch extractors share the vertex welding machinery:
//
//  * method 0 (default): *classic marching cubes* topology — vertices lie
//    only on cube edges (the reference's vertex set) — implemented without
//    the 256-case tables by tracing the isosurface polygon through each
//    cube: crossing edges are paired per face (faces with four crossings are
//    resolved with the asymptotic decider of the bilinear face field, which
//    both adjacent cubes compute identically, so the mesh is crack-free by
//    construction — strictly better than fixed-table ambiguity handling),
//    cycles are fan-triangulated, and winding is oriented along the trilinear
//    field gradient (normals point toward positive SDF = empty space).
//  * method 1: *marching tetrahedra* (6 tets per cube) — table-free and
//    watertight, but introduces extra vertices on face/body diagonals.
//
// Grid layout: z-major (z, y, x), matching the on-disk formats; vertices are
// emitted in (x, y, z) order like the reference PLY output.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <unordered_map>
#include <vector>

namespace {

struct V3 {
  float x, y, z;
};

// the 6-tetrahedra decomposition of a cube around the main diagonal 0-7
// (corner ids 0..7 with bit0 = x, bit1 = y, bit2 = z). Every tet contains
// edge 0-7 and each cube face is split along the diagonal through the
// lattice direction of 0-7, so adjacent cubes triangulate shared faces
// identically (crack-free by construction).
static const int kTets[6][4] = {
    {0, 1, 3, 7}, {0, 3, 2, 7}, {0, 2, 6, 7},
    {0, 6, 4, 7}, {0, 4, 5, 7}, {0, 5, 1, 7},
};

inline int corner_dx(int c) { return c & 1; }
inline int corner_dy(int c) { return (c >> 1) & 1; }
inline int corner_dz(int c) { return (c >> 2) & 1; }

struct MeshAccum {
  std::vector<float> verts;    // xyz triplets
  std::vector<uint8_t> colors; // rgb triplets
  std::vector<int64_t> faces;  // index triplets
  // weld map: key = (min_corner_linear * 8 + max_corner_offset_code) — we key
  // edges by the two global corner ids
  std::unordered_map<uint64_t, int64_t> edge_vertex;

  const float* sdf;
  const uint8_t* color_grid; // may be null
  int64_t dimz, dimy, dimx;
  float isovalue;

  inline int64_t corner_id(int64_t x, int64_t y, int64_t z) const {
    return (z * dimy + y) * dimx + x;
  }

  int64_t edge_vert(int64_t xa, int64_t ya, int64_t za, float va,
                    int64_t xb, int64_t yb, int64_t zb, float vb) {
    int64_t ia = corner_id(xa, ya, za);
    int64_t ib = corner_id(xb, yb, zb);
    if (ia > ib) {
      std::swap(ia, ib);
      std::swap(xa, xb);
      std::swap(ya, yb);
      std::swap(za, zb);
      std::swap(va, vb);
    }
    uint64_t key = (uint64_t)ia * 0x100000000ull ^ (uint64_t)ib;
    auto it = edge_vertex.find(key);
    if (it != edge_vertex.end()) return it->second;
    float denom = va - vb;
    float t = std::fabs(denom) < 1e-12f ? 0.5f : (va - isovalue) / denom;
    if (t < 0.f) t = 0.f;
    if (t > 1.f) t = 1.f;
    float px = xa + t * (xb - xa);
    float py = ya + t * (yb - ya);
    float pz = za + t * (zb - za);
    int64_t idx = (int64_t)(verts.size() / 3);
    verts.push_back(px);
    verts.push_back(py);
    verts.push_back(pz);
    if (color_grid) {
      // trilinear interpolation of the uint8 color grid at (px, py, pz)
      float fx = px, fy = py, fz = pz;
      int64_t x0 = (int64_t)std::floor(fx), y0 = (int64_t)std::floor(fy),
              z0 = (int64_t)std::floor(fz);
      float wx = fx - x0, wy = fy - y0, wz = fz - z0;
      float acc[3] = {0, 0, 0};
      for (int dz = 0; dz < 2; ++dz)
        for (int dy = 0; dy < 2; ++dy)
          for (int dx = 0; dx < 2; ++dx) {
            int64_t xx = x0 + dx, yy = y0 + dy, zz = z0 + dz;
            if (xx < 0) xx = 0;
            if (yy < 0) yy = 0;
            if (zz < 0) zz = 0;
            if (xx >= dimx) xx = dimx - 1;
            if (yy >= dimy) yy = dimy - 1;
            if (zz >= dimz) zz = dimz - 1;
            float w = (dx ? wx : 1 - wx) * (dy ? wy : 1 - wy) * (dz ? wz : 1 - wz);
            const uint8_t* c = color_grid + 3 * ((zz * dimy + yy) * dimx + xx);
            acc[0] += w * c[0];
            acc[1] += w * c[1];
            acc[2] += w * c[2];
          }
      for (int k = 0; k < 3; ++k) {
        float v = acc[k];
        colors.push_back((uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v + 0.5f)));
      }
    }
    edge_vertex.emplace(key, idx);
    return idx;
  }

  void emit_tri(int64_t a, int64_t b, int64_t c) {
    if (a == b || b == c || a == c) return;  // degenerate
    faces.push_back(a);
    faces.push_back(b);
    faces.push_back(c);
  }

  // marching one tetrahedron: corners as (x, y, z, value)
  void march_tet(const int64_t cx[4], const int64_t cy[4], const int64_t cz[4],
                 const float v[4]) {
    int code = 0;
    for (int i = 0; i < 4; ++i)
      if (v[i] < isovalue) code |= (1 << i);
    if (code == 0 || code == 15) return;
    // collect crossing edges of the 6 tet edges
    static const int E[6][2] = {{0, 1}, {0, 2}, {0, 3}, {1, 2}, {1, 3}, {2, 3}};
    // canonical triangulations per case
    auto ev = [&](int a, int b) {
      return edge_vert(cx[a], cy[a], cz[a], v[a], cx[b], cy[b], cz[b], v[b]);
    };
    switch (code) {
      case 1: case 14: {
        int64_t p0 = ev(0, 1), p1 = ev(0, 2), p2 = ev(0, 3);
        if (code == 1) emit_tri(p0, p1, p2); else emit_tri(p0, p2, p1);
        break;
      }
      case 2: case 13: {
        int64_t p0 = ev(1, 0), p1 = ev(1, 3), p2 = ev(1, 2);
        if (code == 2) emit_tri(p0, p1, p2); else emit_tri(p0, p2, p1);
        break;
      }
      case 4: case 11: {
        int64_t p0 = ev(2, 0), p1 = ev(2, 1), p2 = ev(2, 3);
        if (code == 4) emit_tri(p0, p1, p2); else emit_tri(p0, p2, p1);
        break;
      }
      case 8: case 7: {
        int64_t p0 = ev(3, 0), p1 = ev(3, 2), p2 = ev(3, 1);
        if (code == 8) emit_tri(p0, p1, p2); else emit_tri(p0, p2, p1);
        break;
      }
      case 3: case 12: {  // {0,1} vs {2,3}
        int64_t a = ev(0, 2), b = ev(0, 3), c = ev(1, 3), d = ev(1, 2);
        if (code == 3) { emit_tri(a, b, c); emit_tri(a, c, d); }
        else { emit_tri(a, c, b); emit_tri(a, d, c); }
        break;
      }
      case 5: case 10: {  // {0,2} vs {1,3}
        int64_t a = ev(0, 1), b = ev(2, 1), c = ev(2, 3), d = ev(0, 3);
        if (code == 5) emit_tri(a, b, c), emit_tri(a, c, d);
        else emit_tri(a, c, b), emit_tri(a, d, c);
        break;
      }
      case 6: case 9: {  // {1,2} vs {0,3}
        int64_t a = ev(1, 0), b = ev(2, 0), c = ev(2, 3), d = ev(1, 3);
        if (code == 6) emit_tri(a, b, c), emit_tri(a, c, d);
        else emit_tri(a, c, b), emit_tri(a, d, c);
        break;
      }
    }
  }
  // ---- classic marching cubes (method 0) ----------------------------------
  //
  // Cube corner ids: bit0 = x, bit1 = y, bit2 = z. The 12 cube edges and the
  // 6 faces (4 corners in cyclic order, outward-consistent) are fixed local
  // topology; everything else is computed from the corner values.

  void march_cube_classic(int64_t x, int64_t y, int64_t z, const float v[8]) {
    static const int kEdges[12][2] = {
        {0, 1}, {2, 3}, {4, 5}, {6, 7},  // x-aligned
        {0, 2}, {1, 3}, {4, 6}, {5, 7},  // y-aligned
        {0, 4}, {1, 5}, {2, 6}, {3, 7},  // z-aligned
    };
    static const int kFaces[6][4] = {
        {0, 2, 6, 4},  // x = 0
        {1, 3, 7, 5},  // x = 1
        {0, 1, 5, 4},  // y = 0
        {2, 3, 7, 6},  // y = 1
        {0, 1, 3, 2},  // z = 0
        {4, 5, 7, 6},  // z = 1
    };
    // edge id from a corner pair
    auto edge_of = [&](int a, int b) {
      if (a > b) std::swap(a, b);
      for (int e = 0; e < 12; ++e)
        if (kEdges[e][0] == a && kEdges[e][1] == b) return e;
      return -1;
    };

    float g[8];
    bool inside[8];
    int code = 0;
    for (int c = 0; c < 8; ++c) {
      g[c] = v[c] - isovalue;
      inside[c] = g[c] < 0.f;
      if (inside[c]) code |= (1 << c);
    }
    if (code == 0 || code == 255) return;

    bool crossing[12];
    for (int e = 0; e < 12; ++e)
      crossing[e] = inside[kEdges[e][0]] != inside[kEdges[e][1]];

    // per-edge neighbor slots (each crossing edge gets exactly two partners,
    // one per adjacent face)
    int nbr[12][2];
    int nnbr[12] = {0};
    auto link = [&](int ea, int eb) {
      nbr[ea][nnbr[ea]++] = eb;
      nbr[eb][nnbr[eb]++] = ea;
    };
    for (int f = 0; f < 6; ++f) {
      const int* q = kFaces[f];
      int fe[4], nfe = 0;  // crossing edges of this face in cyclic order
      int first_corner = -1;
      for (int k = 0; k < 4; ++k) {
        int e = edge_of(q[k], q[(k + 1) & 3]);
        if (crossing[e]) {
          if (nfe == 0) first_corner = k;
          fe[nfe++] = e;
        }
      }
      if (nfe == 2) {
        link(fe[0], fe[1]);
      } else if (nfe == 4) {
        // corners alternate sign; asymptotic decider of the bilinear field
        // g(s,t) on the face decides which diagonal pair connects through the
        // face center: center value = (g0*g2 - g1*g3) / (g0 + g2 - g1 - g3)
        float g0 = g[q[0]], g1 = g[q[1]], g2 = g[q[2]], g3 = g[q[3]];
        float denom = g0 + g2 - g1 - g3;
        float center = denom != 0.f ? (g0 * g2 - g1 * g3) / denom : 0.f;
        bool center_with_q0 = (center < 0.f) == inside[q[0]];
        // cyclic edges: fe in order E0=(q0,q1), E1=(q1,q2), E2=(q2,q3),
        // E3=(q3,q0) (nfe==4 implies every edge crosses, so order holds)
        (void)first_corner;
        if (center_with_q0) {
          // q0's region runs diagonally through the center; the surface
          // wraps around q1 and q3
          link(fe[0], fe[1]);  // around q1
          link(fe[2], fe[3]);  // around q3
        } else {
          link(fe[3], fe[0]);  // around q0
          link(fe[1], fe[2]);  // around q2
        }
      }
    }

    // trace cycles -> polygons -> fan triangles
    auto vert_of_edge = [&](int e) {
      int a = kEdges[e][0], b = kEdges[e][1];
      return edge_vert(x + corner_dx(a), y + corner_dy(a), z + corner_dz(a), v[a],
                       x + corner_dx(b), y + corner_dy(b), z + corner_dz(b), v[b]);
    };
    bool used[12] = {false};
    for (int e0 = 0; e0 < 12; ++e0) {
      if (!crossing[e0] || used[e0]) continue;
      int poly_edges[12], np = 0;
      int cur = e0, prev = -1;
      do {
        used[cur] = true;
        poly_edges[np++] = cur;
        int nxt = (nbr[cur][0] == prev) ? nbr[cur][1] : nbr[cur][0];
        prev = cur;
        cur = nxt;
      } while (cur != e0 && np < 12);
      if (np < 3) continue;

      // polygon vertex positions (local cube coords) for orientation
      float px[12], py[12], pz[12];
      for (int i = 0; i < np; ++i) {
        int e = poly_edges[i];
        int a = kEdges[e][0], b = kEdges[e][1];
        float va = v[a], vb = v[b];
        float denom = va - vb;
        float t = std::fabs(denom) < 1e-12f ? 0.5f : (va - isovalue) / denom;
        if (t < 0.f) t = 0.f;
        if (t > 1.f) t = 1.f;
        px[i] = corner_dx(a) + t * (corner_dx(b) - corner_dx(a));
        py[i] = corner_dy(a) + t * (corner_dy(b) - corner_dy(a));
        pz[i] = corner_dz(a) + t * (corner_dz(b) - corner_dz(a));
      }
      // Newell normal of the traced order
      float nx = 0, ny = 0, nz = 0, cx = 0, cy = 0, cz = 0;
      for (int i = 0; i < np; ++i) {
        int j = (i + 1) % np;
        nx += (py[i] - py[j]) * (pz[i] + pz[j]);
        ny += (pz[i] - pz[j]) * (px[i] + px[j]);
        nz += (px[i] - px[j]) * (py[i] + py[j]);
        cx += px[i]; cy += py[i]; cz += pz[i];
      }
      cx /= np; cy /= np; cz /= np;
      // gradient of the trilinear field at the centroid
      float gx = 0, gy = 0, gz = 0;
      for (int c = 0; c < 8; ++c) {
        float wx = corner_dx(c) ? cx : 1.f - cx;
        float wy = corner_dy(c) ? cy : 1.f - cy;
        float wz = corner_dz(c) ? cz : 1.f - cz;
        float sx = corner_dx(c) ? 1.f : -1.f;
        float sy = corner_dy(c) ? 1.f : -1.f;
        float sz = corner_dz(c) ? 1.f : -1.f;
        gx += sx * wy * wz * g[c];
        gy += sy * wx * wz * g[c];
        gz += sz * wx * wy * g[c];
      }
      float orient = nx * gx + ny * gy + nz * gz;
      if (orient == 0.f) {
        // centroid sits on a saddle of the trilinear field (possible with
        // symmetric truncated values): fall back to the direction from the
        // inside-corner centroid to the outside-corner centroid — a
        // deterministic outward proxy independent of the traced order
        float ix = 0, iy = 0, iz = 0, ox = 0, oy = 0, oz = 0;
        int ni = 0, no = 0;
        for (int c2 = 0; c2 < 8; ++c2) {
          if (inside[c2]) {
            ix += corner_dx(c2); iy += corner_dy(c2); iz += corner_dz(c2); ++ni;
          } else {
            ox += corner_dx(c2); oy += corner_dy(c2); oz += corner_dz(c2); ++no;
          }
        }
        float dx2 = ox / no - ix / ni;
        float dy2 = oy / no - iy / ni;
        float dz2 = oz / no - iz / ni;
        orient = nx * dx2 + ny * dy2 + nz * dz2;
      }
      bool flip = orient < 0.f;

      int64_t ids[12];
      for (int i = 0; i < np; ++i)
        ids[i] = vert_of_edge(poly_edges[flip ? np - 1 - i : i]);
      for (int i = 1; i + 1 < np; ++i) emit_tri(ids[0], ids[i], ids[i + 1]);
    }
  }
};

}  // namespace

extern "C" {

// Returns 0 on success. Caller frees out_* with spsg_mesh_free.
// method: 0 = classic marching cubes topology, 1 = marching tetrahedra.
int spsg_extract_isosurface(
    const float* sdf, const uint8_t* colors, int64_t dimz, int64_t dimy,
    int64_t dimx, float isovalue, float truncation, int method,
    float** out_verts, uint8_t** out_colors, int64_t** out_faces,
    int64_t* n_verts, int64_t* n_faces) {
  MeshAccum mb;
  mb.sdf = sdf;
  mb.color_grid = colors;
  mb.dimz = dimz;
  mb.dimy = dimy;
  mb.dimx = dimx;
  mb.isovalue = isovalue;

  for (int64_t z = 0; z + 1 < dimz; ++z) {
    for (int64_t y = 0; y + 1 < dimy; ++y) {
      for (int64_t x = 0; x + 1 < dimx; ++x) {
        float v[8];
        bool valid = true;
        for (int c = 0; c < 8; ++c) {
          int64_t xx = x + corner_dx(c);
          int64_t yy = y + corner_dy(c);
          int64_t zz = z + corner_dz(c);
          float s = sdf[(zz * dimy + yy) * dimx + xx];
          // validity: observed within truncation (reference get_voxel weight
          // rule, marching_cubes.cpp:72-105)
          if (!(std::fabs(s) < truncation) || !std::isfinite(s)) {
            valid = false;
            break;
          }
          v[c] = s;
        }
        if (!valid) continue;
        if (method == 0) {
          mb.march_cube_classic(x, y, z, v);
          continue;
        }
        for (int t = 0; t < 6; ++t) {
          int64_t cx[4], cy[4], cz[4];
          float tv[4];
          for (int i = 0; i < 4; ++i) {
            int c = kTets[t][i];
            cx[i] = x + corner_dx(c);
            cy[i] = y + corner_dy(c);
            cz[i] = z + corner_dz(c);
            tv[i] = v[c];
          }
          mb.march_tet(cx, cy, cz, tv);
        }
      }
    }
  }

  *n_verts = (int64_t)(mb.verts.size() / 3);
  *n_faces = (int64_t)(mb.faces.size() / 3);
  *out_verts = (float*)std::malloc(mb.verts.size() * sizeof(float));
  std::memcpy(*out_verts, mb.verts.data(), mb.verts.size() * sizeof(float));
  if (colors) {
    *out_colors = (uint8_t*)std::malloc(mb.colors.size());
    std::memcpy(*out_colors, mb.colors.data(), mb.colors.size());
  } else {
    *out_colors = nullptr;
  }
  *out_faces = (int64_t*)std::malloc(mb.faces.size() * sizeof(int64_t));
  std::memcpy(*out_faces, mb.faces.data(), mb.faces.size() * sizeof(int64_t));
  return 0;
}

void spsg_mesh_free(void* p) { std::free(p); }

}  // extern "C"
