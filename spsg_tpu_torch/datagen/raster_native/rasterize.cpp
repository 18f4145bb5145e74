// Software triangle rasterizer for the virtual scanner's depth/color frames.
//
// Replaces the point-splat approximation with the reference datagen's
// rendering fidelity (the reference's datagen/src/Scene.cpp:169-227: D3D11
// z-buffered mesh rasterization, depth converted to camera-z and validated
// against [minDepth, maxDepth], colors captured from the interpolated
// vertex colors). Splatting leaves sample-density holes that the depth
// median-fill then invents data for; rasterization fills every covered
// pixel exactly.
//
// Semantics:
//   - vertices arrive in CAMERA space (x right, y down, z forward);
//     projection u = fx*x/z + cx, v = fy*y/z + cy, sampled at integer
//     pixel coordinates (the splat path's round() convention);
//   - triangles are clipped against the near plane z = zmin
//     (Sutherland-Hodgman, fan re-triangulation) and z-tested per pixel;
//     pixels with camera-z > zmax stay invalid (Scene.cpp:206-216);
//   - attributes (vertex colors) interpolate perspective-correct
//     (linear in 1/z); no backface culling (scan meshes have
//     inconsistent winding);
//   - depth_out: camera z in meters, 0 = hole; color_out: float 0..255.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 rasterize.cpp -o librasterize.so

#include <cmath>
#include <cstdint>
#include <algorithm>

namespace {

struct V {
    float x, y, z;  // camera space
    float r, g, b;  // vertex color (0..255)
};

inline V lerp(const V& a, const V& b, float t) {
    V o;
    o.x = a.x + t * (b.x - a.x);
    o.y = a.y + t * (b.y - a.y);
    o.z = a.z + t * (b.z - a.z);
    o.r = a.r + t * (b.r - a.r);
    o.g = a.g + t * (b.g - a.g);
    o.b = a.b + t * (b.b - a.b);
    return o;
}

// clip polygon against z >= zmin; in/out up to 4 verts
int clip_near(const V* in, int n_in, float zmin, V* out) {
    int n_out = 0;
    for (int i = 0; i < n_in; ++i) {
        const V& a = in[i];
        const V& b = in[(i + 1) % n_in];
        bool ina = a.z >= zmin, inb = b.z >= zmin;
        if (ina) out[n_out++] = a;
        if (ina != inb) {
            float t = (zmin - a.z) / (b.z - a.z);
            out[n_out++] = lerp(a, b, t);
        }
    }
    return n_out;
}

struct Screen {
    float u, v;     // pixel coords
    float invz;     // 1/z
    float r, g, b;  // color / z (perspective-correct numerators)
};

}  // namespace

extern "C" int spsg_rasterize(
    const float* verts_cam,   // (NV, 3)
    const float* vcolors,     // (NV, 3) 0..255, or nullptr
    const int32_t* faces,     // (NF, 3)
    const float* face_shade,  // (NF,) multiplier, or nullptr
    int64_t nv, int64_t nf,
    float fx, float fy, float cx, float cy,
    int width, int height, float zmin, float zmax,
    float* depth_out,         // (H*W) prefilled 0
    float* color_out)         // (H*W*3) prefilled 0, or nullptr
{
    (void)nv;
    for (int64_t f = 0; f < nf; ++f) {
        V tri[3];
        bool any_front = false;
        for (int k = 0; k < 3; ++k) {
            int32_t vi = faces[f * 3 + k];
            tri[k].x = verts_cam[vi * 3 + 0];
            tri[k].y = verts_cam[vi * 3 + 1];
            tri[k].z = verts_cam[vi * 3 + 2];
            if (vcolors) {
                tri[k].r = vcolors[vi * 3 + 0];
                tri[k].g = vcolors[vi * 3 + 1];
                tri[k].b = vcolors[vi * 3 + 2];
            } else {
                tri[k].r = tri[k].g = tri[k].b = 0.f;
            }
            if (tri[k].z >= zmin) any_front = true;
        }
        if (!any_front) continue;

        V poly[4];
        int np = clip_near(tri, 3, zmin, poly);
        if (np < 3) continue;

        const float shade = face_shade ? face_shade[f] : 1.0f;

        // fan-triangulate the clipped polygon (3 or 4 verts)
        for (int t = 1; t + 1 < np; ++t) {
            const V* q[3] = {&poly[0], &poly[t], &poly[t + 1]};
            Screen s[3];
            for (int k = 0; k < 3; ++k) {
                float iz = 1.0f / q[k]->z;
                s[k].u = fx * q[k]->x * iz + cx;
                s[k].v = fy * q[k]->y * iz + cy;
                s[k].invz = iz;
                s[k].r = q[k]->r * iz;
                s[k].g = q[k]->g * iz;
                s[k].b = q[k]->b * iz;
            }
            float area = (s[1].u - s[0].u) * (s[2].v - s[0].v) -
                         (s[1].v - s[0].v) * (s[2].u - s[0].u);
            if (std::fabs(area) < 1e-12f) continue;
            float inv_area = 1.0f / area;

            int u0 = std::max(0, (int)std::ceil(std::min({s[0].u, s[1].u, s[2].u})));
            int u1 = std::min(width - 1, (int)std::floor(std::max({s[0].u, s[1].u, s[2].u})));
            int v0 = std::max(0, (int)std::ceil(std::min({s[0].v, s[1].v, s[2].v})));
            int v1 = std::min(height - 1, (int)std::floor(std::max({s[0].v, s[1].v, s[2].v})));
            if (u0 > u1 || v0 > v1) continue;

            for (int py = v0; py <= v1; ++py) {
                for (int px = u0; px <= u1; ++px) {
                    // barycentric via edge functions (signed, so winding-
                    // independent after dividing by the signed area)
                    float w0 = ((s[1].u - px) * (s[2].v - py) -
                                (s[1].v - py) * (s[2].u - px)) * inv_area;
                    float w1 = ((s[2].u - px) * (s[0].v - py) -
                                (s[2].v - py) * (s[0].u - px)) * inv_area;
                    float w2 = 1.0f - w0 - w1;
                    if (w0 < 0.f || w1 < 0.f || w2 < 0.f) continue;
                    float invz = w0 * s[0].invz + w1 * s[1].invz + w2 * s[2].invz;
                    if (invz <= 0.f) continue;
                    float z = 1.0f / invz;
                    if (z > zmax) continue;
                    int64_t idx = (int64_t)py * width + px;
                    float cur = depth_out[idx];
                    if (cur != 0.0f && cur <= z) continue;  // z-test
                    depth_out[idx] = z;
                    if (color_out) {
                        float r = (w0 * s[0].r + w1 * s[1].r + w2 * s[2].r) * z * shade;
                        float g = (w0 * s[0].g + w1 * s[1].g + w2 * s[2].g) * z * shade;
                        float b = (w0 * s[0].b + w1 * s[1].b + w2 * s[2].b) * z * shade;
                        color_out[idx * 3 + 0] = r;
                        color_out[idx * 3 + 1] = g;
                        color_out[idx * 3 + 2] = b;
                    }
                }
            }
        }
    }
    return 0;
}
