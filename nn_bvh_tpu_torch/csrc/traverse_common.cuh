// Per-ray pieces shared by the traversal kernels of this directory
// (bvh4_traverse.cu, binary_traverse.cu, bvh8_traverse.cu).
//
// Every operation rounds once (the kernels are built with -fmad=false), in
// the order of the plain torch versions (accel/traverse.py), so kernel and
// plain version return the same bits:
// - inverse direction guards |d| < 1e-20 with +-1e-20;
// - slab test: far t scaled by 1.0000004; a box is hit when
//   tn <= tf && tf > 0 && tn < t_best;
// - Moller-Trumbore: |det| > 1e-12, barycentric slack 1e-7, 0 < t < t_best;
//   a leaf tests its triangles in order and the first smallest t wins;
// - closest-hit: a lane with t_max <= 0 visits nothing; a miss is
//   t = inf, prim = -1, b1 = b2 = 0;
// - any-hit: a lane with t_max < 0 reports occluded (prim = 0), a live lane
//   stops at its first hit; only prim is written.
//
// Triangles: (N, 3, 3) floats, [vertex][axis], or the 16-byte records of
// bvh4_traverse.cu; load_tri reads either, tri_test and leaf_test take both.
// walk is the per-ray loop of the BVH4, binary and BVH8 kernels over their
// own node steps.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace trav {

constexpr float kTiny = 1e-20f;

__device__ __forceinline__ float safe_inv(float c) {
  float s = fabsf(c) < kTiny ? (c < 0.f ? -kTiny : kTiny) : c;
  return 1.0f / s;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ o,
                                        const float* __restrict__ d, int r) {
  Ray ray;
  ray.ox = o[3 * r]; ray.oy = o[3 * r + 1]; ray.oz = o[3 * r + 2];
  ray.dx = d[3 * r]; ray.dy = d[3 * r + 1]; ray.dz = d[3 * r + 2];
  ray.ix = safe_inv(ray.dx); ray.iy = safe_inv(ray.dy); ray.iz = safe_inv(ray.dz);
  return ray;
}

// Slab test of the box [lo, hi]; *tn_out receives the entry t.
__device__ __forceinline__ bool slab(const Ray& r, float lox, float loy,
                                     float loz, float hix, float hiy,
                                     float hiz, float t_best, float* tn_out) {
  const float t0x = (lox - r.ox) * r.ix, t1x = (hix - r.ox) * r.ix;
  const float t0y = (loy - r.oy) * r.iy, t1y = (hiy - r.oy) * r.iy;
  const float t0z = (loz - r.oz) * r.iz, t1z = (hiz - r.oz) * r.iz;
  const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                         fminf(t0z, t1z));
  const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                         fmaxf(t0z, t1z)) * 1.0000004f;
  *tn_out = tn;
  return (tn <= tf) && (tf > 0.f) && (tn < t_best);
}

// One triangle as Moller-Trumbore takes it: a vertex and the two edges from
// it (the w components are unused).
struct Tri {
  float4 v, e1, e2;
};

// Triangle i of an (N, 3, 3) vertex table: nine scalar loads, the edges
// formed here.
__device__ __forceinline__ Tri load_tri(const float* __restrict__ tris, int i) {
  const float* v = tris + (size_t)i * 9;
  const float x0 = __ldg(v + 0), y0 = __ldg(v + 1), z0 = __ldg(v + 2);
  return {make_float4(x0, y0, z0, 0.f),
          make_float4(__ldg(v + 3) - x0, __ldg(v + 4) - y0, __ldg(v + 5) - z0, 0.f),
          make_float4(__ldg(v + 6) - x0, __ldg(v + 7) - y0, __ldg(v + 8) - z0, 0.f)};
}

// Triangle i of a table of 16-byte records (bvh4_traverse.cu;
// accel/bvh4.py::pack_tris_cuda): (N, 3, 4) floats, rows
// [v0, 0 | e1, 0 | e2, 0], the edges rounded once on the host as the
// subtractions of the other load_tri round them. Three float4 loads.
__device__ __forceinline__ Tri load_tri(const float4* __restrict__ tris, int i) {
  const float4* p = tris + (size_t)i * 3;
  return {__ldg(p), __ldg(p + 1), __ldg(p + 2)};
}

// Moller-Trumbore.
__device__ __forceinline__ bool tri_test(const Ray& r, const Tri& tri,
                                         float t_best, float* t_out,
                                         float* u1_out, float* u2_out) {
  const float4 v = tri.v, e1 = tri.e1, e2 = tri.e2;
  const float px = r.dy * e2.z - r.dz * e2.y;
  const float py = r.dz * e2.x - r.dx * e2.z;
  const float pz = r.dx * e2.y - r.dy * e2.x;
  const float det = e1.x * px + e1.y * py + e1.z * pz;
  const bool ok_det = fabsf(det) > 1e-12f;
  const float inv_det = ok_det ? 1.0f / det : 0.f;
  const float sx = r.ox - v.x, sy = r.oy - v.y, sz = r.oz - v.z;
  const float u1 = (sx * px + sy * py + sz * pz) * inv_det;
  const float qx = sy * e1.z - sz * e1.y;
  const float qy = sz * e1.x - sx * e1.z;
  const float qz = sx * e1.y - sy * e1.x;
  const float u2 = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  const float t = (e2.x * qx + e2.y * qy + e2.z * qz) * inv_det;
  *t_out = t;
  *u1_out = u1;
  *u2_out = u2;
  return ok_det && (u1 >= -1e-7f) && (u2 >= -1e-7f) &&
         (u1 + u2 <= 1.0000001f) && (t > 0.f) && (t < t_best);
}

// Tests triangles off .. off+cnt-1 of either table in order. Closest-hit
// keeps the first smallest t; any-hit returns true at its first hit. Over
// 16-byte records the next triangle's three loads are issued before the
// current one is tested; over (N, 3, 3) vertices each triangle is loaded when
// it is tested, since there the early loads' extra live registers made the
// kernel lab's packet kernels spill more and run 10-20% slower.
template <bool kAnyHit, typename T>
__device__ __forceinline__ bool leaf_test(const Ray& r, const T* __restrict__ tris,
                                          int off, int cnt, float& t_best,
                                          int& prim, float& b1, float& b2) {
  // -> true when an any-hit walk may stop
  auto test = [&](const Tri& tri, int j) {
    float t, u1, u2;
    if (!tri_test(r, tri, t_best, &t, &u1, &u2)) return false;
    prim = off + j;
    b1 = u1;
    b2 = u2;
    if (!kAnyHit) t_best = t;
    return kAnyHit;
  };
  if constexpr (std::is_same<T, float4>::value) {
    Tri tri = load_tri(tris, off);
    for (int j = 0; j < cnt; ++j) {
      Tri next = tri;
      if (j + 1 < cnt) next = load_tri(tris, off + j + 1);
      if (test(tri, j)) return true;
      tri = next;
    }
  } else {
    for (int j = 0; j < cnt; ++j) {
      if (test(load_tri(tris, off + j), j)) return true;
    }
  }
  return false;
}

// Writes one ray's result (see the header comment for misses and any-hit).
template <bool kAnyHit>
__device__ __forceinline__ void store_hit(int r, float t_best, int prim,
                                          float b1, float b2, float* t_out,
                                          int* prim_out, float* b1_out,
                                          float* b2_out) {
  prim_out[r] = prim;
  if (!kAnyHit) {
    t_out[r] = prim >= 0 ? t_best : INFINITY;
    b1_out[r] = b1;
    b2_out[r] = b2;
  }
}

// Entries of the walks: a node record >= 0, a leaf
// -(1 + offset*16 + count-1), or kEmpty (none).
constexpr int kEmpty = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool is_node(int e) {
  return static_cast<unsigned>(e) < static_cast<unsigned>(kEmpty);
}

// One ray's walk from entry `next` (kEmpty: none), speculative while-while
// with postponed leaves (Aila and Laine, HPG 2009): node steps run
// warp-wide while any lane still looks for a leaf; a lane that finds one
// parks it and keeps visiting nodes until every lane has one (or is done);
// then the warp tests the parked leaves together. Leaves are tested in the
// order a plain stack walk would reach them; a lane may visit nodes with a
// t_best its parked leaf has not reduced yet, which costs tests, never a
// result, except that on an exact t tie another prim may win.
//
// step(node, t_best, stack, sp) visits a node: it pushes the hit children
// but the nearest on the stack and returns the nearest (the next entry), or
// pops one (kEmpty when the stack is empty). Every lane of the warp must
// call walk together (a dead lane with next = kEmpty).
template <bool kAnyHit, int kStack, typename Step>
__device__ __forceinline__ void walk(const Ray& ray, const float4* __restrict__ tris,
                                     int next, Step step, float& t_best, int& prim,
                                     float& b1, float& b2) {
  int stack[kStack];  // the packers check the depth against kStack
  int sp = -1;
  int leaf = kEmpty;  // the parked leaf
  while (true) {
    // node phase: runs while some lane has no parked leaf and a node to visit
    while (true) {
      if (leaf == kEmpty && next < 0) {
        leaf = next;
        next = sp >= 0 ? stack[sp--] : kEmpty;
      }
      if (!__any_sync(kFull, leaf == kEmpty && is_node(next))) break;
      if (is_node(next)) next = step(next, t_best, stack, sp);
    }
    // leaf phase: every lane with a parked leaf tests it
    if (!__any_sync(kFull, leaf != kEmpty)) break;
    if (leaf != kEmpty) {
      const int u = -leaf - 1;
      const bool hit = leaf_test<kAnyHit>(ray, tris, u >> 4, (u & 15) + 1, t_best, prim,
                                          b1, b2);
      leaf = kEmpty;
      if (kAnyHit && hit) {
        next = kEmpty;
        sp = -1;
      }
    }
  }
}

// The kernels' common signature: nodes, tris, o, d, t_max, n_rays, then
// t_out, prim_out, b1_out, b2_out.
template <typename Node>
using Kernel = void (*)(const Node*, const float*, const float*, const float*,
                        const float*, int, float*, int*, float*, float*);

// The body of every traversal source's C entry: launches `closest` or `any`
// on `stream` (a cudaStream_t), 128 rays per block, and returns
// cudaGetLastError() of the launch. Any-hit writes only prim_out; t_out,
// b1_out, b2_out may then be null.
template <typename Node>
inline int launch(Kernel<Node> closest, Kernel<Node> any, const void* nodes,
                  const void* tris, const void* o, const void* d,
                  const void* t_max, int n_rays, int any_hit, void* t_out,
                  void* prim_out, void* b1_out, void* b2_out, void* stream) {
  if (n_rays <= 0) return 0;
  const dim3 block(128);
  const dim3 grid((n_rays + 127) / 128);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* nd = static_cast<const Node*>(nodes);
  auto* tr = static_cast<const float*>(tris);
  auto* po = static_cast<const float*>(o);
  auto* pd = static_cast<const float*>(d);
  auto* pt = static_cast<const float*>(t_max);
  if (any_hit) {
    any<<<grid, block, 0, s>>>(nd, tr, po, pd, pt, n_rays, nullptr,
                               static_cast<int*>(prim_out), nullptr, nullptr);
  } else {
    closest<<<grid, block, 0, s>>>(nd, tr, po, pd, pt, n_rays,
                                   static_cast<float*>(t_out),
                                   static_cast<int*>(prim_out),
                                   static_cast<float*>(b1_out),
                                   static_cast<float*>(b2_out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace trav
