// BVH4 ray traversal for Hopper (sm_90a): closest-hit and any-hit.
//
// Replaces the TPU kernel nn_bvh_tpu/accel/pallas_bvh4.py::_traverse_bvh4
// (kernel body _make_kernel, pallas_bvh4.py:97-292). It computes the same
// hits; its structure is not carried over. The TPU kernel walks packets of
// rays with one shared scalar stack because the TPU has scalar control flow;
// here every thread walks its own ray with its own 64-entry stack in local
// memory, 128 threads per block, one block per 128 rays.
//
// What bounds it on this card: each node visit is a chain of dependent
// global loads (pop -> 128-byte node record -> push -> pop), and the rays of
// a warp diverge in how many nodes and leaves they visit. The node and
// triangle tables of the bench scene (0.55 MB and 1.9 MB) stay resident in
// the 50 MB L2, so the chain is L2 latency, not DRAM bandwidth. This simple
// design does nothing about either yet: no ray reordering inside a block, no
// persistent threads, no wider nodes. Those are later changes, each to be
// measured against this version.
//
// Semantics and constants match the plain version
// (nn_bvh_tpu_torch/accel/traverse.py::traverse_bvh4_plain), which is built
// without FMA contraction like this file (-fmad=false), so both round alike:
// - inverse direction guards |d| < 1e-20 with +-1e-20;
// - slab test: far t scaled by 1.0000004; a child is hit when
//   tn <= tf && tf > 0 && tn < t_best;
// - hit children are pushed far to near by this ray's entry t (a stable
//   descending sort: on equal keys the lower child index is pushed first);
// - a leaf entry is -(1 + offset*16 + count-1); its triangles are tested in
//   order with Moller-Trumbore (|det| > 1e-12, barycentric slack 1e-7,
//   0 < t < t_best);
// - closest-hit: a lane with t_max <= 0 visits nothing; a miss is
//   t = inf, prim = -1, b1 = b2 = 0;
// - any-hit: a lane with t_max < 0 reports occluded (prim = 0), a live lane
//   stops at its first hit; only prim is written.
//
// Node record (accel/bvh4.py::pack_bvh4_cuda): 4 children x 8 floats
// [lo.x lo.y lo.z hi.x | hi.y hi.z meta pad], read as two float4 per child.
// Triangles: (N, 3, 3) floats, [vertex][axis].

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kStack = 64;   // accel/bvh4.py STACK_DEPTH (packer checks depth)
constexpr float kTiny = 1e-20f;

__device__ __forceinline__ float safe_inv(float c) {
  float s = fabsf(c) < kTiny ? (c < 0.f ? -kTiny : kTiny) : c;
  return 1.0f / s;
}

template <bool kAnyHit>
__global__ void __launch_bounds__(128)
bvh4_traverse_kernel(const float4* __restrict__ nodes,
                     const float* __restrict__ tris,
                     const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ t_max, int n_rays,
                     float* __restrict__ t_out, int* __restrict__ prim_out,
                     float* __restrict__ b1_out, float* __restrict__ b2_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const float ox = o[3 * r], oy = o[3 * r + 1], oz = o[3 * r + 2];
  const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
  float t_best = t_max[r];
  int prim = (kAnyHit && t_best < 0.f) ? 0 : -1;
  float b1 = 0.f, b2 = 0.f;
  const bool live = kAnyHit ? (t_best >= 0.f) : (t_best > 0.f);

  if (live) {
    const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
    int stack[kStack];
    int sp = 0;
    stack[0] = 0;  // wide root
    while (sp >= 0) {
      const int entry = stack[sp];
      sp -= 1;
      if (entry >= 0) {
        const float4* nd = nodes + (size_t)entry * 8;
        float key[4];
        int meta[4];
        int nhit = 0;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float4 a = __ldg(nd + 2 * c);
          const float4 b = __ldg(nd + 2 * c + 1);
          const float t0x = (a.x - ox) * ix, t1x = (a.w - ox) * ix;
          const float t0y = (a.y - oy) * iy, t1y = (b.x - oy) * iy;
          const float t0z = (a.z - oz) * iz, t1z = (b.y - oz) * iz;
          const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                                 fminf(t0z, t1z));
          const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                                 fmaxf(t0z, t1z)) * 1.0000004f;
          const bool ok = (tn <= tf) && (tf > 0.f) && (tn < t_best);
          key[c] = ok ? fmaxf(tn, 0.f) : -1.f;
          meta[c] = __float_as_int(b.z);
          nhit += ok ? 1 : 0;
        }
        // stable descending insertion sort: hits first, farthest first
#pragma unroll
        for (int i = 1; i < 4; ++i) {
#pragma unroll
          for (int j = i; j > 0; --j) {
            if (key[j - 1] < key[j]) {
              const float tk = key[j - 1]; key[j - 1] = key[j]; key[j] = tk;
              const int tm = meta[j - 1]; meta[j - 1] = meta[j]; meta[j] = tm;
            }
          }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (c < nhit) stack[++sp] = meta[c];
        }
      } else {
        const int u = -entry - 1;
        const int off = u >> 4;
        const int cnt = (u & 15) + 1;
        for (int j = 0; j < cnt; ++j) {
          const float* v = tris + (size_t)(off + j) * 9;
          const float x0 = __ldg(v + 0), y0 = __ldg(v + 1), z0 = __ldg(v + 2);
          const float e1x = __ldg(v + 3) - x0, e1y = __ldg(v + 4) - y0,
                      e1z = __ldg(v + 5) - z0;
          const float e2x = __ldg(v + 6) - x0, e2y = __ldg(v + 7) - y0,
                      e2z = __ldg(v + 8) - z0;
          const float px = dy * e2z - dz * e2y;
          const float py = dz * e2x - dx * e2z;
          const float pz = dx * e2y - dy * e2x;
          const float det = e1x * px + e1y * py + e1z * pz;
          const bool ok_det = fabsf(det) > 1e-12f;
          const float inv_det = ok_det ? 1.0f / det : 0.f;
          const float sx = ox - x0, sy = oy - y0, sz = oz - z0;
          const float u1 = (sx * px + sy * py + sz * pz) * inv_det;
          const float qx = sy * e1z - sz * e1y;
          const float qy = sz * e1x - sx * e1z;
          const float qz = sx * e1y - sy * e1x;
          const float u2 = (dx * qx + dy * qy + dz * qz) * inv_det;
          const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
          const bool hit = ok_det && (u1 >= -1e-7f) && (u2 >= -1e-7f) &&
                           (u1 + u2 <= 1.0000001f) && (t > 0.f) && (t < t_best);
          if (hit) {
            prim = off + j;
            b1 = u1;
            b2 = u2;
            if (kAnyHit) break;
            t_best = t;
          }
        }
        if (kAnyHit && prim >= 0) break;
      }
    }
  }

  prim_out[r] = prim;
  if (!kAnyHit) {
    t_out[r] = prim >= 0 ? t_best : INFINITY;
    b1_out[r] = b1;
    b2_out[r] = b2;
  }
}

}  // namespace

// Launches on `stream` (a cudaStream_t) and returns cudaGetLastError() of the
// launch. Any-hit writes only prim_out; t_out, b1_out, b2_out may be null.
extern "C" int bvh4_traverse(const void* nodes, const void* tris,
                             const void* o, const void* d, const void* t_max,
                             int n_rays, int any_hit, void* t_out,
                             void* prim_out, void* b1_out, void* b2_out,
                             void* stream) {
  if (n_rays <= 0) return 0;
  const dim3 block(128);
  const dim3 grid((n_rays + 127) / 128);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* nd = static_cast<const float4*>(nodes);
  auto* tr = static_cast<const float*>(tris);
  auto* po = static_cast<const float*>(o);
  auto* pd = static_cast<const float*>(d);
  auto* pt = static_cast<const float*>(t_max);
  if (any_hit) {
    bvh4_traverse_kernel<true><<<grid, block, 0, s>>>(
        nd, tr, po, pd, pt, n_rays, nullptr, static_cast<int*>(prim_out),
        nullptr, nullptr);
  } else {
    bvh4_traverse_kernel<false><<<grid, block, 0, s>>>(
        nd, tr, po, pd, pt, n_rays, static_cast<float*>(t_out),
        static_cast<int*>(prim_out), static_cast<float*>(b1_out),
        static_cast<float*>(b2_out));
  }
  return static_cast<int>(cudaGetLastError());
}
