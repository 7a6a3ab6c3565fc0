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
// (nn_bvh_tpu_torch/accel/traverse.py::traverse_bvh4_plain); the shared
// slab test, triangle test and miss / any-hit rules are in
// traverse_common.cuh. Particular to this kernel:
// - hit children are pushed far to near by this ray's entry t (a stable
//   descending sort: on equal keys the lower child index is pushed first);
// - a leaf entry is -(1 + offset*16 + count-1).
//
// Node record (accel/bvh4.py::pack_bvh4_cuda): 4 children x 8 floats
// [lo.x lo.y lo.z hi.x | hi.y hi.z meta pad], read as two float4 per child.
// Triangles: (N, 3, 3) floats, [vertex][axis].

#include "traverse_common.cuh"

namespace {

constexpr int kStack = 64;   // accel/bvh4.py STACK_DEPTH (packer checks depth)

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
  float t_best = t_max[r];
  int prim = (kAnyHit && t_best < 0.f) ? 0 : -1;
  float b1 = 0.f, b2 = 0.f;
  const bool live = kAnyHit ? (t_best >= 0.f) : (t_best > 0.f);

  if (live) {
    const trav::Ray ray = trav::load_ray(o, d, r);
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
          float tn;
          const bool ok = trav::slab(ray, a.x, a.y, a.z, a.w, b.x, b.y, t_best, &tn);
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
        const bool hit = trav::leaf_test<kAnyHit>(ray, tris, u >> 4, (u & 15) + 1,
                                                  t_best, prim, b1, b2);
        if (kAnyHit && hit) break;
      }
    }
  }
  trav::store_hit<kAnyHit>(r, t_best, prim, b1, b2, t_out, prim_out, b1_out, b2_out);
}

}  // namespace

extern "C" int bvh4_traverse(const void* nodes, const void* tris,
                             const void* o, const void* d, const void* t_max,
                             int n_rays, int any_hit, void* t_out,
                             void* prim_out, void* b1_out, void* b2_out,
                             void* stream) {
  return trav::launch<float4>(bvh4_traverse_kernel<false>, bvh4_traverse_kernel<true>,
                              nodes, tris, o, d, t_max, n_rays, any_hit, t_out,
                              prim_out, b1_out, b2_out, stream);
}
