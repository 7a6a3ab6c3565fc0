// BVH4 ray traversal for Hopper (sm_90a): closest-hit and any-hit.
//
// Replaces the TPU kernel nn_bvh_tpu/accel/pallas_bvh4.py::_traverse_bvh4
// (kernel body _make_kernel, pallas_bvh4.py:97-292). It computes the same
// hits; its structure is not carried over. The TPU kernel walks packets of
// rays with one shared scalar stack because the TPU has scalar control flow;
// here every thread walks its own ray, 128 threads per block, one block per
// 128 rays.
//
// What bounds it on this card: latency, not bytes or operations. A bench
// wave's nine calls could take 0.0125 ms at the memory rate or float32 peak
// (the rays, and once each the node records and triangles a call reads:
// 0.33-1.9 MB of the 2.46 MB of tables, which fit the 50 MB L2) and take
// 0.49 ms, 39 times that: each node visit is a chain of dependent loads
// (node record -> slab tests -> sort -> next entry), and a warp runs as
// long as its longest lane: on the wave's bounce and shadow batches a warp's
// longest lane makes about twice the node visits and 3-4 times the triangle
// tests of its average lane. Measured by device time (tools/bvh4_ab.py on
// the nine wave batches, NVIDIA H100 80GB HBM3, 700 W; PERF.md), each step
// of the design against the one before:
// (a) 16-byte triangle records (accel/bvh4.py::pack_tris_cuda: v0 and the
//     two edges, rounded once on the host as the vertex table's load_tri in
//     traverse_common.cuh rounds them): a triangle is three float4 loads,
//     the next triangle's issued before the current one is tested, and the
//     six subtractions are gone; -15%.
// (b) while-while traversal with postponed leaves, speculative (Aila and
//     Laine, HPG 2009; trav::walk in traverse_common.cuh, shared with
//     binary_traverse.cu): node steps run warp-wide while any lane is still
//     looking for a leaf; a lane that finds one parks it in a register and
//     keeps visiting nodes until every lane has one (or is done), then the
//     warp tests the parked leaves together. Node and leaf work no longer
//     alternate inside one divergent loop iteration. The nearest hit child
//     stays in a register instead of a push and a pop. -20% on top of (a);
//     the non-speculative form (a lane with a parked leaf waits) gave -10%.
// (c) the per-thread stack stays in local memory (64 entries): a 32-entry
//     stack in shared memory, strided by thread, was 3%
//     slower in both forms of (b), and it would cap the tree depth lower.
//
// Semantics and constants match the plain version
// (nn_bvh_tpu_torch/accel/traverse.py::traverse_bvh4_plain); the slab test,
// triangle test and miss / any-hit rules are in traverse_common.cuh.
// Particular to this kernel:
// - hit children are pushed far to near by this ray's entry t (a stable
//   descending sort: on equal keys the lower child index is pushed first);
// - a leaf entry is -(1 + offset*16 + count-1);
// - a lane may visit nodes while its parked leaf is untested, so with a
//   t_best not yet reduced: that costs tests, never a result, except that on
//   an exact t tie between two triangles the other prim may win. Leaves are
//   still tested in the order the stack gives them.
//
// Node record (accel/bvh4.py::pack_bvh4_cuda): 4 children x 8 floats
// [lo.x lo.y lo.z hi.x | hi.y hi.z meta pad], read as two float4 per child.
// Triangles: (N, 3, 4) floats, [v0, 0 | e1, 0 | e2, 0].

#include "traverse_common.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kStack = 64;  // accel/bvh4.py STACK_DEPTH (packer checks depth)

// Slab-tests the 4 children of wide node `node` and sorts the hit ones far to
// near by entry t (a stable descending sort: on equal keys the lower child
// index comes first). -> number of hit children; meta[0..nhit-1] far to near.
__device__ __forceinline__ int visit(const float4* __restrict__ nodes, int node,
                                     const trav::Ray& ray, float t_best, int meta[4]) {
  const float4* nd = nodes + (size_t)node * 8;
  float key[4];
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
  return nhit;
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock)
bvh4_traverse_kernel(const float4* __restrict__ nodes,
                     const float* __restrict__ tris_f,
                     const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ t_max, int n_rays,
                     float* __restrict__ t_out, int* __restrict__ prim_out,
                     float* __restrict__ b1_out, float* __restrict__ b2_out) {
  const float4* tris = reinterpret_cast<const float4*>(tris_f);
  const int r = blockIdx.x * kBlock + threadIdx.x;
  // every thread of a warp takes part in its votes: none returns early
  const bool in = r < n_rays;
  float t_best = in ? t_max[r] : -1.f;
  int prim = (kAnyHit && t_best < 0.f) ? 0 : -1;
  float b1 = 0.f, b2 = 0.f;
  const bool live = in && (kAnyHit ? (t_best >= 0.f) : (t_best > 0.f));
  trav::Ray ray = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (live) ray = trav::load_ray(o, d, r);

  // a node step: push the hit children but the nearest, far to near; go on
  // with the nearest
  auto step = [&](int node, float tb, int* stack, int& sp) {
    int meta[4];
    const int nhit = visit(nodes, node, ray, tb, meta);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (c < nhit - 1) stack[++sp] = meta[c];
    }
    return nhit == 0 ? (sp >= 0 ? stack[sp--] : trav::kEmpty)
         : nhit == 1 ? meta[0] : nhit == 2 ? meta[1] : nhit == 3 ? meta[2] : meta[3];
  };
  trav::walk<kAnyHit, kStack>(ray, tris, live ? 0 : trav::kEmpty, step, t_best, prim, b1,
                              b2);
  if (in) trav::store_hit<kAnyHit>(r, t_best, prim, b1, b2, t_out, prim_out, b1_out, b2_out);
}

}  // namespace

extern "C" int bvh4_traverse(const void* nodes, const void* tris,
                             const void* o, const void* d, const void* t_max,
                             int n_rays, int any_hit, void* t_out,
                             void* prim_out, void* b1_out, void* b2_out,
                             void* stream) {
  return trav::launch<float4>(bvh4_traverse_kernel<false>, bvh4_traverse_kernel<true>, nodes,
                              tris, o, d, t_max, n_rays, any_hit, t_out, prim_out, b1_out,
                              b2_out, stream);
}
