// Binary-BVH ray traversal for Hopper (sm_90a): closest-hit and any-hit,
// with a per-ray stack of 64 or 128 entries.
//
// Replaces two TPU kernels that compute the same hits:
// - nn_bvh_tpu/accel/pallas_traverse.py::_traverse_packed (kernel body
//   _make_kernel, pallas_traverse.py:216-365), 64-entry stack: entry
//   binary_traverse;
// - nn_bvh_tpu/accel/hbm_traverse.py::_traverse_hbm (kernel body
//   _make_kernel, hbm_traverse.py:67-251), 128-entry stack for deep trees:
//   entry binary_traverse_deep. Its direct-mapped VMEM block cache has no
//   counterpart here: global loads already go through L1 and the 50 MB L2.
//
// The TPU kernels walk packets of rays with one shared scalar stack and
// order a node's children by the packet's majority direction sign. Here every
// thread walks its own ray with its own stack in local memory (128 threads
// per block) and takes the near child by this ray's direction sign on the
// node's split axis, as the XLA anchor (nn_bvh_tpu/accel/traverse.py:109-111)
// and pbrt's dirIsNeg do. The hits are the same.
//
// What bounds it on this card: a chain of dependent global loads, one
// 32-byte node record per pop, and warp divergence; a binary tree pops
// about twice as many nodes as the BVH4 one for the same ray. The bench
// tables (0.57 MB of nodes, 1.9 MB of triangles) stay in L2. This simple
// design does nothing about that yet.
//
// Semantics match the plain version
// (nn_bvh_tpu_torch/accel/traverse.py::traverse_binary_plain); the shared
// rules are in traverse_common.cuh. Particular to this kernel:
// - a popped node is slab-tested against its own box; a missed node is
//   dropped, a hit interior node pushes its far child, then its near child;
// - node record (accel/binary.py::pack_binary_cuda): 8 floats
//   [lo.x lo.y lo.z hi.x | hi.y hi.z offset count+32*axis], the last two as
//   int32 bits; interior: children self+1 and offset; leaf: count triangles
//   from offset.

#include "traverse_common.cuh"

namespace {

template <int kStack, bool kAnyHit>
__global__ void __launch_bounds__(128)
binary_traverse_kernel(const float4* __restrict__ nodes,
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
    int stack[kStack];  // the packer checks depth < kStack - 1
    int sp = 0;
    stack[0] = 0;  // root
    while (sp >= 0) {
      const int node = stack[sp];
      sp -= 1;
      const float4 a = __ldg(nodes + 2 * (size_t)node);
      const float4 b = __ldg(nodes + 2 * (size_t)node + 1);
      float tn;
      if (!trav::slab(ray, a.x, a.y, a.z, a.w, b.x, b.y, t_best, &tn)) continue;
      const int off = __float_as_int(b.z);
      const int count_axis = __float_as_int(b.w);
      const int count = count_axis & 31;
      if (count == 0) {
        const int axis = count_axis >> 5;
        const bool n = (axis == 0 ? ray.ix : (axis == 1 ? ray.iy : ray.iz)) < 0.f;
        stack[++sp] = n ? node + 1 : off;  // far
        stack[++sp] = n ? off : node + 1;  // near, popped next
      } else {
        const bool hit = trav::leaf_test<kAnyHit>(ray, tris, off, count, t_best,
                                                  prim, b1, b2);
        if (kAnyHit && hit) break;
      }
    }
  }
  trav::store_hit<kAnyHit>(r, t_best, prim, b1, b2, t_out, prim_out, b1_out, b2_out);
}

}  // namespace

extern "C" int binary_traverse(const void* nodes, const void* tris,
                               const void* o, const void* d, const void* t_max,
                               int n_rays, int any_hit, void* t_out,
                               void* prim_out, void* b1_out, void* b2_out,
                               void* stream) {
  return trav::launch<float4>(binary_traverse_kernel<64, false>,
                              binary_traverse_kernel<64, true>, nodes, tris, o,
                              d, t_max, n_rays, any_hit, t_out, prim_out,
                              b1_out, b2_out, stream);
}

extern "C" int binary_traverse_deep(const void* nodes, const void* tris,
                                    const void* o, const void* d,
                                    const void* t_max, int n_rays, int any_hit,
                                    void* t_out, void* prim_out, void* b1_out,
                                    void* b2_out, void* stream) {
  return trav::launch<float4>(binary_traverse_kernel<128, false>,
                              binary_traverse_kernel<128, true>, nodes, tris,
                              o, d, t_max, n_rays, any_hit, t_out, prim_out,
                              b1_out, b2_out, stream);
}
