// BVH8 ray traversal for Hopper (sm_90a): closest-hit and any-hit.
//
// Replaces the TPU kernel nn_bvh_tpu/accel/pallas_bvh8.py::_traverse_bvh8
// (kernel body _make_kernel, pallas_bvh8.py:66-219). It computes the same
// hits; its structure is not carried over. The TPU kernel walks one packet
// per ray tile with one shared scalar stack and sorts a node's children by
// the packet's minimum entry t with a Batcher network, which is not stable on
// equal keys. Here every thread walks its own ray with its own 192-entry
// stack in local memory (768 bytes, 128 threads per block) and visits the
// hit children in ascending order of this ray's entry t, stable on ties: the
// lower child slot first.
//
// What bounds it on this card: the same chain of dependent global loads as
// the BVH4 kernel, with a 256-byte node record per pop (16 float4 loads), an
// 8-key sort in registers, and the deep local-memory stack, whose pushes and
// pops spill to L1. The bench tables (0.69 MB of nodes, 1.9 MB of
// triangles) stay in L2. This simple design does nothing about that yet.
//
// Semantics match the plain version
// (nn_bvh_tpu_torch/accel/traverse.py::traverse_bvh8_plain); the shared
// rules are in traverse_common.cuh. Particular to this kernel:
// - node record (accel/bvh8.py::pack_bvh8_cuda): 8 children x 8 floats
//   [lo.x lo.y lo.z hi.x | hi.y hi.z meta pad], f32 bounds; empty children
//   have lo = hi = 3e38 and never pass the slab test;
// - child meta >= 0 is a wide-node index, < 0 a leaf
//   -(1 + offset*8 + count-1) (accel/bvh8.py); the packer checks that
//   7 * depth + 1 stays below the stack.

#include "traverse_common.cuh"

namespace {

constexpr int kStack = 192;  // accel/bvh8.py STACK_DEPTH
constexpr int kWidth = 8;

template <bool kAnyHit>
__global__ void __launch_bounds__(128)
bvh8_traverse_kernel(const float4* __restrict__ nodes,
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
        const float4* nd = nodes + (size_t)entry * (2 * kWidth);
        float key[kWidth];
        int meta[kWidth];
        int nhit = 0;
#pragma unroll
        for (int c = 0; c < kWidth; ++c) {
          const float4 a = __ldg(nd + 2 * c);
          const float4 b = __ldg(nd + 2 * c + 1);
          float tn;
          const bool ok = trav::slab(ray, a.x, a.y, a.z, a.w, b.x, b.y, t_best, &tn);
          key[c] = ok ? fmaxf(tn, 0.f) : INFINITY;
          meta[c] = __float_as_int(b.z);
          nhit += ok ? 1 : 0;
        }
        // stable ascending insertion sort: hits first, nearest first
#pragma unroll
        for (int i = 1; i < kWidth; ++i) {
#pragma unroll
          for (int j = i; j > 0; --j) {
            if (key[j - 1] > key[j]) {
              const float tk = key[j - 1]; key[j - 1] = key[j]; key[j] = tk;
              const int tm = meta[j - 1]; meta[j - 1] = meta[j]; meta[j] = tm;
            }
          }
        }
        // push far to near, so the nearest hit child is popped next
#pragma unroll
        for (int c = kWidth - 1; c >= 0; --c) {
          if (c < nhit) stack[++sp] = meta[c];
        }
      } else {
        const int u = -entry - 1;
        const bool hit = trav::leaf_test<kAnyHit>(ray, tris, u >> 3, (u & 7) + 1,
                                                  t_best, prim, b1, b2);
        if (kAnyHit && hit) break;
      }
    }
  }
  trav::store_hit<kAnyHit>(r, t_best, prim, b1, b2, t_out, prim_out, b1_out, b2_out);
}

}  // namespace

extern "C" int bvh8_traverse(const void* nodes, const void* tris,
                             const void* o, const void* d, const void* t_max,
                             int n_rays, int any_hit, void* t_out,
                             void* prim_out, void* b1_out, void* b2_out,
                             void* stream) {
  return trav::launch<float4>(bvh8_traverse_kernel<false>, bvh8_traverse_kernel<true>,
                              nodes, tris, o, d, t_max, n_rays, any_hit, t_out,
                              prim_out, b1_out, b2_out, stream);
}
