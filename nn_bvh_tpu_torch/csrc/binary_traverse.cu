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
// thread walks its own ray, 128 threads per block, and visits the nearer
// child by this ray's entry t first. The hits are the same but on exact t
// ties.
//
// What bounds it on this card: latency, not bytes or operations. A bench
// wave's nine calls could take 0.0124 ms at the memory rate or float32 peak
// and take 0.51 ms, 41 times that: each node step is a chain of dependent
// loads (record -> two slab tests -> next entry), a warp runs as long as
// its longest lane, and a binary tree takes about twice the node steps of
// the BVH4 one for the same ray. The design, step by step, each measured
// against the one before by device time on the nine batches of a bench
// wave (tools/bvh4_ab.py, NVIDIA H100 80GB HBM3, 700 W; PERF.md):
// (a) 16-byte triangle records (accel/bvh4.py::pack_tris_cuda, as
//     bvh4_traverse.cu reads them): three float4 loads a triangle, the next
//     one's issued before the current one is tested, no edge subtractions;
//     -10%;
// (b) child boxes stored in the parent (Aila and Laine, HPG 2009): one
//     64-byte record per interior node holds both children's boxes and
//     entries, so a step loads one record and makes two slab tests, keeps
//     the nearer hit child in a register and pushes the farther one; a child
//     that misses is never pushed or fetched; -15%;
// (c) the speculative while-while walk with postponed leaves of
//     bvh4_traverse.cu (trav::walk in traverse_common.cuh); -30%, -47% in
//     all against the per-ray transcription of the TPU kernel.
// Measured and left out: persistent warps taking 32 rays at a time from a
// global counter (+11% on (c)), and on top of them the top 255 records in
// shared memory (+4% more).
//
// Semantics match the plain version
// (nn_bvh_tpu_torch/accel/traverse.py::traverse_binary_plain); the slab test,
// triangle test and miss / any-hit rules are in traverse_common.cuh.
// Particular to this kernel:
// - node records (accel/binary.py::pack_binary_pairs): 16 floats
//   [lo0.xyz hi0.x | hi0.yz lo1.xy | lo1.z hi1.xyz | entry0 entry1 0 0],
//   read as four float4; an entry >= 1 is a record, < 0 a leaf
//   -(1 + offset*16 + count-1);
// - record 0 is a header: the walk starts at its entry0 (the root's record,
//   the leaf of a one-leaf tree, or kEmpty for an empty tree), without a
//   test of the root's box;
// - both children hit: the one of smaller max(entry t, 0) is visited first,
//   child 1 on equal keys (bvh4_traverse.cu's stable sort for two children);
// - triangles: (N, 3, 4) floats, [v0, 0 | e1, 0 | e2, 0].

#include "traverse_common.cuh"

namespace {

constexpr int kBlock = 128;

template <int kStack, bool kAnyHit>
__global__ void __launch_bounds__(kBlock)
binary_traverse_kernel(const float4* __restrict__ nodes,
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
  const int start = __float_as_int(__ldg(nodes + 3).x);  // the header's entry0

  // a node step: slab-test both children; go on with the nearer hit one and
  // push the other
  auto step = [&](int node, float tb, int* stack, int& sp) {
    const float4* p = nodes + 4 * (size_t)node;
    const float4 a = __ldg(p), b = __ldg(p + 1), c = __ldg(p + 2);
    const float2 e = __ldg(reinterpret_cast<const float2*>(p + 3));
    float t0, t1;
    const bool h0 = trav::slab(ray, a.x, a.y, a.z, a.w, b.x, b.y, tb, &t0);
    const bool h1 = trav::slab(ray, b.z, b.w, c.x, c.y, c.z, c.w, tb, &t1);
    const int e0 = __float_as_int(e.x), e1 = __float_as_int(e.y);
    if (h0 && h1) {
      const bool first0 = fmaxf(t0, 0.f) < fmaxf(t1, 0.f);
      stack[++sp] = first0 ? e1 : e0;
      return first0 ? e0 : e1;
    }
    if (h0 || h1) return h0 ? e0 : e1;
    return sp >= 0 ? stack[sp--] : trav::kEmpty;
  };
  trav::walk<kAnyHit, kStack>(ray, tris, live ? start : trav::kEmpty, step, t_best, prim,
                              b1, b2);
  if (in) trav::store_hit<kAnyHit>(r, t_best, prim, b1, b2, t_out, prim_out, b1_out, b2_out);
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
