// BVH8 ray traversal for Hopper (sm_90a): closest-hit and any-hit.
//
// Replaces the TPU kernel nn_bvh_tpu/accel/pallas_bvh8.py::_traverse_bvh8
// (kernel body _make_kernel, pallas_bvh8.py:66-219). It computes the same
// hits; its structure is not carried over. The TPU kernel walks one packet
// per ray tile with one shared scalar stack and sorts a node's children by
// the packet's minimum entry t; here every thread walks its own ray, 128
// threads per block, and orders the children by this ray's entry t.
//
// What bounds it on this card: latency and instruction throughput, not bytes
// or operations. A bench wave's nine calls could take 0.0129 ms at the memory
// rate or float32 peak and take 0.47 ms: each node visit is a chain of
// dependent work (node record -> eight slab tests -> order -> next entry),
// and a warp runs as long as its longest lane. The design, each step
// measured against the one before by device time on the nine batches of a
// bench wave (tools/bvh4_ab.py, NVIDIA H100 80GB HBM3, 700 W; PERF.md):
// (a) 16-byte triangle records (accel/bvh4.py::pack_tris_cuda), as the BVH4
//     and binary kernels read them; -13%;
// (b) the speculative while-while walk with postponed leaves shared with
//     them (trav::walk in traverse_common.cuh): a node step pushes the hit
//     children but the nearest, far to near, and goes on with the nearest
//     in a register; -17%;
// (d) the children ordered by a 19-comparator sorting network on packed
//     32-bit keys, the entries carried beside them, instead of 28
//     compare-swaps of (t, entry) pairs; -2%, -29% in all.
// Measured and left out: (c) 96-byte records with 8-bit child boxes
// quantized against a per-node grid (Ylitie, Karras and Laine, HPG 2017):
// 6 float4 loads a node instead of 16, but a byte permute and an addition
// more for each of a child's 6 planes, and 3% more node visits; +5.5% on
// (b) and +7.2% on (d), slower also with L2 flushed before each call.
//
// Semantics match the plain version
// (nn_bvh_tpu_torch/accel/traverse.py::traverse_bvh8_plain); the slab test,
// triangle test and miss / any-hit rules are in traverse_common.cuh.
// Particular to this kernel:
// - node record (accel/bvh8.py::pack_bvh8_cuda): 8 children x 8 floats
//   [lo.x lo.y lo.z hi.x | hi.y hi.z entry pad], f32 bounds; empty children
//   have lo = hi = 3e38, which no ray's slab test passes;
// - a child entry >= 0 is a wide node, < 0 a leaf -(1 + offset*16 +
//   count-1); the packer checks that 7 * depth stays within the stack;
// - hit children are ordered by the key (bits of max(entry t, 0) with the
//   low 3 bits replaced by the slot), ascending: the lower slot first where
//   two keys agree above those bits;
// - triangles: (N, 3, 4) floats, [v0, 0 | e1, 0 | e2, 0].

#include "traverse_common.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kStack = 192;  // accel/bvh8.py STACK_DEPTH
constexpr unsigned kMiss = 0xffffffffu;

// Sorts 8 (key, entry) pairs by key, ascending, the keys distinct: the
// 19-comparator network of depth 6 (Knuth, TAOCP vol. 3, 5.3.4).
__device__ __forceinline__ void sort8(unsigned k[8], int e[8]) {
  auto cx = [&](int a, int b) {
    const bool s = k[b] < k[a];
    const unsigned ka = s ? k[b] : k[a], kb = s ? k[a] : k[b];
    const int ea = s ? e[b] : e[a], eb = s ? e[a] : e[b];
    k[a] = ka; k[b] = kb; e[a] = ea; e[b] = eb;
  };
  cx(0, 2); cx(1, 3); cx(4, 6); cx(5, 7);
  cx(0, 4); cx(1, 5); cx(2, 6); cx(3, 7);
  cx(0, 1); cx(2, 3); cx(4, 5); cx(6, 7);
  cx(2, 4); cx(3, 5);
  cx(1, 4); cx(3, 6);
  cx(1, 2); cx(3, 4); cx(5, 6);
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock)
bvh8_traverse_kernel(const float4* __restrict__ nodes,
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

  // a node step: slab-test the 8 children, push the hit ones but the
  // nearest, far to near; go on with the nearest
  auto step = [&](int node, float tb, int* stack, int& sp) {
    const float4* nd = nodes + (size_t)node * 16;
    unsigned key[8];
    int ent[8];
    int nhit = 0;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float4 a = __ldg(nd + 2 * c);
      const float4 b = __ldg(nd + 2 * c + 1);
      float tn;
      const bool hit = trav::slab(ray, a.x, a.y, a.z, a.w, b.x, b.y, tb, &tn);
      key[c] = hit ? (static_cast<unsigned>(max(__float_as_int(tn), 0)) & ~7u) | c : kMiss;
      ent[c] = __float_as_int(b.z);
      nhit += hit ? 1 : 0;
    }
    sort8(key, ent);
#pragma unroll
    for (int i = 7; i >= 1; --i) {
      if (i < nhit) stack[++sp] = ent[i];
    }
    if (nhit == 0) return sp >= 0 ? stack[sp--] : trav::kEmpty;
    return ent[0];
  };
  trav::walk<kAnyHit, kStack>(ray, tris, live ? 0 : trav::kEmpty, step, t_best, prim, b1,
                              b2);
  if (in) trav::store_hit<kAnyHit>(r, t_best, prim, b1, b2, t_out, prim_out, b1_out, b2_out);
}

}  // namespace

extern "C" int bvh8_traverse(const void* nodes, const void* tris,
                             const void* o, const void* d, const void* t_max,
                             int n_rays, int any_hit, void* t_out,
                             void* prim_out, void* b1_out, void* b2_out,
                             void* stream) {
  return trav::launch<float4>(bvh8_traverse_kernel<false>, bvh8_traverse_kernel<true>, nodes,
                              tris, o, d, t_max, n_rays, any_hit, t_out, prim_out, b1_out,
                              b2_out, stream);
}
