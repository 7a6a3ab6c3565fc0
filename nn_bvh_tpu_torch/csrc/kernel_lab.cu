// The traversal kernel lab for Hopper (sm_90a): packet traversals with
// per-packet counters and a loop-floor probe.
//
// Replaces the three TPU kernels of tools/perf/kernel_lab.py:
// - lab_traverse (kernel body make_lab_kernel, kernel_lab.py:46-197):
//   entry lab_traverse;
// - brless_traverse (make_brless_kernel, kernel_lab.py:244-356): entry
//   brless_traverse;
// - floor_bench (make_floor_kernel, kernel_lab.py:400-430): entry
//   floor_bench.
//
// What those kernels compute is a packet walk, so a packet of rows*128 lanes
// is one block here, not one ray per thread as in binary_traverse.cu. The
// block has min(rows*128, 1024) threads; each owns rows*128/blockDim lanes,
// strided by blockDim, so neighbouring threads load neighbouring rays. The
// 64-entry stack, the packet's direction signs and the counters are uniform
// over the block, in shared memory and registers; the packet-wide `any` is
// __syncthreads_or. A node is visited when any lane's slab test hits it (dead
// and padding lanes vote too); the near child comes from the sign of the
// packet's summed direction on the split axis. The sums use one fixed order,
// each thread's lanes in lane order, then a halving tree over threads, which
// the plain versions (nn_bvh_tpu_torch/tools/kernel_lab.py) repeat, so kernel
// and plain give the same bits.
//
// What bounds them on this card: one packet walks its nodes one after
// another, each visit a chain of a dependent node load, a block-wide vote
// (one barrier) and a stack update (another barrier). That is latency, not
// bytes or operations. And a packet per block leaves most SMs idle at the
// lab's sizes: R = 65,536 with rows=32 makes 16 blocks on 132 SMs (rows=8:
// 64 blocks). That is a property of what the lab measures, not something
// this design hides; the per-ray kernels are the production path.
//
// Stack: no kernel writes past its 64 entries. A push that would do so sets
// *overflow, ends the walk, and the wrapper raises (k_pop > 1 can need more
// entries than the tree is deep; brless writes one entry above its top).
//
// Node records are accel/binary.py::pack_binary_cuda's (8 floats [lo.xyz,
// hi.xyz, offset, count+32*axis], the last two as int32 bits); triangles
// (N, 3, 3). Slab and Moller-Trumbore tests are traverse_common.cuh's, the
// arithmetic of pallas_traverse._slab_tile and _tri_isect_tile.

#include "traverse_common.cuh"

namespace {

constexpr int kStack = 64;
constexpr int kMaxLeaf = 8;
constexpr int kMaxPop = 4;
constexpr int kMaxThreads = 1024;
constexpr int kFloorWrap = 17000;
constexpr int kFloorSlots = 32;

struct NodeRec {
  float4 a, b;  // a = lo.x lo.y lo.z hi.x, b = hi.y hi.z offset count+32*axis
};

__device__ __forceinline__ NodeRec load_node(const float4* __restrict__ nodes,
                                             int node) {
  return {__ldg(nodes + 2 * (size_t)node), __ldg(nodes + 2 * (size_t)node + 1)};
}

// Lanes of this thread: base + threadIdx.x + i * blockDim.x, i < LPT.
template <int LPT>
struct Lanes {
  trav::Ray ray[LPT];
  float t[LPT];
  int prim[LPT];
};

// Sign of the packet's summed component c (0, 1, 2) of d: each thread's
// lanes in lane order, then a halving tree over the threads.
template <int LPT>
__device__ bool packet_neg(const float* __restrict__ d, int base, int c,
                           float* red) {
  const int tid = threadIdx.x, B = blockDim.x;
  float s = d[3 * (size_t)(base + tid) + c];
#pragma unroll
  for (int i = 1; i < LPT; ++i) s = s + d[3 * (size_t)(base + tid + i * B) + c];
  red[tid] = s;
  __syncthreads();
  for (int h = B >> 1; h > 0; h >>= 1) {
    if (tid < h) red[tid] = red[tid] + red[tid + h];
    __syncthreads();
  }
  const bool neg = red[0] < 0.f;
  __syncthreads();
  return neg;
}

template <int LPT>
__device__ bool load_lanes(Lanes<LPT>& L, const float* __restrict__ o,
                           const float* __restrict__ d,
                           const float* __restrict__ t_max, int base) {
  bool live = false;
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const int r = base + threadIdx.x + i * blockDim.x;
    L.ray[i] = trav::load_ray(o, d, r);
    L.t[i] = t_max[r];
    L.prim[i] = -1;
    live |= L.t[i] > 0.f;
  }
  return __syncthreads_or(live);
}

template <int LPT>
__device__ void store_lanes(const Lanes<LPT>& L, int base, float* t_out,
                            int* prim_out, int* cnt_out, int* cnt2_out, int cnt,
                            int cnt2) {
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const int r = base + threadIdx.x + i * blockDim.x;
    t_out[r] = L.t[i];
    prim_out[r] = L.prim[i];
    cnt_out[r] = cnt;
    cnt2_out[r] = cnt2;
  }
}

// Any lane of the packet hits the node's box (block-wide vote).
template <int LPT>
__device__ __forceinline__ bool packet_hits(const Lanes<LPT>& L, const NodeRec& n) {
  bool h = false;
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    float tn;
    h |= trav::slab(L.ray[i], n.a.x, n.a.y, n.a.z, n.a.w, n.b.x, n.b.y, L.t[i], &tn);
  }
  return __syncthreads_or(h);
}

// make_lab_kernel: pops up to k_pop entries, visits them in order (a popped
// slot that was empty visits the root, and counts), then pushes (far, near)
// for each descending visit in order. cnt counts visits, cnt2 leaf visits
// that some lane's box test hit.
template <int LPT, bool kLeaf>
__global__ void __launch_bounds__(kMaxThreads)
lab_kernel(const float4* __restrict__ nodes, const float* __restrict__ tris,
           const float* __restrict__ o, const float* __restrict__ d,
           const float* __restrict__ t_max, int k_pop, int vec, int count,
           float* __restrict__ t_out, int* __restrict__ prim_out,
           int* __restrict__ cnt_out, int* __restrict__ cnt2_out,
           int* __restrict__ overflow) {
  __shared__ int stack[kStack];
  __shared__ float red[kMaxThreads];
  __shared__ NodeRec rec_s;
  const int base = blockIdx.x * blockDim.x * LPT;
  Lanes<LPT> L;
  const bool live = load_lanes<LPT>(L, o, d, t_max, base);
  const bool neg[3] = {packet_neg<LPT>(d, base, 0, red), packet_neg<LPT>(d, base, 1, red),
                       packet_neg<LPT>(d, base, 2, red)};
  if (threadIdx.x == 0) stack[0] = 0;
  __syncthreads();

  int sp = live ? 0 : -1;
  int iters = 0, leafs = 0;
  while (sp >= 0) {
    int popped[kMaxPop];
#pragma unroll
    for (int k = 0; k < kMaxPop; ++k)
      popped[k] = (k < k_pop && sp - k >= 0) ? stack[sp - k] : -1;
    sp -= min(k_pop, sp + 1);

    bool desc[kMaxPop];
    int near[kMaxPop], far[kMaxPop];
#pragma unroll
    for (int k = 0; k < kMaxPop; ++k) {
      desc[k] = false;
      if (k >= k_pop) continue;
      const int node = max(popped[k], 0);
      NodeRec n;
      if (vec) {
        n = load_node(nodes, node);  // every thread, broadcast through L1
      } else {
        if (threadIdx.x == 0) rec_s = load_node(nodes, node);
        __syncthreads();
        n = rec_s;  // rewritten only after the vote below
      }
      const int off = __float_as_int(n.b.z);
      const int cnt_axis = __float_as_int(n.b.w);
      const int cnt_leaf = cnt_axis % 32;
      const int axis = cnt_axis / 32;
      const bool hit_any = packet_hits<LPT>(L, n);
      const bool is_leaf = cnt_leaf > 0;
      if (kLeaf && hit_any && is_leaf) {
#pragma unroll
        for (int i = 0; i < LPT; ++i) {
          float b1, b2;
          trav::leaf_test<false>(L.ray[i], tris, off, min(cnt_leaf, kMaxLeaf), L.t[i],
                                 L.prim[i], b1, b2);
        }
      }
      const bool ng = axis == 0 ? neg[0] : (axis == 1 ? neg[1] : neg[2]);
      near[k] = ng ? off : node + 1;
      far[k] = ng ? node + 1 : off;
      desc[k] = hit_any && !is_leaf && popped[k] >= 0;
      iters += 1;
      leafs += (hit_any && is_leaf) ? 1 : 0;
    }

    bool ovf = false;
#pragma unroll
    for (int k = 0; k < kMaxPop; ++k) {
      if (!desc[k] || ovf) continue;
      if (sp + 2 >= kStack) {
        ovf = true;
        continue;
      }
      if (threadIdx.x == 0) {
        stack[sp + 1] = far[k];
        stack[sp + 2] = near[k];
      }
      sp += 2;
    }
    if (ovf) {
      if (threadIdx.x == 0) *overflow = 1;
      sp = -1;
    }
    __syncthreads();  // pushes visible before the next pop
  }
  store_lanes<LPT>(L, base, t_out, prim_out, cnt_out, cnt2_out, count ? iters : 0,
                   count ? leafs : 0);
}

// make_brless_kernel: one entry per iteration, the leaf tests run every
// iteration on every lane (8 triangles at clamped indices, masked), the two
// pushes are unconditional and sp moves by the descend flag. The reference
// never writes its counters: they come back zero.
template <int LPT>
__global__ void __launch_bounds__(kMaxThreads)
brless_kernel(const float4* __restrict__ nodes, const float* __restrict__ tris,
              const float* __restrict__ o, const float* __restrict__ d,
              const float* __restrict__ t_max, int n_tris, int leaf_when,
              float* __restrict__ t_out, int* __restrict__ prim_out,
              int* __restrict__ cnt_out, int* __restrict__ cnt2_out,
              int* __restrict__ overflow) {
  __shared__ int stack[kStack];
  __shared__ float red[kMaxThreads];
  const int base = blockIdx.x * blockDim.x * LPT;
  Lanes<LPT> L;
  const bool live = load_lanes<LPT>(L, o, d, t_max, base);
  const bool neg[3] = {packet_neg<LPT>(d, base, 0, red), packet_neg<LPT>(d, base, 1, red),
                       packet_neg<LPT>(d, base, 2, red)};
  if (threadIdx.x == 0) stack[0] = 0;
  __syncthreads();

  int sp = live ? 0 : -1;
  while (sp >= 0) {
    const int node = stack[sp];
    const NodeRec n = load_node(nodes, node);
    const int off = __float_as_int(n.b.z);
    const int cnt_axis = __float_as_int(n.b.w);
    const int cnt_leaf = cnt_axis % 32;
    const int axis = cnt_axis / 32;
    const bool hit_any = packet_hits<LPT>(L, n);  // a barrier: stack[sp] read by all
    const bool is_leaf = cnt_leaf > 0;
    const bool gate = hit_any && is_leaf;
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      float tc = L.t[i];
      int pc = L.prim[i];
#pragma unroll
      for (int j = 0; j < kMaxLeaf; ++j) {
        // an interior node's min(off+j, off-1) is a node index: clamp it into
        // the table (the result is masked; the reference reads past its block)
        const int tj = min(max(min(off + j, off + cnt_leaf - 1), 0), n_tris - 1);
        float t, u1, u2;
        const bool h = trav::tri_test(L.ray[i], tris + (size_t)tj * 9, tc, &t, &u1, &u2) &&
                       j < cnt_leaf && (leaf_when || gate);
        tc = h ? t : tc;
        pc = h ? tj : pc;
      }
      L.t[i] = (!leaf_when || gate) ? tc : L.t[i];
      L.prim[i] = (!leaf_when || gate) ? pc : L.prim[i];
    }
    const bool descend = hit_any && !is_leaf;
    const bool ng = axis == 0 ? neg[0] : (axis == 1 ? neg[1] : neg[2]);
    if (sp + 1 >= kStack) {
      if (threadIdx.x == 0) *overflow = 1;
      break;
    }
    if (threadIdx.x == 0) {
      stack[sp] = ng ? node + 1 : off;      // far
      stack[sp + 1] = ng ? off : node + 1;  // near
    }
    sp = descend ? sp + 1 : sp - 1;
    __syncthreads();
  }
  store_lanes<LPT>(L, base, t_out, prim_out, cnt_out, cnt2_out, 0, 0);
}

// make_floor_kernel: one block, n_iter iterations of a stack write, a stack
// read and, with kLoad, a node load whose address depends on that read;
// kSlab runs a toy slab test on every lane and votes. The stack is zeroed
// first (the reference reads slots it has not written yet).
template <int LPT, bool kLoad, bool kSlab>
__global__ void __launch_bounds__(kMaxThreads)
floor_kernel(const float4* __restrict__ nodes, const float* __restrict__ ox,
             int n_iter, float* __restrict__ out) {
  __shared__ int stack[kFloorSlots];
  const int tid = threadIdx.x, B = blockDim.x;
  float x[LPT];
#pragma unroll
  for (int i = 0; i < LPT; ++i) x[i] = ox[tid + i * B];
  if (tid < kFloorSlots) stack[tid] = 0;
  __syncthreads();
  float acc = 0.f;
  int it = 0;
  while (it < n_iter) {
    if (tid == 0) stack[it % kFloorSlots] = it;
    __syncthreads();
    const int node = stack[(it * 7 + 3) % kFloorSlots];
    if (kLoad) {
      // the reference's address: block of node % 17000, lane of node
      const int addr = ((node % kFloorWrap) / 128) * 128 + node % 128;
      const float4 a = __ldg(nodes + 2 * (size_t)addr);
      if (kSlab) {
        bool h = false;
#pragma unroll
        for (int i = 0; i < LPT; ++i) {
          const float t0 = a.x - x[i], t1 = a.w - x[i];
          h |= fminf(t0, t1) < fmaxf(t0, t1) * 0.9f;
        }
        it += __syncthreads_or(h) * 0;
      } else {
        acc = acc + a.x;
      }
    }
    it += 1;
    __syncthreads();  // every read of this iteration before the next write
  }
#pragma unroll
  for (int i = 0; i < LPT; ++i) out[tid + i * B] = acc + (float)it;
}

int threads_for(int rows) { return rows * 128 < kMaxThreads ? rows * 128 : kMaxThreads; }

}  // namespace

// rows in {1, 2, 4, 8, 16, 32}, 1 <= k_pop <= 4 (the wrapper checks); o, d
// (n_packets*rows*128, 3) padded as the reference pads; outputs the same
// number of lanes; *overflow zeroed by the caller.
extern "C" int lab_traverse(const void* nodes, const void* tris, const void* o,
                            const void* d, const void* t_max, int n_packets, int rows,
                            int k_pop, int leaf, int vec, int count, void* t_out,
                            void* prim_out, void* cnt_out, void* cnt2_out,
                            void* overflow, void* stream) {
  if (n_packets <= 0) return 0;
  const int B = threads_for(rows), lpt = rows * 128 / B;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* nd = static_cast<const float4*>(nodes);
  auto* tr = static_cast<const float*>(tris);
  auto* po = static_cast<const float*>(o);
  auto* pd = static_cast<const float*>(d);
  auto* pt = static_cast<const float*>(t_max);
  auto* to = static_cast<float*>(t_out);
  auto* pr = static_cast<int*>(prim_out);
  auto* c1 = static_cast<int*>(cnt_out);
  auto* c2 = static_cast<int*>(cnt2_out);
  auto* ov = static_cast<int*>(overflow);
#define LAB_LAUNCH(LPT, LEAF)                                                          \
  lab_kernel<LPT, LEAF><<<n_packets, B, 0, s>>>(nd, tr, po, pd, pt, k_pop, vec, count, \
                                                to, pr, c1, c2, ov)
  if (lpt == 1) {
    if (leaf) LAB_LAUNCH(1, true); else LAB_LAUNCH(1, false);
  } else if (lpt == 2) {
    if (leaf) LAB_LAUNCH(2, true); else LAB_LAUNCH(2, false);
  } else if (lpt == 4) {
    if (leaf) LAB_LAUNCH(4, true); else LAB_LAUNCH(4, false);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LAB_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

extern "C" int brless_traverse(const void* nodes, const void* tris, const void* o,
                               const void* d, const void* t_max, int n_packets, int rows,
                               int n_tris, int leaf_when, void* t_out, void* prim_out,
                               void* cnt_out, void* cnt2_out, void* overflow,
                               void* stream) {
  if (n_packets <= 0) return 0;
  const int B = threads_for(rows), lpt = rows * 128 / B;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BRLESS_LAUNCH(LPT)                                                          \
  brless_kernel<LPT><<<n_packets, B, 0, s>>>(                                       \
      static_cast<const float4*>(nodes), static_cast<const float*>(tris),           \
      static_cast<const float*>(o), static_cast<const float*>(d),                   \
      static_cast<const float*>(t_max), n_tris, leaf_when,                          \
      static_cast<float*>(t_out), static_cast<int*>(prim_out),                      \
      static_cast<int*>(cnt_out), static_cast<int*>(cnt2_out), static_cast<int*>(overflow))
  if (lpt == 1) BRLESS_LAUNCH(1);
  else if (lpt == 2) BRLESS_LAUNCH(2);
  else if (lpt == 4) BRLESS_LAUNCH(4);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef BRLESS_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// One block; ox holds at least rows*128 floats, out (rows*128).
extern "C" int floor_bench(const void* nodes, const void* ox, int rows, int n_iter,
                           int with_load, int with_slab, void* out, void* stream) {
  const int B = threads_for(rows), lpt = rows * 128 / B;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* nd = static_cast<const float4*>(nodes);
  auto* px = static_cast<const float*>(ox);
  auto* po = static_cast<float*>(out);
#define FLOOR_LAUNCH(LPT)                                                    \
  do {                                                                       \
    if (!with_load) floor_kernel<LPT, false, false><<<1, B, 0, s>>>(nd, px, n_iter, po); \
    else if (!with_slab) floor_kernel<LPT, true, false><<<1, B, 0, s>>>(nd, px, n_iter, po); \
    else floor_kernel<LPT, true, true><<<1, B, 0, s>>>(nd, px, n_iter, po); \
  } while (0)
  if (lpt == 1) FLOOR_LAUNCH(1);
  else if (lpt == 2) FLOOR_LAUNCH(2);
  else if (lpt == 4) FLOOR_LAUNCH(4);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef FLOOR_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
