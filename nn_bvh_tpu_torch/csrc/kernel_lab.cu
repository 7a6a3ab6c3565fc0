// The traversal kernel lab for Hopper (sm_90a): packet traversals with
// per-packet counters and a loop-floor probe.
//
// Replaces the three TPU kernels of tools/perf/kernel_lab.py:
// - lab_traverse (kernel body make_lab_kernel, kernel_lab.py:46-197):
//   entry lab_traverse;
// - brless_traverse (make_brless_kernel, kernel_lab.py:244-356): entry
//   brless_traverse;
// - floor_bench (make_floor_kernel, kernel_lab.py:400-430): entry
//   floor_bench, one packet laid out as the traversals lay it out, each
//   variant one more piece of a visit. Entry floor_cycles times those
//   pieces alone (a probe of this card, with no TPU counterpart).
//
// What the two traversals compute is a packet walk: a packet of rows*128
// lanes has one 64-entry stack and one walk order; a node is visited when any
// lane's slab test hits it (dead and padding lanes vote too); the near child
// comes from the sign of the packet's summed direction on the split axis; the
// counters are per packet. Those semantics are what the lab measures, so they
// stay; the parallelism comes from inside the packet.
//
// What bounds them on this card is the chain of a packet's visits: each is
// a node record, a slab test on every lane, a packet-wide vote and, on a
// leaf visit, up to 8 triangle tests on every lane, and the next visit waits
// for the vote. One packet per block put rows*128 lanes on one SM (R = 65,536
// with rows = 32 was 16 blocks on 132 SMs). Here a packet is a thread-block
// cluster of C = min(8, rows*128/32) blocks on neighbouring SMs, one lane a
// thread (tools/kernel_lab.py::launch_geometry; more, smaller blocks measured
// faster than filling the SMs once, since several clusters then share an SM
// and hide each other's waits).
//
// Every block keeps its own copy of the packet's state (stack, sp, direction
// signs, counters) and makes the same decisions from the same node record and
// the same vote, so only the vote crosses blocks, once a visit, through
// distributed shared memory (cluster_any: the block's OR, st.async into every
// peer's shared memory, completing on the peer's mbarrier; no cluster
// barrier). StackOverflow fires the same way in every block; rank 0 writes
// the flag.
//
// A node's record is read by every thread (vec, broadcast through L1) or by
// thread 0, which publishes it in shared memory through an mbarrier (not
// vec). A leaf's triangles are staged in shared memory before the vote, so
// the lanes read them as broadcasts. Thread 0 writes the stack after a
// visit's vote; an entry that the next iteration pops before its vote (the
// last visit's pushes) is also kept in registers.
//
// The direction sums keep the order of one packet per block: the old
// min(rows*128, 1024) threads each sum their lanes in lane order, then a
// halving tree; every block reads the packet's d and repeats it, so the
// plain versions (nn_bvh_tpu_torch/tools/kernel_lab.py) give the same bits.
//
// Stack: no kernel writes past its 64 entries. A push that would do so sets
// *overflow, ends the walk, and the wrapper raises (k_pop > 1 can need more
// entries than the tree is deep; brless writes one entry above its top).
//
// Node records are accel/binary.py::pack_binary_cuda's (8 floats [lo.xyz,
// hi.xyz, offset, count+32*axis], the last two as int32 bits); triangles
// (N, 3, 3). Slab and Moller-Trumbore tests are traverse_common.cuh's, the
// arithmetic of pallas_traverse._slab_tile and _tri_isect_tile.

#include <cooperative_groups.h>

#include <cstdint>

#include "traverse_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kStack = 64;
constexpr int kMaxLeaf = 8;
constexpr int kMaxPop = 4;
constexpr int kBlockThreads = 512;  // a packet block's most threads
constexpr int kMaxCluster = 8;
constexpr int kSignThreads = 1024;  // the summation order's threads
constexpr int kFloorWrap = 17000;
constexpr int kFloorSlots = 32;

struct NodeRec {
  float4 a, b;  // a = lo.x lo.y lo.z hi.x, b = hi.y hi.z offset count+32*axis
};

__device__ __forceinline__ NodeRec load_node(const float4* __restrict__ nodes,
                                             int node) {
  return {__ldg(nodes + 2 * (size_t)node), __ldg(nodes + 2 * (size_t)node + 1)};
}

// What a block of a packet's cluster keeps in shared memory.
struct PacketShared {
  int stack[kStack];
  float red[3][kSignThreads];          // the direction sums
  float tri[2][kMaxLeaf * 9];          // staged triangles, by visit parity
  NodeRec rec;                         // the node record (not vec)
  unsigned vote[2 * kMaxCluster];      // the cluster's votes
  unsigned long long bar[3];           // mbarriers: votes (2), record
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Waits for the phase of `parity` to complete. A wait of seconds is a fault
// of the kernel: it traps rather than hold the card.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 34)) __trap();
  } while (!done);
}

__device__ __forceinline__ uint32_t peer_u32(uint32_t a, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// A 4-byte store into a peer's shared memory that completes on the peer's
// mbarrier (both addresses the peer's, shared::cluster).
__device__ __forceinline__ void st_async(uint32_t addr, uint32_t value, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];" ::"r"(
                   addr),
               "r"(value), "r"(bar)
               : "memory");
}

// Thread 0 sets the block's three mbarriers (votes, record), one arrival
// each, visible to the cluster; peers may use them after a cluster sync.
__device__ __forceinline__ void init_mbarriers(PacketShared& s) {
  for (int i = 0; i < 3; ++i) mbar_init(&s.bar[i], 1);
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// The geometry of this block in its packet's cluster: one lane a thread.
struct Geo {
  int C, rank, T, tid;
  int packet_base;  // the packet's first lane
  int lane;         // this thread's lane
  int P;            // lanes of a packet
};

__device__ __forceinline__ Geo geometry() {
  cg::cluster_group cl = cg::this_cluster();
  Geo g;
  g.C = static_cast<int>(cl.num_blocks());
  g.rank = static_cast<int>(cl.block_rank());
  g.T = blockDim.x;
  g.tid = threadIdx.x;
  g.P = g.C * g.T;
  g.packet_base = static_cast<int>(blockIdx.x) / g.C * g.P;
  g.lane = g.packet_base + g.rank * g.T + g.tid;
  return g;
}

// Any lane of the packet votes true (every thread of the cluster calls it
// with the same v, the count of earlier votes). The block's OR, then point
// to point: threads 0..C-1 each send it by a 4-byte st.async into slot
// [v&1][rank] of one peer, completing on that peer's mbarrier [v&1]; each
// block waits on its own mbarrier (phase (v>>1)&1) and ORs its C slots. No
// cluster barrier: a fast block can be at most one vote ahead of a slow one
// (it waits for the slow one's bit), so two sets of slots and mbarriers do.
// vote_exchange is the part after the block's OR b (floor_cycles also
// times it alone, on warp 0).
__device__ __forceinline__ bool vote_exchange(bool b, PacketShared& s, const Geo& g, int v) {
  const int p = v & 1;
  if (g.tid == 0) mbar_expect_tx(&s.bar[p], 4u * g.C);
  if (g.tid < g.C)
    st_async(peer_u32(smem_u32(&s.vote[p * kMaxCluster + g.rank]), g.tid), b ? 1u : 0u,
             peer_u32(smem_u32(&s.bar[p]), g.tid));
  mbar_wait(&s.bar[p], (v >> 1) & 1);
  const volatile unsigned* slot = s.vote + p * kMaxCluster;
  bool any = false;
  for (int r = 0; r < g.C; ++r) any |= slot[r] != 0u;
  return any;
}

__device__ __forceinline__ bool cluster_any(bool h, PacketShared& s, const Geo& g, int v) {
  return vote_exchange(__syncthreads_or(h), s, g, v);
}

// This thread's lane.
struct Lane {
  trav::Ray ray;
  float t;
  int prim;
};

// Loads the lane, sets stack[0] = 0, inits the mbarriers, sums the packet's
// direction in the fixed order -> neg, and votes whether the packet is live
// (vote 0).
__device__ bool prologue(Lane& L, PacketShared& s, const Geo& g, const float* __restrict__ o,
                         const float* __restrict__ d, const float* __restrict__ t_max,
                         bool neg[3]) {
  if (g.tid == 0) {
    s.stack[0] = 0;
    init_mbarriers(s);
  }
  L.ray = trav::load_ray(o, d, g.lane);
  L.t = t_max[g.lane];
  L.prim = -1;
  // each of V virtual threads sums lanes vt, vt + V, ... in lane order, then
  // a halving tree over the V sums
  const int V = g.P < kSignThreads ? g.P : kSignThreads, per = g.P / V;
  for (int vt = g.tid; vt < V; vt += g.T) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float sum = d[3 * (size_t)(g.packet_base + vt) + c];
      for (int i = 1; i < per; ++i) sum = sum + d[3 * (size_t)(g.packet_base + vt + i * V) + c];
      s.red[c][vt] = sum;
    }
  }
  __syncthreads();
  for (int h = V >> 1; h > 0; h >>= 1) {
    for (int vt = g.tid; vt < h; vt += g.T) {
#pragma unroll
      for (int c = 0; c < 3; ++c) s.red[c][vt] = s.red[c][vt] + s.red[c][vt + h];
    }
    __syncthreads();
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) neg[c] = s.red[c][0] < 0.f;
  cg::this_cluster().sync();  // every peer started, its mbarriers set
  return cluster_any(L.t > 0.f, s, g, 0);
}

__device__ __forceinline__ void store_lane(const Lane& L, const Geo& g, float* t_out,
                                           int* prim_out, int* cnt_out, int* cnt2_out, int cnt,
                                           int cnt2) {
  t_out[g.lane] = L.t;
  prim_out[g.lane] = L.prim;
  cnt_out[g.lane] = cnt;
  cnt2_out[g.lane] = cnt2;
}

// The lane hits the node's box.
__device__ __forceinline__ bool lane_hits(const Lane& L, const NodeRec& n) {
  float tn;
  return trav::slab(L.ray, n.a.x, n.a.y, n.a.z, n.a.w, n.b.x, n.b.y, L.t, &tn);
}

// A staged triangle: the arithmetic of trav::load_tri on shared floats.
__device__ __forceinline__ trav::Tri staged_tri(const float* v) {
  const float x0 = v[0], y0 = v[1], z0 = v[2];
  return {make_float4(x0, y0, z0, 0.f), make_float4(v[3] - x0, v[4] - y0, v[5] - z0, 0.f),
          make_float4(v[6] - x0, v[7] - y0, v[8] - z0, 0.f)};
}

// Thread 0 makes a record (make()) and publishes it in shared memory
// through the record mbarrier; every thread waits for it -> the record.
// The caller rewrites s.rec only after a barrier that every thread reaches
// after reading it. nrec counts the records published.
template <class Make>
__device__ __forceinline__ NodeRec publish(PacketShared& s, const Geo& g, uint32_t& nrec,
                                           Make make) {
  if (g.tid == 0) {
    s.rec = make();
    mbar_arrive(&s.bar[2]);
  }
  mbar_wait(&s.bar[2], nrec & 1u);
  ++nrec;
  return s.rec;  // mbar_wait is a compiler barrier: read after it
}

// The node record a visit reads. vec: every thread loads it; else thread 0
// loads it and publishes it (s.rec is rewritten only after this visit's
// vote, which every thread reaches after reading it).
__device__ __forceinline__ NodeRec visit_record(const float4* __restrict__ nodes, int node,
                                                bool vec, PacketShared& s, const Geo& g,
                                                uint32_t& nrec) {
  if (vec) return load_node(nodes, node);
  return publish(s, g, nrec, [&] { return load_node(nodes, node); });
}

// make_lab_kernel: pops up to k_pop entries, visits them in order (a popped
// slot that was empty visits the root, and counts), then pushes (far, near)
// for each descending visit in order. cnt counts visits, cnt2 leaf visits
// that some lane's box test hit. Each visit has its own vote: a leaf visit
// lowers the t that the next box test reads.
template <bool kLeaf>
__global__ void __launch_bounds__(kBlockThreads)
lab_kernel(const float4* __restrict__ nodes, const float* __restrict__ tris,
           const float* __restrict__ o, const float* __restrict__ d,
           const float* __restrict__ t_max, int k_pop, int vec, int count,
           float* __restrict__ t_out, int* __restrict__ prim_out,
           int* __restrict__ cnt_out, int* __restrict__ cnt2_out,
           int* __restrict__ overflow) {
  __shared__ PacketShared s;
  const Geo g = geometry();
  Lane L;
  bool neg[3];
  const bool live = prologue(L, s, g, o, d, t_max, neg);
  int v = 1;          // votes so far
  uint32_t nrec = 0;  // records published (not vec)
  int sp = live ? 0 : -1;
  int iters = 0, leafs = 0;
  // Thread 0 writes the stack after a visit's vote. The last visit's pushes
  // (entries lpos, lpos+1) are popped before the next vote, so every thread
  // keeps them; any other entry was written at least one vote before it is
  // read.
  int lpos = -kStack, lfar = 0, lnear = 0;
  auto entry = [&](int i) { return i == lpos ? lfar : (i == lpos + 1 ? lnear : s.stack[i]); };
  while (sp >= 0) {
    int popped[kMaxPop];
#pragma unroll
    for (int k = 0; k < kMaxPop; ++k)
      popped[k] = (k < k_pop && sp - k >= 0) ? entry(sp - k) : -1;
    sp -= min(k_pop, sp + 1);

    int npos = -kStack, nfar = 0, nnear = 0;
    bool ovf = false;
#pragma unroll
    for (int k = 0; k < kMaxPop; ++k) {
      if (k >= k_pop) continue;
      const int node = max(popped[k], 0);
      const NodeRec n = visit_record(nodes, node, vec, s, g, nrec);
      const int off = __float_as_int(n.b.z);
      const int cnt_axis = __float_as_int(n.b.w);
      const int cnt_leaf = cnt_axis % 32;
      const int axis = cnt_axis / 32;
      const bool is_leaf = cnt_leaf > 0;
      const int nt = min(cnt_leaf, kMaxLeaf);
      // a leaf's triangles into shared memory before the vote; the buffer of
      // parity v is rewritten two votes later
      float* staged = s.tri[v & 1];
      if (kLeaf && is_leaf)
        for (int i = g.tid; i < 9 * nt; i += g.T) staged[i] = __ldg(tris + 9 * (size_t)off + i);
      const bool ng = axis == 0 ? neg[0] : (axis == 1 ? neg[1] : neg[2]);
      const int near = ng ? off : node + 1;
      const int far = ng ? node + 1 : off;
      const bool interior = !is_leaf && popped[k] >= 0;  // descends when the vote hits
      const bool hit_any = cluster_any(lane_hits(L, n), s, g, v++);
      if (kLeaf && hit_any && is_leaf) {
        for (int j = 0; j < nt; ++j) {
          float t, u1, u2;
          if (trav::tri_test(L.ray, staged_tri(staged + 9 * j), L.t, &t, &u1, &u2)) {
            L.prim = off + j;
            L.t = t;
          }
        }
      }
      iters += 1;
      leafs += (hit_any && is_leaf) ? 1 : 0;
      if (hit_any && interior && !ovf) {  // pushes in visit order
        if (sp + 2 >= kStack) {
          ovf = true;
        } else {
          if (g.tid == 0) {
            s.stack[sp + 1] = far;
            s.stack[sp + 2] = near;
          }
          if (k == k_pop - 1) {
            npos = sp + 1;
            nfar = far;
            nnear = near;
          }
          sp += 2;
        }
      }
    }
    lpos = npos;
    lfar = nfar;
    lnear = nnear;
    if (ovf) {
      if (g.rank == 0 && g.tid == 0) *overflow = 1;
      sp = -1;
    }
  }
  store_lane(L, g, t_out, prim_out, cnt_out, cnt2_out, count ? iters : 0, count ? leafs : 0);
  cg::this_cluster().sync();  // no block leaves while a peer may still write to it
}

// make_brless_kernel: one entry per iteration, the leaf tests run every
// iteration on every lane (8 triangles at clamped indices, masked, the result
// selected), the two pushes are unconditional and sp moves by the descend
// flag. The reference never writes its counters: they come back zero.
__global__ void __launch_bounds__(kBlockThreads)
brless_kernel(const float4* __restrict__ nodes, const float* __restrict__ tris,
              const float* __restrict__ o, const float* __restrict__ d,
              const float* __restrict__ t_max, int n_tris, int leaf_when,
              float* __restrict__ t_out, int* __restrict__ prim_out,
              int* __restrict__ cnt_out, int* __restrict__ cnt2_out,
              int* __restrict__ overflow) {
  __shared__ PacketShared s;
  const Geo g = geometry();
  Lane L;
  bool neg[3];
  const bool live = prologue(L, s, g, o, d, t_max, neg);
  int v = 1;
  int sp = live ? 0 : -1;
  // thread 0 writes entries sp, sp+1 after the vote; the next iteration
  // reads entry sp+1 before its vote when it descended, so every thread
  // keeps that one (top); any other entry it reads is older than a vote
  bool top_held = false;
  int top = 0;
  while (sp >= 0) {
    const int node = top_held ? top : s.stack[sp];
    const NodeRec n = load_node(nodes, node);
    const int off = __float_as_int(n.b.z);
    const int cnt_axis = __float_as_int(n.b.w);
    const int cnt_leaf = cnt_axis % 32;
    const int axis = cnt_axis / 32;
    const bool is_leaf = cnt_leaf > 0;
    // an interior node's min(off+j, off-1) is a node index: clamp it into
    // the table (the result is masked; the reference reads past its block)
    auto tri_index = [&](int j) {
      return min(max(min(off + j, off + cnt_leaf - 1), 0), n_tris - 1);
    };
    float* staged = s.tri[v & 1];  // the 8 triangles, before the vote
    for (int i = g.tid; i < 9 * kMaxLeaf; i += g.T)
      staged[i] = __ldg(tris + 9 * (size_t)tri_index(i / 9) + i % 9);
    const bool ng = axis == 0 ? neg[0] : (axis == 1 ? neg[1] : neg[2]);
    const int near = ng ? off : node + 1;
    const int far = ng ? node + 1 : off;
    const bool hit_any = cluster_any(lane_hits(L, n), s, g, v++);
    const bool gate = hit_any && is_leaf;
    float tc = L.t;
    int pc = L.prim;
#pragma unroll
    for (int j = 0; j < kMaxLeaf; ++j) {  // all 8 in order; the hit selected, not branched to
      float t, u1, u2;
      const bool h = trav::tri_test(L.ray, staged_tri(staged + 9 * j), tc, &t, &u1, &u2) &&
                     j < cnt_leaf && (leaf_when || gate);
      tc = h ? t : tc;
      pc = h ? tri_index(j) : pc;
    }
    L.t = (!leaf_when || gate) ? tc : L.t;
    L.prim = (!leaf_when || gate) ? pc : L.prim;
    const bool descend = hit_any && !is_leaf;
    if (sp + 1 >= kStack) {
      if (g.rank == 0 && g.tid == 0) *overflow = 1;
      break;
    }
    if (g.tid == 0) {
      s.stack[sp] = far;
      s.stack[sp + 1] = near;
    }
    top_held = descend;
    top = near;
    sp = descend ? sp + 1 : sp - 1;
  }
  store_lane(L, g, t_out, prim_out, cnt_out, cnt2_out, 0, 0);
  cg::this_cluster().sync();
}

// make_floor_kernel, laid out as one lab packet: a cluster of C blocks of
// T threads, one lane a thread (launch_geometry), every block with its own
// 32-slot stack, zeroed first (the reference reads slots it has not
// written). Each variant adds one piece of a lab visit:
// - stack only: thread 0 writes slot it % 32, every thread reads slot
//   (7*it+3) % 32. The read feeds nothing (in the JAX kernel as here), so
//   the variant times the write and the barrier;
// - kLoad: thread 0 loads the record at the reference's address of the
//   node it read and publishes it to its block through the record mbarrier
//   (visit_record, the lab's default way, not vec); every lane adds lo.x;
// - kSlab: every lane's toy slab test on the record feeds the packet's vote
//   (cluster_any, the lab's); the vote adds hit * 0 to it.
// One block barrier an iteration, at its end: __syncthreads, or in kSlab
// the vote's own block OR. The slot read at iteration it was last written
// 1 to 31 iterations earlier (6*it+3 is odd mod 32: never the slot written
// at it), so an earlier iteration's barrier orders the write before the
// read; the next write of that slot, and thread 0's next record, come after
// this iteration's barrier, which every thread reaches after its reads.
// kLoad adds the record's mbarrier phase, kSlab the vote's exchange between
// the blocks (their only link: without kSlab each block runs alone).
template <bool kLoad, bool kSlab>
__global__ void __launch_bounds__(kBlockThreads)
floor_kernel(const float4* __restrict__ nodes, const float* __restrict__ ox, int n_iter,
             float* __restrict__ out) {
  __shared__ PacketShared s;
  const Geo g = geometry();
  const float x = ox[g.lane];
  if (g.tid < kFloorSlots) s.stack[g.tid] = 0;
  if (g.tid == 0) init_mbarriers(s);
  cg::this_cluster().sync();  // the stacks zeroed, every peer's mbarriers set
  float acc = 0.f;
  uint32_t nrec = 0;  // records published
  int it = 0;
  while (it < n_iter) {
    if (g.tid == 0) s.stack[it % kFloorSlots] = it;
    const int node = s.stack[(it * 7 + 3) % kFloorSlots];
    if (kLoad) {
      // the reference's address: block of node % 17000, lane of node
      const int addr = ((node % kFloorWrap) / 128) * 128 + node % 128;
      const NodeRec n = visit_record(nodes, addr, false, s, g, nrec);
      if (kSlab) {
        const float t0 = n.a.x - x, t1 = n.a.w - x;
        it += cluster_any(fminf(t0, t1) < fmaxf(t0, t1) * 0.9f, s, g, it) * 0;
      } else {
        acc = acc + n.a.x;
      }
    }
    if (!kSlab) __syncthreads();
    it += 1;
  }
  out[g.lane] = acc + (float)it;
  cg::this_cluster().sync();  // no block leaves while a peer may still write to it
}

// Cycles (clock64) of `reps` steps of `step`, a chain: each step waits for
// the one before.
template <class Step>
__device__ __forceinline__ long long chain_cycles(int reps, Step step) {
  const long long t0 = clock64();
#pragma unroll 4
  for (int i = 0; i < reps; ++i) step(i);
  return clock64() - t0;
}

// The pieces of a floor iteration, each timed alone as a chain of `reps`
// steps by thread 0 of rank 0 (chain_cycles) in one cluster of the floor's
// geometry. A measurement probe, not a port: it has no plain version.
// out[k], the cycles of piece k (kernel_lab.FLOOR_PIECES), written as each
// is timed:
// 0 st_bar: thread 0 writes a stack slot, then __syncthreads;
// 1 bar: __syncthreads alone;
// 2 ld: thread 0's dependent shared loads (a 32-slot cycle);
// 3 ldg: thread 0's dependent record loads at the floor's first `reps`
//   addresses (the next waits for the last value), L2 hits where the
//   floor has run;
// 4 pub_bar: the publication of a record (publish), then __syncthreads;
// 5 pub_vote: the publication, then cluster_any on the record;
// 6 or: __syncthreads_or alone;
// 7 xchg: vote_exchange alone, on warp 0 of every block (on every thread,
//   with no block OR between votes, a fast warp could complete an
//   mbarrier's next phase before a slow one saw the last);
// 8 vote: cluster_any (the block OR, then the exchange).
// out[9] = 0, the dependences' sum (`zero` is 0: it keeps each chain
// dependent without changing an address).
__global__ void __launch_bounds__(kBlockThreads)
floor_cycles_kernel(const float4* __restrict__ nodes, int reps, int zero,
                    long long* __restrict__ out) {
  __shared__ PacketShared s;
  const Geo g = geometry();
  if (g.tid == 0) init_mbarriers(s);
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  const bool timer = g.rank == 0 && g.tid == 0;
  int dep = 0;
  uint32_t nrec = 0;
  float r = 0.f;
  // thread 0's record i, made to depend on the last one read (r)
  auto rec_i = [&](int i) {
    const float a = __int_as_float(i + (__float_as_int(r) & zero));
    return NodeRec{make_float4(a, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
  };
  long long c = chain_cycles(reps, [&](int i) {
    if (g.tid == 0) s.stack[i % kFloorSlots] = i;
    __syncthreads();
  });
  if (timer) out[0] = c;
  c = chain_cycles(reps, [&](int) { __syncthreads(); });
  if (timer) out[1] = c;
  if (g.tid == 0) {
    for (int i = 0; i < kFloorSlots; ++i) s.stack[i] = (i + 1) % kFloorSlots;
    const volatile int* st = s.stack;
    int k = 0;
    c = chain_cycles(reps, [&](int) { k = st[k]; });
    if (timer) out[2] = c;
    float x = 0.f;
    c = chain_cycles(reps, [&](int i) {
      int node = i - ((i - (7 * i + 3) % kFloorSlots) & (kFloorSlots - 1));  // floor_nodes
      node = max(node, 0);
      const int addr = ((node % kFloorWrap) / 128) * 128 + node % 128;
      x = __ldg(nodes + 2 * (size_t)(addr + (__float_as_int(x) & zero))).x;
    });
    if (timer) out[3] = c;
    dep += (k & zero) + (__float_as_int(x) & zero);
  }
  __syncthreads();
  c = chain_cycles(reps, [&](int i) {
    r = publish(s, g, nrec, [&] { return rec_i(i); }).a.x;
    __syncthreads();
  });
  if (timer) out[4] = c;
  c = chain_cycles(reps, [&](int i) { dep += __syncthreads_or((g.lane + i) & 1) & zero; });
  if (timer) out[6] = c;
  cl.sync();
  if (g.tid < 32) {
    c = chain_cycles(reps, [&](int i) {
      __syncwarp();  // the warp's reads of a slot set before its next bit goes out
      dep += vote_exchange((g.lane + i) & 1, s, g, i) & zero;  // votes 0..reps-1
    });
    if (timer) out[7] = c;
  }
  cl.sync();
  c = chain_cycles(reps,
                   [&](int i) { dep += cluster_any((g.lane + i) & 1, s, g, reps + i) & zero; });
  if (timer) out[8] = c;
  c = chain_cycles(reps, [&](int i) {
    r = publish(s, g, nrec, [&] { return rec_i(i); }).a.x;
    dep += cluster_any(r < 0.f, s, g, 2 * reps + i) & zero;
  });
  if (timer) out[5] = c;
  dep += __float_as_int(r) & zero;
  if (timer) out[9] = dep;
  cl.sync();  // no block leaves while a peer may still write to it
}

// A packet's launch geometry is usable: `cluster` blocks of `threads`
// threads, one lane each, hold the packet's rows*128 lanes.
bool geometry_ok(int rows, int cluster, int threads) {
  return (cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8) && threads >= 32 &&
         threads <= kBlockThreads && threads % 32 == 0 && cluster * threads == rows * 128;
}

// Launches n_packets clusters of `cluster` blocks -> cudaError_t of the
// launch, else of cudaGetLastError.
template <typename... Params, typename... Args>
int launch_clusters(void (*kernel)(Params...), int n_packets, int cluster, int threads,
                    cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_packets * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

}  // namespace

// rows in {1, 2, 4, 8, 16, 32}, 1 <= k_pop <= 4; a packet is a cluster of
// `cluster` blocks of `threads` threads, one lane each
// (tools/kernel_lab.py::launch_geometry); o, d (n_packets*rows*128, 3)
// padded as the reference pads; outputs the same number of lanes;
// *overflow zeroed by the caller.
extern "C" int lab_traverse(const void* nodes, const void* tris, const void* o,
                            const void* d, const void* t_max, int n_packets, int rows,
                            int cluster, int threads, int k_pop, int leaf, int vec, int count,
                            void* t_out, void* prim_out, void* cnt_out, void* cnt2_out,
                            void* overflow, void* stream) {
  if (n_packets <= 0) return 0;
  if (!geometry_ok(rows, cluster, threads) || k_pop < 1 || k_pop > kMaxPop)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* kernel = leaf ? &lab_kernel<true> : &lab_kernel<false>;
  return launch_clusters(kernel, n_packets, cluster, threads, static_cast<cudaStream_t>(stream),
                         static_cast<const float4*>(nodes), static_cast<const float*>(tris),
                         static_cast<const float*>(o), static_cast<const float*>(d),
                         static_cast<const float*>(t_max), k_pop, vec, count,
                         static_cast<float*>(t_out), static_cast<int*>(prim_out),
                         static_cast<int*>(cnt_out), static_cast<int*>(cnt2_out),
                         static_cast<int*>(overflow));
}

extern "C" int brless_traverse(const void* nodes, const void* tris, const void* o,
                               const void* d, const void* t_max, int n_packets, int rows,
                               int cluster, int threads, int n_tris, int leaf_when,
                               void* t_out, void* prim_out, void* cnt_out, void* cnt2_out,
                               void* overflow, void* stream) {
  if (n_packets <= 0) return 0;
  if (!geometry_ok(rows, cluster, threads)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_clusters(brless_kernel, n_packets, cluster, threads,
                         static_cast<cudaStream_t>(stream), static_cast<const float4*>(nodes),
                         static_cast<const float*>(tris), static_cast<const float*>(o),
                         static_cast<const float*>(d), static_cast<const float*>(t_max), n_tris,
                         leaf_when, static_cast<float*>(t_out), static_cast<int*>(prim_out),
                         static_cast<int*>(cnt_out), static_cast<int*>(cnt2_out),
                         static_cast<int*>(overflow));
}

// One packet: a cluster of `cluster` blocks of `threads` threads, one lane
// each (tools/kernel_lab.py::launch_geometry); ox holds at least rows*128
// floats, out rows*128.
extern "C" int floor_bench(const void* nodes, const void* ox, int rows, int cluster,
                           int threads, int n_iter, int with_load, int with_slab, void* out,
                           void* stream) {
  if (!geometry_ok(rows, cluster, threads)) return static_cast<int>(cudaErrorInvalidValue);
  auto* kernel = !with_load ? &floor_kernel<false, false>
                 : !with_slab ? &floor_kernel<true, false> : &floor_kernel<true, true>;
  return launch_clusters(kernel, 1, cluster, threads, static_cast<cudaStream_t>(stream),
                         static_cast<const float4*>(nodes), static_cast<const float*>(ox),
                         n_iter, static_cast<float*>(out));
}

// floor_cycles_kernel in one cluster of the floor's geometry; out (10,) int64.
extern "C" int floor_cycles(const void* nodes, int rows, int cluster, int threads, int reps,
                            void* out, void* stream) {
  if (!geometry_ok(rows, cluster, threads) || reps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_clusters(floor_cycles_kernel, 1, cluster, threads,
                         static_cast<cudaStream_t>(stream), static_cast<const float4*>(nodes),
                         reps, 0, static_cast<long long*>(out));
}
