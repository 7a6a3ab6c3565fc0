// Gradient of the per-lane material gather (scatter/material_grad.py): the
// rows of grad (R, C) summed onto the table rows their lane's material id
// names, out[m, :] = sum over lanes r with max(ids[r], 0) == m of
// grad[r, :]. A missed lane (id -1) adds onto row 0, as the gather clamps it.
//
// Replaces no TPU kernel: the JAX package leaves this scatter-add to XLA.
// It was added because PyTorch's backward of advanced indexing
// (index_put_ with accumulate, indexing_backward_kernel_small_stride) gives
// one warp to each distinct index and walks its duplicates one after
// another: with 3 materials over 921,600 lanes, 3 warps did the whole job on
// 132 SMs, ~0.2 s a bounce, ~63% of a joint_720p step on an H100 80GB
// HBM3 at 700 W (PERF.md, section 5).
//
// What bounds it: bytes. It reads grad and ids once, (R*C + R) * 4 bytes,
// 66.4 MB at the joint shape (921,600 x 17): ~20 us at 3.35 TB/s. The
// sums are a few adds a float.
//
// How the design meets that bound, deterministically:
// - pass 1: kBlocksPerSM persistent blocks a SM (the wrapper passes their
//   number, from its BLOCKS_PER_SM, which a test holds equal to
//   kBlocksPerSM); block b owns one contiguous range of lanes (a multiple
//   of 4) and streams it in tiles of L lanes through a ring of kStages shared
//   buffers filled by 16-byte cp.async copies (the ids by 4-byte ones), so
//   the next tiles are in flight while one is summed. Thread t owns column
//   c = t % C of lane group g = t / C (G = kThreads / C groups) and adds
//   lanes g, g + G, ... of each tile into its own shared slots acc[g][row][c]:
//   no two threads write one slot, so there are no atomics, and a warp's
//   threads read consecutive floats of the tile. The G groups are then added
//   in group order and the block writes its (rows, C) partial to
//   part[b, rows, :].
// - pass 2: one thread a table entry adds the blocks' partials in block
//   order.
// The result is bit-identical from call to call on one card and does not
// depend on how many lanes share a row. A table too large for one block's
// accumulators is cut into row tiles of Mt rows (grid dimension y); a block
// skips the lanes of other tiles. -fmad=false as every kernel here.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 3;
constexpr int kBlocksPerSM = 2;
constexpr int kStageBytes = 32768;  // grad and ids of one tile, about
constexpr int kAccBytes = 49152;    // the accumulators' budget a block

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// grad (R, C), ids (R,); lanes [b * chunk, (b + 1) * chunk) of the R; L lanes
// a tile (a multiple of 4); rows [y * Mt, y * Mt + Mt) of the M; part
// (gridDim.x, M, C).
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
partial_sums(const float* __restrict__ grad, const int* __restrict__ ids, int R, int C, int M,
             int Mt, long long chunk, int L, float* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = kThreads / C;
  const int acc_floats = (G * Mt * C + 3) & ~3;
  float* acc = reinterpret_cast<float*>(smem);
  float* tiles = acc + acc_floats;  // kStages x (L * C)
  int* tile_ids = reinterpret_cast<int*>(tiles + kStages * L * C);  // kStages x L

  const int t = threadIdx.x;
  const int b = blockIdx.x;
  const int m0 = blockIdx.y * Mt;
  const int rows = min(Mt, M - m0);
  const long long lo = min(static_cast<long long>(R), b * chunk);
  const long long hi = min(static_cast<long long>(R), lo + chunk);
  const int n_tiles = static_cast<int>((hi - lo + L - 1) / L);
  const int g = t / C;
  const int c = t - g * C;
  const bool worker = g < G;

  for (int k = t; k < acc_floats; k += kThreads) acc[k] = 0.f;

  auto load = [&](int i, int s) {
    const long long l0 = lo + static_cast<long long>(i) * L;
    const int nl = static_cast<int>(min(static_cast<long long>(L), hi - l0));
    const float* src = grad + l0 * C;  // 16-byte aligned: l0 % 4 == 0
    float* dst = tiles + s * L * C;
    const int nf = nl * C;
    const int n4 = nf >> 2;
    for (int k = t; k < n4; k += kThreads) cp_async16(dst + 4 * k, src + 4 * k);
    for (int k = 4 * n4 + t; k < nf; k += kThreads) cp_async4(dst + k, src + k);
    for (int k = t; k < nl; k += kThreads) cp_async4(tile_ids + s * L + k, ids + l0 + k);
  };

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load(s, s);
    cp_async_commit();
  }
  __syncthreads();  // acc zeroed
  for (int i = 0; i < n_tiles; ++i) {
    const int ahead = i + kStages - 1;
    if (ahead < n_tiles) load(ahead, ahead % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // this thread's copies of tile i have landed
    __syncthreads();               // and every thread's
    const int s = i % kStages;
    const int nl = static_cast<int>(min(static_cast<long long>(L),
                                        hi - lo - static_cast<long long>(i) * L));
    if (worker) {
      const float* tg = tiles + s * L * C;
      const int* ti = tile_ids + s * L;
      float* mine = acc + g * Mt * C + c;
      for (int l = g; l < nl; l += G) {
        const int r = max(ti[l], 0) - m0;
        if (r >= 0 && r < rows) mine[r * C] += tg[l * C + c];
      }
    }
    __syncthreads();  // stage s is refilled by the next iteration's load
  }
  cp_async_wait<0>();
  __syncthreads();

  for (int k = t; k < rows * C; k += kThreads) {
    const int m = k / C;
    const int cc = k - m * C;
    float sum = 0.f;
    for (int gg = 0; gg < G; ++gg) sum += acc[(gg * Mt + m) * C + cc];
    part[(static_cast<long long>(b) * M + m0 + m) * C + cc] = sum;
  }
}

// out (M * C) = the sum over b of part[b] (n_blocks x M * C), in block order.
__global__ void __launch_bounds__(kThreads)
block_sums(const float* __restrict__ part, int n_blocks, int MC, float* __restrict__ out) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= MC) return;
  float sum = 0.f;
  for (int b = 0; b < n_blocks; ++b) sum += part[static_cast<long long>(b) * MC + k];
  out[k] = sum;
}

}  // namespace

extern "C" {

// grad (R, C) float32 and ids (R,) int32, contiguous, grad 16-byte aligned;
// 1 <= C <= 256, M >= 1, n_blocks >= 1; part (n_blocks, M, C) and out (M, C)
// float32 scratch and output (every entry written). Returns the CUDA error
// of the launches (0 on success).
int material_grad(const float* grad, const int* ids, int R, int C, int M, int n_blocks,
                  float* part, float* out, cudaStream_t stream) {
  if (R < 0 || C < 1 || C > kThreads || M < 1 || n_blocks < 1) return cudaErrorInvalidValue;
  const int G = kThreads / C;
  const int Mt = std::min(M, kAccBytes / (G * C * 4));
  const int unit = 4 * G;  // L: a multiple of 4 lanes and of the groups
  const int L = std::max(unit, kStageBytes / ((C + 1) * 4) / unit * unit);
  long long chunk = (static_cast<long long>(R) + n_blocks - 1) / n_blocks;
  chunk = (chunk + 3) & ~3LL;
  const size_t acc_floats = (static_cast<size_t>(G) * Mt * C + 3) & ~static_cast<size_t>(3);
  const size_t smem = acc_floats * 4 + static_cast<size_t>(kStages) * L * (C + 1) * 4;
  // set on every call: the attribute holds for the current device alone
  cudaError_t err = cudaFuncSetAttribute(partial_sums, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(n_blocks, (M + Mt - 1) / Mt);
  partial_sums<<<grid, kThreads, smem, stream>>>(grad, ids, R, C, M, Mt, chunk, L, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int MC = M * C;
  block_sums<<<(MC + kThreads - 1) / kThreads, kThreads, 0, stream>>>(part, n_blocks, MC, out);
  return cudaGetLastError();
}

}  // extern "C"
