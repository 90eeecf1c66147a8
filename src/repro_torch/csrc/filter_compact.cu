// Stable stream compaction of fixed-width rows under a bool mask.
//
// Replaces the TPU kernel filter_project.filter_compact (_fp_kernel,
// src/repro/kernels/filter_project/filter_project.py), which compacts each
// tile with a one-hot permutation matmul on the MXU and stitches tiles by
// an exclusive scan of their counts.  In the port it runs on the artifact
// store's write path (Table.host_compact), so only surviving rows cross
// to the host.
//
// What bounds it on an H100: bytes.  A w-byte row is read once, the mask
// is read twice (count, then scatter) and every output row written once:
// about (2w + 2) bytes per row, no arithmetic to speak of.
//
// Design, in launches that allocate nothing.  The block offsets depend
// only on the mask, so a table's columns share them:
//   restore_compact_offsets, once per mask:
//     1. count:   one thread per row; each warp counts its survivors with
//                 __ballot_sync/__popc, the block sums its 32 warp counts;
//     2. scan:    one block takes the exclusive scan of the block counts
//                 and the total (the block counts are 1/1024 of the rows);
//   restore_compact_scatter, once per column:
//     3. scatter: each block recomputes its ballots, so a survivor's slot
//                 is block offset + warp offset + popc of the lower lanes:
//                 stable by construction.  Rows at or past the total are
//                 zeroed in the same pass, so the tail needs no memset.
// Rows of any byte width are copied as 32-bit words when the width and
// both pointers allow it, and byte by byte otherwise.
#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int BLOCK = 1024;
constexpr int WARPS = BLOCK / 32;

__device__ __forceinline__ void copy_row(const uint8_t* __restrict__ src,
                                         uint8_t* __restrict__ dst,
                                         long long from, long long to,
                                         int w, bool words) {
  if (words) {
    const int nw = w >> 2;
    const uint32_t* s = reinterpret_cast<const uint32_t*>(src) + from * nw;
    uint32_t* d = reinterpret_cast<uint32_t*>(dst) + to * nw;
    for (int k = 0; k < nw; ++k) d[k] = s[k];
  } else {
    const uint8_t* s = src + from * w;
    uint8_t* d = dst + to * w;
    for (int k = 0; k < w; ++k) d[k] = s[k];
  }
}

__device__ __forceinline__ void zero_row(uint8_t* __restrict__ dst,
                                         long long row, int w, bool words) {
  if (words) {
    const int nw = w >> 2;
    uint32_t* d = reinterpret_cast<uint32_t*>(dst) + row * nw;
    for (int k = 0; k < nw; ++k) d[k] = 0u;
  } else {
    uint8_t* d = dst + row * w;
    for (int k = 0; k < w; ++k) d[k] = 0;
  }
}

__global__ void __launch_bounds__(BLOCK)
count_kernel(const uint8_t* __restrict__ mask, long long n,
             int* __restrict__ block_counts) {
  __shared__ int wc[WARPS];
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  const bool keep = i < n && mask[i] != 0;
  const unsigned ballot = __ballot_sync(0xffffffffu, keep);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) wc[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    int c = wc[lane];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      c += __shfl_down_sync(0xffffffffu, c, off);
    if (lane == 0) block_counts[blockIdx.x] = c;
  }
}

// One block: exclusive scan of nb block counts -> offsets, and the total.
__global__ void __launch_bounds__(BLOCK)
scan_kernel(const int* __restrict__ block_counts, int nb,
            int* __restrict__ offsets, int* __restrict__ total) {
  __shared__ int wsum[WARPS];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int per = (nb + BLOCK - 1) / BLOCK;
  const int lo = min(t * per, nb);
  const int hi = min(lo + per, nb);
  int local = 0;
  for (int k = lo; k < hi; ++k) local += block_counts[k];
  // inclusive scan of the per-thread sums across the block
  int v = local;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int x = wsum[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += u;
    }
    wsum[lane] = x;
  }
  __syncthreads();
  int run = v - local + (warp > 0 ? wsum[warp - 1] : 0);  // exclusive
  for (int k = lo; k < hi; ++k) {
    offsets[k] = run;
    run += block_counts[k];
  }
  if (t == BLOCK - 1) *total = wsum[WARPS - 1];
}

__global__ void __launch_bounds__(BLOCK)
scatter_kernel(const uint8_t* __restrict__ src,
               const uint8_t* __restrict__ mask, long long n, int w,
               bool words, const int* __restrict__ offsets,
               const int* __restrict__ total, uint8_t* __restrict__ dst) {
  __shared__ int wc[WARPS];
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  const bool live = i < n;
  const bool keep = live && mask[i] != 0;
  const unsigned ballot = __ballot_sync(0xffffffffu, keep);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) wc[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    int x = wc[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += u;
    }
    wc[lane] = x;  // inclusive per-warp prefix
  }
  __syncthreads();
  if (keep) {
    const unsigned lower = ballot & ((1u << lane) - 1u);
    const long long slot = (long long)offsets[blockIdx.x] +
                           (warp > 0 ? wc[warp - 1] : 0) + __popc(lower);
    copy_row(src, dst, i, slot, w, words);
  }
  if (live && i >= (long long)*total) zero_row(dst, i, w, words);
}

}  // namespace

// mask: n bytes (0/1).  block_counts and offsets hold ceil(n/1024) ints,
// total one int.  Launches on `stream`, allocates nothing; returns
// cudaGetLastError().
extern "C" int restore_compact_offsets(const void* mask, long long n,
                                       int* block_counts, int* offsets,
                                       int* total, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) {
    cudaMemsetAsync(total, 0, sizeof(int), s);
    return static_cast<int>(cudaGetLastError());
  }
  const int nb = (int)((n + BLOCK - 1) / BLOCK);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  count_kernel<<<nb, BLOCK, 0, s>>>(m, n, block_counts);
  scan_kernel<<<1, BLOCK, 0, s>>>(block_counts, nb, offsets, total);
  return static_cast<int>(cudaGetLastError());
}

// src/dst: n rows of w bytes; mask, offsets and total as left by
// restore_compact_offsets on the same mask.  Launches on `stream`,
// allocates nothing; returns cudaGetLastError().
extern "C" int restore_compact_scatter(const void* src, const void* mask,
                                       void* dst, long long n, int w,
                                       const int* offsets, const int* total,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int nb = (int)((n + BLOCK - 1) / BLOCK);
  const bool words = (w % 4 == 0) &&
                     (reinterpret_cast<uintptr_t>(src) % 4 == 0) &&
                     (reinterpret_cast<uintptr_t>(dst) % 4 == 0);
  scatter_kernel<<<nb, BLOCK, 0, s>>>(static_cast<const uint8_t*>(src),
                                      static_cast<const uint8_t*>(mask), n, w,
                                      words, offsets, total,
                                      static_cast<uint8_t*>(dst));
  return static_cast<int>(cudaGetLastError());
}
