// Radix partitioning and the fused bucket scatter of the mesh exchange.
//
// Replaces the two TPU kernels of
// src/repro/kernels/radix_partition/radix_partition.py:
//   radix_partition   (_radix_kernel, :22-65): pid = h & (P-1), invalid
//                     rows parked at P, and a histogram of valid rows per
//                     tile_n-row tile, the one-hot summed on the MXU;
//   partition_scatter (_scatter_kernel, :68-131): slot = pid*bucket + the
//                     row's arrival rank among earlier valid rows bound for
//                     the same partition, with the per-destination running
//                     counts carried in VMEM across the TPU's sequential
//                     grid; ranks at or past `bucket` and invalid rows get
//                     the drop slot P*bucket, and the overflow is counted.
// In the port partition_scatter is the map side of every exchange
// (dataflow/shuffle.py::_exchange); radix_partition is its pass 1.
//
// What bounds them on an H100: bytes.  partition_scatter reads a hash and
// a valid byte and writes a 4-byte slot per row, 9 B per row at the
// reference's uint32 widths (the port's int64 hash carrier makes it 13 B);
// the per-tile histograms are P ints per tile.  The arithmetic is a few
// integer operations per row.
//
// Design.  Blocks run in parallel and in no order, so nothing can carry
// running counts from tile to tile as the TPU's grid does.  The rank is
// the global, stable arrival rank, so there are no atomics on ranks; the
// work goes in three passes, each ONE launch for all segments (a mesh
// exchange ranks every shard's rows at once, each shard its own segment):
//   1. hist_kernel, one block per (segment, tile): pid of each row, and
//      the tile's histogram in shared memory.  __match_any_sync groups the
//      lanes of a warp bound for one partition, and the lowest of them
//      adds the group's popcount: one shared atomic per distinct pid per
//      warp, exact in any order.
//   2. scan_kernel, one block per (segment, partition): the exclusive scan
//      of that partition's column over the segment's tiles, in place, so
//      each tile's counts become the ranks its first rows start from.  The
//      column total gives the overflow, sum over p of max(0, total - bucket).
//   3. slot_kernel, one block per (segment, tile): the tile's bases in
//      shared memory; each round of 256 rows ranks a row by the lanes below
//      it in its __match_any_sync group, and the warps take their turn in
//      row order to read and advance the running counts.
// tile_n sets pass 1's histogram (radix_partition returns it) and never
// changes a slot.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int BLOCK = 256;
constexpr int WARPS = BLOCK / 32;
constexpr int SCAN_BLOCK = 1024;
constexpr int SCAN_WARPS = SCAN_BLOCK / 32;
constexpr unsigned FULL = 0xffffffffu;

// The partition of one row: h & (P-1) for a valid row, P for an invalid
// one, P+1 for a lane past the tile (never counted).
__device__ __forceinline__ int row_pid(const long long* __restrict__ h,
                                       const uint8_t* __restrict__ valid,
                                       long long row, bool live,
                                       int n_parts) {
  if (!live) return n_parts + 1;
  if (!valid[row]) return n_parts;
  return (int)((unsigned long long)h[row] & (unsigned)(n_parts - 1));
}

__global__ void __launch_bounds__(BLOCK)
hist_kernel(const long long* __restrict__ h,
            const uint8_t* __restrict__ valid, long long n, int n_tiles,
            int tile_n, int n_parts, int* __restrict__ pid_out,
            int* __restrict__ hist) {
  extern __shared__ int cnt[];
  const int seg = blockIdx.x / n_tiles;
  const int tile = blockIdx.x - seg * n_tiles;
  for (int p = threadIdx.x; p < n_parts; p += BLOCK) cnt[p] = 0;
  __syncthreads();
  const long long start = (long long)tile * tile_n;
  const int len = (int)min((long long)tile_n, n - start);
  const long long base = (long long)seg * n + start;
  const int lane = threadIdx.x & 31;
  for (int r0 = 0; r0 < len; r0 += BLOCK) {   // block-uniform trip count
    const int r = r0 + threadIdx.x;
    const bool live = r < len;
    const int pid = row_pid(h, valid, base + r, live, n_parts);
    if (live && pid_out != nullptr) pid_out[base + r] = pid;
    const unsigned m = __match_any_sync(FULL, pid);
    if (pid < n_parts && __ffs(m) - 1 == lane)
      atomicAdd(&cnt[pid], __popc(m));
  }
  __syncthreads();
  int* out = hist + (long long)blockIdx.x * n_parts;
  for (int p = threadIdx.x; p < n_parts; p += BLOCK) out[p] = cnt[p];
}

__global__ void __launch_bounds__(SCAN_BLOCK)
scan_kernel(int* __restrict__ hist, int n_tiles, int n_parts, int bucket,
            int* __restrict__ ovf) {
  __shared__ int wsum[SCAN_WARPS];
  const int seg = blockIdx.x / n_parts;
  const int p = blockIdx.x - seg * n_parts;
  int* col = hist + (long long)seg * n_tiles * n_parts + p;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int per = (n_tiles + SCAN_BLOCK - 1) / SCAN_BLOCK;
  const int lo = min(t * per, n_tiles);
  const int hi = min(lo + per, n_tiles);
  int local = 0;
  for (int k = lo; k < hi; ++k) local += col[(long long)k * n_parts];
  int v = local;                                // inclusive warp scan
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(FULL, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int x = wsum[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(FULL, x, off);
      if (lane >= off) x += u;
    }
    wsum[lane] = x;
  }
  __syncthreads();
  int run = v - local + (warp > 0 ? wsum[warp - 1] : 0);   // exclusive
  for (int k = lo; k < hi; ++k) {
    const int c = col[(long long)k * n_parts];
    col[(long long)k * n_parts] = run;
    run += c;
  }
  if (t == 0) {
    const int total = wsum[SCAN_WARPS - 1];
    if (total > bucket) atomicAdd(&ovf[seg], total - bucket);
  }
}

__global__ void __launch_bounds__(BLOCK)
slot_kernel(const long long* __restrict__ h,
            const uint8_t* __restrict__ valid, long long n, int n_tiles,
            int tile_n, int n_parts, int bucket,
            const int* __restrict__ bases, int* __restrict__ slot) {
  extern __shared__ int run[];
  const int seg = blockIdx.x / n_tiles;
  const int tile = blockIdx.x - seg * n_tiles;
  const int* b = bases + (long long)blockIdx.x * n_parts;
  for (int p = threadIdx.x; p < n_parts; p += BLOCK) run[p] = b[p];
  __syncthreads();
  const long long start = (long long)tile * tile_n;
  const int len = (int)min((long long)tile_n, n - start);
  const long long base = (long long)seg * n + start;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int drop = n_parts * bucket;
  for (int r0 = 0; r0 < len; r0 += BLOCK) {   // block-uniform trip count
    const int r = r0 + threadIdx.x;
    const bool live = r < len;
    const int pid = row_pid(h, valid, base + r, live, n_parts);
    const unsigned m = __match_any_sync(FULL, pid);
    const int lower = __popc(m & below);
    // the warps of a round hold consecutive rows: each reads the running
    // counts, then its group leaders advance them, in row order
    for (int w = 0; w < WARPS; ++w) {
      if (warp == w) {
        const int rank = pid < n_parts ? run[pid] + lower : 0;
        __syncwarp();
        if (pid < n_parts && lower == 0) run[pid] += __popc(m);
        if (live)
          slot[base + r] = (pid < n_parts && rank < bucket)
                               ? pid * bucket + rank : drop;
      }
      __syncthreads();
    }
  }
}

}  // namespace

// h: n_segs * n int64 hash lanes (uint32 values), valid: as many bytes;
// segment s is rows [s*n, (s+1)*n).  pid: as many ints, or null; hist:
// n_segs * ceil(n/tile_n) * n_parts ints.  n_parts a power of two.
// Launches on `stream`, allocates nothing; returns cudaGetLastError().
extern "C" int restore_radix_partition(const void* h, const void* valid,
                                       int* pid, int* hist, long long n,
                                       int n_segs, int tile_n, int n_parts,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || n_segs <= 0) return static_cast<int>(cudaGetLastError());
  const int n_tiles = (int)((n + tile_n - 1) / tile_n);
  const unsigned blocks = (unsigned)((long long)n_tiles * n_segs);
  hist_kernel<<<blocks, BLOCK, n_parts * sizeof(int), s>>>(
      static_cast<const long long*>(h), static_cast<const uint8_t*>(valid),
      n, n_tiles, tile_n, n_parts, pid, hist);
  return static_cast<int>(cudaGetLastError());
}

// As above; slot: n_segs * n ints, ovf: n_segs ints, scratch: n_segs *
// ceil(n/tile_n) * n_parts ints.  n_parts * bucket must fit in an int.
extern "C" int restore_partition_scatter(const void* h, const void* valid,
                                         int* slot, int* ovf, int* scratch,
                                         long long n, int n_segs,
                                         int tile_n, int n_parts,
                                         int bucket, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_segs <= 0) return static_cast<int>(cudaGetLastError());
  cudaMemsetAsync(ovf, 0, sizeof(int) * n_segs, s);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int n_tiles = (int)((n + tile_n - 1) / tile_n);
  const unsigned blocks = (unsigned)((long long)n_tiles * n_segs);
  const long long* hh = static_cast<const long long*>(h);
  const uint8_t* vv = static_cast<const uint8_t*>(valid);
  const size_t smem = n_parts * sizeof(int);
  hist_kernel<<<blocks, BLOCK, smem, s>>>(hh, vv, n, n_tiles, tile_n,
                                          n_parts, nullptr, scratch);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  scan_kernel<<<(unsigned)(n_segs * n_parts), SCAN_BLOCK, 0, s>>>(
      scratch, n_tiles, n_parts, bucket, ovf);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  slot_kernel<<<blocks, BLOCK, smem, s>>>(hh, vv, n, n_tiles, tile_n,
                                          n_parts, bucket, scratch, slot);
  return static_cast<int>(cudaGetLastError());
}
