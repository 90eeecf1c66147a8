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
// (dataflow/shuffle.py::_exchange); radix_partition is on no path.
//
// What bounds them on an H100: bytes.  Each row's 8-byte hash carrier
// (uint32 values in int64) and valid byte are read once, and a 4-byte
// slot or pid is written: 13 B a row (9 B at the reference's uint32
// widths), plus P ints a tile of histogram or status words.  The
// arithmetic is a few integer operations and warp votes a row.
//
// Both kernels read each row once and share the loader and the counting
// (load_pids, vote):
//   * Rows lie striped over the lanes of a warp: round j of a warp takes
//     32 consecutive rows, one a lane.  A lane loads the low word of its
//     row's carrier (the warp's request spans 256 fully used bytes) and
//     its valid byte (one 32-byte sector a warp), and stores its slot or
//     pid (one 128-byte line a warp), with no alignment cases and the
//     ragged tail masked per lane.  A warp issues the loads of all its
//     rounds before it ranks any row.
//   * A round is ranked by votes: log2(P) ballots of the pid's bits and
//     one of the valid rows give every lane the lanes bound for its own
//     partition (`same`), so its rank in the round is popc(same & lanes
//     below), with no __match_any_sync and no shared atomics.  For P <= 32
//     lane p keeps the warp's running count of partition p in a register
//     (read with one shuffle, advanced by popc of the lanes bound for p);
//     above 32 partitions the counts are 16-bit words in shared memory,
//     advanced by the lowest lane of each group (correct, not tuned).
//
// partition_scatter, one pass (scatter_kernel): a tile is 8 warps x 16
// rounds x 32 rows = 4096 consecutive rows of one segment, one tile a
// block.  Each warp ranks its 512 rows into a stash in shared memory; an
// exclusive scan of the warps' counts per partition gives each warp its
// offset in the tile and the tile its counts.  The tiles of a segment are
// chained by a decoupled look-back: a block takes its tile from an atomic
// ticket (so it never waits on a tile that has not started; ticket t is
// tile t / S of segment t % S, so the segments' chains advance side by
// side), publishes its P counts as 32-bit status words (a 2-bit flag over
// a 30-bit count: the tile's count, then its inclusive prefix, both
// written by one thread so the prefix lands last), and a warp per group
// of 8 partitions reads the group's words of 32 predecessors a step (one
// sector a lane) until it meets each partition's inclusive prefix.  A
// row's rank is the tile's prefix + the warp's offset + its rank in the
// warp; the counts are exact, so the slots do not depend on the order the
// blocks run in.  The last tile of a segment writes its overflow, sum
// over p of max(0, total_p - bucket).  The status words are zeroed by one
// memset.  A two-pass form (pids stored as bytes, a scan over tile
// counts, a second pass over the bytes) would move 15-16 B a row; the
// look-back keeps 13.  What holds it back on an H100 (PERF.md): the
// look-back's round trip to L2, under a saturated stream, lengthens each
// block's life, so the kernel stays above a pass that streams the same
// bytes (bench.py).  A look-back warp of its own, and persistent blocks
// that load the next tile during the look-back, were slower.
//
// radix_partition (radix_kernel): a warp takes a chunk of whole tile_n
// tiles (at least 512 rows) when tile_n is a multiple of 32 and at most
// 4096, and stores each tile's counts; otherwise chunks of 512 rows add
// their partial counts into a zeroed histogram with global atomics.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int WARPS = 8;
constexpr int BLOCK = WARPS * 32;
constexpr int ROUNDS = 16;                 // rounds of 32 rows a scatter warp
constexpr int WARP_ROWS = ROUNDS * 32;     // 512
constexpr int TILE = WARPS * WARP_ROWS;    // 4096 rows a scatter tile
constexpr int HIST_CHUNK = 512;            // least rows a radix warp takes
constexpr int HIST_ROUNDS = 8;             // rounds a radix warp loads at once
constexpr int SMALL_PARTS = 32;            // counted in lane registers
constexpr int GROUP = 8;                   // partitions a look-back warp takes
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned FLAG_AGG = 1u << 30;    // status word: the tile's count
constexpr unsigned FLAG_INCL = 2u << 30;   // ... or its inclusive prefix
constexpr unsigned COUNT = FLAG_AGG - 1;
constexpr long long MAX_SPINS = 1ll << 24; // then trap: the launch fails
constexpr int DEFAULT_SMEM = 48 * 1024;

__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void ld_relaxed4(const unsigned* p,
                                            unsigned* v) {
  asm volatile("ld.relaxed.gpu.global.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
               : "l"(p) : "memory");
}

__device__ __forceinline__ void st_relaxed(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// The pids of a warp's R rounds starting at row `first`, lane `lane`
// holding rows first + 32 j + lane: h & (P-1) for a valid row, P for an
// invalid one, P+1 for a row at or past `left` rows (never counted).
// Only the low word of each int64 lane is loaded (P <= 8192 needs 13
// bits); every load is issued before any pid is formed.
template <int R>
__device__ __forceinline__ void load_pids(const long long* __restrict__ h,
                                          const uint8_t* __restrict__ valid,
                                          long long first, int left,
                                          int n_parts, int lane,
                                          int (&pid)[R]) {
  const unsigned* lo = reinterpret_cast<const unsigned*>(h);
  unsigned hv[R];
  uint8_t vv[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int r = 32 * j + lane;
    hv[j] = 0;
    vv[j] = 2;   // past the rows
    if (r < left) {
      hv[j] = __ldg(lo + 2 * (first + r));   // little-endian low word
      vv[j] = __ldg(valid + first + r);
    }
  }
#pragma unroll
  for (int j = 0; j < R; ++j)
    pid[j] = vv[j] == 2 ? n_parts + 1
             : vv[j] ? (int)(hv[j] & (unsigned)(n_parts - 1))
                     : n_parts;
}

struct Vote {
  unsigned same;   // lanes with a valid row of my row's partition
  unsigned mine;   // (SMALL) lanes with a valid row of partition `lane`
};

template <bool SMALL>
__device__ __forceinline__ Vote vote(int pid, int n_parts, int nbits,
                                     int lane) {
  const bool ok = pid < n_parts;
  const unsigned any = __ballot_sync(FULL, ok);
  Vote v{ok ? any : 0u, SMALL && lane < n_parts ? any : 0u};
  for (int k = 0; k < nbits; ++k) {   // warp-uniform trip count
    const unsigned b = __ballot_sync(FULL, (pid >> k) & 1);
    v.same &= (pid >> k) & 1 ? b : ~b;
    if (SMALL) v.mine &= (lane >> k) & 1 ? b : ~b;
  }
  return v;
}

// Sum over the warp, every lane gets it.
__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// Lane 0 gets in excl[q] the exclusive prefix at tile `tile` (> 0) of
// partition g + q, q < min(P - g, GROUP), from a segment's status words
// `st` (P a tile): lane l reads tile top - l's words of the group, so a
// step reads 32 tiles, and reads them again only while a tile before a
// partition's first inclusive prefix has not published its count.
__device__ __noinline__ void look_back(const unsigned* st, int tile,
                                      int n_parts, int g, int lane,
                                      int* excl) {
  const int nq = min(n_parts - g, GROUP);
  int sum[GROUP];
#pragma unroll
  for (int q = 0; q < GROUP; ++q) sum[q] = 0;
  unsigned done = ~((1u << nq) - 1u) & ((1u << GROUP) - 1u);
  long long spins = 0;
  for (int top = tile - 1;; top -= 32) {
    const int i = top - lane;
    const unsigned* src = st + (long long)i * n_parts + g;
    unsigned w[GROUP];
    for (;;) {
      if (i < 0) {
#pragma unroll
        for (int q = 0; q < GROUP; ++q) w[q] = FLAG_INCL;   // before tile 0
      } else if (nq == GROUP) {
        ld_relaxed4(src, w);
        ld_relaxed4(src + 4, w + 4);
      } else {
#pragma unroll
        for (int q = 0; q < GROUP; ++q)
          w[q] = q < nq ? ld_relaxed(src + q) : FLAG_INCL;
      }
      bool again = false;
#pragma unroll
      for (int q = 0; q < GROUP; ++q) {
        const unsigned incl = __ballot_sync(FULL, w[q] & FLAG_INCL);
        const unsigned unset = __ballot_sync(FULL, (w[q] & ~COUNT) == 0);
        const unsigned before = incl ? (incl & (0u - incl)) - 1u : FULL;
        again |= !((done >> q) & 1u) && (unset & before);
      }
      if (!again) break;
      if (++spins > MAX_SPINS) __trap();
    }
#pragma unroll
    for (int q = 0; q < GROUP; ++q) {
      if ((done >> q) & 1u) continue;
      const unsigned incl = __ballot_sync(FULL, w[q] & FLAG_INCL);
      const int stop = incl ? __ffs(incl) - 1 : 31;
      sum[q] += warp_sum(lane <= stop ? (int)(w[q] & COUNT) : 0);
      if (incl) done |= 1u << q;
    }
    if (done == (1u << GROUP) - 1u) break;
  }
  if (lane == 0)
#pragma unroll
    for (int q = 0; q < GROUP; ++q)
      if (q < nq) excl[q] = sum[q];
}

// One tile of one segment per block, the tile from the ticket.  Shared
// memory: the stash (each row's pid | rank in its warp << 16, TILE ints,
// lane-minor), base (P ints: the tile's counts, then its exclusive
// prefix) and the warps' counts (WARPS x P 16-bit words: totals, then
// exclusive offsets in the tile).
template <bool SMALL>
__global__ void __launch_bounds__(BLOCK, 5)
scatter_kernel(const long long* __restrict__ h,
               const uint8_t* __restrict__ valid, int n, int n_tiles,
               int n_segs, int n_parts, int nbits, int bucket,
               unsigned* status, unsigned* ticket, int* __restrict__ slot,
               int* __restrict__ ovf) {
  extern __shared__ int smem[];
  int* stash = smem;
  int* base = smem + TILE;
  unsigned short* woff = reinterpret_cast<unsigned short*>(base + n_parts);
  __shared__ int s_ticket, s_ovf;
  __shared__ int s_excl[WARPS][GROUP];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    s_ticket = (int)atomicAdd(ticket, 1u);
    s_ovf = 0;
  }
  if constexpr (!SMALL)
    for (int i = threadIdx.x; i < WARPS * n_parts; i += BLOCK) woff[i] = 0;
  __syncthreads();
  const int tile = s_ticket / n_segs;
  const int seg = s_ticket - tile * n_segs;
  const int w0 = tile * TILE + warp * WARP_ROWS;   // in the segment
  unsigned short* wo = woff + warp * n_parts;
  int* ws = stash + warp * WARP_ROWS + lane;

  // ranks in the warp, into the stash
  int pk[ROUNDS];
  load_pids(h + (long long)seg * n, valid + (long long)seg * n, w0, n - w0,
            n_parts, lane, pk);
  const unsigned below = (1u << lane) - 1u;
  int cnt = 0;   // SMALL: this warp's running count of partition `lane`
#pragma unroll
  for (int j = 0; j < ROUNDS; ++j) {
    const int pid = pk[j];
    const Vote v = vote<SMALL>(pid, n_parts, nbits, lane);
    int before;
    if constexpr (SMALL) {
      before = __shfl_sync(FULL, cnt, pid & 31);
      cnt += __popc(v.mine);
    } else {
      before = pid < n_parts ? wo[pid] : 0;
      __syncwarp();
      if (v.same && (v.same & below) == 0) wo[pid] = before + __popc(v.same);
      __syncwarp();
    }
    ws[32 * j] = pid | (before + __popc(v.same & below)) << 16;
  }
  if constexpr (SMALL)
    if (lane < n_parts) wo[lane] = cnt;
  __syncthreads();

  // exclusive scan of the warps' counts per partition; the tile's counts
  for (int p = threadIdx.x; p < n_parts; p += BLOCK) {
    int run = 0;
    for (int w = 0; w < WARPS; ++w) {
      const int c = woff[w * n_parts + p];
      woff[w * n_parts + p] = (unsigned short)run;
      run += c;
    }
    base[p] = run;
  }
  __syncthreads();

  // the chained scan: lane 0 of warp w publishes the counts of groups w,
  // w + WARPS, ... of GROUP partitions, the warp looks back, and lane 0
  // publishes their inclusive prefixes
  unsigned* st = status + (long long)seg * n_tiles * n_parts;
  unsigned* mine = st + (long long)tile * n_parts;
  for (int g = warp * GROUP; g < n_parts; g += WARPS * GROUP) {
    const int end = min(g + GROUP, n_parts);
    if (lane == 0)
      for (int p = g; p < end; ++p)
        st_relaxed(mine + p, (tile == 0 ? FLAG_INCL : FLAG_AGG) | base[p]);
    if (tile > 0) look_back(st, tile, n_parts, g, lane, s_excl[warp]);
    if (lane == 0)
      for (int p = g; p < end; ++p) {
        const int excl = tile > 0 ? s_excl[warp][p - g] : 0;
        const int all = excl + base[p];
        if (tile > 0) st_relaxed(mine + p, FLAG_INCL | all);
        if (tile == n_tiles - 1 && all > bucket)
          atomicAdd(&s_ovf, all - bucket);
        base[p] = excl;
      }
  }
  __syncthreads();
  if (tile == n_tiles - 1 && threadIdx.x == 0) ovf[seg] = s_ovf;

  // the slots: rank = the tile's prefix + the warp's offset + the rank in
  // the warp; the drop slot past the bucket
  const int drop = n_parts * bucket;
  const int left = n - w0;
  int* out = slot + (long long)seg * n + w0;
#pragma unroll
  for (int j = 0; j < ROUNDS; ++j) {
    const int r = 32 * j + lane;
    if (r < left) {
      const int x = ws[32 * j];
      const int pid = x & 0xffff;
      int s = drop;
      if (pid < n_parts) {
        const int rank = base[pid] + wo[pid] + (x >> 16);
        if (rank < bucket) s = pid * bucket + rank;
      }
      out[r] = s;
    }
  }
}

// Each warp takes `chunk` rows (a multiple of 32).  whole: the chunk is a
// multiple of `tile` (tiles never span two warps) and each tile's counts
// are stored; else they are added into the zeroed histogram.  Shared
// memory (P > 32): the warps' counts of their current tile, WARPS x P
// 16-bit words (a count never exceeds max(chunk, tile) <= 4096 there).
template <bool SMALL>
__global__ void __launch_bounds__(BLOCK)
radix_kernel(const long long* __restrict__ h,
             const uint8_t* __restrict__ valid, int n, int tile, int chunk,
             int n_parts, int nbits, bool whole, int* __restrict__ pid_out,
             int* __restrict__ hist) {
  extern __shared__ int smem[];
  unsigned short* counts = reinterpret_cast<unsigned short*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if constexpr (!SMALL) {
    for (int i = threadIdx.x; i < WARPS * n_parts; i += BLOCK) counts[i] = 0;
    __syncthreads();
  }
  const long long first = ((long long)blockIdx.x * WARPS + warp) * chunk;
  if (first >= n) return;
  const int w0 = (int)first;
  const int w1 = (int)min((long long)n, first + chunk);
  unsigned short* wc = counts + warp * n_parts;
  const unsigned below = (1u << lane) - 1u;

  int cnt = 0;                 // SMALL: partition `lane` in tile t
  int t = w0 / tile;           // the tile being counted
  int t_end = (int)min((long long)(t + 1) * tile, (long long)n);  // its end
  bool pending = false;        // counts of tile t not yet written
  auto flush = [&]() {
    int* out = hist + (long long)t * n_parts;
    if constexpr (SMALL) {
      if (lane < n_parts) {
        if (whole)
          out[lane] = cnt;
        else if (cnt)
          atomicAdd(out + lane, cnt);
      }
      cnt = 0;
    } else {
      __syncwarp();
      for (int p = lane; p < n_parts; p += 32) {
        const int c = wc[p];
        if (whole)
          out[p] = c;
        else if (c)
          atomicAdd(out + p, c);
        wc[p] = 0;
      }
      __syncwarp();
    }
    pending = false;
  };

  for (int r0 = w0; r0 < w1; r0 += 32 * HIST_ROUNDS) {
    int pid[HIST_ROUNDS];
    load_pids(h, valid, r0, w1 - r0, n_parts, lane, pid);
#pragma unroll
    for (int j = 0; j < HIST_ROUNDS; ++j) {
      const int q0 = r0 + 32 * j;
      if (q0 >= w1) break;                          // warp-uniform
      const int q1 = min(q0 + 32, w1);
      if (q0 + lane < q1) pid_out[q0 + lane] = pid[j];
      const Vote v = vote<SMALL>(pid[j], n_parts, nbits, lane);
      // the round's rows, tile by tile
      for (int a = q0; a < q1;) {
        const int b = min(t_end, q1);
        const unsigned range =
            (b - q0 == 32 ? FULL : (1u << (b - q0)) - 1u) &
            ~((1u << (a - q0)) - 1u);
        if constexpr (SMALL) {
          cnt += __popc(v.mine & range);
        } else {
          const unsigned g = v.same & range;
          if ((g >> lane) & 1u && (g & below) == 0) wc[pid[j]] += __popc(g);
          __syncwarp();
        }
        pending = true;
        if (b == t_end) {
          flush();
          ++t;
          t_end = (int)min((long long)t_end + tile, (long long)n);
        }
        a = b;
      }
    }
  }
  if (pending) flush();   // a tile that goes on in the next chunk (!whole)
}

// Dynamic shared memory above 48 KB needs the kernel's consent.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= DEFAULT_SMEM) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

// Rows of a partition_scatter tile.
extern "C" int restore_partition_scatter_tile() { return TILE; }

// h: n int64 hash lanes (uint32 values), valid: n bytes.  pid: n ints;
// hist: ceil(n / tile_n) * n_parts ints.  n_parts a power of two up to
// 8192, 1 <= tile_n <= n < 2**31.  Launches on `stream`, allocates
// nothing; returns a cudaError_t.
extern "C" int restore_radix_partition(const void* h, const void* valid,
                                       int* pid, int* hist, long long n,
                                       int tile_n, int n_parts,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const bool whole = tile_n % 32 == 0 && tile_n <= 4096;
  const int chunk =
      whole ? tile_n * ((HIST_CHUNK + tile_n - 1) / tile_n) : HIST_CHUNK;
  const int n_tiles = (int)((n + tile_n - 1) / tile_n);
  const long long per_block = (long long)WARPS * chunk;
  const unsigned blocks = (unsigned)((n + per_block - 1) / per_block);
  const int nbits = __builtin_ctz((unsigned)n_parts);
  const long long* hh = static_cast<const long long*>(h);
  const uint8_t* vv = static_cast<const uint8_t*>(valid);
  cudaError_t err = cudaSuccess;
  if (!whole)
    err = cudaMemsetAsync(hist, 0, sizeof(int) * (size_t)n_tiles * n_parts,
                          s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_parts <= SMALL_PARTS) {
    radix_kernel<true><<<blocks, BLOCK, 0, s>>>(
        hh, vv, (int)n, tile_n, chunk, n_parts, nbits, whole, pid, hist);
  } else {
    const size_t smem = sizeof(unsigned short) * WARPS * n_parts;
    err = allow_smem(radix_kernel<false>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    radix_kernel<false><<<blocks, BLOCK, smem, s>>>(
        hh, vv, (int)n, tile_n, chunk, n_parts, nbits, whole, pid, hist);
  }
  return static_cast<int>(cudaGetLastError());
}

// h: n_segs * n int64 hash lanes, valid: as many bytes; segment s is rows
// [s*n, (s+1)*n).  slot: as many ints, ovf: n_segs ints, status:
// n_segs * ceil(n / TILE) * n_parts + 1 words (zeroed here).  n_parts a
// power of two up to 8192, n < 2**30, n_segs * n < 2**31, n_parts *
// bucket < 2**31.  Launches on `stream`, allocates nothing; returns a
// cudaError_t.
extern "C" int restore_partition_scatter(const void* h, const void* valid,
                                         int* slot, int* ovf,
                                         unsigned* status, long long n,
                                         int n_segs, int n_parts,
                                         int bucket, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || n_segs <= 0) return static_cast<int>(cudaGetLastError());
  const int n_tiles = (int)((n + TILE - 1) / TILE);
  const long long words = (long long)n_segs * n_tiles * n_parts;
  cudaError_t err = cudaMemsetAsync(status, 0, sizeof(unsigned) * (words + 1),
                                    s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = (unsigned)((long long)n_segs * n_tiles);
  const int nbits = __builtin_ctz((unsigned)n_parts);
  const long long* hh = static_cast<const long long*>(h);
  const uint8_t* vv = static_cast<const uint8_t*>(valid);
  const size_t smem = sizeof(int) * TILE + (sizeof(int) +
                      sizeof(unsigned short) * WARPS) * (size_t)n_parts;
  auto kernel = n_parts <= SMALL_PARTS ? scatter_kernel<true>
                                       : scatter_kernel<false>;
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, BLOCK, smem, s>>>(hh, vv, (int)n, n_tiles, n_segs,
                                     n_parts, nbits, bucket, status,
                                     status + words, slot, ovf);
  return static_cast<int>(cudaGetLastError());
}
