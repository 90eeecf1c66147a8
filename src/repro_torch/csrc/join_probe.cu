// JOIN probe: searchsorted(right, left, side='left') over uint32 hashes.
//
// Replaces the TPU kernel hash_join.join_probe (_probe_kernel,
// src/repro/kernels/hash_join/hash_join.py:51), which keeps the sorted
// build side in VMEM and runs a vectorised branchless binary search of
// bit_length(R) rounds.
//
// What bounds it on an H100: bytes, once the build side's reads stay on
// chip.  Each probe key is read once (the int64 carrier: 8 bytes) and
// each position written once (4 bytes).  A plain binary search over a
// build side too large for shared memory runs bit_length(R) dependent
// rounds; the first few touch a few KB and stay in L1, but each of the
// last ones reads a random 32-byte L2 sector, so the search is bound by
// L2 traffic and latency, as torch.searchsorted is.
//
// Design.  The hashes are uniform 32-bit values, so a key's top b bits
// say almost where it lies in the sorted build side.
// - A pre-pass launch writes a uint32 copy of the build keys (half the
//   bytes of every later read) and a directory of 2**b + 1 int32
//   entries, dir[j] = lower_bound(right, j << (32 - b)), dir[2**b] = R.
// - The probe launch is a persistent grid.  Each block loads the
//   directory into dynamic shared memory once and walks the probes in a
//   grid-stride loop, two int64 probes per thread and step as one
//   16-byte streaming load, two positions as one 8-byte store.
// - A key k lies in bucket j = k >> (32 - b).  Every build key below
//   dir[j] has a smaller prefix and every key at or after dir[j + 1] a
//   larger one, so the leftmost position with right >= k lies in
//   [dir[j], dir[j + 1]], under any ties (all R keys may share one
//   bucket; that costs rounds, not correctness).  A bucket of more than
//   WINDOW keys is halved, branch-free, until it fits; then one read of
//   at most three aligned 16-byte chunks of the uint32 copy and a count
//   of the keys below k settle it.
// - Where the probe's time goes is the reads of the uint32 copy: random
//   16-byte reads that L2 serves at a far lower rate than the streamed
//   probes.  So the kernel asks for the largest L1 (shared-memory
//   carveout hint 0), and for a build side whose copy L1 can mostly hold
//   (2**16 keys) the wrapper keeps the directory small (b <= 12, one
//   1024-thread block per SM): a larger directory shortens the search
//   but takes that room from L1.  A larger build side misses L1 anyway;
//   there b grows to MAX_BITS (PERF.md).
#include <cuda_runtime.h>
#include <atomic>
#include <cstdint>

namespace {

constexpr int PREP_BLOCK = 256;
constexpr int PROBE_BLOCK = 1024;
constexpr int WINDOW = 8;      // keys settled by one vector read
constexpr int PAIR = 2;        // probes per thread and step
constexpr int MAX_BITS = 15;   // the largest directory (128 KB)

// keys[i] = low 32 bits of right[i]; dir[j] = first i with keys[i] >=
// j << (32 - bits), for j in [0, 2**bits] (dir[2**bits] = r).
__global__ void __launch_bounds__(PREP_BLOCK)
directory_kernel(const long long* __restrict__ right, int r, int bits,
                 uint32_t* __restrict__ keys, int* __restrict__ dir) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < r) keys[i] = static_cast<uint32_t>(right[i]);
  if (i <= (1 << bits)) {
    const unsigned long long edge = static_cast<unsigned long long>(i)
                                    << (32 - bits);
    int lo = 0;
    int len = r;
    while (len > 0) {
      const int half = len >> 1;
      const unsigned long long m =
          static_cast<uint32_t>(__ldg(right + lo + half));
      const bool lt = m < edge;
      lo = lt ? lo + half + 1 : lo;
      len = lt ? len - half - 1 : half;
    }
    dir[i] = lo;
  }
}

// Leftmost positions of PAIR keys.  Invariant of the narrowing loop: the
// answer is lo + #{i in [lo, lo + len): keys[i] < key}.
__device__ __forceinline__ void search(const uint32_t* __restrict__ keys,
                                       const int* sdir, int shift,
                                       const uint32_t (&key)[PAIR],
                                       int (&res)[PAIR]) {
  int lo[PAIR], len[PAIR];
#pragma unroll
  for (int q = 0; q < PAIR; ++q) {
    const uint32_t j = key[q] >> shift;
    lo[q] = sdir[j];
    len[q] = sdir[j + 1] - lo[q];
  }
  // halve buckets of more than WINDOW keys (ties, or a build side larger
  // than 4 * 2**MAX_BITS keys)
  for (;;) {
    bool more = false;
#pragma unroll
    for (int q = 0; q < PAIR; ++q) more |= len[q] > WINDOW;
    if (!more) break;
#pragma unroll
    for (int q = 0; q < PAIR; ++q) {
      if (len[q] > WINDOW) {
        const int half = len[q] >> 1;
        const bool lt = __ldg(keys + lo[q] + half - 1) < key[q];
        lo[q] = lt ? lo[q] + half : lo[q];
        len[q] = lt ? len[q] - half : half;
      }
    }
  }
  // [lo, lo + len) lies in the 12 keys from base = lo & ~3; read the
  // 16-byte chunks it touches, all independent, then count
  uint4 w[PAIR][3];
#pragma unroll
  for (int q = 0; q < PAIR; ++q) {
    const int base = lo[q] & ~3;
    const int end = lo[q] + len[q];
    const uint4* p = reinterpret_cast<const uint4*>(keys + base);
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    w[q][0] = len[q] > 0 ? __ldg(p) : zero;
    w[q][1] = end > base + 4 ? __ldg(p + 1) : zero;
    w[q][2] = end > base + 8 ? __ldg(p + 2) : zero;
  }
#pragma unroll
  for (int q = 0; q < PAIR; ++q) {
    const int base = lo[q] & ~3;
    const int end = lo[q] + len[q];
    const uint32_t v[12] = {w[q][0].x, w[q][0].y, w[q][0].z, w[q][0].w,
                            w[q][1].x, w[q][1].y, w[q][1].z, w[q][1].w,
                            w[q][2].x, w[q][2].y, w[q][2].z, w[q][2].w};
    int cnt = 0;
#pragma unroll
    for (int e = 0; e < 12; ++e) {
      const int idx = base + e;
      cnt += (idx >= lo[q] && idx < end && v[e] < key[q]) ? 1 : 0;
    }
    res[q] = lo[q] + cnt;
  }
}

__global__ void __launch_bounds__(PROBE_BLOCK)
probe_kernel(const long long* __restrict__ left,
             const uint32_t* __restrict__ keys, const int* __restrict__ dir,
             int* __restrict__ pos, long long n, int bits, int vec) {
  extern __shared__ int sdir[];
  const int entries = (1 << bits) + 1;
  for (int j = threadIdx.x; j < entries; j += blockDim.x) sdir[j] = dir[j];
  __syncthreads();
  const int shift = 32 - bits;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (vec) {
    // left 16-byte and pos 8-byte aligned: one pair per thread and step
    const longlong2* l2 = reinterpret_cast<const longlong2*>(left);
    int2* p2 = reinterpret_cast<int2*>(pos);
    const long long pairs = n >> 1;
    for (long long i = tid; i < pairs; i += stride) {
      const longlong2 k = __ldcs(l2 + i);
      const uint32_t key[PAIR] = {static_cast<uint32_t>(k.x),
                                  static_cast<uint32_t>(k.y)};
      int res[PAIR];
      search(keys, sdir, shift, key, res);
      __stcs(p2 + i, make_int2(res[0], res[1]));
    }
    if ((n & 1) && tid == 0) {
      const uint32_t k = static_cast<uint32_t>(left[n - 1]);
      const uint32_t key[PAIR] = {k, k};
      int res[PAIR];
      search(keys, sdir, shift, key, res);
      pos[n - 1] = res[0];
    }
  } else {
    for (long long i = tid; i < n; i += stride) {
      const uint32_t k = static_cast<uint32_t>(__ldcs(left + i));
      const uint32_t key[PAIR] = {k, k};
      int res[PAIR];
      search(keys, sdir, shift, key, res);
      pos[i] = res[0];
    }
  }
}

}  // namespace

// left: (n,) int64 probe hashes, right: (r,) int64 sorted build hashes,
// both holding values in [0, 2**32); pos: (n,) int32.  bits in [1,
// MAX_BITS] sizes the directory.  Scratch from the wrapper: keys, r + 12
// uint32 (16-byte aligned; the last window read may pass r by up to 11),
// and dir, 2**bits + 1 int32.  n_sm sizes the persistent grid.  Two
// launches on `stream` (directory, probe), allocates nothing; returns
// cudaGetLastError().
extern "C" int restore_join_probe(const long long* left,
                                  const long long* right, int* pos,
                                  long long n, int r, int bits,
                                  uint32_t* keys, int* dir, int n_sm,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (bits < 1 || bits > MAX_BITS || r < 0 ||
      (reinterpret_cast<uintptr_t>(keys) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  const int entries = (1 << bits) + 1;
  const int prep = r > entries ? r : entries;
  directory_kernel<<<(prep + PREP_BLOCK - 1) / PREP_BLOCK, PREP_BLOCK, 0,
                     s>>>(right, r, bits, keys, dir);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // once per device: the opt-in above 48 KB of dynamic shared memory (for
  // the largest directory) and the hint to give L1 all the room that the
  // directory leaves
  const size_t smem = (size_t)entries * sizeof(int);
  static std::atomic<unsigned> opted{0};
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned bit = 1u << (dev & 31);
  if (!(opted.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(
        probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(((1 << MAX_BITS) + 1) * sizeof(int)));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          probe_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxL1);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted.fetch_or(bit, std::memory_order_release);
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, probe_kernel,
                                                      PROBE_BLOCK, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) per_sm = 1;
  const int vec = !(reinterpret_cast<uintptr_t>(left) & 15) &&
                  !(reinterpret_cast<uintptr_t>(pos) & 7);
  const long long work = vec ? (n + 1) / 2 : n;
  const long long want = (work + PROBE_BLOCK - 1) / PROBE_BLOCK;
  const long long cap = (long long)n_sm * per_sm;
  const int grid = (int)(want < cap ? want : cap);
  probe_kernel<<<grid, PROBE_BLOCK, smem, s>>>(left, keys, dir, pos, n,
                                               bits, vec);
  return static_cast<int>(cudaGetLastError());
}
