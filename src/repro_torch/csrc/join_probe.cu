// JOIN probe: searchsorted(right, left, side='left') over uint32 hashes.
//
// Replaces the TPU kernel hash_join.join_probe (_probe_kernel,
// src/repro/kernels/hash_join/hash_join.py), which keeps the sorted
// build side in VMEM and runs a vectorised branchless binary search.
//
// What bounds it on an H100: bytes.  Each probe key is read once and
// each position written once; a search of bit_length(R) rounds costs a
// few dozen integer operations per probe, far below the card's rate.
// The build side is read many times, so it must stay on chip: when its
// 4*R bytes fit in the 48 KB of static-size shared memory, every block
// stages it there as uint32 and walks the probes in a grid-stride loop
// (so the staging is paid once per resident block, not once per 256
// probes); otherwise the search reads it through the read-only L2 path.
//
// The port carries hash lanes as int64 masked to 32 bits, so the kernel
// reads the int64 carrier directly and compares the low 32 bits as
// unsigned 32-bit values: no narrowing pass runs before the launch.  The
// carrier costs 12 bytes per probe where the function needs 8 (a uint32
// key in, an int32 position out), and 8 per build key instead of 4.
// One thread per probe key; the answer is the leftmost index among ties.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int BLOCK = 256;

template <bool STAGED>
__global__ void __launch_bounds__(BLOCK)
probe_kernel(const long long* __restrict__ left,
             const long long* __restrict__ right, int* __restrict__ pos,
             long long n, int r, int rounds) {
  extern __shared__ uint32_t srh[];
  if (STAGED) {
    for (int i = threadIdx.x; i < r; i += blockDim.x)
      srh[i] = static_cast<uint32_t>(right[i]);
    __syncthreads();
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const uint32_t key = static_cast<uint32_t>(left[i]);
    int lo = 0;
    int hi = r;
    for (int k = 0; k < rounds; ++k) {
      const bool cont = lo < hi;
      const int mid = (lo + hi) >> 1;   // < r whenever cont
      uint32_t mv = 0u;
      if (cont) {
        mv = STAGED ? srh[mid] : static_cast<uint32_t>(__ldg(right + mid));
      }
      const bool go_right = mv < key;
      lo = (cont && go_right) ? mid + 1 : lo;
      hi = (cont && !go_right) ? mid : hi;
    }
    pos[i] = lo;
  }
}

}  // namespace

// left: (n,) int64 probe hashes, right: (r,) int64 sorted build hashes,
// both holding values in [0, 2**32); pos: (n,) int32.  n_sm sizes the
// grid of the staged variant.  Launches on `stream`, allocates nothing;
// returns cudaGetLastError().
extern "C" int restore_join_probe(const long long* left,
                                  const long long* right, int* pos,
                                  long long n, int r, int n_sm,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  int rounds = 1;
  while ((1LL << rounds) <= (long long)r) ++rounds;  // bit_length(r), >= 1
  const long long want = (n + BLOCK - 1) / BLOCK;
  const size_t smem = (size_t)r * sizeof(uint32_t);
  if (smem <= 48 * 1024) {
    const long long cap = (long long)n_sm * 8;
    const int grid = (int)(want < cap ? want : cap);
    probe_kernel<true><<<grid, BLOCK, smem, s>>>(left, right, pos, n, r,
                                                 rounds);
  } else {
    const int grid = (int)(want < 0x7fffffffLL ? want : 0x7fffffffLL);
    probe_kernel<false><<<grid, BLOCK, 0, s>>>(left, right, pos, n, r,
                                               rounds);
  }
  return static_cast<int>(cudaGetLastError());
}
