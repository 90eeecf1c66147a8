// Sorted segment sum for GROUPBY / COGROUP aggregation.
//
// Replaces the TPU kernel segment_reduce.segment_sum_sorted (_seg_kernel,
// src/repro/kernels/segment_reduce/segment_reduce.py), which reduces each
// tile with a one-hot matmul on the MXU and combines tiles by scatter-add.
//
// What bounds it on an H100: bytes.  Each row is read once (a 4-byte id
// and D 4-byte values) and each segment written once; there are no
// floating-point operations to speak of.  The tile's ids are staged in
// shared memory so run boundaries cost no extra device-memory reads.
//
// Design: no float atomics, so every segment adds in the same order on
// every run.  One block of TILE threads takes TILE consecutive rows.  A
// segmented inclusive scan (warp shuffles, then one warp over the warp
// totals) leaves each run's in-tile sum on its last row.  Runs that lie
// wholly inside the tile are written straight to the output.  The first
// and last run of a tile may continue into a neighbour, so they go to a
// partial buffer of 2 entries per tile, whose ids are again sorted; that
// buffer is reduced by the same kernel, level by level, until it fits in
// one tile, where every run is written out.  Ids need not be dense, and
// ids outside [0, num_segments) are dropped, as in the reference.
// The output must be zero on entry (the wrapper allocates it so).
#include <cuda_runtime.h>
#include <climits>
#include <cstddef>

namespace {

constexpr int TILE = 1024;
constexpr int WARPS = TILE / 32;

__global__ void __launch_bounds__(TILE)
seg_tile_kernel(const float* __restrict__ vals, const int* __restrict__ ids,
                int n, int d, int num_segments, float* __restrict__ out,
                float* __restrict__ part_vals, int* __restrict__ part_ids,
                int final_level) {
  __shared__ int sid[TILE];
  __shared__ float wsum[WARPS];
  __shared__ int wflag[WARPS];

  const int tile = blockIdx.x;
  const int start = tile * TILE;
  const int len = min(TILE, n - start);
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const bool live = t < len;

  const int id = live ? ids[start + t] : INT_MAX;
  sid[t] = id;
  __syncthreads();
  const int first_id = sid[0];
  const int last_id = sid[len - 1];
  const bool head = live && (t == 0 || sid[t - 1] != id);
  const bool tail = live && (t == len - 1 || sid[t + 1] != id);
  const bool in_range = id >= 0 && id < num_segments;
  const bool boundary_run = !final_level && (id == first_id || id == last_id);

  if (!final_level && t == 0) {
    part_ids[2 * tile] = first_id;
    part_ids[2 * tile + 1] = last_id;
  }

  for (int c = 0; c < d; ++c) {
    float v = live ? vals[(size_t)(start + t) * d + c] : 0.0f;
    int f = head ? 1 : 0;
    // segmented inclusive scan within the warp: (a,fa) + (b,fb) =
    // (fb ? b : a + b, fa | fb), a fixed tree, so a fixed order
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float vu = __shfl_up_sync(0xffffffffu, v, off);
      const int fu = __shfl_up_sync(0xffffffffu, f, off);
      if (lane >= off) {
        if (!f) v = vu + v;
        f |= fu;
      }
    }
    if (lane == 31) {
      wsum[warp] = v;
      wflag[warp] = f;
    }
    __syncthreads();
    if (warp == 0) {
      float wv = wsum[lane];
      int wf = wflag[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float vu = __shfl_up_sync(0xffffffffu, wv, off);
        const int fu = __shfl_up_sync(0xffffffffu, wf, off);
        if (lane >= off) {
          if (!wf) wv = vu + wv;
          wf |= fu;
        }
      }
      wsum[lane] = wv;
    }
    __syncthreads();
    // carry in the segmented total of the warps before this one, unless
    // this row's run started inside its own warp
    if (warp > 0 && !f) v = wsum[warp - 1] + v;

    if (tail) {
      if (!boundary_run) {
        if (in_range) out[(size_t)id * d + c] = v;
      } else if (id == first_id) {
        part_vals[(size_t)(2 * tile) * d + c] = v;
        if (id == last_id) part_vals[(size_t)(2 * tile + 1) * d + c] = 0.0f;
      } else {
        part_vals[(size_t)(2 * tile + 1) * d + c] = v;
      }
    }
    __syncthreads();  // wsum is reused by the next column
  }
}

}  // namespace

// Entry ids are sorted ascending.  scratch_* hold the partial buffers of
// every level: sum over levels of 2*ceil(n_level/TILE) entries (the
// wrapper computes the same sizes).  Launches on `stream`, allocates
// nothing, does not synchronise; returns cudaGetLastError().
extern "C" int restore_segment_sum(const float* vals, const int* ids,
                                   float* out, int n, int d,
                                   int num_segments, float* scratch_vals,
                                   int* scratch_ids, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* cv = vals;
  const int* ci = ids;
  int cn = n;
  float* sv = scratch_vals;
  int* si = scratch_ids;
  while (cn > TILE) {
    const int nt = (cn + TILE - 1) / TILE;
    seg_tile_kernel<<<nt, TILE, 0, s>>>(cv, ci, cn, d, num_segments, out,
                                        sv, si, 0);
    cv = sv;
    ci = si;
    cn = 2 * nt;
    sv += (size_t)cn * d;
    si += cn;
  }
  if (cn > 0) {
    seg_tile_kernel<<<1, TILE, 0, s>>>(cv, ci, cn, d, num_segments, out,
                                       nullptr, nullptr, 1);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int restore_segment_sum_tile() { return TILE; }
