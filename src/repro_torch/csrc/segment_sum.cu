// Sorted segment sum for GROUPBY / COGROUP aggregation.
//
// Replaces the TPU kernel segment_reduce.segment_sum_sorted (_seg_kernel,
// src/repro/kernels/segment_reduce/segment_reduce.py:52), which reduces
// each tile with a one-hot matmul on the MXU and combines tiles by
// scatter-add.
//
// What bounds it on an H100: bytes.  Each row is read once (a 4-byte id
// and D 4-byte values) and each segment written once; there are no
// floating-point operations to speak of.  To reach the memory's rate a
// thread must keep several 16-byte loads in flight and spend few
// instructions and barriers per row.
//
// Design: no float atomics and no look-back, so every segment adds in
// the same order on every run.
// - A block of THREADS threads takes a tile of TILE consecutive rows,
//   ROWS per thread.  A full tile's ids come in as int4 loads and its
//   values as 16-byte loads of the row-major (rows, D) block; a ragged
//   tile, or a misaligned pointer, takes scalar loads.
// - Each thread adds its rows in order in registers, all D lanes at
//   once.  Its rows' (any-head, sum since the last head) pair feeds one
//   segmented exclusive scan over the warp (shuffles) and one over the
//   warps (shared memory, one barrier), a fixed tree for all D lanes.
//   With the carry from the threads before it, the thread walks its rows
//   again and writes every run that ends in them.
// - A run that lies wholly inside the tile is written straight to the
//   output.  The tile's first and last runs may continue into a
//   neighbour, so they go to a partial buffer of 2 entries per tile,
//   whose ids are again sorted; that buffer is reduced by the same
//   kernel, level by level, until it fits in one tile, where every run
//   is written out.  2**24 rows take three launches.
// - Ids need not be dense; ids outside [0, num_segments) are dropped, as
//   in the reference.  Rows wider than MAX_LANES lanes run in passes of
//   up to MAX_LANES columns.  The output must be zero on entry (the
//   wrapper allocates it so).
#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int THREADS = 512;
constexpr int ROWS = 8;                  // rows per thread
constexpr int TILE = THREADS * ROWS;     // rows per block
constexpr int WARPS = THREADS / 32;
constexpr int MAX_LANES = 8;             // lanes of one pass
constexpr unsigned FULL = 0xffffffffu;

// vals: rows of `ld` floats, of which this pass reads DC from column 0
// (the caller offsets the pointers by the pass's first column); out and
// part_vals have rows of `ld` floats too.
template <int DC>
__global__ void __launch_bounds__(THREADS)
seg_tile_kernel(const float* __restrict__ vals, const int* __restrict__ ids,
                int n, int ld, int num_segments, float* __restrict__ out,
                float* __restrict__ part_vals, int* __restrict__ part_ids,
                int final_level, int vec) {
  __shared__ float wsum[WARPS][DC];
  __shared__ int wflag[WARPS];

  const int tile = blockIdx.x;
  const int start = tile * TILE;
  const int len = min(TILE, n - start);
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int r0 = t * ROWS;                       // first row, in the tile
  const int nrows = max(0, min(ROWS, len - r0));
  const bool holds_tail = nrows > 0 && r0 + nrows == len;
  const int first_id = __ldg(ids + start);
  const int last_id = __ldg(ids + start + len - 1);

  int id[ROWS];
  float v[ROWS][DC];
  if (vec && len == TILE) {
    const int4* ip = reinterpret_cast<const int4*>(ids + start + r0);
#pragma unroll
    for (int q = 0; q < ROWS / 4; ++q) {
      const int4 x = __ldcs(ip + q);
      id[4 * q] = x.x;
      id[4 * q + 1] = x.y;
      id[4 * q + 2] = x.z;
      id[4 * q + 3] = x.w;
    }
    const float4* vp =
        reinterpret_cast<const float4*>(vals + (size_t)(start + r0) * DC);
#pragma unroll
    for (int q = 0; q < ROWS * DC / 4; ++q) {
      const float4 x = __ldcs(vp + q);
      const float e[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) v[(4 * q + j) / DC][(4 * q + j) % DC] = e[j];
    }
  } else {
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const bool live = k < nrows;
      const size_t row = (size_t)(start + r0 + k);
      id[k] = live ? ids[row] : 0;
#pragma unroll
      for (int c = 0; c < DC; ++c) v[k][c] = live ? vals[row * ld + c] : 0.f;
    }
  }

  // the ids just before and after this thread's rows, inside the tile
  // (only read where they exist)
  int last_own = id[0];
#pragma unroll
  for (int k = 1; k < ROWS; ++k) last_own = k < nrows ? id[k] : last_own;
  int prev_id = __shfl_up_sync(FULL, last_own, 1);
  if (lane == 0 && r0 > 0 && nrows > 0) prev_id = __ldg(ids + start + r0 - 1);
  int next_id = __shfl_down_sync(FULL, id[0], 1);
  if (lane == 31 && nrows > 0 && !holds_tail)
    next_id = __ldg(ids + start + r0 + ROWS);

  // this thread's (any head, sum since its last head)
  bool f = false;
  float s[DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) s[c] = 0.f;
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    if (k < nrows) {
      const bool head = k == 0 ? (r0 == 0 || prev_id != id[0])
                               : id[k] != id[k - 1];
      f = f || head;
#pragma unroll
      for (int c = 0; c < DC; ++c) s[c] = head ? v[k][c] : s[c] + v[k][c];
    }
  }

  // segmented inclusive scan over the warp: (a,fa) + (b,fb) =
  // (fb ? b : a + b, fa | fb), a fixed tree, so a fixed order
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int fu = __shfl_up_sync(FULL, (int)f, off);
    float su[DC];
#pragma unroll
    for (int c = 0; c < DC; ++c) su[c] = __shfl_up_sync(FULL, s[c], off);
    if (lane >= off) {
      if (!f) {
#pragma unroll
        for (int c = 0; c < DC; ++c) s[c] = su[c] + s[c];
      }
      f = f || fu;
    }
  }
  if (lane == 31) {
    wflag[warp] = f;
#pragma unroll
    for (int c = 0; c < DC; ++c) wsum[warp][c] = s[c];
  }
  // exclusive: the inclusive value of the lane before
  int ef = __shfl_up_sync(FULL, (int)f, 1);
  float es[DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) es[c] = __shfl_up_sync(FULL, s[c], 1);
  if (lane == 0) {
    ef = 0;
#pragma unroll
    for (int c = 0; c < DC; ++c) es[c] = 0.f;
  }
  __syncthreads();
  // the warps before this one, in order, then the lanes before this one
  float carry[DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) carry[c] = 0.f;
  for (int w = 0; w < warp; ++w) {
    const bool wf = wflag[w];
#pragma unroll
    for (int c = 0; c < DC; ++c)
      carry[c] = wf ? wsum[w][c] : carry[c] + wsum[w][c];
  }
#pragma unroll
  for (int c = 0; c < DC; ++c) carry[c] = ef ? es[c] : carry[c] + es[c];

  if (!final_level && t == 0) {
    part_ids[2 * tile] = first_id;
    part_ids[2 * tile + 1] = last_id;
  }

  // walk the rows again with the carry; write each run where it ends
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    if (k < nrows) {
      const bool head = k == 0 ? (r0 == 0 || prev_id != id[0])
                               : id[k] != id[k - 1];
#pragma unroll
      for (int c = 0; c < DC; ++c)
        carry[c] = head ? v[k][c] : carry[c] + v[k][c];
      const bool tail = k + 1 < nrows ? id[k + 1] != id[k]
                                      : (holds_tail || next_id != id[k]);
      if (tail) {
        const int sid = id[k];
        float* dst = nullptr;
        if (!final_level && sid == first_id) {
          dst = part_vals + (size_t)(2 * tile) * ld;
          if (sid == last_id) {
#pragma unroll
            for (int c = 0; c < DC; ++c)
              part_vals[(size_t)(2 * tile + 1) * ld + c] = 0.f;
          }
        } else if (!final_level && sid == last_id) {
          dst = part_vals + (size_t)(2 * tile + 1) * ld;
        } else if (sid >= 0 && sid < num_segments) {
          dst = out + (size_t)sid * ld;
        }
        if (dst != nullptr) {
#pragma unroll
          for (int c = 0; c < DC; ++c) dst[c] = carry[c];
        }
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Every level of one pass of DC lanes; the pointers are offset by the
// pass's first column, rows are d floats wide.
template <int DC>
void run_levels(const float* vals, const int* ids, float* out, int n, int d,
                int num_segments, float* sv, int* si, cudaStream_t s) {
  const float* cv = vals;
  const int* ci = ids;
  int cn = n;
  while (cn > TILE) {
    const int nt = (cn + TILE - 1) / TILE;
    const int vec = DC == d && aligned16(cv) && aligned16(ci);
    seg_tile_kernel<DC><<<nt, THREADS, 0, s>>>(cv, ci, cn, d, num_segments,
                                               out, sv, si, 0, vec);
    cv = sv;
    ci = si;
    cn = 2 * nt;
    sv += (size_t)cn * d;
    si += cn;
  }
  if (cn > 0) {
    const int vec = DC == d && aligned16(cv) && aligned16(ci);
    seg_tile_kernel<DC><<<1, THREADS, 0, s>>>(cv, ci, cn, d, num_segments,
                                              out, nullptr, nullptr, 1, vec);
  }
}

}  // namespace

// Entry ids are sorted ascending.  scratch_* hold the partial buffers of
// every level: sum over levels of 2*ceil(n_level/TILE) entries of d
// floats and one id (the wrapper computes the same sizes).  Launches on
// `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError().
extern "C" int restore_segment_sum(const float* vals, const int* ids,
                                   float* out, int n, int d,
                                   int num_segments, float* scratch_vals,
                                   int* scratch_ids, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int c0 = 0; c0 < d; c0 += MAX_LANES) {
    const int dc = d - c0 < MAX_LANES ? d - c0 : MAX_LANES;
    const float* v = vals + c0;
    float* o = out + c0;
    float* sv = scratch_vals + c0;
    switch (dc) {
      case 1: run_levels<1>(v, ids, o, n, d, num_segments, sv, scratch_ids, s); break;
      case 2: run_levels<2>(v, ids, o, n, d, num_segments, sv, scratch_ids, s); break;
      case 3: run_levels<3>(v, ids, o, n, d, num_segments, sv, scratch_ids, s); break;
      case 4: run_levels<4>(v, ids, o, n, d, num_segments, sv, scratch_ids, s); break;
      case 5: run_levels<5>(v, ids, o, n, d, num_segments, sv, scratch_ids, s); break;
      case 6: run_levels<6>(v, ids, o, n, d, num_segments, sv, scratch_ids, s); break;
      case 7: run_levels<7>(v, ids, o, n, d, num_segments, sv, scratch_ids, s); break;
      default: run_levels<8>(v, ids, o, n, d, num_segments, sv, scratch_ids, s); break;
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int restore_segment_sum_tile() { return TILE; }
