// Causal online-softmax attention (FlashAttention) for Hopper (sm_90a),
// bf16 on the tensor cores.
//
// Replaces, for bf16, the TPU kernel `_attn_kernel` behind
// src/repro/kernels/flash_attention/flash_attention.py::flash_attention_bhsd
// (float32 keeps the CUDA-core kernel of flash_attention.cu).  It computes
// what that kernel computes: scores in f32, scaled by 1/sqrt(D); keys at or
// beyond the row's valid length, and (causal) keys after the query's
// position, masked; an online softmax carried across KV tiles; out =
// acc / max(l, 1e-30), cast to bf16.  With the serving path's contract:
// kv_len and q_offset per batch row (an int32 (B,) device array, or one
// value for all rows passed by value); GQA without copies; ragged Sq and
// Skv; q, k, v and o addressed through (batch, head, seq) strides with a
// dense, 16-byte aligned last dim; head dims 16, 32, 64 and 128, and, for
// MLA (minicpm3: a query/key head dim of 96 = 64 + 32 rotary, a value
// head dim of 64), a value head dim Dv of 16, 32 or 64 under a wider
// query/key head dim D, a multiple of 8 up to 128.  Given
// an `lse` buffer (training), it also writes each row's statistic for the
// backward (flash_attention_bwd.cu): lse = ln(sum of exp(scores)), +inf
// for a row that sees no key; the serving path passes null.
//
// Design.
//   * One CTA serves one (batch row, KV head, tile of 64 query rows).  The
//     tile's rows are the group = Hq / Hkv query heads of that KV head
//     times 64 / group query positions (row r: position q0 + r / group,
//     head hk * group + r % group), so K and V are read once per KV head.
//   * 160 threads: warps 0-3 are one consumer warpgroup, warp 4 the
//     producer.  One producer thread keeps K and V tiles (64 keys x the
//     head dim) in flight by TMA (cp.async.bulk.tensor, CUtensorMaps
//     passed as __grid_constant__ parameters) into two rings of STAGES
//     shared-memory stages, one for K and one for V, each stage with a
//     `full` mbarrier (TMA bytes) and an `empty` mbarrier (128 consumer
//     arrivals), so a K stage is refilled once S has read it.  TMA writes
//     each 64-column box with the 128-byte swizzle, the layout the wgmma
//     descriptors below name (B128); rows at or beyond Skv, and columns
//     at or beyond D < 64, come back as zeros.
//   * Two padded widths: DP for Q and K (64 or 128 columns) and DV for V,
//     the accumulators and the output (64 or 128).  Instantiated (DP, DV)
//     = (64, 64), (128, 128) and (128, 64), the last for MLA: S at 128
//     columns with columns 96-127 zero (TMA's out-of-bounds fill for K,
//     zeros staged for Q), P V and the output at 64.
//   * S = Q K^T: wgmma.mma_async m64n64k16, Q (staged once in shared
//     memory in the same swizzled layout) and K both K-major, f32
//     accumulators in registers.  P V: P rounded to bf16 in registers as
//     the A operand (the accumulator layout of S is the A-fragment layout
//     of P), V the B operand from shared memory through the transpose flag
//     (V is stored key-major, d contiguous: MN-major).  The online softmax
//     stays in f32 registers in the log2 domain (scores pre-scaled by
//     log2(e)/sqrt(D), ex2.approx); `l` sums the f32 probabilities, not the
//     bf16-rounded P that enters P V.  Masked probabilities are exactly 0.
//     Software pipeline: S of tile t + 1 and P V of tile t - 1 run on the
//     tensor cores while the softmax of tile t runs on the CUDA cores.
//   * Split-KV.  The key axis is cut into splits of SPLIT = 128 keys,
//     fixed at compile time.  Each split runs its own online softmax
//     over its two 64-key tiles in order, from (m, l, acc) = (-1e30, 0,
//     0), and splits are merged in increasing key order by merge_*().
//     A prefill CTA loops over the splits and merges them in registers
//     (the fused form; between merges the merged accumulators wait in
//     shared memory, so two CTAs fit on an SM).  With few CTAs (decode,
//     short suffixes) each CTA owns one split and writes (m, l, acc) to a
//     scratch buffer that the wrapper allocates; a second launch
//     (fa_merge_kernel) merges the splits with the same functions.  A split that is fully masked for
//     a row leaves it at (-1e30, 0, 0), and merging that is an exact
//     no-op.
//   * A row that sees no key (kv_len = 0, or causal before every key)
//     ends with L = 0 in both forms.  Its scores are all masked to
//     -1e30, whose softmax is uniform over the Skv keys, so the epilogue
//     (fused) or the merge (split) writes the mean of V over all Skv keys
//     of the row's KV head (mean_v, the same arithmetic in both forms), as
//     the plain version does.  A row that sees a key has L >= 1.
//   * Skipped work: KV tiles at or beyond min(kv_len, Skv) and, causally,
//     beyond the tile's last query position are never loaded.  A tile
//     that every row of the CTA sees whole skips the mask.  The longest
//     causal tiles are scheduled first, paired with the shortest.
//
// Batch invariance.  A query row's arithmetic depends only on its own
// position and kv_len and the fixed 64-key tiles and 128-key splits: every
// tile goes through the same instruction shapes (m64n64k16 for S,
// m64nDVk16 for P V) whatever the tile's row count; the row reductions are
// the same quad shuffles; tiles and splits that are fully masked for the
// row (present because another row of the CTA needs them, or absent in a
// one-row decode) leave its state bit for bit unchanged (a max that did
// not move rescales by exactly 1); and every rounding step outside the
// tensor cores is explicit (fmaf, __f*_rn, ex2.approx), so the compiler
// cannot contract it differently in two instantiations.  So a
// row gets the same bits in a 1040-row prefill (fused form), a 16-row
// suffix and a one-row decode (split form).
//
// Bound on this card: the cold prefill (16 query and 8 KV heads x 128,
// 1040 queries causal over a 1042-slot cache) is compute-bound, ~4.4 GFLOP
// at 989 TFLOP/s bf16, ~4.5 us; decode is bytes-bound (the visible cache
// read once, ~4.3 MB at 3.35 TB/s, ~1.3 us).  The tensor cores take the
// FLOPs; split-KV puts 72 CTAs on a one-row decode instead of 8.  Measured
// on an H100, the prefill is bound by its longest CTA's serial chain of
// 17 tiles (the CUDA-core work of each tile, not its loads or its wgmma),
// the decode by its two launches.  Not done yet: two consumer warpgroups
// ping-ponging softmax against wgmma, 128-key tiles, a persistent grid,
// and the merge folded into the last split CTA.

#include <math.h>
#include <string.h>

#include "sm90_common.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BM = 64;                  // query-tile rows: one wgmma M
constexpr int BK = 64;                  // keys per KV tile
constexpr int SPLIT = 128;              // keys per split
constexpr int TPS = SPLIT / BK;         // tiles per split
constexpr int STAGES = 2;               // K/V ring depth
constexpr int CONSUMERS = 128;          // one warpgroup
constexpr int THREADS = CONSUMERS + 32; // + the producer warp

// Shared memory of one CTA for a query/key head dim padded to DP and a
// value head dim padded to DV (64 or 128 each): the Q tile and STAGES K
// tiles (DP / 64 boxes each), STAGES V tiles (DV / 64 boxes each), in the
// fused form the merged accumulators (DV / 2 floats per consumer thread),
// then the mbarriers.  The dynamic shared memory base is 1024-aligned
// (the 128-byte swizzle's period; the kernel traps if it is not), and the
// fused form fits two CTAs on an SM, so one overlaps its softmax with the
// other's wgmma.
template <int DP, int DV, bool FUSED>
struct Smem {
  static constexpr int KT = (DP / 64) * BOX;   // a Q or K tile
  static constexpr int VT = (DV / 64) * BOX;   // a V tile
  static constexpr int Q = 0;
  static constexpr int K = KT;
  static constexpr int V = K + STAGES * KT;
  static constexpr int ACC = V + STAGES * VT;
  static constexpr int BAR = ACC + (FUSED ? DV / 2 * CONSUMERS * 4 : 0);
  static constexpr int BYTES = BAR + 4 * STAGES * 8;
};

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* v;  // read only for rows that see no key
  __nv_bfloat16* o;
  float* part_acc;        // split form: (B, Hq, Sq, n_split, Dv)
  float* part_ml;         // split form: (B, Hq, Sq, n_split, 2)
  float* lse;             // (B * Hq, lse_ld) row statistics, or null
  const int* kv_len;      // (B,) or null: kv_len_val for every row
  const int* q_offset;    // (B,) or null: q_offset_val for every row
  long long qb, qh, qs, vb, vh, vs, ob, oh, os;
  int kv_len_val, q_offset_val;
  int Hq, Hkv, group, Sq, Skv, D, Dv;
  int qp;                 // query positions per tile: 64 / group
  int wave;               // CTAs in the first wave: the SM count
  int n_split;
  int causal;
  int lse_ld;
  float scale_log2;       // log2(e) / sqrt(D), D the query/key head dim
};

// ------------------------------------------------------------ softmax

// The weight of a running state whose max moved from `from` to `to`:
// exactly 1 when it did not move, so a fully masked tile or split leaves
// the state bit for bit unchanged.
__device__ __forceinline__ float rescale(float from, float to) {
  return from == to ? 1.f : ex2(__fsub_rn(from, to));
}

// ------------------------------------------------ the split-KV merge
// Both forms (registers in the fused kernel, scratch in fa_merge_kernel)
// go through these three functions, in increasing split order, from
// (M, L, ACC) = (-1e30, 0, 0).

// Merge a split's (m, l) into the running (M, L); wa and wb weigh the
// running and the split's accumulators.
__device__ __forceinline__ void merge_ml(float& M, float& L, float m, float l,
                                         float& wa, float& wb) {
  const float mn = fmaxf(M, m);
  wa = rescale(M, mn);
  wb = rescale(m, mn);
  L = fmaf(L, wa, __fmul_rn(l, wb));
  M = mn;
}

__device__ __forceinline__ float merge_acc(float x, float wa, float y,
                                           float wb) {
  return fmaf(x, wa, __fmul_rn(y, wb));
}

// A row's statistic for the backward, lse = ln(sum of exp(scores)) in the
// natural-log domain, from the merged (M, L) of the log2 domain; +inf for
// a row that sees no key (L = 0)
__device__ __forceinline__ float row_lse(float M, float L) {
  return L == 0.f ? INFINITY : (M + log2f(L)) * 0.69314718055994531f;
}

// out = acc / max(L, 1e-30), as acc times the row's rounded reciprocal
__device__ __forceinline__ float inv_l(float L) {
  return __frcp_rn(fmaxf(L, 1e-30f));
}
__device__ __forceinline__ float finish(float acc, float inv) {
  return __fmul_rn(acc, inv);
}

// Columns col, col + 1 of the mean of V over all Skv keys of KV head hk:
// the output of a row that sees no key (L = 0).  Keys are summed in
// order, so both forms give the same bits.
__device__ __forceinline__ __nv_bfloat162 mean_v(const Params& p, int b,
                                                 int hk, int col) {
  const __nv_bfloat16* vp = p.v + b * p.vb + hk * p.vh + col;
  float a0 = 0.f, a1 = 0.f;
  for (int k = 0; k < p.Skv; ++k) {
    const __nv_bfloat162 x =
        *reinterpret_cast<const __nv_bfloat162*>(vp + k * p.vs);
    a0 = __fadd_rn(a0, __bfloat162float(x.x));
    a1 = __fadd_rn(a1, __bfloat162float(x.y));
  }
  const float inv = p.Skv > 0 ? __frcp_rn((float)p.Skv) : 0.f;
  return __floats2bfloat162_rn(__fmul_rn(a0, inv), __fmul_rn(a1, inv));
}

// ------------------------------------------------------------ the kernel

// grid (query tiles, B * Hkv, 1), or (query tiles, B * Hkv, n_split) with
// SPLITS: then CTA z owns split z and writes its partials to scratch.
template <int DP, int DV, bool SPLITS>
__global__ void __launch_bounds__(THREADS, 2)
fa_sm90_kernel(const __grid_constant__ CUtensorMap tmk,
               const __grid_constant__ CUtensorMap tmv, const Params p) {
  using SM = Smem<DP, DV, !SPLITS>;
  constexpr int NB = DP / 64;      // 64-column boxes per Q or K row
  constexpr int NBV = DV / 64;     // 64-column boxes per V row
  constexpr int NACC = DV / 2;     // P V accumulators per thread
  extern __shared__ __align__(1024) uint8_t gsm[];
  const uint32_t base = smem_u32(gsm);
  if (base & 1023u) __trap();
  const uint32_t sQ = base + SM::Q, sK = base + SM::K, sV = base + SM::V;
  // K and V rings with their own barriers: a K stage is released as soon
  // as S has read it, a V stage once P V has
  const uint32_t kfull = base + SM::BAR, kempty = kfull + STAGES * 8;
  const uint32_t vfull = kempty + STAGES * 8, vempty = vfull + STAGES * 8;

  // The work item (query tile, batch row x KV head) of this CTA: by rank
  // r, longest causal tiles first.  The first wave (one CTA per SM) takes
  // the longest, the second the shortest, so the two CTAs that share an
  // SM add up to about the mean; the rest follow longest first.
  const int n_qt = gridDim.x, n = gridDim.x * gridDim.y;
  const int lin = blockIdx.y * n_qt + blockIdx.x;
  const int w = p.wave;
  const int rank = lin < w ? lin : lin < 2 * w ? n - 1 - (lin - w) : lin - w;
  const int bh = rank % gridDim.y;
  const int b = bh / p.Hkv;
  const int hk = bh % p.Hkv;
  const int q0 = (n_qt - 1 - rank / gridDim.y) * p.qp;  // first position
  const int last = min(q0 + p.qp, p.Sq) - 1;     // last query position
  const int kvl = p.kv_len ? p.kv_len[b] : p.kv_len_val;
  const int qoff = p.q_offset ? p.q_offset[b] : p.q_offset_val;
  const int kv_lim = max(0, min(kvl, p.Skv));
  int n_keys = kv_lim;
  if (p.causal) n_keys = max(0, min(n_keys, qoff + last + 1));
  const int n_tiles = (n_keys + BK - 1) / BK;
  int t_begin = 0, t_end = n_tiles;
  if constexpr (SPLITS) {
    t_begin = min((int)blockIdx.z * TPS, n_tiles);
    t_end = min(t_begin + TPS, n_tiles);
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(kfull + 8 * s, 1);
      mbar_init(kempty + 8 * s, CONSUMERS);
      mbar_init(vfull + 8 * s, 1);
      mbar_init(vempty + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer: one thread keeps the ring full
    if (threadIdx.x == CONSUMERS) {
      for (int i = 0; i < t_end - t_begin; ++i) {
        const int t = t_begin + i, st = i % STAGES;
        // round i / STAGES of a stage; a fresh barrier's previous phase
        // counts as done, so round 0 passes at once
        const uint32_t parity = ((i / STAGES) & 1) ^ 1;
        mbar_wait(kempty + 8 * st, parity);
        mbar_expect_tx(kfull + 8 * st, SM::KT);
#pragma unroll
        for (int j = 0; j < NB; ++j)
          tma_load(sK + st * SM::KT + j * BOX, &tmk, kfull + 8 * st, 64 * j,
                   t * BK, hk, b);
        mbar_wait(vempty + 8 * st, parity);
        mbar_expect_tx(vfull + 8 * st, SM::VT);
#pragma unroll
        for (int j = 0; j < NBV; ++j)
          tma_load(sV + st * SM::VT + j * BOX, &tmv, vfull + 8 * st, 64 * j,
                   t * BK, hk, b);
      }
    }
    return;
  }

  // ---- consumers: one warpgroup
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rows_used = p.qp * p.group;

  // The Q tile into shared memory in the layout TMA's 128-byte swizzle
  // gives (16-byte chunk c of row r at chunk c ^ (r % 8)); rows past the
  // tile's positions and columns past D are zeros.
  {
    constexpr int CH = DP / 8;
    for (int c = tid; c < BM * CH; c += CONSUMERS) {
      const int r = c / CH, ch = c % CH;
      const int pos = q0 + r / p.group;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows_used && pos < p.Sq && ch * 8 < p.D) {
        const int h = hk * p.group + r % p.group;
        val = *reinterpret_cast<const uint4*>(p.q + b * p.qb + h * p.qh +
                                              pos * p.qs + ch * 8);
      }
      *reinterpret_cast<uint4*>(gsm + SM::Q + (ch >> 3) * BOX + r * 128 +
                                (((ch & 7) ^ (r & 7)) << 4)) = val;
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");

  // Accumulator layout of m64nN: register i of this thread holds row
  // rw[(i >> 1) & 1], column 8 (i >> 2) + cq + (i & 1).
  const int rw[2] = {warp * 16 + (lane >> 2), warp * 16 + (lane >> 2) + 8};
  const int cq = 2 * (lane & 3);
  int qpos[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) qpos[ri] = qoff + q0 + rw[ri] / p.group;

  float m[2], l[2], acc[NACC];    // the current split
  float m_done[2], l_done[2];     // the split that just ended
  float M[2], L[2];               // merged splits (fused form)
  // the fused form's merged accumulators, element i of this thread at
  // accs[i * CONSUMERS + tid]
  float* accs = reinterpret_cast<float*>(gsm + SM::ACC);
  float s[32];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    m[ri] = M[ri] = NEG_INF;
    l[ri] = L[ri] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  if constexpr (!SPLITS) {
#pragma unroll
    for (int i = 0; i < NACC; ++i) accs[i * CONSUMERS + tid] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;

  // S of this CTA's i-th tile into d: wgmma over the padded head dim, 16
  // columns per instruction, committed as one group and not waited for
  auto issue_s = [&](float (&d)[32], int i) {
    const int st = i % STAGES;
    mbar_wait(kfull + 8 * st, (i / STAGES) & 1);
    const uint32_t kt = sK + st * SM::KT;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk >> 2) * BOX + (kk & 3) * 32;
      wgmma_ss_n64(d, sw128_desc(sQ + off, 16, 1024),
                   sw128_desc(kt + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
  };

  // Software pipeline, per tile t: S of tile t + 1 and P V of tile t - 1
  // run on the tensor cores while the softmax of tile t runs on the CUDA
  // cores.  wgmma groups complete in commit order.
  auto merge_split = [&]() {   // fold the finished split into (M, L, accs)
    if constexpr (!SPLITS) {
      float wa[2], wb[2];
#pragma unroll
      for (int ri = 0; ri < 2; ++ri)
        merge_ml(M[ri], L[ri], m_done[ri], l_done[ri], wa[ri], wb[ri]);
#pragma unroll
      for (int i = 0; i < NACC; ++i) {
        const int ri = (i >> 1) & 1;
        float* x = accs + i * CONSUMERS + tid;
        *x = merge_acc(*x, wa[ri], acc[i], wb[ri]);
      }
    }
  };
  float s_next[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s_next[i] = 0.f;
  const int n_t = t_end - t_begin;
  if (n_t > 0) {
    issue_s(s, 0);
    wgmma_wait<0>();
    fence_regs(s);
    mbar_arrive(kempty);
  }
  for (int it = 0; it < n_t; ++it) {
    const int t = t_begin + it, st = it % STAGES;
    const bool more = it + 1 < n_t;
    if (more) issue_s(s_next, it + 1);
    if (t % TPS == 0) {   // a split starts from (-1e30, 0, 0)
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        m_done[ri] = m[ri];
        l_done[ri] = l[ri];
        m[ri] = NEG_INF;
        l[ri] = 0.f;
      }
    }

    // online softmax of this tile, log2 domain; a tile that every row of
    // the CTA sees whole needs no mask (the same arithmetic otherwise)
    const bool whole = (t + 1) * BK <= kv_lim &&
                       (!p.causal || (t + 1) * BK - 1 <= qoff + q0);
    const int kb = t * BK + cq;
    float mx[2] = {NEG_INF, NEG_INF};
    uint32_t ok = 0xffffffffu;
    if (!whole) {
      ok = 0;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int kp = kb + 8 * (i >> 2) + (i & 1);
        const bool vis =
            kp < kv_lim && (!p.causal || kp <= qpos[(i >> 1) & 1]);
        ok |= (uint32_t)vis << i;
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int ri = (i >> 1) & 1;
      s[i] = (ok >> i) & 1u ? __fmul_rn(s[i], p.scale_log2) : NEG_INF;
      mx[ri] = fmaxf(mx[ri], s[i]);
    }
    float rs[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      mx[ri] = fmaxf(mx[ri], __shfl_xor_sync(0xffffffffu, mx[ri], 1));
      mx[ri] = fmaxf(mx[ri], __shfl_xor_sync(0xffffffffu, mx[ri], 2));
      mx[ri] = fmaxf(m[ri], mx[ri]);         // the new running max
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int ri = (i >> 1) & 1;
      s[i] = (ok >> i) & 1u ? ex2(__fsub_rn(s[i], mx[ri])) : 0.f;
      rs[ri] = __fadd_rn(rs[ri], s[i]);
    }
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      rs[ri] = __fadd_rn(rs[ri], __shfl_xor_sync(0xffffffffu, rs[ri], 1));
      rs[ri] = __fadd_rn(rs[ri], __shfl_xor_sync(0xffffffffu, rs[ri], 2));
      alpha[ri] = rescale(m[ri], mx[ri]);
      l[ri] = fmaf(l[ri], alpha[ri], rs[ri]);   // sums the f32 P
      m[ri] = mx[ri];
    }
    // P V of tile t - 1 done: release its V stage, fold a finished split
    if (it > 0) {
      if (more)
        wgmma_wait<1>();
      else
        wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(vempty + 8 * ((it - 1) % STAGES));
      if (t % TPS == 0) {
        merge_split();
#pragma unroll
        for (int j = 0; j < NACC; ++j) acc[j] = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < NACC; ++i)
      acc[i] = __fmul_rn(acc[i], alpha[(i >> 1) & 1]);

    // P (bf16) as the register A operand: the S registers of columns
    // 16 kk .. 16 kk + 15 are the A fragment of k-step kk
    uint32_t pa[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) pa[i] = pack_bf16(s[2 * i], s[2 * i + 1]);

    // acc += P V: 16 keys per instruction, V MN-major (transposed); not
    // waited for here
    mbar_wait(vfull + 8 * st, (it / STAGES) & 1);
    const uint32_t vt = sV + st * SM::VT;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs(acc, pa + 4 * kk, sw128_desc(vt + kk * 16 * 128, BOX, 1024));
    wgmma_commit();
    if (more) {   // S of tile t + 1 done
      wgmma_wait<1>();
      fence_regs(s_next);
      mbar_arrive(kempty + 8 * ((it + 1) % STAGES));
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] = s_next[j];
    }
  }
  if (n_t > 0) {   // the last P V, and the last split
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(vempty + 8 * ((n_t - 1) % STAGES));
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      m_done[ri] = m[ri];
      l_done[ri] = l[ri];
    }
    merge_split();
  }

  // ---- epilogue
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int r = rw[ri];
    const int pos = q0 + r / p.group;
    if (r >= rows_used || pos >= p.Sq) continue;
    const int h = hk * p.group + r % p.group;
    if constexpr (SPLITS) {
      const long long row =
          ((long long)(b * p.Hq + h) * p.Sq + pos) * p.n_split + blockIdx.z;
      if ((lane & 3) == 0) {
        p.part_ml[2 * row] = m[ri];
        p.part_ml[2 * row + 1] = l[ri];
      }
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        const int col = 8 * j + cq;
        if (col < p.Dv)
          *reinterpret_cast<float2*>(p.part_acc + row * p.Dv + col) =
              make_float2(acc[4 * j + 2 * ri], acc[4 * j + 2 * ri + 1]);
      }
    } else {
      __nv_bfloat16* op = p.o + b * p.ob + h * p.oh + pos * p.os;
      const float inv = inv_l(L[ri]);
      if (p.lse != nullptr && (lane & 3) == 0)
        p.lse[(long long)(b * p.Hq + h) * p.lse_ld + pos] =
            row_lse(M[ri], L[ri]);
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        const int col = 8 * j + cq;
        if (col < p.Dv)
          *reinterpret_cast<__nv_bfloat162*>(op + col) =
              L[ri] == 0.f
                  ? mean_v(p, b, hk, col)
                  : __floats2bfloat162_rn(
                        finish(accs[(4 * j + 2 * ri) * CONSUMERS + tid], inv),
                        finish(accs[(4 * j + 2 * ri + 1) * CONSUMERS + tid],
                               inv));
      }
    }
  }
}

// The split form's second launch: one thread per (row, column pair)
// merges the row's n_split partials in increasing key order.
__global__ void __launch_bounds__(256)
fa_merge_kernel(const Params p, long long n_pairs) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n_pairs) return;
  const int half = p.Dv / 2;
  const long long row = i / half;              // (b, h, pos) flattened
  const int col = 2 * (int)(i % half);
  const int pos = (int)(row % p.Sq);
  const long long bh = row / p.Sq;
  const int h = (int)(bh % p.Hq), b = (int)(bh / p.Hq);
  float M = NEG_INF, L = 0.f, a0 = 0.f, a1 = 0.f;
  for (int s = 0; s < p.n_split; ++s) {
    const long long k = row * p.n_split + s;
    float wa, wb;
    merge_ml(M, L, p.part_ml[2 * k], p.part_ml[2 * k + 1], wa, wb);
    const float2 x = *reinterpret_cast<const float2*>(p.part_acc + k * p.Dv +
                                                      col);
    a0 = merge_acc(a0, wa, x.x, wb);
    a1 = merge_acc(a1, wa, x.y, wb);
  }
  const float inv = inv_l(L);
  if (p.lse != nullptr && col == 0)
    p.lse[(long long)(b * p.Hq + h) * p.lse_ld + pos] = row_lse(M, L);
  *reinterpret_cast<__nv_bfloat162*>(p.o + b * p.ob + h * p.oh + pos * p.os +
                                     col) =
      L == 0.f ? mean_v(p, b, h / p.group, col)
               : __floats2bfloat162_rn(finish(a0, inv), finish(a1, inv));
}

// ------------------------------------------------------------ host side

template <int DP, int DV, bool SPLITS>
int launch(const CUtensorMap& mk, const CUtensorMap& mv, const Params& p,
           int B, cudaStream_t stream) {
  static std::atomic<unsigned> opted{0};
  cudaError_t err = opt_in(fa_sm90_kernel<DP, DV, SPLITS>,
                           Smem<DP, DV, !SPLITS>::BYTES, opted);
  int wave = 0;
  if (err == cudaSuccess) err = sm_count(&wave);
  if (err != cudaSuccess) return err;
  Params q = p;
  q.wave = wave;
  const dim3 grid((p.Sq + p.qp - 1) / p.qp, B * p.Hkv,
                  SPLITS ? p.n_split : 1);
  fa_sm90_kernel<DP, DV, SPLITS>
      <<<grid, THREADS, Smem<DP, DV, !SPLITS>::BYTES, stream>>>(mk, mv, q);
  err = cudaGetLastError();
  if (err != cudaSuccess || !SPLITS) return err;
  const long long pairs = (long long)B * p.Hq * p.Sq * (p.Dv / 2);
  fa_merge_kernel<<<(unsigned)((pairs + 255) / 256), 256, 0, stream>>>(
      p, pairs);
  return cudaGetLastError();
}

}  // namespace

// q (B, Hq, Sq, D), k (B, Hkv, Skv, D), v (B, Hkv, Skv, Dv), o (B, Hq, Sq,
// Dv), bf16, each addressed by the (batch, head, seq) element strides in
// `strides` (a host array of 12: q, k, v, o), last dim dense.  Dv = D in
// {16, 32, 64, 128}, or Dv in {16, 32, 64} under D a multiple of 8 in
// (Dv, 128].  kv_len and q_offset are int32 (B,) device arrays, or null
// to use kv_len_val / q_offset_val for every row.  scale_log2 = log2(e) /
// sqrt(D).  scratch null: the fused form; else the split form, scratch
// holding B Hq Sq n_split (Dv + 2) floats and n_split = ceil(Skv / 128).
// lse null: the serving path;
// else each row's statistic for the backward (row_lse) goes to
// lse[(b * Hq + h) * lse_ld + pos], float32.  Returns 0, a cudaError_t, or
// 1000 (no tensor-map encoder) / 2000 + CUresult (encoding refused).
extern "C" int restore_flash_attention_sm90(
    const void* q, const void* k, const void* v, void* o, const int* kv_len,
    const int* q_offset, int kv_len_val, int q_offset_val, int B, int Hq,
    int Hkv, int Sq, int Skv, int D, int Dv, const long long* strides,
    int causal, float scale_log2, void* scratch, int n_split, float* lse,
    int lse_ld, void* stream) {
  const bool dv_ok = Dv == 16 || Dv == 32 || Dv == 64 || Dv == 128;
  const bool dims_ok =
      dv_ok && (Dv == D || (D % 8 == 0 && Dv < D && D <= 128));
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq < 0 || Skv < 0 ||
      Hq / Hkv > BM || !dims_ok)
    return (int)cudaErrorInvalidValue;
  if (scratch != nullptr &&
      (Skv == 0 || n_split != (Skv + SPLIT - 1) / SPLIT))
    return (int)cudaErrorInvalidValue;
  if (lse != nullptr && lse_ld < Sq) return (int)cudaErrorInvalidValue;
  if (Sq == 0) return 0;
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.part_acc = static_cast<float*>(scratch);
  p.part_ml = scratch == nullptr
                  ? nullptr
                  : p.part_acc + (long long)B * Hq * Sq * n_split * Dv;
  p.kv_len = kv_len;
  p.q_offset = q_offset;
  p.qb = strides[0]; p.qh = strides[1]; p.qs = strides[2];
  p.vb = strides[6]; p.vh = strides[7]; p.vs = strides[8];
  p.ob = strides[9]; p.oh = strides[10]; p.os = strides[11];
  p.kv_len_val = kv_len_val;
  p.q_offset_val = q_offset_val;
  p.Hq = Hq; p.Hkv = Hkv; p.group = Hq / Hkv;
  p.Sq = Sq; p.Skv = Skv; p.D = D; p.Dv = Dv;
  p.qp = BM / p.group;
  p.wave = 0;
  p.n_split = scratch == nullptr ? 0 : n_split;
  p.causal = causal;
  p.lse = lse;
  p.lse_ld = lse_ld;
  p.scale_log2 = scale_log2;
  CUtensorMap mk, mv;
  memset(&mk, 0, sizeof(mk));
  memset(&mv, 0, sizeof(mv));
  if (Skv > 0) {   // with no keys no tile is loaded
    int rc = tile_map(&mk, k, B, Hkv, Skv, D, strides[3], strides[4],
                      strides[5]);
    if (rc == 0)
      rc = tile_map(&mv, v, B, Hkv, Skv, Dv, strides[6], strides[7],
                    strides[8]);
    if (rc != 0) return rc;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D > 64 && Dv > 64)
    return scratch ? launch<128, 128, true>(mk, mv, p, B, s)
                   : launch<128, 128, false>(mk, mv, p, B, s);
  if (D > 64)
    return scratch ? launch<128, 64, true>(mk, mv, p, B, s)
                   : launch<128, 64, false>(mk, mv, p, B, s);
  return scratch ? launch<64, 64, true>(mk, mv, p, B, s)
                 : launch<64, 64, false>(mk, mv, p, B, s);
}
