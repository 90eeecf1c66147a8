// The gradient of causal online-softmax attention for Hopper (sm_90a):
// dQ, dK and dV of  O = softmax(Q K^T / sqrt(D) + mask) V.  bf16 runs on
// the tensor cores (the sm90 kernels below); float32 keeps the first
// kernel's CUDA-core passes (namespace simt).
//
// No TPU kernel stands behind it: the reference differentiates its plain
// attention (src/repro/models/layers.py::_sdpa) with JAX's autodiff, and
// its Pallas kernel (flash_attention.py::flash_attention_bhsd) has no
// backward.  The function is the gradient of the port's forward kernels
// (flash_attention.cu, flash_attention_sm90.cu) as the plain version
// (kernels/flash_attention/ref.py::mha_ref, under autograd) defines it:
//   * scores s = q.k * scale with scale = 1/sqrt(D); keys at or beyond the
//     row's kv_len and, causally, keys after the query's position are
//     masked, and a masked score has no gradient;
//   * P = softmax(s), dP = dO V^T, dS = P * (dP - rowsum(dO * O)),
//     dQ = scale * dS K, dK = scale * dS^T Q, dV = P^T dO;
//   * a row that sees no key (kv_len <= 0, or causal before every key)
//     returned the mean of V: its P is 1/Skv over every key, so it adds
//     dO / Skv to every key's dV and nothing to dQ or dK;
//   * GQA: query head h reads KV head h / (Hq / Hkv), so each KV head's
//     dK and dV sum over its group of query heads.
//
// Bound on this card: 10 * D operations per visible query-key pair (five
// products: S, dP, dQ, dK, dV) at 989 TFLOP/s bf16, against the bytes of
// q, k, v, O, dO, dQ, dK and dV read or written once.  At the trainer's
// 8 x 1024 tokens (16/8 heads x 128, causal) the operations bound it
// (0.087 ms); at 8 x 64 the bytes (0.004 ms), and there launches and
// latency set the time.
//
// bf16 design (two launches on the caller's stream, no atomics: the sums
// run in a fixed order, so two calls give the same bits).
//   * The forward saves each row's lse = m + ln(l) (natural log, +inf for
//     a row that sees no key; flash_attention_sm90.cu), so nothing here
//     recomputes the row statistics: P = exp(s - lse) directly.
//   * Launch 1, dQ (bwd_dq_kernel): one CTA per (batch row, KV head, 64
//     query rows), the GQA group folded into the tile's rows as in the
//     forward, so K and V are read once per KV head.  It stages Q and dO
//     once (128-byte swizzled, as TMA writes them) and computes each
//     row's delta = rowsum(dO * O) on the way, writing it to scratch for
//     launch 2.  A producer warp streams K and V tiles by TMA into two
//     mbarrier rings.  Per 64-key tile: S = Q K^T and dP = dO V^T by
//     wgmma m64n64k16; P = exp2(S log2(e)/sqrt(D) - lse log2(e)), masked
//     probabilities exactly 0; dS = P (dP - delta) rounded to bf16 in
//     registers as the A operand of dQ += dS K (K MN-major).  dQ is
//     recomputed per query tile instead of summed over key tiles, so it
//     needs no atomics and no reduction pass: 14 D operations per
//     visible pair in all, against the 10 D the bound counts.
//   * Launch 2, dK and dV (bwd_dkv_kernel): one CTA per (batch row, KV
//     head, 64 keys), causal key tile 0 (the longest) first.  K and V are
//     loaded once by TMA; the producer warp streams, for each query head
//     of the group and each query tile that can see these keys, the Q and
//     dO tiles and the tile's lse and delta by TMA into a ring of stages
//     with `full` (TMA bytes) and `empty` (128 consumer arrivals)
//     mbarriers.  Per tile: S^T = K Q^T and dP^T = V dO^T by wgmma;
//     P^T = exp(S^T - lse); dV += P^T dO with P^T rounded to bf16 in
//     registers (dO MN-major), issued before dS^T = P^T (dP^T - delta) is
//     computed, then dK += dS^T Q.  dK and dV stay in f32 registers
//     across the whole walk, the group's heads summed in order.
//   * Rows that see no key are found by lse = +inf in the query tiles
//     that can hold them (kv_len <= 0, or causal rows before key 0): their
//     P^T is 1/Skv on every key and their dS^T is 0.
//   * Two padded widths, as in the forward: DP for Q and K (S = Q K^T,
//     dQ, dK) and DV for V and dO (dP = dO V^T, dV, delta).  Head dims
//     16, 32 and 64 run (64, 64), 128 runs (128, 128) (TMA fills the
//     columns past D with zeros), and MLA (minicpm3: a query/key head dim
//     of 96, a value head dim of 64) runs (128, 64): S and dQ, dK at 128
//     columns with Q and K zero past 96, dP, dV and P^T dO at 64; the
//     scale is 1/sqrt(96), and dQ and dK are written in their 96 columns
//     only.  The dK, dV kernel then holds 64 + 32 accumulators a thread
//     instead of 64 + 64.
//
// Measured on an H100 (kernels/flash_attention/bench.py, graph-replayed):
// at 8 x 1024 the two launches take 0.18 ms (dQ) and 0.21 ms (dK, dV),
// the tensor cores busy about a third of the time.  Each warpgroup's
// chain of wgmma, waits and elementwise work runs in series, and one
// warpgroup per SM holds dK and dV (254 registers); the last product of
// each item (dK += dS^T Q), waited for at once, costs the most.  Tried
// and measured slower or no faster: issuing the next item's products
// before this item's are waited for (ptxas then serializes the wgmma
// pipeline, or it gains nothing), two consumer warpgroups with
// setmaxnreg (ptxas still gives them at most 168 registers and spills),
// two dQ warpgroups sharing one K, V ring, one dQ CTA per SM instead of
// two, Q and dO as register operands of the dQ kernel, a K-major B in
// place of the transposed one, and deeper rings.  Left for later:
// 128-key tiles with dK and dV split over two warpgroups, a persistent
// grid, and dQ folded into the dK, dV walk by a fixed-order reduction.
//
// float32 design (namespace simt, the first kernel): three launches, all
// math on the CUDA cores from shared memory.  1. stats: one CTA per
// (batch, query head, 64 query rows) recomputes each row's max and sum
// and stores lse and delta in float32 scratch; 2. dQ: the same CTAs walk
// their visible 64-key tiles and accumulate dQ = dS K in registers;
// 3. dK, dV: one CTA per (batch, KV head, 64 keys) walks the group's query
// heads and their query tiles in order.  256 threads: 16 row groups (ty)
// x 16 column lanes (tx); tiles in shared memory in rows padded to an odd
// stride.  Given the caller's lse (the forward's, or chunked attention's
// merged statistic, which no single call could recompute), pass 1 skips
// its walk over the keys and writes delta only.  Two widths, as in the
// forward kernel: Q and K staged at D, the least of 16, 32, 64 and 128
// that holds the query/key head dim (the columns past it zero, which
// leaves every dot product's bits as they are), V and dO at the value
// head dim DV, so MLA's (24, 16) and (96, 64) run as (32, 16) and
// (128, 64); dQ and dK are written in their real columns only.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <atomic>

#include "sm90_common.cuh"

namespace {

// ================================================= float32: CUDA cores
namespace simt {


constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;         // query rows per tile
constexpr int BK = 64;         // keys per tile
constexpr int THREADS = 256;   // 16 row groups (ty) x 16 column lanes (tx)

struct Strides {   // (batch, head, seq) element strides; last dim dense
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os, db, dh, ds;
};

struct Args {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  float *lse, *delta;             // (B, Hq, Sq) float32: lse at row stride
                                  // lse_ld, delta dense
  const int *kv_len, *q_offset;   // (B,) on the device, or null: the _val
  int kv_len_val, q_offset_val, B, Hq, Hkv, Sq, Skv;
  int Dqk;          // query/key head dim, at most the staged width D
  int lse_ld;       // row stride of lse
  int lse_given;    // 1: lse holds the caller's statistics; pass 1 then
                    // computes delta only
  Strides st;
  int causal;
  float scale;
};

// The element type T is float32 only (bf16 takes the sm90 kernels); the
// conversions keep the passes written for any T.
__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}

// `rows` rows of `cols` elements of T (row stride `rs` elements) ->
// float32 shared rows of D elements at stride `ld`; rows at or beyond
// `valid`, and the columns from `cols` to D, are zero-filled.  16-byte
// loads (`cols` a multiple of 16 / sizeof(T)): the wrapper checks the
// alignment.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long long rs, int valid, int cols) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = D / VEC;
  for (int c = threadIdx.x; c < ROWS * CHUNKS; c += THREADS) {
    const int r = c / CHUNKS;
    const int e0 = (c % CHUNKS) * VEC;
    float* d = dst + r * ld + e0;
    if (r < valid && e0 < cols) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + r * rs + e0);
      const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < VEC; ++i) d[i] = to_f(x[i]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) d[i] = 0.f;
    }
  }
}

struct RowCtx {       // what a (batch row, head) block needs of the masks
  int qoff, kv_lim;
};

__device__ __forceinline__ RowCtx row_ctx(const Args& a, int b) {
  RowCtx c;
  c.qoff = a.q_offset ? a.q_offset[b] : a.q_offset_val;
  c.kv_lim = min(a.kv_len ? a.kv_len[b] : a.kv_len_val, a.Skv);
  return c;
}

// keys a block of query rows [q0, q0 + rows) can see, as the forward
// kernel bounds them
__device__ __forceinline__ int n_key_tiles(const Args& a, RowCtx c, int q0,
                                           int rows) {
  int n_keys = c.kv_lim;
  if (a.causal) n_keys = min(n_keys, c.qoff + q0 + rows);
  return n_keys > 0 ? (n_keys + BK - 1) / BK : 0;
}

// ---------------------------------------------------------------- pass 1
// Each row's lse (unless given) and delta = rowsum(dO * O).
template <typename T, int D, int DV>
__global__ void __launch_bounds__(THREADS)
bwd_stats_kernel(Args a) {
  constexpr int LD = D + 1, RI = BQ / 16, CJV = DV / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LD;
  const int b = blockIdx.y / a.Hq, h = blockIdx.y % a.Hq;
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = blockIdx.x * BQ;
  const int rows = min(BQ, a.Sq - q0);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const RowCtx c = row_ctx(a, b);
  const Strides& st = a.st;
  const T* kp = static_cast<const T*>(a.k) + b * st.kb + hk * st.kh;

  float m[RI], l[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
  }
  const int n_tiles = a.lse_given ? 0 : n_key_tiles(a, c, q0, rows);
  if (n_tiles > 0)
    load_tile<T, D, BQ>(Qs, LD, static_cast<const T*>(a.q) + b * st.qb +
                        h * st.qh + q0 * st.qs, st.qs, rows, a.Dqk);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();
    load_tile<T, D, BK>(Ks, LD, kp + k0 * st.ks, st.ks, a.Skv - k0, a.Dqk);
    __syncthreads();
    float s[RI][4];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RI], kv[4];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int q_pos = c.qoff + q0 + ty + 16 * i;
      float mx = NEG_INF;
      bool ok[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k0 + tx + 16 * j;
        ok[j] = k_pos < c.kv_lim && (!a.causal || k_pos <= q_pos);
        s[i][j] = ok[j] ? __fmul_rn(s[i][j], a.scale) : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        rs = __fadd_rn(rs, ok[j] ? expf(__fsub_rn(s[i][j], m_new)) : 0.f);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs = __fadd_rn(rs, __shfl_xor_sync(0xffffffffu, rs, off));
      l[i] = fmaf(l[i], expf(__fsub_rn(m[i], m_new)), rs);
      m[i] = m_new;
    }
  }

  // delta = rowsum(dO * O): lanes tx split each row's DV columns
  const T* op = static_cast<const T*>(a.o) + b * st.ob + h * st.oh;
  const T* dp = static_cast<const T*>(a.dout) + b * st.db + h * st.dh;
  const long long bh = (long long)b * a.Hq + h;
  const long long row0 = bh * a.Sq + q0;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i;
    float acc = 0.f;
    if (r < rows) {
#pragma unroll
      for (int cc = 0; cc < CJV; ++cc) {
        const int e = tx + 16 * cc;
        acc = fmaf(to_f(dp[(q0 + r) * st.ds + e]),
                   to_f(op[(q0 + r) * st.os + e]), acc);
      }
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    if (r < rows && tx == 0) {
      if (!a.lse_given)
        a.lse[bh * a.lse_ld + q0 + r] =
            l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
      a.delta[row0 + r] = acc;
    }
  }
}

// ---------------------------------------------------------------- pass 2
template <typename T, int D, int DV>
__global__ void __launch_bounds__(THREADS)
bwd_dq_kernel(Args a) {
  constexpr int LD = D + 1, LDV = DV + 1, LDS = BK + 1, RI = BQ / 16;
  constexpr int CJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LDV;
  float* Vs = Ks + BK * LD;
  float* dSs = Vs + BK * LDV;
  const int b = blockIdx.y / a.Hq, h = blockIdx.y % a.Hq;
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = blockIdx.x * BQ;
  const int rows = min(BQ, a.Sq - q0);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const RowCtx c = row_ctx(a, b);
  const Strides& st = a.st;
  const T* kp = static_cast<const T*>(a.k) + b * st.kb + hk * st.kh;
  const T* vp = static_cast<const T*>(a.v) + b * st.vb + hk * st.vh;
  load_tile<T, D, BQ>(Qs, LD, static_cast<const T*>(a.q) + b * st.qb +
                      h * st.qh + q0 * st.qs, st.qs, rows, a.Dqk);
  load_tile<T, DV, BQ>(dOs, LDV, static_cast<const T*>(a.dout) + b * st.db +
                       h * st.dh + q0 * st.ds, st.ds, rows, DV);
  const long long bh = (long long)b * a.Hq + h;
  const long long row0 = bh * a.Sq + q0;
  float lse[RI], del[RI], acc[RI][CJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i;
    lse[i] = r < rows ? a.lse[bh * a.lse_ld + q0 + r] : INFINITY;
    del[i] = r < rows ? a.delta[row0 + r] : 0.f;
#pragma unroll
    for (int cc = 0; cc < CJ; ++cc) acc[i][cc] = 0.f;
  }

  const int n_tiles = n_key_tiles(a, c, q0, rows);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();
    load_tile<T, D, BK>(Ks, LD, kp + k0 * st.ks, st.ks, a.Skv - k0, a.Dqk);
    load_tile<T, DV, BK>(Vs, LDV, vp + k0 * st.vs, st.vs, a.Skv - k0, DV);
    __syncthreads();
    float s[RI][4], dp[RI][4];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RI], kv[4];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll 4
    for (int d = 0; d < DV; ++d) {
      float gv[RI], vv[4];
#pragma unroll
      for (int i = 0; i < RI; ++i) gv[i] = dOs[(ty + 16 * i) * LDV + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) vv[j] = Vs[(tx + 16 * j) * LDV + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 16 * i;
      const int q_pos = c.qoff + q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k0 + tx + 16 * j;
        const bool ok = k_pos < c.kv_lim && (!a.causal || k_pos <= q_pos);
        const float p = ok ? expf(__fsub_rn(__fmul_rn(s[i][j], a.scale),
                                            lse[i])) : 0.f;
        dSs[r * LDS + tx + 16 * j] = __fmul_rn(p, __fsub_rn(dp[i][j],
                                                            del[i]));
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float sv[RI], kv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) sv[i] = dSs[(ty + 16 * i) * LDS + kk];
#pragma unroll
      for (int cc = 0; cc < CJ; ++cc) kv[cc] = Ks[kk * LD + tx + 16 * cc];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int cc = 0; cc < CJ; ++cc)
          acc[i][cc] = fmaf(sv[i], kv[cc], acc[i][cc]);
    }
  }

  // dQ is dense (B, Hq, Sq, Dqk); the staged columns past Dqk are not
  // written
  T* dq = static_cast<T*>(a.dq) + row0 * a.Dqk;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int cc = 0; cc < CJ; ++cc) {
      const int e = tx + 16 * cc;
      if (r < rows && e < a.Dqk)
        dq[r * a.Dqk + e] = from_f<T>(__fmul_rn(acc[i][cc], a.scale));
    }
  }
}

// ---------------------------------------------------------------- pass 3
template <typename T, int D, int DV>
__global__ void __launch_bounds__(THREADS)
bwd_dkv_kernel(Args a) {
  constexpr int LD = D + 1, LDV = DV + 1, LDP = BQ + 1, RI = BK / 16;
  constexpr int CJ = D / 16, CJV = DV / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LDV;
  float* dOs = Qs + BQ * LD;
  float* Ps = dOs + BQ * LDV;
  float* dSs = Ps + BK * LDP;
  float* lse_s = dSs + BK * LDP;
  float* del_s = lse_s + BQ;
  const int b = blockIdx.y / a.Hkv, hk = blockIdx.y % a.Hkv;
  const int group = a.Hq / a.Hkv;
  const int k0 = blockIdx.x * BK;
  const int keys = min(BK, a.Skv - k0);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const RowCtx c = row_ctx(a, b);
  const Strides& st = a.st;
  load_tile<T, D, BK>(Ks, LD, static_cast<const T*>(a.k) + b * st.kb +
                      hk * st.kh + k0 * st.ks, st.ks, keys, a.Dqk);
  load_tile<T, DV, BK>(Vs, LDV, static_cast<const T*>(a.v) + b * st.vb +
                       hk * st.vh + k0 * st.vs, st.vs, keys, DV);
  const float inv_skv = 1.f / (float)a.Skv;
  float acc_k[RI][CJ], acc_v[RI][CJV];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
#pragma unroll
    for (int cc = 0; cc < CJ; ++cc) acc_k[i][cc] = 0.f;
#pragma unroll
    for (int cc = 0; cc < CJV; ++cc) acc_v[i][cc] = 0.f;
  }

  const int n_qt = (a.Sq + BQ - 1) / BQ;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const T* qp = static_cast<const T*>(a.q) + b * st.qb + h * st.qh;
    const T* gp = static_cast<const T*>(a.dout) + b * st.db + h * st.dh;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      const int rows = min(BQ, a.Sq - q0);
      // the tile adds something when one of its rows sees one of these
      // keys, or when one of its rows sees no key (its dV share)
      const bool sees = k0 < c.kv_lim &&
                        (!a.causal || c.qoff + q0 + rows - 1 >= k0);
      const bool blind = c.kv_lim <= 0 || (a.causal && c.qoff + q0 < 0);
      if (!sees && !blind) continue;
      __syncthreads();
      load_tile<T, D, BQ>(Qs, LD, qp + q0 * st.qs, st.qs, rows, a.Dqk);
      load_tile<T, DV, BQ>(dOs, LDV, gp + q0 * st.ds, st.ds, rows, DV);
      const long long bh = (long long)b * a.Hq + h;
      const long long row0 = bh * a.Sq + q0;
      for (int r = threadIdx.x; r < BQ; r += THREADS) {
        lse_s[r] = r < rows ? a.lse[bh * a.lse_ld + q0 + r] : INFINITY;
        del_s[r] = r < rows ? a.delta[row0 + r] : 0.f;
      }
      __syncthreads();
      float s[RI][4], dp[RI][4];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[RI], qv[4];
#pragma unroll
        for (int i = 0; i < RI; ++i) kv[i] = Ks[(ty + 16 * i) * LD + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) qv[j] = Qs[(tx + 16 * j) * LD + d];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
      }
#pragma unroll 4
      for (int d = 0; d < DV; ++d) {
        float vv[RI], gv[4];
#pragma unroll
        for (int i = 0; i < RI; ++i) vv[i] = Vs[(ty + 16 * i) * LDV + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) gv[j] = dOs[(tx + 16 * j) * LDV + d];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(vv[i], gv[j], dp[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int kr = ty + 16 * i;
        const int k_pos = k0 + kr;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tx + 16 * j;
          const int q_pos = c.qoff + q0 + r;
          const bool row_ok = r < rows && k_pos < a.Skv;
          const bool no_key = c.kv_lim <= 0 || (a.causal && q_pos < 0);
          const bool ok = k_pos < c.kv_lim && (!a.causal || k_pos <= q_pos);
          float p = 0.f, ds = 0.f;
          if (row_ok && no_key) {
            p = inv_skv;
          } else if (row_ok && ok) {
            p = expf(__fsub_rn(__fmul_rn(s[i][j], a.scale), lse_s[r]));
            ds = __fmul_rn(p, __fsub_rn(dp[i][j], del_s[r]));
          }
          Ps[kr * LDP + r] = p;
          dSs[kr * LDP + r] = ds;
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int rr = 0; rr < BQ; ++rr) {
        float pv[RI], sv[RI], gv[CJV], qv[CJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          pv[i] = Ps[(ty + 16 * i) * LDP + rr];
          sv[i] = dSs[(ty + 16 * i) * LDP + rr];
        }
#pragma unroll
        for (int cc = 0; cc < CJV; ++cc) gv[cc] = dOs[rr * LDV + tx + 16 * cc];
#pragma unroll
        for (int cc = 0; cc < CJ; ++cc) qv[cc] = Qs[rr * LD + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
#pragma unroll
          for (int cc = 0; cc < CJV; ++cc)
            acc_v[i][cc] = fmaf(pv[i], gv[cc], acc_v[i][cc]);
#pragma unroll
          for (int cc = 0; cc < CJ; ++cc)
            acc_k[i][cc] = fmaf(sv[i], qv[cc], acc_k[i][cc]);
        }
      }
    }
  }

  // dK dense (B, Hkv, Skv, Dqk), dV dense (B, Hkv, Skv, DV)
  const long long key0 = ((long long)b * a.Hkv + hk) * a.Skv + k0;
  T* dk = static_cast<T*>(a.dk) + key0 * a.Dqk;
  T* dv = static_cast<T*>(a.dv) + key0 * DV;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int kr = ty + 16 * i;
    if (kr >= keys) continue;
#pragma unroll
    for (int cc = 0; cc < CJ; ++cc) {
      const int e = tx + 16 * cc;
      if (e < a.Dqk)
        dk[kr * a.Dqk + e] = from_f<T>(__fmul_rn(acc_k[i][cc], a.scale));
    }
#pragma unroll
    for (int cc = 0; cc < CJV; ++cc)
      dv[kr * DV + tx + 16 * cc] = from_f<T>(acc_v[i][cc]);
  }
}

template <int D>
constexpr size_t stats_smem() { return sizeof(float) * (BQ + BK) * (D + 1); }
template <int D, int DV>
constexpr size_t dq_smem() {
  return sizeof(float) * ((BQ + BK) * (D + 1 + DV + 1) + BQ * (BK + 1));
}
template <int D, int DV>
constexpr size_t dkv_smem() {
  return sizeof(float) * ((BQ + BK) * (D + 1 + DV + 1) + 2 * BK * (BQ + 1)
                          + 2 * BQ);
}

template <typename T, int D, int DV>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  static std::atomic<unsigned> opted_stats{0}, opted_dq{0}, opted_dkv{0};
  cudaError_t err;
  if ((err = opt_in(bwd_stats_kernel<T, D, DV>, stats_smem<D>(),
                    opted_stats)))
    return err;
  if ((err = opt_in(bwd_dq_kernel<T, D, DV>, dq_smem<D, DV>(), opted_dq)))
    return err;
  if ((err = opt_in(bwd_dkv_kernel<T, D, DV>, dkv_smem<D, DV>(), opted_dkv)))
    return err;
  const dim3 qgrid((a.Sq + BQ - 1) / BQ, a.B * a.Hq);
  bwd_stats_kernel<T, D, DV><<<qgrid, THREADS, stats_smem<D>(), stream>>>(a);
  if ((err = cudaGetLastError())) return err;
  bwd_dq_kernel<T, D, DV><<<qgrid, THREADS, dq_smem<D, DV>(), stream>>>(a);
  if ((err = cudaGetLastError())) return err;
  if (a.Skv > 0) {
    const dim3 kgrid((a.Skv + BK - 1) / BK, a.B * a.Hkv);
    bwd_dkv_kernel<T, D, DV><<<kgrid, THREADS, dkv_smem<D, DV>(), stream>>>(
        a);
  }
  return cudaGetLastError();
}

// the staged width D for Dqk, and DV <= D from 16, 32, 64 and 128
template <int D>
cudaError_t launch_dv(const Args& a, int Dv, cudaStream_t s) {
  switch (Dv) {
    case 16: return launch<float, D, 16>(a, s);
    case 32: if constexpr (D >= 32) return launch<float, D, 32>(a, s); break;
    case 64: if constexpr (D >= 64) return launch<float, D, 64>(a, s); break;
    case 128:
      if constexpr (D >= 128) return launch<float, D, 128>(a, s);
      break;
  }
  return cudaErrorInvalidValue;
}

cudaError_t launch_d(const Args& a, int D, int Dv, cudaStream_t s) {
  if (D <= 0 || D > 128 || D % 8 != 0) return cudaErrorInvalidValue;
  if (D <= 16) return launch_dv<16>(a, Dv, s);
  if (D <= 32) return launch_dv<32>(a, Dv, s);
  if (D <= 64) return launch_dv<64>(a, Dv, s);
  return launch_dv<128>(a, Dv, s);
}

}  // namespace simt

// ======================================================= bf16: sm_90a
namespace sm90 {

constexpr int BQ = 64;                  // query rows per tile
constexpr int BK = 64;                  // keys per tile
constexpr int STAGES = 2;               // ring depth of both kernels
constexpr int CONSUMERS = 128;          // one warpgroup
constexpr int THREADS = CONSUMERS + 32; // + the producer warp
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const __nv_bfloat16 *q, *o, *dout;
  __nv_bfloat16 *dq, *dk, *dv;   // dense (B, H, S, D); dv (B, Hkv, S, Dv)
  const float* lse;              // (B * Hq, ld), the forward's
  float* delta;                  // (B * Hq, ld), written by launch 1
  const int* kv_len;             // (B,) or null: kv_len_val for every row
  const int* q_offset;           // (B,) or null: q_offset_val
  long long qb, qh, qs, ob, oh, os, db, dh, ds;   // o, dout: (.., Dv)
  int kv_len_val, q_offset_val;
  int Hq, Hkv, group, Sq, Skv, D, Dv, ld;   // D of q, k; Dv of v, o
  int qp;                        // query positions per dQ tile: 64 / group
  int wave;                      // the SM count
  int causal;
  float scale_log2;              // log2(e) / sqrt(D)
  float scale;                   // 1 / sqrt(D)
};

__device__ __forceinline__ int kv_limit(const Params& p, int b) {
  return max(0, min(p.kv_len ? p.kv_len[b] : p.kv_len_val, p.Skv));
}
__device__ __forceinline__ int q_off(const Params& p, int b) {
  return p.q_offset ? p.q_offset[b] : p.q_offset_val;
}

// The sum of the products of 8 bf16 pairs, in order.
__device__ __forceinline__ float dot8(const uint4& a, const uint4& b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), w = __bfloat1622float2(y[i]);
    s = fmaf(u.x, w.x, s);
    s = fmaf(u.y, w.y, s);
  }
  return s;
}

// The products over the padded head dim, 16 columns per instruction, of
// two K-major 64-row tiles in shared memory: d = A B^T
template <int DP>
__device__ __forceinline__ void mma_abt(float (&d)[32], uint32_t a,
                                        uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t off = (kk >> 2) * BOX + (kk & 3) * 32;
    wgmma_ss_n64(d, sw128_desc(a + off, 16, 1024),
                 sw128_desc(b + off, 16, 1024), kk > 0);
  }
}

// acc += A B for A a 64 x 64 register fragment (bf16 pairs, the
// accumulator layout of mma_abt) and B a 64-row tile in shared memory
// read MN-major (its rows are the reduction)
template <int N>
__device__ __forceinline__ void mma_rb(float (&acc)[N], const uint32_t* a,
                                       uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs(acc, a + 4 * kk, sw128_desc(b + kk * 16 * 128, BOX, 1024));
}

// ------------------------------------------------------ launch 1: dQ

template <int DP, int DV>
struct DqSmem {
  static constexpr int QT = (DP / 64) * BOX;   // a Q or K tile
  static constexpr int VT = (DV / 64) * BOX;   // a dO or V tile
  static constexpr int Q = 0;
  static constexpr int DO = QT;
  static constexpr int K = QT + VT;
  static constexpr int V = K + STAGES * QT;
  static constexpr int DEL = V + STAGES * VT;
  static constexpr int BAR = DEL + BQ * 4;
  static constexpr int BYTES = BAR + 4 * STAGES * 8;
};

// grid (query tiles, B * Hkv)
template <int DP, int DV>
__global__ void __launch_bounds__(THREADS, 2)
bwd_dq_kernel(const __grid_constant__ CUtensorMap tmk,
              const __grid_constant__ CUtensorMap tmv, const Params p) {
  using SM = DqSmem<DP, DV>;
  constexpr int NB = DP / 64;      // 64-column boxes per Q or K row
  constexpr int NBV = DV / 64;     // 64-column boxes per dO or V row
  constexpr int NACC = DP / 2;     // dQ accumulators per thread
  extern __shared__ __align__(1024) uint8_t gsm[];
  const uint32_t base = smem_u32(gsm);
  if (base & 1023u) __trap();
  const uint32_t sQ = base + SM::Q, sDO = base + SM::DO;
  const uint32_t sK = base + SM::K, sV = base + SM::V;
  const uint32_t kfull = base + SM::BAR, kempty = kfull + STAGES * 8;
  const uint32_t vfull = kempty + STAGES * 8, vempty = vfull + STAGES * 8;
  float* del_s = reinterpret_cast<float*>(gsm + SM::DEL);

  // the work item as the forward picks it: longest causal tiles first,
  // the second wave the shortest
  const int n_qt = gridDim.x, n = gridDim.x * gridDim.y;
  const int lin = blockIdx.y * n_qt + blockIdx.x;
  const int w = p.wave;
  const int rank = lin < w ? lin : lin < 2 * w ? n - 1 - (lin - w) : lin - w;
  const int bh = rank % gridDim.y;
  const int b = bh / p.Hkv, hk = bh % p.Hkv;
  const int q0 = (n_qt - 1 - rank / gridDim.y) * p.qp;  // first position
  const int last = min(q0 + p.qp, p.Sq) - 1;
  const int kv_lim = kv_limit(p, b), qoff = q_off(p, b);
  int n_keys = kv_lim;
  if (p.causal) n_keys = max(0, min(n_keys, qoff + last + 1));
  const int n_t = (n_keys + BK - 1) / BK;

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
    // ---- producer: one thread keeps the K and V rings full
    if (threadIdx.x == CONSUMERS) {
      for (int i = 0; i < n_t; ++i) {
        const int st = i % STAGES;
        const uint32_t parity = ((i / STAGES) & 1) ^ 1;
        mbar_wait(kempty + 8 * st, parity);
        mbar_expect_tx(kfull + 8 * st, SM::QT);
#pragma unroll
        for (int j = 0; j < NB; ++j)
          tma_load(sK + st * SM::QT + j * BOX, &tmk, kfull + 8 * st, 64 * j,
                   i * BK, hk, b);
        mbar_wait(vempty + 8 * st, parity);
        mbar_expect_tx(vfull + 8 * st, SM::VT);
#pragma unroll
        for (int j = 0; j < NBV; ++j)
          tma_load(sV + st * SM::VT + j * BOX, &tmv, vfull + 8 * st, 64 * j,
                   i * BK, hk, b);
      }
    }
    return;
  }

  // ---- consumers: one warpgroup
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rows_used = p.qp * p.group;

  // Q and dO into shared memory in TMA's 128-byte swizzled layout (rows
  // past the tile's positions and columns past D or Dv are zeros), and
  // each row's delta = rowsum(dO * O): the CH threads of a row
  // (consecutive lanes) each sum 8 columns (0 past Dv), then add the parts
  // in a fixed order
  {
    constexpr int CH = DP / 8;   // DV <= DP
    for (int c = tid; c < BQ * CH; c += CONSUMERS) {
      const int r = c / CH, ch = c % CH;
      const int pos = q0 + r / p.group;
      const int h = hk * p.group + r % p.group;
      const bool row = r < rows_used && pos < p.Sq;
      uint4 qv = make_uint4(0u, 0u, 0u, 0u), gv = qv;
      float dl = 0.f;
      if (row && ch * 8 < p.D)
        qv = *reinterpret_cast<const uint4*>(p.q + b * p.qb + h * p.qh +
                                             pos * p.qs + ch * 8);
      if (row && ch * 8 < p.Dv) {
        gv = *reinterpret_cast<const uint4*>(p.dout + b * p.db + h * p.dh +
                                             pos * p.ds + ch * 8);
        dl = dot8(gv, *reinterpret_cast<const uint4*>(
                          p.o + b * p.ob + h * p.oh + pos * p.os + ch * 8));
      }
      const int off = (ch >> 3) * BOX + r * 128 + (((ch & 7) ^ (r & 7)) << 4);
      *reinterpret_cast<uint4*>(gsm + SM::Q + off) = qv;
      if (ch < DV / 8) *reinterpret_cast<uint4*>(gsm + SM::DO + off) = gv;
#pragma unroll
      for (int o = CH / 2; o > 0; o >>= 1)
        dl = __fadd_rn(dl, __shfl_xor_sync(0xffffffffu, dl, o));
      if (ch == 0) {
        del_s[r] = dl;
        if (row) p.delta[(long long)(b * p.Hq + h) * p.ld + pos] = dl;
      }
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");

  // Accumulator layout of m64nN: register i of this thread holds row
  // rw[(i >> 1) & 1], column 8 (i >> 2) + cq + (i & 1).
  const int rw[2] = {warp * 16 + (lane >> 2), warp * 16 + (lane >> 2) + 8};
  const int cq = 2 * (lane & 3);
  int qpos[2];
  float lse2[2], del[2];   // lse in the log2 domain; +inf: no P
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int r = rw[ri], pos = q0 + r / p.group;
    const int h = hk * p.group + r % p.group;
    qpos[ri] = qoff + pos;
    lse2[ri] = r < rows_used && pos < p.Sq
                   ? __fmul_rn(p.lse[(long long)(b * p.Hq + h) * p.ld + pos],
                               LOG2E)
                   : INFINITY;
    del[ri] = del_s[r];
  }

  float dq[NACC], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < NACC; ++i) dq[i] = 0.f;
  for (int it = 0; it < n_t; ++it) {
    const int st = it % STAGES;
    const uint32_t par = (it / STAGES) & 1;
    const uint32_t kt = sK + st * SM::QT, vt = sV + st * SM::VT;
    mbar_wait(kfull + 8 * st, par);
    wgmma_fence();
    mma_abt<DP>(s, sQ, kt);       // S = Q K^T
    wgmma_commit();
    mbar_wait(vfull + 8 * st, par);
    wgmma_fence();
    mma_abt<DV>(dp, sDO, vt);     // dP = dO V^T
    wgmma_commit();

    // which scores are visible; a tile that every row sees whole needs
    // no mask (rows past the tile's positions have lse2 = +inf)
    const int k0 = it * BK;
    const bool whole =
        k0 + BK <= kv_lim && (!p.causal || k0 + BK - 1 <= qoff + q0);
    uint32_t ok = 0xffffffffu;
    if (!whole) {
      ok = 0;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int kp = k0 + cq + 8 * (i >> 2) + (i & 1);
        const bool vis =
            kp < kv_lim && (!p.causal || kp <= qpos[(i >> 1) & 1]);
        ok |= (uint32_t)vis << i;
      }
    }
    wgmma_wait<1>();
    fence_regs(s);
    // P = exp(S - lse); off the whole tiles masked scores are exactly 0
    // (a masked score's exp may overflow: it is replaced, never
    // multiplied)
    const float sl2 = p.scale_log2;
#pragma unroll
    for (int i = 0; i < 32; ++i)
      s[i] = ex2(fmaf(s[i], sl2, -lse2[(i >> 1) & 1]));
    if (!whole) {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = (ok >> i) & 1u ? s[i] : 0.f;
    }
    wgmma_wait<0>();
    fence_regs(dp);
    mbar_arrive(vempty + 8 * st);
    // dS = P (dP - delta), bf16, as the A operand of dQ += dS K
    uint32_t da[16];
#pragma unroll
    for (int m = 0; m < 16; ++m) {
      const float d = del[m & 1];
      da[m] = pack_bf16(__fmul_rn(s[2 * m], __fsub_rn(dp[2 * m], d)),
                        __fmul_rn(s[2 * m + 1], __fsub_rn(dp[2 * m + 1], d)));
    }
    fence_regs(dq);
    wgmma_fence();
    mma_rb(dq, da, kt);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    keep_regs(da);
    mbar_arrive(kempty + 8 * st);
  }

  // ---- epilogue: dQ = scale * dS K, dense (B, Hq, Sq, D)
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int r = rw[ri], pos = q0 + r / p.group;
    if (r >= rows_used || pos >= p.Sq) continue;
    const int h = hk * p.group + r % p.group;
    __nv_bfloat16* out = p.dq + ((long long)(b * p.Hq + h) * p.Sq + pos) * p.D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + cq;
      if (col < p.D)
        *reinterpret_cast<__nv_bfloat162*>(out + col) = __floats2bfloat162_rn(
            __fmul_rn(dq[4 * j + 2 * ri], p.scale),
            __fmul_rn(dq[4 * j + 2 * ri + 1], p.scale));
    }
  }
}

// -------------------------------------------------- launch 2: dK, dV

template <int DP, int DV>
struct DkvSmem {
  static constexpr int QT = (DP / 64) * BOX;   // a Q or K tile
  static constexpr int VT = (DV / 64) * BOX;   // a dO or V tile
  static constexpr int K = 0;
  static constexpr int V = QT;
  static constexpr int Q = QT + VT;
  static constexpr int DO = Q + STAGES * QT;
  static constexpr int ROWS = DO + STAGES * VT;  // lse, delta per stage
  static constexpr int BAR = ROWS + STAGES * 2 * BQ * 4;
  static constexpr int BYTES = BAR + (1 + 2 * STAGES) * 8;
};

// grid (key tiles, B * Hkv)
template <int DP, int DV>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dkv_kernel(const __grid_constant__ CUtensorMap tmk,
               const __grid_constant__ CUtensorMap tmv,
               const __grid_constant__ CUtensorMap tmq,
               const __grid_constant__ CUtensorMap tmdo,
               const __grid_constant__ CUtensorMap tml,
               const __grid_constant__ CUtensorMap tmd, const Params p) {
  using SM = DkvSmem<DP, DV>;
  constexpr int NB = DP / 64;      // 64-column boxes per Q or K row
  constexpr int NBV = DV / 64;     // 64-column boxes per dO or V row
  constexpr int NACC = DP / 2;     // dK accumulators per thread
  constexpr int NACV = DV / 2;     // dV accumulators per thread
  extern __shared__ __align__(1024) uint8_t gsm[];
  const uint32_t base = smem_u32(gsm);
  if (base & 1023u) __trap();
  const uint32_t sK = base + SM::K, sV = base + SM::V;
  const uint32_t sQ = base + SM::Q, sDO = base + SM::DO;
  const uint32_t sRows = base + SM::ROWS;
  const uint32_t kvbar = base + SM::BAR, full = kvbar + 8;
  const uint32_t empty = full + STAGES * 8;

  // the work item: causal key tile 0 sees every query tile, so tiles go
  // in key order, every (batch row, KV head) of one tile before the next
  const int rank = blockIdx.y * gridDim.x + blockIdx.x;
  const int bh = rank % gridDim.y;
  const int b = bh / p.Hkv, hk = bh % p.Hkv;
  const int k0 = (rank / gridDim.y) * BK;
  const int kv_lim = kv_limit(p, b), qoff = q_off(p, b);
  const int n_qt = (p.Sq + BQ - 1) / BQ;
  // a query tile that may hold rows that see no key (their dV share)
  auto blind = [&](int q0) {
    return kv_lim <= 0 || (p.causal && qoff + q0 < 0);
  };
  // a query tile adds something to these keys when one of its rows sees
  // one of them, or it may hold rows that see no key
  auto used = [&](int qt) {
    const int q0 = qt * BQ, ql = min(q0 + BQ, p.Sq) - 1;
    return blind(q0) || (k0 < kv_lim && (!p.causal || qoff + ql >= k0));
  };

  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer: K and V once, then the ring of (Q, dO, lse, delta)
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(kvbar, SM::QT + SM::VT);
#pragma unroll
      for (int j = 0; j < NB; ++j)
        tma_load(sK + j * BOX, &tmk, kvbar, 64 * j, k0, hk, b);
#pragma unroll
      for (int j = 0; j < NBV; ++j)
        tma_load(sV + j * BOX, &tmv, kvbar, 64 * j, k0, hk, b);
      int i = 0;
      for (int g = 0; g < p.group; ++g) {
        const int h = hk * p.group + g;
        for (int qt = 0; qt < n_qt; ++qt) {
          if (!used(qt)) continue;
          const int st = i % STAGES;
          mbar_wait(empty + 8 * st, ((i / STAGES) & 1) ^ 1);
          const uint32_t bar = full + 8 * st;
          mbar_expect_tx(bar, SM::QT + SM::VT + 2 * BQ * 4);
#pragma unroll
          for (int j = 0; j < NB; ++j)
            tma_load(sQ + st * SM::QT + j * BOX, &tmq, bar, 64 * j, qt * BQ,
                     h, b);
#pragma unroll
          for (int j = 0; j < NBV; ++j)
            tma_load(sDO + st * SM::VT + j * BOX, &tmdo, bar, 64 * j,
                     qt * BQ, h, b);
          const uint32_t rows = sRows + st * 2 * BQ * 4;
          tma_load_2d(rows, &tml, bar, qt * BQ, b * p.Hq + h);
          tma_load_2d(rows + BQ * 4, &tmd, bar, qt * BQ, b * p.Hq + h);
          ++i;
        }
      }
    }
    return;
  }

  // ---- consumers: one warpgroup; this thread's rows are keys
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rw[2] = {warp * 16 + (lane >> 2), warp * 16 + (lane >> 2) + 8};
  const int cq = 2 * (lane & 3);
  const int kpos[2] = {k0 + rw[0], k0 + rw[1]};
  const float inv_skv = 1.f / (float)p.Skv;
  float dk[NACC], dv[NACV], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < NACC; ++i) dk[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NACV; ++i) dv[i] = 0.f;
  mbar_wait(kvbar, 0);

  int i = 0;
  for (int g = 0; g < p.group; ++g) {
    for (int qt = 0; qt < n_qt; ++qt) {
      if (!used(qt)) continue;
      const int st = i % STAGES;
      const uint32_t qs = sQ + st * SM::QT, gs = sDO + st * SM::VT;
      const float* lse_s =
          reinterpret_cast<const float*>(gsm + SM::ROWS + st * 2 * BQ * 4);
      const float* del_s = lse_s + BQ;
      mbar_wait(full + 8 * st, (i / STAGES) & 1);
      wgmma_fence();
      mma_abt<DP>(s, sK, qs);     // S^T = K Q^T
      wgmma_commit();
      wgmma_fence();
      mma_abt<DV>(dp, sV, gs);    // dP^T = V dO^T
      wgmma_commit();

      // which (key, query) pairs are visible; query columns past Sq come
      // back from TMA as zeros and are masked
      const int q0 = qt * BQ;
      const bool tb = blind(q0);
      const bool whole = !tb && k0 + BK <= kv_lim && q0 + BQ <= p.Sq &&
                         (!p.causal || k0 + BK - 1 <= qoff + q0);
      uint32_t ok = 0xffffffffu;
      if (!whole) {
        ok = 0;
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int kp = kpos[(e >> 1) & 1];
          const int qq = q0 + cq + 8 * (e >> 2) + (e & 1);
          const bool vis = kp < kv_lim && qq < p.Sq &&
                           (!p.causal || kp <= qoff + qq);
          ok |= (uint32_t)vis << e;
        }
      }
      wgmma_wait<1>();
      fence_regs(s);
      // P^T = exp(S^T - lse), lse of a column pair at a time in the log2
      // domain; then, off the whole tiles, masked pairs are exactly 0 and
      // a column whose row sees no key is 1 / Skv.  (A masked pair's exp
      // may overflow: it is replaced, never multiplied.)
      const float sl2 = p.scale_log2;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(lse_s + 8 * j + cq);
        const float n0 = -__fmul_rn(l.x, LOG2E), n1 = -__fmul_rn(l.y, LOG2E);
#pragma unroll
        for (int x = 0; x < 4; ++x)
          s[4 * j + x] = ex2(fmaf(s[4 * j + x], sl2, (x & 1) ? n1 : n0));
      }
      if (!whole) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          float pr = (ok >> e) & 1u ? s[e] : 0.f;
          if (tb && lse_s[8 * (e >> 2) + cq + (e & 1)] == INFINITY)
            pr = inv_skv;
          s[e] = pr;
        }
      }
      uint32_t pa[16];
#pragma unroll
      for (int m = 0; m < 16; ++m) pa[m] = pack_bf16(s[2 * m], s[2 * m + 1]);
      fence_regs(dv);
      wgmma_fence();
      mma_rb(dv, pa, gs);         // dV += P^T dO
      wgmma_commit();
      wgmma_wait<1>();            // dP^T done; dV may still run
      fence_regs(dp);
      // dS^T = P^T (dP^T - delta), 0 in the columns of rows with no key
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 d = *reinterpret_cast<const float2*>(del_s + 8 * j + cq);
#pragma unroll
        for (int x = 0; x < 4; ++x)
          dp[4 * j + x] = __fmul_rn(s[4 * j + x],
                                    __fsub_rn(dp[4 * j + x], (x & 1) ? d.y
                                                                     : d.x));
      }
      if (tb) {
#pragma unroll
        for (int e = 0; e < 32; ++e)
          if (lse_s[8 * (e >> 2) + cq + (e & 1)] == INFINITY) dp[e] = 0.f;
      }
      uint32_t da[16];
#pragma unroll
      for (int m = 0; m < 16; ++m) da[m] = pack_bf16(dp[2 * m], dp[2 * m + 1]);
      fence_regs(dk);
      wgmma_fence();
      mma_rb(dk, da, qs);         // dK += dS^T Q
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      keep_regs(pa);
      keep_regs(da);
      mbar_arrive(empty + 8 * st);
      ++i;
    }
  }

  // ---- epilogue: dK = scale * dS^T Q, dense (B, Hkv, Skv, D), and dV,
  // dense (B, Hkv, Skv, Dv)
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    if (kpos[ri] >= p.Skv) continue;
    const long long row = (long long)(b * p.Hkv + hk) * p.Skv + kpos[ri];
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + cq, e = 4 * j + 2 * ri;
      if (col < p.D)
        *reinterpret_cast<__nv_bfloat162*>(p.dk + row * p.D + col) =
            __floats2bfloat162_rn(__fmul_rn(dk[e], p.scale),
                                  __fmul_rn(dk[e + 1], p.scale));
    }
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      const int col = 8 * j + cq, e = 4 * j + 2 * ri;
      if (col < p.Dv)
        *reinterpret_cast<__nv_bfloat162*>(p.dv + row * p.Dv + col) =
            __floats2bfloat162_rn(dv[e], dv[e + 1]);
    }
  }
}

template <int DP, int DV>
int launch(const CUtensorMap* maps, const Params& p, int B,
           cudaStream_t stream) {
  using SQ = DqSmem<DP, DV>;
  using SKV = DkvSmem<DP, DV>;
  static std::atomic<unsigned> opted_dq{0}, opted_dkv{0};
  cudaError_t err = opt_in(bwd_dq_kernel<DP, DV>, SQ::BYTES, opted_dq);
  if (err == cudaSuccess)
    err = opt_in(bwd_dkv_kernel<DP, DV>, SKV::BYTES, opted_dkv);
  int wave = 0;
  if (err == cudaSuccess) err = sm_count(&wave);
  if (err != cudaSuccess) return err;
  Params q = p;
  q.wave = wave;
  const dim3 qgrid((p.Sq + p.qp - 1) / p.qp, B * p.Hkv);
  bwd_dq_kernel<DP, DV><<<qgrid, THREADS, SQ::BYTES, stream>>>(
      maps[0], maps[1], q);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.Skv == 0) return err;
  const dim3 kgrid((p.Skv + BK - 1) / BK, B * p.Hkv);
  bwd_dkv_kernel<DP, DV><<<kgrid, THREADS, SKV::BYTES, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], q);
  return cudaGetLastError();
}

}  // namespace sm90

}  // namespace

// bf16 on the tensor cores.  q (B, Hq, Sq, D), k (B, Hkv, Skv, D), v (B,
// Hkv, Skv, Dv), o and dout (B, Hq, Sq, Dv), each addressed by the (batch,
// head, seq) element strides in `strides` (a host array of 15: q, k, v, o,
// dout), last dim dense, rows 16-byte aligned.  Dv = D in {16, 32, 64,
// 128}, or Dv in {16, 32, 64} under D a multiple of 8 in (Dv, 128], as the
// forward takes them.  dq, dk and dv are dense outputs of q's, k's and v's
// shapes.  lse holds the forward's row statistics at
// lse[(b * Hq + h) * ld + pos]; delta is float32 scratch of the same
// layout; ld is a multiple of 4 and >= Sq.  kv_len and q_offset are int32
// (B,) device arrays, or null to use kv_len_val / q_offset_val for every
// row.  scale_log2 = log2(e) / sqrt(D), scale = 1 / sqrt(D).  Returns 0,
// a cudaError_t, or 1000 (no tensor-map encoder) / 2000 + CUresult.
extern "C" int restore_flash_attention_bwd_sm90(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, const float* lse,
    float* delta, int ld, const int* kv_len, const int* q_offset,
    int kv_len_val, int q_offset_val, int B, int Hq, int Hkv, int Sq,
    int Skv, int D, int Dv, const long long* strides, int causal,
    float scale_log2, float scale, void* stream) {
  const bool dv_ok = Dv == 16 || Dv == 32 || Dv == 64 || Dv == 128;
  const bool dims_ok =
      dv_ok && (Dv == D || (D % 8 == 0 && Dv < D && D <= 128));
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Skv < 0 ||
      Hq / Hkv > sm90::BQ || !dims_ok || ld < Sq || ld % 4 != 0)
    return (int)cudaErrorInvalidValue;
  sm90::Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.lse = lse;
  p.delta = delta;
  p.kv_len = kv_len;
  p.q_offset = q_offset;
  p.qb = strides[0]; p.qh = strides[1]; p.qs = strides[2];
  p.ob = strides[9]; p.oh = strides[10]; p.os = strides[11];
  p.db = strides[12]; p.dh = strides[13]; p.ds = strides[14];
  p.kv_len_val = kv_len_val;
  p.q_offset_val = q_offset_val;
  p.Hq = Hq; p.Hkv = Hkv; p.group = Hq / Hkv;
  p.Sq = Sq; p.Skv = Skv; p.D = D; p.Dv = Dv; p.ld = ld;
  p.qp = sm90::BQ / p.group;
  p.wave = 0;
  p.causal = causal;
  p.scale_log2 = scale_log2;
  p.scale = scale;
  // K, V, Q, dO, lse, delta; with no keys no tile is loaded
  CUtensorMap maps[6];
  memset(maps, 0, sizeof(maps));
  if (Skv > 0) {
    int rc = tile_map(&maps[0], k, B, Hkv, Skv, D, strides[3], strides[4],
                      strides[5]);
    if (rc == 0)
      rc = tile_map(&maps[1], v, B, Hkv, Skv, Dv, strides[6], strides[7],
                    strides[8]);
    if (rc == 0)
      rc = tile_map(&maps[2], q, B, Hq, Sq, D, strides[0], strides[1],
                    strides[2]);
    if (rc == 0)
      rc = tile_map(&maps[3], dout, B, Hq, Sq, Dv, strides[12], strides[13],
                    strides[14]);
    if (rc == 0) rc = rows_map(&maps[4], lse, B * Hq, Sq, ld);
    if (rc == 0) rc = rows_map(&maps[5], delta, B * Hq, Sq, ld);
    if (rc != 0) return rc;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D > 64 && Dv > 64) return sm90::launch<128, 128>(maps, p, B, s);
  if (D > 64) return sm90::launch<128, 64>(maps, p, B, s);
  return sm90::launch<64, 64>(maps, p, B, s);
}

// float32 on the CUDA cores: the same tensors as above in float32 (the
// strides likewise; dq, dk and dv dense), D a multiple of 8 up to 128 and
// Dv one of 16, 32, 64 and 128, at most D rounded up to one of them.
// delta is float32 scratch of B * Hq * Sq; lse holds B * Hq rows at
// stride ld >= Sq, the caller's statistics when lse_given is 1 (the
// forward's, or chunked attention's merged ones), else scratch the
// kernel fills itself.  Returns the first launch's cudaError_t that is
// not cudaSuccess.
extern "C" int restore_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, float* lse, float* delta,
    int ld, int lse_given, const int* kv_len, const int* q_offset,
    int kv_len_val, int q_offset_val, int B, int Hq, int Hkv, int Sq,
    int Skv, int D, int Dv, const long long* strides, int causal,
    float scale, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Skv < 0
      || ld < Sq)
    return (int)cudaErrorInvalidValue;
  simt::Args a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout;
  a.dq = dq; a.dk = dk; a.dv = dv; a.lse = lse; a.delta = delta;
  a.kv_len = kv_len;
  a.q_offset = q_offset;
  a.kv_len_val = kv_len_val;
  a.q_offset_val = q_offset_val;
  a.B = B; a.Hq = Hq; a.Hkv = Hkv; a.Sq = Sq; a.Skv = Skv;
  a.st.qb = strides[0]; a.st.qh = strides[1]; a.st.qs = strides[2];
  a.st.kb = strides[3]; a.st.kh = strides[4]; a.st.ks = strides[5];
  a.st.vb = strides[6]; a.st.vh = strides[7]; a.st.vs = strides[8];
  a.st.ob = strides[9]; a.st.oh = strides[10]; a.st.os = strides[11];
  a.st.db = strides[12]; a.st.dh = strides[13]; a.st.ds = strides[14];
  a.Dqk = D;
  a.lse_ld = ld;
  a.lse_given = lse_given;
  a.causal = causal;
  a.scale = scale;
  return (int)simt::launch_d(a, D, Dv, static_cast<cudaStream_t>(stream));
}
