// The gradient of causal online-softmax attention for Hopper (sm_90a):
// dQ, dK and dV of  O = softmax(Q K^T / sqrt(D) + mask) V,  float32 and
// bf16, on the CUDA cores with float32 accumulation.
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
// Design: three launches on the caller's stream, no atomics, so the
// result is deterministic.
//   1. stats: one CTA per (batch, query head, 64 query rows) recomputes
//      each row's max and sum over its visible keys, exactly as the
//      forward does, and stores lse = m + log(l) (+inf for a row that
//      sees no key) and delta = rowsum(dO * O) in float32 scratch;
//   2. dQ: one CTA per (batch, query head, 64 query rows) walks the
//      row block's visible 64-key tiles in order and accumulates
//      dQ = dS K in registers;
//   3. dK, dV: one CTA per (batch, KV head, 64 keys) walks the group's
//      query heads and, for each, the 64-row query tiles in order, and
//      accumulates dV = P^T dO and dK = dS^T Q in registers.
// Each CTA has 256 threads: 16 row groups (ty) x 16 column lanes (tx), as
// in flash_attention.cu.  Tiles are staged in shared memory as float32
// (bf16 converted on load) in rows padded to an odd stride, so column
// reads are free of bank conflicts.
//
// Bound on this card: 10 * D operations per visible query-key pair (five
// products: S, dP, dQ, dK, dV), against the bytes of q, k, v, O, dO, dQ,
// dK and dV.  At training shapes the operations bound; this first kernel
// runs them from shared memory on the CUDA cores (passes 1-3 compute S
// three times and dP twice), far below the tensor cores' rate.  Tensor
// cores and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

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
  float *lse, *delta;             // (B, Hq, Sq) float32 scratch
  const int *kv_len, *q_offset;   // (B,) on the device, or null: the _val
  int kv_len_val, q_offset_val, B, Hq, Hkv, Sq, Skv;
  Strides st;
  int causal;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

// `rows` rows of D elements of T (row stride `rs` elements) -> float32
// shared rows of stride `ld`; rows at or beyond `valid` are zero-filled.
// 16-byte loads: the wrapper checks the alignment.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long long rs, int valid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = D / VEC;
  for (int c = threadIdx.x; c < ROWS * CHUNKS; c += THREADS) {
    const int r = c / CHUNKS;
    const int e0 = (c % CHUNKS) * VEC;
    float* d = dst + r * ld + e0;
    if (r < valid) {
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
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
bwd_stats_kernel(Args a) {
  constexpr int LD = D + 1, RI = BQ / 16, CJ = D / 16;
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
  load_tile<T, D, BQ>(Qs, LD, static_cast<const T*>(a.q) + b * st.qb +
                      h * st.qh + q0 * st.qs, st.qs, rows);

  float m[RI], l[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
  }
  const int n_tiles = n_key_tiles(a, c, q0, rows);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();
    load_tile<T, D, BK>(Ks, LD, kp + k0 * st.ks, st.ks, a.Skv - k0);
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

  // delta = rowsum(dO * O): lanes tx split each row's D columns
  const T* op = static_cast<const T*>(a.o) + b * st.ob + h * st.oh;
  const T* dp = static_cast<const T*>(a.dout) + b * st.db + h * st.dh;
  const long long row0 = ((long long)b * a.Hq + h) * a.Sq + q0;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i;
    float acc = 0.f;
    if (r < rows) {
#pragma unroll
      for (int cc = 0; cc < CJ; ++cc) {
        const int e = tx + 16 * cc;
        acc = fmaf(to_f(dp[(q0 + r) * st.ds + e]),
                   to_f(op[(q0 + r) * st.os + e]), acc);
      }
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    if (r < rows && tx == 0) {
      a.lse[row0 + r] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
      a.delta[row0 + r] = acc;
    }
  }
}

// ---------------------------------------------------------------- pass 2
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
bwd_dq_kernel(Args a) {
  constexpr int LD = D + 1, LDS = BK + 1, RI = BQ / 16, CJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* dSs = Vs + BK * LD;
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
                      h * st.qh + q0 * st.qs, st.qs, rows);
  load_tile<T, D, BQ>(dOs, LD, static_cast<const T*>(a.dout) + b * st.db +
                      h * st.dh + q0 * st.ds, st.ds, rows);
  const long long row0 = ((long long)b * a.Hq + h) * a.Sq + q0;
  float lse[RI], del[RI], acc[RI][CJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i;
    lse[i] = r < rows ? a.lse[row0 + r] : INFINITY;
    del[i] = r < rows ? a.delta[row0 + r] : 0.f;
#pragma unroll
    for (int cc = 0; cc < CJ; ++cc) acc[i][cc] = 0.f;
  }

  const int n_tiles = n_key_tiles(a, c, q0, rows);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();
    load_tile<T, D, BK>(Ks, LD, kp + k0 * st.ks, st.ks, a.Skv - k0);
    load_tile<T, D, BK>(Vs, LD, vp + k0 * st.vs, st.vs, a.Skv - k0);
    __syncthreads();
    float s[RI][4], dp[RI][4];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RI], gv[RI], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        qv[i] = Qs[(ty + 16 * i) * LD + d];
        gv[i] = dOs[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 16 * j) * LD + d];
        vv[j] = Vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
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

  T* dq = static_cast<T*>(a.dq) + row0 * D;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i;
    if (r < rows)
#pragma unroll
      for (int cc = 0; cc < CJ; ++cc)
        dq[r * D + tx + 16 * cc] = from_f<T>(__fmul_rn(acc[i][cc], a.scale));
  }
}

// ---------------------------------------------------------------- pass 3
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
bwd_dkv_kernel(Args a) {
  constexpr int LD = D + 1, LDP = BQ + 1, RI = BK / 16, CJ = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* dOs = Qs + BQ * LD;
  float* Ps = dOs + BQ * LD;
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
                      hk * st.kh + k0 * st.ks, st.ks, keys);
  load_tile<T, D, BK>(Vs, LD, static_cast<const T*>(a.v) + b * st.vb +
                      hk * st.vh + k0 * st.vs, st.vs, keys);
  const float inv_skv = 1.f / (float)a.Skv;
  float acc_k[RI][CJ], acc_v[RI][CJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int cc = 0; cc < CJ; ++cc) acc_k[i][cc] = acc_v[i][cc] = 0.f;

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
      load_tile<T, D, BQ>(Qs, LD, qp + q0 * st.qs, st.qs, rows);
      load_tile<T, D, BQ>(dOs, LD, gp + q0 * st.ds, st.ds, rows);
      const long long row0 = ((long long)b * a.Hq + h) * a.Sq + q0;
      for (int r = threadIdx.x; r < BQ; r += THREADS) {
        lse_s[r] = r < rows ? a.lse[row0 + r] : INFINITY;
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
        float kv[RI], vv[RI], qv[4], gv[4];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          kv[i] = Ks[(ty + 16 * i) * LD + d];
          vv[i] = Vs[(ty + 16 * i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = Qs[(tx + 16 * j) * LD + d];
          gv[j] = dOs[(tx + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], gv[j], dp[i][j]);
          }
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
        float pv[RI], sv[RI], gv[CJ], qv[CJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          pv[i] = Ps[(ty + 16 * i) * LDP + rr];
          sv[i] = dSs[(ty + 16 * i) * LDP + rr];
        }
#pragma unroll
        for (int cc = 0; cc < CJ; ++cc) {
          gv[cc] = dOs[rr * LD + tx + 16 * cc];
          qv[cc] = Qs[rr * LD + tx + 16 * cc];
        }
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int cc = 0; cc < CJ; ++cc) {
            acc_v[i][cc] = fmaf(pv[i], gv[cc], acc_v[i][cc]);
            acc_k[i][cc] = fmaf(sv[i], qv[cc], acc_k[i][cc]);
          }
      }
    }
  }

  const long long key0 = ((long long)b * a.Hkv + hk) * a.Skv + k0;
  T* dk = static_cast<T*>(a.dk) + key0 * D;
  T* dv = static_cast<T*>(a.dv) + key0 * D;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int kr = ty + 16 * i;
    if (kr < keys)
#pragma unroll
      for (int cc = 0; cc < CJ; ++cc) {
        dk[kr * D + tx + 16 * cc] = from_f<T>(__fmul_rn(acc_k[i][cc],
                                                        a.scale));
        dv[kr * D + tx + 16 * cc] = from_f<T>(acc_v[i][cc]);
      }
  }
}

template <int D>
constexpr size_t stats_smem() { return sizeof(float) * (BQ + BK) * (D + 1); }
template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (2 * (BQ + BK) * (D + 1) + BQ * (BK + 1));
}
template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) * (2 * (BQ + BK) * (D + 1) + 2 * BK * (BQ + 1)
                          + 2 * BQ);
}

// above 48 KB of dynamic shared memory a kernel must opt in: once per
// kernel and device
template <typename K>
cudaError_t opt_in(K kernel, size_t smem, std::atomic<unsigned>& opted) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = 1u << (dev & 31);
  if (!(opted.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    opted.fetch_or(bit, std::memory_order_release);
  }
  return cudaSuccess;
}

template <typename T, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  static std::atomic<unsigned> opted_stats{0}, opted_dq{0}, opted_dkv{0};
  cudaError_t err;
  if ((err = opt_in(bwd_stats_kernel<T, D>, stats_smem<D>(), opted_stats)))
    return err;
  if ((err = opt_in(bwd_dq_kernel<T, D>, dq_smem<D>(), opted_dq)))
    return err;
  if ((err = opt_in(bwd_dkv_kernel<T, D>, dkv_smem<D>(), opted_dkv)))
    return err;
  const dim3 qgrid((a.Sq + BQ - 1) / BQ, a.B * a.Hq);
  bwd_stats_kernel<T, D><<<qgrid, THREADS, stats_smem<D>(), stream>>>(a);
  if ((err = cudaGetLastError())) return err;
  bwd_dq_kernel<T, D><<<qgrid, THREADS, dq_smem<D>(), stream>>>(a);
  if ((err = cudaGetLastError())) return err;
  if (a.Skv > 0) {
    const dim3 kgrid((a.Skv + BK - 1) / BK, a.B * a.Hkv);
    bwd_dkv_kernel<T, D><<<kgrid, THREADS, dkv_smem<D>(), stream>>>(a);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Args& a, int D, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(a, s);
    case 32: return launch<T, 32>(a, s);
    case 64: return launch<T, 64>(a, s);
    case 128: return launch<T, 128>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), o and dout (B, Hq, Sq, D),
// each addressed by the (batch, head, seq) element strides in `strides`
// (a host array of 15: q, k, v, o, dout), last dim dense.  dq, dk and dv
// are dense outputs of q's, k's and v's shapes; lse and delta are float32
// scratch of B * Hq * Sq.  kv_len and q_offset are int32 (B,) device
// arrays, or null to use kv_len_val / q_offset_val for every row.  bf16
// selects __nv_bfloat16 for every tensor, else float32.  Returns the
// first launch's cudaError_t that is not cudaSuccess.
extern "C" int restore_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, float* lse, float* delta,
    const int* kv_len, const int* q_offset, int kv_len_val, int q_offset_val,
    int B, int Hq, int Hkv, int Sq, int Skv, int D, const long long* strides,
    int causal, int bf16, float scale, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Skv < 0)
    return (int)cudaErrorInvalidValue;
  Args a;
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
  a.causal = causal;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch_d<__nv_bfloat16>(a, D, st)
                    : launch_d<float>(a, D, st));
}
