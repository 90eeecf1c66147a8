// Causal online-softmax attention (FlashAttention) for Hopper (sm_90a),
// float32 on the CUDA cores.
//
// Replaces, for float32, the TPU kernel `_attn_kernel` behind
// src/repro/kernels/flash_attention/flash_attention.py::flash_attention_bhsd;
// bf16 goes to the tensor-core kernel of flash_attention_sm90.cu (tensor
// cores at TF32 would not keep float32's agreement with the plain version).
// It computes what that kernel computes: scores in f32, scaled by
// 1/sqrt(D); keys at or beyond the row's valid length, and (causal)
// keys after the query's position, masked to NEG_INF = -1e30; the online
// max m, sum l and accumulator acc carried across KV tiles; out =
// acc / max(l, 1e-30), cast to the input type.  Masked probabilities are
// exactly 0, so l = 0 marks a row that sees no key (kv_len = 0, or causal
// before every key); its scores are all -1e30, whose softmax is uniform,
// and it gets the mean of V over all Skv keys of its KV head, as the
// plain version gives.  Given an `lse` buffer, it also writes each row's
// statistic, as flash_attention_sm90.cu does for bf16: lse = m + ln(l),
// the natural log of the sum of exp(scores) over the row's visible keys,
// and +inf for a row that sees no key (the plain version's mha_lse_ref).
// Chunked attention and the sequence-sharded decode merge partial
// outputs by it (models/layers.py).
//
// Two head dims: the query/key head dim Dqk and the value head dim DV
// (MLA's (24, 16) and (96, 64), as the reference's plain attention takes
// them).  Q and K are staged at a padded width D, the least of 16, 32, 64
// and 128 that holds Dqk, their columns past Dqk zero-filled: a zero
// column adds fmaf(0, 0, s) = s to a dot product, so the scores' bits do
// not depend on the padding.  V, the accumulator and the output have DV
// columns.
//
// Where the serving path needs more than the TPU kernel's contract:
//   * kv_len and q_offset are int32 (B,) device arrays, one per batch
//     row, so batched decode (per-row lengths) and a prefill that reuses
//     a prefix (q_offset = the reused length) read nothing back to the
//     host; or one value for every row, passed by value;
//   * GQA: query head h reads KV head h / (Hq / Hkv); nothing is copied;
//   * ragged Sq and Skv: the kernel masks the edges itself and writes no
//     row beyond Sq;
//   * q, k, v and o are addressed through (batch, head, seq) strides, so
//     the model's transposed views need no copy (the last dim is dense).
//
// Design.  One CTA of 256 threads per (batch, query head, block of BQ
// query rows), BQ = 64, or 16 when Sq <= 16 (decode).  The KV tiles
// (64 keys) are a loop inside the CTA: the TPU's sequential grid axis.
// Q, K and V tiles are staged in shared memory (padded rows keep
// the column reads free of bank conflicts); the math is f32 on CUDA
// cores.  Thread (ty, tx) owns rows ty + 16 i and score columns
// tx + 16 j, so a row's max and sum are one 16-lane butterfly.  KV tiles
// at or beyond min(kv_len, Skv) and, causally, beyond the CTA's last
// query position are skipped; a skipped tile is fully masked for every
// row of the CTA and would add exactly 0.
//
// Batch invariance: a query row's arithmetic (its dot products, the
// order of its KV tiles, its butterfly reductions) depends only on its
// own position, kv_len and the fixed 64-key tiling, never on BQ or on
// which rows share its CTA.  Every rounding step is explicit (fmaf and
// the __f*_rn intrinsics, which the compiler never contracts), so the
// instantiations for BQ = 16 and 64 round alike: a row computed in a
// 1040-row prefill, a 16-row suffix prefill or a decode step gets the
// same bits from the same inputs.
//
// Bound on this card: float32 attention's FLOPs run at most at the f32
// CUDA-core peak (67 TFLOP/s); this kernel runs them out of shared
// memory, far below it.  Float32 is the smoke config's and the tests'
// type, not the serving path's; decode (Sq = 1) is bytes-bound, and there
// one CTA per head streams its cache rows and 15 of its 16 query rows
// idle.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BK = 64;         // keys per KV tile
constexpr int THREADS = 256;   // 16 row groups (ty) x 16 column lanes (tx)

struct Strides {
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

// `rows` rows of `cols` elements (row stride `rs` elements) -> shared
// rows of D elements at stride `ld`; rows at or beyond `valid`, and the
// columns from `cols` to D, are zero-filled.  16-byte loads (`cols` is a
// multiple of 4): the wrapper checks the alignment.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          long long rs, int valid, int cols) {
  constexpr int VEC = 4;
  constexpr int CHUNKS = D / VEC;
  for (int c = threadIdx.x; c < ROWS * CHUNKS; c += THREADS) {
    const int r = c / CHUNKS;
    const int e0 = (c % CHUNKS) * VEC;
    float* d = dst + r * ld + e0;
    if (r < valid && e0 < cols) {
      const float4 x = *reinterpret_cast<const float4*>(src + r * rs + e0);
      d[0] = x.x;
      d[1] = x.y;
      d[2] = x.z;
      d[3] = x.w;
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) d[i] = 0.f;
    }
  }
}

template <int D, int DV, int RI>
constexpr size_t smem_bytes() {
  // Qs (BQ x D+1), Ks (BK x D+1), Vs (BK x DV), Ss (BQ x BK+1), f32
  return sizeof(float) * ((16 * RI + BK) * (D + 1) + BK * DV
                          + 16 * RI * (BK + 1));
}

template <int D, int DV, int RI>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       const int* __restrict__ kv_len,
                       const int* __restrict__ q_offset, int kv_len_val,
                       int q_offset_val, int Hq, int group, int Sq, int Skv,
                       Strides st, int causal, float scale,
                       float* __restrict__ lse, int lse_ld, int dqk) {
  constexpr int BQ = 16 * RI;
  constexpr int LDQ = D + 1, LDK = D + 1, LDS = BK + 1;
  constexpr int CJ = DV / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LDQ;
  float* Vs = Ks + BK * LDK;
  float* Ss = Vs + BK * DV;

  const int b = blockIdx.y / Hq;
  const int h = blockIdx.y % Hq;
  const int hk = h / group;
  const int q0 = blockIdx.x * BQ;
  const int rows = min(BQ, Sq - q0);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  const int qoff = q_offset ? q_offset[b] : q_offset_val;
  const int kv_lim = min(kv_len ? kv_len[b] : kv_len_val, Skv);
  int n_keys = kv_lim;
  if (causal) n_keys = min(n_keys, qoff + q0 + rows);  // last row's pos + 1
  const int n_tiles = n_keys > 0 ? (n_keys + BK - 1) / BK : 0;

  const float* kp = k + b * st.kb + hk * st.kh;
  const float* vp = v + b * st.vb + hk * st.vh;
  load_tile<D, BQ>(Qs, LDQ, q + b * st.qb + h * st.qh + q0 * st.qs,
                      st.qs, rows, dqk);

  float m[RI], l[RI], acc[RI][CJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CJ; ++c) acc[i][c] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();   // the previous tile's readers are done
    load_tile<D, BK>(Ks, LDK, kp + k0 * st.ks, st.ks, Skv - k0, dqk);
    load_tile<DV, BK>(Vs, DV, vp + k0 * st.vs, st.vs, Skv - k0, DV);
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
      for (int i = 0; i < RI; ++i) qv[i] = Qs[(ty + 16 * i) * LDQ + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * LDK + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 16 * i;
      const int q_pos = qoff + q0 + r;
      float mx = NEG_INF;
      bool ok[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k0 + tx + 16 * j;
        ok[j] = k_pos < kv_lim && (!causal || k_pos <= q_pos);
        s[i][j] = ok[j] ? __fmul_rn(s[i][j], scale) : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = ok[j] ? expf(__fsub_rn(s[i][j], m_new)) : 0.f;
        rs = __fadd_rn(rs, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs = __fadd_rn(rs, __shfl_xor_sync(0xffffffffu, rs, off));
      const float alpha = expf(__fsub_rn(m[i], m_new));
      l[i] = fmaf(l[i], alpha, rs);
#pragma unroll
      for (int c = 0; c < CJ; ++c) acc[i][c] = __fmul_rn(acc[i][c], alpha);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) Ss[r * LDS + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[RI], vv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = Ss[(ty + 16 * i) * LDS + kk];
#pragma unroll
      for (int c = 0; c < CJ; ++c) vv[c] = Vs[kk * DV + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int c = 0; c < CJ; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  float* op = o + b * st.ob + h * st.oh + q0 * st.os;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i;
    if (lse != nullptr && r < rows && tx == 0)   // m, l alike on all lanes
      lse[(long long)(b * Hq + h) * lse_ld + q0 + r] =
          l[i] == 0.f ? INFINITY : __fadd_rn(m[i], logf(l[i]));
    if (r < rows && l[i] == 0.f) {   // no key seen: the mean of V
      float sum[CJ];
#pragma unroll
      for (int c = 0; c < CJ; ++c) sum[c] = 0.f;
      for (int kk = 0; kk < Skv; ++kk)
#pragma unroll
        for (int c = 0; c < CJ; ++c)
          sum[c] = __fadd_rn(sum[c], vp[kk * st.vs + tx + 16 * c]);
#pragma unroll
      for (int c = 0; c < CJ; ++c)
        op[r * st.os + tx + 16 * c] = Skv > 0 ? __fdiv_rn(sum[c], Skv) : 0.f;
    } else if (r < rows) {
      const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < CJ; ++c)
        op[r * st.os + tx + 16 * c] = __fdiv_rn(acc[i][c], den);
    }
  }
}

struct Args {
  const float *q, *k, *v;
  float* o;
  const int *kv_len, *q_offset;   // (B,) on the device, or null: the _val
  int kv_len_val, q_offset_val, B, Hq, Hkv, Sq, Skv;
  Strides st;
  int causal;
  float scale;
  float* lse;   // (B * Hq, lse_ld) row statistics, or null
  int lse_ld;
  int Dqk;      // query/key head dim, at most D
};

template <int D, int DV, int RI>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int BQ = 16 * RI;
  constexpr size_t smem = smem_bytes<D, DV, RI>();
  // above 48 KB of dynamic shared memory the kernel must opt in: once per
  // instantiation and device
  static std::atomic<unsigned> opted{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = 1u << (dev & 31);
  if (!(opted.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(flash_attention_kernel<D, DV, RI>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    opted.fetch_or(bit, std::memory_order_release);
  }
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.B * a.Hq);
  flash_attention_kernel<D, DV, RI><<<grid, THREADS, smem, stream>>>(
      a.q, a.k, a.v, a.o, a.kv_len, a.q_offset, a.kv_len_val, a.q_offset_val,
      a.Hq, a.Hq / a.Hkv, a.Sq, a.Skv, a.st, a.causal, a.scale, a.lse,
      a.lse_ld, a.Dqk);
  return cudaGetLastError();
}

template <int D, int DV>
cudaError_t launch_rows(const Args& a, cudaStream_t stream) {
  return a.Sq <= 16 ? launch<D, DV, 1>(a, stream)
                    : launch<D, DV, 4>(a, stream);
}

// the staged width D for Dqk, and DV <= D from 16, 32, 64 and 128
template <int D>
cudaError_t launch_dv(const Args& a, int Dv, cudaStream_t s) {
  switch (Dv) {
    case 16: return launch_rows<D, 16>(a, s);
    case 32: if constexpr (D >= 32) return launch_rows<D, 32>(a, s); break;
    case 64: if constexpr (D >= 64) return launch_rows<D, 64>(a, s); break;
    case 128: if constexpr (D >= 128) return launch_rows<D, 128>(a, s); break;
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q and k (B, Hq|Hkv, Sq|Skv, D), v (B, Hkv, Skv, Dv), o (B, Hq, Sq, Dv),
// float32, D a multiple of 8 up to 128, Dv one of 16, 32, 64 and 128 and
// at most D rounded up to one of them; each addressed by the (batch, head, seq) element strides in `strides`
// (a host array of 12: q, k, v, o), last dim dense.  kv_len and q_offset
// are int32 (B,) device arrays, or null to use kv_len_val / q_offset_val
// for every row.  lse null: no statistics; else each row's statistic goes
// to lse[(b * Hq + h) * lse_ld + pos], float32.  Returns the launch's
// cudaError_t.
extern "C" int restore_flash_attention(
    const void* q, const void* k, const void* v, void* o, const int* kv_len,
    const int* q_offset, int kv_len_val, int q_offset_val, int B, int Hq,
    int Hkv, int Sq, int Skv, int D, int Dv, const long long* strides,
    int causal, float scale, float* lse, int lse_ld, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq < 0 || Skv < 0)
    return (int)cudaErrorInvalidValue;
  if (D <= 0 || D > 128 || D % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (lse != nullptr && lse_ld < Sq) return (int)cudaErrorInvalidValue;
  if (Sq == 0) return 0;
  Args a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.o = static_cast<float*>(o);
  a.kv_len = kv_len;
  a.q_offset = q_offset;
  a.kv_len_val = kv_len_val;
  a.q_offset_val = q_offset_val;
  a.B = B; a.Hq = Hq; a.Hkv = Hkv; a.Sq = Sq; a.Skv = Skv;
  a.st.qb = strides[0]; a.st.qh = strides[1]; a.st.qs = strides[2];
  a.st.kb = strides[3]; a.st.kh = strides[4]; a.st.ks = strides[5];
  a.st.vb = strides[6]; a.st.vh = strides[7]; a.st.vs = strides[8];
  a.st.ob = strides[9]; a.st.oh = strides[10]; a.st.os = strides[11];
  a.causal = causal;
  a.scale = scale;
  a.lse = lse;
  a.lse_ld = lse_ld;
  a.Dqk = D;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 16) return (int)launch_dv<16>(a, Dv, s);
  if (D <= 32) return (int)launch_dv<32>(a, Dv, s);
  if (D <= 64) return (int)launch_dv<64>(a, Dv, s);
  return (int)launch_dv<128>(a, Dv, s);
}
