// Causal online-softmax attention (FlashAttention) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_attn_kernel` behind
// src/repro/kernels/flash_attention/flash_attention.py::flash_attention_bhsd.
// It computes what that kernel computes: scores in f32, scaled by
// 1/sqrt(D); keys at or beyond the row's valid length, and (causal)
// keys after the query's position, masked to NEG_INF = -1e30; the online
// max m, sum l and accumulator acc carried across KV tiles; out =
// acc / max(l, 1e-30), cast to the input type.
//
// Where the serving path needs more than the TPU kernel's contract:
//   * kv_len and q_offset are int32 (B,) device arrays, one per batch
//     row, so batched decode (per-row lengths) and a prefill that reuses
//     a prefix (q_offset = the reused length) read nothing back to the
//     host;
//   * GQA: query head h reads KV head h / (Hq / Hkv); nothing is copied;
//   * ragged Sq and Skv: the kernel masks the edges itself and writes no
//     row beyond Sq;
//   * q, k, v and o are addressed through (batch, head, seq) strides, so
//     the model's transposed views need no copy (the last dim is dense).
//
// Design.  One CTA of 256 threads per (batch, query head, block of BQ
// query rows), BQ = 64, or 16 when Sq <= 16 (decode).  The KV tiles
// (64 keys) are a loop inside the CTA: the TPU's sequential grid axis.
// Q, K and V tiles are staged in shared memory as f32 (padded rows keep
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
// Bound on this card: at the cold prefill (16 heads x 1040 queries over
// up to 1042 keys, D = 128, bf16) the function's FLOPs (4 H Sq keys D,
// ~4.4 GFLOP per layer counting the visible keys) over 989 TFLOP/s
// bf16 exceed its bytes (~8 MB) over 3.35 TB/s: compute-bound, ~4.5 us.
// This kernel runs its FLOPs on the f32 CUDA cores (67 TFLOP/s peak),
// out of shared memory, so it is far above that bound; the tensor-core
// form (wgmma fed by TMA, warp-specialised) is later work.  Decode
// (Sq = 1) is bytes-bound (the KV cache read once); there one CTA per
// head streams its cache rows and 15 of its 16 query rows idle.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BK = 64;         // keys per KV tile
constexpr int THREADS = 256;   // 16 row groups (ty) x 16 column lanes (tx)

struct Strides {
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as torch's cast
}

// `rows` rows of D elements (row stride `rs` elements) -> shared f32
// rows of stride `ld`; rows at or beyond `valid` are zero-filled.
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
      for (int i = 0; i < VEC; ++i) d[i] = to_f32(x[i]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) d[i] = 0.f;
    }
  }
}

template <int D, int RI>
constexpr size_t smem_bytes() {
  // Qs (BQ x D+1), Ks (BK x D+1), Vs (BK x D), Ss (BQ x BK+1), f32
  return sizeof(float) * ((16 * RI + BK) * (D + 1) + BK * D
                          + 16 * RI * (BK + 1));
}

template <typename T, int D, int RI>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       const int* __restrict__ kv_len,
                       const int* __restrict__ q_offset, int Hq, int group,
                       int Sq, int Skv, Strides st, int causal,
                       float scale) {
  constexpr int BQ = 16 * RI;
  constexpr int LDQ = D + 1, LDK = D + 1, LDS = BK + 1;
  constexpr int CJ = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LDQ;
  float* Vs = Ks + BK * LDK;
  float* Ss = Vs + BK * D;

  const int b = blockIdx.y / Hq;
  const int h = blockIdx.y % Hq;
  const int hk = h / group;
  const int q0 = blockIdx.x * BQ;
  const int rows = min(BQ, Sq - q0);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  const int qoff = q_offset[b];
  const int kv_lim = min(kv_len[b], Skv);
  int n_keys = kv_lim;
  if (causal) n_keys = min(n_keys, qoff + q0 + rows);  // last row's pos + 1
  const int n_tiles = n_keys > 0 ? (n_keys + BK - 1) / BK : 0;

  const T* kp = k + b * st.kb + hk * st.kh;
  const T* vp = v + b * st.vb + hk * st.vh;
  load_tile<T, D, BQ>(Qs, LDQ, q + b * st.qb + h * st.qh + q0 * st.qs,
                      st.qs, rows);

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
    load_tile<T, D, BK>(Ks, LDK, kp + k0 * st.ks, st.ks, Skv - k0);
    load_tile<T, D, BK>(Vs, D, vp + k0 * st.vs, st.vs, Skv - k0);
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
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k0 + tx + 16 * j;
        const bool ok = k_pos < kv_lim && (!causal || k_pos <= q_pos);
        s[i][j] = ok ? __fmul_rn(s[i][j], scale) : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(__fsub_rn(s[i][j], m_new));
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
      for (int c = 0; c < CJ; ++c) vv[c] = Vs[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int c = 0; c < CJ; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  T* op = o + b * st.ob + h * st.oh + q0 * st.os;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i;
    if (r < rows) {
      const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < CJ; ++c)
        op[r * st.os + tx + 16 * c] = from_f32<T>(__fdiv_rn(acc[i][c], den));
    }
  }
}

template <typename T, int D, int RI>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const int* kv_len, const int* q_offset, int B, int Hq,
                   int Hkv, int Sq, int Skv, const Strides& st, int causal,
                   float scale, cudaStream_t stream) {
  constexpr int BQ = 16 * RI;
  constexpr size_t smem = smem_bytes<D, RI>();
  // above 48 KB of dynamic shared memory the kernel must opt in
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D, RI>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, B * Hq);
  flash_attention_kernel<T, D, RI><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), kv_len, q_offset, Hq,
      Hq / Hkv, Sq, Skv, st, causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_rows(const void* q, const void* k, const void* v,
                        void* o, const int* kv_len, const int* q_offset,
                        int B, int Hq, int Hkv, int Sq, int Skv,
                        const Strides& st, int causal, float scale,
                        cudaStream_t stream) {
  if (Sq <= 16)
    return launch<T, D, 1>(q, k, v, o, kv_len, q_offset, B, Hq, Hkv, Sq,
                           Skv, st, causal, scale, stream);
  return launch<T, D, 4>(q, k, v, o, kv_len, q_offset, B, Hq, Hkv, Sq, Skv,
                         st, causal, scale, stream);
}

template <typename T>
cudaError_t launch_dim(const void* q, const void* k, const void* v, void* o,
                       const int* kv_len, const int* q_offset, int B, int Hq,
                       int Hkv, int Sq, int Skv, int D, const Strides& st,
                       int causal, float scale, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch_rows<T, 16>(q, k, v, o, kv_len, q_offset, B, Hq, Hkv,
                                Sq, Skv, st, causal, scale, stream);
    case 32:
      return launch_rows<T, 32>(q, k, v, o, kv_len, q_offset, B, Hq, Hkv,
                                Sq, Skv, st, causal, scale, stream);
    case 64:
      return launch_rows<T, 64>(q, k, v, o, kv_len, q_offset, B, Hq, Hkv,
                                Sq, Skv, st, causal, scale, stream);
    case 128:
      return launch_rows<T, 128>(q, k, v, o, kv_len, q_offset, B, Hq, Hkv,
                                 Sq, Skv, st, causal, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), o (B, Hq, Sq, D), each
// addressed by the (batch, head, seq) element strides in `strides` (a
// host array of 12: q, k, v, o), last dim dense.  kv_len and q_offset
// are int32 (B,) on the device.  bf16 != 0 selects __nv_bfloat16, else
// float.  Returns the launch's cudaError_t.
extern "C" int restore_flash_attention(
    const void* q, const void* k, const void* v, void* o, const int* kv_len,
    const int* q_offset, int B, int Hq, int Hkv, int Sq, int Skv, int D,
    const long long* strides, int causal, float scale, int bf16,
    void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq < 0 || Skv < 0)
    return (int)cudaErrorInvalidValue;
  if (Sq == 0) return 0;
  Strides st;
  st.qb = strides[0]; st.qh = strides[1]; st.qs = strides[2];
  st.kb = strides[3]; st.kh = strides[4]; st.ks = strides[5];
  st.vb = strides[6]; st.vh = strides[7]; st.vs = strides[8];
  st.ob = strides[9]; st.oh = strides[10]; st.os = strides[11];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)launch_dim<__nv_bfloat16>(q, k, v, o, kv_len, q_offset, B,
                                          Hq, Hkv, Sq, Skv, D, st, causal,
                                          scale, s);
  return (int)launch_dim<float>(q, k, v, o, kv_len, q_offset, B, Hq, Hkv,
                                Sq, Skv, D, st, causal, scale, s);
}
