// K2: backward of the fused graph-guided attention + residual + reference
// LayerNorm (K1, csrc/graph_attention.cu).
//
// Replaces the TPU kernel structured_alignment_vqa_tpu/ops/pallas_attention_bwd.py
// (_bwd_kernel, line 53, launched by fused_attention_bwd).
//
// Given the forward's inputs and dy = d out, per batch element b, head h
// (dh = C / H), query row i and key j:
//   recompute  s = q_i.k_j * scale (masked keys -2^32+1), P = softmax(s),
//              G = P * graph, r = max(sum G, 1e-12) (l1, live = sum G > 1e-12)
//              or sum G + 1e-7 (sum_eps, live = 1), A = G / r * qmask_i,
//              O = A (rounded to V's type) @ V, x = O + residual
//   LayerNorm: xm = x - mean, s = std (unbiased; 0 on constant rows),
//              inv = 1 / (s + 1e-8); dbeta = sum_i dy, dgamma = sum_i dy xm inv;
//              dxh = dy gamma; dx = (dxh - mean dxh) inv
//                                  - [var > 0] xm (sum dxh xm) inv^2 / ((C-1) s)
//              dresidual = dO = dx
//   attention: dV = A^T dO (f32 A); dA = dO V^T (f32 V); dN = dA qmask_i
//              dG = dN / r - live sign(G) (sum dN G) / r^2  (sum_eps: no live, no sign)
//              dP = dG graph; dS = P (dP - sum dP P), 0 on masked keys, * scale
//              dQ = dS K; dK = dS^T Q
//
// What bounds it on an H100: bytes. At the training shapes (B 128, C 512,
// L 128, bf16) it must read q, k, v, residual, dy (bf16), the f32 graph and
// the masks and write dq, dk, dv and dresidual: ~160 MB, ~48 us at 3.35 TB/s,
// against ~12 B Tq Tk C = 13 GFLOP (13 us at the bf16 tensor-core peak). In
// f32 the operations bound it (67 TFLOP/s outside the tensor cores).
//
// Design: two launches, the dq / dkv split of the TPU package's flash
// backward (K5 / K6), because dK and dV sum over every query row and blocks
// cannot share a sum.
// * K2a, one block of 256 threads per (batch, tile of up to 16 query rows),
//   all heads, as K1. It recomputes the forward output of all heads into
//   shared memory (the LayerNorm backward needs whole rows), runs the
//   LayerNorm backward (dresidual, dO, per-block dgamma/dbeta partials summed
//   by the wrapper), then per head recomputes P, forms dA, dN, dG, dP and dS
//   in shared memory and writes dQ. It stores dO in f32 and, per (batch,
//   head, row), the softmax max and sum, r, live, sum dN G and sum dP P.
// * K2b, one block per (batch, head, tile of 32 keys). It walks the query
//   rows 16 at a time, recomputes P, G and A from those statistics (the same
//   score arithmetic as K2a, so the same P), and accumulates dV += A^T dO and
//   dK += dS^T Q in registers. No atomics: every sum comes out the same on
//   every run.
// Rows whose graph is all zero (the encoder's stage-1 graph on modality rows)
// have r = 1e-12 and dN / r ~ 1e12 dN; that stays in f32 and is multiplied
// by the graph (0) before anything else. The products are plain FMAs on CUDA
// cores, as in K1; tensor cores (wgmma) and TMA are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQTile = 16;      // K2a: query rows per block
constexpr int kKeyChunk = 64;   // K2a: keys staged in shared memory at a time
constexpr int kKTile = 32;      // K2b: keys per block
constexpr int kQChunk = 16;     // K2b: query rows per step
constexpr int kMaxDh = 128;
constexpr int kPer = kKTile * kMaxDh / kThreads;  // K2b accumulators per thread
constexpr int kStats = 8;       // m, z, r, live, sum dN G, sum dP P, unused, unused
constexpr float kNegMask = -4294967295.0f;  // float(-(2**32) + 1)
constexpr float kL1Eps = 1e-12f;
constexpr float kSumEps = 1e-7f;
constexpr float kLnEps = 1e-8f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float sign_of(float x) { return (float)((x > 0.f) - (x < 0.f)); }

// dG for one entry: dN / r minus the renorm's correction.
__device__ __forceinline__ float d_graph_weight(float dn, float g, float r, float live,
                                                float inner, int renorm) {
  const float corr = renorm == 0 ? live * sign_of(g) * inner : inner;
  return dn / r - corr / (r * r);
}

// Masked scores of head c0 for `rows` query rows into p (rows, Tk); K is
// staged through kv in chunks of kKeyChunk keys. Ends synchronised.
template <typename T>
__device__ void head_scores(const T* __restrict__ qb, const T* __restrict__ kb,
                            const float* __restrict__ km, float* qs, float* kv, float* p,
                            int rows, int Tk, int C, int c0, int dh, float scale) {
  const int tid = threadIdx.x;
  for (int i = tid; i < rows * dh; i += kThreads) {
    const int r = i / dh, d = i - r * dh;
    qs[i] = to_float(qb[(size_t)r * C + c0 + d]);
  }
  for (int j0 = 0; j0 < Tk; j0 += kKeyChunk) {
    const int nk = min(kKeyChunk, Tk - j0);
    __syncthreads();  // qs written; the previous chunk's readers of kv done
    for (int i = tid; i < nk * dh; i += kThreads) {
      const int j = i / dh, d = i - j * dh;
      kv[j * (dh + 1) + d] = to_float(kb[(size_t)(j0 + j) * C + c0 + d]);
    }
    __syncthreads();
    for (int i = tid; i < rows * nk; i += kThreads) {
      const int r = i / nk, j = i - r * nk;
      const float* qr = qs + r * dh;
      const float* kr = kv + j * (dh + 1);
      float s = 0.f;
      for (int d = 0; d < dh; ++d) s = fmaf(qr[d], kr[d], s);
      p[r * Tk + j0 + j] = km[j0 + j] == 0.f ? kNegMask : s * scale;
    }
  }
  __syncthreads();
}

// One warp, one row: scores -> P = softmax in place. Returns (max, sum).
__device__ __forceinline__ float2 row_softmax(float* pr, int Tk, int lane) {
  float m = -INFINITY;
  for (int j = lane; j < Tk; j += 32) m = fmaxf(m, pr[j]);
  m = warp_max(m);
  float z = 0.f;
  for (int j = lane; j < Tk; j += 32) {
    const float e = expf(pr[j] - m);
    pr[j] = e;
    z += e;
  }
  z = warp_sum(z);
  for (int j = lane; j < Tk; j += 32) pr[j] = pr[j] / z;
  return make_float2(m, z);
}

// Shared memory: acc (rows, C) | p (rows, Tk) | dd (rows, Tk) | qs (rows, dh)
//                | kv (kKeyChunk, dh + 1) | rowst (rows, kStats)
template <typename T>
__global__ void __launch_bounds__(kThreads)
graph_attention_ln_bwd_rows_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ key_mask, const float* __restrict__ query_mask,
    const float* __restrict__ graph, const T* __restrict__ residual,
    const float* __restrict__ gamma, const T* __restrict__ dy, T* __restrict__ dq,
    T* __restrict__ dres, float* __restrict__ partials, float* __restrict__ dout,
    float* __restrict__ stats, int Tq, int Tk, int C, int H, int renorm, float scale) {
  extern __shared__ float smem[];
  const int tile = min(kQTile, Tq);
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * tile;
  const int rows = min(tile, Tq - row0);
  const int dh = C / H;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  float* acc = smem;
  float* p = acc + tile * C;
  float* dd = p + tile * Tk;
  float* qs = dd + tile * Tk;
  float* kv = qs + tile * dh;
  float* rowst = kv + kKeyChunk * (dh + 1);

  const T* qb = q + ((size_t)b * Tq + row0) * C;
  const T* kb = k + (size_t)b * Tk * C;
  const T* vb = v + (size_t)b * Tk * C;
  const float* km = key_mask + (size_t)b * Tk;
  const float* qm = query_mask + (size_t)b * Tq + row0;
  const float* gb = graph + ((size_t)b * Tq + row0) * Tk;
  const T* rb = residual + ((size_t)b * Tq + row0) * C;
  const T* dyb = dy + ((size_t)b * Tq + row0) * C;

  // ---- 1. the forward output of every head, as K1 computes it ----
  for (int h = 0; h < H; ++h) {
    const int c0 = h * dh;
    head_scores(qb, kb, km, qs, kv, p, rows, Tk, C, c0, dh, scale);
    for (int r = warp; r < rows; r += kWarps) {
      float* pr = p + r * Tk;
      const float* gr = gb + (size_t)r * Tk;
      row_softmax(pr, Tk, lane);
      float n = 0.f;
      for (int j = lane; j < Tk; j += 32) {
        const float a = pr[j] * gr[j];
        pr[j] = a;
        n += renorm == 0 ? fabsf(a) : a;
      }
      n = warp_sum(n);
      const float denom = renorm == 0 ? fmaxf(n, kL1Eps) : n + kSumEps;
      const float qmr = qm[r];
      for (int j = lane; j < Tk; j += 32) pr[j] = to_float(from_float<T>(pr[j] / denom * qmr));
    }
    for (int j0 = 0; j0 < Tk; j0 += kKeyChunk) {
      const int nk = min(kKeyChunk, Tk - j0);
      __syncthreads();  // weights final; the previous chunk's readers of kv done
      for (int i = tid; i < nk * dh; i += kThreads) {
        const int j = i / dh, d = i - j * dh;
        kv[j * (dh + 1) + d] = to_float(vb[(size_t)(j0 + j) * C + c0 + d]);
      }
      __syncthreads();
      for (int i = tid; i < rows * dh; i += kThreads) {
        const int r = i / dh, d = i - r * dh;
        const float* pr = p + r * Tk + j0;
        float s = 0.f;
        for (int j = 0; j < nk; ++j) s = fmaf(pr[j], kv[j * (dh + 1) + d], s);
        float* a = acc + r * C + c0 + d;
        *a = j0 == 0 ? s : *a + s;
      }
    }
    __syncthreads();  // acc of this head complete
  }

  // ---- 2. LayerNorm backward: acc becomes x - mean, then dO ----
  for (int r = warp; r < rows; r += kWarps) {
    float* xr = acc + r * C;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float x = xr[c] + to_float(rb[(size_t)r * C + c]);
      xr[c] = x;
      s += x;
    }
    const float mean = warp_sum(s) / (float)C;
    float ss = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = xr[c] - mean;
      xr[c] = d;
      ss += d * d;
    }
    const float var = warp_sum(ss) / (float)max(C - 1, 1);
    const float sd = var > 0.f ? sqrtf(var) : 0.f;
    if (lane == 0) {
      rowst[r * kStats + 0] = 1.f / (sd + kLnEps);
      rowst[r * kStats + 1] = sd;
      rowst[r * kStats + 2] = var > 0.f ? 1.f : 0.f;
    }
  }
  __syncthreads();
  // per-block dgamma / dbeta partials, one column per thread
  float* part = partials + ((size_t)b * gridDim.x + blockIdx.x) * 2 * C;
  for (int c = tid; c < C; c += kThreads) {
    float sg = 0.f, sb = 0.f;
    for (int r = 0; r < rows; ++r) {
      const float g = to_float(dyb[(size_t)r * C + c]);
      sb += g;
      sg += g * (acc[r * C + c] * rowst[r * kStats + 0]);
    }
    part[c] = sg;
    part[C + c] = sb;
  }
  __syncthreads();  // every reader of x - mean done
  float* dob = dout + ((size_t)b * Tq + row0) * C;
  for (int r = warp; r < rows; r += kWarps) {
    float* xr = acc + r * C;
    const float inv = rowst[r * kStats + 0];
    const float sd = rowst[r * kStats + 1];
    const bool nonzero = rowst[r * kStats + 2] != 0.f;
    float sum_dxh = 0.f, ssum = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float dxh = to_float(dyb[(size_t)r * C + c]) * gamma[c];
      sum_dxh += dxh;
      ssum += dxh * xr[c];
    }
    const float mean_dxh = warp_sum(sum_dxh) / (float)C;
    ssum = warp_sum(ssum);
    const float coef = nonzero ? ssum * inv * inv / ((float)max(C - 1, 1) * sd) : 0.f;
    for (int c = lane; c < C; c += 32) {
      const float dxh = to_float(dyb[(size_t)r * C + c]) * gamma[c];
      const float dx = (dxh - mean_dxh) * inv - xr[c] * coef;
      xr[c] = dx;
      dob[(size_t)r * C + c] = dx;
      dres[((size_t)b * Tq + row0 + r) * C + c] = from_float<T>(dx);
    }
  }
  __syncthreads();  // acc holds dO

  // ---- 3. per head: dA, dS and dQ; statistics for K2b ----
  for (int h = 0; h < H; ++h) {
    const int c0 = h * dh;
    head_scores(qb, kb, km, qs, kv, p, rows, Tk, C, c0, dh, scale);
    for (int r = warp; r < rows; r += kWarps) {
      float* pr = p + r * Tk;
      const float* gr = gb + (size_t)r * Tk;
      const float2 mz = row_softmax(pr, Tk, lane);
      float rsum = 0.f;
      for (int j = lane; j < Tk; j += 32) rsum += pr[j] * gr[j];
      rsum = warp_sum(rsum);
      if (lane == 0) {
        float* st = rowst + r * kStats;
        st[0] = mz.x;
        st[1] = mz.y;
        st[2] = renorm == 0 ? fmaxf(rsum, kL1Eps) : rsum + kSumEps;
        st[3] = renorm == 0 ? (rsum > kL1Eps ? 1.f : 0.f) : 1.f;
      }
    }
    // dA = dO_h V_h^T into dd
    for (int j0 = 0; j0 < Tk; j0 += kKeyChunk) {
      const int nk = min(kKeyChunk, Tk - j0);
      __syncthreads();  // P and rowst written; the previous chunk's readers of kv done
      for (int i = tid; i < nk * dh; i += kThreads) {
        const int j = i / dh, d = i - j * dh;
        kv[j * (dh + 1) + d] = to_float(vb[(size_t)(j0 + j) * C + c0 + d]);
      }
      __syncthreads();
      for (int i = tid; i < rows * nk; i += kThreads) {
        const int r = i / nk, j = i - r * nk;
        const float* dor = acc + r * C + c0;
        const float* vr = kv + j * (dh + 1);
        float s = 0.f;
        for (int d = 0; d < dh; ++d) s = fmaf(dor[d], vr[d], s);
        dd[r * Tk + j0 + j] = s;
      }
    }
    __syncthreads();
    // renorm and softmax backward, one warp per row: dd becomes dS
    for (int r = warp; r < rows; r += kWarps) {
      const float* pr = p + r * Tk;
      float* dr = dd + r * Tk;
      const float* gr = gb + (size_t)r * Tk;
      float* st = rowst + r * kStats;
      const float rr = st[2], live = st[3], qmr = qm[r];
      float inner = 0.f;
      for (int j = lane; j < Tk; j += 32) inner += (dr[j] * qmr) * (pr[j] * gr[j]);
      inner = warp_sum(inner);
      float dpp = 0.f;
      for (int j = lane; j < Tk; j += 32) {
        const float g = pr[j] * gr[j];
        const float dp = d_graph_weight(dr[j] * qmr, g, rr, live, inner, renorm) * gr[j];
        dr[j] = dp;
        dpp += dp * pr[j];
      }
      dpp = warp_sum(dpp);
      for (int j = lane; j < Tk; j += 32)
        dr[j] = km[j] == 0.f ? 0.f : pr[j] * (dr[j] - dpp) * scale;
      if (lane == 0) {
        float* out = stats + (((size_t)b * H + h) * Tq + row0 + r) * kStats;
        out[0] = st[0];
        out[1] = st[1];
        out[2] = rr;
        out[3] = live;
        out[4] = inner;
        out[5] = dpp;
      }
    }
    // dQ_h = dS K_h, accumulated in qs
    for (int j0 = 0; j0 < Tk; j0 += kKeyChunk) {
      const int nk = min(kKeyChunk, Tk - j0);
      __syncthreads();  // dS final; the previous chunk's readers of kv done
      for (int i = tid; i < nk * dh; i += kThreads) {
        const int j = i / dh, d = i - j * dh;
        kv[j * (dh + 1) + d] = to_float(kb[(size_t)(j0 + j) * C + c0 + d]);
      }
      __syncthreads();
      for (int i = tid; i < rows * dh; i += kThreads) {
        const int r = i / dh, d = i - r * dh;
        const float* dr = dd + r * Tk + j0;
        float s = 0.f;
        for (int j = 0; j < nk; ++j) s = fmaf(dr[j], kv[j * (dh + 1) + d], s);
        qs[i] = j0 == 0 ? s : qs[i] + s;
      }
    }
    __syncthreads();
    for (int i = tid; i < rows * dh; i += kThreads) {
      const int r = i / dh, d = i - r * dh;
      dq[((size_t)b * Tq + row0 + r) * C + c0 + d] = from_float<T>(qs[i]);
    }
    __syncthreads();  // qs, p, dd and rowst free for the next head
  }
}

// Shared memory: ks, vs (kKTile, dh + 1) | qc, dc (kQChunk, dh)
//                | aw, sw (kQChunk, kKTile + 1) | st (kQChunk, kStats) | qmc (kQChunk)
template <typename T>
__global__ void __launch_bounds__(kThreads)
graph_attention_ln_bwd_keys_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ key_mask, const float* __restrict__ query_mask,
    const float* __restrict__ graph, const float* __restrict__ dout,
    const float* __restrict__ stats, T* __restrict__ dk, T* __restrict__ dv, int Tq, int Tk,
    int C, int H, int renorm, float scale) {
  extern __shared__ float smem[];
  const int j0 = blockIdx.x * kKTile;
  const int nk = min(kKTile, Tk - j0);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int dh = C / H;
  const int c0 = h * dh;
  const int tid = threadIdx.x;

  float* ks = smem;
  float* vs = ks + kKTile * (dh + 1);
  float* qc = vs + kKTile * (dh + 1);
  float* dc = qc + kQChunk * dh;
  float* aw = dc + kQChunk * dh;
  float* sw = aw + kQChunk * (kKTile + 1);
  float* st = sw + kQChunk * (kKTile + 1);
  float* qmc = st + kQChunk * kStats;

  const float* km = key_mask + (size_t)b * Tk + j0;
  for (int i = tid; i < nk * dh; i += kThreads) {
    const int j = i / dh, d = i - j * dh;
    const size_t at = ((size_t)b * Tk + j0 + j) * C + c0 + d;
    ks[j * (dh + 1) + d] = to_float(k[at]);
    vs[j * (dh + 1) + d] = to_float(v[at]);
  }

  float acc_k[kPer], acc_v[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) acc_k[u] = acc_v[u] = 0.f;

  for (int r0 = 0; r0 < Tq; r0 += kQChunk) {
    const int nr = min(kQChunk, Tq - r0);
    __syncthreads();  // ks, vs loaded; the previous chunk's readers done
    for (int i = tid; i < nr * dh; i += kThreads) {
      const int r = i / dh, d = i - r * dh;
      const size_t at = ((size_t)b * Tq + r0 + r) * C + c0 + d;
      qc[i] = to_float(q[at]);
      dc[i] = dout[at];
    }
    for (int i = tid; i < nr * kStats; i += kThreads)
      st[i] = stats[(((size_t)b * H + h) * Tq + r0) * kStats + i];
    for (int i = tid; i < nr; i += kThreads) qmc[i] = query_mask[(size_t)b * Tq + r0 + i];
    __syncthreads();
    for (int i = tid; i < nr * nk; i += kThreads) {
      const int r = i / nk, j = i - r * nk;
      const float* qr = qc + r * dh;
      const float* dr = dc + r * dh;
      const float* kr = ks + j * (dh + 1);
      const float* vr = vs + j * (dh + 1);
      float s = 0.f, da = 0.f;
      for (int d = 0; d < dh; ++d) {
        s = fmaf(qr[d], kr[d], s);
        da = fmaf(dr[d], vr[d], da);
      }
      const float* sr = st + r * kStats;
      const bool masked = km[j] == 0.f;
      const float pj = expf((masked ? kNegMask : s * scale) - sr[0]) / sr[1];
      const float gj = graph[((size_t)b * Tq + r0 + r) * Tk + j0 + j];
      const float g = pj * gj;
      const float qmr = qmc[r];
      aw[r * (kKTile + 1) + j] = g / sr[2] * qmr;
      const float dp = d_graph_weight(da * qmr, g, sr[2], sr[3], sr[4], renorm) * gj;
      sw[r * (kKTile + 1) + j] = masked ? 0.f : pj * (dp - sr[5]) * scale;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = tid + u * kThreads;
      if (i < nk * dh) {
        const int j = i / dh, d = i - j * dh;
        float sk = acc_k[u], sv = acc_v[u];
        for (int r = 0; r < nr; ++r) {
          sv = fmaf(aw[r * (kKTile + 1) + j], dc[r * dh + d], sv);
          sk = fmaf(sw[r * (kKTile + 1) + j], qc[r * dh + d], sk);
        }
        acc_k[u] = sk;
        acc_v[u] = sv;
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = tid + u * kThreads;
    if (i < nk * dh) {
      const int j = i / dh, d = i - j * dh;
      const size_t at = ((size_t)b * Tk + j0 + j) * C + c0 + d;
      dk[at] = from_float<T>(acc_k[u]);
      dv[at] = from_float<T>(acc_v[u]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const float* key_mask,
                   const float* query_mask, const float* graph, const void* residual,
                   const float* gamma, const void* dy, void* dq, void* dk, void* dv, void* dres,
                   float* partials, float* dout, float* stats, int B, int Tq, int Tk, int C,
                   int H, int renorm, float scale, cudaStream_t stream) {
  const int tile = Tq < kQTile ? Tq : kQTile;
  const int dh = C / H;
  const size_t smem_a =
      sizeof(float) * ((size_t)tile * C + 2 * (size_t)tile * Tk + (size_t)tile * dh +
                       (size_t)kKeyChunk * (dh + 1) + (size_t)tile * kStats);
  cudaError_t err = cudaFuncSetAttribute(graph_attention_ln_bwd_rows_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_a);
  if (err != cudaSuccess) return err;
  const dim3 grid_a((Tq + tile - 1) / tile, B);
  graph_attention_ln_bwd_rows_kernel<T><<<grid_a, kThreads, smem_a, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), key_mask,
      query_mask, graph, static_cast<const T*>(residual), gamma, static_cast<const T*>(dy),
      static_cast<T*>(dq), static_cast<T*>(dres), partials, dout, stats, Tq, Tk, C, H, renorm,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_b =
      sizeof(float) * (2 * (size_t)kKTile * (dh + 1) + 2 * (size_t)kQChunk * dh +
                       2 * (size_t)kQChunk * (kKTile + 1) + (size_t)kQChunk * kStats + kQChunk);
  err = cudaFuncSetAttribute(graph_attention_ln_bwd_keys_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_b);
  if (err != cudaSuccess) return err;
  const dim3 grid_b((Tk + kKTile - 1) / kKTile, H, B);
  graph_attention_ln_bwd_keys_kernel<T><<<grid_b, kThreads, smem_b, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), key_mask,
      query_mask, graph, dout, stats, static_cast<T*>(dk), static_cast<T*>(dv), Tq, Tk, C, H,
      renorm, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. renorm: 0 = l1, 1 = sum_eps.
// partials: (B * ceil(Tq / min(16, Tq)), 2, C) f32, per-block dgamma / dbeta.
// dout: (B, Tq, C) f32 and stats: (B, H, Tq, 8) f32 are scratch passed
// between the two launches. Returns cudaGetLastError() after the launches.
extern "C" int savqa_graph_attention_ln_bwd(
    const void* q, const void* k, const void* v, const void* key_mask, const void* query_mask,
    const void* graph, const void* residual, const void* gamma, const void* dy, void* dq,
    void* dk, void* dv, void* dres, void* partials, void* dout, void* stats, int B, int Tq,
    int Tk, int C, int H, int renorm, int dtype, float scale, void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || C % H != 0 || C / H > kMaxDh ||
      (renorm != 0 && renorm != 1))
    return (int)cudaErrorInvalidValue;
  const auto* km = static_cast<const float*>(key_mask);
  const auto* qm = static_cast<const float*>(query_mask);
  const auto* g = static_cast<const float*>(graph);
  const auto* ga = static_cast<const float*>(gamma);
  auto* pa = static_cast<float*>(partials);
  auto* dout_f = static_cast<float*>(dout);
  auto* st = static_cast<float*>(stats);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, km, qm, g, residual, ga, dy, dq, dk, dv, dres, pa, dout_f,
                              st, B, Tq, Tk, C, H, renorm, scale, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, km, qm, g, residual, ga, dy, dq, dk, dv, dres, pa,
                                      dout_f, st, B, Tq, Tk, C, H, renorm, scale, s);
  return (int)cudaErrorInvalidValue;
}
