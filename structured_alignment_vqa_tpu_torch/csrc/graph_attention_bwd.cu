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
//   attention: dV = A^T dO; dA = dO V^T; dN = dA qmask_i
//              dG = dN / r - live sign(G) (sum dN G) / r^2  (sum_eps: no live, no sign)
//              dP = dG graph; dS = P (dP - sum dP P), 0 on masked keys, * scale
//              dQ = dS K; dK = dS^T Q
// Every product takes its operands in the inputs' type T and sums in f32: A
// is rounded to T once (for O and for dV alike), dO once after the LayerNorm
// backward (dresidual is that value) and dS once after the softmax backward.
// In f32 these roundings do nothing.
//
// What bounds it on an H100: bytes. At the training shapes (B 128, C 512,
// L 128, bf16) it must read q, k, v, residual, dy (bf16), the f32 graph and
// the masks and write dq, dk, dv and dresidual: ~160 MB, ~48 us at 3.35 TB/s,
// against ~12 B Tq Tk C = 13 GFLOP (13 us at the bf16 tensor-core peak). In
// f32 the operations bound it (67 TFLOP/s outside the tensor cores). Far
// above either bound, what sets the time of the bf16 path is the length of
// one block's chain of dependent steps in the rows launch (below).
//
// Design: two launches, the dq / dkv split of the TPU package's flash
// backward (K5 / K6), because dK and dV sum over every query row and blocks
// cannot share a sum. No atomics: every sum comes out the same on every run.
// Rows whose graph is all zero (the encoder's stage-1 graph on modality rows)
// have r = 1e-12 and dN / r ~ 1e12 dN; that stays in f32 and is multiplied
// by G (0) before anything else.
//
// The bf16 path (head widths that are multiples of 16): all six products on
// the tensor cores (mma.sync m16n8k16, f32 accumulators, csrc/mma_sm90.cuh),
// operands as bf16 tiles in shared memory filled by cp.async.
// * Rows launch, one block of 2 warps per (batch, 32 query rows), all heads,
//   16 rows a warp; two blocks share an SM (x - mean of whole rows must stay
//   on chip for the LayerNorm backward: 32 x C f32 is the largest tile).
//   Nothing of size (rows, Tk) is kept: each pass over the keys rebuilds the
//   64-key score fragments from Q K^T on the tensor cores and the row's
//   maximum and sum. Per head, section 1: pass A gets m, z and sum e g
//   online, pass B forms A, rounds it and accumulates O = A V into the f32
//   row tile. Section 2 is the LayerNorm backward (8 lanes a row, 16-byte
//   accesses), which leaves dO as bf16 in shared memory. Per head, section
//   3: pass C gets s1 = sum dA G and s2 = sum |G|, which give both row sums
//   of the renorm and softmax backwards (inner = qmask s1, sum dP P = c1 s1
//   - c2 s2); pass E forms dS, rounds it and accumulates dQ = dS K. K and V
//   tiles stream through a two-stage ring; up to 128 keys the ring holds a
//   head's K and V whole and the second pass of a section reads them in
//   place. The ring and the dO tile take turns in the room the row tile and
//   the first ring leave free. A ragged last step skips its empty 8-key
//   blocks. The decoder's one-query calls run here too: a block's time is
//   its chain of steps whatever its rows, and it measured shorter than the
//   SIMT rows launch.
// * Keys launch, one block of 4 warps per (batch, head, 64 keys), 16 keys a
//   warp: K and V stay in registers as A operands, the query rows stream
//   past 64 at a time with their per-row constants (m, 1 / z, qmask / r,
//   c2, sum dP P from the rows launch) and dO (the bf16 dresidual), and dV
//   += A^T dO and dK += dS^T Q accumulate in fragments.
//
// f32 takes four register-tiled FFMA kernels (TF32 would not
// hold the 1e-4 the f32 path is checked to), counted as one launch, built
// from csrc/simt_f32.cuh's tiles (a warp owns 16 rows, a lane a 4 x 4 or
// 4 x 8 tile of scores and a 4 x (dh / 8) tile of an output; operands in
// swizzled shared tiles filled by cp.async rings):
// * forward, per (head, 64 query rows, batch): K4's f32 body with emit
//   "stats", which computes K1's output O (its renorm written with the
//   softmax sum z and b = sum e g: A = e g / max(b, 1e-12 z)) into f32
//   scratch and m, z, b per (batch, head, row) into the stats scratch.
// * LayerNorm backward, per (batch, row tile of bwd_row_tile rows), a warp
//   a row: x = O + residual, dO = dresidual (f32), the tile's dgamma and
//   dbeta partials. The entry from d(o) skips it.
// * dq, per (head, 64 query rows, batch), keys 32 a step: with delta = dO .
//   O per head row (dO . O = inner / r), both row sums of the renorm and
//   softmax backwards are known before the first key: c1 = qmask / r, c2 =
//   live delta / r (sum_eps: delta / r), dpp = sum dP P = delta (1 - live
//   sum G / r). Per step S = Q K^T and dA = dO V^T, P dP = (dA c1 - c2
//   sign(G)) G, dS = P dP - P dpp (0 on masked keys, scaled), dQ += dS K
//   (dS through the warp's own rows of the graph tile). It writes m, 1 / z,
//   c1, c2, dpp for the dkv kernel over the forward's m, z, b.
// * dkv, per (head, 64 keys, batch), query rows 32 a step: S^T = K Q^T,
//   dA^T = V dO^T, the weights A and dS^T from the rows' constants, dV +=
//   A^T dO, dK += dS^T Q through a warp's transposed tile.
// Nine FFMA products against the six of the bound; O and dO pass through
// device memory (f32, ~67 MB at B 128, L 128, C 512) instead of the SIMT
// rows launch's shared tile of all heads.
//
// Head widths above 256, and SIMT calls whose single row does not fit a
// block, take the wide path (ops/fused_graph_attention.py "wide"): the
// wide K4 kernel with emit 3 (K1's output O and m, z, b), this file's
// LayerNorm backward at any C (graph_attention_ln_bwd_ln_wide_kernel,
// entry savqa_attention_ln_bwd), then K5's and K6's kernels
// (csrc/flash_graph_attention_bwd.cu, the wide ones above 256) from dO =
// dresidual and delta = dO . O. The f32 path above C 2,048 keeps its
// kernels but takes that LayerNorm backward too.
//
// The first SIMT kernels take every other call (path 0): bf16 at a head
// width that is no multiple of 16 or above 128, or where the tensor-core
// rows launch does not fit (C 2,048 at 16 heads and C 4,096 at 32: 32 rows
// of C + 8 f32 and bf16), and f32 at a head width that is no multiple of 4
// or above 128; head widths up to 256 in both dtypes, any C whose rows fit.
// They were never redesigned:
// * Rows launch, one block of 256 threads per (batch, tile of up to 16 query
//   rows; fewer where 16 rows of C + 2 Tk floats do not fit, the caller's
//   choice, ops/fused_graph_attention.py:simt_rows), all heads, as K1: the
//   forward output of all heads into shared
//   memory, the LayerNorm backward, then per head P, dA, dS in shared memory
//   and dQ; dO goes to the keys launch in f32 with, per (batch, head, row),
//   the softmax max and sum, r, live, sum dN G and sum dP P.
// * Keys launch, one block per (batch, head, tile of 32 keys; 16 at head
//   widths above 128), the query rows 16 at a time, dV and dK in registers
//   (16 of each a thread). Plain FMAs on CUDA cores.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "mma_sm90.cuh"
#include "simt_f32.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQTile = 16;      // K2a: query rows per block
constexpr int kKeyChunk = 64;   // K2a: keys staged in shared memory at a time
constexpr int kQChunk = 16;     // K2b: query rows per step
constexpr int kMaxDh = 256;     // the SIMT kernels' widest head
constexpr int kPer = 16;        // K2b accumulators a thread: KT keys x dh <= 16 x 256
// K2b: keys per block, 32 up to head width 128, 16 above
inline int keys_tile(int dh) { return dh <= 128 ? 32 : 16; }
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
    float* __restrict__ stats, int Tq, int Tk, int C, int H, int renorm, float scale,
    int from_do, int tile) {
  extern __shared__ float smem[];
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

  if (from_do) {   // dy is dO itself (savqa_graph_attention_bwd): no forward, no LayerNorm
    float* dob = dout + ((size_t)b * Tq + row0) * C;
    for (int i = tid; i < rows * C; i += kThreads) {
      const float d = to_float(dyb[i]);
      acc[i] = d;
      dob[i] = d;
    }
  } else {
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
        // dO enters the products in T: rounded once, here; dresidual is that value
        const T dxt = from_float<T>((dxh - mean_dxh) * inv - xr[c] * coef);
        xr[c] = to_float(dxt);
        dob[(size_t)r * C + c] = to_float(dxt);
        dres[((size_t)b * Tq + row0 + r) * C + c] = dxt;
      }
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
        dr[j] = km[j] == 0.f ? 0.f : to_float(from_float<T>(pr[j] * (dr[j] - dpp) * scale));
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

// Shared memory: ks, vs (KT, dh + 1) | qc, dc (kQChunk, dh)
//                | aw, sw (kQChunk, KT + 1) | st (kQChunk, kStats) | qmc (kQChunk)
template <typename T, int KT>
__global__ void __launch_bounds__(kThreads)
graph_attention_ln_bwd_keys_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ key_mask, const float* __restrict__ query_mask,
    const float* __restrict__ graph, const float* __restrict__ dout,
    const float* __restrict__ stats, T* __restrict__ dk, T* __restrict__ dv, int Tq, int Tk,
    int C, int H, int renorm, float scale) {
  extern __shared__ float smem[];
  const int j0 = blockIdx.x * KT;
  const int nk = min(KT, Tk - j0);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int dh = C / H;
  const int c0 = h * dh;
  const int tid = threadIdx.x;

  float* ks = smem;
  float* vs = ks + KT * (dh + 1);
  float* qc = vs + KT * (dh + 1);
  float* dc = qc + kQChunk * dh;
  float* aw = dc + kQChunk * dh;
  float* sw = aw + kQChunk * (KT + 1);
  float* st = sw + kQChunk * (KT + 1);
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
      aw[r * (KT + 1) + j] = to_float(from_float<T>(g / sr[2] * qmr));
      const float dp = d_graph_weight(da * qmr, g, sr[2], sr[3], sr[4], renorm) * gj;
      sw[r * (KT + 1) + j] =
          masked ? 0.f : to_float(from_float<T>(pj * (dp - sr[5]) * scale));
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = tid + u * kThreads;
      if (i < nk * dh) {
        const int j = i / dh, d = i - j * dh;
        float sk = acc_k[u], sv = acc_v[u];
        for (int r = 0; r < nr; ++r) {
          sv = fmaf(aw[r * (KT + 1) + j], dc[r * dh + d], sv);
          sk = fmaf(sw[r * (KT + 1) + j], qc[r * dh + d], sk);
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
                   int H, int renorm, float scale, int from_do, int tile, cudaStream_t stream) {
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
      scale, from_do, tile);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int kt = keys_tile(dh);
  const size_t smem_b =
      sizeof(float) * (2 * (size_t)kt * (dh + 1) + 2 * (size_t)kQChunk * dh +
                       2 * (size_t)kQChunk * (kt + 1) + (size_t)kQChunk * kStats + kQChunk);
  auto keys_kernel = kt == 32 ? graph_attention_ln_bwd_keys_kernel<T, 32>
                              : graph_attention_ln_bwd_keys_kernel<T, 16>;
  err = cudaFuncSetAttribute(keys_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_b);
  if (err != cudaSuccess) return err;
  const dim3 grid_b((Tk + kt - 1) / kt, H, B);
  keys_kernel<<<grid_b, kThreads, smem_b, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), key_mask,
      query_mask, graph, dout, stats, static_cast<T*>(dk), static_cast<T*>(dv), Tq, Tk, C, H,
      renorm, scale);
  return cudaGetLastError();
}


// ---- the tensor-core kernels (bf16, head width a multiple of 16) ----

using bf16 = __nv_bfloat16;
using savqa::accumulate_ab;
using savqa::cp_async16;
using savqa::cp_async4;
using savqa::cp_async_commit;
using savqa::cp_async_wait;
using savqa::fast_exp2;
using savqa::frag_a_row;
using savqa::ldmatrix_x4;
using savqa::load_graph_frag;
using savqa::pack_bf16;
using savqa::product_abt;
using savqa::quad_max;
using savqa::quad_sum;
using savqa::stage_head_tile;

constexpr int kTcRows = 32;       // rows launch: query rows per block, 16 a warp
constexpr int kTcRowThreads = 64;
constexpr int kTcKeys = 64;       // keys launch: keys per block, 16 a warp
constexpr int kTcKeyThreads = 128;
constexpr int kStep = 64;         // keys (rows launch) or query rows (keys launch) per step
constexpr int kNS = kStep / 8;    // 8-wide accumulator blocks of a step
constexpr float kLog2e = 1.4426950408889634f;
// per (batch, head, row) constants the rows launch hands to the keys launch
// (kStats floats): m in units of log 2, 1 / z, c1 = qmask / r,
// c2 = live inner / r^2 (sum_eps: inner / r^2), dpp = sum dP P
enum { kStM = 0, kStInvZ = 1, kStC1 = 2, kStC2 = 3, kStDpp = 4 };

// Sum over the 8 lanes that share a row in the LayerNorm backward.
__device__ __forceinline__ float group8_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

// Eight consecutive values (32- or 16-byte aligned) to and from registers.
__device__ __forceinline__ void load8(float (&x)[8], const float* p) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
  x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
}

__device__ __forceinline__ void load8(float (&x)[8], const bf16* p) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // a bf16 is the upper half of an f32
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store8(float* p, const float (&x)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(x[4], x[5], x[6], x[7]);
}

// One pass of the rows launch over the keys of head c0, 64 at a time,
// through a two-stage ring of (K, V) tiles filled with cp.async: the copies
// of step j + 1 overlap body(j, Ks, Vs). With `with_q` the head's Q tile is
// staged too and has landed before body(0, ..). Up to 128 keys the ring
// holds every tile of the head, and a later pass over the same head reads
// them where they are (`load` false: no copy and no barrier).
template <int DH, typename Body>
__device__ __forceinline__ void key_pass(bf16* ring, bf16* Qs, const bf16* qb, const bf16* kb,
                                         const bf16* vb, int row0, int Tq, int Tk, int C, int c0,
                                         int dh, bool with_q, bool with_v, bool load_tiles,
                                         Body body) {
  constexpr int kLd = DH + 8;
  const int n_steps = (Tk + kStep - 1) / kStep;
  if (!load_tiles) {
    for (int step = 0; step < n_steps; ++step) {
      const bf16* Ks = ring + (step & 1) * 2 * kStep * kLd;
      body(step, Ks, Ks + kStep * kLd);
    }
    return;
  }
  auto load = [&](int step) {
    bf16* Ks = ring + (step & 1) * 2 * kStep * kLd;
    stage_head_tile<DH, kTcRowThreads>(Ks, kb, step * kStep, Tk, kStep, C, c0, dh);
    if (with_v)
      stage_head_tile<DH, kTcRowThreads>(Ks + kStep * kLd, vb, step * kStep, Tk, kStep, C, c0, dh);
  };
  __syncthreads();   // the previous pass's readers of the ring and of Qs are done
  if (with_q) stage_head_tile<DH, kTcRowThreads>(Qs, qb, row0, Tq, kTcRows, C, c0, dh);
  load(0);
  cp_async_commit();
  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<0>();
    __syncthreads();   // this step's tiles have landed; the other stage's readers are done
    if (step + 1 < n_steps) load(step + 1);
    cp_async_commit();
    const bf16* Ks = ring + (step & 1) * 2 * kStep * kLd;
    body(step, Ks, Ks + kStep * kLd);
  }
  cp_async_wait<0>();
}

// Rows launch. Shared memory:
//   X: acc (32, C + 8) f32 in sections 1-2, the (K, V) ring in section 3
//   Y: the (K, V) ring in section 1, dO (32, C + 8) bf16 in sections 2-3
//   Qs (32, DH + 8) bf16 | kmul, kfill (ceil(Tk / 64) * 64) f32
//   | hstat (H, 32, 4) f32 | rowst (32, 4) f32
template <int DH>
__global__ void __launch_bounds__(kTcRowThreads)
graph_attention_ln_bwd_rows_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ key_mask, const float* __restrict__ query_mask,
    const float* __restrict__ graph, const bf16* __restrict__ residual,
    const float* __restrict__ gamma, const bf16* __restrict__ dy, bf16* __restrict__ dq,
    bf16* __restrict__ dres, float* __restrict__ partials, float* __restrict__ stats, int Tq,
    int Tk, int C, int H, int dh, int renorm, float scale, int x_bytes, int y_bytes,
    int from_do) {
  constexpr int kLd = DH + 8;
  constexpr int kKD = DH / 16;
  constexpr int kND = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldc = C + 8;
  const int n_steps = (Tk + kStep - 1) / kStep;
  float* acc = reinterpret_cast<float*>(smem_raw);
  bf16* dOs = reinterpret_cast<bf16*>(smem_raw + x_bytes);
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw + x_bytes + y_bytes);
  float* kmul = reinterpret_cast<float*>(Qs + kTcRows * kLd);
  float* kfill = kmul + n_steps * kStep;
  float* hstat = kfill + n_steps * kStep;
  float* rowst = hstat + H * kTcRows * 4;

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kTcRows;
  const int rows = min(kTcRows, Tq - row0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int lrow_a = warp * 16 + g;   // this lane's two rows within the tile
  const int lrow_b = lrow_a + 8;
  const bool real_a = lrow_a < rows, real_b = lrow_b < rows;
  const bool active = warp * 16 < rows;   // this warp holds a real row
  const bool graph_pairs = (Tk & 1) == 0;
  const float scale2 = scale * kLog2e;
  const bool resident = n_steps <= 2;   // the ring holds all K and V of a head

  const bf16* qb = q + (size_t)b * Tq * C;
  const bf16* kb = k + (size_t)b * Tk * C;
  const bf16* vb = v + (size_t)b * Tk * C;
  const float* graph_a = graph + ((size_t)b * Tq + row0 + (real_a ? lrow_a : 0)) * Tk;
  const float* graph_b = graph + ((size_t)b * Tq + row0 + (real_b ? lrow_b : 0)) * Tk;
  const float qm_a = real_a ? query_mask[(size_t)b * Tq + row0 + lrow_a] : 0.f;
  const float qm_b = real_b ? query_mask[(size_t)b * Tq + row0 + lrow_b] : 0.f;
  const bf16* rb = residual + ((size_t)b * Tq + row0) * C;
  const bf16* dyb = dy + ((size_t)b * Tq + row0) * C;

  // x = s * kmul + kfill is the masked score in units of log 2: (scale
  // log2(e), 0) on a real key, (0, fill) on a masked one, (0, -inf) past Tk
  for (int j = tid; j < n_steps * kStep; j += kTcRowThreads) {
    const bool in = j < Tk;
    const bool keep = in && key_mask[(size_t)b * Tk + j] != 0.f;
    kmul[j] = keep ? scale2 : 0.f;
    kfill[j] = keep ? 0.f : in ? kNegMask : -INFINITY;
  }

  uint32_t qf[kKD][4];
  auto load_q = [&]() {
#pragma unroll
    for (int kd = 0; kd < kKD; ++kd)
      ldmatrix_x4(qf[kd], frag_a_row(Qs, kLd, warp * 16, kd * 16, lane));
  };
  // the step's masked scores (log 2 units) from Q K^T
  auto scores = [&](float (&s)[kNS][4], const bf16* Ks, int step) {
    product_abt<DH, kNS>(s, qf, Ks, lane, Tk - step * kStep);
#pragma unroll
    for (int nb = 0; nb < kNS; ++nb) {
      const int j = step * kStep + nb * 8 + 2 * t;
      const float2 mul = *reinterpret_cast<const float2*>(kmul + j);
      const float2 fill = *reinterpret_cast<const float2*>(kfill + j);
      s[nb][0] = fmaf(s[nb][0], mul.x, fill.x);
      s[nb][1] = fmaf(s[nb][1], mul.y, fill.y);
      s[nb][2] = fmaf(s[nb][2], mul.x, fill.x);
      s[nb][3] = fmaf(s[nb][3], mul.y, fill.y);
    }
  };
  auto graph_step = [&](float (&gr)[kNS][4], int step) {
    load_graph_frag<kNS>(gr, graph_a, graph_b, step * kStep + 2 * t, Tk, real_a, real_b,
                         graph_pairs);
  };

  // ---- 1. the forward output of every head, as K1 computes it ----
  bf16* ring = dOs;
  for (int h = 0; h < H; ++h) {
    const int c0 = h * dh;
    // pass A: the softmax maximum m and sum z, and b = sum e g, online
    float m_a = -INFINITY, m_b = -INFINITY, z_a = 0.f, z_b = 0.f, b_a = 0.f, b_b = 0.f;
    key_pass<DH>(ring, Qs, qb, kb, vb, row0, Tq, Tk, C, c0, dh, true, resident, true,
                 [&](int step, const bf16* Ks, const bf16*) {
      if (!active) return;
      if (step == 0) load_q();
      float gr[kNS][4], s[kNS][4];
      graph_step(gr, step);
      scores(s, Ks, step);
      const int nk = Tk - step * kStep;   // real keys of this step (more than 64: all)
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int nb = 0; nb < kNS; ++nb) {
        if (nb * 8 >= nk) continue;
        mx_a = fmaxf(mx_a, fmaxf(s[nb][0], s[nb][1]));
        mx_b = fmaxf(mx_b, fmaxf(s[nb][2], s[nb][3]));
      }
      const float mn_a = fmaxf(m_a, quad_max(mx_a)), mn_b = fmaxf(m_b, quad_max(mx_b));
      const float alpha_a = fast_exp2(m_a - mn_a), alpha_b = fast_exp2(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      float sz_a = 0.f, sz_b = 0.f, sb_a = 0.f, sb_b = 0.f;
#pragma unroll
      for (int nb = 0; nb < kNS; ++nb) {
        if (nb * 8 >= nk) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float e = fast_exp2(s[nb][c] - (c < 2 ? mn_a : mn_b));
          if (c < 2) { sz_a += e; sb_a += e * gr[nb][c]; } else { sz_b += e; sb_b += e * gr[nb][c]; }
        }
      }
      z_a = z_a * alpha_a + sz_a;
      z_b = z_b * alpha_b + sz_b;
      b_a = b_a * alpha_a + sb_a;
      b_b = b_b * alpha_b + sb_b;
    });
    float iz_a = 0.f, iz_b = 0.f, c1_a = 0.f, c1_b = 0.f;
    if (active) {
      iz_a = 1.f / quad_sum(z_a);
      iz_b = 1.f / quad_sum(z_b);
      const float rs_a = quad_sum(b_a) * iz_a, rs_b = quad_sum(b_b) * iz_b;   // sum of P graph
      const float r_a = renorm == 0 ? fmaxf(rs_a, kL1Eps) : rs_a + kSumEps;
      const float r_b = renorm == 0 ? fmaxf(rs_b, kL1Eps) : rs_b + kSumEps;
      const float live_a = renorm == 0 ? (rs_a > kL1Eps ? 1.f : 0.f) : 1.f;
      const float live_b = renorm == 0 ? (rs_b > kL1Eps ? 1.f : 0.f) : 1.f;
      c1_a = qm_a / r_a;
      c1_b = qm_b / r_b;
      if (t == 0) {
        float* st = hstat + (h * kTcRows + lrow_a) * 4;
        st[0] = m_a; st[1] = iz_a; st[2] = c1_a; st[3] = live_a / (r_a * r_a);
        st = hstat + (h * kTcRows + lrow_b) * 4;
        st[0] = m_b; st[1] = iz_b; st[2] = c1_b; st[3] = live_b / (r_b * r_b);
      }
    }
    if (from_do) continue;   // dO is given: the output O is not needed
    // pass B: O = A V with A = P graph / r * qmask rounded to V's type
    float o[kND][4];
#pragma unroll
    for (int i = 0; i < kND; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
    key_pass<DH>(ring, Qs, qb, kb, vb, row0, Tq, Tk, C, c0, dh, false, true, !resident,
                 [&](int step, const bf16* Ks, const bf16* Vs) {
      if (!active) return;
      const int nk = Tk - step * kStep;
      float gr[kNS][4], s[kNS][4];
      graph_step(gr, step);
      scores(s, Ks, step);
#pragma unroll
      for (int nb = 0; nb < kNS; ++nb) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (nb * 8 >= nk) { s[nb][c] = 0.f; continue; }
          const float p = fast_exp2(s[nb][c] - (c < 2 ? m_a : m_b)) * (c < 2 ? iz_a : iz_b);
          s[nb][c] = p * gr[nb][c] * (c < 2 ? c1_a : c1_b);
        }
      }
      accumulate_ab<DH, kNS>(o, s, Vs, lane, nk);
    });
    if (active) {
#pragma unroll
      for (int i = 0; i < kND; ++i) {
        const int d = i * 8 + 2 * t;
        if (d >= dh) continue;
        *reinterpret_cast<float2*>(acc + lrow_a * ldc + c0 + d) = make_float2(o[i][0], o[i][1]);
        *reinterpret_cast<float2*>(acc + lrow_b * ldc + c0 + d) = make_float2(o[i][2], o[i][3]);
      }
    }
  }
  __syncthreads();   // acc of every head complete; the ring is free

  if (from_do) {   // dy is dO itself (savqa_graph_attention_bwd); rows past the tile are zeros
    for (int i = tid; i < kTcRows * (C / 8); i += kTcRowThreads) {
      const int r = i / (C / 8), ch = i - r * (C / 8);
      *reinterpret_cast<uint4*>(dOs + r * ldc + ch * 8) =
          r < rows ? *reinterpret_cast<const uint4*>(dyb + (size_t)r * C + ch * 8)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    // ---- 2. LayerNorm backward: acc becomes x - mean; dO, rounded, goes to dOs ----
    // Eight lanes share a row, four rows a warp at a time; a lane owns the
    // 8-channel chunks sub, sub + 8, ... of its row (16-byte loads and stores).
    const int sub = lane & 7;
    const int n_chunks = C / 8;
    constexpr int kRowsAtOnce = kTcRowThreads / 8;
    for (int r = tid >> 3; r < kTcRows; r += kRowsAtOnce) {
      const bool real = r < rows;
      float* xr = acc + r * ldc;
      float s = 0.f;
      for (int ch = sub; ch < n_chunks; ch += 8) {
        float x[8], res[8];
        load8(x, xr + ch * 8);
        if (real) load8(res, rb + (size_t)r * C + ch * 8);
  #pragma unroll
        for (int i = 0; i < 8; ++i) {
          x[i] = real ? x[i] + res[i] : 0.f;
          s += x[i];
        }
        store8(xr + ch * 8, x);
      }
      const float mean = group8_sum(s) / (float)C;
      float ss = 0.f;
      for (int ch = sub; ch < n_chunks; ch += 8) {
        float x[8];
        load8(x, xr + ch * 8);
  #pragma unroll
        for (int i = 0; i < 8; ++i) {
          x[i] -= mean;
          ss += x[i] * x[i];
        }
        store8(xr + ch * 8, x);
      }
      const float var = group8_sum(ss) / (float)max(C - 1, 1);
      const float sd = var > 0.f ? sqrtf(var) : 0.f;
      if (sub == 0) {
        rowst[r * 4 + 0] = 1.f / (sd + kLnEps);
        rowst[r * 4 + 1] = sd;
        rowst[r * 4 + 2] = var > 0.f ? 1.f : 0.f;
      }
    }
    __syncthreads();
    // per-block dgamma / dbeta partials, one column per thread
    float* part = partials + ((size_t)b * gridDim.x + blockIdx.x) * 2 * C;
    for (int c = tid; c < C; c += kTcRowThreads) {
      float sg = 0.f, sb = 0.f;
      for (int r = 0; r < rows; ++r) {
        const float gy = to_float(dyb[(size_t)r * C + c]);
        sb += gy;
        sg += gy * (acc[r * ldc + c] * rowst[r * 4 + 0]);
      }
      part[c] = sg;
      part[C + c] = sb;
    }
    for (int r = tid >> 3; r < kTcRows; r += kRowsAtOnce) {
      const bool real = r < rows;   // rows past the end of the tile enter the products as zeros
      bf16* dor = dOs + r * ldc;
      const float* xr = acc + r * ldc;
      const float inv = rowst[r * 4 + 0];
      const float sd = rowst[r * 4 + 1];
      const bool nonzero = rowst[r * 4 + 2] != 0.f;
      float sum_dxh = 0.f, ssum = 0.f;
      for (int ch = sub; ch < n_chunks && real; ch += 8) {
        float gy[8], ga[8], x[8];
        load8(gy, dyb + (size_t)r * C + ch * 8);
        load8(ga, gamma + ch * 8);
        load8(x, xr + ch * 8);
  #pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float dxh = gy[i] * ga[i];
          sum_dxh += dxh;
          ssum += dxh * x[i];
        }
      }
      const float mean_dxh = group8_sum(sum_dxh) / (float)C;
      ssum = group8_sum(ssum);
      const float coef = real && nonzero ? ssum * inv * inv / ((float)max(C - 1, 1) * sd) : 0.f;
      for (int ch = sub; ch < n_chunks; ch += 8) {
        float dx[8];
        if (real) {
          float gy[8], ga[8], x[8];
          load8(gy, dyb + (size_t)r * C + ch * 8);
          load8(ga, gamma + ch * 8);
          load8(x, xr + ch * 8);
  #pragma unroll
          for (int i = 0; i < 8; ++i) dx[i] = (gy[i] * ga[i] - mean_dxh) * inv - x[i] * coef;
        } else {
  #pragma unroll
          for (int i = 0; i < 8; ++i) dx[i] = 0.f;
        }
        // dO enters the products as bf16: rounded once, here; dresidual is that value
        const uint4 packed = make_uint4(pack_bf16(dx[0], dx[1]), pack_bf16(dx[2], dx[3]),
                                        pack_bf16(dx[4], dx[5]), pack_bf16(dx[6], dx[7]));
        *reinterpret_cast<uint4*>(dor + ch * 8) = packed;
        if (real)
          *reinterpret_cast<uint4*>(dres + ((size_t)b * Tq + row0 + r) * C + ch * 8) = packed;
      }
    }
  }
  __syncthreads();   // dOs complete; acc is dead and its room becomes the ring

  // ---- 3. per head: dA, dS and dQ; the row constants for the keys launch ----
  ring = reinterpret_cast<bf16*>(smem_raw);
  for (int h = 0; h < H; ++h) {
    const int c0 = h * dh;
    const float* st_a = hstat + (h * kTcRows + lrow_a) * 4;
    const float* st_b = hstat + (h * kTcRows + lrow_b) * 4;
    const float m_a = st_a[0], iz_a = st_a[1], c1_a = st_a[2];
    const float m_b = st_b[0], iz_b = st_b[1], c1_b = st_b[2];
    uint32_t dof[kKD][4];
#pragma unroll
    for (int kd = 0; kd < kKD; ++kd) {
      if (kd * 16 < dh) {
        ldmatrix_x4(dof[kd], frag_a_row(dOs, ldc, warp * 16, c0 + kd * 16, lane));
      } else {   // a zero-padded head: no channels of the next head
        dof[kd][0] = dof[kd][1] = dof[kd][2] = dof[kd][3] = 0u;
      }
    }
    // p = P, gq = P graph and da = dO V^T of one step
    auto tiles = [&](float (&p)[kNS][4], float (&gq)[kNS][4], float (&da)[kNS][4],
                     const bf16* Ks, const bf16* Vs, int step) {
      const int nk = Tk - step * kStep;
      graph_step(gq, step);
      scores(p, Ks, step);
      product_abt<DH, kNS>(da, dof, Vs, lane, nk);
#pragma unroll
      for (int nb = 0; nb < kNS; ++nb) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (nb * 8 >= nk) { p[nb][c] = gq[nb][c] = 0.f; continue; }   // da is zero there
          p[nb][c] = fast_exp2(p[nb][c] - (c < 2 ? m_a : m_b)) * (c < 2 ? iz_a : iz_b);
          gq[nb][c] *= p[nb][c];
        }
      }
    };
    // pass C: s1 = sum dA G and s2 = sum sign(G) G (sum_eps: sum G) give both
    // row sums of the renorm and softmax backwards, regrouped:
    //   inner = sum dN G = qmask s1
    //   dpp = sum dP P = sum (dN / r - corr / r^2) G = c1 s1 - c2 s2
    float s1_a = 0.f, s1_b = 0.f, s2_a = 0.f, s2_b = 0.f;
    key_pass<DH>(ring, Qs, qb, kb, vb, row0, Tq, Tk, C, c0, dh, true, true, true,
                 [&](int step, const bf16* Ks, const bf16* Vs) {
      if (!active) return;
      if (step == 0) load_q();
      float p[kNS][4], gq[kNS][4], da[kNS][4];
      tiles(p, gq, da, Ks, Vs, step);
#pragma unroll
      for (int nb = 0; nb < kNS; ++nb) {
        if (nb * 8 >= Tk - step * kStep) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float sg = renorm == 0 ? fabsf(gq[nb][c]) : gq[nb][c];
          if (c < 2) { s1_a += da[nb][c] * gq[nb][c]; s2_a += sg; }
          else { s1_b += da[nb][c] * gq[nb][c]; s2_b += sg; }
        }
      }
    });
    float c2_a = 0.f, c2_b = 0.f, dpp_a = 0.f, dpp_b = 0.f;
    if (active) {
      s1_a = quad_sum(s1_a);
      s1_b = quad_sum(s1_b);
      c2_a = qm_a * s1_a * st_a[3];
      c2_b = qm_b * s1_b * st_b[3];
      dpp_a = c1_a * s1_a - c2_a * quad_sum(s2_a);
      dpp_b = c1_b * s1_b - c2_b * quad_sum(s2_b);
    }
    // pass E: dS = P (dP - dpp), 0 on masked keys, scaled; dQ = dS K
    float dqa[kND][4];
#pragma unroll
    for (int i = 0; i < kND; ++i) dqa[i][0] = dqa[i][1] = dqa[i][2] = dqa[i][3] = 0.f;
    key_pass<DH>(ring, Qs, qb, kb, vb, row0, Tq, Tk, C, c0, dh, false, true, !resident,
                 [&](int step, const bf16* Ks, const bf16* Vs) {
      if (!active) return;
      float p[kNS][4], gq[kNS][4], da[kNS][4];
      tiles(p, gq, da, Ks, Vs, step);
#pragma unroll
      for (int nb = 0; nb < kNS; ++nb) {
        if (nb * 8 >= Tk - step * kStep) continue;   // p, gq and da are zero there
        const int j = step * kStep + nb * 8 + 2 * t;
        const float2 mul = *reinterpret_cast<const float2*>(kmul + j);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float corr = (c < 2 ? c2_a : c2_b) * (renorm == 0 ? sign_of(gq[nb][c]) : 1.f);
          // P dP = (dN / r - corr / r^2) G
          const float pdp = (da[nb][c] * (c < 2 ? c1_a : c1_b) - corr) * gq[nb][c];
          const float keep = (c & 1 ? mul.y : mul.x) != 0.f ? scale : 0.f;
          da[nb][c] = (pdp - p[nb][c] * (c < 2 ? dpp_a : dpp_b)) * keep;
        }
      }
      accumulate_ab<DH, kNS>(dqa, da, Ks, lane, Tk - step * kStep);
    });
    if (active) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (!(half == 0 ? real_a : real_b)) continue;
        const int row = row0 + (half == 0 ? lrow_a : lrow_b);
#pragma unroll
        for (int i = 0; i < kND; ++i) {
          const int d = i * 8 + 2 * t;
          if (d >= dh) continue;
          *reinterpret_cast<__nv_bfloat162*>(dq + ((size_t)b * Tq + row) * C + c0 + d) =
              __floats2bfloat162_rn(dqa[i][2 * half], dqa[i][2 * half + 1]);
        }
        if (t == 0) {
          float* out = stats + (((size_t)b * H + h) * Tq + row) * kStats;
          out[kStM] = half == 0 ? m_a : m_b;
          out[kStInvZ] = half == 0 ? iz_a : iz_b;
          out[kStC1] = half == 0 ? c1_a : c1_b;
          out[kStC2] = half == 0 ? c2_a : c2_b;
          out[kStDpp] = half == 0 ? dpp_a : dpp_b;
          out[5] = out[6] = out[7] = 0.f;
        }
      }
    }
  }
}

// Keys launch, one block of 4 warps per (batch, head, 64 keys), 16 keys a
// warp: K and V fragments stay in registers as A operands; the query rows
// stream past 64 at a time (Q, dO and the row constants through a two-stage
// cp.async ring) and dK, dV accumulate in fragments.
// Shared memory: Ks, Vs (64, DH + 8) bf16 | per stage Qc, dOc (64, DH + 8)
// bf16, two stages | per stage st (64, kStats) f32, two stages
template <int DH>
__global__ void __launch_bounds__(kTcKeyThreads)
graph_attention_ln_bwd_keys_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ key_mask, const float* __restrict__ graph,
    const bf16* __restrict__ d_out, const float* __restrict__ stats, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int Tq, int Tk, int C, int H, int dh, int renorm, float scale) {
  constexpr int kLd = DH + 8;
  constexpr int kKD = DH / 16;
  constexpr int kND = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kTcKeys * kLd;
  bf16* ring = Vs + kTcKeys * kLd;
  float* sts = reinterpret_cast<float*>(ring + 4 * kStep * kLd);

  const int j0 = blockIdx.x * kTcKeys;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int c0 = h * dh;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int key_a = j0 + warp * 16 + g;   // this lane's two keys
  const int key_b = key_a + 8;
  const bool active = j0 + warp * 16 < Tk;
  const float scale2 = scale * kLog2e;
  const int n_steps = (Tq + kStep - 1) / kStep;

  const bf16* qb = q + (size_t)b * Tq * C;
  const bf16* dob = d_out + (size_t)b * Tq * C;
  const float* stb = stats + ((size_t)b * H + h) * Tq * kStats;
  const float* gb = graph + (size_t)b * Tq * Tk;
  const bool keep_a = key_a < Tk && key_mask[(size_t)b * Tk + key_a] != 0.f;
  const bool keep_b = key_b < Tk && key_mask[(size_t)b * Tk + key_b] != 0.f;

  auto load = [&](int step) {
    bf16* Qc = ring + (step & 1) * 2 * kStep * kLd;
    stage_head_tile<DH, kTcKeyThreads>(Qc, qb, step * kStep, Tq, kStep, C, c0, dh);
    stage_head_tile<DH, kTcKeyThreads>(Qc + kStep * kLd, dob, step * kStep, Tq, kStep, C, c0, dh);
    // the rows' constants: kStats floats a row, two 16-byte copies; zeros past Tq
    for (int i = tid; i < kStep * 2; i += kTcKeyThreads) {
      const int r = step * kStep + (i >> 1);
      const bool valid = r < Tq;
      cp_async16(sts + (step & 1) * kStep * kStats + i * 4,
                 stb + (size_t)(valid ? r : 0) * kStats + (i & 1) * 4, valid);
    }
  };

  stage_head_tile<DH, kTcKeyThreads>(Ks, k + (size_t)b * Tk * C, j0, Tk, kTcKeys, C, c0, dh);
  stage_head_tile<DH, kTcKeyThreads>(Vs, v + (size_t)b * Tk * C, j0, Tk, kTcKeys, C, c0, dh);
  load(0);
  cp_async_commit();

  uint32_t kf[kKD][4], vf[kKD][4];
  float dka[kND][4], dva[kND][4];
#pragma unroll
  for (int i = 0; i < kND; ++i) {
    dka[i][0] = dka[i][1] = dka[i][2] = dka[i][3] = 0.f;
    dva[i][0] = dva[i][1] = dva[i][2] = dva[i][3] = 0.f;
  }

  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<0>();
    __syncthreads();   // this step's tiles have landed; the other stage's readers are done
    if (step + 1 < n_steps) load(step + 1);
    cp_async_commit();
    if (!active) continue;
    if (step == 0) {
#pragma unroll
      for (int kd = 0; kd < kKD; ++kd) {
        ldmatrix_x4(kf[kd], frag_a_row(Ks, kLd, warp * 16, kd * 16, lane));
        ldmatrix_x4(vf[kd], frag_a_row(Vs, kLd, warp * 16, kd * 16, lane));
      }
    }
    const bf16* Qc = ring + (step & 1) * 2 * kStep * kLd;
    const bf16* dOc = Qc + kStep * kLd;
    const float* st = sts + (step & 1) * kStep * kStats;
    const int r0 = step * kStep;

    // graph[row][key] of this lane's fragment entries (rows along the
    // columns: 2t, 2t + 1 of each 8-wide block), in flight during the products
    float gr[kNS][4];
#pragma unroll
    for (int nb = 0; nb < kNS; ++nb) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = r0 + nb * 8 + 2 * t + (c & 1);
        const int key = c < 2 ? key_a : key_b;
        gr[nb][c] = row < Tq && key < Tk ? __ldg(gb + (size_t)row * Tk + key) : 0.f;
      }
    }
    const int nr = Tq - r0;   // real query rows of this step (more than 64: all)
    float w[kNS][4], da[kNS][4];
    product_abt<DH, kNS>(w, kf, Qc, lane, nr);     // S^T = K Q^T: 16 keys x 64 rows
    product_abt<DH, kNS>(da, vf, dOc, lane, nr);   // dA^T = V dO^T
#pragma unroll
    for (int nb = 0; nb < kNS; ++nb) {
      if (nb * 8 >= nr) continue;   // w and da are zero there
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float* rc = st + (nb * 8 + 2 * t + (c & 1)) * kStats;   // zeros past Tq
        const bool keep = c < 2 ? keep_a : keep_b;
        const float x = keep ? w[nb][c] * scale2 : kNegMask;
        const float p = fast_exp2(x - rc[kStM]) * rc[kStInvZ];
        const float gq = p * gr[nb][c];
        const float corr = renorm == 0 ? rc[kStC2] * sign_of(gq) : rc[kStC2];
        const float pdp = (da[nb][c] * rc[kStC1] - corr) * gq;
        w[nb][c] = gq * rc[kStC1];                                      // A
        da[nb][c] = keep ? (pdp - p * rc[kStDpp]) * scale : 0.f;        // dS
      }
    }
    accumulate_ab<DH, kNS>(dva, w, dOc, lane, nr);   // dV += A^T dO
    accumulate_ab<DH, kNS>(dka, da, Qc, lane, nr);   // dK += dS^T Q
  }
  cp_async_wait<0>();
  if (!active) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = half == 0 ? key_a : key_b;
    if (key >= Tk) continue;
#pragma unroll
    for (int i = 0; i < kND; ++i) {
      const int d = i * 8 + 2 * t;
      if (d >= dh) continue;
      const size_t at = ((size_t)b * Tk + key) * C + c0 + d;
      *reinterpret_cast<__nv_bfloat162*>(dk + at) =
          __floats2bfloat162_rn(dka[i][2 * half], dka[i][2 * half + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + at) =
          __floats2bfloat162_rn(dva[i][2 * half], dva[i][2 * half + 1]);
    }
  }
}

inline size_t round16(size_t n) { return (n + 15) / 16 * 16; }

template <int DH>
cudaError_t launch_tc(const bf16* q, const bf16* k, const bf16* v, const float* key_mask,
                      const float* query_mask, const float* graph, const bf16* residual,
                      const float* gamma, const bf16* dy, bf16* dq, bf16* dk, bf16* dv,
                      bf16* dres, float* partials, float* stats, int B, int Tq, int Tk, int C,
                      int H, int renorm, float scale, int from_do, cudaStream_t stream) {
  const int dh = C / H;
  const int n_steps = (Tk + kStep - 1) / kStep;
  const size_t ring = sizeof(bf16) * 4 * kStep * (DH + 8);
  const size_t x_bytes = round16(max(sizeof(float) * kTcRows * (C + 8), ring));
  const size_t y_bytes = round16(max(sizeof(bf16) * kTcRows * (C + 8), ring));
  const size_t smem_a = x_bytes + y_bytes + sizeof(bf16) * kTcRows * (DH + 8) +
                        sizeof(float) * (2 * n_steps * kStep + (H + 1) * kTcRows * 4);
  auto rows_kernel = graph_attention_ln_bwd_rows_tc_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(
      rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
  if (err != cudaSuccess) return err;
  const dim3 grid_a((Tq + kTcRows - 1) / kTcRows, B);
  rows_kernel<<<grid_a, kTcRowThreads, smem_a, stream>>>(
      q, k, v, key_mask, query_mask, graph, residual, gamma, dy, dq, dres, partials, stats, Tq,
      Tk, C, H, dh, renorm, scale, (int)x_bytes, (int)y_bytes, from_do);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_b = sizeof(bf16) * (2 * kTcKeys + 4 * kStep) * (DH + 8) +
                        sizeof(float) * 2 * kStep * kStats;
  auto keys_kernel = graph_attention_ln_bwd_keys_tc_kernel<DH>;
  err = cudaFuncSetAttribute(keys_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_b);
  if (err != cudaSuccess) return err;
  const dim3 grid_b((Tk + kTcKeys - 1) / kTcKeys, H, B);
  // dO is dresidual (the rows launch wrote it rounded to bf16), or dy when given
  keys_kernel<<<grid_b, kTcKeyThreads, smem_b, stream>>>(
      q, k, v, key_mask, graph, from_do ? dy : dres, stats, dk, dv, Tq, Tk, C, H, dh, renorm,
      scale);
  return cudaGetLastError();
}


// ---- the f32 kernels (csrc/simt_f32.cuh) ----

namespace f32 = savqa_f32;

constexpr int kF32Keys = 64;    // dkv: keys a block, 16 a warp
constexpr int kF32Step = 32;    // dq: keys a step; dkv: query rows a step
constexpr int kLnThreads = 256;
constexpr int kF32MaxC = 2048;  // the LayerNorm backward's registers: 64 columns a lane

__host__ __device__ constexpr int dq_stage_floats(int dh, int warps) {
  return 2 * kF32Step * dh + 16 * warps * kF32Step + kF32Step;
}
__host__ __device__ constexpr int dq_smem_floats(int dh, int warps) {
  return 2 * 16 * warps * dh + 2 * dq_stage_floats(dh, warps);
}
__host__ __device__ constexpr int dkv_stage_floats(int dh) {
  return 2 * kF32Step * dh + kF32Step * kF32Keys + kF32Step * kStats;
}
__host__ __device__ constexpr int dkv_smem_floats(int dh) {
  return 2 * kF32Keys * dh + 4 * kF32Step * 16 + 2 * dkv_stage_floats(dh);
}

// 1. K1's output O of every head and the forward's m, z, b (stats slots 0-2).
template <int DH, int WARPS>
__global__ void __launch_bounds__(WARPS * 32, WARPS == 4 && DH <= 64 ? 2 : 1)
graph_attention_ln_bwd_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                      const float* __restrict__ v,
                                      const float* __restrict__ key_mask,
                                      const float* __restrict__ query_mask,
                                      const float* __restrict__ graph, float* __restrict__ o,
                                      float* __restrict__ stats, int Tq, int Tk, int C, int H,
                                      int dh, int renorm, float scale) {
  f32::flash_f32_body<DH, WARPS>(q, k, v, key_mask, query_mask, graph, o, nullptr, stats,
                                 stats + 1, stats + 2, kStats, Tq, Tk, C, H, dh, renorm, 1, scale,
                                 1, (Tk + f32::kStep - 1) / f32::kStep);
}

// 2. The LayerNorm backward of `tile` rows of batch element blockIdx.y, a
// warp a row (columns lane + 32 k, k < NK): dO = dres, and the tile's
// dgamma / dbeta partials, summed over the warps in warp order.
// Shared memory: (kLnThreads / 32, 2, C) f32.
template <int NK>
__global__ void __launch_bounds__(kLnThreads)
graph_attention_ln_bwd_ln_f32_kernel(const float* __restrict__ o, const float* __restrict__ residual,
                                     const float* __restrict__ gamma, const float* __restrict__ dy,
                                     float* __restrict__ dres, float* __restrict__ partials,
                                     int Tq, int C, int tile) {
  constexpr int kW = kLnThreads / 32;
  extern __shared__ __align__(16) float red[];
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * tile;
  const int rows = min(tile, Tq - row0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float sg[NK], sb[NK];
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) sg[kk] = sb[kk] = 0.f;
  for (int r = warp; r < rows; r += kW) {
    const size_t at = ((size_t)b * Tq + row0 + r) * C;
    float x[NK], gy[NK];
    float s = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const int c = lane + 32 * kk;
      x[kk] = c < C ? o[at + c] + residual[at + c] : 0.f;
      gy[kk] = c < C ? dy[at + c] : 0.f;
      s += x[kk];
    }
    const float mean = warp_sum(s) / (float)C;
    float ss = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      x[kk] = lane + 32 * kk < C ? x[kk] - mean : 0.f;
      ss += x[kk] * x[kk];
    }
    const float var = warp_sum(ss) / (float)max(C - 1, 1);
    const float sd = var > 0.f ? sqrtf(var) : 0.f;
    const float inv = 1.f / (sd + kLnEps);
    float sum_dxh = 0.f, ssum = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const int c = lane + 32 * kk;
      if (c >= C) continue;
      sb[kk] += gy[kk];
      sg[kk] += gy[kk] * (x[kk] * inv);
      const float dxh = gy[kk] * gamma[c];
      sum_dxh += dxh;
      ssum += dxh * x[kk];
    }
    const float mean_dxh = warp_sum(sum_dxh) / (float)C;
    ssum = warp_sum(ssum);
    const float coef = var > 0.f ? ssum * inv * inv / ((float)max(C - 1, 1) * sd) : 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const int c = lane + 32 * kk;
      if (c < C) dres[at + c] = (gy[kk] * gamma[c] - mean_dxh) * inv - x[kk] * coef;
    }
  }
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    const int c = lane + 32 * kk;
    if (c >= C) continue;
    red[2 * warp * C + c] = sg[kk];
    red[(2 * warp + 1) * C + c] = sb[kk];
  }
  __syncthreads();
  float* part = partials + ((size_t)b * gridDim.x + blockIdx.x) * 2 * C;
  for (int c = threadIdx.x; c < C; c += kLnThreads) {
    float a = 0.f, bb = 0.f;
    for (int w = 0; w < kW; ++w) {
      a += red[2 * w * C + c];
      bb += red[(2 * w + 1) * C + c];
    }
    part[c] = a;
    part[C + c] = bb;
  }
}

// 2'. The same LayerNorm backward at any C (the f32 path above C 2,048,
// and K2's wide path in either type, ops/fused_graph_attention.py
// "wide"): a tile of `tile` rows (at most kLnWideRows) of batch element
// blockIdx.y. First a warp a row takes the row's mean, 1 / (std + 1e-8),
// mean of dy gamma and the std term's coefficient in three passes over the
// row (columns lane + 32 k); then a thread a column (c = tid + 256 k) walks
// the tile's rows in order: dres = (dy gamma - mean dxh) inv - (x - mean)
// coef in T, and the column's dgamma and dbeta partials. Nothing of size C
// stays on chip. o f32, residual, dy and dres of type T.
constexpr int kLnWideRows = 64;

template <typename T>
__global__ void __launch_bounds__(kLnThreads)
graph_attention_ln_bwd_ln_wide_kernel(const float* __restrict__ o, const T* __restrict__ residual,
                                      const float* __restrict__ gamma, const T* __restrict__ dy,
                                      T* __restrict__ dres, float* __restrict__ partials, int Tq,
                                      int C, int tile) {
  constexpr int kW = kLnThreads / 32;
  __shared__ float row_mean[kLnWideRows], row_inv[kLnWideRows], row_mdxh[kLnWideRows],
      row_coef[kLnWideRows];
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * tile;
  const int rows = min(tile, Tq - row0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int r = warp; r < rows; r += kW) {
    const size_t at = ((size_t)b * Tq + row0 + r) * C;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += o[at + c] + to_float(residual[at + c]);
    const float mean = warp_sum(s) / (float)C;
    float ss = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float x = (o[at + c] + to_float(residual[at + c])) - mean;
      ss += x * x;
    }
    const float var = warp_sum(ss) / (float)max(C - 1, 1);
    const float sd = var > 0.f ? sqrtf(var) : 0.f;
    const float inv = 1.f / (sd + kLnEps);
    float sum_dxh = 0.f, ssum = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float x = (o[at + c] + to_float(residual[at + c])) - mean;
      const float dxh = to_float(dy[at + c]) * gamma[c];
      sum_dxh += dxh;
      ssum += dxh * x;
    }
    const float mean_dxh = warp_sum(sum_dxh) / (float)C;
    ssum = warp_sum(ssum);
    if (lane == 0) {
      row_mean[r] = mean;
      row_inv[r] = inv;
      row_mdxh[r] = mean_dxh;
      row_coef[r] = var > 0.f ? ssum * inv * inv / ((float)max(C - 1, 1) * sd) : 0.f;
    }
  }
  __syncthreads();
  float* part = partials + ((size_t)b * gridDim.x + blockIdx.x) * 2 * C;
  for (int c = threadIdx.x; c < C; c += kLnThreads) {
    float sg = 0.f, sb = 0.f;
    const float gc = gamma[c];
    for (int r = 0; r < rows; ++r) {
      const size_t at = ((size_t)b * Tq + row0 + r) * C + c;
      const float x = (o[at] + to_float(residual[at])) - row_mean[r];
      const float gy = to_float(dy[at]);
      sb += gy;
      sg += gy * (x * row_inv[r]);
      dres[at] = from_float<T>((gy * gc - row_mdxh[r]) * row_inv[r] - x * row_coef[r]);
    }
    part[c] = sg;
    part[C + c] = sb;
  }
}

template <typename T>
cudaError_t launch_ln_wide(const float* o, const T* residual, const float* gamma, const T* dy,
                           T* dres, float* partials, int B, int Tq, int C, int tile,
                           cudaStream_t stream) {
  if (tile < 1 || tile > kLnWideRows) return cudaErrorInvalidValue;
  const dim3 grid((Tq + tile - 1) / tile, B);
  graph_attention_ln_bwd_ln_wide_kernel<T><<<grid, kLnThreads, 0, stream>>>(
      o, residual, gamma, dy, dres, partials, Tq, C, tile);
  return cudaGetLastError();
}

// 3. dQ of (head blockIdx.x, 16 WARPS query rows blockIdx.y, batch
// blockIdx.z), keys 32 a step through a two-stage ring of (K, V, graph tile,
// key mask); Q and dO staged once. Each warp first takes its rows' delta =
// dO . O (8 lanes a row, float4 loads of O) and constants, and writes m,
// 1 / z, c1, c2, dpp (stats slots 0-4) over the forward's m, z, b.
// Shared memory: Qs, dOs (16 WARPS, DH) | two stages of Ks, Vs (32, DH), Gs
// (16 WARPS, 32), kms (32).
template <int DH, int WARPS>
__global__ void __launch_bounds__(WARPS * 32, WARPS == 4 && DH <= 64 ? 2 : 1)
graph_attention_ln_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                     const float* __restrict__ v,
                                     const float* __restrict__ key_mask,
                                     const float* __restrict__ query_mask,
                                     const float* __restrict__ graph, const float* __restrict__ o,
                                     const float* __restrict__ d_o, float* __restrict__ dq,
                                     float* __restrict__ stats, int Tq, int Tk, int C, int H,
                                     int dh, int renorm, float scale) {
  constexpr int kBQ = 16 * WARPS;
  constexpr int kThr = 32 * WARPS;
  constexpr int kStageF = dq_stage_floats(DH, WARPS);
  extern __shared__ __align__(16) float smem_dq[];
  float* Qs = smem_dq;
  float* dOs = Qs + kBQ * DH;
  float* stages = dOs + kBQ * DH;

  const int h = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const int b = blockIdx.z;
  const int c0 = h * dh;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ly = lane >> 3, lx = lane & 7;
  const int wrow = warp * 16;
  const int n_steps = (Tk + kF32Step - 1) / kF32Step;
  const bool gvec = (Tk & 3) == 0;
  const float* kb = k + (size_t)b * Tk * C;
  const float* vb = v + (size_t)b * Tk * C;
  const float* gb = graph + (size_t)b * Tq * Tk;
  const float* km = key_mask + (size_t)b * Tk;

  auto load_step = [&](int step) {
    float* base = stages + (step & 1) * kStageF;
    const int j0 = step * kF32Step;
    f32::stage_tile<DH, kThr>(base, kb, j0, Tk, kF32Step, C, c0, dh, true, f32::Swz<DH>());
    f32::stage_tile<DH, kThr>(base + kF32Step * DH, vb, j0, Tk, kF32Step, C, c0, dh, true,
                              f32::Swz<DH>());
    f32::stage_tile<kF32Step, kThr>(base + 2 * kF32Step * DH, gb, q0, Tq, kBQ, Tk, j0, Tk - j0,
                                    gvec, f32::GSwz<kF32Step>());
    float* kms = base + 2 * kF32Step * DH + kBQ * kF32Step;
    for (int j = tid; j < kF32Step; j += kThr)
      cp_async4(kms + j, km + (j0 + j < Tk ? j0 + j : 0), j0 + j < Tk);
  };
  f32::stage_tile<DH, kThr>(Qs, q + (size_t)b * Tq * C, q0, Tq, kBQ, C, c0, dh, true,
                            f32::Swz<DH>());
  f32::stage_tile<DH, kThr>(dOs, d_o + (size_t)b * Tq * C, q0, Tq, kBQ, C, c0, dh, true,
                            f32::Swz<DH>());
  load_step(0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();   // Q, dO and the first step's tiles have landed

  // the rows' constants, from delta = dO . O of the head: each warp its rows
  const bool active = q0 + wrow < Tq;
  float cm[4], ciz[4], cc1[4], cc2[4], cdpp[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + wrow + ly + 4 * i;
    const bool real = row < Tq;
    float delta = 0.f;
    if (real) {
      const float* orow = o + ((size_t)b * Tq + row) * C + c0;
#pragma unroll
      for (int g = 0; g < DH / 32; ++g) {
        const int d = 4 * lx + 32 * g;
        if (d >= dh) continue;
        const float4 o4 = *reinterpret_cast<const float4*>(orow + d);
        const float4 d4 = *reinterpret_cast<const float4*>(dOs + f32::swz<DH>(wrow + ly + 4 * i, d));
        delta = fmaf(d4.x, o4.x, delta);
        delta = fmaf(d4.y, o4.y, delta);
        delta = fmaf(d4.z, o4.z, delta);
        delta = fmaf(d4.w, o4.w, delta);
      }
    }
    delta += __shfl_xor_sync(0xffffffffu, delta, 1);
    delta += __shfl_xor_sync(0xffffffffu, delta, 2);
    delta += __shfl_xor_sync(0xffffffffu, delta, 4);
    const float* st = stats + (((size_t)b * H + h) * Tq + (real ? row : 0)) * kStats;
    const float m = real ? st[0] : 0.f, z = real ? st[1] : 1.f, bsum = real ? st[2] : 0.f;
    const float rs = bsum / z;   // sum of G = P graph
    const float rr = renorm == 0 ? fmaxf(rs, kL1Eps) : rs + kSumEps;
    const float live = renorm == 0 ? (rs > kL1Eps ? 1.f : 0.f) : 1.f;
    const float qm = real ? query_mask[(size_t)b * Tq + row] : 0.f;
    cm[i] = m;
    ciz[i] = 1.f / z;
    cc1[i] = qm / rr;
    cc2[i] = live * delta / rr;
    cdpp[i] = delta * (1.f - live * (rs / rr));
  }
  __syncwarp();   // every lane has read its rows' m, z, b
  if (lx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + wrow + ly + 4 * i;
      if (row >= Tq) continue;
      float* st = stats + (((size_t)b * H + h) * Tq + row) * kStats;
      st[kStM] = cm[i];
      st[kStInvZ] = ciz[i];
      st[kStC1] = cc1[i];
      st[kStC2] = cc2[i];
      st[kStDpp] = cdpp[i];
      st[5] = st[6] = st[7] = 0.f;
    }
  }
  float dqa[4][DH / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < DH / 8; ++e) dqa[i][e] = 0.f;

  for (int step = 0; step < n_steps; ++step) {
    if (step > 0) {
      cp_async_wait<0>();
      __syncthreads();   // this step's tiles have landed; the other stage is free
    }
    if (step + 1 < n_steps) load_step(step + 1);
    cp_async_commit();
    if (!active) continue;
    float* base = stages + (step & 1) * kStageF;
    const float* Ks = base;
    const float* Vs = base + kF32Step * DH;
    float* Gs = base + 2 * kF32Step * DH;
    const float* kms = Gs + kBQ * kF32Step;
    const int j0 = step * kF32Step;
    float s[4][4], da[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = da[i][c] = 0.f;
    f32::tile_abt<DH, 4>(s, Qs, wrow, Ks, dh, ly, lx);     // S = Q K^T
    f32::tile_abt<DH, 4>(da, dOs, wrow, Vs, dh, ly, lx);   // dA = dO V^T
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = lx + 8 * c;
      const bool in = j0 + j < Tk;
      const bool keep = in && kms[j] != 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = keep ? s[i][c] * scale : in ? kNegMask : -INFINITY;
        const float p = expf(x - cm[i]) * ciz[i];
        const float gq = p * Gs[f32::gswz<kF32Step>(wrow + ly + 4 * i, j)];
        const float corr = renorm == 0 ? cc2[i] * sign_of(gq) : cc2[i];
        const float pdp = (da[i][c] * cc1[i] - corr) * gq;   // P dP
        s[i][c] = keep ? (pdp - p * cdpp[i]) * scale : 0.f;  // dS
      }
    }
    __syncwarp();   // every lane has read its graph entries: the warp's rows take dS
    float* pt = Gs + wrow * kF32Step;
    f32::store_t<4>(pt, s, ly, lx);
    __syncwarp();
    f32::tile_pv<DH, kF32Step>(dqa, pt, Ks, ly, lx);   // dQ += dS K
  }
  cp_async_wait<0>();
  if (!active) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + wrow + ly + 4 * i;
    if (row >= Tq) continue;
#pragma unroll
    for (int g = 0; g < DH / 32; ++g) {
      const int d = 4 * lx + 32 * g;
      if (d >= dh) continue;
      const float* a4 = dqa[i] + 4 * g;
      *reinterpret_cast<float4*>(dq + ((size_t)b * Tq + row) * C + c0 + d) =
          make_float4(a4[0], a4[1], a4[2], a4[3]);
    }
  }
}

// 4. dK and dV of (head blockIdx.x, 64 keys blockIdx.y, batch blockIdx.z),
// 16 keys a warp; query rows 32 a step through a two-stage ring of (Q, dO,
// graph tile, the rows' constants); K and V staged once.
// Shared memory: Ks, Vs (64, DH) | bt (4 warps, 32, 16) | two stages of Qc,
// dOc (32, DH), Gs (32, 64), sts (32, kStats).
template <int DH>
__global__ void __launch_bounds__(128, DH <= 64 ? 2 : 1)
graph_attention_ln_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                      const float* __restrict__ v,
                                      const float* __restrict__ key_mask,
                                      const float* __restrict__ graph,
                                      const float* __restrict__ d_o,
                                      const float* __restrict__ stats, float* __restrict__ dk,
                                      float* __restrict__ dv, int Tq, int Tk, int C, int H,
                                      int dh, int renorm, float scale) {
  constexpr int kThr = 128;
  constexpr int kStageF = dkv_stage_floats(DH);
  extern __shared__ __align__(16) float smem_kv[];
  float* Ks = smem_kv;
  float* Vs = Ks + kF32Keys * DH;
  float* bt = Vs + kF32Keys * DH;
  float* stages = bt + 4 * kF32Step * 16;

  const int h = blockIdx.x;
  const int j0 = blockIdx.y * kF32Keys;
  const int b = blockIdx.z;
  const int c0 = h * dh;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ly = lane >> 3, lx = lane & 7;
  const int n_steps = (Tq + kF32Step - 1) / kF32Step;
  const bool gvec = (Tk & 3) == 0;
  const float* qb = q + (size_t)b * Tq * C;
  const float* dob = d_o + (size_t)b * Tq * C;
  const float* gb = graph + (size_t)b * Tq * Tk;
  const float* stb = stats + ((size_t)b * H + h) * Tq * kStats;

  auto load_step = [&](int step) {
    float* base = stages + (step & 1) * kStageF;
    const int r0 = step * kF32Step;
    f32::stage_tile<DH, kThr>(base, qb, r0, Tq, kF32Step, C, c0, dh, true, f32::Swz<DH>());
    f32::stage_tile<DH, kThr>(base + kF32Step * DH, dob, r0, Tq, kF32Step, C, c0, dh, true,
                              f32::Swz<DH>());
    f32::stage_tile<kF32Keys, kThr>(base + 2 * kF32Step * DH, gb, r0, Tq, kF32Step, Tk, j0,
                                    Tk - j0, gvec, f32::Swz<kF32Keys>());
    float* sts = base + 2 * kF32Step * DH + kF32Step * kF32Keys;
    for (int i = tid; i < kF32Step * 2; i += kThr) {   // kStats floats a row: two 16-byte copies
      const int r = r0 + (i >> 1);
      const bool valid = r < Tq;
      cp_async16(sts + i * 4, stb + (size_t)(valid ? r : 0) * kStats + (i & 1) * 4, valid);
    }
  };
  f32::stage_tile<DH, kThr>(Ks, k + (size_t)b * Tk * C, j0, Tk, kF32Keys, C, c0, dh, true,
                            f32::Swz<DH>());
  f32::stage_tile<DH, kThr>(Vs, v + (size_t)b * Tk * C, j0, Tk, kF32Keys, C, c0, dh, true,
                            f32::Swz<DH>());
  load_step(0);
  cp_async_commit();

  int kw[4];
  bool keep[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    kw[i] = warp * 16 + ly + 4 * i;
    const int key = j0 + kw[i];
    keep[i] = key < Tk && key_mask[(size_t)b * Tk + key] != 0.f;
  }
  const bool active = j0 + warp * 16 < Tk;
  float* pt = bt + warp * kF32Step * 16;
  float dka[4][DH / 8], dva[4][DH / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < DH / 8; ++e) dka[i][e] = dva[i][e] = 0.f;

  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<0>();
    __syncthreads();   // this step's tiles (and K, V) have landed; the other stage is free
    if (step + 1 < n_steps) load_step(step + 1);
    cp_async_commit();
    if (!active) continue;
    const float* base = stages + (step & 1) * kStageF;
    const float* Qc = base;
    const float* dOc = base + kF32Step * DH;
    const float* Gs = base + 2 * kF32Step * DH;
    const float* sts = Gs + kF32Step * kF32Keys;
    float w[4][4], da[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) w[i][c] = da[i][c] = 0.f;
    f32::tile_abt<DH, 4>(w, Ks, warp * 16, Qc, dh, ly, lx);    // S^T = K Q^T
    f32::tile_abt<DH, 4>(da, Vs, warp * 16, dOc, dh, ly, lx);  // dA^T = V dO^T
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float* rc = sts + (lx + 8 * c) * kStats;   // zeros past Tq
      const float m = rc[kStM], iz = rc[kStInvZ], c1 = rc[kStC1], c2 = rc[kStC2];
      const float dpp = rc[kStDpp];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = keep[i] ? w[i][c] * scale : kNegMask;
        const float p = expf(x - m) * iz;
        const float gq = p * Gs[f32::swz<kF32Keys>(lx + 8 * c, kw[i])];
        const float corr = renorm == 0 ? c2 * sign_of(gq) : c2;
        const float pdp = (da[i][c] * c1 - corr) * gq;
        w[i][c] = gq * c1;                                         // A
        da[i][c] = keep[i] ? (pdp - p * dpp) * scale : 0.f;        // dS
      }
    }
    __syncwarp();   // the previous step's readers of pt are done
    f32::store_t<4>(pt, w, ly, lx);
    __syncwarp();
    f32::tile_pv<DH, kF32Step>(dva, pt, dOc, ly, lx);   // dV += A^T dO
    __syncwarp();
    f32::store_t<4>(pt, da, ly, lx);
    __syncwarp();
    f32::tile_pv<DH, kF32Step>(dka, pt, Qc, ly, lx);    // dK += dS^T Q
  }
  cp_async_wait<0>();
  if (!active) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = j0 + kw[i];
    if (key >= Tk) continue;
#pragma unroll
    for (int g = 0; g < DH / 32; ++g) {
      const int d = 4 * lx + 32 * g;
      if (d >= dh) continue;
      const size_t at = ((size_t)b * Tk + key) * C + c0 + d;
      const float* k4 = dka[i] + 4 * g;
      const float* v4 = dva[i] + 4 * g;
      *reinterpret_cast<float4*>(dk + at) = make_float4(k4[0], k4[1], k4[2], k4[3]);
      *reinterpret_cast<float4*>(dv + at) = make_float4(v4[0], v4[1], v4[2], v4[3]);
    }
  }
}

struct F32Bwd {
  const float *q, *k, *v, *key_mask, *query_mask, *graph, *residual, *gamma, *dy;
  float *dq, *dk, *dv, *dres, *partials, *o, *stats;
  int B, Tq, Tk, C, H, renorm, from_do, row_tile;
  float scale;
  cudaStream_t stream;
};

// The attributes of each f32 kernel are set once a process (the one-query
// calls are short enough for the host's attribute calls to show); the
// LayerNorm backward's for the widest C it takes.
template <int NK>
cudaError_t launch_ln_f32(const F32Bwd& p) {
  const size_t smem = sizeof(float) * 2 * (kLnThreads / 32) * p.C;
  static const cudaError_t attributes = f32::allow_smem(
      graph_attention_ln_bwd_ln_f32_kernel<NK>, sizeof(float) * 2 * (kLnThreads / 32) * kF32MaxC);
  if (attributes != cudaSuccess) return attributes;
  const dim3 grid((p.Tq + p.row_tile - 1) / p.row_tile, p.B);
  graph_attention_ln_bwd_ln_f32_kernel<NK><<<grid, kLnThreads, smem, p.stream>>>(
      p.o, p.residual, p.gamma, p.dy, p.dres, p.partials, p.Tq, p.C, p.row_tile);
  return cudaGetLastError();
}

template <int DH, int WARPS>
cudaError_t launch_rows_f32(const F32Bwd& p) {
  const int dh = p.C / p.H;
  const dim3 grid(p.H, (p.Tq + 16 * WARPS - 1) / (16 * WARPS), p.B);
  const size_t smem_f = sizeof(float) * f32::flash_smem_floats(DH, 16 * WARPS);
  const size_t smem_q = sizeof(float) * dq_smem_floats(DH, WARPS);
  const size_t smem_kv = sizeof(float) * dkv_smem_floats(DH);
  auto fwd = graph_attention_ln_bwd_fwd_f32_kernel<DH, WARPS>;
  auto dqk = graph_attention_ln_bwd_dq_f32_kernel<DH, WARPS>;
  auto dkv = graph_attention_ln_bwd_dkv_f32_kernel<DH>;
  static const cudaError_t attributes = [&] {
    cudaError_t e = f32::allow_smem(fwd, smem_f);
    if (e == cudaSuccess) e = f32::allow_smem(dqk, smem_q);
    return e == cudaSuccess ? f32::allow_smem(dkv, smem_kv) : e;
  }();
  if (attributes != cudaSuccess) return attributes;
  cudaError_t err;
  fwd<<<grid, WARPS * 32, smem_f, p.stream>>>(p.q, p.k, p.v, p.key_mask, p.query_mask, p.graph,
                                              p.o, p.stats, p.Tq, p.Tk, p.C, p.H, dh, p.renorm,
                                              p.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float* d_o = p.dy;   // from d(o): dy is dO itself
  if (!p.from_do) {
    const int nk = (p.C + 31) / 32;
    err = p.C > kF32MaxC ? launch_ln_wide<float>(p.o, p.residual, p.gamma, p.dy, p.dres,
                                                 p.partials, p.B, p.Tq, p.C, p.row_tile,
                                                 p.stream)
        : nk <= 4 ? launch_ln_f32<4>(p) : nk <= 8 ? launch_ln_f32<8>(p)
        : nk <= 16 ? launch_ln_f32<16>(p) : nk <= 32 ? launch_ln_f32<32>(p) : launch_ln_f32<64>(p);
    if (err != cudaSuccess) return err;
    d_o = p.dres;
  }
  dqk<<<grid, WARPS * 32, smem_q, p.stream>>>(p.q, p.k, p.v, p.key_mask, p.query_mask, p.graph,
                                              p.o, d_o, p.dq, p.stats, p.Tq, p.Tk, p.C, p.H, dh,
                                              p.renorm, p.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_kv(p.H, (p.Tk + kF32Keys - 1) / kF32Keys, p.B);
  dkv<<<grid_kv, 128, smem_kv, p.stream>>>(p.q, p.k, p.v, p.key_mask, p.graph, d_o, p.stats,
                                           p.dk, p.dv, p.Tq, p.Tk, p.C, p.H, dh, p.renorm,
                                           p.scale);
  return cudaGetLastError();
}

// Whether `path` cannot take a call of this dtype and head width (see
// savqa_graph_attention_ln_bwd).
bool bad_path(int dtype, int dh, int path, int row_tile) {
  if (dtype != 0 && dtype != 1) return true;
  if (path == 1) return dtype != 1 || dh % 16 != 0 || dh > 128;
  if (path == 2) return dtype != 0 || dh % 4 != 0 || dh > 128 || row_tile < 1;
  return path != 0 || dh > kMaxDh || row_tile < 1 || row_tile > kQTile;
}

// The four f32 kernels, forward and dq at 16 query rows a block when Tq <= 16.
cudaError_t launch_f32(const F32Bwd& p) {
  const int dh = p.C / p.H;
  if (p.Tq <= 16) {
    if (dh <= 32) return launch_rows_f32<32, 1>(p);
    if (dh <= 64) return launch_rows_f32<64, 1>(p);
    return launch_rows_f32<128, 1>(p);
  }
  if (dh <= 32) return launch_rows_f32<32, 4>(p);
  if (dh <= 64) return launch_rows_f32<64, 4>(p);
  return launch_rows_f32<128, 4>(p);
}
}  // namespace

// dtype: 0 = float32, 1 = bfloat16. renorm: 0 = l1, 1 = sum_eps. path
// (ops/fused_graph_attention.py:k2_path): 1 = the tensor-core kernels (bf16
// with a head width that is a multiple of 16, at most 128), 32 query rows a
// block in the rows launch; 2 = the f32 kernels (f32 with a head width that
// is a multiple of 4, at most 128), whose LayerNorm backward writes one
// dgamma / dbeta partial per row_tile rows; 0 = the first SIMT kernels
// (either dtype, head widths up to 256), row_tile rows a block (1 to 16).
// Any C (the f32 path's LayerNorm backward above C 2,048 is the wide one,
// row_tile at most 64). partials: (B * ceil(Tq / rows a block), 2, C) f32, per-block
// dgamma / dbeta. stats: (B, H, Tq, 8) f32 and dout: (B, Tq, C) f32 are
// scratch passed between the launches (the tensor-core keys launch reads
// dO from dres and takes no dout; in f32 dout holds the forward's output O).
// Returns cudaGetLastError() after the launches.
extern "C" int savqa_graph_attention_ln_bwd(
    const void* q, const void* k, const void* v, const void* key_mask, const void* query_mask,
    const void* graph, const void* residual, const void* gamma, const void* dy, void* dq,
    void* dk, void* dv, void* dres, void* partials, void* dout, void* stats, int B, int Tq,
    int Tk, int C, int H, int renorm, int dtype, int path, int row_tile, float scale,
    void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || C % H != 0 || (renorm != 0 && renorm != 1) ||
      bad_path(dtype, C / H, path, row_tile) ||
      (path == 2 && C > kF32MaxC && row_tile > kLnWideRows))
    return (int)cudaErrorInvalidValue;
  const auto* km = static_cast<const float*>(key_mask);
  const auto* qm = static_cast<const float*>(query_mask);
  const auto* g = static_cast<const float*>(graph);
  const auto* ga = static_cast<const float*>(gamma);
  auto* pa = static_cast<float*>(partials);
  auto* dout_f = static_cast<float*>(dout);
  auto* st = static_cast<float*>(stats);
  auto s = static_cast<cudaStream_t>(stream);
  const int dh = C / H;
  if (path == 1) {
    auto run = dh <= 16 ? launch_tc<16> : dh <= 32 ? launch_tc<32> : dh <= 64 ? launch_tc<64>
                                                                               : launch_tc<128>;
    return (int)run(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                    static_cast<const bf16*>(v), km, qm, g, static_cast<const bf16*>(residual),
                    ga, static_cast<const bf16*>(dy), static_cast<bf16*>(dq),
                    static_cast<bf16*>(dk), static_cast<bf16*>(dv), static_cast<bf16*>(dres), pa,
                    st, B, Tq, Tk, C, H, renorm, scale, 0, s);
  }
  if (dout == nullptr) return (int)cudaErrorInvalidValue;
  if (path == 2) {
    const F32Bwd p{static_cast<const float*>(q), static_cast<const float*>(k),
                   static_cast<const float*>(v), km, qm, g, static_cast<const float*>(residual),
                   ga, static_cast<const float*>(dy), static_cast<float*>(dq),
                   static_cast<float*>(dk), static_cast<float*>(dv), static_cast<float*>(dres),
                   pa, dout_f, st, B, Tq, Tk, C, H, renorm, 0, row_tile, scale, s};
    return (int)launch_f32(p);
  }
  if (dtype == 0)
    return (int)launch<float>(q, k, v, km, qm, g, residual, ga, dy, dq, dk, dv, dres, pa,
                              dout_f, st, B, Tq, Tk, C, H, renorm, scale, 0, row_tile, s);
  return (int)launch<__nv_bfloat16>(q, k, v, km, qm, g, residual, ga, dy, dq, dk, dv, dres, pa,
                                    dout_f, st, B, Tq, Tk, C, H, renorm, scale, 0, row_tile, s);
}

// The model axis (ops/fused_graph_attention.py:graph_attention_heads'
// backward): dq, dk and dv of the H heads given from do, the gradient of
// savqa_graph_attention's output o, in q's type: the kernels above without
// the LayerNorm backward (the first SIMT rows launch also skips the
// forward's output). dout ((B, Tq, C) f32) and stats ((B, H, Tq, 8) f32) are
// scratch; the tensor-core keys launch reads do itself (dout unused, may be
// null). path and row_tile as savqa_graph_attention_ln_bwd's (row_tile: the
// SIMT rows launch's rows a block; unused otherwise).
extern "C" int savqa_graph_attention_bwd(
    const void* q, const void* k, const void* v, const void* key_mask, const void* query_mask,
    const void* graph, const void* d_o, void* dq, void* dk, void* dv, void* dout, void* stats,
    int B, int Tq, int Tk, int C, int H, int renorm, int dtype, int path, int row_tile,
    float scale, void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || C % H != 0 || (renorm != 0 && renorm != 1) ||
      bad_path(dtype, C / H, path, row_tile) || (path != 1 && dout == nullptr))
    return (int)cudaErrorInvalidValue;
  const auto* km = static_cast<const float*>(key_mask);
  const auto* qm = static_cast<const float*>(query_mask);
  const auto* g = static_cast<const float*>(graph);
  auto* dout_f = static_cast<float*>(dout);
  auto* st = static_cast<float*>(stats);
  auto s = static_cast<cudaStream_t>(stream);
  const int dh = C / H;
  if (path == 1) {
    auto run = dh <= 16 ? launch_tc<16> : dh <= 32 ? launch_tc<32> : dh <= 64 ? launch_tc<64>
                                                                               : launch_tc<128>;
    return (int)run(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                    static_cast<const bf16*>(v), km, qm, g, nullptr, nullptr,
                    static_cast<const bf16*>(d_o), static_cast<bf16*>(dq),
                    static_cast<bf16*>(dk), static_cast<bf16*>(dv), nullptr, nullptr, st, B, Tq,
                    Tk, C, H, renorm, scale, 1, s);
  }
  if (path == 2) {
    const F32Bwd p{static_cast<const float*>(q), static_cast<const float*>(k),
                   static_cast<const float*>(v), km, qm, g, nullptr, nullptr,
                   static_cast<const float*>(d_o), static_cast<float*>(dq),
                   static_cast<float*>(dk), static_cast<float*>(dv), nullptr, nullptr, dout_f,
                   st, B, Tq, Tk, C, H, renorm, 1, 1, scale, s};
    return (int)launch_f32(p);
  }
  if (dtype == 0)
    return (int)launch<float>(q, k, v, km, qm, g, nullptr, nullptr, d_o, dq, dk, dv, nullptr,
                              nullptr, dout_f, st, B, Tq, Tk, C, H, renorm, scale, 1, row_tile,
                              s);
  return (int)launch<__nv_bfloat16>(q, k, v, km, qm, g, nullptr, nullptr, d_o, dq, dk, dv,
                                    nullptr, nullptr, dout_f, st, B, Tq, Tk, C, H, renorm,
                                    scale, 1, row_tile, s);
}

// K2's wide path (ops/fused_graph_attention.py "wide"), its LayerNorm
// backward at any C: from o, K1's attention output (B, Tq, C) f32, the
// residual, gamma and dy, dres = dO (B, Tq, C) and the dgamma / dbeta
// partials (B * ceil(Tq / row_tile), 2, C) f32 of row_tile rows each (1 to
// 64). residual, dy and dres of dtype (0 float32, 1 bfloat16). The
// attention backward of that path is K5's and K6's kernels
// (csrc/flash_graph_attention_bwd.cu).
extern "C" int savqa_attention_ln_bwd(const void* o, const void* residual, const void* gamma,
                                      const void* dy, void* dres, void* partials, int B, int Tq,
                                      int C, int dtype, int row_tile, void* stream) {
  if (B <= 0 || Tq <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const auto* of = static_cast<const float*>(o);
  const auto* ga = static_cast<const float*>(gamma);
  auto* pa = static_cast<float*>(partials);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_ln_wide<float>(of, static_cast<const float*>(residual), ga,
                                      static_cast<const float*>(dy), static_cast<float*>(dres),
                                      pa, B, Tq, C, row_tile, s);
  if (dtype == 1)
    return (int)launch_ln_wide<__nv_bfloat16>(of, static_cast<const bf16*>(residual), ga,
                                              static_cast<const bf16*>(dy),
                                              static_cast<bf16*>(dres), pa, B, Tq, C, row_tile,
                                              s);
  return (int)cudaErrorInvalidValue;
}
