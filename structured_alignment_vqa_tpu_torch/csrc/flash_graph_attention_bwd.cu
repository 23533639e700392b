// K5 and K6: backward of the flash graph-guided attention (K4,
// csrc/flash_graph_attention.cu).
//
// Replace the TPU kernels of structured_alignment_vqa_tpu/ops/pallas_flash_attention.py:
// K5 = _bwd_dq_kernel (line 367), K6 = _bwd_dkv_kernel (line 398), both with
// the tile math of _ds_tile (lines 339-364), launched by _flash_backward.
//
// Given the forward's inputs, its saved per-row statistics m, z, b (B, H, Tq),
// dO = d out * query_mask rounded to q's type, and delta_i = dO_i . out_i per
// (batch, head, row) (both made by the wrapper, in f32 before the rounding),
// per batch element, head h (dh = C / H), query row i and key j:
//   s  = <q_i, k_j> * scale, or -2^32+1 where key_mask[b, j] == 0
//   e  = exp(s - m_i),  p = e / z_i,  dN = <dO_i, v_j>
//   l1:      D = max(b_i, 1e-12 z_i), live = [b_i >= 1e-12 z_i]  (not strict:
//            max() takes its first operand on a tie), n = e g_ij / D,
//            dS = n (dN - live delta_i) - p (1 - live) delta_i
//   sum_eps: D = b_i + 1e-7 z_i, n = e g_ij / D,
//            dS = n (dN - delta_i) - p delta_i 1e-7 z_i / D
//   dS = 0 on masked keys, then * scale
//   K5: dQ_i = sum_j dS_ij k_j
//   K6: dV_j = sum_i n_ij dO_i,  dK_j = sum_i dS_ij q_i
// n are the final renormalised weights, so this is the usual flash backward
// with n in the place of the softmax probabilities, plus a correction that
// is zero on every row with a live graph neighbour. Rows whose graph is all
// zero (the encoder's stage-1 graph on its modality rows) have b = 0 < eps z:
// they are dead rows, n = 0 and dS = -p delta.
//
// What bounds them on an H100: operations. At the obj+rel shapes (B 4,
// L 1,536, C 512, 8 heads, bf16) K5 does three products of 2 B Tq Tk C
// (QK^T, dO V^T, dS K) = 29 GFLOP and K6 four (QK^T, dO V^T, N^T dO, dS^T Q)
// = 39 GFLOP, against ~50 MB read and written by each: 29 and 39 us at the
// bf16 tensor-core peak, 433 and 577 us at the f32 rate these FMAs run at.
//
// Design, as K4's: blocks of 256 threads in a 16 x 16 grid, 64 x 64 score
// tiles computed from float4 reads of f32 tiles staged in shared memory,
// every product a plain FMA on CUDA cores in f32 (dO, V, K and Q are widened
// first, as the TPU kernels widen them). No atomics anywhere, so every run
// gives the same bits.
// * K5: one block per (batch, head, tile of 64 query rows), walking the keys
//   64 at a time. Thread (ty, tx) owns rows 4 ty .. 4 ty + 3; it computes S
//   and dN for keys tx + 16 c together, turns them into dS with its rows'
//   constants (held in registers), writes dS to a shared tile and, after a
//   barrier, adds dS K into its 4 x dh/16 accumulators of dQ.
// * K6: the transposed walk, one block per (batch, head, tile of 64 keys),
//   walking the query rows 64 at a time: dK and dV sum over every query
//   row, and the sum stays in one block's registers. K and V are staged
//   once. Per step the block stages Q, dO, the rows' constants and the graph
//   tile (read coalesced along the keys, then replaced in place by n).
//   Thread (ty, tx) owns keys 4 ty .. 4 ty + 3; it computes S and dN for
//   rows tx + 16 i, writes n and dS to two shared tiles and, after a
//   barrier, adds N^T dO and dS^T Q into its 4 x dh/16 accumulators of dV
//   and dK.
// Tq != Tk and ragged tiles run through the same code: rows and keys past
// the end are staged as zeros and their n and dS are set to 0. Up to head
// width 64 the registers are capped at 128 a thread (__launch_bounds__): at
// 138, K6 had one block an SM and took 3.65 ms where it now takes 2.40 (bf16,
// B 4, L 1,536, H100 80GB HBM3 at 700 W).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 64;        // keys per tile
constexpr int kLdP = kBK + 4;  // row stride of the (rows, keys) tiles
constexpr int kMaxDh = 128;
constexpr float kNegMask = -4294967295.0f;  // float(-(2**32) + 1)
constexpr float kL1Eps = 1e-12f;
constexpr float kSumEps = 1e-7f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

// Rows [row0, row0 + n) of head c0 of x (.., C) into dst (tile, ld) as f32;
// rows from n to tile are zero.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ x, int row0, int n,
                                      int tile, int C, int c0, int dh, int ld) {
  for (int i = threadIdx.x; i < tile * dh; i += kThreads) {
    const int r = i / dh, d = i - r * dh;
    dst[r * ld + d] = r < n ? to_float(x[(size_t)(row0 + r) * C + c0 + d]) : 0.f;
  }
}

// What dS needs of one query row: dS = n (dN - c1) - p c2 with n = e g / D.
struct RowTerms {
  float m, z, D, c1, c2;
};

__device__ __forceinline__ RowTerms row_terms(float m, float z, float b, float delta,
                                              int renorm) {
  RowTerms t;
  t.m = m;
  t.z = z;
  if (renorm == 0) {
    const float floor_ = kL1Eps * z;
    const bool live = b >= floor_;
    t.D = fmaxf(b, floor_);
    t.c1 = live ? delta : 0.f;
    t.c2 = live ? 0.f : delta;
  } else {
    t.D = b + kSumEps * z;
    t.c1 = delta;
    t.c2 = delta * kSumEps * z / t.D;
  }
  return t;
}

// One entry of the tile: the raw score and dN in, n and the scaled dS out.
__device__ __forceinline__ void ds_entry(float raw, float dn, float g, bool masked,
                                         const RowTerms& t, float scale, float* n_out,
                                         float* ds_out) {
  const float s = masked ? kNegMask : raw * scale;
  const float e = expf(s - t.m);
  const float p = e / t.z;
  const float n = e * g / t.D;
  const float ds = n * (dn - t.c1) - p * t.c2;
  *n_out = n;
  *ds_out = masked ? 0.f : ds * scale;
}

// K5. Shared memory: Qs, Ds (kBQ, ld) | Ks, Vs (kBK, ld) | Ss (kBQ, kLdP) | kms (kBK)
template <typename T, int NDH>
__global__ void __launch_bounds__(kThreads, NDH <= 4 ? 2 : 1)
flash_graph_attention_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ key_mask, const float* __restrict__ graph,
    const float* __restrict__ m_in, const float* __restrict__ z_in,
    const float* __restrict__ b_in, const float* __restrict__ delta,
    const T* __restrict__ dout, T* __restrict__ dq, int Tq, int Tk, int C, int H, int renorm,
    float scale) {
  extern __shared__ __align__(16) float smem[];
  const int dh = C / H;
  const int ld = dh + 4;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int rows = min(kBQ, Tq - q0);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int c0 = h * dh;
  const bool active = ty * 4 < rows;

  float* Qs = smem;
  float* Ds = Qs + kBQ * ld;
  float* Ks = Ds + kBQ * ld;
  float* Vs = Ks + kBK * ld;
  float* Ss = Vs + kBK * ld;
  float* kms = Ss + kBQ * kLdP;

  stage(Qs, q + (size_t)b * Tq * C, q0, rows, kBQ, C, c0, dh, ld);
  stage(Ds, dout + (size_t)b * Tq * C, q0, rows, kBQ, C, c0, dh, ld);

  RowTerms rt[4];
  float acc[4][NDH];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = ty * 4 + r;
    if (row < rows) {
      const size_t at = ((size_t)b * H + h) * Tq + q0 + row;
      rt[r] = row_terms(m_in[at], z_in[at], b_in[at], delta[at], renorm);
    } else {
      rt[r] = row_terms(0.f, 1.f, 1.f, 0.f, renorm);
    }
#pragma unroll
    for (int i = 0; i < NDH; ++i) acc[r][i] = 0.f;
  }

  const T* kb = k + (size_t)b * Tk * C;
  const T* vb = v + (size_t)b * Tk * C;
  const float* km = key_mask + (size_t)b * Tk;
  const float* gb = graph + ((size_t)b * Tq + q0) * Tk;

  for (int j0 = 0; j0 < Tk; j0 += kBK) {
    const int nk = min(kBK, Tk - j0);
    __syncthreads();  // Qs, Ds written; the previous step's readers of Ks, Vs, Ss, kms done
    stage(Ks, kb, j0, nk, kBK, C, c0, dh, ld);
    stage(Vs, vb, j0, nk, kBK, C, c0, dh, ld);
    for (int j = tid; j < kBK; j += kThreads) kms[j] = j < nk ? km[j0 + j] : 0.f;
    __syncthreads();

    if (active) {
      float s[4][4], dn[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = dn[r][c] = 0.f;
      for (int d = 0; d < dh; d += 4) {
        float4 qv[4], dv4[4], kv[4], vv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          qv[r] = *reinterpret_cast<const float4*>(Qs + (ty * 4 + r) * ld + d);
          dv4[r] = *reinterpret_cast<const float4*>(Ds + (ty * 4 + r) * ld + d);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          kv[c] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * c) * ld + d);
          vv[c] = *reinterpret_cast<const float4*>(Vs + (tx + 16 * c) * ld + d);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            s[r][c] = dot4(qv[r], kv[c], s[r][c]);
            dn[r][c] = dot4(dv4[r], vv[c], dn[r][c]);
          }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = ty * 4 + r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = tx + 16 * c;
          float n = 0.f, ds = 0.f;
          if (row < rows && j < nk)
            ds_entry(s[r][c], dn[r][c], gb[(size_t)row * Tk + j0 + j], kms[j] == 0.f, rt[r],
                     scale, &n, &ds);
          Ss[row * kLdP + j] = ds;
        }
      }
    }
    __syncthreads();  // Ss complete

    if (active) {
      for (int j = 0; j < kBK; j += 4) {
        float4 sv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          sv[r] = *reinterpret_cast<const float4*>(Ss + (ty * 4 + r) * kLdP + j);
#pragma unroll
        for (int i = 0; i < NDH; ++i) {
          const int d = tx + 16 * i;
          if (d < dh) {
            const float k0 = Ks[(j + 0) * ld + d], k1 = Ks[(j + 1) * ld + d];
            const float k2 = Ks[(j + 2) * ld + d], k3 = Ks[(j + 3) * ld + d];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              float a = acc[r][i];
              a = fmaf(sv[r].x, k0, a);
              a = fmaf(sv[r].y, k1, a);
              a = fmaf(sv[r].z, k2, a);
              acc[r][i] = fmaf(sv[r].w, k3, a);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = ty * 4 + r;
    if (row >= rows) continue;
#pragma unroll
    for (int i = 0; i < NDH; ++i) {
      const int d = tx + 16 * i;
      if (d < dh) dq[((size_t)b * Tq + q0 + row) * C + c0 + d] = from_float<T>(acc[r][i]);
    }
  }
}

// K6. Shared memory: Ks, Vs (kBK, ld) | Qs, Ds (kBQ, ld) | Ns, Ss (kBQ, kLdP)
//                    | terms (kBQ RowTerms) | kms (kBK)
template <typename T, int NDH>
__global__ void __launch_bounds__(kThreads, NDH <= 4 ? 2 : 1)
flash_graph_attention_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ key_mask, const float* __restrict__ graph,
    const float* __restrict__ m_in, const float* __restrict__ z_in,
    const float* __restrict__ b_in, const float* __restrict__ delta,
    const T* __restrict__ dout, T* __restrict__ dk, T* __restrict__ dv, int Tq, int Tk, int C,
    int H, int renorm, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int dh = C / H;
  const int ld = dh + 4;
  const int j0 = blockIdx.x * kBK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int nk = min(kBK, Tk - j0);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int c0 = h * dh;
  const bool active = ty * 4 < nk;     // this thread's key group holds a real key

  float* Ks = smem;
  float* Vs = Ks + kBK * ld;
  float* Qs = Vs + kBK * ld;
  float* Ds = Qs + kBQ * ld;
  float* Ns = Ds + kBQ * ld;
  float* Ss = Ns + kBQ * kLdP;
  RowTerms* terms = reinterpret_cast<RowTerms*>(Ss + kBQ * kLdP);
  float* kms = reinterpret_cast<float*>(terms + kBQ);

  stage(Ks, k + (size_t)b * Tk * C, j0, nk, kBK, C, c0, dh, ld);
  stage(Vs, v + (size_t)b * Tk * C, j0, nk, kBK, C, c0, dh, ld);
  for (int j = tid; j < kBK; j += kThreads)
    kms[j] = j < nk ? key_mask[(size_t)b * Tk + j0 + j] : 0.f;

  float acc_k[4][NDH], acc_v[4][NDH];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int i = 0; i < NDH; ++i) acc_k[c][i] = acc_v[c][i] = 0.f;

  const T* qb = q + (size_t)b * Tq * C;
  const T* db = dout + (size_t)b * Tq * C;

  for (int r0 = 0; r0 < Tq; r0 += kBQ) {
    const int nr = min(kBQ, Tq - r0);
    __syncthreads();  // Ks, Vs, kms written; the previous step's readers done
    stage(Qs, qb, r0, nr, kBQ, C, c0, dh, ld);
    stage(Ds, db, r0, nr, kBQ, C, c0, dh, ld);
    for (int r = tid; r < kBQ; r += kThreads) {
      if (r < nr) {
        const size_t at = ((size_t)b * H + h) * Tq + r0 + r;
        terms[r] = row_terms(m_in[at], z_in[at], b_in[at], delta[at], renorm);
      } else {
        terms[r] = row_terms(0.f, 1.f, 1.f, 0.f, renorm);
      }
    }
    // the graph tile, read along the keys; replaced by n below
    for (int i = tid; i < kBQ * kBK; i += kThreads) {
      const int r = i / kBK, j = i - r * kBK;
      Ns[r * kLdP + j] =
          (r < nr && j < nk) ? graph[((size_t)b * Tq + r0 + r) * Tk + j0 + j] : 0.f;
    }
    __syncthreads();

    if (active) {
      float s[4][4], dn[4][4];   // [row i][key c]
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = dn[i][c] = 0.f;
      for (int d = 0; d < dh; d += 4) {
        float4 qv[4], dv4[4], kv[4], vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qv[i] = *reinterpret_cast<const float4*>(Qs + (tx + 16 * i) * ld + d);
          dv4[i] = *reinterpret_cast<const float4*>(Ds + (tx + 16 * i) * ld + d);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          kv[c] = *reinterpret_cast<const float4*>(Ks + (ty * 4 + c) * ld + d);
          vv[c] = *reinterpret_cast<const float4*>(Vs + (ty * 4 + c) * ld + d);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            s[i][c] = dot4(qv[i], kv[c], s[i][c]);
            dn[i][c] = dot4(dv4[i], vv[c], dn[i][c]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = tx + 16 * i;
        const RowTerms t = terms[row];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = ty * 4 + c;
          float n = 0.f, ds = 0.f;
          if (row < nr && j < nk)
            ds_entry(s[i][c], dn[i][c], Ns[row * kLdP + j], kms[j] == 0.f, t, scale, &n, &ds);
          Ns[row * kLdP + j] = n;
          Ss[row * kLdP + j] = ds;
        }
      }
    }
    __syncthreads();  // Ns, Ss complete

    if (active) {
      for (int r = 0; r < kBQ; ++r) {
        const float4 nv = *reinterpret_cast<const float4*>(Ns + r * kLdP + ty * 4);
        const float4 sv = *reinterpret_cast<const float4*>(Ss + r * kLdP + ty * 4);
#pragma unroll
        for (int i = 0; i < NDH; ++i) {
          const int d = tx + 16 * i;
          if (d < dh) {
            const float dor = Ds[r * ld + d];
            const float qr = Qs[r * ld + d];
            acc_v[0][i] = fmaf(nv.x, dor, acc_v[0][i]);
            acc_v[1][i] = fmaf(nv.y, dor, acc_v[1][i]);
            acc_v[2][i] = fmaf(nv.z, dor, acc_v[2][i]);
            acc_v[3][i] = fmaf(nv.w, dor, acc_v[3][i]);
            acc_k[0][i] = fmaf(sv.x, qr, acc_k[0][i]);
            acc_k[1][i] = fmaf(sv.y, qr, acc_k[1][i]);
            acc_k[2][i] = fmaf(sv.z, qr, acc_k[2][i]);
            acc_k[3][i] = fmaf(sv.w, qr, acc_k[3][i]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int j = ty * 4 + c;
    if (j >= nk) continue;
#pragma unroll
    for (int i = 0; i < NDH; ++i) {
      const int d = tx + 16 * i;
      if (d >= dh) continue;
      const size_t at = ((size_t)b * Tk + j0 + j) * C + c0 + d;
      dk[at] = from_float<T>(acc_k[c][i]);
      dv[at] = from_float<T>(acc_v[c][i]);
    }
  }
}

template <typename T, int NDH>
cudaError_t launch_dq_ndh(const void* q, const void* k, const void* v, const float* key_mask,
                          const float* graph, const float* m_in, const float* z_in,
                          const float* b_in, const float* delta, const void* dout, void* dq,
                          int B, int Tq, int Tk, int C, int H, int renorm, float scale,
                          cudaStream_t stream) {
  const int ld = C / H + 4;
  const size_t smem =
      sizeof(float) * ((size_t)(2 * kBQ + 2 * kBK) * ld + (size_t)kBQ * kLdP + kBK);
  cudaError_t err = cudaFuncSetAttribute(flash_graph_attention_bwd_dq_kernel<T, NDH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
  flash_graph_attention_bwd_dq_kernel<T, NDH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), key_mask,
      graph, m_in, z_in, b_in, delta, static_cast<const T*>(dout), static_cast<T*>(dq), Tq, Tk,
      C, H, renorm, scale);
  return cudaGetLastError();
}

template <typename T, int NDH>
cudaError_t launch_dkv_ndh(const void* q, const void* k, const void* v, const float* key_mask,
                           const float* graph, const float* m_in, const float* z_in,
                           const float* b_in, const float* delta, const void* dout, void* dk,
                           void* dv, int B, int Tq, int Tk, int C, int H, int renorm,
                           float scale, cudaStream_t stream) {
  const int ld = C / H + 4;
  const size_t smem = sizeof(float) * ((size_t)(2 * kBQ + 2 * kBK) * ld +
                                       2 * (size_t)kBQ * kLdP + kBK) +
                      sizeof(RowTerms) * kBQ;
  cudaError_t err = cudaFuncSetAttribute(flash_graph_attention_bwd_dkv_kernel<T, NDH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tk + kBK - 1) / kBK, H, B);
  flash_graph_attention_bwd_dkv_kernel<T, NDH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), key_mask,
      graph, m_in, z_in, b_in, delta, static_cast<const T*>(dout), static_cast<T*>(dk),
      static_cast<T*>(dv), Tq, Tk, C, H, renorm, scale);
  return cudaGetLastError();
}

template <typename T, typename... Args>
cudaError_t launch_dq(int dh, Args... args) {
  if (dh <= 16) return launch_dq_ndh<T, 1>(args...);
  if (dh <= 32) return launch_dq_ndh<T, 2>(args...);
  if (dh <= 64) return launch_dq_ndh<T, 4>(args...);
  return launch_dq_ndh<T, 8>(args...);
}

template <typename T, typename... Args>
cudaError_t launch_dkv(int dh, Args... args) {
  if (dh <= 16) return launch_dkv_ndh<T, 1>(args...);
  if (dh <= 32) return launch_dkv_ndh<T, 2>(args...);
  if (dh <= 64) return launch_dkv_ndh<T, 4>(args...);
  return launch_dkv_ndh<T, 8>(args...);
}

bool bad_shape(int B, int Tq, int Tk, int C, int H, int renorm) {
  return B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || C % H != 0 || (C / H) % 4 != 0 ||
         C / H > kMaxDh || (renorm != 0 && renorm != 1);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. renorm: 0 = l1, 1 = sum_eps.
// q, dout, dq (B, Tq, C) and k, v, dk, dv (B, Tk, C) in that type; key_mask
// (B, Tk), graph (B, Tq, Tk), m, z, b, delta (B, H, Tq) f32. The head width
// C / H must be a multiple of 4 and at most 128. Each returns
// cudaGetLastError() after its launch.
extern "C" int savqa_flash_graph_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* key_mask, const void* graph,
    const void* m_in, const void* z_in, const void* b_in, const void* delta, const void* dout,
    void* dq, int B, int Tq, int Tk, int C, int H, int renorm, int dtype, float scale,
    void* stream) {
  if (bad_shape(B, Tq, Tk, C, H, renorm)) return (int)cudaErrorInvalidValue;
  const auto* km = static_cast<const float*>(key_mask);
  const auto* g = static_cast<const float*>(graph);
  const auto* mi = static_cast<const float*>(m_in);
  const auto* zi = static_cast<const float*>(z_in);
  const auto* bi = static_cast<const float*>(b_in);
  const auto* de = static_cast<const float*>(delta);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_dq<float>(C / H, q, k, v, km, g, mi, zi, bi, de, dout, dq, B, Tq, Tk, C,
                                 H, renorm, scale, s);
  if (dtype == 1)
    return (int)launch_dq<__nv_bfloat16>(C / H, q, k, v, km, g, mi, zi, bi, de, dout, dq, B, Tq,
                                         Tk, C, H, renorm, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int savqa_flash_graph_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* key_mask, const void* graph,
    const void* m_in, const void* z_in, const void* b_in, const void* delta, const void* dout,
    void* dk, void* dv, int B, int Tq, int Tk, int C, int H, int renorm, int dtype, float scale,
    void* stream) {
  if (bad_shape(B, Tq, Tk, C, H, renorm)) return (int)cudaErrorInvalidValue;
  const auto* km = static_cast<const float*>(key_mask);
  const auto* g = static_cast<const float*>(graph);
  const auto* mi = static_cast<const float*>(m_in);
  const auto* zi = static_cast<const float*>(z_in);
  const auto* bi = static_cast<const float*>(b_in);
  const auto* de = static_cast<const float*>(delta);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_dkv<float>(C / H, q, k, v, km, g, mi, zi, bi, de, dout, dk, dv, B, Tq,
                                  Tk, C, H, renorm, scale, s);
  if (dtype == 1)
    return (int)launch_dkv<__nv_bfloat16>(C / H, q, k, v, km, g, mi, zi, bi, de, dout, dk, dv,
                                          B, Tq, Tk, C, H, renorm, scale, s);
  return (int)cudaErrorInvalidValue;
}
