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
// bf16 rounds two more values than the TPU kernels, which multiply in f32:
// n and dS are rounded to bf16 once, as the operands of the second products
// (dQ = dS K, dK = dS^T Q, dV = N^T dO), by the tensor-core kernels, the
// bf16 SIMT kernels and the plain versions alike. In f32 nothing is rounded.
//
// What bounds them on an H100: operations. At the obj+rel shapes (B 4,
// L 1,536, C 512, 8 heads, bf16) K5 does three products of 2 B Tq Tk C
// (QK^T, dO V^T, dS K) = 29 GFLOP and K6 four (QK^T, dO V^T, N^T dO, dS^T Q)
// = 39 GFLOP, against ~50 MB read and written by each: 29 and 39 us at the
// bf16 tensor-core peak, 433 and 577 us at the f32 rate of CUDA cores.
// Below that floor what every block pulls through L2 sets the pace, as in
// K4: its stream of (Q, dO) or (K, V) tiles and its f32 graph tiles.
//
// The bf16 path (head widths that are multiples of 16): FlashAttention-2's
// backward with n in the place of the softmax probabilities. Every product
// runs on the tensor cores (mma.sync m16n8k16, bf16 operands, f32
// accumulators, csrc/mma_sm90.cuh); tiles are staged as bf16 by cp.async
// (16 bytes a thread, rows padded by 16 bytes for ldmatrix) through a ring
// of two stages, whose copies for step j + 1 are issued right after the one
// barrier of step j and overlap its products. Scores are recomputed in units
// of log 2 as K4 takes them (ex2.approx): e = 2^(s scale log2(e) - m log2(e))
// on a real key and 2^((fill - m) log2(e)) on a masked one, which is exactly
// 2^0 = 1 on a row whose keys are all masked (m = fill), as in the plain
// version. n and dS are formed on the accumulator fragments, packed to bf16
// pairs and used as the A operand of the next product as they are: nothing
// of size (rows, keys) goes through shared memory. No atomics: every run
// gives the same bits. Heads are the fastest grid axis, so a graph tile one
// head's block pulls from device memory is an L2 hit for the other heads.
// * K6: one block of 4 warps per (batch, head, 64 keys), 16 keys a warp. K
//   and V are read once into registers as A fragments (staged in the second
//   stage's room, which they give up before its first copy). The block walks
//   the query rows 64 at a time; a step's stage holds Q and dO (bf16), the
//   f32 graph tile (64 rows x 64 keys, rows padded to 68 floats: a lane
//   reads a column, query rows 2t, 2t + 1 at key g, and the 32 lanes of a
//   warp hit 32 banks) and the rows' terms, formed once a row: thread r loads
//   row r's m, z, b, delta a step ahead and writes its terms into the stage
//   before the barrier that opens the step. A warp walks the step in four
//   sub-steps of 16 rows: S^T = K Q^T and dN^T = V dO^T land in fragments of
//   16 keys x 16 rows, then dV += n^T dO and dK += dS^T Q read dO and Q with
//   ldmatrix .trans. dK and dV (16 x dh each) stay in registers.
// * K5: one block of 4 warps per (batch, head, 64 query rows), 16 rows a
//   warp: K4's shape with a third product. Q and dO are read once into
//   registers as A fragments, each lane holds the terms of its two rows, and
//   the ring carries K, V, the f32 graph tile (rows padded to 72 floats:
//   float2 reads along the keys, as K4) and the key mask. A warp walks a
//   step in two sub-steps of 32 keys: S = Q K^T and dN = dO V^T on
//   fragments, dS formed on them, dQ += dS K with K read by ldmatrix .trans;
//   dQ (16 x dh a warp) stays in registers.
// * Three blocks an SM (12 warps) up to head width 64: 74-76 KB of shared
//   memory a block, and the sub-steps keep the registers within the 168 a
//   thread that three blocks leave (no spills). What hides the copies is the
//   other blocks' warps, as in K4 (bf16, B 4, L 1,536, H100 80GB HBM3 at
//   700 W; chip_smoke.py and scripts/k56_knockouts.py): K6 took 0.465 ms
//   with every lane forming the terms of its 16 rows itself, 0.37 with the
//   terms formed once a row, 0.35 / 0.32 in whole / half steps at two
//   blocks an SM, 0.24 in quarter steps at three; K5 0.175 in whole steps at
//   two blocks, 0.155 in half steps at three.
// * A key split for K5 when its query tiles do not fill the card (the
//   decoder's one query into 1,536 keys: 32 blocks), by the rule K4 uses
//   (ops/flash_graph_attention.py:key_split): block (h, q-tile x n_split +
//   shard, b) walks its shard of the key steps and writes its f32 partial
//   dQ to scratch; flash_graph_attention_bwd_dq_sum_kernel<bf16> adds the
//   shards in shard order and rounds to bf16. Partials of dQ simply add: no
//   rescaling, no atomics, the same bits every run.
// * A head width of 48, 80, ... runs in the next instantiation (16, 32, 64,
//   128, 256) with its upper channels staged as zeros.
// * Instance 256 (head widths 144-256): a warp's 16 x 256 f32 accumulators
//   take 128 registers a thread, so K6's dK and dV (256) and K5's dQ beside
//   Q's and dO's fragments do not fit one warp; pairs of warps share the
//   work (the pair kernels below: K6 splits dV from dK, K5 dQ's channels,
//   the scores passed through shared memory).
//
// K6 in f32 takes a register-tiled FFMA kernel built from csrc/simt_f32.cuh's
// tiles (TF32 products would not hold the 1e-4 the f32 path is checked to),
// in the walk of K2's f32 dkv kernel (csrc/graph_attention_bwd.cu): one
// block of 4 warps per (head, 64 keys, batch element), heads the fastest
// grid axis, 16 keys a warp; K and V staged once; the query rows 32 a step
// through a two-stage cp.async ring of (Q, dO, the graph tile, the rows' m,
// z, b, delta), the copies of step j + 1 overlapping step j's products. A
// lane owns a 4 x 4 tile of (key, row) entries: S^T = K Q^T and dN^T = V
// dO^T by tile_abt, n and dS by row_terms and ds_entry's formula as the
// SIMT kernels form them (each lane its rows' terms, from the staged m, z,
// b, delta; the divisions by z and D through their reciprocals, div_rn),
// then dV += N^T dO and dK += dS^T Q through the warp's transposed tile
// (store_t, tile_pv). Each score is one ascending-d FMA chain and each dK
// and dV entry one FMA chain over the query rows in ascending order, as in
// the first f32 kernel, so it gives that kernel's bits. Two blocks an SM up
// to head width 64 (91,136 bytes of shared memory a block at 64). At
// instance 256 (head widths 132-256) the pair kernel below: 32 keys a block,
// dV and dK on two warps each.
//
// K5 in f32 takes a register-tiled FFMA kernel in the walk of K2's f32 dq
// kernel: one block of 4 warps per (head, 64 query rows, batch element),
// one warp of 16 rows when Tq <= 16, heads the fastest grid axis; Q and dO
// staged once; the keys 32 a step through a two-stage cp.async ring of (K,
// V, the graph tile, the key mask). A lane owns a 4 x 4 tile of (row, key)
// entries: S = Q K^T and dN = dO V^T by tile_abt, dS by ds_entry_rcp from
// its rows' terms (formed once, in registers), then dQ += dS K through the
// warp's transposed tile, written over its rows of the graph tile (store_t,
// tile_pv). Each score is one ascending-d FMA chain and each dQ entry one
// FMA chain over the keys in ascending order, as in the first f32 kernel:
// an unsplit call gives its bits. Two blocks an SM up to head width 64
// (82,176 bytes of shared memory a block at 64). When the blocks do not
// fill the card (the decoder's one query into 1,536 keys: 32 one-warp
// blocks) the key steps are cut into shards of four
// (ops/flash_graph_attention.py:dq_f32_plan), each block writes its f32
// partial dQ to scratch and flash_graph_attention_bwd_dq_sum_kernel<float>
// adds them in shard order. At instance 256 (head widths 132-256) Q and dO
// take 128 KB, so the keys pass 16 a step (a 4 x 2 tile a lane), the
// shards 8 steps (128 keys, as below 256).
//
// K5 and K6 in bf16 with a head width that is no multiple of 16 take the
// first SIMT kernels below, and so does K5 in f32 where its caller names
// that path (a check holding the f32 kernel to it): blocks of 256 threads
// in a 16 x 16 grid, 64 x 64 score tiles computed from float4 reads of f32
// tiles staged in shared memory, every product a plain FMA on CUDA cores in
// f32 (dO, V, K and Q are widened first, as the TPU kernels widen them).
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
// 138, K6 had one block an SM and took 3.65 ms where it then took 2.40 (bf16,
// B 4, L 1,536, H100 80GB HBM3 at 700 W).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "mma_sm90.cuh"
#include "simt_f32.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 64;        // keys per tile
constexpr int kLdP = kBK + 4;  // row stride of the (rows, keys) tiles
constexpr int kMaxDh = 256;     // the SIMT kernels' widest head
constexpr int kTcMaxDh = 256;   // the tensor-core and f32 kernels' widest head (instance 256)
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

// The SIMT kernels' row stride: the head width rounded up to 4, plus 4.
__host__ __device__ constexpr int simt_ld(int dh) { return (dh + 3) / 4 * 4 + 4; }

// Rows [row0, row0 + n) of head c0 of x (.., C) into dst (tile, ld) as f32,
// the head width rounded up to 4; rows from n to tile and columns from dh
// to that width are zero (so the float4 products add exact zeros).
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ x, int row0, int n,
                                      int tile, int C, int c0, int dh, int ld) {
  const int dp = (dh + 3) / 4 * 4;
  for (int i = threadIdx.x; i < tile * dp; i += kThreads) {
    const int r = i / dp, d = i - r * dp;
    dst[r * ld + d] = r < n && d < dh ? to_float(x[(size_t)(row0 + r) * C + c0 + d]) : 0.f;
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

// ds_entry with its two divisions by savqa_f32::div_rn (the same quotients),
// from rz = 1 / z and rd = 1 / D.
__device__ __forceinline__ void ds_entry_rcp(float raw, float dn, float g, bool masked,
                                             const RowTerms& t, float rz, float rd, float scale,
                                             float* n_out, float* ds_out) {
  const float s = masked ? kNegMask : raw * scale;
  const float e = expf(s - t.m);
  const float p = savqa_f32::div_rn(e, t.z, rz);
  const float n = savqa_f32::div_rn(e * g, t.D, rd);
  const float ds = n * (dn - t.c1) - p * t.c2;
  *n_out = n;
  *ds_out = masked ? 0.f : ds * scale;
}

// K5. A block owns 16 RPT query rows (RPT rows a thread: 4, or 2 at head
// widths above 128, where 64 rows of Q and dO beside K and V would pass
// the shared memory a block may use).
// Shared memory: Qs, Ds (16 RPT, ld) | Ks, Vs (kBK, ld) | Ss (16 RPT, kLdP) | kms (kBK)
template <typename T, int NDH, int RPT>
__global__ void __launch_bounds__(kThreads, NDH <= 4 ? 2 : 1)
flash_graph_attention_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ key_mask, const float* __restrict__ graph,
    const float* __restrict__ m_in, const float* __restrict__ z_in,
    const float* __restrict__ b_in, const float* __restrict__ delta,
    const T* __restrict__ dout, T* __restrict__ dq, int Tq, int Tk, int C, int H, int renorm,
    float scale) {
  constexpr int BQ = 16 * RPT;
  extern __shared__ __align__(16) float smem[];
  const int dh = C / H;
  const int ld = simt_ld(dh);
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int rows = min(BQ, Tq - q0);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int c0 = h * dh;
  const bool active = ty * RPT < rows;

  float* Qs = smem;
  float* Ds = Qs + BQ * ld;
  float* Ks = Ds + BQ * ld;
  float* Vs = Ks + kBK * ld;
  float* Ss = Vs + kBK * ld;
  float* kms = Ss + BQ * kLdP;

  stage(Qs, q + (size_t)b * Tq * C, q0, rows, BQ, C, c0, dh, ld);
  stage(Ds, dout + (size_t)b * Tq * C, q0, rows, BQ, C, c0, dh, ld);

  RowTerms rt[RPT];
  float acc[RPT][NDH];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = ty * RPT + r;
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
      float s[RPT][4], dn[RPT][4];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = dn[r][c] = 0.f;
      for (int d = 0; d < dh; d += 4) {
        float4 qv[RPT], dv4[RPT], kv[4], vv[4];
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          qv[r] = *reinterpret_cast<const float4*>(Qs + (ty * RPT + r) * ld + d);
          dv4[r] = *reinterpret_cast<const float4*>(Ds + (ty * RPT + r) * ld + d);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          kv[c] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * c) * ld + d);
          vv[c] = *reinterpret_cast<const float4*>(Vs + (tx + 16 * c) * ld + d);
        }
#pragma unroll
        for (int r = 0; r < RPT; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            s[r][c] = dot4(qv[r], kv[c], s[r][c]);
            dn[r][c] = dot4(dv4[r], vv[c], dn[r][c]);
          }
      }
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int row = ty * RPT + r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = tx + 16 * c;
          float n = 0.f, ds = 0.f;
          if (row < rows && j < nk)
            ds_entry(s[r][c], dn[r][c], gb[(size_t)row * Tk + j0 + j], kms[j] == 0.f, rt[r],
                     scale, &n, &ds);
          Ss[row * kLdP + j] = to_float(from_float<T>(ds));   // the bf16 operand
        }
      }
    }
    __syncthreads();  // Ss complete

    if (active) {
      for (int j = 0; j < kBK; j += 4) {
        float4 sv[RPT];
#pragma unroll
        for (int r = 0; r < RPT; ++r)
          sv[r] = *reinterpret_cast<const float4*>(Ss + (ty * RPT + r) * kLdP + j);
#pragma unroll
        for (int i = 0; i < NDH; ++i) {
          const int d = tx + 16 * i;
          if (d < dh) {
            const float k0 = Ks[(j + 0) * ld + d], k1 = Ks[(j + 1) * ld + d];
            const float k2 = Ks[(j + 2) * ld + d], k3 = Ks[(j + 3) * ld + d];
#pragma unroll
            for (int r = 0; r < RPT; ++r) {
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
  for (int r = 0; r < RPT; ++r) {
    const int row = ty * RPT + r;
    if (row >= rows) continue;
#pragma unroll
    for (int i = 0; i < NDH; ++i) {
      const int d = tx + 16 * i;
      if (d < dh) dq[((size_t)b * Tq + q0 + row) * C + c0 + d] = from_float<T>(acc[r][i]);
    }
  }
}

// K6. The query rows pass 16 RI at a time (RI rows a thread: 4, or 2 at
// head widths above 128, where 64 rows of Q and dO beside K and V would
// pass the shared memory a block may use).
// Shared memory: Ks, Vs (kBK, ld) | Qs, Ds (16 RI, ld) | Ns, Ss (16 RI, kLdP)
//                | terms (16 RI RowTerms) | kms (kBK)
template <typename T, int NDH, int RI>
__global__ void __launch_bounds__(kThreads, NDH <= 4 ? 2 : 1)
flash_graph_attention_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ key_mask, const float* __restrict__ graph,
    const float* __restrict__ m_in, const float* __restrict__ z_in,
    const float* __restrict__ b_in, const float* __restrict__ delta,
    const T* __restrict__ dout, T* __restrict__ dk, T* __restrict__ dv, int Tq, int Tk, int C,
    int H, int renorm, float scale) {
  constexpr int BQ = 16 * RI;
  extern __shared__ __align__(16) float smem[];
  const int dh = C / H;
  const int ld = simt_ld(dh);
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
  float* Ds = Qs + BQ * ld;
  float* Ns = Ds + BQ * ld;
  float* Ss = Ns + BQ * kLdP;
  RowTerms* terms = reinterpret_cast<RowTerms*>(Ss + BQ * kLdP);
  float* kms = reinterpret_cast<float*>(terms + BQ);

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

  for (int r0 = 0; r0 < Tq; r0 += BQ) {
    const int nr = min(BQ, Tq - r0);
    __syncthreads();  // Ks, Vs, kms written; the previous step's readers done
    stage(Qs, qb, r0, nr, BQ, C, c0, dh, ld);
    stage(Ds, db, r0, nr, BQ, C, c0, dh, ld);
    for (int r = tid; r < BQ; r += kThreads) {
      if (r < nr) {
        const size_t at = ((size_t)b * H + h) * Tq + r0 + r;
        terms[r] = row_terms(m_in[at], z_in[at], b_in[at], delta[at], renorm);
      } else {
        terms[r] = row_terms(0.f, 1.f, 1.f, 0.f, renorm);
      }
    }
    // the graph tile, read along the keys; replaced by n below
    for (int i = tid; i < BQ * kBK; i += kThreads) {
      const int r = i / kBK, j = i - r * kBK;
      Ns[r * kLdP + j] =
          (r < nr && j < nk) ? graph[((size_t)b * Tq + r0 + r) * Tk + j0 + j] : 0.f;
    }
    __syncthreads();

    if (active) {
      float s[RI][4], dn[RI][4];   // [row i][key c]
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = dn[i][c] = 0.f;
      for (int d = 0; d < dh; d += 4) {
        float4 qv[RI], dv4[RI], kv[4], vv[4];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          qv[i] = *reinterpret_cast<const float4*>(Qs + (tx + 16 * i) * ld + d);
          dv4[i] = *reinterpret_cast<const float4*>(Ds + (tx + 16 * i) * ld + d);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          kv[c] = *reinterpret_cast<const float4*>(Ks + (ty * 4 + c) * ld + d);
          vv[c] = *reinterpret_cast<const float4*>(Vs + (ty * 4 + c) * ld + d);
        }
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            s[i][c] = dot4(qv[i], kv[c], s[i][c]);
            dn[i][c] = dot4(dv4[i], vv[c], dn[i][c]);
          }
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int row = tx + 16 * i;
        const RowTerms t = terms[row];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = ty * 4 + c;
          float n = 0.f, ds = 0.f;
          if (row < nr && j < nk)
            ds_entry(s[i][c], dn[i][c], Ns[row * kLdP + j], kms[j] == 0.f, t, scale, &n, &ds);
          Ns[row * kLdP + j] = to_float(from_float<T>(n));    // the bf16 operands
          Ss[row * kLdP + j] = to_float(from_float<T>(ds));
        }
      }
    }
    __syncthreads();  // Ns, Ss complete

    if (active) {
      for (int r = 0; r < BQ; ++r) {
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

// The kernels an entry picks, by the names of flash_graph_attention.py's
// k56_path, and the head-width instance each launcher starts: 16 x NDH for
// the first SIMT kernels, DH for the tiled ones (the pair kernels at 256), 0
// for the wide kernels, which take any width. Each launcher notes its
// kernel and instance here before it launches; the entries keep the note of
// a launch that succeeded (launched) for the wrappers to read.
enum K56Path { kK56Simt, kK56Wide, kK56Tc, kK56F32 };
thread_local K56Path started_path = kK56Simt;
thread_local int started_width = -1;

void started(K56Path path, int width) {
  started_path = path;
  started_width = width;
}

template <typename T, int NDH>
cudaError_t launch_dq_ndh(const void* q, const void* k, const void* v, const float* key_mask,
                          const float* graph, const float* m_in, const float* z_in,
                          const float* b_in, const float* delta, const void* dout, void* dq,
                          int B, int Tq, int Tk, int C, int H, int renorm, float scale,
                          cudaStream_t stream) {
  constexpr int kRpt = NDH <= 8 ? 4 : 2;   // rows a thread: 64 a block, 32 above head width 128
  constexpr int kRows = 16 * kRpt;
  const int ld = simt_ld(C / H);
  const size_t smem =
      sizeof(float) * ((size_t)(2 * kRows + 2 * kBK) * ld + (size_t)kRows * kLdP + kBK);
  auto kernel = flash_graph_attention_bwd_dq_kernel<T, NDH, kRpt>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + kRows - 1) / kRows, H, B);
  started(kK56Simt, 16 * NDH);
  kernel<<<grid, kThreads, smem, stream>>>(
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
  constexpr int kRi = NDH <= 8 ? 4 : 2;   // rows a step: 64, 32 above head width 128
  constexpr int kRows = 16 * kRi;
  const int ld = simt_ld(C / H);
  const size_t smem = sizeof(float) * ((size_t)(2 * kRows + 2 * kBK) * ld +
                                       2 * (size_t)kRows * kLdP + kBK) +
                      sizeof(RowTerms) * kRows;
  auto kernel = flash_graph_attention_bwd_dkv_kernel<T, NDH, kRi>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tk + kBK - 1) / kBK, H, B);
  started(kK56Simt, 16 * NDH);
  kernel<<<grid, kThreads, smem, stream>>>(
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
  if (dh <= 128) return launch_dq_ndh<T, 8>(args...);
  return launch_dq_ndh<T, 16>(args...);
}

template <typename T, typename... Args>
cudaError_t launch_dkv(int dh, Args... args) {
  if (dh <= 16) return launch_dkv_ndh<T, 1>(args...);
  if (dh <= 32) return launch_dkv_ndh<T, 2>(args...);
  if (dh <= 64) return launch_dkv_ndh<T, 4>(args...);
  if (dh <= 128) return launch_dkv_ndh<T, 8>(args...);
  return launch_dkv_ndh<T, 16>(args...);
}

// ---- the wide kernels (head widths above 256) ----
//
// K4's wide kernel (csrc/flash_graph_attention.cu) cuts a head's output
// channels into chunks of kWideDh (256) over blocks; K5's and K6's do the
// same with dQ and with dK, dV. A score and dN need the whole head width,
// so a block streams Q, dO, K and V through shared memory kScoreChunk (64)
// channels at a time into the SIMT kernels' 4 x 4 tiles (each one FMA chain
// over the head width in ascending order), then stages the rows of its own
// chunk (K for dQ; Q and dO for dK and dV) and runs the SIMT kernels' dS, n
// and second products on them. The scores and dN are recomputed ceil(dh /
// 256) times, once a chunk. Shapes otherwise as the SIMT kernels': K5 64
// query rows a block walking the keys 64 at a time; K6 64 keys a block
// walking the query rows 32 at a time (two a thread).
constexpr int kWideDh = 256;                 // output channels a block: 16 a thread
constexpr int kScoreChunk = 64;              // channels staged at a time for the scores
constexpr int kLdC = kScoreChunk + 4;
constexpr int kLdW = kWideDh + 4;
constexpr int kWideRows = 32;                // K6: query rows a step

__host__ __device__ constexpr size_t dq_wide_smem_bytes() {
  return sizeof(float) * ((size_t)(2 * kBQ + 2 * kBK) * kLdC + (size_t)kBK * kLdW +
                          (size_t)kBQ * kLdP + kBK);
}
__host__ __device__ constexpr size_t dkv_wide_smem_bytes() {
  return sizeof(float) * ((size_t)(2 * kBK + 2 * kWideRows) * kLdC + 2 * (size_t)kWideRows * kLdW +
                          2 * (size_t)kWideRows * kLdP + kBK) +
         sizeof(RowTerms) * kWideRows;
}

// K5. Shared memory: Qc, Dc (kBQ, kLdC) | Kc, Vc (kBK, kLdC) | Ko (kBK, kLdW)
//                    | Ss (kBQ, kLdP) | kms (kBK)
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_graph_attention_bwd_dq_wide_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ key_mask, const float* __restrict__ graph,
    const float* __restrict__ m_in, const float* __restrict__ z_in,
    const float* __restrict__ b_in, const float* __restrict__ delta,
    const T* __restrict__ dout, T* __restrict__ dq, int Tq, int Tk, int C, int H, int renorm,
    float scale) {
  constexpr int RPT = 4;
  extern __shared__ __align__(16) float smem[];
  const int dh = C / H;
  const int n_chunks = (dh + kWideDh - 1) / kWideDh;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y / n_chunks;
  const int o0 = (blockIdx.y - h * n_chunks) * kWideDh;
  const int ow = min(kWideDh, dh - o0);
  const int b = blockIdx.z;
  const int rows = min(kBQ, Tq - q0);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int c0 = h * dh;
  const bool active = ty * RPT < rows;

  float* Qc = smem;
  float* Dc = Qc + kBQ * kLdC;
  float* Kc = Dc + kBQ * kLdC;
  float* Vc = Kc + kBK * kLdC;
  float* Ko = Vc + kBK * kLdC;
  float* Ss = Ko + kBK * kLdW;
  float* kms = Ss + kBQ * kLdP;

  RowTerms rt[RPT];
  float acc[RPT][kWideDh / 16];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = ty * RPT + r;
    if (row < rows) {
      const size_t at = ((size_t)b * H + h) * Tq + q0 + row;
      rt[r] = row_terms(m_in[at], z_in[at], b_in[at], delta[at], renorm);
    } else {
      rt[r] = row_terms(0.f, 1.f, 1.f, 0.f, renorm);
    }
#pragma unroll
    for (int i = 0; i < kWideDh / 16; ++i) acc[r][i] = 0.f;
  }

  const T* qb = q + (size_t)b * Tq * C;
  const T* db = dout + (size_t)b * Tq * C;
  const T* kb = k + (size_t)b * Tk * C;
  const T* vb = v + (size_t)b * Tk * C;
  const float* km = key_mask + (size_t)b * Tk;
  const float* gb = graph + ((size_t)b * Tq + q0) * Tk;

  for (int j0 = 0; j0 < Tk; j0 += kBK) {
    const int nk = min(kBK, Tk - j0);
    float s[RPT][4], dn[RPT][4];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = dn[r][c] = 0.f;
    for (int dc = 0; dc < dh; dc += kScoreChunk) {
      const int w = min(kScoreChunk, dh - dc);
      __syncthreads();  // the readers of the chunk (and of the step) before are done
      stage(Qc, qb, q0, rows, kBQ, C, c0 + dc, w, kLdC);
      stage(Dc, db, q0, rows, kBQ, C, c0 + dc, w, kLdC);
      stage(Kc, kb, j0, nk, kBK, C, c0 + dc, w, kLdC);
      stage(Vc, vb, j0, nk, kBK, C, c0 + dc, w, kLdC);
      __syncthreads();
      if (!active) continue;
      const int wp = (w + 3) / 4 * 4;
      for (int d = 0; d < wp; d += 4) {
        float4 qv[RPT], dv4[RPT], kv[4], vv[4];
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          qv[r] = *reinterpret_cast<const float4*>(Qc + (ty * RPT + r) * kLdC + d);
          dv4[r] = *reinterpret_cast<const float4*>(Dc + (ty * RPT + r) * kLdC + d);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          kv[c] = *reinterpret_cast<const float4*>(Kc + (tx + 16 * c) * kLdC + d);
          vv[c] = *reinterpret_cast<const float4*>(Vc + (tx + 16 * c) * kLdC + d);
        }
#pragma unroll
        for (int r = 0; r < RPT; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            s[r][c] = dot4(qv[r], kv[c], s[r][c]);
            dn[r][c] = dot4(dv4[r], vv[c], dn[r][c]);
          }
      }
    }
    stage(Ko, kb, j0, nk, kBK, C, c0 + o0, ow, kLdW);
    for (int j = tid; j < kBK; j += kThreads) kms[j] = j < nk ? km[j0 + j] : 0.f;
    __syncthreads();

    if (active) {
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int row = ty * RPT + r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = tx + 16 * c;
          float n = 0.f, ds = 0.f;
          if (row < rows && j < nk)
            ds_entry(s[r][c], dn[r][c], gb[(size_t)row * Tk + j0 + j], kms[j] == 0.f, rt[r],
                     scale, &n, &ds);
          Ss[row * kLdP + j] = to_float(from_float<T>(ds));   // the bf16 operand
        }
      }
    }
    __syncthreads();  // Ss complete

    if (active) {
      for (int j = 0; j < kBK; j += 4) {
        float4 sv[RPT];
#pragma unroll
        for (int r = 0; r < RPT; ++r)
          sv[r] = *reinterpret_cast<const float4*>(Ss + (ty * RPT + r) * kLdP + j);
#pragma unroll
        for (int i = 0; i < kWideDh / 16; ++i) {
          const int d = tx + 16 * i;
          if (d < ow) {
            const float k0 = Ko[(j + 0) * kLdW + d], k1 = Ko[(j + 1) * kLdW + d];
            const float k2 = Ko[(j + 2) * kLdW + d], k3 = Ko[(j + 3) * kLdW + d];
#pragma unroll
            for (int r = 0; r < RPT; ++r) {
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
  for (int r = 0; r < RPT; ++r) {
    const int row = ty * RPT + r;
    if (row >= rows) continue;
#pragma unroll
    for (int i = 0; i < kWideDh / 16; ++i) {
      const int d = tx + 16 * i;
      if (d < ow) dq[((size_t)b * Tq + q0 + row) * C + c0 + o0 + d] = from_float<T>(acc[r][i]);
    }
  }
}

// K6. Shared memory: Kc, Vc (kBK, kLdC) | Qc, Dc (kWideRows, kLdC)
//   | Qo, Do (kWideRows, kLdW) | Ns, Ss (kWideRows, kLdP) | kms (kBK) | terms (kWideRows)
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_graph_attention_bwd_dkv_wide_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ key_mask, const float* __restrict__ graph,
    const float* __restrict__ m_in, const float* __restrict__ z_in,
    const float* __restrict__ b_in, const float* __restrict__ delta,
    const T* __restrict__ dout, T* __restrict__ dk, T* __restrict__ dv, int Tq, int Tk, int C,
    int H, int renorm, float scale) {
  constexpr int BQ = kWideRows;
  constexpr int RI = BQ / 16;
  extern __shared__ __align__(16) float smem[];
  const int dh = C / H;
  const int n_chunks = (dh + kWideDh - 1) / kWideDh;
  const int j0 = blockIdx.x * kBK;
  const int h = blockIdx.y / n_chunks;
  const int o0 = (blockIdx.y - h * n_chunks) * kWideDh;
  const int ow = min(kWideDh, dh - o0);
  const int b = blockIdx.z;
  const int nk = min(kBK, Tk - j0);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int c0 = h * dh;
  const bool active = ty * 4 < nk;

  float* Kc = smem;
  float* Vc = Kc + kBK * kLdC;
  float* Qc = Vc + kBK * kLdC;
  float* Dc = Qc + BQ * kLdC;
  float* Qo = Dc + BQ * kLdC;
  float* Do = Qo + BQ * kLdW;
  float* Ns = Do + BQ * kLdW;
  float* Ss = Ns + BQ * kLdP;
  float* kms = Ss + BQ * kLdP;
  RowTerms* terms = reinterpret_cast<RowTerms*>(kms + kBK);

  for (int j = tid; j < kBK; j += kThreads)
    kms[j] = j < nk ? key_mask[(size_t)b * Tk + j0 + j] : 0.f;

  float acc_k[4][kWideDh / 16], acc_v[4][kWideDh / 16];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int i = 0; i < kWideDh / 16; ++i) acc_k[c][i] = acc_v[c][i] = 0.f;

  const T* qb = q + (size_t)b * Tq * C;
  const T* db = dout + (size_t)b * Tq * C;
  const T* kb = k + (size_t)b * Tk * C;
  const T* vb = v + (size_t)b * Tk * C;

  for (int r0 = 0; r0 < Tq; r0 += BQ) {
    const int nr = min(BQ, Tq - r0);
    float s[RI][4], dn[RI][4];   // [row i][key c]
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = dn[i][c] = 0.f;
    for (int dc = 0; dc < dh; dc += kScoreChunk) {
      const int w = min(kScoreChunk, dh - dc);
      __syncthreads();  // kms written; the readers of the chunk (and of the step) before done
      stage(Kc, kb, j0, nk, kBK, C, c0 + dc, w, kLdC);
      stage(Vc, vb, j0, nk, kBK, C, c0 + dc, w, kLdC);
      stage(Qc, qb, r0, nr, BQ, C, c0 + dc, w, kLdC);
      stage(Dc, db, r0, nr, BQ, C, c0 + dc, w, kLdC);
      __syncthreads();
      if (!active) continue;
      const int wp = (w + 3) / 4 * 4;
      for (int d = 0; d < wp; d += 4) {
        float4 qv[RI], dv4[RI], kv[4], vv[4];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          qv[i] = *reinterpret_cast<const float4*>(Qc + (tx + 16 * i) * kLdC + d);
          dv4[i] = *reinterpret_cast<const float4*>(Dc + (tx + 16 * i) * kLdC + d);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          kv[c] = *reinterpret_cast<const float4*>(Kc + (ty * 4 + c) * kLdC + d);
          vv[c] = *reinterpret_cast<const float4*>(Vc + (ty * 4 + c) * kLdC + d);
        }
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            s[i][c] = dot4(qv[i], kv[c], s[i][c]);
            dn[i][c] = dot4(dv4[i], vv[c], dn[i][c]);
          }
      }
    }
    stage(Qo, qb, r0, nr, BQ, C, c0 + o0, ow, kLdW);
    stage(Do, db, r0, nr, BQ, C, c0 + o0, ow, kLdW);
    for (int r = tid; r < BQ; r += kThreads) {
      if (r < nr) {
        const size_t at = ((size_t)b * H + h) * Tq + r0 + r;
        terms[r] = row_terms(m_in[at], z_in[at], b_in[at], delta[at], renorm);
      } else {
        terms[r] = row_terms(0.f, 1.f, 1.f, 0.f, renorm);
      }
    }
    // the graph tile, read along the keys; replaced by n below
    for (int i = tid; i < BQ * kBK; i += kThreads) {
      const int r = i / kBK, j = i - r * kBK;
      Ns[r * kLdP + j] =
          (r < nr && j < nk) ? graph[((size_t)b * Tq + r0 + r) * Tk + j0 + j] : 0.f;
    }
    __syncthreads();

    if (active) {
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int row = tx + 16 * i;
        const RowTerms t = terms[row];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = ty * 4 + c;
          float n = 0.f, ds = 0.f;
          if (row < nr && j < nk)
            ds_entry(s[i][c], dn[i][c], Ns[row * kLdP + j], kms[j] == 0.f, t, scale, &n, &ds);
          Ns[row * kLdP + j] = to_float(from_float<T>(n));    // the bf16 operands
          Ss[row * kLdP + j] = to_float(from_float<T>(ds));
        }
      }
    }
    __syncthreads();  // Ns, Ss complete

    if (active) {
      for (int r = 0; r < BQ; ++r) {
        const float4 nv = *reinterpret_cast<const float4*>(Ns + r * kLdP + ty * 4);
        const float4 sv = *reinterpret_cast<const float4*>(Ss + r * kLdP + ty * 4);
#pragma unroll
        for (int i = 0; i < kWideDh / 16; ++i) {
          const int d = tx + 16 * i;
          if (d < ow) {
            const float dor = Do[r * kLdW + d];
            const float qr = Qo[r * kLdW + d];
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
    for (int i = 0; i < kWideDh / 16; ++i) {
      const int d = tx + 16 * i;
      if (d >= ow) continue;
      const size_t at = ((size_t)b * Tk + j0 + j) * C + c0 + o0 + d;
      dk[at] = from_float<T>(acc_k[c][i]);
      dv[at] = from_float<T>(acc_v[c][i]);
    }
  }
}

// Grid (tiles, heads x ceil(dh / 256) chunks, batch) of a wide kernel.
inline cudaError_t wide_grid(dim3* grid, int tiles, int B, int C, int H) {
  const long long heads = (long long)H * ((C / H + kWideDh - 1) / kWideDh);
  if (heads > 65535) return cudaErrorInvalidConfiguration;
  *grid = dim3(tiles, (unsigned)heads, B);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_dq_wide(const void* q, const void* k, const void* v, const float* key_mask,
                           const float* graph, const float* m_in, const float* z_in,
                           const float* b_in, const float* delta, const void* dout, void* dq,
                           int B, int Tq, int Tk, int C, int H, int renorm, float scale,
                           cudaStream_t stream) {
  constexpr size_t smem = dq_wide_smem_bytes();
  auto kernel = flash_graph_attention_bwd_dq_wide_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid;
  err = wide_grid(&grid, (Tq + kBQ - 1) / kBQ, B, C, H);
  if (err != cudaSuccess) return err;
  started(kK56Wide, 0);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), key_mask,
      graph, m_in, z_in, b_in, delta, static_cast<const T*>(dout), static_cast<T*>(dq), Tq, Tk,
      C, H, renorm, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv_wide(const void* q, const void* k, const void* v, const float* key_mask,
                            const float* graph, const float* m_in, const float* z_in,
                            const float* b_in, const float* delta, const void* dout, void* dk,
                            void* dv, int B, int Tq, int Tk, int C, int H, int renorm,
                            float scale, cudaStream_t stream) {
  constexpr size_t smem = dkv_wide_smem_bytes();
  auto kernel = flash_graph_attention_bwd_dkv_wide_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid;
  err = wide_grid(&grid, (Tk + kBK - 1) / kBK, B, C, H);
  if (err != cudaSuccess) return err;
  started(kK56Wide, 0);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), key_mask,
      graph, m_in, z_in, b_in, delta, static_cast<const T*>(dout), static_cast<T*>(dk),
      static_cast<T*>(dv), Tq, Tk, C, H, renorm, scale);
  return cudaGetLastError();
}

// ---- K6's f32 kernel (csrc/simt_f32.cuh) ----

namespace f32 = savqa_f32;

constexpr int kF32Keys = 64;   // keys a block, 16 a warp
constexpr int kF32Rows = 32;   // query rows a step

// Floats of one stage: Qc, dOc (32, DH), Gs (32, 64), the rows' m, z, b and
// delta (4, 32); of a block: Ks, Vs (64, DH), the warps' transposed tiles
// (4, 32, 16), two stages.
__host__ __device__ constexpr int dkv_f32_stage_floats(int dh) {
  return 2 * kF32Rows * dh + kF32Rows * kF32Keys + 4 * kF32Rows;
}
__host__ __device__ constexpr int dkv_f32_smem_floats(int dh) {
  return 2 * kF32Keys * dh + 4 * kF32Rows * 16 + 2 * dkv_f32_stage_floats(dh);
}

template <int DH>
__global__ void __launch_bounds__(128, DH <= 64 ? 2 : 1)
flash_graph_attention_bwd_dkv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ key_mask, const float* __restrict__ graph,
    const float* __restrict__ m_in, const float* __restrict__ z_in,
    const float* __restrict__ b_in, const float* __restrict__ delta,
    const float* __restrict__ dout, float* __restrict__ dk, float* __restrict__ dv, int Tq,
    int Tk, int C, int H, int dh, int renorm, float scale) {
  constexpr int kThr = 128;
  constexpr int kStageF = dkv_f32_stage_floats(DH);
  extern __shared__ __align__(16) float smem_kv[];
  float* Ks = smem_kv;
  float* Vs = Ks + kF32Keys * DH;
  float* bt = Vs + kF32Keys * DH;
  float* stages = bt + 4 * kF32Rows * 16;

  const int h = blockIdx.x;
  const int j0 = blockIdx.y * kF32Keys;
  const int b = blockIdx.z;
  const int c0 = h * dh;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ly = lane >> 3, lx = lane & 7;
  const int n_steps = (Tq + kF32Rows - 1) / kF32Rows;
  const bool gvec = (Tk & 3) == 0;   // the graph's rows are 16-byte aligned
  const float* qb = q + (size_t)b * Tq * C;
  const float* dob = dout + (size_t)b * Tq * C;
  const float* gb = graph + (size_t)b * Tq * Tk;
  const size_t st0 = ((size_t)b * H + h) * Tq;   // this (batch, head)'s rows of m, z, b, delta

  auto load_step = [&](int step) {
    float* base = stages + (step & 1) * kStageF;
    const int r0 = step * kF32Rows;
    f32::stage_tile<DH, kThr>(base, qb, r0, Tq, kF32Rows, C, c0, dh, true, f32::Swz<DH>());
    f32::stage_tile<DH, kThr>(base + kF32Rows * DH, dob, r0, Tq, kF32Rows, C, c0, dh, true,
                              f32::Swz<DH>());
    f32::stage_tile<kF32Keys, kThr>(base + 2 * kF32Rows * DH, gb, r0, Tq, kF32Rows, Tk, j0,
                                    Tk - j0, gvec, f32::Swz<kF32Keys>());
    float* raw = base + 2 * kF32Rows * DH + kF32Rows * kF32Keys;
    for (int i = tid; i < 4 * kF32Rows; i += kThr) {   // (m, z, b, delta) x 32 rows
      const int which = i / kF32Rows, r = r0 + i - which * kF32Rows;
      const float* src = which == 0 ? m_in : which == 1 ? z_in : which == 2 ? b_in : delta;
      const bool valid = r < Tq;
      savqa::cp_async4(raw + i, src + st0 + (valid ? r : 0), valid);
    }
  };
  f32::stage_tile<DH, kThr>(Ks, k + (size_t)b * Tk * C, j0, Tk, kF32Keys, C, c0, dh, true,
                            f32::Swz<DH>());
  f32::stage_tile<DH, kThr>(Vs, v + (size_t)b * Tk * C, j0, Tk, kF32Keys, C, c0, dh, true,
                            f32::Swz<DH>());
  load_step(0);
  savqa::cp_async_commit();

  int kw[4];
  bool masked[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    kw[i] = warp * 16 + ly + 4 * i;
    const int key = j0 + kw[i];
    masked[i] = key >= Tk || key_mask[(size_t)b * Tk + key] == 0.f;   // past Tk: never written
  }
  const bool active = j0 + warp * 16 < Tk;
  float* pt = bt + warp * kF32Rows * 16;
  float dka[4][DH / 8], dva[4][DH / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < DH / 8; ++e) dka[i][e] = dva[i][e] = 0.f;

  for (int step = 0; step < n_steps; ++step) {
    savqa::cp_async_wait<0>();
    __syncthreads();   // this step's tiles (and K, V) have landed; the other stage is free
    if (step + 1 < n_steps) load_step(step + 1);
    savqa::cp_async_commit();
    if (!active) continue;
    const float* base = stages + (step & 1) * kStageF;
    const float* Qc = base;
    const float* dOc = base + kF32Rows * DH;
    const float* Gs = base + 2 * kF32Rows * DH;
    const float* raw = Gs + kF32Rows * kF32Keys;
    float w[4][4], dn[4][4];   // [key ly + 4 i][row lx + 8 c]
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) w[i][c] = dn[i][c] = 0.f;
    f32::tile_abt<DH, 4>(w, Ks, warp * 16, Qc, dh, ly, lx);    // S^T = K Q^T
    f32::tile_abt<DH, 4>(dn, Vs, warp * 16, dOc, dh, ly, lx);  // dN^T = V dO^T
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = lx + 8 * c;
      const bool real = step * kF32Rows + r < Tq;
      const RowTerms t = row_terms(raw[r], raw[kF32Rows + r], raw[2 * kF32Rows + r],
                                   raw[3 * kF32Rows + r], renorm);   // zeros past Tq: unused
      const float rz = 1.f / t.z, rd = 1.f / t.D;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float n, ds;
        ds_entry_rcp(w[i][c], dn[i][c], Gs[f32::swz<kF32Keys>(r, kw[i])], masked[i], t, rz, rd,
                     scale, &n, &ds);
        w[i][c] = real ? n : 0.f;    // n and dS of key ly + 4 i, row lx + 8 c
        dn[i][c] = real ? ds : 0.f;
      }
    }
    __syncwarp();   // the previous step's readers of pt are done
    f32::store_t<4>(pt, w, ly, lx);
    __syncwarp();
    f32::tile_pv<DH, kF32Rows>(dva, pt, dOc, ly, lx);   // dV += N^T dO
    __syncwarp();
    f32::store_t<4>(pt, dn, ly, lx);
    __syncwarp();
    f32::tile_pv<DH, kF32Rows>(dka, pt, Qc, ly, lx);    // dK += dS^T Q
  }
  savqa::cp_async_wait<0>();
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

template <int DH>
cudaError_t launch_dkv_f32_dh(const float* q, const float* k, const float* v,
                              const float* key_mask, const float* graph, const float* m_in,
                              const float* z_in, const float* b_in, const float* delta,
                              const float* dout, float* dk, float* dv, int B, int Tq, int Tk,
                              int C, int H, int renorm, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * dkv_f32_smem_floats(DH);
  auto kernel = flash_graph_attention_bwd_dkv_f32_kernel<DH>;
  // once a process: the one-query calls are short enough for the host's
  // attribute calls to show
  static const cudaError_t attributes = f32::allow_smem(kernel, smem);
  if (attributes != cudaSuccess) return attributes;
  const dim3 grid(H, (Tk + kF32Keys - 1) / kF32Keys, B);
  started(kK56F32, DH);
  kernel<<<grid, 128, smem, stream>>>(q, k, v, key_mask, graph, m_in, z_in, b_in, delta, dout,
                                      dk, dv, Tq, Tk, C, H, C / H, renorm, scale);
  return cudaGetLastError();
}

// Barrier of the two warps of pair `pair` (named barrier 1 + pair, 64
// threads): the pair kernels below pass a sub-step's scores from one warp
// to the other through shared memory.
__device__ __forceinline__ void pair_sync(int pair) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + pair) : "memory");
}

// K6 in f32 at instance 256 (head widths 132-256): dK's and dV's 4 x 32
// accumulators a lane each (256 registers) do not fit one warp, so a key
// group's dV and dK go to two warps. A block of 4 warps owns 32 keys (K and
// V at 256 take 64 KB); warp w holds key group w & 1 and role w >> 1: role
// 0 forms S^T = K Q^T, passes the raw scores to its partner through
// shared memory (pair_sync) and adds N^T dO into dV; role 1 forms dN^T = V
// dO^T, takes the scores and adds dS^T Q into dK. Every product is the one
// FMA chain of the 64-key kernel above (ds_entry_rcp on the same raw
// scores): its bits. Query rows 32 a step through the same two-stage ring.
constexpr int kF32PairKeys = 32;   // keys a block of the pair kernel, 16 a key group

__host__ __device__ constexpr int dkv_f32_pair_stage_floats(int dh) {
  return 2 * kF32Rows * dh + kF32Rows * kF32PairKeys + 4 * kF32Rows;
}
// Ks, Vs (32, DH), the warps' transposed (32, 16) tiles, the pairs' (2, 32
// lanes, 16) score exchange, two stages.
__host__ __device__ constexpr int dkv_f32_pair_smem_floats(int dh) {
  return 2 * kF32PairKeys * dh + 4 * kF32Rows * 16 + 2 * 32 * 16 +
         2 * dkv_f32_pair_stage_floats(dh);
}

template <int DH>
__global__ void __launch_bounds__(128, 1)
flash_graph_attention_bwd_dkv_f32_pair_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ key_mask, const float* __restrict__ graph,
    const float* __restrict__ m_in, const float* __restrict__ z_in,
    const float* __restrict__ b_in, const float* __restrict__ delta,
    const float* __restrict__ dout, float* __restrict__ dk, float* __restrict__ dv, int Tq,
    int Tk, int C, int H, int dh, int renorm, float scale) {
  constexpr int kThr = 128;
  constexpr int kKeys = kF32PairKeys;
  constexpr int kStageF = dkv_f32_pair_stage_floats(DH);
  extern __shared__ __align__(16) float smem_pair[];
  float* Ks = smem_pair;
  float* Vs = Ks + kKeys * DH;
  float* bt = Vs + kKeys * DH;
  float* xs = bt + 4 * kF32Rows * 16;
  float* stages = xs + 2 * 32 * 16;

  const int h = blockIdx.x;
  const int j0 = blockIdx.y * kKeys;
  const int b = blockIdx.z;
  const int c0 = h * dh;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kg = warp & 1;      // key group: keys kg 16 .. kg 16 + 15 of the block
  const int role = warp >> 1;   // 0: S^T and dV, 1: dN^T and dK
  const int ly = lane >> 3, lx = lane & 7;
  const int n_steps = (Tq + kF32Rows - 1) / kF32Rows;
  const bool gvec = (Tk & 3) == 0;
  const float* qb = q + (size_t)b * Tq * C;
  const float* dob = dout + (size_t)b * Tq * C;
  const float* gb = graph + (size_t)b * Tq * Tk;
  const size_t st0 = ((size_t)b * H + h) * Tq;

  auto load_step = [&](int step) {
    float* base = stages + (step & 1) * kStageF;
    const int r0 = step * kF32Rows;
    f32::stage_tile<DH, kThr>(base, qb, r0, Tq, kF32Rows, C, c0, dh, true, f32::Swz<DH>());
    f32::stage_tile<DH, kThr>(base + kF32Rows * DH, dob, r0, Tq, kF32Rows, C, c0, dh, true,
                              f32::Swz<DH>());
    f32::stage_tile<kKeys, kThr>(base + 2 * kF32Rows * DH, gb, r0, Tq, kF32Rows, Tk, j0,
                                 Tk - j0, gvec, f32::Swz<kKeys>());
    float* raw = base + 2 * kF32Rows * DH + kF32Rows * kKeys;
    for (int i = tid; i < 4 * kF32Rows; i += kThr) {   // (m, z, b, delta) x 32 rows
      const int which = i / kF32Rows, r = r0 + i - which * kF32Rows;
      const float* src = which == 0 ? m_in : which == 1 ? z_in : which == 2 ? b_in : delta;
      const bool valid = r < Tq;
      savqa::cp_async4(raw + i, src + st0 + (valid ? r : 0), valid);
    }
  };
  f32::stage_tile<DH, kThr>(Ks, k + (size_t)b * Tk * C, j0, Tk, kKeys, C, c0, dh, true,
                            f32::Swz<DH>());
  f32::stage_tile<DH, kThr>(Vs, v + (size_t)b * Tk * C, j0, Tk, kKeys, C, c0, dh, true,
                            f32::Swz<DH>());
  load_step(0);
  savqa::cp_async_commit();

  int kw[4];
  bool masked[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    kw[i] = kg * 16 + ly + 4 * i;
    const int key = j0 + kw[i];
    masked[i] = key >= Tk || key_mask[(size_t)b * Tk + key] == 0.f;
  }
  const bool active = j0 + kg * 16 < Tk;   // the same for both warps of a pair
  float* pt = bt + warp * kF32Rows * 16;
  float* xp = xs + kg * 32 * 16;           // the pair's raw scores: float4 slot (i, lane)
  float acc[4][DH / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < DH / 8; ++e) acc[i][e] = 0.f;

  for (int step = 0; step < n_steps; ++step) {
    savqa::cp_async_wait<0>();
    __syncthreads();   // this step's tiles (and K, V) have landed; the other stage is free
    if (step + 1 < n_steps) load_step(step + 1);
    savqa::cp_async_commit();
    if (!active) continue;
    const float* base = stages + (step & 1) * kStageF;
    const float* Qc = base;
    const float* dOc = base + kF32Rows * DH;
    const float* Gs = base + 2 * kF32Rows * DH;
    const float* raw = Gs + kF32Rows * kKeys;
    float x[4][4];   // [key ly + 4 i][row lx + 8 c]: S^T (role 0) or dN^T (role 1)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) x[i][c] = 0.f;
    f32::tile_abt<DH, 4>(x, role ? Vs : Ks, kg * 16, role ? dOc : Qc, dh, ly, lx);
    if (role == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(xp + (i * 32 + lane) * 4) =
            make_float4(x[i][0], x[i][1], x[i][2], x[i][3]);
    }
    pair_sync(kg);
    float sc[4][4];   // the raw scores
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (role == 0) {
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[i][c] = x[i][c];
      } else {
        const float4 r4 = *reinterpret_cast<const float4*>(xp + (i * 32 + lane) * 4);
        sc[i][0] = r4.x, sc[i][1] = r4.y, sc[i][2] = r4.z, sc[i][3] = r4.w;
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = lx + 8 * c;
      const bool real = step * kF32Rows + r < Tq;
      const RowTerms t = row_terms(raw[r], raw[kF32Rows + r], raw[2 * kF32Rows + r],
                                   raw[3 * kF32Rows + r], renorm);   // zeros past Tq: unused
      const float rz = 1.f / t.z, rd = 1.f / t.D;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float n, ds;
        ds_entry_rcp(sc[i][c], role ? x[i][c] : 0.f, Gs[f32::swz<kKeys>(r, kw[i])], masked[i],
                     t, rz, rd, scale, &n, &ds);
        x[i][c] = real ? (role ? ds : n) : 0.f;   // n (role 0) or dS (role 1)
      }
    }
    __syncwarp();   // the previous step's readers of pt are done
    f32::store_t<4>(pt, x, ly, lx);
    __syncwarp();
    f32::tile_pv<DH, kF32Rows>(acc, pt, role ? Qc : dOc, ly, lx);   // dV += N^T dO, dK += dS^T Q
  }
  savqa::cp_async_wait<0>();
  if (!active) return;
  float* out = role ? dk : dv;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = j0 + kw[i];
    if (key >= Tk) continue;
#pragma unroll
    for (int g = 0; g < DH / 32; ++g) {
      const int d = 4 * lx + 32 * g;
      if (d >= dh) continue;
      const float* a4 = acc[i] + 4 * g;
      *reinterpret_cast<float4*>(out + ((size_t)b * Tk + key) * C + c0 + d) =
          make_float4(a4[0], a4[1], a4[2], a4[3]);
    }
  }
}

template <int DH>
cudaError_t launch_dkv_f32_pair(const float* q, const float* k, const float* v,
                                const float* key_mask, const float* graph, const float* m_in,
                                const float* z_in, const float* b_in, const float* delta,
                                const float* dout, float* dk, float* dv, int B, int Tq, int Tk,
                                int C, int H, int renorm, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * dkv_f32_pair_smem_floats(DH);
  auto kernel = flash_graph_attention_bwd_dkv_f32_pair_kernel<DH>;
  static const cudaError_t attributes = f32::allow_smem(kernel, smem);
  if (attributes != cudaSuccess) return attributes;
  const dim3 grid(H, (Tk + kF32PairKeys - 1) / kF32PairKeys, B);
  started(kK56F32, DH);
  kernel<<<grid, 128, smem, stream>>>(q, k, v, key_mask, graph, m_in, z_in, b_in, delta, dout,
                                      dk, dv, Tq, Tk, C, H, C / H, renorm, scale);
  return cudaGetLastError();
}

template <typename... Args>
cudaError_t launch_dkv_f32(int dh, Args... args) {
  if (dh <= 32) return launch_dkv_f32_dh<32>(args...);
  if (dh <= 64) return launch_dkv_f32_dh<64>(args...);
  if (dh <= 128) return launch_dkv_f32_dh<128>(args...);
  return launch_dkv_f32_pair<256>(args...);
}

// dQ = the sum of n_split f32 partials (n_split, n), added in shard order
// and rounded to T; one thread an element (K5's key split, both kernels).
template <typename T>
__global__ void __launch_bounds__(256)
flash_graph_attention_bwd_dq_sum_kernel(const float* __restrict__ dq_part, T* __restrict__ dq,
                                        int n_split, size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = dq_part[i];
  for (int sp = 1; sp < n_split; ++sp) acc += dq_part[(size_t)sp * n + i];
  dq[i] = from_float<T>(acc);
}

template <typename T>
cudaError_t launch_dq_sum(const float* dq_part, T* dq, int n_split, size_t n,
                          cudaStream_t stream) {
  flash_graph_attention_bwd_dq_sum_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      dq_part, dq, n_split, n);
  return cudaGetLastError();
}

// ---- K5's f32 kernel (csrc/simt_f32.cuh) ----

constexpr int kDqF32Step = 32;   // keys a step

// Keys a step of instance DH: 32, 16 at 256, where two stages of 32-key K
// and V tiles would not fit beside 64 rows of Q and dO (f32, 128 KB).
__host__ __device__ constexpr int dq_f32_step(int dh) { return dh > 128 ? 16 : kDqF32Step; }

// Floats of one stage: Ks, Vs (step, DH), Gs (16 WARPS, step), the key mask
// (step); of a block: Qs, dOs (16 WARPS, DH), two stages.
__host__ __device__ constexpr int dq_f32_stage_floats(int dh, int warps) {
  return 2 * dq_f32_step(dh) * dh + 16 * warps * dq_f32_step(dh) + dq_f32_step(dh);
}
__host__ __device__ constexpr int dq_f32_smem_floats(int dh, int warps) {
  return 2 * 16 * warps * dh + 2 * dq_f32_stage_floats(dh, warps);
}

// dQ of (head blockIdx.x, query tile and key shard blockIdx.y = qt n_split
// + sp, batch blockIdx.z): 16 WARPS query rows, Q and dO staged once, the
// shard's keys 32 (16 at instance 256: dq_f32_step) a step through a
// two-stage ring of (K, V, graph tile, key mask). Per step a lane forms S
// and dN for its 4 x 4 (4 x 2 at 256) (row, key) tile by
// tile_abt, dS by ds_entry_rcp from its rows' terms (held in registers),
// writes dS over its warp's rows of the graph tile, read by then, and adds
// dS K through that transposed tile (store_t, tile_pv). With one shard it
// writes dQ, else its f32 partial at shard sp of dq_part (n_split, B, Tq, C).
template <int DH, int WARPS>
__global__ void __launch_bounds__(WARPS * 32, WARPS == 4 && DH <= 64 ? 2 : 1)
flash_graph_attention_bwd_dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ key_mask, const float* __restrict__ graph,
    const float* __restrict__ m_in, const float* __restrict__ z_in,
    const float* __restrict__ b_in, const float* __restrict__ delta,
    const float* __restrict__ dout, float* __restrict__ dq, float* __restrict__ dq_part, int Tq,
    int Tk, int C, int H, int dh, int renorm, float scale, int n_split, int steps_per_split) {
  constexpr int kBQ = 16 * WARPS;
  constexpr int kThr = 32 * WARPS;
  constexpr int kStageF = dq_f32_stage_floats(DH, WARPS);
  constexpr int kStepK = dq_f32_step(DH);   // keys a step
  constexpr int kNC = kStepK / 8;           // a lane's keys of a step
  extern __shared__ __align__(16) float smem_dq[];
  float* Qs = smem_dq;
  float* dOs = Qs + kBQ * DH;
  float* stages = dOs + kBQ * DH;

  const int h = blockIdx.x;
  const int qt = blockIdx.y / n_split;
  const int sp = blockIdx.y - qt * n_split;
  const int b = blockIdx.z;
  const int q0 = qt * kBQ;
  const int c0 = h * dh;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ly = lane >> 3, lx = lane & 7;
  const int wrow = warp * 16;
  const int n_steps = (Tk + kStepK - 1) / kStepK;
  const int step_lo = sp * steps_per_split;
  const int step_hi = min(n_steps, step_lo + steps_per_split);
  const bool active = q0 + wrow < Tq;   // this warp holds a real row
  const bool gvec = (Tk & 3) == 0;        // the graph's rows are 16-byte aligned
  const float* kb = k + (size_t)b * Tk * C;
  const float* vb = v + (size_t)b * Tk * C;
  const float* gb = graph + (size_t)b * Tq * Tk;
  const float* km = key_mask + (size_t)b * Tk;

  auto load_step = [&](int step) {
    float* base = stages + ((step - step_lo) & 1) * kStageF;
    const int j0 = step * kStepK;
    f32::stage_tile<DH, kThr>(base, kb, j0, Tk, kStepK, C, c0, dh, true, f32::Swz<DH>());
    f32::stage_tile<DH, kThr>(base + kStepK * DH, vb, j0, Tk, kStepK, C, c0, dh, true,
                              f32::Swz<DH>());
    f32::stage_tile<kStepK, kThr>(base + 2 * kStepK * DH, gb, q0, Tq, kBQ, Tk, j0, Tk - j0,
                                  gvec, f32::GSwz<kStepK>());
    float* kms = base + 2 * kStepK * DH + kBQ * kStepK;
    for (int j = tid; j < kStepK; j += kThr)
      savqa::cp_async4(kms + j, km + (j0 + j < Tk ? j0 + j : 0), j0 + j < Tk);
  };
  f32::stage_tile<DH, kThr>(Qs, q + (size_t)b * Tq * C, q0, Tq, kBQ, C, c0, dh, true,
                            f32::Swz<DH>());
  f32::stage_tile<DH, kThr>(dOs, dout + (size_t)b * Tq * C, q0, Tq, kBQ, C, c0, dh, true,
                            f32::Swz<DH>());
  load_step(step_lo);
  savqa::cp_async_commit();

  // the terms of the lane's rows ly + 4 i, as the first kernel forms them
  RowTerms rt[4];
  float rz[4], rd[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + wrow + ly + 4 * i;
    if (row < Tq) {
      const size_t at = ((size_t)b * H + h) * Tq + row;
      rt[i] = row_terms(m_in[at], z_in[at], b_in[at], delta[at], renorm);
    } else {
      rt[i] = row_terms(0.f, 1.f, 1.f, 0.f, renorm);
    }
    rz[i] = 1.f / rt[i].z;
    rd[i] = 1.f / rt[i].D;
  }
  float dqa[4][DH / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < DH / 8; ++e) dqa[i][e] = 0.f;

  for (int step = step_lo; step < step_hi; ++step) {
    savqa::cp_async_wait<0>();
    __syncthreads();   // this step's tiles (and Q, dO) have landed; the other stage is free
    if (step + 1 < step_hi) load_step(step + 1);
    savqa::cp_async_commit();
    if (!active) continue;
    float* base = stages + ((step - step_lo) & 1) * kStageF;
    const float* Ks = base;
    const float* Vs = base + kStepK * DH;
    float* Gs = base + 2 * kStepK * DH;
    const float* kms = Gs + kBQ * kStepK;
    float s[4][kNC], dn[4][kNC];   // [row ly + 4 i][key lx + 8 c]
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < kNC; ++c) s[i][c] = dn[i][c] = 0.f;
    f32::tile_abt<DH, kNC>(s, Qs, wrow, Ks, dh, ly, lx);     // S = Q K^T
    f32::tile_abt<DH, kNC>(dn, dOs, wrow, Vs, dh, ly, lx);   // dN = dO V^T
#pragma unroll
    for (int c = 0; c < kNC; ++c) {
      const int j = lx + 8 * c;
      const bool masked = kms[j] == 0.f;   // 0 past Tk
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float n, ds;
        ds_entry_rcp(s[i][c], dn[i][c], Gs[f32::gswz<kStepK>(wrow + ly + 4 * i, j)], masked,
                     rt[i], rz[i], rd[i], scale, &n, &ds);
        s[i][c] = ds;
      }
    }
    __syncwarp();   // every lane has read its graph entries: the warp's rows take dS
    float* pt = Gs + wrow * kStepK;
    f32::store_t<kNC>(pt, s, ly, lx);
    __syncwarp();
    f32::tile_pv<DH, kStepK>(dqa, pt, Ks, ly, lx);   // dQ += dS K
  }
  savqa::cp_async_wait<0>();
  if (!active) return;
  float* out = n_split > 1 ? dq_part + (size_t)sp * gridDim.z * Tq * C : dq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + wrow + ly + 4 * i;
    if (row >= Tq) continue;
#pragma unroll
    for (int g = 0; g < DH / 32; ++g) {
      const int d = 4 * lx + 32 * g;
      if (d >= dh) continue;
      const float* a4 = dqa[i] + 4 * g;
      *reinterpret_cast<float4*>(out + ((size_t)b * Tq + row) * C + c0 + d) =
          make_float4(a4[0], a4[1], a4[2], a4[3]);
    }
  }
}

struct DqF32Args {
  const float *q, *k, *v, *key_mask, *graph, *m, *z, *b, *delta, *dout;
  float *dq, *scratch;
  int B, Tq, Tk, C, H, renorm, n_split, steps_per_split;
  float scale;
  cudaStream_t stream;
};

template <int DH, int WARPS>
cudaError_t launch_dq_f32_dh(const DqF32Args& p) {
  const size_t smem = sizeof(float) * dq_f32_smem_floats(DH, WARPS);
  auto kernel = flash_graph_attention_bwd_dq_f32_kernel<DH, WARPS>;
  // once a process, as K6's f32 kernel
  static const cudaError_t attributes = f32::allow_smem(kernel, smem);
  if (attributes != cudaSuccess) return attributes;
  const dim3 grid(p.H, (p.Tq + 16 * WARPS - 1) / (16 * WARPS) * p.n_split, p.B);
  started(kK56F32, DH);
  kernel<<<grid, 32 * WARPS, smem, p.stream>>>(p.q, p.k, p.v, p.key_mask, p.graph, p.m, p.z,
                                               p.b, p.delta, p.dout, p.dq, p.scratch, p.Tq, p.Tk,
                                               p.C, p.H, p.C / p.H, p.renorm, p.scale, p.n_split,
                                               p.steps_per_split);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.n_split == 1) return err;
  return launch_dq_sum<float>(p.scratch, p.dq, p.n_split, (size_t)p.B * p.Tq * p.C, p.stream);
}

// 16 query rows (one warp) a block when q_tile is 16, else 64 (four).
cudaError_t launch_dq_f32(const DqF32Args& p, int q_tile) {
  const int dh = p.C / p.H;
  if (q_tile == 16) {
    if (dh <= 32) return launch_dq_f32_dh<32, 1>(p);
    if (dh <= 64) return launch_dq_f32_dh<64, 1>(p);
    if (dh <= 128) return launch_dq_f32_dh<128, 1>(p);
    return launch_dq_f32_dh<256, 1>(p);
  }
  if (dh <= 32) return launch_dq_f32_dh<32, 4>(p);
  if (dh <= 64) return launch_dq_f32_dh<64, 4>(p);
  if (dh <= 128) return launch_dq_f32_dh<128, 4>(p);
  return launch_dq_f32_dh<256, 4>(p);
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
using savqa::product_abt;
using savqa::stage_head_tile;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTcThreads = 128;   // 4 warps, 16 rows (K5) or keys (K6) each
constexpr int kTile = 64;         // rows or keys of a block, keys or rows of a step
// Blocks an SM up to head width 64 (which caps a thread's registers at
// 65,536 / (128 blocks): 168 for three), and the query rows (K6) or keys
// (K5) of the sub-steps a warp walks a step in: only a sub-step's score
// fragments are live at a time.
constexpr int kDkvBlocks = 3;
constexpr int kDkvSub = kTile / 4;
constexpr int kDqBlocks = 3;
constexpr int kDqSub = kTile / 2;

// A query row's terms in the units the tensor-core kernels use: scores in
// units of log 2, 1 / D and c2 / z in place of the divisions. 32 bytes, so
// K6's table of them is read 16 bytes at a time.
struct __align__(16) TcRowTerms {
  float m2, fill2, inv_d, c1, c2_z, unused[3];
};

__device__ __forceinline__ TcRowTerms tc_row_terms(float m, float z, float b, float delta,
                                                   int renorm) {
  const RowTerms r = row_terms(m, z, b, delta, renorm);
  TcRowTerms t;
  t.m2 = m * kLog2e;
  t.fill2 = (kNegMask - m) * kLog2e;   // exactly 0 where every key is masked (m = fill)
  t.inv_d = 1.f / r.D;
  t.c1 = r.c1;
  t.c2_z = r.c2 / z;
  return t;
}

// One entry: the raw score and dN in, n and the scaled dS (0 on a masked key) out.
__device__ __forceinline__ void tc_entry(float raw, float dn, float g, bool keep,
                                         const TcRowTerms& t, float scale2, float scale,
                                         float& n, float& ds) {
  const float e = fast_exp2(keep ? fmaf(raw, scale2, -t.m2) : t.fill2);
  n = e * g * t.inv_d;
  ds = keep ? (n * (dn - t.c1) - e * t.c2_z) * scale : 0.f;
}

// The f32 (rows, 64 keys) graph tile of rows [r0, r0 + 64) and keys
// [j0, j0 + 64) into Gs (row stride LDG), zeros past Tq and past Tk;
// 16-byte copies when Tk is a multiple of 4 (then four adjacent entries are
// 16-byte aligned), else 4-byte ones.
template <int LDG, int THREADS = kTcThreads>
__device__ __forceinline__ void stage_graph_tile(float* Gs, const float* __restrict__ gb, int r0,
                                                 int j0, int Tq, int Tk, const float* any) {
  if ((Tk & 3) == 0) {
    for (int i = threadIdx.x; i < kTile * (kTile / 4); i += THREADS) {
      const int r = i / (kTile / 4), j = (i - r * (kTile / 4)) * 4;
      const bool valid = r0 + r < Tq && j0 + j < Tk;
      cp_async16(Gs + r * LDG + j, valid ? gb + (size_t)(r0 + r) * Tk + j0 + j : any, valid);
    }
  } else {
    for (int i = threadIdx.x; i < kTile * kTile; i += THREADS) {
      const int r = i / kTile, j = i - r * kTile;
      const bool valid = r0 + r < Tq && j0 + j < Tk;
      cp_async4(Gs + r * LDG + j, valid ? gb + (size_t)(r0 + r) * Tk + j0 + j : any, valid);
    }
  }
}

// Bytes of one stage of the rings.
template <int DH>
__host__ __device__ constexpr int dkv_stage_bytes() {   // Qc, dOc (64, DH + 8) bf16 | Gs (64, 68) | terms (64)
  return 2 * kTile * (DH + 8) * 2 + kTile * (kTile + 4) * 4 + kTile * sizeof(TcRowTerms);
}

template <int DH>
__host__ __device__ constexpr int dq_stage_bytes() {    // Ks, Vs (64, DH + 8) bf16 | Gs (64, 72) | key mask (64)
  return 2 * kTile * (DH + 8) * 2 + (kTile * (kTile + 8) + kTile) * 4;
}

// K6, one block per (head, 64 keys, batch). Shared memory: two stages of
// dkv_stage_bytes; K and V (64, DH + 8) bf16 land in the second stage's room
// first and are read into registers before its first copy.
template <int DH>
__global__ void __launch_bounds__(kTcThreads, DH <= 64 ? kDkvBlocks : 1)
flash_graph_attention_bwd_dkv_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ key_mask, const float* __restrict__ graph,
    const float* __restrict__ m_in, const float* __restrict__ z_in,
    const float* __restrict__ b_in, const float* __restrict__ delta,
    const bf16* __restrict__ dout, bf16* __restrict__ dk, bf16* __restrict__ dv, int Tq, int Tk,
    int C, int H, int dh, int renorm, float scale) {
  constexpr int kLd = DH + 8;
  constexpr int kKD = DH / 16;
  constexpr int kND = DH / 8;
  constexpr int kLdG = kTile + 4;   // (2t rows) x 68 = 8t banks apart: a column read hits 32 banks
  constexpr int kStage = dkv_stage_bytes<DH>();
  constexpr int kNSub = kDkvSub / 8;   // 8-wide accumulator blocks of a sub-step
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int h = blockIdx.x;
  const int j0 = blockIdx.y * kTile;
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
  const bool keep_a = key_a < Tk && key_mask[(size_t)b * Tk + key_a] != 0.f;
  const bool keep_b = key_b < Tk && key_mask[(size_t)b * Tk + key_b] != 0.f;
  const float scale2 = scale * kLog2e;
  const int n_steps = (Tq + kTile - 1) / kTile;

  const bf16* qb = q + (size_t)b * Tq * C;
  const bf16* dob = dout + (size_t)b * Tq * C;
  const float* gb = graph + (size_t)b * Tq * Tk;
  const size_t stat0 = ((size_t)b * H + h) * Tq;

  auto load_step = [&](int step) {
    unsigned char* base = smem_raw + (step & 1) * kStage;
    const int r0 = step * kTile;
    bf16* Qc = reinterpret_cast<bf16*>(base);
    stage_head_tile<DH, kTcThreads>(Qc, qb, r0, Tq, kTile, C, c0, dh);
    stage_head_tile<DH, kTcThreads>(Qc + kTile * kLd, dob, r0, Tq, kTile, C, c0, dh);
    stage_graph_tile<kLdG>(reinterpret_cast<float*>(Qc + 2 * kTile * kLd), gb, r0, j0, Tq, Tk,
                           graph);
  };
  auto terms_of = [&](int step) {
    return reinterpret_cast<TcRowTerms*>(smem_raw + (step & 1) * kStage + 2 * kTile * kLd * 2 +
                                         kTile * kLdG * 4);
  };
  // Thread r < 64 forms the terms of row r of a step: it loads the row's
  // statistics a step ahead and writes the terms into the step's stage
  // before the barrier that opens the step (rows past Tq get harmless ones).
  float row_m = 0.f, row_z = 1.f, row_b = 1.f, row_delta = 0.f;
  auto load_row_stats = [&](int step) {
    const int r = step * kTile + tid;
    if (tid < kTile && r < Tq) {
      row_m = m_in[stat0 + r];
      row_z = z_in[stat0 + r];
      row_b = b_in[stat0 + r];
      row_delta = delta[stat0 + r];
    } else {
      row_m = 0.f, row_z = 1.f, row_b = 1.f, row_delta = 0.f;
    }
  };
  auto store_terms = [&](int step) {
    if (tid < kTile) terms_of(step)[tid] = tc_row_terms(row_m, row_z, row_b, row_delta, renorm);
  };

  bf16* KVs = reinterpret_cast<bf16*>(smem_raw + kStage);
  stage_head_tile<DH, kTcThreads>(KVs, k + (size_t)b * Tk * C, j0, Tk, kTile, C, c0, dh);
  stage_head_tile<DH, kTcThreads>(KVs + kTile * kLd, v + (size_t)b * Tk * C, j0, Tk, kTile, C,
                                  c0, dh);
  load_step(0);
  cp_async_commit();
  load_row_stats(0);
  store_terms(0);
  cp_async_wait<0>();
  __syncthreads();   // K, V, the first step's tiles and its terms have landed
  uint32_t kf[kKD][4], vf[kKD][4];
  if (active) {
#pragma unroll
    for (int kd = 0; kd < kKD; ++kd) {
      ldmatrix_x4(kf[kd], frag_a_row(KVs, kLd, warp * 16, kd * 16, lane));
      ldmatrix_x4(vf[kd], frag_a_row(KVs + kTile * kLd, kLd, warp * 16, kd * 16, lane));
    }
  }

  float dka[kND][4], dva[kND][4];
#pragma unroll
  for (int i = 0; i < kND; ++i) {
    dka[i][0] = dka[i][1] = dka[i][2] = dka[i][3] = 0.f;
    dva[i][0] = dva[i][1] = dva[i][2] = dva[i][3] = 0.f;
  }

  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<0>();
    __syncthreads();   // this step's tiles and terms have landed; the readers of the other
                       // stage (the first time: of K and V) are done, and it takes the next
    const bool more = step + 1 < n_steps;
    if (more) load_step(step + 1);
    cp_async_commit();
    if (more) load_row_stats(step + 1);
    if (active) {
      const unsigned char* base = smem_raw + (step & 1) * kStage;
      const bf16* Qc = reinterpret_cast<const bf16*>(base);
      const bf16* dOc = Qc + kTile * kLd;
      // graph[row][key_a] at g_col[row * kLdG], graph[row][key_b] 8 floats on
      const float* g_col = reinterpret_cast<const float*>(dOc + kTile * kLd) + warp * 16 + g;
      const TcRowTerms* terms = terms_of(step);
      const int nr = Tq - step * kTile;           // real rows of this step (more than 64: all)

#pragma unroll
      for (int sub = 0; sub < kTile / kDkvSub; ++sub) {
        const int h0 = sub * kDkvSub;
        if (h0 >= nr) continue;
        const bf16* Qh = Qc + h0 * kLd;
        const bf16* dOh = dOc + h0 * kLd;
        float s[kNSub][4], dn[kNSub][4];
        product_abt<DH, kNSub>(s, kf, Qh, lane, nr - h0);     // S^T = K Q^T: 16 keys x 16 rows
        product_abt<DH, kNSub>(dn, vf, dOh, lane, nr - h0);   // dN^T = V dO^T
        // entries cc and cc + 2 of block nb: keys a and b at query row h0 + nb 8 + 2t + cc
#pragma unroll
        for (int nb = 0; nb < kNSub; ++nb) {
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int r = h0 + nb * 8 + 2 * t + cc;
            if (r >= nr) {   // no row: n = dS = 0
              s[nb][cc] = s[nb][cc + 2] = dn[nb][cc] = dn[nb][cc + 2] = 0.f;
              continue;
            }
            const TcRowTerms rt = terms[r];
            tc_entry(s[nb][cc], dn[nb][cc], g_col[r * kLdG], keep_a, rt, scale2, scale,
                     s[nb][cc], dn[nb][cc]);
            tc_entry(s[nb][cc + 2], dn[nb][cc + 2], g_col[r * kLdG + 8], keep_b, rt, scale2,
                     scale, s[nb][cc + 2], dn[nb][cc + 2]);
          }
        }
        accumulate_ab<DH, kNSub>(dva, s, dOh, lane, nr - h0);   // dV += n^T dO
        accumulate_ab<DH, kNSub>(dka, dn, Qh, lane, nr - h0);   // dK += dS^T Q
      }
    }
    if (more) store_terms(step + 1);
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

// K5, one block per (head, 64 query rows x key shard, batch). Shared memory:
// two stages of dq_stage_bytes; the Q and dO tiles (64, DH + 8) bf16 land in
// the second stage's room first and are read into registers before its
// first copy. With n_split > 1 block (h, qt * n_split + sp, b) walks the key
// steps [sp * steps_per_split, (sp + 1) * steps_per_split) and writes its
// f32 partial dQ at shard sp of dq_part (n_split, B, Tq, C).
template <int DH>
__global__ void __launch_bounds__(kTcThreads, DH <= 64 ? kDqBlocks : 1)
flash_graph_attention_bwd_dq_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ key_mask, const float* __restrict__ graph,
    const float* __restrict__ m_in, const float* __restrict__ z_in,
    const float* __restrict__ b_in, const float* __restrict__ delta,
    const bf16* __restrict__ dout, bf16* __restrict__ dq, float* __restrict__ dq_part, int Tq,
    int Tk, int C, int H, int dh, int renorm, float scale, int n_split, int steps_per_split) {
  constexpr int kLd = DH + 8;
  constexpr int kKD = DH / 16;
  constexpr int kND = DH / 8;
  constexpr int kLdG = kTile + 8;   // float2 reads along the keys hit 32 banks (as K4)
  constexpr int kStage = dq_stage_bytes<DH>();
  constexpr int kNSub = kDqSub / 8;   // 8-wide accumulator blocks of a sub-step
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int h = blockIdx.x;
  const int qt = blockIdx.y / n_split;
  const int sp = blockIdx.y - qt * n_split;
  const int b = blockIdx.z;
  const int q0 = qt * kTile;
  const int c0 = h * dh;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n_steps = (Tk + kTile - 1) / kTile;
  const int step_lo = sp * steps_per_split;
  const int step_hi = min(n_steps, step_lo + steps_per_split);
  const bool active = q0 + warp * 16 < Tq;
  const int row_a = q0 + warp * 16 + g;   // this lane's two query rows
  const int row_b = row_a + 8;
  const float scale2 = scale * kLog2e;

  const bf16* kb = k + (size_t)b * Tk * C;
  const bf16* vb = v + (size_t)b * Tk * C;
  const float* km = key_mask + (size_t)b * Tk;
  const float* gb = graph + (size_t)b * Tq * Tk;

  auto load_step = [&](int step) {
    unsigned char* base = smem_raw + ((step - step_lo) & 1) * kStage;
    const int j0 = step * kTile;
    bf16* Ks = reinterpret_cast<bf16*>(base);
    stage_head_tile<DH, kTcThreads>(Ks, kb, j0, Tk, kTile, C, c0, dh);
    stage_head_tile<DH, kTcThreads>(Ks + kTile * kLd, vb, j0, Tk, kTile, C, c0, dh);
    float* Gs = reinterpret_cast<float*>(Ks + 2 * kTile * kLd);
    stage_graph_tile<kLdG>(Gs, gb, q0, j0, Tq, Tk, graph);
    float* kms = Gs + kTile * kLdG;
    for (int j = tid; j < kTile; j += kTcThreads)
      cp_async4(kms + j, km + (j0 + j < Tk ? j0 + j : 0), j0 + j < Tk);
  };

  bf16* QDs = reinterpret_cast<bf16*>(smem_raw + kStage);
  stage_head_tile<DH, kTcThreads>(QDs, q + (size_t)b * Tq * C, q0, Tq, kTile, C, c0, dh);
  stage_head_tile<DH, kTcThreads>(QDs + kTile * kLd, dout + (size_t)b * Tq * C, q0, Tq, kTile,
                                  C, c0, dh);
  if (step_lo < step_hi) load_step(step_lo);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();   // Q, dO and the first step's tiles have landed
  uint32_t qf[kKD][4], df[kKD][4];
  if (active) {
#pragma unroll
    for (int kd = 0; kd < kKD; ++kd) {
      ldmatrix_x4(qf[kd], frag_a_row(QDs, kLd, warp * 16, kd * 16, lane));
      ldmatrix_x4(df[kd], frag_a_row(QDs + kTile * kLd, kLd, warp * 16, kd * 16, lane));
    }
  }
  TcRowTerms rt[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half == 0 ? row_a : row_b;
    const size_t at = ((size_t)b * H + h) * Tq + (row < Tq ? row : 0);
    rt[half] = tc_row_terms(m_in[at], z_in[at], b_in[at], delta[at], renorm);
  }

  float acc[kND][4];
#pragma unroll
  for (int i = 0; i < kND; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int step = step_lo; step < step_hi; ++step) {
    cp_async_wait<0>();
    __syncthreads();   // this step's tiles have landed; the readers of the other stage (the
                       // first time: of Q and dO) are done, and it takes the next copies
    if (step + 1 < step_hi) load_step(step + 1);
    cp_async_commit();
    if (!active) continue;
    const unsigned char* base = smem_raw + ((step - step_lo) & 1) * kStage;
    const bf16* Ks = reinterpret_cast<const bf16*>(base);
    const bf16* Vs = Ks + kTile * kLd;
    const float* Gs = reinterpret_cast<const float*>(Vs + kTile * kLd);
    const float* kmask = Gs + kTile * kLdG;
    const float* g_a = Gs + (warp * 16 + g) * kLdG;   // this lane's two graph rows
    const float* g_b = g_a + 8 * kLdG;

#pragma unroll
    for (int sub = 0; sub < kTile / kDqSub; ++sub) {
      const int k0 = sub * kDqSub;
      const bf16* Kh = Ks + k0 * kLd;
      float s[kNSub][4], dn[kNSub][4];
      product_abt<DH, kNSub>(s, qf, Kh, lane, kDqSub);                // S = Q K^T: 16 rows a warp
      product_abt<DH, kNSub>(dn, df, Vs + k0 * kLd, lane, kDqSub);   // dN = dO V^T
      // entries 0, 1 (row a) and 2, 3 (row b) of block nb: keys k0 + nb 8 + 2t, + 1
#pragma unroll
      for (int nb = 0; nb < kNSub; ++nb) {
        const int jl = k0 + nb * 8 + 2 * t;
        const float2 kmv = *reinterpret_cast<const float2*>(kmask + jl);
        const float2 ga = *reinterpret_cast<const float2*>(g_a + jl);
        const float2 gbv = *reinterpret_cast<const float2*>(g_b + jl);
        const float gr[4] = {ga.x, ga.y, gbv.x, gbv.y};
        const bool keep[2] = {kmv.x != 0.f, kmv.y != 0.f};   // 0 past Tk
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float n;
          tc_entry(s[nb][c], dn[nb][c], gr[c], keep[c & 1], rt[c >> 1], scale2, scale, n,
                   s[nb][c]);
        }
      }
      accumulate_ab<DH, kNSub>(acc, s, Kh, lane, kDqSub);   // dQ += dS K
    }
  }
  cp_async_wait<0>();
  if (!active) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half == 0 ? row_a : row_b;
    if (row >= Tq) continue;
#pragma unroll
    for (int i = 0; i < kND; ++i) {
      const int d = i * 8 + 2 * t;
      if (d >= dh) continue;
      const float x = acc[i][2 * half], y = acc[i][2 * half + 1];
      const size_t at = ((size_t)b * Tq + row) * C + c0 + d;
      if (n_split > 1)
        *reinterpret_cast<float2*>(dq_part + (size_t)sp * gridDim.z * Tq * C + at) =
            make_float2(x, y);
      else
        *reinterpret_cast<__nv_bfloat162*>(dq + at) = __floats2bfloat162_rn(x, y);
    }
  }
}

// ---- instance 256 of the tensor-core kernels: pairs of warps ----
//
// At head widths 144-256 (zero-padded to 256) a warp's 16 x 256 f32
// accumulators take 128 registers a thread: K6's dK and dV together (256)
// and K5's dQ beside Q's and dO's fragments (128 + 128) do not fit the 255
// a thread may hold. So a block runs 8 warps in 4 pairs, each pair owning
// the 16 keys (K6) or 16 query rows (K5) one warp owns below 256, and the
// two warps of a pair split the work, each holding one A operand's
// fragments (64 registers) and 128 (K6) or 64 (K5) accumulators:
// * K6: warp p (role 0) holds K's fragments, forms S^T = K Q^T, e and n,
//   passes e to warp p + 4 through shared memory and adds n^T dO into dV;
//   warp p + 4 (role 1) holds V's fragments, forms dN^T = V dO^T, takes e,
//   forms n (the same product e g / D) and dS, and adds dS^T Q into dK.
//   Each warp does two of the four products of a sub-step, and the n and dS
//   of an entry are tc_entry's: the same bits as the kernel above would
//   give. 64 query rows a step (two stages: 174 KB) and 16 a sub-step.
// * K5: warp p holds Q's fragments and forms S = Q K^T, warp p + 4 holds
//   dO's and forms dN = dO V^T; each passes its product to the other, both
//   form dS (tc_entry on the same values: the same dS), and warp p adds dS
//   K into dQ's channels 0-127, warp p + 4 into 128-255. 64 keys a step, 32
//   a sub-step, the key split as above.
// The pass goes through a double-buffered room of shared memory beside the
// two stages, with one 64-thread barrier of the pair a sub-step (pair_sync);
// a warp writes buffer i & 1 of sub-step i only after the barrier of
// sub-step i - 1, which its partner reaches after reading sub-step i - 2's.
// No atomics: every run gives the same bits. One block (8 warps) an SM.
constexpr int kPairThreads = 2 * kTcThreads;

template <int DH>
__host__ __device__ constexpr int dkv_pair_smem_bytes() {   // two stages | e: 2 x 4 pairs x 32 x 8 f32
  return 2 * dkv_stage_bytes<DH>() + 2 * 4 * 32 * 8 * 4;
}

template <int DH>
__host__ __device__ constexpr int dq_pair_smem_bytes() {    // two stages | S, dN: 2 x 8 warps x 32 x 16 f32
  return 2 * dq_stage_bytes<DH>() + 2 * 8 * 32 * 16 * 4;
}

// out (16 x W a warp) += W B over B's channels [col0, col0 + W): as
// accumulate_ab (B's fragments two 8-wide blocks at a time), for a warp
// that owns W of the DH output channels.
template <int DH, int NB, int W>
__device__ __forceinline__ void accumulate_ab_cols(float (&out)[W / 8][4], const float (&w)[NB][4],
                                                   const bf16* tile, int col0, int lane,
                                                   int n_real) {
#pragma unroll
  for (int kk = 0; kk < NB / 2; ++kk) {
    if (kk * 16 >= n_real) continue;
    uint32_t wf[4];
    wf[0] = savqa::pack_bf16(w[2 * kk][0], w[2 * kk][1]);
    wf[1] = savqa::pack_bf16(w[2 * kk][2], w[2 * kk][3]);
    wf[2] = savqa::pack_bf16(w[2 * kk + 1][0], w[2 * kk + 1][1]);
    wf[3] = savqa::pack_bf16(w[2 * kk + 1][2], w[2 * kk + 1][3]);
#pragma unroll
    for (int nd = 0; nd < W / 8; nd += 2) {
      uint32_t bfr[4];
      savqa::ldmatrix_x4_trans(bfr, savqa::frag_bt_row(tile, DH + 8, kk * 16, col0 + nd * 8, lane));
      savqa::mma_bf16(out[nd], wf, bfr[0], bfr[1]);
      savqa::mma_bf16(out[nd + 1], wf, bfr[2], bfr[3]);
    }
  }
}

// K6 at instance 256, one block of 8 warps per (head, 64 keys, batch).
template <int DH>
__global__ void __launch_bounds__(kPairThreads, 1)
flash_graph_attention_bwd_dkv_tc_pair_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ key_mask, const float* __restrict__ graph,
    const float* __restrict__ m_in, const float* __restrict__ z_in,
    const float* __restrict__ b_in, const float* __restrict__ delta,
    const bf16* __restrict__ dout, bf16* __restrict__ dk, bf16* __restrict__ dv, int Tq, int Tk,
    int C, int H, int dh, int renorm, float scale) {
  constexpr int kLd = DH + 8;
  constexpr int kKD = DH / 16;
  constexpr int kND = DH / 8;
  constexpr int kLdG = kTile + 4;
  constexpr int kStage = dkv_stage_bytes<DH>();
  constexpr int kNSub = kDkvSub / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int h = blockIdx.x;
  const int j0 = blockIdx.y * kTile;
  const int b = blockIdx.z;
  const int c0 = h * dh;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int pair = warp & 3;    // keys pair 16 .. pair 16 + 15 of the block
  const int role = warp >> 2;   // 0: S^T, e, n and dV; 1: dN^T, dS and dK
  const int g = lane >> 2;
  const int t = lane & 3;
  const int key_a = j0 + pair * 16 + g;
  const int key_b = key_a + 8;
  const bool active = j0 + pair * 16 < Tk;
  const bool keep_a = key_a < Tk && key_mask[(size_t)b * Tk + key_a] != 0.f;
  const bool keep_b = key_b < Tk && key_mask[(size_t)b * Tk + key_b] != 0.f;
  const float scale2 = scale * kLog2e;
  const int n_steps = (Tq + kTile - 1) / kTile;

  const bf16* qb = q + (size_t)b * Tq * C;
  const bf16* dob = dout + (size_t)b * Tq * C;
  const float* gb = graph + (size_t)b * Tq * Tk;
  const size_t stat0 = ((size_t)b * H + h) * Tq;

  auto load_step = [&](int step) {
    unsigned char* base = smem_raw + (step & 1) * kStage;
    const int r0 = step * kTile;
    bf16* Qc = reinterpret_cast<bf16*>(base);
    stage_head_tile<DH, kPairThreads>(Qc, qb, r0, Tq, kTile, C, c0, dh);
    stage_head_tile<DH, kPairThreads>(Qc + kTile * kLd, dob, r0, Tq, kTile, C, c0, dh);
    stage_graph_tile<kLdG, kPairThreads>(reinterpret_cast<float*>(Qc + 2 * kTile * kLd), gb, r0,
                                         j0, Tq, Tk, graph);
  };
  auto terms_of = [&](int step) {
    return reinterpret_cast<TcRowTerms*>(smem_raw + (step & 1) * kStage + 2 * kTile * kLd * 2 +
                                         kTile * kLdG * 4);
  };
  float row_m = 0.f, row_z = 1.f, row_b = 1.f, row_delta = 0.f;
  auto load_row_stats = [&](int step) {
    const int r = step * kTile + tid;
    if (tid < kTile && r < Tq) {
      row_m = m_in[stat0 + r];
      row_z = z_in[stat0 + r];
      row_b = b_in[stat0 + r];
      row_delta = delta[stat0 + r];
    } else {
      row_m = 0.f, row_z = 1.f, row_b = 1.f, row_delta = 0.f;
    }
  };
  auto store_terms = [&](int step) {
    if (tid < kTile) terms_of(step)[tid] = tc_row_terms(row_m, row_z, row_b, row_delta, renorm);
  };

  bf16* KVs = reinterpret_cast<bf16*>(smem_raw + kStage);
  stage_head_tile<DH, kPairThreads>(KVs, k + (size_t)b * Tk * C, j0, Tk, kTile, C, c0, dh);
  stage_head_tile<DH, kPairThreads>(KVs + kTile * kLd, v + (size_t)b * Tk * C, j0, Tk, kTile, C,
                                    c0, dh);
  load_step(0);
  cp_async_commit();
  load_row_stats(0);
  store_terms(0);
  cp_async_wait<0>();
  __syncthreads();   // K, V, the first step's tiles and its terms have landed
  uint32_t af[kKD][4];   // K's (role 0) or V's (role 1) 16 keys
  if (active) {
#pragma unroll
    for (int kd = 0; kd < kKD; ++kd)
      ldmatrix_x4(af[kd], frag_a_row(KVs + role * kTile * kLd, kLd, pair * 16, kd * 16, lane));
  }
  float acc[kND][4];   // dV (role 0) or dK (role 1)
#pragma unroll
  for (int i = 0; i < kND; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float* xroom = reinterpret_cast<float*>(smem_raw + 2 * kStage);
  int xsub = 0;   // sub-steps passed: the exchange buffer is xsub & 1

  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<0>();
    __syncthreads();   // this step's tiles and terms have landed; the other stage is free
    const bool more = step + 1 < n_steps;
    if (more) load_step(step + 1);
    cp_async_commit();
    if (more) load_row_stats(step + 1);
    if (active) {
      const unsigned char* base = smem_raw + (step & 1) * kStage;
      const bf16* Qc = reinterpret_cast<const bf16*>(base);
      const bf16* dOc = Qc + kTile * kLd;
      const float* g_col = reinterpret_cast<const float*>(dOc + kTile * kLd) + pair * 16 + g;
      const TcRowTerms* terms = terms_of(step);
      const int nr = Tq - step * kTile;
#pragma unroll
      for (int sub = 0; sub < kTile / kDkvSub; ++sub) {
        const int h0 = sub * kDkvSub;
        if (h0 >= nr) continue;   // both warps of a pair alike
        const bf16* Qh = Qc + h0 * kLd;
        const bf16* dOh = dOc + h0 * kLd;
        float x[kNSub][4];
        product_abt<DH, kNSub>(x, af, role ? dOh : Qh, lane, nr - h0);
        float* xp = xroom + ((xsub & 1) * 4 + pair) * 32 * 8 + lane * 4;
        ++xsub;
        if (role == 0) {
          float ev[kNSub][4];
#pragma unroll
          for (int nb = 0; nb < kNSub; ++nb) {
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
              const int r = h0 + nb * 8 + 2 * t + cc;
              if (r >= nr) {
                x[nb][cc] = x[nb][cc + 2] = ev[nb][cc] = ev[nb][cc + 2] = 0.f;
                continue;
              }
              const TcRowTerms rt = terms[r];
              ev[nb][cc] = fast_exp2(keep_a ? fmaf(x[nb][cc], scale2, -rt.m2) : rt.fill2);
              ev[nb][cc + 2] = fast_exp2(keep_b ? fmaf(x[nb][cc + 2], scale2, -rt.m2) : rt.fill2);
              x[nb][cc] = ev[nb][cc] * g_col[r * kLdG] * rt.inv_d;
              x[nb][cc + 2] = ev[nb][cc + 2] * g_col[r * kLdG + 8] * rt.inv_d;
            }
          }
#pragma unroll
          for (int nb = 0; nb < kNSub; ++nb)
            *reinterpret_cast<float4*>(xp + nb * 32 * 4) =
                make_float4(ev[nb][0], ev[nb][1], ev[nb][2], ev[nb][3]);
        }
        pair_sync(pair);
        if (role == 1) {
#pragma unroll
          for (int nb = 0; nb < kNSub; ++nb) {
            const float4 e4 = *reinterpret_cast<const float4*>(xp + nb * 32 * 4);
            const float ev[4] = {e4.x, e4.y, e4.z, e4.w};
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
              const int r = h0 + nb * 8 + 2 * t + cc;
              if (r >= nr) {
                x[nb][cc] = x[nb][cc + 2] = 0.f;
                continue;
              }
              const TcRowTerms rt = terms[r];
              const float n_a = ev[cc] * g_col[r * kLdG] * rt.inv_d;
              const float n_b = ev[cc + 2] * g_col[r * kLdG + 8] * rt.inv_d;
              x[nb][cc] = keep_a ? (n_a * (x[nb][cc] - rt.c1) - ev[cc] * rt.c2_z) * scale : 0.f;
              x[nb][cc + 2] =
                  keep_b ? (n_b * (x[nb][cc + 2] - rt.c1) - ev[cc + 2] * rt.c2_z) * scale : 0.f;
            }
          }
        }
        accumulate_ab<DH, kNSub>(acc, x, role ? Qh : dOh, lane, nr - h0);   // dV += n^T dO, dK += dS^T Q
      }
    }
    if (more) store_terms(step + 1);
  }
  cp_async_wait<0>();
  if (!active) return;
  bf16* out = role ? dk : dv;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = half == 0 ? key_a : key_b;
    if (key >= Tk) continue;
#pragma unroll
    for (int i = 0; i < kND; ++i) {
      const int d = i * 8 + 2 * t;
      if (d >= dh) continue;
      *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)b * Tk + key) * C + c0 + d) =
          __floats2bfloat162_rn(acc[i][2 * half], acc[i][2 * half + 1]);
    }
  }
}

// K5 at instance 256, one block of 8 warps per (head, 64 query rows x key
// shard, batch); the split and the partials as the kernel above.
template <int DH>
__global__ void __launch_bounds__(kPairThreads, 1)
flash_graph_attention_bwd_dq_tc_pair_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ key_mask, const float* __restrict__ graph,
    const float* __restrict__ m_in, const float* __restrict__ z_in,
    const float* __restrict__ b_in, const float* __restrict__ delta,
    const bf16* __restrict__ dout, bf16* __restrict__ dq, float* __restrict__ dq_part, int Tq,
    int Tk, int C, int H, int dh, int renorm, float scale, int n_split, int steps_per_split) {
  constexpr int kLd = DH + 8;
  constexpr int kKD = DH / 16;
  constexpr int kHalf = DH / 2;   // dQ's channels a warp
  constexpr int kLdG = kTile + 8;
  constexpr int kStage = dq_stage_bytes<DH>();
  constexpr int kNSub = kDqSub / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int h = blockIdx.x;
  const int qt = blockIdx.y / n_split;
  const int sp = blockIdx.y - qt * n_split;
  const int b = blockIdx.z;
  const int q0 = qt * kTile;
  const int c0 = h * dh;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int pair = warp & 3;    // query rows pair 16 .. pair 16 + 15 of the block
  const int role = warp >> 2;   // 0: S and dQ's first half, 1: dN and its second
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n_steps = (Tk + kTile - 1) / kTile;
  const int step_lo = sp * steps_per_split;
  const int step_hi = min(n_steps, step_lo + steps_per_split);
  const bool active = q0 + pair * 16 < Tq;
  const int row_a = q0 + pair * 16 + g;
  const int row_b = row_a + 8;
  const float scale2 = scale * kLog2e;

  const bf16* kb = k + (size_t)b * Tk * C;
  const bf16* vb = v + (size_t)b * Tk * C;
  const float* km = key_mask + (size_t)b * Tk;
  const float* gb = graph + (size_t)b * Tq * Tk;

  auto load_step = [&](int step) {
    unsigned char* base = smem_raw + ((step - step_lo) & 1) * kStage;
    const int j0 = step * kTile;
    bf16* Ks = reinterpret_cast<bf16*>(base);
    stage_head_tile<DH, kPairThreads>(Ks, kb, j0, Tk, kTile, C, c0, dh);
    stage_head_tile<DH, kPairThreads>(Ks + kTile * kLd, vb, j0, Tk, kTile, C, c0, dh);
    float* Gs = reinterpret_cast<float*>(Ks + 2 * kTile * kLd);
    stage_graph_tile<kLdG, kPairThreads>(Gs, gb, q0, j0, Tq, Tk, graph);
    float* kms = Gs + kTile * kLdG;
    for (int j = tid; j < kTile; j += kPairThreads)
      cp_async4(kms + j, km + (j0 + j < Tk ? j0 + j : 0), j0 + j < Tk);
  };

  bf16* QDs = reinterpret_cast<bf16*>(smem_raw + kStage);
  stage_head_tile<DH, kPairThreads>(QDs, q + (size_t)b * Tq * C, q0, Tq, kTile, C, c0, dh);
  stage_head_tile<DH, kPairThreads>(QDs + kTile * kLd, dout + (size_t)b * Tq * C, q0, Tq, kTile,
                                    C, c0, dh);
  if (step_lo < step_hi) load_step(step_lo);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();   // Q, dO and the first step's tiles have landed
  uint32_t af[kKD][4];   // Q's (role 0) or dO's (role 1) 16 rows
  if (active) {
#pragma unroll
    for (int kd = 0; kd < kKD; ++kd)
      ldmatrix_x4(af[kd], frag_a_row(QDs + role * kTile * kLd, kLd, pair * 16, kd * 16, lane));
  }
  TcRowTerms rt[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half == 0 ? row_a : row_b;
    const size_t at = ((size_t)b * H + h) * Tq + (row < Tq ? row : 0);
    rt[half] = tc_row_terms(m_in[at], z_in[at], b_in[at], delta[at], renorm);
  }
  float acc[kHalf / 8][4];
#pragma unroll
  for (int i = 0; i < kHalf / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float* xroom = reinterpret_cast<float*>(smem_raw + 2 * kStage);
  int xsub = 0;

  for (int step = step_lo; step < step_hi; ++step) {
    cp_async_wait<0>();
    __syncthreads();   // this step's tiles have landed; the other stage is free
    if (step + 1 < step_hi) load_step(step + 1);
    cp_async_commit();
    if (!active) continue;
    const unsigned char* base = smem_raw + ((step - step_lo) & 1) * kStage;
    const bf16* Ks = reinterpret_cast<const bf16*>(base);
    const bf16* Vs = Ks + kTile * kLd;
    const float* Gs = reinterpret_cast<const float*>(Vs + kTile * kLd);
    const float* kmask = Gs + kTile * kLdG;
    const float* g_a = Gs + (pair * 16 + g) * kLdG;
    const float* g_b = g_a + 8 * kLdG;
#pragma unroll
    for (int sub = 0; sub < kTile / kDqSub; ++sub) {
      const int k0 = sub * kDqSub;
      float x[kNSub][4], y[kNSub][4];   // this warp's product (S or dN), its partner's
      product_abt<DH, kNSub>(x, af, (role ? Vs : Ks) + k0 * kLd, lane, kDqSub);
      float* room = xroom + (xsub & 1) * 8 * 32 * 16;
      ++xsub;
      float* mine = room + warp * 32 * 16 + lane * 4;
      const float* theirs = room + (warp ^ 4) * 32 * 16 + lane * 4;
#pragma unroll
      for (int nb = 0; nb < kNSub; ++nb)
        *reinterpret_cast<float4*>(mine + nb * 32 * 4) =
            make_float4(x[nb][0], x[nb][1], x[nb][2], x[nb][3]);
      pair_sync(pair);
#pragma unroll
      for (int nb = 0; nb < kNSub; ++nb) {
        const float4 y4 = *reinterpret_cast<const float4*>(theirs + nb * 32 * 4);
        y[nb][0] = y4.x, y[nb][1] = y4.y, y[nb][2] = y4.z, y[nb][3] = y4.w;
      }
#pragma unroll
      for (int nb = 0; nb < kNSub; ++nb) {
        const int jl = k0 + nb * 8 + 2 * t;
        const float2 kmv = *reinterpret_cast<const float2*>(kmask + jl);
        const float2 ga = *reinterpret_cast<const float2*>(g_a + jl);
        const float2 gbv = *reinterpret_cast<const float2*>(g_b + jl);
        const float gr[4] = {ga.x, ga.y, gbv.x, gbv.y};
        const bool keep[2] = {kmv.x != 0.f, kmv.y != 0.f};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float n;
          const float sv = role ? y[nb][c] : x[nb][c], dnv = role ? x[nb][c] : y[nb][c];
          tc_entry(sv, dnv, gr[c], keep[c & 1], rt[c >> 1], scale2, scale, n, x[nb][c]);
        }
      }
      accumulate_ab_cols<DH, kNSub, kHalf>(acc, x, Ks + k0 * kLd, role * kHalf, lane,
                                           kDqSub);   // dQ += dS K, this warp's channels
    }
  }
  cp_async_wait<0>();
  if (!active) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half == 0 ? row_a : row_b;
    if (row >= Tq) continue;
#pragma unroll
    for (int i = 0; i < kHalf / 8; ++i) {
      const int d = role * kHalf + i * 8 + 2 * t;
      if (d >= dh) continue;
      const float x = acc[i][2 * half], y = acc[i][2 * half + 1];
      const size_t at = ((size_t)b * Tq + row) * C + c0 + d;
      if (n_split > 1)
        *reinterpret_cast<float2*>(dq_part + (size_t)sp * gridDim.z * Tq * C + at) =
            make_float2(x, y);
      else
        *reinterpret_cast<__nv_bfloat162*>(dq + at) = __floats2bfloat162_rn(x, y);
    }
  }
}

struct TcArgs {
  const bf16 *q, *k, *v, *dout;
  const float *key_mask, *graph, *m, *z, *b, *delta;
  bf16 *dq, *dk, *dv;
  float* scratch;
  int B, Tq, Tk, C, H, renorm, n_split, steps_per_split;
  float scale;
  cudaStream_t stream;
};

template <int DH>
cudaError_t launch_dkv_tc(const TcArgs& p) {
  const int smem = 2 * dkv_stage_bytes<DH>();
  auto kernel = flash_graph_attention_bwd_dkv_tc_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, (p.Tk + kTile - 1) / kTile, p.B);
  started(kK56Tc, DH);
  kernel<<<grid, kTcThreads, smem, p.stream>>>(p.q, p.k, p.v, p.key_mask, p.graph, p.m, p.z, p.b,
                                               p.delta, p.dout, p.dk, p.dv, p.Tq, p.Tk, p.C, p.H,
                                               p.C / p.H, p.renorm, p.scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dq_tc(const TcArgs& p) {
  const int smem = 2 * dq_stage_bytes<DH>();
  auto kernel = flash_graph_attention_bwd_dq_tc_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, (p.Tq + kTile - 1) / kTile * p.n_split, p.B);
  started(kK56Tc, DH);
  kernel<<<grid, kTcThreads, smem, p.stream>>>(p.q, p.k, p.v, p.key_mask, p.graph, p.m, p.z, p.b,
                                               p.delta, p.dout, p.dq, p.scratch, p.Tq, p.Tk, p.C,
                                               p.H, p.C / p.H, p.renorm, p.scale, p.n_split,
                                               p.steps_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.n_split == 1) return err;
  return launch_dq_sum<bf16>(p.scratch, p.dq, p.n_split, (size_t)p.B * p.Tq * p.C, p.stream);
}

template <int DH>
cudaError_t launch_dkv_tc_pair(const TcArgs& p) {
  const int smem = dkv_pair_smem_bytes<DH>();
  auto kernel = flash_graph_attention_bwd_dkv_tc_pair_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, (p.Tk + kTile - 1) / kTile, p.B);
  started(kK56Tc, DH);
  kernel<<<grid, kPairThreads, smem, p.stream>>>(p.q, p.k, p.v, p.key_mask, p.graph, p.m, p.z,
                                                 p.b, p.delta, p.dout, p.dk, p.dv, p.Tq, p.Tk,
                                                 p.C, p.H, p.C / p.H, p.renorm, p.scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dq_tc_pair(const TcArgs& p) {
  const int smem = dq_pair_smem_bytes<DH>();
  auto kernel = flash_graph_attention_bwd_dq_tc_pair_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, (p.Tq + kTile - 1) / kTile * p.n_split, p.B);
  started(kK56Tc, DH);
  kernel<<<grid, kPairThreads, smem, p.stream>>>(p.q, p.k, p.v, p.key_mask, p.graph, p.m, p.z,
                                                 p.b, p.delta, p.dout, p.dq, p.scratch, p.Tq,
                                                 p.Tk, p.C, p.H, p.C / p.H, p.renorm, p.scale,
                                                 p.n_split, p.steps_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.n_split == 1) return err;
  return launch_dq_sum<bf16>(p.scratch, p.dq, p.n_split, (size_t)p.B * p.Tq * p.C, p.stream);
}

cudaError_t launch_dkv_tc_dh(const TcArgs& p) {
  const int dh = p.C / p.H;
  if (dh <= 16) return launch_dkv_tc<16>(p);
  if (dh <= 32) return launch_dkv_tc<32>(p);
  if (dh <= 64) return launch_dkv_tc<64>(p);
  if (dh <= 128) return launch_dkv_tc<128>(p);
  return launch_dkv_tc_pair<256>(p);
}

cudaError_t launch_dq_tc_dh(const TcArgs& p) {
  const int dh = p.C / p.H;
  if (dh <= 16) return launch_dq_tc<16>(p);
  if (dh <= 32) return launch_dq_tc<32>(p);
  if (dh <= 64) return launch_dq_tc<64>(p);
  if (dh <= 128) return launch_dq_tc<128>(p);
  return launch_dq_tc_pair<256>(p);
}

bool bad_shape(int B, int Tq, int Tk, int C, int H, int renorm) {
  return B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || C % H != 0 || (renorm != 0 && renorm != 1);
}

// The kernels of a call: the tensor-core ones (bf16, a head width that is a
// multiple of 16 up to 256; the pair kernels above 128), the f32 ones (f32,
// a multiple of 4 up to 256; K6's pair kernel above 128), else the first
// SIMT kernels (the wide ones above 256).
bool tensor_cores(int dtype, int C, int H) {
  return dtype == 1 && (C / H) % 16 == 0 && C / H <= kTcMaxDh;
}
bool f32_kernels(int dtype, int C, int H) {
  return dtype == 0 && (C / H) % 4 == 0 && C / H <= kTcMaxDh;
}

// Whether K5's `path` cannot take this call (see savqa_flash_graph_attention_bwd_dq).
bool bad_dq_path(int dtype, int Tk, int C, int H, int path, int q_tile, int n_split,
                 int steps_per_split, const void* scratch) {
  if (path == 0 || path == 3) return n_split != 1 || (dtype != 0 && dtype != 1) ||
                                     (path == 3) != (C / H > kMaxDh);
  if (path == 1 && !tensor_cores(dtype, C, H)) return true;
  if (path == 2 && (!f32_kernels(dtype, C, H) || (q_tile != 16 && q_tile != 64))) return true;
  if (path != 1 && path != 2) return true;
  const int step = path == 1 ? kTile : dq_f32_step(C / H);
  const int n_steps = (Tk + step - 1) / step;
  return n_split < 1 || steps_per_split < 1 || (n_split - 1) * steps_per_split >= n_steps ||
         n_split * steps_per_split < n_steps || (n_split > 1 && scratch == nullptr);
}

// The kernel and instance this thread's last call of each entry launched
// (-1 before any): [0] K5's, [1] K6's.
thread_local int last_path[2] = {-1, -1};
thread_local int last_width[2] = {-1, -1};

// Keeps what the launcher noted (started) for a launch that succeeded; an
// entry clears the note before it calls its launcher.
int launched(int entry, cudaError_t err) {
  if (err == cudaSuccess && started_width >= 0) {
    last_path[entry] = started_path;
    last_width[entry] = started_width;
  }
  return (int)err;
}

}  // namespace

// The kernel that this thread's last call of savqa_flash_graph_attention_bwd_dq
// (entry 0) or _dkv (entry 1) launched, as its launcher noted it: 0 simt, 1
// wide, 2 tensor-core, 3 f32; -1 before any or for another entry. The
// wrappers count launches by it.
extern "C" int savqa_flash_graph_attention_bwd_last_path(int entry) {
  return entry == 0 || entry == 1 ? last_path[entry] : -1;
}

// The head-width instance of that launch: 16-256 (the first SIMT and the
// tiled kernels; 256 the pair kernels), 0 for the wide kernels; -1 before
// any or for another entry. The wrappers hold it to the shape's plan.
extern "C" int savqa_flash_graph_attention_bwd_last_width(int entry) {
  return entry == 0 || entry == 1 ? last_width[entry] : -1;
}

// dtype: 0 = float32, 1 = bfloat16. renorm: 0 = l1, 1 = sum_eps.
// q, dout, dq (B, Tq, C) and k, v, dk, dv (B, Tk, C) in that type; key_mask
// (B, Tk), graph (B, Tq, Tk), m, z, b, delta (B, H, Tq) f32. Each returns
// cudaGetLastError() after its launches.
//
// K5's path: 0 = the first SIMT kernel (either type, head widths up to 256,
// one shard); 3 = the wide kernel (either type, head widths above 256, one
// shard); 1 = the tensor-core kernel (bf16 with a head width that is a
// multiple of 16 up to 256); 2 = the f32 kernel (f32 with a head width that
// is a multiple of 4 up to 256, q_tile = 16 or 64 query rows a block). Paths 1 and 2
// split the key steps (64 keys each on path 1, 32 on path 2, 16 there above
// head width 128) into n_split
// shards of steps_per_split steps, none of them empty; with n_split > 1
// scratch (n_split, B, Tq, C) f32 holds the partials between their two
// launches. q_tile is read on path 2 only.
extern "C" int savqa_flash_graph_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* key_mask, const void* graph,
    const void* m_in, const void* z_in, const void* b_in, const void* delta, const void* dout,
    void* dq, void* scratch, int B, int Tq, int Tk, int C, int H, int renorm, int dtype,
    int path, int q_tile, int n_split, int steps_per_split, float scale, void* stream) {
  if (bad_shape(B, Tq, Tk, C, H, renorm) ||
      bad_dq_path(dtype, Tk, C, H, path, q_tile, n_split, steps_per_split, scratch))
    return (int)cudaErrorInvalidValue;
  started(kK56Simt, -1);
  const auto* km = static_cast<const float*>(key_mask);
  const auto* g = static_cast<const float*>(graph);
  const auto* mi = static_cast<const float*>(m_in);
  const auto* zi = static_cast<const float*>(z_in);
  const auto* bi = static_cast<const float*>(b_in);
  const auto* de = static_cast<const float*>(delta);
  auto s = static_cast<cudaStream_t>(stream);
  if (path == 1) {
    const TcArgs p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                   static_cast<const bf16*>(v), static_cast<const bf16*>(dout), km, g, mi, zi,
                   bi, de, static_cast<bf16*>(dq), nullptr, nullptr,
                   static_cast<float*>(scratch), B, Tq, Tk, C, H, renorm, n_split,
                   steps_per_split, scale, s};
    return launched(0, launch_dq_tc_dh(p));
  }
  if (path == 2) {
    const DqF32Args p{static_cast<const float*>(q), static_cast<const float*>(k),
                      static_cast<const float*>(v), km, g, mi, zi, bi, de,
                      static_cast<const float*>(dout), static_cast<float*>(dq),
                      static_cast<float*>(scratch), B, Tq, Tk, C, H, renorm, n_split,
                      steps_per_split, scale, s};
    return launched(0, launch_dq_f32(p, q_tile));
  }
  if (path == 3) {
    if (dtype == 0)
      return launched(0, launch_dq_wide<float>(q, k, v, km, g, mi, zi, bi, de, dout, dq, B, Tq,
                                               Tk, C, H, renorm, scale, s));
    return launched(0, launch_dq_wide<__nv_bfloat16>(q, k, v, km, g, mi, zi, bi, de, dout, dq, B,
                                                     Tq, Tk, C, H, renorm, scale, s));
  }
  if (dtype == 0)
    return launched(0, launch_dq<float>(C / H, q, k, v, km, g, mi, zi, bi, de, dout, dq, B, Tq,
                                        Tk, C, H, renorm, scale, s));
  return launched(0, launch_dq<__nv_bfloat16>(C / H, q, k, v, km, g, mi, zi, bi, de, dout, dq, B,
                                              Tq, Tk, C, H, renorm, scale, s));
}

// K6: bf16 with a head width that is a multiple of 16 up to 256 takes the
// tensor-core kernel (the pair kernel above 128), f32 with a multiple of 4
// up to 256 its register-tiled kernel (the pair kernel above 128), head
// widths above 256 the wide kernel, every other call the SIMT kernel.
extern "C" int savqa_flash_graph_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* key_mask, const void* graph,
    const void* m_in, const void* z_in, const void* b_in, const void* delta, const void* dout,
    void* dk, void* dv, int B, int Tq, int Tk, int C, int H, int renorm, int dtype, float scale,
    void* stream) {
  if (bad_shape(B, Tq, Tk, C, H, renorm)) return (int)cudaErrorInvalidValue;
  started(kK56Simt, -1);
  const auto* km = static_cast<const float*>(key_mask);
  const auto* g = static_cast<const float*>(graph);
  const auto* mi = static_cast<const float*>(m_in);
  const auto* zi = static_cast<const float*>(z_in);
  const auto* bi = static_cast<const float*>(b_in);
  const auto* de = static_cast<const float*>(delta);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (C / H > kMaxDh) {
    if (dtype == 0)
      return launched(1, launch_dkv_wide<float>(q, k, v, km, g, mi, zi, bi, de, dout, dk, dv, B,
                                                Tq, Tk, C, H, renorm, scale, s));
    return launched(1, launch_dkv_wide<__nv_bfloat16>(q, k, v, km, g, mi, zi, bi, de, dout, dk,
                                                      dv, B, Tq, Tk, C, H, renorm, scale, s));
  }
  if (tensor_cores(dtype, C, H)) {
    const TcArgs p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                   static_cast<const bf16*>(v), static_cast<const bf16*>(dout), km, g, mi, zi,
                   bi, de, nullptr, static_cast<bf16*>(dk), static_cast<bf16*>(dv), nullptr, B,
                   Tq, Tk, C, H, renorm, 1, 1, scale, s};
    return launched(1, launch_dkv_tc_dh(p));
  }
  if (f32_kernels(dtype, C, H))
    return launched(1, launch_dkv_f32(C / H, static_cast<const float*>(q),
                                      static_cast<const float*>(k), static_cast<const float*>(v),
                                      km, g, mi, zi, bi, de, static_cast<const float*>(dout),
                                      static_cast<float*>(dk), static_cast<float*>(dv), B, Tq,
                                      Tk, C, H, renorm, scale, s));
  if (dtype == 0)
    return launched(1, launch_dkv<float>(C / H, q, k, v, km, g, mi, zi, bi, de, dout, dk, dv, B,
                                         Tq, Tk, C, H, renorm, scale, s));
  return launched(1, launch_dkv<__nv_bfloat16>(C / H, q, k, v, km, g, mi, zi, bi, de, dout, dk,
                                               dv, B, Tq, Tk, C, H, renorm, scale, s));
}
