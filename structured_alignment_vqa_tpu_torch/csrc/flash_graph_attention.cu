// K4: flash-style (K-blocked) graph-guided attention for long sequences.
//
// Replaces the TPU kernel structured_alignment_vqa_tpu/ops/pallas_flash_attention.py
// (_kernel, line 78, launched by _flash_forward, entry flash_graph_attention).
//
// Per batch element b, head h (dh = C / H) and query row i, one pass over the
// keys j with a running maximum m:
//   s_j = <q_i^h, k_j^h> * scale, or -2^32+1 where key_mask[b, j] == 0
//   e_j = exp(s_j - m)
//   z = sum_j e_j            (the softmax normaliser)
//   b = sum_j e_j g_ij       (g = graph[b, i, j], shared by the heads)
//   a = sum_j round(e_j g_ij) v_j^h   (the weight rounded to V's type, f32 sum)
//   out_i^h = a / max(b, 1e-12 z) * query_mask[b, i]     (renorm 0, "l1")
//   out_i^h = a / (b + 1e-7 z)    * query_mask[b, i]     (renorm 1, "sum_eps")
// The softmax normaliser cancels between the weights and their renorm, so no
// second pass and no (Tq, Tk) tensor is needed. Whenever the maximum rises,
// z, b and a are scaled by alpha = exp(m_old - m_new); the first step starts
// from m = -inf, where alpha = exp(-inf) = 0. While every key seen so far is
// masked, m is the fill value and each masked key counts exp(0) = 1; the
// first real key raises m and alpha underflows to exactly 0 and wipes them.
// Keys are exactly the Tk given: a ragged last step gets s = -inf, so it adds
// nothing to z (the TPU wrapper pads with masked keys, which add to z on rows
// whose real keys are all masked; out is the same).
//
// emit 0 ("out"):     out (B, Tq, C) in q's type.
// emit 1 ("stats"):   out, and m, z, b (B, H, Tq) f32 for the backward (K5, K6).
// emit 2 ("partial"): the raw a (B, H, Tq, dh) f32 and m, z, b: no division,
//                     no query mask (a caller merges partials over key shards).
//
// What bounds it on an H100: at the obj+rel shapes (B 4, L 1,536, C 512,
// 8 heads, bf16) it reads q, k, v and the f32 graph and writes out: ~50 MB,
// 15 us at 3.35 TB/s, against 4 B Tq Tk C = 19.3 GFLOP, 20 us at the bf16
// tensor-core peak. Below that floor the pace is set by what every block
// pulls through L2: its K and V (Tk x dh, once per 64 query rows) and its
// graph rows (64 x Tk f32, once per head), ~300 MB each per launch.
//
// Design of the bf16 path (head widths that are multiples of 16): the shape
// of FlashAttention-2 with this model's graph and renorm.
// * One warp owns 16 query rows; a block of 4 warps owns 64 (6 or 8 warps
//   with 96 or 128 rows measured 3% faster at most). The grid is (head,
//   q-tile x key split, batch): the 8 heads of one (batch, q-tile) are
//   neighbours, so the graph rows the first of them pulls from device memory
//   are L2 hits for the others.
// * Both products run on the tensor cores (mma.sync m16n8k16, bf16 operands,
//   f32 accumulators). S = Q K^T of a 64-key step lands in the warp's
//   accumulator fragments; mask, running maximum, e, e g and the row sums
//   are computed on those fragments (a row lives in the 4 lanes of a quad:
//   two shuffles for the maximum; z and b stay per-lane partial sums until
//   the end). The rounded e g fragments, packed to bf16 pairs, are the A
//   operand of the second product as they are: no weight tile in shared
//   memory and no barrier between the products. a (16 x dh a warp) stays in
//   accumulator fragments and is scaled by alpha in place.
// * K and V tiles are staged as bf16 with cp.async (16 bytes a thread) into
//   a ring of two stages: the copies of step j + 1 are issued right after
//   the one barrier of step j and overlap its products (three stages leave
//   room for two blocks an SM, not three, and measured slower: what hides
//   the copies is the other blocks' warps). Rows are padded by
//   16 bytes so ldmatrix (.trans for V) is free of bank conflicts. Q is
//   loaded once and kept in registers as A fragments. The key mask of a step
//   (64 floats) travels with the tile.
// * The f32 graph tile of a step (64 rows x 64 keys) travels with them,
//   cp.async 16 bytes a thread (4 bytes when Tk is no multiple of 4), and is
//   read from shared memory in the fragment's own pattern (two adjacent
//   floats per 8-wide block; rows padded to 72 floats keep those reads off
//   each other's banks). Reading it from device memory in that pattern
//   instead took as long as everything else in the kernel together: 32 loads
//   of 8 x 32 bytes a step and lane, and 32 registers to keep them in flight.
// * A key split for few query rows: when (q-tiles x heads x batch) does not
//   fill the card (the decoder's one query into 1,536 keys: 32 blocks), the
//   caller splits the key steps over blockIdx.y; each block writes its raw
//   (a, m, z, b) to f32 scratch and merge_partials_kernel combines them
//   (m = max m_i, c_i = exp(m_i - m), sums of c_i (z_i, b_i, a_i), in shard
//   order: no atomics, the same bits every run) and applies renorm, query
//   mask and emit.
// * A zero-padded head: a head width of 48, 80, ... runs in the next
//   instantiation (16, 32, 64, 128) with its upper channels staged as zeros.
//
// f32 (csrc/simt_f32.cuh:flash_f32_body): FFMA on the CUDA
// cores (TF32 products would not hold the 1e-4 the f32 path is checked to),
// shaped as the bf16 kernel: a block of 4 warps owns 64 query rows (1 warp,
// 16 rows, when Tq <= 16), K, V, the f32 graph tile and the key mask of each
// 64-key step stream through a two-stage cp.async ring into swizzled shared
// tiles, and each lane computes a 4 x 8 tile of scores (4 + 8 float4 loads
// for 128 FMAs per 4 channels) and a 4 x (dh / 8) tile of the output. The
// weights go to the second product through the warp's own rows of the
// graph tile, which it has read by then: one warp barrier, no block
// barrier. Each score, each output channel and z and b are summed in the
// order of the first f32 kernel (one block of 256 threads per (batch, head,
// 64 rows), a 4 x 4 thread tile, scalar V loads, the graph read from device
// memory), so an unsplit call keeps its bits. Few-block calls (the
// decoder's one query into 1,536 keys) split the keys into shards of four
// steps, whatever the head count, and merge_partials_kernel<float> merges
// them. What bounds it: at B 4, L 1,536, 8 heads, 19.3 GFLOP, 288 us at the
// 67 TFLOP/s FFMA peak.
//
// Every other call keeps the first SIMT kernel below (one block of 256
// threads per (batch, head, 64 query rows), no key split), in either
// dtype: bf16 at a head width that is no multiple of 16 or above 128, f32
// at a head width that is no multiple of 4 or above 128. It takes head
// widths from 1 to 256 (16 output channels a thread at 256); wider heads
// take the wide kernel further below.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "mma_sm90.cuh"
#include "simt_f32.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per step
constexpr int kLdP = kBK + 4;  // row stride of the weight tile
constexpr int kMaxDh = 256;     // the SIMT kernel's widest head
constexpr int kTcMaxDh = 128;   // the tensor-core and f32 kernels' widest head
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

// ---- the first SIMT kernel (every call the two kernels below do not take) ----
//
// One block of 256 threads owns (batch, head, tile of 64 query rows) and
// walks the keys 64 at a time; Q, K and V are staged in shared memory as
// f32, rows of the head width rounded up to 4 (the columns past it zero, so
// the float4 products add exact zeros) plus 4 of padding. The threads form
// a 16 x 16 grid: thread (ty, tx) owns query rows 4 ty .. 4 ty + 3 and, of
// the scores, keys tx + 16 c, of the output, channels tx + 16 i (i < 16 at
// head width 256). Its rounded weights go through a (64, 64) tile in
// shared memory to the second product; the graph is read from device
// memory, 64 bytes per row and half-warp.

// Reductions over the 16 lanes that share a query row (a half-warp).
__device__ __forceinline__ float row_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float row_max(float x) {
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

// The SIMT kernel's row stride: the head width rounded up to 4, plus 4.
__host__ __device__ constexpr int simt_ld(int dh) { return (dh + 3) / 4 * 4 + 4; }

// Rows [row0, row0 + n) of head c0 of x (.., C) into dst (tile, ld) as f32,
// the head width rounded up to 4; rows from n to tile and columns from dh
// to that width are zero.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ x, int row0, int n,
                                      int tile, int C, int c0, int dh, int ld) {
  const int dp = (dh + 3) / 4 * 4;
  for (int i = threadIdx.x; i < tile * dp; i += kThreads) {
    const int r = i / dp, d = i - r * dp;
    dst[r * ld + d] = r < n && d < dh ? to_float(x[(size_t)(row0 + r) * C + c0 + d]) : 0.f;
  }
}

// Shared memory: Qs (kBQ, ld) | Ks, Vs (kBK, ld) | Ps (kBQ, kLdP) | kms (kBK)
template <typename T, int NDH>
__global__ void __launch_bounds__(kThreads, NDH <= 4 ? 2 : 1)
flash_graph_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const float* __restrict__ key_mask,
                             const float* __restrict__ query_mask,
                             const float* __restrict__ graph, void* __restrict__ out,
                             float* __restrict__ m_out, float* __restrict__ z_out,
                             float* __restrict__ b_out, int Tq, int Tk, int C, int H,
                             int renorm, int emit, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int dh = C / H;
  const int ld = simt_ld(dh);
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int rows = min(kBQ, Tq - q0);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int c0 = h * dh;
  const bool active = ty * 4 < rows;   // this thread's row group holds a real row

  float* Qs = smem;
  float* Ks = Qs + kBQ * ld;
  float* Vs = Ks + kBK * ld;
  float* Ps = Vs + kBK * ld;
  float* kms = Ps + kBQ * kLdP;

  stage(Qs, q + (size_t)b * Tq * C, q0, rows, kBQ, C, c0, dh, ld);

  float m[4], z[4], bs[4], acc[4][NDH];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    z[r] = 0.f;
    bs[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NDH; ++i) acc[r][i] = 0.f;
  }

  const T* kb = k + (size_t)b * Tk * C;
  const T* vb = v + (size_t)b * Tk * C;
  const float* km = key_mask + (size_t)b * Tk;
  const float* gb = graph + ((size_t)b * Tq + q0) * Tk;

  for (int j0 = 0; j0 < Tk; j0 += kBK) {
    const int nk = min(kBK, Tk - j0);
    __syncthreads();  // Qs written; the previous step's readers of Ks, Vs, Ps, kms done
    stage(Ks, kb, j0, nk, kBK, C, c0, dh, ld);
    stage(Vs, vb, j0, nk, kBK, C, c0, dh, ld);
    for (int j = tid; j < kBK; j += kThreads) kms[j] = j < nk ? km[j0 + j] : 0.f;
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
    if (active) {
      for (int d = 0; d < dh; d += 4) {
        float4 qv[4], kv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          qv[r] = *reinterpret_cast<const float4*>(Qs + (ty * 4 + r) * ld + d);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          kv[c] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * c) * ld + d);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[r][c] = dot4(qv[r], kv[c], s[r][c]);
      }
    }
    // mask, running maximum, weights. Every thread takes part in the
    // shuffles; rows past the end of the tile carry zeros and are not stored.
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = tx + 16 * c;
      const bool in_range = j < nk;
      const bool masked = kms[j] == 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        s[r][c] = !in_range ? -INFINITY : masked ? kNegMask : s[r][c] * scale;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = ty * 4 + r;
      const float mx = row_max(fmaxf(fmaxf(s[r][0], s[r][1]), fmaxf(s[r][2], s[r][3])));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float sp = 0.f, spg = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = tx + 16 * c;
        const float p = expf(s[r][c] - m_new);
        const float g = (row < rows && j < nk) ? gb[(size_t)row * Tk + j0 + j] : 0.f;
        const float pg = p * g;
        sp += p;
        spg += pg;
        Ps[row * kLdP + j] = to_float(from_float<T>(pg));
      }
      z[r] = z[r] * alpha + row_sum(sp);
      bs[r] = bs[r] * alpha + row_sum(spg);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < NDH; ++i) acc[r][i] *= alpha;
    }
    __syncthreads();  // Ps complete

    if (active) {
      for (int j = 0; j < kBK; j += 4) {
        float4 pv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pv[r] = *reinterpret_cast<const float4*>(Ps + (ty * 4 + r) * kLdP + j);
#pragma unroll
        for (int i = 0; i < NDH; ++i) {
          const int d = tx + 16 * i;
          if (d < dh) {
            const float v0 = Vs[(j + 0) * ld + d], v1 = Vs[(j + 1) * ld + d];
            const float v2 = Vs[(j + 2) * ld + d], v3 = Vs[(j + 3) * ld + d];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              float a = acc[r][i];
              a = fmaf(pv[r].x, v0, a);
              a = fmaf(pv[r].y, v1, a);
              a = fmaf(pv[r].z, v2, a);
              acc[r][i] = fmaf(pv[r].w, v3, a);
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
    const size_t stat_at = ((size_t)b * H + h) * Tq + q0 + row;
    if (emit != 0 && tx == 0) {
      m_out[stat_at] = m[r];
      z_out[stat_at] = z[r];
      b_out[stat_at] = bs[r];
    }
    const float denom = renorm == 0 ? fmaxf(bs[r], kL1Eps * z[r]) : bs[r] + kSumEps * z[r];
    const float qm = query_mask[(size_t)b * Tq + q0 + row];
#pragma unroll
    for (int i = 0; i < NDH; ++i) {
      const int d = tx + 16 * i;
      if (d >= dh) continue;
      if (emit == 2)
        static_cast<float*>(out)[stat_at * dh + d] = acc[r][i];
      else
        static_cast<T*>(out)[((size_t)b * Tq + q0 + row) * C + c0 + d] =
            from_float<T>(acc[r][i] / denom * qm);
    }
  }
}

template <typename T, int NDH>
cudaError_t launch_ndh(const void* q, const void* k, const void* v, const float* key_mask,
                       const float* query_mask, const float* graph, void* out, float* m_out,
                       float* z_out, float* b_out, int B, int Tq, int Tk, int C, int H,
                       int renorm, int emit, float scale, cudaStream_t stream) {
  const int ld = simt_ld(C / H);
  const size_t smem = sizeof(float) * ((size_t)(kBQ + 2 * kBK) * ld + (size_t)kBQ * kLdP + kBK);
  cudaError_t err = cudaFuncSetAttribute(flash_graph_attention_kernel<T, NDH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
  flash_graph_attention_kernel<T, NDH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), key_mask,
      query_mask, graph, out, m_out, z_out, b_out, Tq, Tk, C, H, renorm, emit, scale);
  return cudaGetLastError();
}

template <typename T, typename... Args>
cudaError_t launch(int dh, Args... args) {
  if (dh <= 16) return launch_ndh<T, 1>(args...);
  if (dh <= 32) return launch_ndh<T, 2>(args...);
  if (dh <= 64) return launch_ndh<T, 4>(args...);
  if (dh <= 128) return launch_ndh<T, 8>(args...);
  return launch_ndh<T, 16>(args...);
}


// ---- the wide kernel (head widths above 256, and K1's and K2's wide path) ----
//
// The SIMT kernel above keeps a whole head's Q, K and V rows in shared
// memory and 16 output channels a thread in registers: 256 channels at most.
// Above that the head's output channels are cut into chunks of kWideDh
// (256) over blocks: block (q tile, head x chunk, batch) owns 64 query rows
// and one chunk of the head's output channels. Its scores need the whole
// head width, so per 64-key step it streams Q and K through shared memory
// kScoreChunk (64) channels at a time into the same 16 x 16 thread grid of
// 4 x 4 scores (each score one FMA chain over the head width in ascending
// order, as the SIMT kernel sums it), then stages V's rows of its chunk and
// runs the SIMT kernel's weights and second product on them. Every block of
// a head computes the same scores, so m, z and b agree between its chunks
// (chunk 0 writes them). The scores are recomputed ceil(dh / 256) times and
// Q is read once a key step: the price of a head wider than a block's
// registers, paid only above the old edge. No key split.
// emit 3 ("o", K1's and K2's wide path): out is (B, Tq, C) f32, K1's
// attention output before the residual, and m, z, b are written where
// their pointers are not null. Its weights are K1's, rounded where K1
// rounds them: a first pass over the keys takes the rows' m, z and b, and
// the second forms each weight as K1 does, (e / z) g / r qmask with r =
// max(b / z, 1e-12) (l1) or b / z + 1e-7 (sum_eps), rounds it to T and
// adds it times V: the scores are computed once more for that.
constexpr int kWideDh = 256;                 // output channels a block: 16 a thread
constexpr int kScoreChunk = 64;              // channels of Q and K staged at a time
constexpr int kLdC = kScoreChunk + 4;        // row stride of the staged channel chunks
constexpr int kLdW = kWideDh + 4;            // row stride of the staged V chunk

__host__ __device__ constexpr size_t wide_smem_bytes() {
  return sizeof(float) * ((size_t)(kBQ + kBK) * kLdC + (size_t)kBK * kLdW + (size_t)kBQ * kLdP + kBK);
}

// s[r][c] = <q_(4 ty + r), k_(tx + 16 c)> over the head's dh channels from
// c0, for the rows [q0, q0 + rows) of qb and the keys [j0, j0 + nk) of kb,
// the channels kScoreChunk at a time through Qc (kBQ, kLdC) and Kc (kBK,
// kLdC). Every thread takes part in the barriers; the first one also waits
// for the readers of the step before.
template <typename T>
__device__ __forceinline__ void wide_scores(float (&s)[4][4], float* Qc, float* Kc,
                                            const T* __restrict__ qb, const T* __restrict__ kb,
                                            int q0, int rows, int j0, int nk, int C, int c0,
                                            int dh, bool active) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
  for (int dc = 0; dc < dh; dc += kScoreChunk) {
    const int w = min(kScoreChunk, dh - dc);
    __syncthreads();
    stage(Qc, qb, q0, rows, kBQ, C, c0 + dc, w, kLdC);
    stage(Kc, kb, j0, nk, kBK, C, c0 + dc, w, kLdC);
    __syncthreads();
    if (!active) continue;
    const int wp = (w + 3) / 4 * 4;
    for (int d = 0; d < wp; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = *reinterpret_cast<const float4*>(Qc + (ty * 4 + r) * kLdC + d);
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = *reinterpret_cast<const float4*>(Kc + (tx + 16 * c) * kLdC + d);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = dot4(qv[r], kv[c], s[r][c]);
    }
  }
}

// Shared memory: Qc (kBQ, kLdC) | Kc (kBK, kLdC) | Vs (kBK, kLdW) | Ps (kBQ, kLdP) | kms (kBK)
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_graph_attention_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                  const T* __restrict__ v, const float* __restrict__ key_mask,
                                  const float* __restrict__ query_mask,
                                  const float* __restrict__ graph, void* __restrict__ out,
                                  float* __restrict__ m_out, float* __restrict__ z_out,
                                  float* __restrict__ b_out, int Tq, int Tk, int C, int H,
                                  int renorm, int emit, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int dh = C / H;
  const int n_chunks = (dh + kWideDh - 1) / kWideDh;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y / n_chunks;
  const int o0 = (blockIdx.y - h * n_chunks) * kWideDh;   // the chunk's first channel in the head
  const int ow = min(kWideDh, dh - o0);
  const int b = blockIdx.z;
  const int rows = min(kBQ, Tq - q0);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int c0 = h * dh;
  const bool active = ty * 4 < rows;

  float* Qc = smem;
  float* Kc = Qc + kBQ * kLdC;
  float* Vs = Kc + kBK * kLdC;
  float* Ps = Vs + kBK * kLdW;
  float* kms = Ps + kBQ * kLdP;

  float m[4], z[4], bs[4], acc[4][kWideDh / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    z[r] = 0.f;
    bs[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kWideDh / 16; ++i) acc[r][i] = 0.f;
  }

  const T* qb = q + (size_t)b * Tq * C;
  const T* kb = k + (size_t)b * Tk * C;
  const T* vb = v + (size_t)b * Tk * C;
  const float* km = key_mask + (size_t)b * Tk;
  const float* gb = graph + ((size_t)b * Tq + q0) * Tk;

  // pass 0 (emit 3 only): m, z and b; pass 1: the weights and O = A V
  float den[4], qmr[4];   // K1's divisor and query mask of each row (emit 3)
  for (int pass = emit == 3 ? 0 : 1; pass < 2; ++pass) {
  const bool k1_weights = emit == 3 && pass == 1;
  if (k1_weights) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = ty * 4 + r;
      const float n = row < rows ? bs[r] / z[r] : 0.f;
      den[r] = renorm == 0 ? fmaxf(n, kL1Eps) : n + kSumEps;
      qmr[r] = row < rows ? query_mask[(size_t)b * Tq + q0 + row] : 0.f;
    }
  }
  for (int j0 = 0; j0 < Tk; j0 += kBK) {
    const int nk = min(kBK, Tk - j0);
    float s[4][4];
    wide_scores(s, Qc, Kc, qb, kb, q0, rows, j0, nk, C, c0, dh, active);
    if (pass == 1) stage(Vs, vb, j0, nk, kBK, C, c0 + o0, ow, kLdW);
    for (int j = tid; j < kBK; j += kThreads) kms[j] = j < nk ? km[j0 + j] : 0.f;
    __syncthreads();

#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = tx + 16 * c;
      const bool in_range = j < nk;
      const bool masked = kms[j] == 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        s[r][c] = !in_range ? -INFINITY : masked ? kNegMask : s[r][c] * scale;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = ty * 4 + r;
      if (k1_weights) {   // m, z, b are final: K1's weight of each key
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = tx + 16 * c;
          float w = 0.f;
          if (row < rows && j < nk) {
            const float a = expf(s[r][c] - m[r]) / z[r] * gb[(size_t)row * Tk + j0 + j];
            w = a / den[r] * qmr[r];
          }
          Ps[row * kLdP + j] = to_float(from_float<T>(w));
        }
        continue;
      }
      const float mx = row_max(fmaxf(fmaxf(s[r][0], s[r][1]), fmaxf(s[r][2], s[r][3])));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float sp = 0.f, spg = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = tx + 16 * c;
        const float p = expf(s[r][c] - m_new);
        const float g = (row < rows && j < nk) ? gb[(size_t)row * Tk + j0 + j] : 0.f;
        const float pg = p * g;
        sp += p;
        spg += pg;
        if (pass == 1) Ps[row * kLdP + j] = to_float(from_float<T>(pg));
      }
      z[r] = z[r] * alpha + row_sum(sp);
      bs[r] = bs[r] * alpha + row_sum(spg);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < kWideDh / 16; ++i) acc[r][i] *= alpha;
    }
    if (pass == 0) continue;
    __syncthreads();  // Ps complete

    if (active) {
      for (int j = 0; j < kBK; j += 4) {
        float4 pv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pv[r] = *reinterpret_cast<const float4*>(Ps + (ty * 4 + r) * kLdP + j);
#pragma unroll
        for (int i = 0; i < kWideDh / 16; ++i) {
          const int d = tx + 16 * i;
          if (d < ow) {
            const float v0 = Vs[(j + 0) * kLdW + d], v1 = Vs[(j + 1) * kLdW + d];
            const float v2 = Vs[(j + 2) * kLdW + d], v3 = Vs[(j + 3) * kLdW + d];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              float a = acc[r][i];
              a = fmaf(pv[r].x, v0, a);
              a = fmaf(pv[r].y, v1, a);
              a = fmaf(pv[r].z, v2, a);
              acc[r][i] = fmaf(pv[r].w, v3, a);
            }
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
    const size_t stat_at = ((size_t)b * H + h) * Tq + q0 + row;
    if (emit != 0 && o0 == 0 && tx == 0 && m_out != nullptr) {
      m_out[stat_at] = m[r];
      z_out[stat_at] = z[r];
      b_out[stat_at] = bs[r];
    }
    const float denom = renorm == 0 ? fmaxf(bs[r], kL1Eps * z[r]) : bs[r] + kSumEps * z[r];
    const float qm = query_mask[(size_t)b * Tq + q0 + row];
    const size_t out_at = ((size_t)b * Tq + q0 + row) * C + c0 + o0;
#pragma unroll
    for (int i = 0; i < kWideDh / 16; ++i) {
      const int d = tx + 16 * i;
      if (d >= ow) continue;
      if (emit == 2)
        static_cast<float*>(out)[stat_at * dh + o0 + d] = acc[r][i];
      else if (emit == 3)
        static_cast<float*>(out)[out_at + d] = acc[r][i];
      else
        static_cast<T*>(out)[out_at + d] = from_float<T>(acc[r][i] / denom * qm);
    }
  }
}

template <typename T>
cudaError_t launch_wide(const void* q, const void* k, const void* v, const float* key_mask,
                        const float* query_mask, const float* graph, void* out, float* m_out,
                        float* z_out, float* b_out, int B, int Tq, int Tk, int C, int H,
                        int renorm, int emit, float scale, cudaStream_t stream) {
  constexpr size_t smem = wide_smem_bytes();
  auto kernel = flash_graph_attention_wide_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_chunks = (C / H + kWideDh - 1) / kWideDh;
  const long long heads = (long long)H * n_chunks;
  if (heads > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid((Tq + kBQ - 1) / kBQ, (unsigned)heads, B);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), key_mask, query_mask, graph,
                                           out, m_out, z_out, b_out, Tq, Tk, C, H, renorm, emit,
                                           scale);
  return cudaGetLastError();
}


// ---- the tensor-core kernel (bf16, head width a multiple of 16) ----

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kTcStages = 2;   // stages of the ring of (K, V, graph, key mask) tiles
using savqa::fast_exp2;
using savqa::cp_async16;
using savqa::cp_async4;
using savqa::cp_async_commit;
using savqa::cp_async_wait;
using savqa::frag_a_row;
using savqa::frag_b_row;
using savqa::frag_bt_row;
using savqa::ldmatrix_x4;
using savqa::ldmatrix_x4_trans;
using savqa::mma_bf16;
using savqa::pack_bf16;
using savqa::quad_max;
using savqa::quad_sum;
using savqa::stage_head_tile;

// Shared memory, kTcStages stages of: Ks, Vs (kBK, DH + 8) bf16 | Gs (BQ,
// kBK + 8) f32 | kms (kBK) f32. The Q tile (BQ, DH + 8) bf16 lands in the last
// stage's room, is read into registers once, and gives the room up.
// With n_split > 1 block (h, qt * n_split + sp, b) walks the key steps
// [sp * steps_per_split, (sp + 1) * steps_per_split) and writes raw
// partials at shard sp of a_out (n_split, B, H, Tq, dh) and m_out, z_out,
// b_out (n_split, B, H, Tq), whatever emit says.
template <int DH, int WARPS>
__global__ void __launch_bounds__(WARPS * 32, DH <= 64 ? 384 / (WARPS * 32) : 1)
flash_graph_attention_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                const bf16* __restrict__ v, const float* __restrict__ key_mask,
                                const float* __restrict__ query_mask,
                                const float* __restrict__ graph, bf16* __restrict__ out,
                                float* __restrict__ a_out, float* __restrict__ m_out,
                                float* __restrict__ z_out, float* __restrict__ b_out, int Tq,
                                int Tk, int C, int H, int dh, int renorm, int emit, float scale,
                                int n_split, int steps_per_split) {
  constexpr int kBQt = WARPS * 16;
  constexpr int kThr = WARPS * 32;
  constexpr int kLd = DH + 8;
  constexpr int kKD = DH / 16;   // 16-deep blocks of the head width
  constexpr int kND = DH / 8;    // 8-wide accumulator blocks of the output
  constexpr int kNS = kBK / 8;   // 8-wide accumulator blocks of the scores
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kLdG = kBK + 8;   // row stride of the graph tile: float2 reads hit 32 banks
  constexpr int kStageBytes = 2 * kBK * kLd * 2 + (kBQt * kLdG + kBK) * 4;
  static_assert(kBQt * kLd * 2 <= kStageBytes, "the Q tile fits a stage");
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw + (kTcStages - 1) * kStageBytes);

  const int h = blockIdx.x;
  const int qt = blockIdx.y / n_split;
  const int sp = blockIdx.y - qt * n_split;
  const int b = blockIdx.z;
  const int q0 = qt * kBQt;
  const int c0 = h * dh;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n_steps = (Tk + kBK - 1) / kBK;
  const int step_lo = sp * steps_per_split;
  const int step_hi = min(n_steps, step_lo + steps_per_split);
  const bool active = q0 + warp * 16 < Tq;   // this warp holds a real row
  const bool graph_quads = (Tk & 3) == 0;    // four adjacent graph entries are 16-byte aligned
  const float scale2 = scale * kLog2e;

  const bf16* qb = q + (size_t)b * Tq * C;
  const bf16* kb = k + (size_t)b * Tk * C;
  const bf16* vb = v + (size_t)b * Tk * C;
  const float* km = key_mask + (size_t)b * Tk;
  const int row_a = q0 + warp * 16 + g;   // this lane's two query rows
  const int row_b = row_a + 8;

  const float* gtile = graph + ((size_t)b * Tq + q0) * Tk;
  auto load_step = [&](int step) {
    unsigned char* base = smem_raw + ((step - step_lo) % kTcStages) * kStageBytes;
    const int j0 = step * kBK;
    bf16* Ks = reinterpret_cast<bf16*>(base);
    stage_head_tile<DH, kThr>(Ks, kb, j0, Tk, kBK, C, c0, dh);
    stage_head_tile<DH, kThr>(Ks + kBK * kLd, vb, j0, Tk, kBK, C, c0, dh);
    // the graph tile of the block's rows: zeros past Tq and past Tk
    float* Gs = reinterpret_cast<float*>(Ks + 2 * kBK * kLd);
    if (graph_quads) {
      for (int i = tid; i < kBQt * (kBK / 4); i += kThr) {
        const int r = i / (kBK / 4), j = j0 + (i - r * (kBK / 4)) * 4;
        const bool valid = q0 + r < Tq && j < Tk;
        cp_async16(Gs + r * kLdG + (j - j0), valid ? gtile + (size_t)r * Tk + j : graph, valid);
      }
    } else {
      for (int i = tid; i < kBQt * kBK; i += kThr) {
        const int r = i / kBK, j = j0 + (i - r * kBK);
        const bool valid = q0 + r < Tq && j < Tk;
        cp_async4(Gs + r * kLdG + (j - j0), valid ? gtile + (size_t)r * Tk + j : graph, valid);
      }
    }
    float* kms = Gs + kBQt * kLdG;
    for (int j = tid; j < kBK; j += kThr)
      cp_async4(kms + j, km + (j0 + j < Tk ? j0 + j : 0), j0 + j < Tk);
  };

  stage_head_tile<DH, kThr>(Qs, qb, q0, Tq, kBQt, C, c0, dh);
  for (int i = 0; i < kTcStages - 1; ++i) {   // one group of copies a step, empty past the end
    if (step_lo + i < step_hi) load_step(step_lo + i);
    cp_async_commit();
  }
  cp_async_wait<kTcStages - 2>();
  __syncthreads();   // Q and the first step's tiles have landed
  uint32_t qf[kKD][4];
  if (active) {
#pragma unroll
    for (int kd = 0; kd < kKD; ++kd)
      ldmatrix_x4(qf[kd], frag_a_row(Qs, kLd, warp * 16, kd * 16, lane));
  }

  float o[kND][4];
  float m_a = -INFINITY, m_b = -INFINITY, z_a = 0.f, z_b = 0.f, b_a = 0.f, b_b = 0.f;
#pragma unroll
  for (int i = 0; i < kND; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;

  for (int step = step_lo; step < step_hi; ++step) {
    cp_async_wait<kTcStages - 2>();
    __syncthreads();   // this step's tiles have landed; the readers of the previous step's
                       // stage (the first time: of Q) are done, and it takes the next copies
    if (step + kTcStages - 1 < step_hi) load_step(step + kTcStages - 1);
    cp_async_commit();
    if (!active) continue;
    const unsigned char* base = smem_raw + ((step - step_lo) % kTcStages) * kStageBytes;
    const int j0 = step * kBK;
    const bf16* Ks = reinterpret_cast<const bf16*>(base);
    const bf16* Vs = Ks + kBK * kLd;
    const float* Gs = reinterpret_cast<const float*>(Vs + kBK * kLd);
    const float* kmask = Gs + kBQt * kLdG;
    const float* g_a = Gs + (warp * 16 + g) * kLdG + 2 * t;   // this lane's two graph rows
    const float* g_b = g_a + 8 * kLdG;

    // S = Q K^T: 16 rows x 64 keys a warp
    float s[kNS][4];
#pragma unroll
    for (int nb = 0; nb < kNS; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
    for (int kd = 0; kd < kKD; ++kd) {
#pragma unroll
      uint32_t kf[kNS / 2][4];
#pragma unroll
      for (int nb = 0; nb < kNS; nb += 2)
        ldmatrix_x4(kf[nb / 2], frag_b_row(Ks, kLd, nb * 8, kd * 16, lane));
#pragma unroll
      for (int nb = 0; nb < kNS; nb += 2) {
        mma_bf16(s[nb], qf[kd], kf[nb / 2][0], kf[nb / 2][1]);
        mma_bf16(s[nb + 1], qf[kd], kf[nb / 2][2], kf[nb / 2][3]);
      }
    }

    // mask and the running maximum of both rows. Scores live in units of
    // log 2 (x = s scale log2(e), so e = 2^(x - m)); a masked key is the fill
    // value itself in those units, which keeps rows without a real key at
    // uniform weights and lets the epilogue give back the fill value exactly.
    // x = s * mul + fill is one FMA per score: (scale log2(e), 0) on a real
    // key, (0, fill) on a masked one, (0, -inf) past the last key.
    const bool ragged = j0 + kBK > Tk;
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int nb = 0; nb < kNS; ++nb) {
      const int jl = nb * 8 + 2 * t;
      const float2 kmv = *reinterpret_cast<const float2*>(kmask + jl);
      float mul0 = kmv.x != 0.f ? scale2 : 0.f, fill0 = kmv.x != 0.f ? 0.f : kNegMask;
      float mul1 = kmv.y != 0.f ? scale2 : 0.f, fill1 = kmv.y != 0.f ? 0.f : kNegMask;
      if (ragged) {
        if (j0 + jl >= Tk) { mul0 = 0.f; fill0 = -INFINITY; }
        if (j0 + jl + 1 >= Tk) { mul1 = 0.f; fill1 = -INFINITY; }
      }
      s[nb][0] = fmaf(s[nb][0], mul0, fill0);
      s[nb][1] = fmaf(s[nb][1], mul1, fill1);
      s[nb][2] = fmaf(s[nb][2], mul0, fill0);
      s[nb][3] = fmaf(s[nb][3], mul1, fill1);
      mx_a = fmaxf(mx_a, fmaxf(s[nb][0], s[nb][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[nb][2], s[nb][3]));
    }
    const float mn_a = fmaxf(m_a, quad_max(mx_a));
    const float mn_b = fmaxf(m_b, quad_max(mx_b));
    const float alpha_a = fast_exp2(m_a - mn_a);
    const float alpha_b = fast_exp2(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;

    // e, e g and the row sums; s becomes e g
    float sz_a = 0.f, sz_b = 0.f, sb_a = 0.f, sb_b = 0.f;
#pragma unroll
    for (int nb = 0; nb < kNS; ++nb) {
      const float2 ga = *reinterpret_cast<const float2*>(g_a + nb * 8);
      const float2 gb = *reinterpret_cast<const float2*>(g_b + nb * 8);
      const float gr[4] = {ga.x, ga.y, gb.x, gb.y};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float e = fast_exp2(s[nb][c] - (c < 2 ? mn_a : mn_b));
        const float eg = e * gr[c];
        s[nb][c] = eg;
        if (c < 2) { sz_a += e; sb_a += eg; } else { sz_b += e; sb_b += eg; }
      }
    }
    z_a = z_a * alpha_a + sz_a;
    z_b = z_b * alpha_b + sz_b;
    b_a = b_a * alpha_a + sb_a;
    b_b = b_b * alpha_b + sb_b;
#pragma unroll
    for (int i = 0; i < kND; ++i) {
      o[i][0] *= alpha_a; o[i][1] *= alpha_a;
      o[i][2] *= alpha_b; o[i][3] *= alpha_b;
    }

    // a += round(e g) V: the score fragments are the A operand as they are
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pf[4];
      pf[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pf[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pf[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pf[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      uint32_t vf[kND / 2][4];
#pragma unroll
      for (int nd = 0; nd < kND; nd += 2)
        ldmatrix_x4_trans(vf[nd / 2], frag_bt_row(Vs, kLd, kk * 16, nd * 8, lane));
#pragma unroll
      for (int nd = 0; nd < kND; nd += 2) {
        mma_bf16(o[nd], pf, vf[nd / 2][0], vf[nd / 2][1]);
        mma_bf16(o[nd + 1], pf, vf[nd / 2][2], vf[nd / 2][3]);
      }
    }
  }
  cp_async_wait<0>();
  if (!active) return;

  z_a = quad_sum(z_a);
  z_b = quad_sum(z_b);
  b_a = quad_sum(b_a);
  b_b = quad_sum(b_b);
  const bool raw = n_split > 1 || emit == 2;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half == 0 ? row_a : row_b;
    if (row >= Tq) continue;
    // back to natural units; the fill value comes back as it went in
    const float m2 = half == 0 ? m_a : m_b;
    const float mr = m2 == kNegMask ? kNegMask : m2 * kLn2;
    const float zr = half == 0 ? z_a : z_b;
    const float br = half == 0 ? b_a : b_b;
    const size_t stat_at = (((size_t)sp * gridDim.z + b) * H + h) * Tq + row;
    if ((raw || emit == 1) && t == 0) {
      m_out[stat_at] = mr;
      z_out[stat_at] = zr;
      b_out[stat_at] = br;
    }
    const float denom = renorm == 0 ? fmaxf(br, kL1Eps * zr) : br + kSumEps * zr;
    const float qm = query_mask[(size_t)b * Tq + row];
#pragma unroll
    for (int i = 0; i < kND; ++i) {
      const int d = i * 8 + 2 * t;
      if (d >= dh) continue;
      const float x = o[i][2 * half], y = o[i][2 * half + 1];
      if (raw) {
        *reinterpret_cast<float2*>(a_out + stat_at * dh + d) = make_float2(x, y);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)b * Tq + row) * C + c0 + d) =
            __floats2bfloat162_rn(x / denom * qm, y / denom * qm);
      }
    }
  }
}

// Combines the raw partials of n_split key shards, one thread per (batch,
// head, row, channel): m = max m_i, c_i = exp(m_i - m) (0 for a shard that
// saw no key, m_i = -inf), z, b, a = sum c_i (z_i, b_i, a_i) in shard order;
// then renorm, query mask and emit as the unsplit kernel.
template <typename T>
__global__ void __launch_bounds__(256)
merge_partials_kernel(const float* __restrict__ a_part, const float* __restrict__ m_part,
                      const float* __restrict__ z_part, const float* __restrict__ b_part,
                      const float* __restrict__ query_mask, T* __restrict__ out,
                      float* __restrict__ a_out, float* __restrict__ m_out,
                      float* __restrict__ z_out, float* __restrict__ b_out, int n_split, int B,
                      int H, int Tq, int dh, int renorm, int emit) {
  const size_t n_rows = (size_t)B * H * Tq;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_rows * dh) return;
  const size_t r = idx / dh;
  const int d = (int)(idx - r * dh);
  float m = -INFINITY;
  for (int i = 0; i < n_split; ++i) m = fmaxf(m, m_part[i * n_rows + r]);
  float z = 0.f, bs = 0.f, a = 0.f;
  for (int i = 0; i < n_split; ++i) {
    const float mi = m_part[i * n_rows + r];
    const float c = mi == -INFINITY ? 0.f : expf(mi - m);
    z += c * z_part[i * n_rows + r];
    bs += c * b_part[i * n_rows + r];
    a += c * a_part[(i * n_rows + r) * dh + d];
  }
  if (emit != 0 && d == 0) {
    m_out[r] = m;
    z_out[r] = z;
    b_out[r] = bs;
  }
  if (emit == 2) {
    a_out[idx] = a;
    return;
  }
  const int row = (int)(r % Tq);
  const int h = (int)((r / Tq) % H);
  const int b = (int)(r / ((size_t)Tq * H));
  const float denom = renorm == 0 ? fmaxf(bs, kL1Eps * z) : bs + kSumEps * z;
  const float qm = query_mask[(size_t)b * Tq + row];
  out[((size_t)b * Tq + row) * H * dh + h * dh + d] = from_float<T>(a / denom * qm);
}

struct TcArgs {
  const bf16 *q, *k, *v;
  const float *key_mask, *query_mask, *graph;
  void* out;
  float *m_out, *z_out, *b_out, *scratch_a, *scratch_stats;
  int B, Tq, Tk, C, H, renorm, emit, n_split, steps_per_split;
  float scale;
  cudaStream_t stream;
};

template <int DH, int WARPS>
cudaError_t launch_tc(const TcArgs& p) {
  constexpr int kBQt = WARPS * 16;
  const size_t smem = kTcStages * (sizeof(bf16) * 2 * kBK * (DH + 8) +
                                   sizeof(float) * (kBQt * (kBK + 8) + kBK));
  auto kernel = flash_graph_attention_tc_kernel<DH, WARPS>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int dh = p.C / p.H;
  const int q_tiles = (p.Tq + kBQt - 1) / kBQt;
  const dim3 grid(p.H, q_tiles * p.n_split, p.B);
  const size_t n_rows = (size_t)p.B * p.H * p.Tq;
  const bool split = p.n_split > 1;
  // unsplit: out or the raw a go where the caller wants them; split: to scratch
  bf16* out = p.emit == 2 ? nullptr : static_cast<bf16*>(p.out);
  float* a_out = p.emit == 2 ? static_cast<float*>(p.out) : nullptr;
  float* sm = p.scratch_stats;
  kernel<<<grid, WARPS * 32, smem, p.stream>>>(
      p.q, p.k, p.v, p.key_mask, p.query_mask, p.graph, out, split ? p.scratch_a : a_out,
      split ? sm : p.m_out, split ? sm + p.n_split * n_rows : p.z_out,
      split ? sm + 2 * p.n_split * n_rows : p.b_out, p.Tq, p.Tk, p.C, p.H, dh, p.renorm, p.emit,
      p.scale, p.n_split, p.steps_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || !split) return err;
  const size_t total = n_rows * dh;
  merge_partials_kernel<bf16><<<(unsigned)((total + 255) / 256), 256, 0, p.stream>>>(
      p.scratch_a, sm, sm + p.n_split * n_rows, sm + 2 * p.n_split * n_rows, p.query_mask, out,
      a_out, p.m_out, p.z_out, p.b_out, p.n_split, p.B, p.H, p.Tq, dh, p.renorm, p.emit);
  return cudaGetLastError();
}

constexpr int kTcWarps = 4;   // 64 query rows a block

cudaError_t launch_tc_dh(const TcArgs& p) {
  const int dh = p.C / p.H;
  if (dh <= 16) return launch_tc<16, kTcWarps>(p);
  if (dh <= 32) return launch_tc<32, kTcWarps>(p);
  if (dh <= 64) return launch_tc<64, kTcWarps>(p);
  return launch_tc<128, kTcWarps>(p);
}

// ---- the f32 kernel (csrc/simt_f32.cuh) ----

template <int DH, int WARPS, int R>
__global__ void __launch_bounds__(WARPS * 32, WARPS * R == 16 && DH <= 64 ? 2 : 1)
flash_graph_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v, const float* __restrict__ key_mask,
                                 const float* __restrict__ query_mask,
                                 const float* __restrict__ graph, float* __restrict__ out,
                                 float* __restrict__ a_out, float* __restrict__ m_out,
                                 float* __restrict__ z_out, float* __restrict__ b_out, int Tq,
                                 int Tk, int C, int H, int dh, int renorm, int emit, float scale,
                                 int n_split, int steps_per_split) {
  savqa_f32::flash_f32_body<DH, WARPS, R>(q, k, v, key_mask, query_mask, graph, out, a_out, m_out,
                                       z_out, b_out, 1, Tq, Tk, C, H, dh, renorm, emit, scale,
                                       n_split, steps_per_split);
}

struct F32Args {
  const float *q, *k, *v, *key_mask, *query_mask, *graph;
  void* out;
  float *m_out, *z_out, *b_out, *scratch_a, *scratch_stats;
  int B, Tq, Tk, C, H, renorm, emit, n_split, steps_per_split;
  float scale;
  cudaStream_t stream;
};

template <int DH, int WARPS, int R>
cudaError_t launch_f32(const F32Args& p) {
  constexpr int kRows = 4 * R * WARPS;
  const size_t smem = sizeof(float) * savqa_f32::flash_smem_floats(DH, kRows);
  auto kernel = flash_graph_attention_f32_kernel<DH, WARPS, R>;
  // once a process: the one-query calls are short enough for the host's
  // attribute calls to show
  static const cudaError_t attributes = savqa_f32::allow_smem(kernel, smem);
  if (attributes != cudaSuccess) return attributes;
  cudaError_t err;
  const int dh = p.C / p.H;
  const int q_tiles = (p.Tq + kRows - 1) / kRows;
  const dim3 grid(p.H, q_tiles * p.n_split, p.B);
  const size_t n_rows = (size_t)p.B * p.H * p.Tq;
  const bool split = p.n_split > 1;
  float* out = p.emit == 2 ? nullptr : static_cast<float*>(p.out);
  float* a_out = p.emit == 2 ? static_cast<float*>(p.out) : nullptr;
  float* sm = p.scratch_stats;
  kernel<<<grid, WARPS * 32, smem, p.stream>>>(
      p.q, p.k, p.v, p.key_mask, p.query_mask, p.graph, out, split ? p.scratch_a : a_out,
      split ? sm : p.m_out, split ? sm + p.n_split * n_rows : p.z_out,
      split ? sm + 2 * p.n_split * n_rows : p.b_out, p.Tq, p.Tk, p.C, p.H, dh, p.renorm, p.emit,
      p.scale, p.n_split, p.steps_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || !split) return err;
  const size_t total = n_rows * dh;
  merge_partials_kernel<float><<<(unsigned)((total + 255) / 256), 256, 0, p.stream>>>(
      p.scratch_a, sm, sm + p.n_split * n_rows, sm + 2 * p.n_split * n_rows, p.query_mask, out,
      a_out, p.m_out, p.z_out, p.b_out, p.n_split, p.B, p.H, p.Tq, dh, p.renorm, p.emit);
  return cudaGetLastError();
}

template <int WARPS, int R>
cudaError_t launch_f32_dh(const F32Args& p) {
  const int dh = p.C / p.H;
  if (dh <= 32) return launch_f32<32, WARPS, R>(p);
  if (dh <= 64) return launch_f32<64, WARPS, R>(p);
  return launch_f32<128, WARPS, R>(p);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. renorm: 0 = l1, 1 = sum_eps.
// emit: 0 = out, 1 = out + m, z, b, 2 = raw a (B, H, Tq, dh) f32 + m, z, b,
// 3 = out (B, Tq, C) f32 (+ m, z, b where they are not null). m, z and b may
// be null with emit 0. Head widths above 256, and emit 3 at any head width,
// take the wide kernel (no split: n_split must be 1).
// bf16 with a head width that is a multiple of 16 up to 128 takes the
// tensor-core kernel (64 query rows a block) and f32 with a head width that
// is a multiple of 4 up to 128 the f32 kernel (q_tile query rows a block, 16
// or 64), both with the key steps (64 keys each) split into n_split shards
// of steps_per_split steps, none of them empty; with n_split > 1 scratch_a
// (n_split, B, H, Tq, dh) and scratch_stats (3, n_split, B, H, Tq) f32 hold
// the partials between the two launches. Every other call takes the first
// SIMT kernel, which has no split (n_split must be 1). Returns
// cudaGetLastError() after the launch.
extern "C" int savqa_flash_graph_attention(const void* q, const void* k, const void* v,
                                           const void* key_mask, const void* query_mask,
                                           const void* graph, void* out, void* m_out,
                                           void* z_out, void* b_out, void* scratch_a,
                                           void* scratch_stats, int B, int Tq, int Tk, int C,
                                           int H, int renorm, int emit, int dtype, int n_split,
                                           int steps_per_split, int q_tile, float scale,
                                           void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || C % H != 0 || (renorm != 0 && renorm != 1) ||
      emit < 0 || emit > 3 || n_split < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const auto* km = static_cast<const float*>(key_mask);
  const auto* qm = static_cast<const float*>(query_mask);
  const auto* g = static_cast<const float*>(graph);
  auto* mo = static_cast<float*>(m_out);
  auto* zo = static_cast<float*>(z_out);
  auto* bo = static_cast<float*>(b_out);
  auto s = static_cast<cudaStream_t>(stream);
  const int dh = C / H;
  if (dh > kMaxDh || emit == 3) {
    if (n_split != 1) return (int)cudaErrorInvalidValue;
    if (dtype == 0)
      return (int)launch_wide<float>(q, k, v, km, qm, g, out, mo, zo, bo, B, Tq, Tk, C, H,
                                     renorm, emit, scale, s);
    return (int)launch_wide<__nv_bfloat16>(q, k, v, km, qm, g, out, mo, zo, bo, B, Tq, Tk, C,
                                           H, renorm, emit, scale, s);
  }
  const bool tc = dtype == 1 && dh % 16 == 0 && dh <= kTcMaxDh;
  const bool f32k = dtype == 0 && dh % 4 == 0 && dh <= kTcMaxDh;
  if (tc || f32k) {
    const int n_steps = (Tk + kBK - 1) / kBK;
    if (steps_per_split < 1 ||
        (n_split - 1) * steps_per_split >= n_steps || n_split * steps_per_split < n_steps ||
        (n_split > 1 && (scratch_a == nullptr || scratch_stats == nullptr)))
      return (int)cudaErrorInvalidValue;
  }
  if (tc) {
    const TcArgs p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                   static_cast<const bf16*>(v), km, qm, g, out, mo, zo, bo,
                   static_cast<float*>(scratch_a), static_cast<float*>(scratch_stats),
                   B, Tq, Tk, C, H, renorm, emit, n_split, steps_per_split, scale, s};
    return (int)launch_tc_dh(p);
  }
  if (f32k) {
    if (q_tile != 16 && q_tile != 64) return (int)cudaErrorInvalidValue;
    const F32Args p{static_cast<const float*>(q), static_cast<const float*>(k),
                    static_cast<const float*>(v), km, qm, g, out, mo, zo, bo,
                    static_cast<float*>(scratch_a), static_cast<float*>(scratch_stats),
                    B, Tq, Tk, C, H, renorm, emit, n_split, steps_per_split, scale, s};
    return (int)(q_tile == 16 ? launch_f32_dh<1, 4>(p) : launch_f32_dh<4, 4>(p));
  }
  if (n_split != 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch<float>(dh, q, k, v, km, qm, g, out, mo, zo, bo, B, Tq, Tk, C, H, renorm,
                              emit, scale, s);
  return (int)launch<__nv_bfloat16>(dh, q, k, v, km, qm, g, out, mo, zo, bo, B, Tq, Tk, C, H,
                                    renorm, emit, scale, s);
}
