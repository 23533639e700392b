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
//   instantiation (16, 32, 64, 128, 256) with its upper channels staged as
//   zeros.
// * Above head width 128 (instance 256) O's accumulators take 128
//   registers a thread, so Q keeps a room of shared memory of its own and
//   each 16-deep block of it is read with ldmatrix where Q K^T needs it
//   (the Q fragments would be 64 registers more), and V's fragments
//   are read two 8-wide blocks at a time. A stage is 86 KB at 256: two
//   stages and Q (206 KB) are one block an SM. Instance 256 also runs 128
//   query rows a block (8 warps; the graph read in fragments from device
//   memory, as the tile would not fit): the rows share the K and V tiles.
// * Above head width 256 the chunked kernel further below: a head's
//   output channels in chunks of 256 over blocks, Q and K streamed 128
//   channels a unit, the scores computed once per chunk.
//
// f32 (csrc/simt_f32.cuh:flash_f32_body): FFMA on the CUDA
// cores (TF32 products would not hold the 1e-4 the f32 path is checked to),
// shaped as the bf16 kernel: a block of 4 warps owns 64 query rows (1 warp,
// 16 rows, when Tq <= 16), K, V, the f32 graph tile and the key mask of each
// 64-key step (32 keys at instance 256, where 64-key K and V tiles would
// not fit beside Q) stream through a two-stage cp.async ring into swizzled
// shared tiles, and each lane computes a 4 x 8 (4 x 4) tile of scores (4 +
// 8 float4 loads for 128 FMAs per 4 channels) and a 4 x (dh / 8) tile of
// the output; above head width 256 its chunked form further below. The
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
// dtype: bf16 at a head width that is no multiple of 16, f32 at one that is
// no multiple of 4. It takes head widths from 1 to 256 (16 output channels
// a thread at 256); wider heads take the wide kernel further below, which
// also serves emit 3 (K1's and K2's wide path) at every head width.

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
constexpr int kTcMaxDh = 256;   // the tensor-core and f32 kernels' widest head
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

// Whether the tensor-core kernel's instance DH keeps Q in shared memory (a
// room of its own) rather than in registers.
__host__ __device__ constexpr bool tc_q_smem(int dh) { return dh > 128; }

// Whether the instance DH with BQ query rows reads its graph entries from
// device memory in the fragments' pattern (load_graph_frag) rather than
// staging the graph tile: above DH 128 at 128 rows (8 warps), where the tile
// would not fit beside Q, K and V.
__host__ __device__ constexpr bool tc_graph_frag(int dh, int bq) {
  return tc_q_smem(dh) && bq > 64;
}

// Dynamic shared memory of the tensor-core kernel's instance DH with BQ
// query rows: kTcStages stages of K, V, the graph tile (but with
// tc_graph_frag) and the key mask, and Q's own room above DH 128.
__host__ __device__ constexpr size_t tc_smem_bytes(int dh, int bq) {
  return kTcStages * (sizeof(__nv_bfloat16) * 2 * kBK * (dh + 8) +
                      sizeof(float) * ((tc_graph_frag(dh, bq) ? 0 : bq * (kBK + 8)) + kBK)) +
         (tc_q_smem(dh) ? sizeof(__nv_bfloat16) * bq * (dh + 8) : 0);
}
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
using savqa::load_graph_frag;
using savqa::mma_bf16;
using savqa::pack_bf16;
using savqa::quad_max;
using savqa::quad_sum;
using savqa::stage_head_tile;

// The running statistics of the two query rows a lane holds in the
// tensor-core kernels' fragments (rows g and g + 8 of its warp's 16): m in
// units of log 2 until the epilogue.
struct TcRows {
  float m_a = -INFINITY, m_b = -INFINITY, z_a = 0.f, z_b = 0.f, b_a = 0.f, b_b = 0.f;
};

// One 64-key step of the tensor-core kernels once s holds this warp's
// scores Q K^T (16 rows x the keys [j0, j0 + 64)): kmask is the step's key
// mask, Vs its V tile (row stride LDV) and graph_at(nb, gr) gives this
// lane's four graph entries of 8-key block nb. Masks the scores and moves
// the running maximum of both rows, forms e, e g and the row sums (s
// becomes e g), rescales O and adds round(e g) V to it. Scores live in
// units of log 2 (x = s scale log2(e), so e = 2^(x - m)); a masked key is
// the fill value itself in those units, which keeps rows without a real key
// at uniform weights and lets the epilogue give back the fill value
// exactly. x = s * mul + fill is one FMA per score: (scale log2(e), 0) on a
// real key, (0, fill) on a masked one, (0, -inf) past the last key.
// V_PAIRS reads V's fragments two 8-wide blocks at a time (fewer live
// registers) and skips O's blocks at or past ow; otherwise every block's
// fragments are read before the products.
template <int ND, int LDV, bool V_PAIRS, typename GraphAt>
__device__ __forceinline__ void tc_step(float (&s)[kBK / 8][4], float (&o)[ND][4], TcRows& st,
                                        const float* kmask, const bf16* Vs, int j0, int Tk,
                                        float scale2, int t, int lane, int ow,
                                        GraphAt graph_at) {
  constexpr int kNS = kBK / 8;
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
  const float mn_a = fmaxf(st.m_a, quad_max(mx_a));
  const float mn_b = fmaxf(st.m_b, quad_max(mx_b));
  const float alpha_a = fast_exp2(st.m_a - mn_a);
  const float alpha_b = fast_exp2(st.m_b - mn_b);
  st.m_a = mn_a;
  st.m_b = mn_b;

  float sz_a = 0.f, sz_b = 0.f, sb_a = 0.f, sb_b = 0.f;
#pragma unroll
  for (int nb = 0; nb < kNS; ++nb) {
    float gr[4];
    graph_at(nb, gr);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float e = fast_exp2(s[nb][c] - (c < 2 ? mn_a : mn_b));
      const float eg = e * gr[c];
      s[nb][c] = eg;
      if (c < 2) { sz_a += e; sb_a += eg; } else { sz_b += e; sb_b += eg; }
    }
  }
  st.z_a = st.z_a * alpha_a + sz_a;
  st.z_b = st.z_b * alpha_b + sz_b;
  st.b_a = st.b_a * alpha_a + sb_a;
  st.b_b = st.b_b * alpha_b + sb_b;
#pragma unroll
  for (int i = 0; i < ND; ++i) {
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
    if constexpr (V_PAIRS) {
#pragma unroll
      for (int nd = 0; nd < ND; nd += 2) {
        if (nd * 8 >= ow) continue;
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, frag_bt_row(Vs, LDV, kk * 16, nd * 8, lane));
        mma_bf16(o[nd], pf, vf[0], vf[1]);
        mma_bf16(o[nd + 1], pf, vf[2], vf[3]);
      }
    } else {
      uint32_t vf[ND / 2][4];
#pragma unroll
      for (int nd = 0; nd < ND; nd += 2)
        ldmatrix_x4_trans(vf[nd / 2], frag_bt_row(Vs, LDV, kk * 16, nd * 8, lane));
#pragma unroll
      for (int nd = 0; nd < ND; nd += 2) {
        mma_bf16(o[nd], pf, vf[nd / 2][0], vf[nd / 2][1]);
        mma_bf16(o[nd + 1], pf, vf[nd / 2][2], vf[nd / 2][3]);
      }
    }
  }
}

// The tensor-core kernels' epilogue for this lane's rows row_a and row_a +
// 8: the row sums over the quad, m back to natural units (the fill value
// comes back as it went in), m, z and b where a split or emit asks for them
// (written by the blocks of the head's first chunk, o0 0), and O's channels
// [o0, o0 + ow) of head h: raw into a_out at shard sp (a split, or emit 2),
// else renormalised, masked and rounded into out.
template <int ND>
__device__ __forceinline__ void tc_epilogue(const float (&o)[ND][4], TcRows st, int row_a,
                                            int t, int Tq, int C, int H, int dh, int h, int b,
                                            int sp, int o0, int ow, int renorm, int emit,
                                            int n_split, const float* __restrict__ query_mask,
                                            bf16* __restrict__ out, float* __restrict__ a_out,
                                            float* __restrict__ m_out, float* __restrict__ z_out,
                                            float* __restrict__ b_out) {
  const float z_a = quad_sum(st.z_a);
  const float z_b = quad_sum(st.z_b);
  const float b_a = quad_sum(st.b_a);
  const float b_b = quad_sum(st.b_b);
  const int c0 = h * dh;
  const bool raw = n_split > 1 || emit == 2;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row_a + 8 * half;
    if (row >= Tq) continue;
    const float m2 = half == 0 ? st.m_a : st.m_b;
    const float mr = m2 == kNegMask ? kNegMask : m2 * kLn2;
    const float zr = half == 0 ? z_a : z_b;
    const float br = half == 0 ? b_a : b_b;
    const size_t stat_at = (((size_t)sp * gridDim.z + b) * H + h) * Tq + row;
    if ((raw || emit == 1) && t == 0 && o0 == 0) {
      m_out[stat_at] = mr;
      z_out[stat_at] = zr;
      b_out[stat_at] = br;
    }
    const float denom = renorm == 0 ? fmaxf(br, kL1Eps * zr) : br + kSumEps * zr;
    const float qm = query_mask[(size_t)b * Tq + row];
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      const int d = i * 8 + 2 * t;
      if (d >= ow) continue;
      const float x = o[i][2 * half], y = o[i][2 * half + 1];
      if (raw) {
        *reinterpret_cast<float2*>(a_out + stat_at * dh + o0 + d) = make_float2(x, y);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)b * Tq + row) * C + c0 + o0 + d) =
            __floats2bfloat162_rn(x / denom * qm, y / denom * qm);
      }
    }
  }
}

// Shared memory, kTcStages stages of: Ks, Vs (kBK, DH + 8) bf16 | Gs (BQ,
// kBK + 8) f32 | kms (kBK) f32. Up to DH 128 the Q tile (BQ, DH + 8) bf16
// lands in the last stage's room, is read into registers once, and gives the
// room up. Above (DH 256: kQSmem) Q's fragments would take 64 registers a
// thread beside O's 128, so the tile keeps a room of its own after the
// stages and each 16-deep block of Q is read with ldmatrix where Q K^T needs
// it; the second product's V fragments are read two 8-wide blocks at a time
// for the same reason.
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
  constexpr bool kGFrag = tc_graph_frag(DH, kBQt);
  constexpr int kGsRows = kGFrag ? 0 : kBQt;   // rows of the staged graph tile
  constexpr int kStageBytes = 2 * kBK * kLd * 2 + (kGsRows * kLdG + kBK) * 4;
  constexpr bool kQSmem = tc_q_smem(DH);
  static_assert(kBQt * kLd * 2 <= kStageBytes, "the Q tile fits a stage");
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw + (kQSmem ? kTcStages : kTcStages - 1) * kStageBytes);

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
    if constexpr (!kGFrag) {
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
    }
    float* kms = Gs + kGsRows * kLdG;
    for (int j = tid; j < kBK; j += kThr)
      cp_async4(kms + j, km + (j0 + j < Tk ? j0 + j : 0), j0 + j < Tk);
  };
  // with kGFrag: this lane's two graph rows (any real row for one that is not)
  const bool real_a = row_a < Tq, real_b = row_b < Tq;
  const float* graph_a = graph + ((size_t)b * Tq + (real_a ? row_a : 0)) * Tk;
  const float* graph_b = graph + ((size_t)b * Tq + (real_b ? row_b : 0)) * Tk;

  stage_head_tile<DH, kThr>(Qs, qb, q0, Tq, kBQt, C, c0, dh);
  for (int i = 0; i < kTcStages - 1; ++i) {   // one group of copies a step, empty past the end
    if (step_lo + i < step_hi) load_step(step_lo + i);
    cp_async_commit();
  }
  cp_async_wait<kTcStages - 2>();
  __syncthreads();   // Q and the first step's tiles have landed
  uint32_t qf[kQSmem ? 1 : kKD][4];
  if (!kQSmem && active) {
#pragma unroll
    for (int kd = 0; kd < kKD; ++kd)
      ldmatrix_x4(qf[kQSmem ? 0 : kd], frag_a_row(Qs, kLd, warp * 16, kd * 16, lane));
  }

  float o[kND][4];
  TcRows st;
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
    const float* kmask = Gs + kGsRows * kLdG;
    const float* g_a = Gs + (warp * 16 + g) * kLdG + 2 * t;   // this lane's two graph rows
    const float* g_b = g_a + 8 * kLdG;
    float gf[kGFrag ? kNS : 1][4];   // kGFrag: the step's graph entries, issued before Q K^T
    if constexpr (kGFrag)
      load_graph_frag<kNS>(gf, graph_a, graph_b, j0 + 2 * t, Tk, real_a, real_b, (Tk & 1) == 0);

    // S = Q K^T: 16 rows x 64 keys a warp
    float s[kNS][4];
#pragma unroll
    for (int nb = 0; nb < kNS; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
    for (int kd = 0; kd < kKD; ++kd) {
      if constexpr (kQSmem) ldmatrix_x4(qf[0], frag_a_row(Qs, kLd, warp * 16, kd * 16, lane));
#pragma unroll
      uint32_t kf[kNS / 2][4];
#pragma unroll
      for (int nb = 0; nb < kNS; nb += 2)
        ldmatrix_x4(kf[nb / 2], frag_b_row(Ks, kLd, nb * 8, kd * 16, lane));
#pragma unroll
      for (int nb = 0; nb < kNS; nb += 2) {
        mma_bf16(s[nb], qf[kQSmem ? 0 : kd], kf[nb / 2][0], kf[nb / 2][1]);
        mma_bf16(s[nb + 1], qf[kQSmem ? 0 : kd], kf[nb / 2][2], kf[nb / 2][3]);
      }
    }

    auto graph_at = [&](int nb, float (&gr)[4]) {
      if constexpr (kGFrag) {
        gr[0] = gf[nb][0], gr[1] = gf[nb][1], gr[2] = gf[nb][2], gr[3] = gf[nb][3];
      } else {
        const float2 ga = *reinterpret_cast<const float2*>(g_a + nb * 8);
        const float2 gb = *reinterpret_cast<const float2*>(g_b + nb * 8);
        gr[0] = ga.x, gr[1] = ga.y, gr[2] = gb.x, gr[3] = gb.y;
      }
    };
    tc_step<kND, kLd, kQSmem>(s, o, st, kmask, Vs, j0, Tk, scale2, t, lane, DH, graph_at);
  }
  cp_async_wait<0>();
  if (!active) return;
  tc_epilogue(o, st, row_a, t, Tq, C, H, dh, h, b, sp, 0, dh, renorm, emit, n_split, query_mask,
              out, a_out, m_out, z_out, b_out);
}

// ---- the chunked tensor-core kernel (bf16, head widths above 256) ----
//
// A head wider than 256 channels has O's 16 x dh f32 a warp past the
// registers, and its K and V tiles past two stages of shared memory. So its
// output channels are cut into chunks of kWideDh (256) over blocks, as the
// wide SIMT kernel cuts them: block (head x chunk, q tile x key shard,
// batch) owns 128 query rows and output channels [o0, o0 + 256) of one head.
// Its scores need the whole head width: each 64-key step is walked as
// ceil(dh / 128) units of the ring, unit d staging Q's and K's channels [128
// d, 128 d + 128) (the last unit's channels past dh zeros) and adding Q
// K^T over them to the warp's score fragments, the last unit also staging
// the step's V chunk (64 keys x 256) and key mask and running the
// tensor-core kernel's step on them (tc_step), then its epilogue for the
// block's channels (tc_epilogue). Q is staged again at every step (it is an L2
// hit): it does not fit beside the ring at every head width. The scores are
// computed ceil(dh / 256) times, once per chunk, on the tensor cores;
// chunk 0 writes m, z and b. Key split and merge as the tensor-core
// kernel's: a chunk's raw a goes to its channels of the partial.
// A block is 8 warps, 128 query rows: each K and V chunk staged serves
// them all (64 rows measured 1.69x / 1.71x slower at head widths 320 / 512,
// scripts/head256_rows.py). The graph tile would not fit beside Q, K and V:
// the lanes read their graph entries from device memory in the fragments'
// pattern (load_graph_frag), issued before the last unit's Q K^T.
// Shared memory, two slots of: Vs (64, 264) bf16 | kms (64) f32 | Kc (64,
// 136) bf16 | Qc (128, 136) bf16: 86,272 bytes each.
constexpr int kChunkDc = 128;   // channels of Q and K a unit of the chunked kernel
constexpr int kChunkWarps = 8;  // warps a block of the chunked kernels (bf16 and f32)

__host__ __device__ constexpr size_t chunk_slot_bytes(int bq) {
  return sizeof(__nv_bfloat16) * kBK * (kWideDh + 8) + sizeof(float) * kBK +
         sizeof(__nv_bfloat16) * (kBK + bq) * (kChunkDc + 8);
}

template <int WARPS>
__global__ void __launch_bounds__(WARPS * 32, 1)
flash_graph_attention_tc_chunk_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                      const bf16* __restrict__ v,
                                      const float* __restrict__ key_mask,
                                      const float* __restrict__ query_mask,
                                      const float* __restrict__ graph, bf16* __restrict__ out,
                                      float* __restrict__ a_out, float* __restrict__ m_out,
                                      float* __restrict__ z_out, float* __restrict__ b_out,
                                      int Tq, int Tk, int C, int H, int dh, int renorm, int emit,
                                      float scale, int n_split, int steps_per_split) {
  constexpr int kBQt = WARPS * 16;
  constexpr int kThr = WARPS * 32;
  constexpr int kLdV = kWideDh + 8;
  constexpr int kLdC = kChunkDc + 8;
  constexpr int kND = kWideDh / 8;   // 8-wide accumulator blocks of the chunk's output
  constexpr int kNS = kBK / 8;       // 8-wide accumulator blocks of the scores
  constexpr int kSlot = (int)chunk_slot_bytes(kBQt);
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int n_chunks = (dh + kWideDh - 1) / kWideDh;
  const int h = blockIdx.x / n_chunks;
  const int o0 = (blockIdx.x - h * n_chunks) * kWideDh;   // the chunk's first channel in the head
  const int ow = min(kWideDh, dh - o0);
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
  const int n_dc = (dh + kChunkDc - 1) / kChunkDc;
  const int n_steps = (Tk + kBK - 1) / kBK;
  const int step_lo = sp * steps_per_split;
  const int step_hi = min(n_steps, step_lo + steps_per_split);
  const int n_units = (step_hi - step_lo) * n_dc;
  const bool active = q0 + warp * 16 < Tq;
  const float scale2 = scale * kLog2e;

  const bf16* qb = q + (size_t)b * Tq * C;
  const bf16* kb = k + (size_t)b * Tk * C;
  const bf16* vb = v + (size_t)b * Tk * C;
  const float* km = key_mask + (size_t)b * Tk;
  const int row_a = q0 + warp * 16 + g;
  const int row_b = row_a + 8;

  auto slot = [&](int u) { return smem_raw + (u & 1) * kSlot; };
  auto load_unit = [&](int u) {
    unsigned char* base = slot(u);
    const int step = step_lo + u / n_dc, dc = (u % n_dc) * kChunkDc;
    const int j0 = step * kBK;
    bf16* Vs = reinterpret_cast<bf16*>(base);
    float* kms = reinterpret_cast<float*>(Vs + kBK * kLdV);
    bf16* Kc = reinterpret_cast<bf16*>(kms + kBK);
    bf16* Qc = Kc + kBK * kLdC;
    stage_head_tile<kChunkDc, kThr>(Kc, kb, j0, Tk, kBK, C, c0 + dc, dh - dc);
    stage_head_tile<kChunkDc, kThr>(Qc, qb, q0, Tq, kBQt, C, c0 + dc, dh - dc);
    if (dc + kChunkDc < dh) return;   // not the step's last unit
    stage_head_tile<kWideDh, kThr>(Vs, vb, j0, Tk, kBK, C, c0 + o0, ow);
    for (int j = tid; j < kBK; j += kThr)
      cp_async4(kms + j, km + (j0 + j < Tk ? j0 + j : 0), j0 + j < Tk);
  };
  // this lane's two graph rows (any real row for one that is not)
  const bool real_a = row_a < Tq, real_b = row_b < Tq;
  const float* graph_a = graph + ((size_t)b * Tq + (real_a ? row_a : 0)) * Tk;
  const float* graph_b = graph + ((size_t)b * Tq + (real_b ? row_b : 0)) * Tk;

  if (n_units > 0) load_unit(0);
  cp_async_commit();

  float o[kND][4], s[kNS][4];
  TcRows st;
#pragma unroll
  for (int i = 0; i < kND; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;

  for (int u = 0; u < n_units; ++u) {
    cp_async_wait<0>();
    __syncthreads();   // this unit's tiles have landed; the other slot's readers are done
    if (u + 1 < n_units) load_unit(u + 1);
    cp_async_commit();
    if (!active) continue;
    const unsigned char* base = slot(u);
    const bf16* Vs = reinterpret_cast<const bf16*>(base);
    const float* kmask = reinterpret_cast<const float*>(Vs + kBK * kLdV);
    const bf16* Kc = reinterpret_cast<const bf16*>(kmask + kBK);
    const bf16* Qc = Kc + kBK * kLdC;
    const int du = u % n_dc;
    const int j0 = (step_lo + u / n_dc) * kBK;
    if (du == 0) {
#pragma unroll
      for (int nb = 0; nb < kNS; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
    }
    float gr[kNS][4];   // the step's graph entries of this lane's rows
    if (du == n_dc - 1)
      load_graph_frag<kNS>(gr, graph_a, graph_b, j0 + 2 * t, Tk, real_a, real_b,
                           (Tk & 1) == 0);
    // S += Q K^T over the unit's 128 channels
#pragma unroll
    for (int kd = 0; kd < kChunkDc / 16; ++kd) {
      uint32_t qa[4], kf[kNS / 2][4];
      ldmatrix_x4(qa, frag_a_row(Qc, kLdC, warp * 16, kd * 16, lane));
#pragma unroll
      for (int nb = 0; nb < kNS; nb += 2)
        ldmatrix_x4(kf[nb / 2], frag_b_row(Kc, kLdC, nb * 8, kd * 16, lane));
#pragma unroll
      for (int nb = 0; nb < kNS; nb += 2) {
        mma_bf16(s[nb], qa, kf[nb / 2][0], kf[nb / 2][1]);
        mma_bf16(s[nb + 1], qa, kf[nb / 2][2], kf[nb / 2][3]);
      }
    }
    if (du != n_dc - 1) continue;
    tc_step<kND, kLdV, true>(s, o, st, kmask, Vs, j0, Tk, scale2, t, lane, ow,
                             [&](int nb, float (&g4)[4]) {
                               g4[0] = gr[nb][0], g4[1] = gr[nb][1];
                               g4[2] = gr[nb][2], g4[3] = gr[nb][3];
                             });
  }
  cp_async_wait<0>();
  if (!active) return;
  tc_epilogue(o, st, row_a, t, Tq, C, H, dh, h, b, sp, o0, ow, renorm, emit, n_split,
              query_mask, out, a_out, m_out, z_out, b_out);
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

// DH 0: the chunked kernel (head widths above 256), a block per (head x
// chunk of 256 output channels), else the tensor-core kernel's instance DH.
template <int DH, int WARPS>
cudaError_t launch_tc(const TcArgs& p) {
  constexpr int kBQt = WARPS * 16;
  constexpr size_t smem = DH == 0 ? 2 * chunk_slot_bytes(kBQt) : tc_smem_bytes(DH, kBQt);
  auto kernel = [] {
    if constexpr (DH == 0)
      return flash_graph_attention_tc_chunk_kernel<WARPS>;
    else
      return flash_graph_attention_tc_kernel<DH, WARPS>;
  }();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int dh = p.C / p.H;
  const int q_tiles = (p.Tq + kBQt - 1) / kBQt;
  const long long heads = DH == 0 ? (long long)p.H * ((dh + kWideDh - 1) / kWideDh) : p.H;
  if (heads > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)heads, q_tiles * p.n_split, p.B);
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

// q_tile: query rows a block, 64, or 128 on instance 256; the chunked
// kernel takes 128.
cudaError_t launch_tc_dh(const TcArgs& p, int q_tile) {
  const int dh = p.C / p.H;
  if (dh <= 16) return launch_tc<16, kTcWarps>(p);
  if (dh <= 32) return launch_tc<32, kTcWarps>(p);
  if (dh <= 64) return launch_tc<64, kTcWarps>(p);
  if (dh <= 128) return launch_tc<128, kTcWarps>(p);
  if (dh <= 256) return q_tile == 128 ? launch_tc<256, 8>(p) : launch_tc<256, kTcWarps>(p);
  return launch_tc<0, kChunkWarps>(p);
}

// ---- the f32 kernel (csrc/simt_f32.cuh) ----

// Keys a step of the f32 kernel's instance DH: 64, and 32 above head width
// 128 (instance 256: Q's 64 KB and two stages of 32-key K and V tiles, 208
// KB with the graph tiles, where 64-key tiles would take 352 KB).
__host__ __device__ constexpr int f32_step(int dh) { return dh <= 128 ? 64 : 32; }

template <int DH, int WARPS, int R, int STEP>
__global__ void __launch_bounds__(WARPS * 32, WARPS * R == 16 && DH <= 64 ? 2 : 1)
flash_graph_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v, const float* __restrict__ key_mask,
                                 const float* __restrict__ query_mask,
                                 const float* __restrict__ graph, float* __restrict__ out,
                                 float* __restrict__ a_out, float* __restrict__ m_out,
                                 float* __restrict__ z_out, float* __restrict__ b_out, int Tq,
                                 int Tk, int C, int H, int dh, int renorm, int emit, float scale,
                                 int n_split, int steps_per_split) {
  savqa_f32::flash_f32_body<DH, WARPS, R, STEP>(q, k, v, key_mask, query_mask, graph, out, a_out, m_out,
                                       z_out, b_out, 1, Tq, Tk, C, H, dh, renorm, emit, scale,
                                       n_split, steps_per_split);
}

// ---- the chunked f32 kernel (f32, head widths above 256) ----
//
// The chunked tensor-core kernel's walk on flash_f32_body's tiles: block
// (head x chunk of 256 output channels, q tile x key shard, batch), 4 R
// WARPS query rows, 32-key steps. Each step is ceil(dh / 64) units of the
// ring, unit d staging Q's and K's channels [64 d, 64 d + 64) (the last
// unit's channels past dh zeros) and adding their products to the lane's 4
// x 4 scores (tile_abt: one FMA chain per score over the head width, in
// ascending channels), the last unit also staging the step's V chunk (32
// keys x 256), graph tile and key mask and running flash_f32_body's step on
// them (flash_f32_step: mask, running maximum, weights through the warp's
// rows of the graph tile, tile_pv into a 4 x 32 output tile a lane), then
// its epilogue (flash_f32_epilogue). Scores computed
// ceil(dh / 256) times; chunk 0 writes m, z, b; key split and merge as
// flash_f32_body's. Shared memory, two slots of Qc (rows, 64) | Kc (32, 64)
// | Vs (32, 256) | Gs (rows, 32) | kms (32) f32: 65,664 bytes each at 64
// rows.
constexpr int kF32Dc = 64;          // channels of Q and K a unit stages
constexpr int kF32ChunkStep = 32;   // keys a step

__host__ __device__ constexpr int f32_chunk_slot_floats(int rows) {
  return (rows + kF32ChunkStep) * kF32Dc + kF32ChunkStep * kWideDh + rows * kF32ChunkStep +
         kF32ChunkStep;
}

template <int WARPS>
__global__ void __launch_bounds__(WARPS * 32, 1)
flash_graph_attention_f32_chunk_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                       const float* __restrict__ v,
                                       const float* __restrict__ key_mask,
                                       const float* __restrict__ query_mask,
                                       const float* __restrict__ graph, float* __restrict__ out,
                                       float* __restrict__ a_out, float* __restrict__ m_out,
                                       float* __restrict__ z_out, float* __restrict__ b_out,
                                       int Tq, int Tk, int C, int H, int dh, int renorm,
                                       int emit, float scale, int n_split, int steps_per_split) {
  namespace f32 = savqa_f32;
  constexpr int R = 4;
  constexpr int kBQ = 4 * R * WARPS;
  constexpr int kThr = 32 * WARPS;
  constexpr int kStepK = kF32ChunkStep;
  constexpr int kNC = kStepK / 8;
  constexpr int kSlotF = f32_chunk_slot_floats(kBQ);
  extern __shared__ __align__(16) float smem_fc[];

  const int n_chunks = (dh + kWideDh - 1) / kWideDh;
  const int h = blockIdx.x / n_chunks;
  const int o0 = (blockIdx.x - h * n_chunks) * kWideDh;
  const int ow = min(kWideDh, dh - o0);
  const int qt = blockIdx.y / n_split;
  const int sp = blockIdx.y - qt * n_split;
  const int b = blockIdx.z;
  const int q0 = qt * kBQ;
  const int c0 = h * dh;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ly = lane >> 3, lx = lane & 7;
  const int wrow = warp * 4 * R;
  const int n_dc = (dh + kF32Dc - 1) / kF32Dc;
  const int n_steps = (Tk + kStepK - 1) / kStepK;
  const int step_lo = sp * steps_per_split;
  const int step_hi = min(n_steps, step_lo + steps_per_split);
  const int n_units = (step_hi - step_lo) * n_dc;
  const bool active = q0 + wrow < Tq;
  const bool gvec = (Tk & 3) == 0;

  const float* qb = q + (size_t)b * Tq * C;
  const float* kb = k + (size_t)b * Tk * C;
  const float* vb = v + (size_t)b * Tk * C;
  const float* gb = graph + (size_t)b * Tq * Tk;
  const float* km = key_mask + (size_t)b * Tk;
  auto load_unit = [&](int u) {
    float* Qc = smem_fc + (u & 1) * kSlotF;
    float* Kc = Qc + kBQ * kF32Dc;
    float* Vs = Kc + kStepK * kF32Dc;
    float* Gs = Vs + kStepK * kWideDh;
    float* kms = Gs + kBQ * kStepK;
    const int step = step_lo + u / n_dc, dc = (u % n_dc) * kF32Dc;
    const int j0 = step * kStepK;
    f32::stage_tile<kF32Dc, kThr>(Qc, qb, q0, Tq, kBQ, C, c0 + dc, dh - dc, true,
                                  f32::Swz<kF32Dc>());
    f32::stage_tile<kF32Dc, kThr>(Kc, kb, j0, Tk, kStepK, C, c0 + dc, dh - dc, true,
                                  f32::Swz<kF32Dc>());
    if (dc + kF32Dc < dh) return;   // not the step's last unit
    f32::stage_tile<kWideDh, kThr>(Vs, vb, j0, Tk, kStepK, C, c0 + o0, ow, true,
                                   f32::Swz<kWideDh>());
    f32::stage_tile<kStepK, kThr>(Gs, gb, q0, Tq, kBQ, Tk, j0, Tk - j0, gvec,
                                  f32::GSwz<kStepK>());
    for (int j = tid; j < kStepK; j += kThr)
      cp_async4(kms + j, km + (j0 + j < Tk ? j0 + j : 0), j0 + j < Tk);
  };

  if (n_units > 0) load_unit(0);
  cp_async_commit();

  float m[R], z[R], bs[R], acc[R][kWideDh / 8], s[R][kNC];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = -INFINITY;
    z[i] = 0.f;
    bs[i] = 0.f;
#pragma unroll
    for (int e = 0; e < kWideDh / 8; ++e) acc[i][e] = 0.f;
  }

  for (int u = 0; u < n_units; ++u) {
    cp_async_wait<0>();
    __syncthreads();   // this unit's tiles have landed; the other slot's readers are done
    if (u + 1 < n_units) load_unit(u + 1);
    cp_async_commit();
    if (!active) continue;
    const float* Qc = smem_fc + (u & 1) * kSlotF;
    const float* Kc = Qc + kBQ * kF32Dc;
    const float* Vs = Kc + kStepK * kF32Dc;
    float* Gs = const_cast<float*>(Vs + kStepK * kWideDh);
    const float* kms = Gs + kBQ * kStepK;
    const int du = u % n_dc;
    if (du == 0) {
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < kNC; ++c) s[i][c] = 0.f;
    }
    f32::tile_abt<kF32Dc, kNC, R>(s, Qc, wrow, Kc, kF32Dc, ly, lx);
    if (du != n_dc - 1) continue;

    const int nk = min(kStepK, Tk - (step_lo + u / n_dc) * kStepK);
    f32::flash_f32_step<kWideDh, kStepK, R>(s, m, z, bs, acc, Gs, kms, Vs, nk, scale, wrow, ly,
                                            lx);
  }
  cp_async_wait<0>();
  if (!active) return;
  f32::flash_f32_epilogue<kWideDh, R>(m, z, bs, acc, q0 + wrow + ly, lx, Tq, C, H, dh, h, b, sp,
                                      o0, ow, 1, renorm, emit, n_split, query_mask, out, a_out,
                                      m_out, z_out, b_out);
}

struct F32Args {
  const float *q, *k, *v, *key_mask, *query_mask, *graph;
  void* out;
  float *m_out, *z_out, *b_out, *scratch_a, *scratch_stats;
  int B, Tq, Tk, C, H, renorm, emit, n_split, steps_per_split;
  float scale;
  cudaStream_t stream;
};

// DH 0: the chunked kernel (head widths above 256), a block per (head x
// chunk of 256 output channels), else the f32 kernel's instance DH.
template <int DH, int WARPS, int R>
cudaError_t launch_f32(const F32Args& p) {
  constexpr int kRows = 4 * R * WARPS;
  constexpr int kStep = f32_step(DH == 0 ? kF32ChunkStep : DH);
  const size_t smem = sizeof(float) * (DH == 0 ? 2 * f32_chunk_slot_floats(kRows)
                                               : savqa_f32::flash_smem_floats(DH, kRows, kStep));
  auto kernel = [] {
    if constexpr (DH == 0)
      return flash_graph_attention_f32_chunk_kernel<WARPS>;
    else
      return flash_graph_attention_f32_kernel<DH, WARPS, R, kStep>;
  }();
  // once a process: the one-query calls are short enough for the host's
  // attribute calls to show
  static const cudaError_t attributes = savqa_f32::allow_smem(kernel, smem);
  if (attributes != cudaSuccess) return attributes;
  cudaError_t err;
  const int dh = p.C / p.H;
  const int q_tiles = (p.Tq + kRows - 1) / kRows;
  const long long heads = DH == 0 ? (long long)p.H * ((dh + kWideDh - 1) / kWideDh) : p.H;
  if (heads > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)heads, q_tiles * p.n_split, p.B);
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
  if (dh <= 128) return launch_f32<128, WARPS, R>(p);
  return launch_f32<256, WARPS, R>(p);
}

// The kernels the entry picks, by the names of flash_graph_attention.py's
// k4_path, and the one this thread's last call launched (-1 before any).
enum K4Path { kPathSimt, kPathWide, kPathTc, kPathTcChunked, kPathF32, kPathF32Chunked };
thread_local int last_path = -1;

// Records the path of a launch that succeeded.
int launched(cudaError_t err, K4Path path) {
  if (err == cudaSuccess) last_path = path;
  return (int)err;
}

}  // namespace

// The kernel that this thread's last call of savqa_flash_graph_attention
// launched (0 simt, 1 wide, 2 tensor-core, 3 tc-chunked, 4 f32, 5
// f32-chunked), -1 before any: the wrappers count launches by it.
extern "C" int savqa_flash_graph_attention_last_path() { return last_path; }

// dtype: 0 = float32, 1 = bfloat16. renorm: 0 = l1, 1 = sum_eps.
// emit: 0 = out, 1 = out + m, z, b, 2 = raw a (B, H, Tq, dh) f32 + m, z, b,
// 3 = out (B, Tq, C) f32 (+ m, z, b where they are not null). m, z and b may
// be null with emit 0. Emit 3 at any head width, and head widths above 256
// that are no multiple of 16 (bf16) or of 4 (f32), take the wide kernel (no
// split: n_split must be 1).
// bf16 with a head width that is a multiple of 16 takes the tensor-core
// kernel (q_tile query rows a block: 64, or 128 above head width 128; 128
// above 256) and f32 with a head width that is a multiple of 4 the f32
// kernel (q_tile: 16 or 64; 128 above 256), above 256 their chunked forms,
// all with the key
// steps (64 keys each; the f32 kernels' are 32 above head width 128) split
// into n_split shards of steps_per_split steps, none of them empty; with
// n_split > 1 scratch_a
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
  // bf16 at every multiple of 16, f32 at every multiple of 4 (above
  // kTcMaxDh the chunked kernels); emit 3 always takes the wide kernel
  const bool tc = dtype == 1 && dh % 16 == 0 && emit != 3;
  const bool f32k = dtype == 0 && dh % 4 == 0 && emit != 3;
  if (!tc && !f32k && (dh > kMaxDh || emit == 3)) {
    if (n_split != 1) return (int)cudaErrorInvalidValue;
    if (dtype == 0)
      return launched(launch_wide<float>(q, k, v, km, qm, g, out, mo, zo, bo, B, Tq, Tk, C, H,
                                         renorm, emit, scale, s), kPathWide);
    return launched(launch_wide<__nv_bfloat16>(q, k, v, km, qm, g, out, mo, zo, bo, B, Tq, Tk,
                                               C, H, renorm, emit, scale, s), kPathWide);
  }
  if (tc || f32k) {
    const int step = f32k ? f32_step(dh) : kBK;
    const int n_steps = (Tk + step - 1) / step;
    if (steps_per_split < 1 ||
        (n_split - 1) * steps_per_split >= n_steps || n_split * steps_per_split < n_steps ||
        (n_split > 1 && (scratch_a == nullptr || scratch_stats == nullptr)))
      return (int)cudaErrorInvalidValue;
  }
  if (tc) {
    if (dh > kTcMaxDh ? q_tile != 128 : q_tile != 64 && (q_tile != 128 || dh <= 128))
      return (int)cudaErrorInvalidValue;
    const TcArgs p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                   static_cast<const bf16*>(v), km, qm, g, out, mo, zo, bo,
                   static_cast<float*>(scratch_a), static_cast<float*>(scratch_stats),
                   B, Tq, Tk, C, H, renorm, emit, n_split, steps_per_split, scale, s};
    return launched(launch_tc_dh(p, q_tile), dh > kTcMaxDh ? kPathTcChunked : kPathTc);
  }
  if (f32k) {
    // above kTcMaxDh the chunked kernel at 128 rows a block (8 warps; 64
    // measured 1.33x slower at head widths 320 and 512,
    // scripts/k4_f32_head256_variants.py)
    const bool chunked = dh > kTcMaxDh;
    if (chunked ? q_tile != 128 : q_tile != 16 && q_tile != 64)
      return (int)cudaErrorInvalidValue;
    const F32Args p{static_cast<const float*>(q), static_cast<const float*>(k),
                    static_cast<const float*>(v), km, qm, g, out, mo, zo, bo,
                    static_cast<float*>(scratch_a), static_cast<float*>(scratch_stats),
                    B, Tq, Tk, C, H, renorm, emit, n_split, steps_per_split, scale, s};
    if (chunked) return launched(launch_f32<0, kChunkWarps, 4>(p), kPathF32Chunked);
    return launched(q_tile == 16 ? launch_f32_dh<1, 4>(p) : launch_f32_dh<4, 4>(p), kPathF32);
  }
  if (n_split != 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launched(launch<float>(dh, q, k, v, km, qm, g, out, mo, zo, bo, B, Tq, Tk, C, H,
                                  renorm, emit, scale, s), kPathSimt);
  return launched(launch<__nv_bfloat16>(dh, q, k, v, km, qm, g, out, mo, zo, bo, B, Tq, Tk, C,
                                        H, renorm, emit, scale, s), kPathSimt);
}
