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
//
// emit 0 ("out"):     out (B, Tq, C) in q's type.
// emit 1 ("stats"):   out, and m, z, b (B, H, Tq) f32 for the backward (K5, K6).
// emit 2 ("partial"): the raw a (B, H, Tq, dh) f32 and m, z, b: no division,
//                     no query mask (a caller merges partials over key shards).
//
// What bounds it on an H100: operations. At the obj+rel shapes (B 4, L 1,536,
// C 512, 8 heads, bf16) it reads q, k, v and the f32 graph and writes out:
// ~50 MB, 15 us at 3.35 TB/s, against 4 B Tq Tk C = 19.3 GFLOP, 20 us at the
// bf16 tensor-core peak and 288 us at the f32 rate these FMAs run at.
//
// Design. One block of 256 threads owns (batch, head, tile of 64 query rows)
// and walks the keys 64 at a time: the loop inside the block takes the place
// of the TPU grid's sequential k-tile dimension, and m, z, b and a live in
// registers across it. Q (once), then each K and V chunk, are staged in
// shared memory as f32. The threads form a 16 x 16 grid: thread (ty, tx)
// owns query rows 4 ty .. 4 ty + 3 and, of the scores, keys tx + 16 c, of
// the output, channels tx + 16 i. It computes its 4 x 4 scores from float4
// reads (rows padded to dh + 4 floats: aligned and free of bank conflicts),
// reduces each row's maximum and sums over the 16 lanes that share the row
// with shuffles, writes its rounded weights to a (64, 64) tile in shared
// memory and, after a barrier, adds that tile times V into its 4 x dh/16
// accumulators. The graph is read straight from device memory, 64 bytes per
// row and half-warp, once per head. Keys are exactly the Tk given: a ragged
// last chunk is filled with s = -inf, so it adds nothing to z (the TPU
// wrapper pads with masked keys, which add to z on rows whose real keys are
// all masked; out is the same). Tq != Tk runs through the same code; row
// groups past the end of a short tile (the decoder's one query) skip the
// products. Up to head width 64 the registers are capped at 128 a thread
// (__launch_bounds__), so that two blocks share an SM and one block's loads
// overlap the other's products. The products are plain FMAs on CUDA cores;
// tensor cores (wgmma) and TMA are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per step
constexpr int kLdP = kBK + 4;  // row stride of the weight tile
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
  const int ld = dh + 4;
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
  const int ld = C / H + 4;
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
  return launch_ndh<T, 8>(args...);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. renorm: 0 = l1, 1 = sum_eps.
// emit: 0 = out, 1 = out + m, z, b, 2 = raw a (B, H, Tq, dh) f32 + m, z, b.
// The head width C / H must be a multiple of 4 and at most 128. m, z and b
// may be null with emit 0. Returns cudaGetLastError() after the launch.
extern "C" int savqa_flash_graph_attention(const void* q, const void* k, const void* v,
                                           const void* key_mask, const void* query_mask,
                                           const void* graph, void* out, void* m_out,
                                           void* z_out, void* b_out, int B, int Tq, int Tk,
                                           int C, int H, int renorm, int emit, int dtype,
                                           float scale, void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || C % H != 0 || (C / H) % 4 != 0 ||
      C / H > kMaxDh || (renorm != 0 && renorm != 1) || emit < 0 || emit > 2)
    return (int)cudaErrorInvalidValue;
  const auto* km = static_cast<const float*>(key_mask);
  const auto* qm = static_cast<const float*>(query_mask);
  const auto* g = static_cast<const float*>(graph);
  auto* mo = static_cast<float*>(m_out);
  auto* zo = static_cast<float*>(z_out);
  auto* bo = static_cast<float*>(b_out);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(C / H, q, k, v, km, qm, g, out, mo, zo, bo, B, Tq, Tk, C, H,
                              renorm, emit, scale, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(C / H, q, k, v, km, qm, g, out, mo, zo, bo, B, Tq, Tk, C,
                                      H, renorm, emit, scale, s);
  return (int)cudaErrorInvalidValue;
}
