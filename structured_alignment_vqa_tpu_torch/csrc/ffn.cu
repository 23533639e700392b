// K3: fused position-wise FFN + residual + reference LayerNorm.
//
// Replaces the TPU kernel structured_alignment_vqa_tpu/ops/pallas_ffn.py
// (_kernel, launched by _fused_forward, entry fused_ffn).
//
// For every row x of C values (weights in nn.Linear layout, W1 (Hd, C),
// W2 (C, Hd), Hd = 4C in the model):
//   h   = relu(W1 x + b1)            f32 accumulation, rounded to x's type
//   y   = W2 h + b2 + x              f32
//   out = gamma (y - mean) / (std + 1e-8) + beta, std unbiased
//
// What bounds it on an H100: operations. At 16,384 rows, C 512 it does
// 6.9e10 operations on ~37 MB in bf16 (about 1,900 per byte, far above the
// ~295 ridge) and on ~75 MB in f32; at the decoder's 128 rows the 4 MB of
// bf16 weights bound it instead. f32 has no tensor-core form that keeps
// f32 products (TF32 keeps about 3 digits; the f32 path is held to 1e-4),
// so its bound is FFMA on the CUDA cores, 67 TFLOP/s.
//
// Two designs, by dtype and width (any C, any hidden width):
//
// * bf16 at C 128, 256, 384 or 512 with a hidden width that is a multiple of
//   64 (ffn_ln_tc_kernel, below): the TPU kernel's shape. A
//   block owns 64 rows and walks the hidden width in chunks of 64 on the
//   tensor cores: the chunk h = relu(x W1[chunk]^T + b1) is built on chip
//   and never written to device memory, y += h W2[:, chunk]^T accumulates in
//   registers, and the residual and the LayerNorm finish in the block.
//
// * float32 at every width, and bf16 at every other width (the products
//   path, further below): two kernels shaped like GEMMs, then the shard-sum
//   kernel. C and the hidden width are runtime extents there: edge tiles
//   zero-fill the rows, columns and k past the operands and store nothing
//   past them, and the LayerNorm leaves the columns past C out of its sums
//   (above C 2,048 it runs a block a row, ffn_ln_row_kernel).
//   bf16 rows whose width is no multiple of 8 (or operands not 16-byte
//   aligned) are copied element by element instead of by 16-byte cp.async. The
//   hidden activation goes through device memory: at 16,384 rows its round
//   trip is 268 MB in f32 (~0.08 ms, 8% of the 1.03 ms bound), while a fused
//   block would have to stream both weight matrices once per row tile (the
//   old f32 kernel, 32 rows a block: 4.3 GB through L2) and, at C 2,048, a
//   64-row tile of f32 y alone is 512 KB against a block's 227 KB. A GEMM
//   tile of 128 x 128 reads each operand once per 128 rows or columns, and
//   its register blocking (f32: 8 x 8 a thread, 4 FMAs per shared word) is
//   what FFMA peak needs. wgmma and TMA are not used (bf16 C 2,048 is off
//   every serving and training path; f32 cannot use them).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstdint>

#include "mma_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHidden = 64;     // hidden chunk: the unit of Hd and of a shard
constexpr float kLnEps = 1e-8f;

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ------------------------------------------------------------------- bf16
//
// One block of 8 warps owns 64 rows and walks its hidden chunks of 64 (all
// of them, or one shard of them, below). Per chunk:
//   1. h = relu(x W1[chunk]^T + b1): warp (rg, hh) = (warp / 2, warp % 2)
//      forms rows 16 rg .. 16 rg + 15 x hidden 32 hh .. 32 hh + 31 with
//      mma.sync m16n8k16 (x and the W1 chunk from shared memory through
//      ldmatrix), adds b1 and rounds to bf16 on its accumulator fragments,
//      and writes them to the 64 x 64 bf16 tile hs (the only round trip of
//      h: 8 KB in shared memory, never f32);
//   2. y += h W2[:, chunk]^T: warp w owns all 64 rows x columns
//      [w C/8, (w+1) C/8) of y in accumulator fragments (128 registers at
//      C 512), so every hs fragment it loads feeds C/64 products.
// The W1 chunk (64 x C) and the W2 chunk (C x 64) stream in by cp.async, the
// next W1 chunk while the current W2 chunk is multiplied and the other way
// round. 64 rows a block read the 4 MB of weights half as often per row as
// 32 did (2 GiB -> 1 GiB through L2 at 16,384 rows); 218 KB of shared
// memory and ~170 registers a thread leave one block an SM.
//
// Few rows (the decoders' 128 and 4, obj+rel's 264): the row tiles alone
// leave most SMs idle and each block's chunks are one serial chain, so the
// wrapper splits the hidden chunks into n_split shards (ffn_split in
// ops/fused_ffn.py, a pure function of the shapes): block (tile, shard)
// writes its f32 partial y of real rows to scratch and ffn_ln_shard_sum_kernel
// sums the shards in shard order (no atomics: every run sums alike), adds
// b2 and x and runs the LayerNorm. Unsplit, the block adds b2 and x to its
// fragments and runs the LayerNorm itself, the row sums of its 8 warps
// exchanged through shared memory.

using bf16 = __nv_bfloat16;
using savqa::cp_async16;
using savqa::cp_async4;
using savqa::cp_async_commit;
using savqa::cp_async_wait;
using savqa::frag_a_row;
using savqa::frag_b_row;
using savqa::ldmatrix_x4;
using savqa::mma_bf16;
using savqa::pack_bf16;
using savqa::quad_sum;

constexpr int kTcRows = 64;     // rows per block
constexpr int kTcHidden = 64;   // hidden chunk

// Shared memory of the tensor-core kernel, in bytes. Row strides are an odd
// number of 16-byte units, which keeps ldmatrix free of bank conflicts.
template <int C>
struct TcSmem {
  static constexpr int XS = C + 8;           // x tile and W1 chunk: rows of C
  static constexpr int W2S = kTcHidden + 8;  // W2 chunk: one row of 64 per output column
  static constexpr int HS = kTcHidden + 8;   // hidden chunk, bf16
  static constexpr size_t x = 0;
  static constexpr size_t w1 = x + 2 * kTcRows * XS;
  static constexpr size_t w2 = w1 + 2 * kTcHidden * XS;
  static constexpr size_t h = w2 + 2 * C * W2S;
  static constexpr size_t red = h + 2 * kTcRows * HS;   // per warp and row: a LayerNorm partial sum
  static constexpr size_t bytes = red + 4 * kWarps * kTcRows;
};

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
ffn_ln_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                 const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                 const bf16* __restrict__ b2, const float* __restrict__ gamma,
                 const float* __restrict__ beta, bf16* __restrict__ out,
                 float* __restrict__ partial, int N, int Hd, int per_split) {
  using S = TcSmem<C>;
  constexpr int kNW = C / kWarps;   // output columns per warp
  constexpr int kNB = kNW / 8;      // their 8-wide blocks
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* xs = reinterpret_cast<bf16*>(tc_smem + S::x);
  bf16* w1s = reinterpret_cast<bf16*>(tc_smem + S::w1);
  bf16* w2s = reinterpret_cast<bf16*>(tc_smem + S::w2);
  bf16* hs = reinterpret_cast<bf16*>(tc_smem + S::h);
  float* red = reinterpret_cast<float*>(tc_smem + S::red);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = blockIdx.x * kTcRows;
  const int j_begin = blockIdx.y * per_split;
  const int j_end = min(Hd / kTcHidden, j_begin + per_split);

  auto load_w1 = [&](int j) {   // W1[64 j : 64 j + 64, :]
    for (int i = tid; i < kTcHidden * (C / 8); i += kThreads) {
      const int r = i / (C / 8), c = (i - r * (C / 8)) * 8;
      cp_async16(w1s + r * S::XS + c, w1 + (size_t)(j * kTcHidden + r) * C + c, true);
    }
  };
  auto load_w2 = [&](int j) {   // W2[:, 64 j : 64 j + 64]
    for (int i = tid; i < C * (kTcHidden / 8); i += kThreads) {
      const int n = i >> 3, k = (i & 7) * 8;
      cp_async16(w2s + n * S::W2S + k, w2 + (size_t)n * Hd + j * kTcHidden + k, true);
    }
  };
  for (int i = tid; i < kTcRows * (C / 8); i += kThreads) {   // rows past N are zeros
    const int r = i / (C / 8), c = (i - r * (C / 8)) * 8;
    const bool valid = row0 + r < N;
    cp_async16(xs + r * S::XS + c, valid ? x + (size_t)(row0 + r) * C + c : x, valid);
  }
  load_w1(j_begin);
  cp_async_commit();

  float y[4][kNB][4];
#pragma unroll
  for (int rb = 0; rb < 4; ++rb)
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) y[rb][nb][0] = y[rb][nb][1] = y[rb][nb][2] = y[rb][nb][3] = 0.f;
  const int rg = warp >> 1, hh = warp & 1;

  for (int j = j_begin; j < j_end; ++j) {
    load_w2(j);
    cp_async_commit();
    cp_async_wait<1>();   // x and this W1 chunk have landed; the W2 chunk may not have
    __syncthreads();

    {   // 1. h = relu(x W1[chunk]^T + b1), rounded to bf16, into hs
      float hacc[4][4];
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) hacc[nb][0] = hacc[nb][1] = hacc[nb][2] = hacc[nb][3] = 0.f;
#pragma unroll 8
      for (int k0 = 0; k0 < C; k0 += 16) {
        uint32_t a[4], bq[2][4];
        ldmatrix_x4(a, frag_a_row(xs, S::XS, 16 * rg, k0, lane));
        ldmatrix_x4(bq[0], frag_b_row(w1s, S::XS, 32 * hh, k0, lane));
        ldmatrix_x4(bq[1], frag_b_row(w1s, S::XS, 32 * hh + 16, k0, lane));
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          mma_bf16(hacc[2 * p], a, bq[p][0], bq[p][1]);
          mma_bf16(hacc[2 * p + 1], a, bq[p][2], bq[p][3]);
        }
      }
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        const int col = 32 * hh + 8 * nb + 2 * t;
        const float ba = __bfloat162float(b1[j * kTcHidden + col]);
        const float bb = __bfloat162float(b1[j * kTcHidden + col + 1]);
        const int ra = 16 * rg + g;
        *reinterpret_cast<uint32_t*>(hs + ra * S::HS + col) =
            pack_bf16(fmaxf(hacc[nb][0] + ba, 0.f), fmaxf(hacc[nb][1] + bb, 0.f));
        *reinterpret_cast<uint32_t*>(hs + (ra + 8) * S::HS + col) =
            pack_bf16(fmaxf(hacc[nb][2] + ba, 0.f), fmaxf(hacc[nb][3] + bb, 0.f));
      }
    }
    __syncthreads();   // hs complete; every warp is done with this W1 chunk
    if (j + 1 < j_end) load_w1(j + 1);
    cp_async_commit();   // empty after the last chunk, so the wait below stays uniform
    cp_async_wait<1>();  // this W2 chunk has landed; the next W1 chunk may not have
    __syncthreads();

    // 2. y += h W2[:, chunk]^T
#pragma unroll
    for (int kk = 0; kk < kTcHidden / 16; ++kk) {
      uint32_t a[4][4];
#pragma unroll
      for (int rb = 0; rb < 4; ++rb) ldmatrix_x4(a[rb], frag_a_row(hs, S::HS, 16 * rb, 16 * kk, lane));
#pragma unroll
      for (int p = 0; p < kNB / 2; ++p) {
        uint32_t bq[4];
        ldmatrix_x4(bq, frag_b_row(w2s, S::W2S, warp * kNW + 16 * p, 16 * kk, lane));
#pragma unroll
        for (int rb = 0; rb < 4; ++rb) {
          mma_bf16(y[rb][2 * p], a[rb], bq[0], bq[1]);
          mma_bf16(y[rb][2 * p + 1], a[rb], bq[2], bq[3]);
        }
      }
    }
    __syncthreads();   // every warp is done with hs and this W2 chunk
  }
  cp_async_wait<0>();

  if (partial != nullptr) {   // one shard of the hidden width: its f32 partial y, real rows only
    float* part = partial + ((size_t)blockIdx.y * N + row0) * C;
#pragma unroll
    for (int rb = 0; rb < 4; ++rb)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 16 * rb + g + 8 * half;
        if (row0 + r >= N) continue;
#pragma unroll
        for (int nb = 0; nb < kNB; ++nb)
          *reinterpret_cast<float2*>(part + (size_t)r * C + warp * kNW + 8 * nb + 2 * t) =
              make_float2(y[rb][nb][2 * half], y[rb][nb][2 * half + 1]);
      }
    return;
  }

  // + b2 + x, then the LayerNorm over each row; a lane holds rows 16 rb + g
  // and 16 rb + g + 8 (rb < 4) at 2 kNB columns of the warp's slice
#pragma unroll
  for (int rb = 0; rb < 4; ++rb)
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
      const int col = warp * kNW + 8 * nb + 2 * t;
      const float ba = __bfloat162float(b2[col]), bb = __bfloat162float(b2[col + 1]);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(
            xs + (16 * rb + g + 8 * half) * S::XS + col);
        y[rb][nb][2 * half] = (y[rb][nb][2 * half] + ba) + __low2float(xv);
        y[rb][nb][2 * half + 1] = (y[rb][nb][2 * half + 1] + bb) + __high2float(xv);
      }
    }
  // row sums of the warp's slice -> red[warp][row]; the block sums them in warp order
  auto row_totals = [&](float (&part)[4][2], float (&total)[4][2]) {
#pragma unroll
    for (int rb = 0; rb < 4; ++rb)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float s = quad_sum(part[rb][half]);
        if (t == 0) red[warp * kTcRows + 16 * rb + g + 8 * half] = s;
      }
    __syncthreads();
#pragma unroll
    for (int rb = 0; rb < 4; ++rb)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float s = 0.f;
        for (int w = 0; w < kWarps; ++w) s += red[w * kTcRows + 16 * rb + g + 8 * half];
        total[rb][half] = s;
      }
    __syncthreads();   // red is read by every lane before it is written again
  };
  float part[4][2], mean[4][2], sd[4][2];
#pragma unroll
  for (int rb = 0; rb < 4; ++rb)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float s = 0.f;
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb) s += y[rb][nb][2 * half] + y[rb][nb][2 * half + 1];
      part[rb][half] = s;
    }
  row_totals(part, mean);
#pragma unroll
  for (int rb = 0; rb < 4; ++rb)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      mean[rb][half] /= (float)C;
      float s = 0.f;
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb) {
        const float d0 = y[rb][nb][2 * half] - mean[rb][half];
        const float d1 = y[rb][nb][2 * half + 1] - mean[rb][half];
        s += d0 * d0 + d1 * d1;
      }
      part[rb][half] = s;
    }
  row_totals(part, sd);
#pragma unroll
  for (int rb = 0; rb < 4; ++rb)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 16 * rb + g + 8 * half;
      const float var = sd[rb][half] / (float)(C - 1);
      const float den = (var > 0.f ? sqrtf(var) : 0.f) + kLnEps;
      if (row0 + r >= N) continue;
      bf16* orow = out + (size_t)(row0 + r) * C;
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb) {
        const int col = warp * kNW + 8 * nb + 2 * t;
        const float o0 = gamma[col] * (y[rb][nb][2 * half] - mean[rb][half]) / den + beta[col];
        const float o1 =
            gamma[col + 1] * (y[rb][nb][2 * half + 1] - mean[rb][half]) / den + beta[col + 1];
        *reinterpret_cast<uint32_t*>(orow + col) = pack_bf16(o0, o1);
      }
    }
}

// The split path's second kernel, and the last of the products path in
// bf16 and at C above 512 (below): per row, y = the shards' partial sums in
// shard order, + b2 + x, then the LayerNorm; one warp a row, a lane owning
// the 4-column chunks 4 lane + 128 i (i < CMAX / 128; C <= CMAX, the columns
// from C on left out of every sum and store). The loads of kAhead shards are
// issued before any is added, so a row waits for ceil(n_split / kAhead)
// round trips to L2 and not n_split. No atomics: every run sums alike. With
// n_split 1 and T float or bf16 it is also the model axis's epilogue
// (savqa_ffn_epilogue): y there is the partials summed over the ranks. C a
// multiple of 4 moves 16 bytes of partials a load (and 16 or 8 of out a
// store); other widths load and store element by element.
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store1(float* p, float y) { *p = y; }
__device__ __forceinline__ void store1(bf16* p, float y) { *p = __float2bfloat16_rn(y); }

__device__ __forceinline__ void store4(bf16* p, const float (&y)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]));
}
__device__ __forceinline__ void store4(float* p, const float (&y)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(y[0], y[1], y[2], y[3]);
}

template <int CMAX, typename T>
__global__ void __launch_bounds__(kThreads)
ffn_ln_shard_sum_kernel(const float* __restrict__ partial, const T* __restrict__ x,
                        const T* __restrict__ b2, const float* __restrict__ gamma,
                        const float* __restrict__ beta, T* __restrict__ out, int N, int C,
                        int n_split) {
  constexpr int kChunks = CMAX / 128;
  constexpr int kAhead = CMAX <= 512 ? 4 : 1;   // wider: a lane's 32-64 sums and one shard's loads
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= N) return;
  const bool vec = (C & 3) == 0;
  float v[kChunks][4];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) v[i][0] = v[i][1] = v[i][2] = v[i][3] = 0.f;
  for (int sp0 = 0; sp0 < n_split; sp0 += kAhead) {
    float4 p[kAhead][kChunks];
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
#pragma unroll
      for (int i = 0; i < kChunks; ++i)
        if (sp0 + u < n_split) {
          const int c = 4 * lane + 128 * i;
          const float* src = partial + ((size_t)(sp0 + u) * N + row) * C + c;
          if (vec && c + 4 <= C) {
            p[u][i] = *reinterpret_cast<const float4*>(src);
          } else {
            p[u][i].x = c < C ? src[0] : 0.f;
            p[u][i].y = c + 1 < C ? src[1] : 0.f;
            p[u][i].z = c + 2 < C ? src[2] : 0.f;
            p[u][i].w = c + 3 < C ? src[3] : 0.f;
          }
        }
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
#pragma unroll
      for (int i = 0; i < kChunks; ++i)
        if (sp0 + u < n_split) {
          v[i][0] += p[u][i].x;
          v[i][1] += p[u][i].y;
          v[i][2] += p[u][i].z;
          v[i][3] += p[u][i].w;
        }
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kChunks; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 4 * lane + 128 * i + e;
      if (c < C) {
        v[i][e] = (v[i][e] + to_f(b2[c])) + to_f(x[(size_t)row * C + c]);
        s += v[i][e];
      }
    }
  const float mean = warp_sum(s) / (float)C;
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kChunks; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (4 * lane + 128 * i + e < C) ss += (v[i][e] - mean) * (v[i][e] - mean);
  const float var = warp_sum(ss) / (float)max(C - 1, 1);
  const float sd = var > 0.f ? sqrtf(var) : 0.f;
  T* orow = out + (size_t)row * C;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = 4 * lane + 128 * i;
    if (c >= C) continue;
    float y[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      y[e] = c + e < C ? gamma[c + e] * (v[i][e] - mean) / (sd + kLnEps) + beta[c + e] : 0.f;
    if (vec && c + 4 <= C) {
      store4(orow + c, y);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e < C) store1(orow + c + e, y[e]);
    }
  }
}

// The sum of a value over the block's 256 threads, the warps' sums added in
// warp order (every thread gets it). red: kWarps floats of shared memory,
// free again when every thread has returned.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();   // the readers of red's last use are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += red[w];
  return t;
}

// C above 2,048 (kMaxLaneC), where a warp's lanes cannot hold a row: one
// block of 256 threads a row, thread t owning the columns t + 256 i. y =
// the shards' partials in shard order, + b2 + x, then the reference
// LayerNorm of the shard-sum kernel (mean; sum of squared deviations over
// C - 1; std 0 where the variance is 0; 1e-8 on the std). Three passes over
// the row: where C floats fit a block's shared memory (C up to kRowStage) y
// is staged there in the first; above that each pass forms y again from the
// partials (they are L2 hits at the row's size). Any C, any n_split.
constexpr int kMaxLaneC = 2048;   // the shard-sum kernel's widest instance
constexpr int kRowStage = 57344;  // floats of a row staged in shared memory, at most

template <typename T>
__global__ void __launch_bounds__(kThreads)
ffn_ln_row_kernel(const float* __restrict__ partial, const T* __restrict__ x,
                  const T* __restrict__ b2, const float* __restrict__ gamma,
                  const float* __restrict__ beta, T* __restrict__ out, int N, int C,
                  int n_split, int staged) {
  extern __shared__ __align__(16) float ys[];
  __shared__ float red[kWarps];
  const size_t at = (size_t)blockIdx.x * C;
  const size_t shard = (size_t)N * C;
  auto y_at = [&](int c) {
    float v = partial[at + c];
    for (int sp = 1; sp < n_split; ++sp) v += partial[sp * shard + at + c];
    return (v + to_f(b2[c])) + to_f(x[at + c]);
  };
  float s = 0.f;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float v = y_at(c);
    if (staged) ys[c] = v;
    s += v;
  }
  const float mean = block_sum(s, red) / (float)C;
  float ss = 0.f;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float d = (staged ? ys[c] : y_at(c)) - mean;
    ss += d * d;
  }
  const float var = block_sum(ss, red) / (float)max(C - 1, 1);
  const float sd = var > 0.f ? sqrtf(var) : 0.f;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float v = staged ? ys[c] : y_at(c);
    store1(out + at + c, gamma[c] * (v - mean) / (sd + kLnEps) + beta[c]);
  }
}

// The shard-sum kernel at the narrowest CMAX (128, 256, 512, 1,024 or
// 2,048) that holds C; above 2,048 the row kernel.
template <typename T>
cudaError_t launch_shard_sum(const float* partial, const T* x, const T* b2, const float* gamma,
                             const float* beta, T* out, int N, int C, int n_split,
                             cudaStream_t stream) {
  if (C > kMaxLaneC) {
    const int staged = C <= kRowStage;
    const size_t smem = staged ? sizeof(float) * C : 0;
    cudaError_t err = cudaFuncSetAttribute(ffn_ln_row_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    ffn_ln_row_kernel<T><<<N, kThreads, smem, stream>>>(partial, x, b2, gamma, beta, out, N, C,
                                                        n_split, staged);
    return cudaGetLastError();
  }
  const int blocks = (N + kWarps - 1) / kWarps;
  auto kernel = C <= 128 ? ffn_ln_shard_sum_kernel<128, T>
              : C <= 256 ? ffn_ln_shard_sum_kernel<256, T>
              : C <= 512 ? ffn_ln_shard_sum_kernel<512, T>
              : C <= 1024 ? ffn_ln_shard_sum_kernel<1024, T> : ffn_ln_shard_sum_kernel<2048, T>;
  kernel<<<blocks, kThreads, 0, stream>>>(partial, x, b2, gamma, beta, out, N, C, n_split);
  return cudaGetLastError();
}

// The model axis's sum of this rank's own hidden shards (bf16): out = the
// n_split partials added in shard order, element by element.
__global__ void __launch_bounds__(kThreads)
ffn_partial_sum_kernel(const float* __restrict__ partial, float* __restrict__ out,
                       size_t n, int n_split) {
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (size_t)gridDim.x * kThreads) {
    float v = partial[i];
    for (int sp = 1; sp < n_split; ++sp) v += partial[(size_t)sp * n + i];
    out[i] = v;
  }
}

// The f32 products path's last kernel at C up to 512: per row, y (one
// shard, a k-ascending FMA chain over the whole hidden width) + b2 + x,
// then the LayerNorm; one warp a row, lane l owning the columns l + 32 t (t
// < CMAX / 32, those from C on left out), the sums taken over t in order.
// These are the sums, in their order, of the f32 SIMT kernel this path
// replaced (ffn_ln_f32_kernel, 32 rows a block): f32 results at C 128, 256
// and 512 are the same bits as that kernel's, only faster.
template <int CMAX>
__global__ void __launch_bounds__(kThreads)
ffn_ln_f32_epilogue_kernel(const float* __restrict__ y, const float* __restrict__ x,
                           const float* __restrict__ b2, const float* __restrict__ gamma,
                           const float* __restrict__ beta, float* __restrict__ out, int N,
                           int C) {
  constexpr int kCols = CMAX / 32;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= N) return;
  const float* yr = y + (size_t)row * C;
  const float* xr = x + (size_t)row * C;
  float v[kCols];
  float s = 0.f;
#pragma unroll
  for (int t = 0; t < kCols; ++t) {
    const int c = lane + 32 * t;
    if (c < C) {
      v[t] = (yr[c] + b2[c]) + xr[c];
      s += v[t];
    }
  }
  const float mean = warp_sum(s) / (float)C;
  float ss = 0.f;
#pragma unroll
  for (int t = 0; t < kCols; ++t) {
    if (lane + 32 * t < C) {
      const float d = v[t] - mean;
      ss += d * d;
    }
  }
  const float var = warp_sum(ss) / (float)max(C - 1, 1);
  const float sd = var > 0.f ? sqrtf(var) : 0.f;
  float* orow = out + (size_t)row * C;
#pragma unroll
  for (int t = 0; t < kCols; ++t) {
    const int c = lane + 32 * t;
    if (c < C) orow[c] = gamma[c] * (v[t] - mean) / (sd + kLnEps) + beta[c];
  }
}

// ------------------------------------------------------- the products path
//
// float32 at every C and bf16 at every C but the row tile's
// (ops/fused_ffn.py:ffn_path "products"), three kernels counted as one
// launch:
//   1. hidden = relu(x W1^T + b1), (N, Hd) in x's type, into scratch;
//   2. y_s = hidden[:, shard s] W2[:, shard s]^T for each of n_split shards
//      of the hidden width, (n_split, N, C) f32, into scratch;
//   3. + b2 + x and the LayerNorm: ffn_ln_f32_epilogue_kernel (above) for
//      f32 at C <= 512, which takes one shard; else ffn_ln_shard_sum_kernel,
//      the shards summed in order first. The model axis's partial
//      entry ends after stage 2 instead (one shard written straight into
//      its output, or ffn_partial_sum_kernel over several).
// In f32 at C <= 512 both products are one k-ascending FMA chain per
// output and the LayerNorm sums as the replaced f32 SIMT kernel did: this
// path gives that kernel's results bit for bit, so every f32 check of the
// port holds as it held.
// Stages 1 and 2 are the same kernel: C = A B^T over one shard of k, A (M,
// K) and B (N, K) both K-contiguous (nn.Linear's layout, and the hidden
// scratch's), one tile of C a block of 256 threads, the k slices of A and
// B streamed through a cp.async ring with one barrier a stage. Rows past M,
// columns past N and k past the shard's end (K or the hidden width need be
// no multiple of a stage's k) are zero-filled on the way in, and nothing
// past M or N is stored; the zeros add exact zeros to every sum, so a width
// that fills its tiles sums as before.
//
// What bounds it: FMAs. Both products are GEMMs far above the ridge, and
// f32 has no tensor-core form that keeps 1e-4. What the design does about
// it: 128 x 128 tiles (f32 also 64 x 128) read each operand once per tile,
// not once per 32 rows as a fused block of rows would; register blocking
// gives 4 FMAs per shared word; and the card is kept full with few rows by
// two choices the wrapper makes from the shapes (ops/fused_ffn.py:
// products_plan, estimated from scripts/k3_variants.py's times): the tile
// height and, in bf16, the shards of the hidden width over blocks in stage
// 2 (C 2,048 at 3,136 rows: 2). f32 takes one shard at C <= 512 (above)
// and shards of 1,024 columns above C 512 (8 at C 2,048's 4C).
// f32 reaches about 42 TFLOP/s of the 67 at 16,384 rows, C 512 (H100 SXM).
//
// f32 (ffn_ln_simt_product_kernel<BM>): FFMA on the CUDA cores. A stage
// holds kSK k of A and of B k-major (a k: BM or 128 floats + 4 of
// padding); thread (ty, tx) owns rows 4 ty + {0..3} (BM 128: and 64 + those)
// and columns 4 tx + {0..3, 64..67} of the tile, and per k reads them as
// float4 loads: 64 FMAs for 16 shared words, and the rows' words a warp
// reads are one broadcast. The copies are 4-byte cp.async so that they can
// transpose, a warp's lanes on one row's contiguous k. Two stages of 32 k
// (BM 64: 16) measured faster than three or than 16 k.
//
// bf16 (ffn_ln_mma_product_kernel): mma.sync m16n8k16 as K2 and K4-K6. A
// stage holds 64 k of 128 rows of A and of B, row-major (72 bf16 a row,
// conflict-free ldmatrix), three stages; warp (wm, wn) owns rows 64 wm ..
// 64 wm + 63 and columns 32 wn .. 32 wn + 31: per 16 k, 4 + 2 ldmatrix_x4
// feed 16 mma.

constexpr int kTile = 128;      // columns of a block's tile of C, and rows in bf16
constexpr int kEpiHidden = 0;   // C = relu(A B^T + bias) in A's type
constexpr int kEpiPartial = 1;  // C = A B^T in f32, shard blockIdx.z at z * split_stride

constexpr int kHK = 64;                          // bf16: k a stage
constexpr int kHLd = kHK + 8;                    // bf16: elements a row (144 bytes)
constexpr int kHStage = 2 * kTile * kHLd;        // bf16: elements a stage, A then B
constexpr int kMmaStages = 3;                    // bf16: depth of the cp.async ring
constexpr size_t kMmaSmem = (size_t)kMmaStages * kHStage * sizeof(bf16);   // 110,592

// f32, by the rows BM of the A tile: k a stage; floats a k of the k-major A
// and B tiles, each padded by 4; floats a stage; bytes of the ring.
constexpr int kSimtStages = 2;                   // f32: depth of the cp.async ring
__host__ __device__ constexpr int simt_k(int bm) { return bm == 64 ? 16 : 32; }
__host__ __device__ constexpr int simt_ald(int bm) { return bm + 4; }
constexpr int kSBLd = kTile + 4;
__host__ __device__ constexpr int simt_stage(int bm) { return simt_k(bm) * (simt_ald(bm) + kSBLd); }
constexpr size_t simt_smem(int bm) { return (size_t)kSimtStages * simt_stage(bm) * sizeof(float); }

template <int BM, int EPI>
__global__ void __launch_bounds__(kThreads, 2)
ffn_ln_simt_product_kernel(const float* __restrict__ A, const float* __restrict__ B,
                           const float* __restrict__ bias, float* __restrict__ out, int M,
                           int N, int K, int k_split, size_t split_stride) {
  constexpr int kSK = simt_k(BM);
  constexpr int kALd = simt_ald(BM);
  constexpr int TM = BM / 16;             // rows a thread: 4 ty + {0..3} (and 64 + those)
  extern __shared__ __align__(16) float sp_smem[];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kTile;
  const int k_begin = blockIdx.z * k_split;
  const int k_end = min(K, k_begin + k_split);
  const int steps = (k_end - k_begin + kSK - 1) / kSK;

  // element tid + 256 i of a rows x kSK slice: row tid / kSK + kPass i, k
  // tid % kSK, so that a warp's copies read whole rows' contiguous k (a
  // warp that spread over 8 rows x 4 k, free of bank conflicts, was
  // slower). Offsets are 32-bit from the block's first row of A and of B
  // (a tile of 128 rows of K: the entry refuses K above 2^31 / 128),
  // stepped by kPass rows, so that a stage's copies hold few registers.
  constexpr int kPass = kThreads / kSK;   // rows a pass of the block copies
  const int cr = tid / kSK, ck = tid % kSK;
  const int a_left = M - m0 - cr, b_left = N - n0 - cr;   // rows left below this thread's first
  A += (size_t)m0 * K;
  B += (size_t)n0 * K;
  const int a_first = cr * K + k_begin + ck, b_first = cr * K + k_begin + ck;
  const int row_step = kPass * K;
  auto load = [&](int stage, int step) {
    float* as = sp_smem + stage * simt_stage(BM) + ck * kALd + cr;
    float* bs = sp_smem + stage * simt_stage(BM) + kSK * kALd + ck * kSBLd + cr;
    int ao = a_first + step * kSK, bo = b_first + step * kSK;
    const bool kv = k_begin + step * kSK + ck < k_end;
#pragma unroll
    for (int i = 0; i < kTile / kPass; ++i, ao += row_step, bo += row_step) {
      const bool va = kv && kPass * i < a_left, vb = kv && kPass * i < b_left;
      if (kPass * i < BM) cp_async4(as + kPass * i, A + (va ? ao : 0), va);
      cp_async4(bs + kPass * i, B + (vb ? bo : 0), vb);
    }
  };

  const int ty = tid >> 4, tx = tid & 15;
  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kSimtStages - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kSimtStages - 2>();   // this step's slices have landed
    __syncthreads();                // and every warp is done with the step before's
    if (step + kSimtStages - 1 < steps) load((step + kSimtStages - 1) % kSimtStages, step + kSimtStages - 1);
    cp_async_commit();              // empty at the tail, so the wait above stays uniform
    const float* as = sp_smem + (step % kSimtStages) * simt_stage(BM);
    const float* bs = as + kSK * kALd;
#pragma unroll
    for (int kk = 0; kk < kSK; ++kk) {
      float a[TM], b[8];
#pragma unroll
      for (int h = 0; h < TM / 4; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(as + kk * kALd + 64 * h + 4 * ty);
        a[4 * h] = v.x, a[4 * h + 1] = v.y, a[4 * h + 2] = v.z, a[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(bs + kk * kSBLd + 64 * h + 4 * tx);
        b[4 * h] = v.x, b[4 * h + 1] = v.y, b[4 * h + 2] = v.z, b[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  float* o = out + (size_t)blockIdx.z * split_stride;
  float bb[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + 4 * tx + (j < 4 ? j : 60 + j);
    bb[j] = EPI == kEpiHidden && col < N ? bias[col] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + 4 * ty + (i < 4 ? i : 60 + i);
    if (row >= M) continue;
#pragma unroll
    for (int jh = 0; jh < 2; ++jh) {
      const int col = n0 + 64 * jh + 4 * tx;
      if (col >= N) continue;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = acc[i][4 * jh + e];
        if (EPI == kEpiHidden) v[e] = fmaxf(v[e] + bb[4 * jh + e], 0.f);
      }
      float* dst = o + (size_t)row * N + col;
      if ((N & 3) == 0 && col + 4 <= N) {
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < N) dst[e] = v[e];
      }
    }
  }
}

// VEC: K is a multiple of 8 and A, B are 16-byte aligned, so the slices
// move by 16-byte cp.async; else element by element (plain loads and
// shared stores, which the barrier of the step that reads them orders).
template <int EPI, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
ffn_ln_mma_product_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                          const bf16* __restrict__ bias, void* __restrict__ out, int M, int N,
                          int K, int k_split, size_t split_stride) {
  extern __shared__ __align__(16) unsigned char mp_smem[];
  bf16* base = reinterpret_cast<bf16*>(mp_smem);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int k_begin = blockIdx.z * k_split;
  const int k_end = min(K, k_begin + k_split);
  const int steps = (k_end - k_begin + kHK - 1) / kHK;

  // 16-byte chunk tid + 256 i of a 128 x kHK slice: row tid / (kHK / 8) +
  // kPass i, k 8 (tid % (kHK / 8))
  constexpr int kPass = kThreads / (kHK / 8);   // rows a pass of the block copies
  const int cr = tid / (kHK / 8), cc = tid % (kHK / 8) * 8;
  auto load = [&](int stage, int step) {
    bf16* as = base + stage * kHStage;
    bf16* bs = as + kTile * kHLd;
    const int k = k_begin + step * kHK + cc;
#pragma unroll
    for (int i = 0; i < kTile / kPass; ++i) {
      const int r = cr + kPass * i;
      if constexpr (VEC) {   // k_end is a multiple of 8: a chunk is all in or all out
        const bool va = k < k_end && m0 + r < M, vb = k < k_end && n0 + r < N;
        cp_async16(as + r * kHLd + cc, va ? A + (size_t)(m0 + r) * K + k : A, va);
        cp_async16(bs + r * kHLd + cc, vb ? B + (size_t)(n0 + r) * K + k : B, vb);
      } else {
        const bf16 zero = __float2bfloat16_rn(0.f);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const bool ke = k + e < k_end;
          as[r * kHLd + cc + e] = ke && m0 + r < M ? A[(size_t)(m0 + r) * K + k + e] : zero;
          bs[r * kHLd + cc + e] = ke && n0 + r < N ? B[(size_t)(n0 + r) * K + k + e] : zero;
        }
      }
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) acc[i][nb][0] = acc[i][nb][1] = acc[i][nb][2] = acc[i][nb][3] = 0.f;

#pragma unroll
  for (int s = 0; s < kMmaStages - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kMmaStages - 2>();
    __syncthreads();
    if (step + kMmaStages - 1 < steps) load((step + kMmaStages - 1) % kMmaStages, step + kMmaStages - 1);
    cp_async_commit();
    const bf16* as = base + (step % kMmaStages) * kHStage;
    const bf16* bs = as + kTile * kHLd;
#pragma unroll
    for (int kk = 0; kk < kHK; kk += 16) {
      uint32_t af[4][4], bq[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ldmatrix_x4(af[i], frag_a_row(as, kHLd, 64 * wm + 16 * i, kk, lane));
#pragma unroll
      for (int p = 0; p < 2; ++p) ldmatrix_x4(bq[p], frag_b_row(bs, kHLd, 32 * wn + 16 * p, kk, lane));
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          mma_bf16(acc[i][2 * p], af[i], bq[p][0], bq[p][1]);
          mma_bf16(acc[i][2 * p + 1], af[i], bq[p][2], bq[p][3]);
        }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int nb = 0; nb < 4; ++nb) {
    const int col = n0 + 32 * wn + 8 * nb + 2 * t;
    if (col >= N) continue;
    const bool two = col + 1 < N;             // the pair's second column is real
    const bool packed = two && (N & 1) == 0;  // and the pair is one aligned store
    float ba = 0.f, bb = 0.f;
    if (EPI == kEpiHidden) {
      ba = __bfloat162float(bias[col]);
      if (two) bb = __bfloat162float(bias[col + 1]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + 64 * wm + 16 * i + g + 8 * half;
        if (row >= M) continue;
        const float c0 = acc[i][nb][2 * half], c1 = acc[i][nb][2 * half + 1];
        if (EPI == kEpiHidden) {
          bf16* dst = static_cast<bf16*>(out) + (size_t)row * N + col;
          const float h0 = fmaxf(c0 + ba, 0.f), h1 = fmaxf(c1 + bb, 0.f);
          if (packed) {
            *reinterpret_cast<uint32_t*>(dst) = pack_bf16(h0, h1);
          } else {
            dst[0] = __float2bfloat16_rn(h0);
            if (two) dst[1] = __float2bfloat16_rn(h1);
          }
        } else {
          float* dst = static_cast<float*>(out) + (size_t)blockIdx.z * split_stride +
                       (size_t)row * N + col;
          if (packed) {
            *reinterpret_cast<float2*>(dst) = make_float2(c0, c1);
          } else {
            dst[0] = c0;
            if (two) dst[1] = c1;
          }
        }
      }
  }
}

// Stage 1 or 2 of the products path: C (M, N) = A (M, K) B (N, K)^T in
// tiles of tile_rows x 128 (f32: 64 or 128 rows; bf16: 128), the k range
// cut into shards of k_split along blockIdx.z.
template <int BM, int EPI>
cudaError_t launch_simt(const float* A, const float* B, const float* bias, void* out, int M,
                        int N, int K, int k_split, int n_split, size_t split_stride,
                        cudaStream_t stream) {
  constexpr size_t smem = simt_smem(BM);
  cudaError_t err = cudaFuncSetAttribute(ffn_ln_simt_product_kernel<BM, EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kTile - 1) / kTile, (M + BM - 1) / BM, n_split);
  ffn_ln_simt_product_kernel<BM, EPI><<<grid, kThreads, smem, stream>>>(
      A, B, bias, static_cast<float*>(out), M, N, K, k_split, split_stride);
  return cudaGetLastError();
}

template <int EPI>
cudaError_t launch_product(const float* A, const float* B, const float* bias, void* out, int M,
                           int N, int K, int k_split, int n_split, size_t split_stride,
                           int tile_rows, cudaStream_t stream) {
  if (tile_rows == 64)
    return launch_simt<64, EPI>(A, B, bias, out, M, N, K, k_split, n_split, split_stride, stream);
  if (tile_rows == 128)
    return launch_simt<128, EPI>(A, B, bias, out, M, N, K, k_split, n_split, split_stride, stream);
  return cudaErrorInvalidValue;
}

template <int EPI>
cudaError_t launch_product(const bf16* A, const bf16* B, const bf16* bias, void* out, int M,
                           int N, int K, int k_split, int n_split, size_t split_stride,
                           int tile_rows, cudaStream_t stream) {
  if (tile_rows != kTile) return cudaErrorInvalidValue;
  const bool vec = K % 8 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(B) % 16 == 0;
  auto kernel = vec ? ffn_ln_mma_product_kernel<EPI, true> : ffn_ln_mma_product_kernel<EPI, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kMmaSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile, n_split);
  kernel<<<grid, kThreads, kMmaSmem, stream>>>(A, B, bias, out, M, N, K, k_split, split_stride);
  return cudaGetLastError();
}

// Stages 1 and 2: hidden (N, Hd) in T, then y (n_split, N, C) f32.
template <typename T>
cudaError_t launch_products(const void* x, const void* w1, const void* b1, const void* w2,
                            void* hidden, float* y, int N, int C, int Hd, int n_split,
                            int per_split, int tile_rows, cudaStream_t stream) {
  const T* h = static_cast<const T*>(hidden);
  cudaError_t err = launch_product<kEpiHidden>(static_cast<const T*>(x),
                                               static_cast<const T*>(w1),
                                               static_cast<const T*>(b1), hidden, N, Hd, C, C,
                                               1, 0, tile_rows, stream);
  if (err != cudaSuccess) return err;
  return launch_product<kEpiPartial>(h, static_cast<const T*>(w2), static_cast<const T*>(nullptr),
                                     y, N, C, Hd, per_split * kHidden, n_split, (size_t)N * C,
                                     tile_rows, stream);
}

template <typename T>
cudaError_t launch_products_ln(const void* x, const void* w1, const void* b1, const void* w2,
                               const void* b2, const float* gamma, const float* beta, void* out,
                               void* hidden, float* partial, int N, int C, int Hd, int n_split,
                               int per_split, int tile_rows, cudaStream_t stream) {
  cudaError_t err = launch_products<T>(x, w1, b1, w2, hidden, partial, N, C, Hd, n_split,
                                       per_split, tile_rows, stream);
  if (err != cudaSuccess) return err;
  if (std::is_same<T, float>::value && C <= 512 && n_split == 1) {
    const int blocks = (N + kWarps - 1) / kWarps;
    auto kernel = C <= 128 ? ffn_ln_f32_epilogue_kernel<128>
                : C <= 256 ? ffn_ln_f32_epilogue_kernel<256> : ffn_ln_f32_epilogue_kernel<512>;
    kernel<<<blocks, kThreads, 0, stream>>>(partial, static_cast<const float*>(x),
                                            static_cast<const float*>(b2), gamma, beta,
                                            static_cast<float*>(out), N, C);
    return cudaGetLastError();
  }
  return launch_shard_sum<T>(partial, static_cast<const T*>(x), static_cast<const T*>(b2), gamma,
                             beta, static_cast<T*>(out), N, C, n_split, stream);
}

// ----------------------------------------------------------------- launch

// Does a call take the bf16 row-tile kernel? (ops/fused_ffn.py:ffn_path)
bool row_tile(int dtype, int C, int Hd) {
  return dtype == 1 && (C == 128 || C == 256 || C == 384 || C == 512) && Hd % kHidden == 0;
}

// The row-tile kernel at C (shard partials into `partial` when n_split > 1).
template <int C>
cudaError_t launch_tc(const void* x, const void* w1, const void* b1, const void* w2,
                      const void* b2, const float* gamma, const float* beta, void* out,
                      float* partial, int N, int Hd, int n_split, int per_split,
                      cudaStream_t stream) {
  const size_t smem = TcSmem<C>::bytes;
  cudaError_t err = cudaFuncSetAttribute(ffn_ln_tc_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kTcRows - 1) / kTcRows, n_split);
  ffn_ln_tc_kernel<C><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
      static_cast<const bf16*>(w2), static_cast<const bf16*>(b2), gamma, beta,
      static_cast<bf16*>(out), partial, N, Hd, per_split);
  return cudaGetLastError();
}

cudaError_t launch_tc_c(int C, const void* x, const void* w1, const void* b1, const void* w2,
                        const void* b2, const float* gamma, const float* beta, void* out,
                        float* partial, int N, int Hd, int n_split, int per_split,
                        cudaStream_t stream) {
  auto run = C == 128 ? launch_tc<128> : C == 256 ? launch_tc<256>
           : C == 384 ? launch_tc<384> : launch_tc<512>;
  return run(x, w1, b1, w2, b2, gamma, beta, out, partial, N, Hd, n_split, per_split, stream);
}

// Does (n_split, per_split) cut the ceil(Hd / 64) hidden chunks into shards with none empty?
bool valid_split(int Hd, int n_split, int per_split) {
  const int chunks = (Hd + kHidden - 1) / kHidden;
  return Hd > 0 && n_split >= 1 && per_split >= 1 && (n_split - 1) * per_split < chunks &&
         n_split * per_split >= chunks;
}

// Do the f32 product kernel's 32-bit element offsets, counted from a tile's
// first row (128 rows of K = C or Hd), reach every element of its tile?
// (Every other offset is 64-bit.)
bool offsets_fit(int C, int Hd) {
  const long long width = C > Hd ? C : Hd;
  return (long long)kTile * width <= 0x7fffffffLL;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. C and Hd at least 1, 128 max(C, Hd)
// below 2^31;
// the row-tile kernel (bf16 at C 128, 256, 384 or 512 with Hd a multiple of
// 64) needs 16-byte aligned bf16 pointers, the products path takes any
// (bf16 operands copied element by element where their rows or pointers are
// not 16-byte aligned). The ceil(Hd / 64) hidden chunks are cut into n_split
// shards of per_split chunks, none empty ((n_split - 1) per_split <
// ceil(Hd / 64) <= n_split per_split). tile_rows: the rows of the products path's tiles, 64 or 128 in f32,
// 128 in bf16 (unused by the row-tile kernel).
//   the row-tile kernel: hidden is unused (may be null); with n_split > 1
//     partial is (n_split, N, C) f32 scratch, else unused.
//   the products path: hidden is (N, Hd) scratch in x's type and partial
//     (n_split, N, C) f32 scratch, both required.
// Returns cudaGetLastError() after the launches (0 = success).
extern "C" int savqa_ffn_ln(const void* x, const void* w1, const void* b1, const void* w2,
                            const void* b2, const void* gamma, const void* beta, void* out,
                            void* hidden, void* partial, int N, int C, int Hd, int dtype,
                            int n_split, int per_split, int tile_rows, void* stream) {
  const bool tc = row_tile(dtype, C, Hd);
  if (N <= 0 || C <= 0 || (dtype != 0 && dtype != 1) ||
      !valid_split(Hd, n_split, per_split) || !offsets_fit(C, Hd) ||
      (!tc && (hidden == nullptr || partial == nullptr)) || (n_split > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  const auto* ga = static_cast<const float*>(gamma);
  const auto* be = static_cast<const float*>(beta);
  auto* pa = static_cast<float*>(partial);
  auto s = static_cast<cudaStream_t>(stream);
  if (tc) {
    cudaError_t err = launch_tc_c(C, x, w1, b1, w2, b2, ga, be, out, n_split > 1 ? pa : nullptr,
                                  N, Hd, n_split, per_split, s);
    if (err != cudaSuccess || n_split == 1) return (int)err;
    return (int)launch_shard_sum<bf16>(pa, static_cast<const bf16*>(x),
                                       static_cast<const bf16*>(b2), ga, be,
                                       static_cast<bf16*>(out), N, C, n_split, s);
  }
  if (dtype == 0)
    return (int)launch_products_ln<float>(x, w1, b1, w2, b2, ga, be, out, hidden, pa, N, C, Hd,
                                          n_split, per_split, tile_rows, s);
  return (int)launch_products_ln<bf16>(x, w1, b1, w2, b2, ga, be, out, hidden, pa, N, C, Hd,
                                       n_split, per_split, tile_rows, s);
}

// The model axis (ops/fused_ffn.py:ffn_partial): out = relu(x W1^T + b1)
// W2^T, (N, C) f32, for this rank's shard of the hidden width (W1 (Hd, C),
// b1 (Hd,), W2 (C, Hd) of the shard), h rounded to x's type as in
// savqa_ffn_ln; no b2, residual or LayerNorm. C and Hd as savqa_ffn_ln's. The
// ceil(Hd / 64) chunks may be cut into n_split shards over blocks as in
// savqa_ffn_ln, their partials in scratch ((n_split, N, C) f32) summed in
// shard order into out; with n_split 1 scratch is unused (may be null).
// The row-tile kernel (bf16 at its widths) leaves hidden and tile_rows
// unused (hidden may be null); the products path (f32, and bf16 at other
// widths) runs in tiles of tile_rows and needs hidden ((N, Hd) scratch in
// x's type).
extern "C" int savqa_ffn_partial(const void* x, const void* w1, const void* b1, const void* w2,
                                 void* hidden, void* scratch, void* out, int N, int C, int Hd,
                                 int dtype, int n_split, int per_split, int tile_rows,
                                 void* stream) {
  const bool tc = row_tile(dtype, C, Hd);
  if (N <= 0 || C <= 0 || (dtype != 0 && dtype != 1) ||
      !valid_split(Hd, n_split, per_split) || !offsets_fit(C, Hd) ||
      (n_split > 1 && scratch == nullptr) || (!tc && hidden == nullptr) || out == nullptr)
    return (int)cudaErrorInvalidValue;
  auto* sc = static_cast<float*>(scratch);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  float* y = n_split > 1 ? sc : o;
  cudaError_t err;
  if (tc)
    err = launch_tc_c(C, x, w1, b1, w2, nullptr, nullptr, nullptr, nullptr, y, N, Hd, n_split,
                      per_split, s);
  else if (dtype == 0)
    err = launch_products<float>(x, w1, b1, w2, hidden, y, N, C, Hd, n_split, per_split,
                                 tile_rows, s);
  else
    err = launch_products<bf16>(x, w1, b1, w2, hidden, y, N, C, Hd, n_split, per_split,
                                tile_rows, s);
  if (err != cudaSuccess || n_split == 1) return (int)err;
  const size_t n = (size_t)N * C;
  const size_t want = (n + kThreads - 1) / kThreads;
  const int blocks = want < 4 * 132 ? (int)want : 4 * 132;
  ffn_partial_sum_kernel<<<blocks, kThreads, 0, s>>>(sc, o, n, n_split);
  return (int)cudaGetLastError();
}

// The model axis's epilogue (ops/fused_ffn.py:ffn_epilogue): out = LN((y +
// b2) + x) over rows, y (N, C) f32 the partials summed over the ranks, x and
// b2 in out's type; the split path's shard-sum kernel with one shard (the
// row kernel above C 2,048). Any C.
extern "C" int savqa_ffn_epilogue(const void* y, const void* x, const void* b2,
                                  const void* gamma, const void* beta, void* out, int N, int C,
                                  int dtype, void* stream) {
  if (N <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const auto* yf = static_cast<const float*>(y);
  const auto* ga = static_cast<const float*>(gamma);
  const auto* be = static_cast<const float*>(beta);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_shard_sum<float>(yf, static_cast<const float*>(x),
                                        static_cast<const float*>(b2), ga, be,
                                        static_cast<float*>(out), N, C, 1, s);
  if (dtype == 1)
    return (int)launch_shard_sum<bf16>(yf, static_cast<const bf16*>(x),
                                       static_cast<const bf16*>(b2), ga, be,
                                       static_cast<bf16*>(out), N, C, 1, s);
  return (int)cudaErrorInvalidValue;
}
