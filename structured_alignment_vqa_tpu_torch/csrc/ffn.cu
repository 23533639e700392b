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
// What bounds it on an H100: operations. At 16,384 rows, C 512, bf16 it does
// 6.9e10 operations on ~37 MB (about 1,900 per byte, far above the ~295
// ridge); at the decoder's 128 rows the 4 MB of weights bound it instead.
// Far above either bound, what sets the bf16 path's time is the weight
// bytes every block streams from L2 and the shared-memory traffic of
// mma.sync's small tiles.
//
// Design. A block owns a tile of rows and walks the hidden width in chunks
// of 64: the chunk h = relu(x W1[chunk]^T + b1) is built on chip and never
// written to device memory, then y += h W2[:, chunk]^T is accumulated on
// chip, so the residual and the LayerNorm finish in the block. Every block
// reads both weight matrices once (from L2 after the first blocks).
//
// bf16 runs on the tensor cores (below). float32 has no tensor-core form
// that keeps f32 products, so it runs on CUDA cores: one block of 256
// threads per 32 rows, FMAs from shared-memory slices of W1 and W2, y in
// registers (each warp 4 whole rows). wgmma and TMA are not used.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "mma_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;       // rows per block
constexpr int kHidden = 64;     // hidden chunk
constexpr float kLnEps = 1e-8f;

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---------------------------------------------------------------- float32

constexpr int kRed = 32;        // C slice of W1 staged per step
constexpr int kRed2 = 16;       // hidden slice of W2 staged per step

template <int C>
constexpr size_t f32_smem_floats() {
  return (size_t)kRows * (C + 1)          // xs: the row tile
         + (size_t)kRows * (kHidden + 1)  // hs: the hidden chunk
         + (size_t)kRed * (kHidden + 1)   // w1s: W1 slice, transposed
         + (size_t)kRed2 * (C + 1);       // w2s: W2 slice, transposed
}

template <int C>
__global__ void __launch_bounds__(kThreads)
ffn_ln_f32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                  const float* __restrict__ b1, const float* __restrict__ w2,
                  const float* __restrict__ b2, const float* __restrict__ gamma,
                  const float* __restrict__ beta, float* __restrict__ out,
                  float* __restrict__ partial, int N, int Hd) {
  constexpr int XS = C + 1;
  constexpr int HS = kHidden + 1;
  constexpr int W1S = kHidden + 1;
  constexpr int W2S = C + 1;
  constexpr int kCols = C / 32;  // output columns per lane
  extern __shared__ float smem[];
  float* xs = smem;
  float* hs = xs + kRows * XS;
  float* w1s = hs + kRows * HS;
  float* w2s = w1s + kRed * W1S;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * kRows;

  for (int i = tid; i < kRows * C; i += kThreads) {
    const int r = i / C, c = i - r * C;
    xs[r * XS + c] = row0 + r < N ? x[(size_t)(row0 + r) * C + c] : 0.f;
  }

  // phase A mapping: rows 2*ay, 2*ay+1; hidden columns ax + 16*t
  const int ax = tid & 15;
  const int ay = tid >> 4;
  float y[4][kCols];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int t = 0; t < kCols; ++t) y[r][t] = 0.f;

  for (int j0 = 0; j0 < Hd; j0 += kHidden) {
    // h = relu(x W1[j0:j0+64]^T + b1)
    float hacc[2][4] = {};
    for (int k0 = 0; k0 < C; k0 += kRed) {
      __syncthreads();  // xs loaded; the previous slice's readers of w1s done
      for (int i = tid; i < kRed * kHidden; i += kThreads) {
        const int kk = i % kRed, jj = i / kRed;
        w1s[kk * W1S + jj] = w1[(size_t)(j0 + jj) * C + k0 + kk];
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kRed; ++kk) {
        const float a0 = xs[(2 * ay) * XS + k0 + kk];
        const float a1 = xs[(2 * ay + 1) * XS + k0 + kk];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float w = w1s[kk * W1S + ax + 16 * t];
          hacc[0][t] = fmaf(a0, w, hacc[0][t]);
          hacc[1][t] = fmaf(a1, w, hacc[1][t]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int jj = ax + 16 * t;
        hs[(2 * ay + r) * HS + jj] = fmaxf(hacc[r][t] + b1[j0 + jj], 0.f);
      }

    // y += h W2[:, j0:j0+64]^T; warp owns rows 4*warp..4*warp+3
    for (int k0 = 0; k0 < kHidden; k0 += kRed2) {
      __syncthreads();  // hs written; the previous slice's readers of w2s done
      for (int i = tid; i < kRed2 * C; i += kThreads) {
        const int kk = i % kRed2, n = i / kRed2;
        w2s[kk * W2S + n] = w2[(size_t)n * Hd + j0 + k0 + kk];
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kRed2; ++kk) {
        float a[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = hs[(4 * warp + r) * HS + k0 + kk];
#pragma unroll
        for (int t = 0; t < kCols; ++t) {
          const float w = w2s[kk * W2S + lane + 32 * t];
#pragma unroll
          for (int r = 0; r < 4; ++r) y[r][t] = fmaf(a[r], w, y[r][t]);
        }
      }
    }
  }

  if (partial != nullptr) {   // the model axis's partial y = h W2^T of this hidden shard
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = 4 * warp + r;
      if (row0 + row >= N) continue;
#pragma unroll
      for (int t = 0; t < kCols; ++t) partial[(size_t)(row0 + row) * C + lane + 32 * t] = y[r][t];
    }
    return;
  }

  // + b2 + x, then LayerNorm over the row; each warp holds its 4 rows whole
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = 4 * warp + r;
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < kCols; ++t) {
      const int c = lane + 32 * t;
      y[r][t] = (y[r][t] + b2[c]) + xs[row * XS + c];
      s += y[r][t];
    }
    const float mean = warp_sum(s) / (float)C;
    float ss = 0.f;
#pragma unroll
    for (int t = 0; t < kCols; ++t) {
      const float d = y[r][t] - mean;
      ss += d * d;
    }
    const float var = warp_sum(ss) / (float)(C - 1);
    const float sd = var > 0.f ? sqrtf(var) : 0.f;
    if (row0 + row < N) {
#pragma unroll
      for (int t = 0; t < kCols; ++t) {
        const int c = lane + 32 * t;
        out[(size_t)(row0 + row) * C + c] = gamma[c] * (y[r][t] - mean) / (sd + kLnEps) + beta[c];
      }
    }
  }
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

// The split path's second kernel: per row, y = the shards' partial sums in
// shard order, + b2 + x, then the LayerNorm; one warp a row, a lane owning
// the 4-column chunks 4 lane + 128 i. The loads of kAhead shards are issued
// before any is added, so a row waits for ceil(n_split / kAhead) round trips
// to L2 and not n_split. With n_split 1 and T float or bf16 it is also the
// model axis's epilogue (savqa_ffn_epilogue): y there is the partials summed
// over the ranks.
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store4(bf16* p, const float (&y)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]));
}
__device__ __forceinline__ void store4(float* p, const float (&y)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(y[0], y[1], y[2], y[3]);
}

template <int C, typename T>
__global__ void __launch_bounds__(kThreads)
ffn_ln_shard_sum_kernel(const float* __restrict__ partial, const T* __restrict__ x,
                        const T* __restrict__ b2, const float* __restrict__ gamma,
                        const float* __restrict__ beta, T* __restrict__ out, int N,
                        int n_split) {
  constexpr int kChunks = C / 128;
  constexpr int kAhead = 4;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= N) return;
  float v[kChunks][4];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) v[i][0] = v[i][1] = v[i][2] = v[i][3] = 0.f;
  for (int sp0 = 0; sp0 < n_split; sp0 += kAhead) {
    float4 p[kAhead][kChunks];
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
#pragma unroll
      for (int i = 0; i < kChunks; ++i)
        if (sp0 + u < n_split)
          p[u][i] = *reinterpret_cast<const float4*>(
              partial + ((size_t)(sp0 + u) * N + row) * C + 4 * lane + 128 * i);
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
      v[i][e] = (v[i][e] + to_f(b2[c])) + to_f(x[(size_t)row * C + c]);
      s += v[i][e];
    }
  const float mean = warp_sum(s) / (float)C;
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kChunks; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) ss += (v[i][e] - mean) * (v[i][e] - mean);
  const float var = warp_sum(ss) / (float)(C - 1);
  const float sd = var > 0.f ? sqrtf(var) : 0.f;
  T* orow = out + (size_t)row * C;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = 4 * lane + 128 * i;
    float y[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) y[e] = gamma[c + e] * (v[i][e] - mean) / (sd + kLnEps) + beta[c + e];
    store4(orow + c, y);
  }
}

// The model axis's sum of this rank's own hidden shards (ffn_split): out =
// the n_split partials added in shard order, element by element.
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

// ------------------------------------------------------------ wide rows
//
// C = 2048 (fusion_dec_mil2's alignment blocks run the FFN at the region
// features' width): a 64-row tile of x alone would take 256 KB of shared
// memory in bf16, so neither kernel above fits. This one keeps 8 rows a
// block as f32 in shared memory and works on CUDA cores in both dtypes
// (inputs widened to f32, h rounded to the input type before the second
// product, as the tensor-core path does): phase A forms the 8 x 64 hidden
// chunk, two rows and one hidden column a thread, from 32-wide slices of
// W1; phase B adds h W2[:, chunk]^T into y, warp w owning row w whole
// (64 columns a lane in registers), from 8-deep slices of W2; the warp
// then adds b2 and x and runs the LayerNorm on its row. Every block reads
// both weight matrices once (from L2 after the first blocks): slow, and
// right first (wgmma over column tiles is work for a later change).

constexpr int kWRows = 8;    // rows per block: one warp a row in phase B
constexpr int kWRed = 32;    // C slice of W1 staged per step
constexpr int kWRed2 = 8;    // hidden slice of W2 staged per step

template <int C>
constexpr size_t wide_smem_floats() {
  return (size_t)kWRows * C                  // xs: the row tile, f32
         + (size_t)kWRows * (kHidden + 1)    // hs: the hidden chunk
         + (size_t)kWRed * (kHidden + 1)     // w1s: W1 slice, transposed
         + (size_t)kWRed2 * C;               // w2s: W2 slice, transposed
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T narrow(float v);
template <> __device__ __forceinline__ float narrow<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 narrow<bf16>(float v) { return __float2bfloat16(v); }

template <int C, typename T>
__global__ void __launch_bounds__(kThreads)
ffn_ln_wide_kernel(const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ b1,
                   const T* __restrict__ w2, const T* __restrict__ b2,
                   const float* __restrict__ gamma, const float* __restrict__ beta,
                   T* __restrict__ out, int N, int Hd) {
  constexpr int HS = kHidden + 1;
  constexpr int kCols = C / 32;  // output columns per lane
  extern __shared__ float smem[];
  float* xs = smem;
  float* hs = xs + kWRows * C;
  float* w1s = hs + kWRows * HS;
  float* w2s = w1s + kWRed * HS;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * kWRows;
  for (int i = tid; i < kWRows * C; i += kThreads) {
    const int r = i / C, c = i - r * C;
    xs[i] = row0 + r < N ? widen(x[(size_t)(row0 + r) * C + c]) : 0.f;
  }
  const int jj = tid & (kHidden - 1);   // phase A: hidden column
  const int ar = 2 * (tid / kHidden);   // phase A: rows ar, ar + 1
  float y[kCols];
#pragma unroll
  for (int t = 0; t < kCols; ++t) y[t] = 0.f;

  for (int j0 = 0; j0 < Hd; j0 += kHidden) {
    float h0 = 0.f, h1 = 0.f;
    for (int k0 = 0; k0 < C; k0 += kWRed) {
      __syncthreads();  // xs loaded; the previous slice's readers of w1s done
      for (int i = tid; i < kWRed * kHidden; i += kThreads) {
        const int kk = i % kWRed, j = i / kWRed;
        w1s[kk * HS + j] = widen(w1[(size_t)(j0 + j) * C + k0 + kk]);
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kWRed; ++kk) {
        const float w = w1s[kk * HS + jj];
        h0 = fmaf(xs[ar * C + k0 + kk], w, h0);
        h1 = fmaf(xs[(ar + 1) * C + k0 + kk], w, h1);
      }
    }
    const float bb = widen(b1[j0 + jj]);
    hs[ar * HS + jj] = widen(narrow<T>(fmaxf(h0 + bb, 0.f)));
    hs[(ar + 1) * HS + jj] = widen(narrow<T>(fmaxf(h1 + bb, 0.f)));

    for (int k0 = 0; k0 < kHidden; k0 += kWRed2) {
      __syncthreads();  // hs written; the previous slice's readers of w2s done
      for (int i = tid; i < kWRed2 * C; i += kThreads) {
        const int kk = i % kWRed2, n = i / kWRed2;
        w2s[kk * C + n] = widen(w2[(size_t)n * Hd + j0 + k0 + kk]);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kWRed2; ++kk) {
        const float a = hs[warp * HS + k0 + kk];
#pragma unroll
        for (int t = 0; t < kCols; ++t) y[t] = fmaf(a, w2s[kk * C + lane + 32 * t], y[t]);
      }
    }
  }

  // + b2 + x, then the LayerNorm of row `warp`
  float s = 0.f;
#pragma unroll
  for (int t = 0; t < kCols; ++t) {
    const int c = lane + 32 * t;
    y[t] = (y[t] + widen(b2[c])) + xs[warp * C + c];
    s += y[t];
  }
  const float mean = warp_sum(s) / (float)C;
  float ss = 0.f;
#pragma unroll
  for (int t = 0; t < kCols; ++t) ss += (y[t] - mean) * (y[t] - mean);
  const float var = warp_sum(ss) / (float)(C - 1);
  const float sd = var > 0.f ? sqrtf(var) : 0.f;
  if (row0 + warp < N) {
#pragma unroll
    for (int t = 0; t < kCols; ++t) {
      const int c = lane + 32 * t;
      out[(size_t)(row0 + warp) * C + c] =
          narrow<T>(gamma[c] * (y[t] - mean) / (sd + kLnEps) + beta[c]);
    }
  }
}

// ----------------------------------------------------------------- launch

template <int C, typename T>
cudaError_t launch_wide(const void* x, const void* w1, const void* b1, const void* w2,
                        const void* b2, const float* gamma, const float* beta, void* out, int N,
                        int Hd, cudaStream_t stream) {
  const size_t smem = wide_smem_floats<C>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ffn_ln_wide_kernel<C, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ffn_ln_wide_kernel<C, T><<<(N + kWRows - 1) / kWRows, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(b2), gamma, beta, static_cast<T*>(out),
      N, Hd);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_f32(const void* x, const void* w1, const void* b1, const void* w2,
                       const void* b2, const float* gamma, const float* beta, void* out,
                       float* partial, int N, int Hd, cudaStream_t stream) {
  const size_t smem = f32_smem_floats<C>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ffn_ln_f32_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (N + kRows - 1) / kRows;
  ffn_ln_f32_kernel<C><<<blocks, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), gamma, beta, static_cast<float*>(out), partial, N, Hd);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_bf16(const void* x, const void* w1, const void* b1, const void* w2,
                        const void* b2, const float* gamma, const float* beta, void* out,
                        float* partial, int N, int Hd, int n_split, int per_split,
                        cudaStream_t stream) {
  const size_t smem = TcSmem<C>::bytes;
  cudaError_t err = cudaFuncSetAttribute(ffn_ln_tc_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const auto* xb = static_cast<const bf16*>(x);
  const auto* b2b = static_cast<const bf16*>(b2);
  auto* ob = static_cast<bf16*>(out);
  const dim3 grid((N + kTcRows - 1) / kTcRows, n_split);
  ffn_ln_tc_kernel<C><<<grid, kThreads, smem, stream>>>(
      xb, static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
      static_cast<const bf16*>(w2), b2b, gamma, beta, ob, partial, N, Hd, per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  ffn_ln_shard_sum_kernel<C, bf16><<<(N + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      partial, xb, b2b, gamma, beta, ob, N, n_split);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                   const float* gamma, const float* beta, void* out, float* partial, int N,
                   int Hd, int dtype, int n_split, int per_split, cudaStream_t stream) {
  if (dtype == 0)
    return launch_f32<C>(x, w1, b1, w2, b2, gamma, beta, out, nullptr, N, Hd, stream);
  if (dtype == 1)
    return launch_bf16<C>(x, w1, b1, w2, b2, gamma, beta, out, partial, N, Hd, n_split,
                          per_split, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. C must be 128, 256, 512 or 2048 (the
// wide kernel, both dtypes, n_split 1) and Hd a multiple of 64; bf16
// pointers must be 16-byte aligned. bf16 splits the
// Hd / 64 hidden chunks into n_split shards of per_split chunks, none empty
// ((n_split - 1) per_split < Hd / 64 <= n_split per_split); with n_split > 1,
// partial is (n_split, N, C) f32 scratch (else unused, may be null). f32
// takes n_split 1. Returns cudaGetLastError() after the launches (0 =
// success).
extern "C" int savqa_ffn_ln(const void* x, const void* w1, const void* b1, const void* w2,
                            const void* b2, const void* gamma, const void* beta, void* out,
                            void* partial, int N, int C, int Hd, int dtype, int n_split,
                            int per_split, void* stream) {
  const int chunks = Hd / kHidden;
  if (N <= 0 || Hd <= 0 || Hd % kHidden != 0 || n_split < 1 || per_split < 1 ||
      (n_split - 1) * per_split >= chunks || n_split * per_split < chunks ||
      ((dtype == 0 || C == 2048) && n_split != 1) || (n_split > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  const auto* ga = static_cast<const float*>(gamma);
  const auto* be = static_cast<const float*>(beta);
  // unsplit, the kernel finishes its rows itself (a null partial)
  auto* pa = n_split > 1 ? static_cast<float*>(partial) : nullptr;
  auto s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 128: return (int)launch<128>(x, w1, b1, w2, b2, ga, be, out, pa, N, Hd, dtype, n_split, per_split, s);
    case 256: return (int)launch<256>(x, w1, b1, w2, b2, ga, be, out, pa, N, Hd, dtype, n_split, per_split, s);
    case 512: return (int)launch<512>(x, w1, b1, w2, b2, ga, be, out, pa, N, Hd, dtype, n_split, per_split, s);
    case 2048:
      if (dtype == 0) return (int)launch_wide<2048, float>(x, w1, b1, w2, b2, ga, be, out, N, Hd, s);
      if (dtype == 1) return (int)launch_wide<2048, bf16>(x, w1, b1, w2, b2, ga, be, out, N, Hd, s);
      return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

namespace {

template <int C>
cudaError_t launch_partial(const void* x, const void* w1, const void* b1, const void* w2,
                           float* scratch, float* out, int N, int Hd, int dtype, int n_split,
                           int per_split, cudaStream_t stream) {
  if (dtype == 0)
    return launch_f32<C>(x, w1, b1, w2, nullptr, nullptr, nullptr, nullptr, out, N, Hd, stream);
  if (dtype != 1) return cudaErrorInvalidValue;
  const size_t smem = TcSmem<C>::bytes;
  cudaError_t err = cudaFuncSetAttribute(ffn_ln_tc_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kTcRows - 1) / kTcRows, n_split);
  ffn_ln_tc_kernel<C><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
      static_cast<const bf16*>(w2), nullptr, nullptr, nullptr, nullptr,
      n_split > 1 ? scratch : out, N, Hd, per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  const size_t n = (size_t)N * C;
  const size_t want = (n + kThreads - 1) / kThreads;
  const int blocks = want < 4 * 132 ? (int)want : 4 * 132;
  ffn_partial_sum_kernel<<<blocks, kThreads, 0, stream>>>(scratch, out, n, n_split);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_epilogue(const float* y, const void* x, const void* b2, const float* gamma,
                            const float* beta, void* out, int N, int dtype,
                            cudaStream_t stream) {
  const int blocks = (N + kWarps - 1) / kWarps;
  if (dtype == 0)
    ffn_ln_shard_sum_kernel<C, float><<<blocks, kThreads, 0, stream>>>(
        y, static_cast<const float*>(x), static_cast<const float*>(b2), gamma, beta,
        static_cast<float*>(out), N, 1);
  else if (dtype == 1)
    ffn_ln_shard_sum_kernel<C, bf16><<<blocks, kThreads, 0, stream>>>(
        y, static_cast<const bf16*>(x), static_cast<const bf16*>(b2), gamma, beta,
        static_cast<bf16*>(out), N, 1);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

// The model axis (ops/fused_ffn.py:ffn_partial): out = relu(x W1^T + b1)
// W2^T, (N, C) f32, for this rank's shard of the hidden width (W1 (Hd, C),
// b1 (Hd,), W2 (C, Hd) of the shard), h rounded to x's type as in
// savqa_ffn_ln; no b2, residual or LayerNorm. C 128, 256 or 512. bf16 may
// split its own Hd / 64 chunks into n_split shards as savqa_ffn_ln does,
// their partials in scratch ((n_split, N, C) f32) summed in shard order into
// out; with n_split 1 scratch is unused (may be null). f32 takes n_split 1.
extern "C" int savqa_ffn_partial(const void* x, const void* w1, const void* b1, const void* w2,
                                 void* scratch, void* out, int N, int C, int Hd, int dtype,
                                 int n_split, int per_split, void* stream) {
  const int chunks = Hd / kHidden;
  if (N <= 0 || Hd <= 0 || Hd % kHidden != 0 || n_split < 1 || per_split < 1 ||
      (n_split - 1) * per_split >= chunks || n_split * per_split < chunks ||
      (dtype == 0 && n_split != 1) || (n_split > 1 && scratch == nullptr) || out == nullptr)
    return (int)cudaErrorInvalidValue;
  auto* sc = static_cast<float*>(scratch);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 128: return (int)launch_partial<128>(x, w1, b1, w2, sc, o, N, Hd, dtype, n_split, per_split, s);
    case 256: return (int)launch_partial<256>(x, w1, b1, w2, sc, o, N, Hd, dtype, n_split, per_split, s);
    case 512: return (int)launch_partial<512>(x, w1, b1, w2, sc, o, N, Hd, dtype, n_split, per_split, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The model axis's epilogue (ops/fused_ffn.py:ffn_epilogue): out = LN((y +
// b2) + x) over rows, y (N, C) f32 the partials summed over the ranks, x and
// b2 in out's type; the split path's shard-sum kernel with one shard.
extern "C" int savqa_ffn_epilogue(const void* y, const void* x, const void* b2,
                                  const void* gamma, const void* beta, void* out, int N, int C,
                                  int dtype, void* stream) {
  if (N <= 0) return (int)cudaErrorInvalidValue;
  const auto* yf = static_cast<const float*>(y);
  const auto* ga = static_cast<const float*>(gamma);
  const auto* be = static_cast<const float*>(beta);
  auto s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 128: return (int)launch_epilogue<128>(yf, x, b2, ga, be, out, N, dtype, s);
    case 256: return (int)launch_epilogue<256>(yf, x, b2, ga, be, out, N, dtype, s);
    case 512: return (int)launch_epilogue<512>(yf, x, b2, ga, be, out, N, dtype, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
