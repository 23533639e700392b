// K1: fused graph-guided attention + residual + reference LayerNorm.
//
// Replaces the TPU kernel structured_alignment_vqa_tpu/ops/pallas_attention.py
// (_kernel, launched by _fused_forward, entry fused_graph_attention_ln).
//
// Per batch element b and query row i, over every head h (dh = C / H):
//   s_j  = <q_i^h, k_j^h> * scale, or -2^32+1 where key_mask[b, j] == 0
//   a_j  = softmax(s)_j * graph[b, i, j]
//   a_j /= max(sum |a|, 1e-12)        (renorm 0, "l1")
//   a_j /= sum a + 1e-7               (renorm 1, "sum_eps")
//   a_j *= query_mask[b, i], rounded to V's type
//   o^h  = sum_j a_j v_j^h            (f32 accumulation)
//   out_i = LN(o + residual_i): gamma (x - mean) / (std + 1e-8) + beta, std unbiased
//
// What bounds it on an H100: bytes in bf16. At the serving shapes (B 128,
// C 512, L <= 128, bf16) it does ~47 operations per byte read (Q, K, V,
// residual, the f32 graph, the output), below the card's ~295 bf16
// ops/byte ridge. In f32 the operations bound it (64 us at B 128, L 128 at
// the 67 TFLOP/s FFMA peak against ~53 us of bytes).
//
// Three designs, chosen by shape (ops/fused_graph_attention.py:k1_path):
// * bf16 with a head width that is a multiple of 16 (up to 256): the
//   tensor-core kernels below.
// * f32 with a head width that is a multiple of 4 (up to 128): a
//   register-tiled FFMA kernel (csrc/simt_f32.cuh's tiles) that sums as the
//   first SIMT kernel does, then the epilogue kernel that the tensor-core
//   path shares; its output is the SIMT kernel's bit for bit (see "the f32
//   kernel" below).
// * Every other call (bf16 at other head widths, f32 at a head width that
//   is no multiple of 4 or above 128; head widths up to 256): the first
//   SIMT kernel. One block of
//   256 threads owns (batch element, tile of up to 16 query rows) and loops
//   over all H heads, so the LayerNorm epilogue sees all C channels of its
//   rows: the (rows, C) f32 attention output stays in shared memory and
//   only the normalised row is written. Per head, K and then V stream
//   through shared memory in chunks of 64 keys; the (rows, Lk) score tile
//   stays in shared memory (Lk <= 512: 32 KB at 16 rows), so no score,
//   weight or pre-LN output ever reaches device memory. The tile is the
//   caller's (ops/fused_graph_attention.py:simt_rows): 16 rows, or 8, 4, 2,
//   1 where 16 rows of (C + Tk) floats do not fit (C 2,048 at 8 heads of
//   256 and 512 keys: 8 rows). One warp owns a row
//   for the softmax, renorm and LayerNorm reductions. Keys are exactly the
//   Lk given: the kernel needs no padding, so Tq != Tk (the decoder's
//   one-query cross-attention) runs through the same code.
// Every f32 product is a plain FMA on the CUDA cores: TF32 would not hold
// the f32 path's 1e-4.
// Head widths above 256, and SIMT calls whose single row of C does not fit
// a block, take the wide path (ops/fused_graph_attention.py "wide"): the
// wide kernel of csrc/flash_graph_attention.cu with emit 3 (K1's weights
// in a second pass over the keys, the f32 attention output), then this
// file's LayerNorm kernel (graph_attention_ln_epilogue_kernel, any C).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include <type_traits>

#include "mma_sm90.cuh"
#include "simt_f32.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQTile = 16;
constexpr int kKeyChunk = 64;
constexpr int kMaxKeys = 512;   // the f32 kernel's score rows
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

// Shared memory: acc (rows, C) | p (rows, Tk) | qs (rows, dh) | kv (kKeyChunk, dh + 1)
template <typename T>
__global__ void __launch_bounds__(kThreads)
graph_attention_ln_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const float* __restrict__ key_mask,
                          const float* __restrict__ query_mask,
                          const float* __restrict__ graph, const T* __restrict__ residual,
                          const float* __restrict__ gamma, const float* __restrict__ beta,
                          T* __restrict__ out, float* __restrict__ o_out, int Tq, int Tk,
                          int C, int H, int renorm, float scale, int tile) {
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
  float* qs = p + tile * Tk;
  float* kv = qs + tile * dh;

  const T* qb = q + ((size_t)b * Tq + row0) * C;
  const T* kb = k + (size_t)b * Tk * C;
  const T* vb = v + (size_t)b * Tk * C;
  const float* km = key_mask + (size_t)b * Tk;
  const float* qm = query_mask + (size_t)b * Tq + row0;
  const float* gb = graph + ((size_t)b * Tq + row0) * Tk;

  for (int h = 0; h < H; ++h) {
    const int c0 = h * dh;
    for (int i = tid; i < rows * dh; i += kThreads) {
      const int r = i / dh, d = i - r * dh;
      qs[i] = to_float(qb[(size_t)r * C + c0 + d]);
    }

    // scores of this head, chunk by chunk of keys
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

    // softmax -> x graph -> renorm -> x query mask -> round to V's type
    for (int r = warp; r < rows; r += kWarps) {
      float* pr = p + r * Tk;
      const float* gr = gb + (size_t)r * Tk;
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
      float n = 0.f;
      for (int j = lane; j < Tk; j += 32) {
        const float a = pr[j] / z * gr[j];
        pr[j] = a;
        n += renorm == 0 ? fabsf(a) : a;
      }
      n = warp_sum(n);
      const float denom = renorm == 0 ? fmaxf(n, kL1Eps) : n + kSumEps;
      const float qmr = qm[r];
      for (int j = lane; j < Tk; j += 32) pr[j] = to_float(from_float<T>(pr[j] / denom * qmr));
    }

    // acc[:, c0:c0+dh] = weights @ V_h, chunk by chunk of keys
    for (int j0 = 0; j0 < Tk; j0 += kKeyChunk) {
      const int nk = min(kKeyChunk, Tk - j0);
      __syncthreads();  // weights final; the previous chunk's readers of kv done
      for (int i = tid; i < nk * dh; i += kThreads) {
        const int j = i / dh, d = i - j * dh;
        kv[j * dh + d] = to_float(vb[(size_t)(j0 + j) * C + c0 + d]);
      }
      __syncthreads();
      for (int i = tid; i < rows * dh; i += kThreads) {
        const int r = i / dh, d = i - r * dh;
        const float* pr = p + r * Tk + j0;
        float s = 0.f;
        for (int j = 0; j < nk; ++j) s = fmaf(pr[j], kv[j * dh + d], s);
        float* a = acc + r * C + c0 + d;
        *a = j0 == 0 ? s : *a + s;
      }
    }
    __syncthreads();  // acc of this head complete; qs, p and kv free
  }

  if (o_out != nullptr) {   // the attention output alone (savqa_graph_attention)
    float* orows = o_out + ((size_t)b * Tq + row0) * C;
    for (int i = tid; i < rows * C; i += kThreads) orows[i] = acc[i];
    return;
  }

  // residual + LayerNorm, one warp per row
  const T* rb = residual + ((size_t)b * Tq + row0) * C;
  T* ob = out + ((size_t)b * Tq + row0) * C;
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
      ss += d * d;
    }
    const float var = warp_sum(ss) / (float)max(C - 1, 1);
    const float sd = var > 0.f ? sqrtf(var) : 0.f;
    for (int c = lane; c < C; c += 32)
      ob[(size_t)r * C + c] = from_float<T>(gamma[c] * (xr[c] - mean) / (sd + kLnEps) + beta[c]);
  }
}

// ---- the tensor-core kernels (bf16, head width a multiple of 16) ----
//
// Two kernels, counted as one launch of K1:
// * graph_attention_ln_tc_kernel, one block of NW warps per (head, NW x 16
//   query rows, batch element), 16 rows a warp, heads the fastest grid axis
//   (the graph tile and V's rows are L2 hits for the other heads). It is
//   section 1 of K2's tensor-core rows launch (csrc/graph_attention_bwd.cu)
//   for one head: pass A gets the row maximum m, the sum z and b = sum e g
//   (l1: sum e |g|) online from Q K^T on the tensor cores (mma.sync
//   m16n8k16, csrc/mma_sm90.cuh), pass B forms A = e / z g / r qmask on the
//   score fragments, rounds it to bf16 and accumulates O = A V, the weights
//   going from one product to the next in registers. K and V stream through
//   a two-stage cp.async ring, 64 keys a step; up to 128 keys the ring holds
//   all of them and pass B reads them in place. Scores are in units of log 2
//   with the fill value's exponent formed per row, so a row whose keys are
//   all masked gets exp(0) = 1 for each, as the plain version does. O, f32,
//   goes to scratch.
// * graph_attention_ln_epilogue_kernel, one warp a row: O + residual in f32
//   and the reference LayerNorm. (The last head block of a row tile running
//   the LayerNorm of its 64 rows instead took 2-6x as long: 4 warps walk 64
//   rows at the end of the kernel; scripts/k13_knockouts.py.)
// The heads' blocks run side by side: at B 4, L 66 that is 64 blocks, where
// blocks that walk all heads of their rows (the SIMT kernel) are 20.

using bf16 = __nv_bfloat16;
using savqa::accumulate_ab;
using savqa::cp_async_commit;
using savqa::cp_async_wait;
using savqa::fast_exp2;
using savqa::frag_a_row;
using savqa::ldmatrix_x4;
using savqa::load_graph_frag;
using savqa::product_abt;
using savqa::product_abt_smem;
using savqa::quad_max;
using savqa::quad_sum;
using savqa::stage_head_tile;

constexpr int kStep = 64;         // keys a step
constexpr int kTcMaxDh = 256;     // the widest head of the tensor-core kernel (instance 256)
constexpr int kNS = kStep / 8;    // 8-wide accumulator blocks of a step
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory: Qs (16 NW, DH + 8) bf16 | ring: two stages of K, V
// (64, DH + 8) bf16 | kmul, kfill (ceil(Tk / 64) * 64) f32
// Instance 256 (head widths 144-256, zero-padded): O's accumulators are 128
// registers a thread, so Q's fragments are read from Qs with ldmatrix where
// Q K^T needs them (product_abt_smem) instead of held (64 registers), V's
// two 8-wide blocks at a time, and pass B reads the graph after Q K^T; it
// runs 64 or 128 query rows a block (4 or 8 warps), one block an SM either
// way (173 or 207 KB at 512 keys), 128 above 128 rows (tc_warps).
// Up to a head width of 64 the registers are capped for three blocks of 4
// warps an SM (170 a thread; 209 uncapped left two): 0.0803 / 0.1205 ms
// against 0.0942 / 0.1351 at L 66 / 128, B 128, spilling 12 bytes
// (scripts/k13_knockouts.py, H100 80GB HBM3 at 700 W). At 128 the cap
// would spill 800 bytes.
template <int DH, int NW>
__global__ void __launch_bounds__(NW * 32, DH <= 64 ? 3 : 1)
graph_attention_ln_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const float* __restrict__ key_mask,
                             const float* __restrict__ query_mask,
                             const float* __restrict__ graph, float* __restrict__ o,
                             float* __restrict__ stats, int Tq, int Tk, int C, int dh, int renorm,
                             float scale) {
  constexpr int kThreadsTc = NW * 32;
  constexpr int kRowsTc = NW * 16;
  constexpr int kLd = DH + 8;
  constexpr int kKD = DH / 16;
  constexpr int kND = DH / 8;
  constexpr bool kQSmem = DH > 128;   // Q's fragments read from Qs where Q K^T needs them
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_steps = (Tk + kStep - 1) / kStep;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ring = Qs + kRowsTc * kLd;
  float* kmul = reinterpret_cast<float*>(ring + 4 * kStep * kLd);
  float* kfill = kmul + n_steps * kStep;

  const int c0 = blockIdx.x * dh;
  const int row0 = blockIdx.y * kRowsTc;
  const int b = blockIdx.z;
  const int rows = min(kRowsTc, Tq - row0);
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
  const bool resident = n_steps <= 2;     // the ring holds every key of the head
  const float scale2 = scale * kLog2e;

  const bf16* qb = q + (size_t)b * Tq * C;
  const bf16* kb = k + (size_t)b * Tk * C;
  const bf16* vb = v + (size_t)b * Tk * C;
  const float* graph_a = graph + ((size_t)b * Tq + row0 + (real_a ? lrow_a : 0)) * Tk;
  const float* graph_b = graph + ((size_t)b * Tq + row0 + (real_b ? lrow_b : 0)) * Tk;
  const float qm_a = real_a ? query_mask[(size_t)b * Tq + row0 + lrow_a] : 0.f;
  const float qm_b = real_b ? query_mask[(size_t)b * Tq + row0 + lrow_b] : 0.f;

  // x = s * kmul + kfill is the masked score in units of log 2: (scale
  // log2(e), 0) on a real key, (0, fill) on a masked one, (0, -inf) past Tk
  for (int j = tid; j < n_steps * kStep; j += kThreadsTc) {
    const bool in = j < Tk;
    const bool keep = in && key_mask[(size_t)b * Tk + j] != 0.f;
    kmul[j] = keep ? scale2 : 0.f;
    kfill[j] = keep ? 0.f : in ? kNegMask : -INFINITY;
  }

  // one pass over the keys through the ring: the copies of step j + 1
  // overlap body(j); with `load_tiles` false the tiles are in place already
  auto key_pass = [&](bool with_q, bool with_v, bool load_tiles, auto body) {
    if (!load_tiles) {
      for (int step = 0; step < n_steps; ++step) {
        const bf16* Ks = ring + (step & 1) * 2 * kStep * kLd;
        body(step, Ks, Ks + kStep * kLd);
      }
      return;
    }
    auto load = [&](int step) {
      bf16* Ks = ring + (step & 1) * 2 * kStep * kLd;
      stage_head_tile<DH, kThreadsTc>(Ks, kb, step * kStep, Tk, kStep, C, c0, dh);
      if (with_v)
        stage_head_tile<DH, kThreadsTc>(Ks + kStep * kLd, vb, step * kStep, Tk, kStep, C, c0, dh);
    };
    __syncthreads();   // the previous pass's readers of the ring are done
    if (with_q) stage_head_tile<DH, kThreadsTc>(Qs, qb, row0, Tq, kRowsTc, C, c0, dh);
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
  };

  uint32_t qf[kQSmem ? 1 : kKD][4];
  // the step's masked scores (log 2 units) from Q K^T
  auto scores = [&](float (&s)[kNS][4], const bf16* Ks, int step) {
    if constexpr (kQSmem)
      product_abt_smem<DH, kNS>(s, Qs, warp * 16, Ks, lane, Tk - step * kStep);
    else
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

  // pass A: the softmax maximum m and sum z, and b = sum e g (l1: sum e |g|), online
  float m_a = -INFINITY, m_b = -INFINITY, z_a = 0.f, z_b = 0.f, b_a = 0.f, b_b = 0.f;
  key_pass(true, resident, true, [&](int step, const bf16* Ks, const bf16*) {
    if (!active) return;
    if (!kQSmem && step == 0) {
#pragma unroll
      for (int kd = 0; kd < kKD; ++kd)
        ldmatrix_x4(qf[kQSmem ? 0 : kd], frag_a_row(Qs, kLd, warp * 16, kd * 16, lane));
    }
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
        const float w = e * (renorm == 0 ? fabsf(gr[nb][c]) : gr[nb][c]);
        if (c < 2) { sz_a += e; sb_a += w; } else { sz_b += e; sb_b += w; }
      }
    }
    z_a = z_a * alpha_a + sz_a;
    z_b = z_b * alpha_b + sz_b;
    b_a = b_a * alpha_a + sb_a;
    b_b = b_b * alpha_b + sb_b;
  });
  float iz_a = 0.f, iz_b = 0.f, c1_a = 0.f, c1_b = 0.f;
  if (active) {
    const float zs_a = quad_sum(z_a), zs_b = quad_sum(z_b);
    const float bs_a = quad_sum(b_a), bs_b = quad_sum(b_b);
    if (stats != nullptr && t == 0) {
      // pass A's m, z, b as K4 gives them (K2's composed route hands them to
      // K5 and K6): m in natural units, exactly the fill where every key is
      // masked (m = fill, whose e are all 1)
      const size_t n = (size_t)gridDim.z * gridDim.x * Tq;
      const size_t at = ((size_t)b * gridDim.x + blockIdx.x) * Tq + row0 + lrow_a;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (!(half == 0 ? real_a : real_b)) continue;
        const float m2 = half == 0 ? m_a : m_b;
        stats[at + 8 * half] = m2 == kNegMask ? kNegMask : m2 / kLog2e;
        stats[n + at + 8 * half] = half == 0 ? zs_a : zs_b;
        stats[2 * n + at + 8 * half] = half == 0 ? bs_a : bs_b;
      }
    }
    iz_a = 1.f / zs_a;
    iz_b = 1.f / zs_b;
    const float rs_a = bs_a * iz_a, rs_b = bs_b * iz_b;   // sum of P graph
    const float r_a = renorm == 0 ? fmaxf(rs_a, kL1Eps) : rs_a + kSumEps;
    const float r_b = renorm == 0 ? fmaxf(rs_b, kL1Eps) : rs_b + kSumEps;
    c1_a = qm_a / r_a;
    c1_b = qm_b / r_b;
  }
  // pass B: O = A V with A = P graph / r * qmask rounded to V's type
  float acc[kND][4];
#pragma unroll
  for (int i = 0; i < kND; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  key_pass(false, true, !resident, [&](int step, const bf16* Ks, const bf16* Vs) {
    if (!active) return;
    const int nk = Tk - step * kStep;
    float gr[kNS][4], s[kNS][4];
    if constexpr (kQSmem) {   // the graph's 32 registers live after Q K^T, not across it
      scores(s, Ks, step);
      graph_step(gr, step);
    } else {
      graph_step(gr, step);
      scores(s, Ks, step);
    }
#pragma unroll
    for (int nb = 0; nb < kNS; ++nb) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (nb * 8 >= nk) { s[nb][c] = 0.f; continue; }
        const float p = fast_exp2(s[nb][c] - (c < 2 ? m_a : m_b)) * (c < 2 ? iz_a : iz_b);
        s[nb][c] = p * gr[nb][c] * (c < 2 ? c1_a : c1_b);
      }
    }
    accumulate_ab<DH, kNS>(acc, s, Vs, lane, nk);
  });
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (!active || !(half == 0 ? real_a : real_b)) continue;   // no barrier follows
    float* orow = o + ((size_t)b * Tq + row0 + (half == 0 ? lrow_a : lrow_b)) * C + c0;
#pragma unroll
    for (int i = 0; i < kND; ++i) {
      const int d = i * 8 + 2 * t;
      if (d < dh)
        *reinterpret_cast<float2*>(orow + d) = make_float2(acc[i][2 * half], acc[i][2 * half + 1]);
    }
  }
}

// out = LN(o + residual), one warp a row. bf16 with C a multiple of 128
// (up to 1,024): a lane holds its 4-float chunks c = 4 lane + 128 i in
// registers (one read of o and of the residual, 16-byte and 8-byte loads);
// other widths and f32 read the row three times, from L1 after the first.
// The tensor-core path's second kernel, and the model axis's LayerNorm
// entry (savqa_attention_ln) after the heads are gathered.
template <typename T>
__global__ void __launch_bounds__(kThreads)
graph_attention_ln_epilogue_kernel(const float* __restrict__ o, const T* __restrict__ residual,
                                   const float* __restrict__ gamma,
                                   const float* __restrict__ beta, T* __restrict__ out,
                                   int n_rows, int C) {
  constexpr int kMaxChunks = 8;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const float* xr = o + (size_t)row * C;
  const T* rr = residual + (size_t)row * C;
  T* orow = out + (size_t)row * C;
  if constexpr (std::is_same<T, bf16>::value) {
    if (C % 128 == 0 && C <= 128 * kMaxChunks) {
      const int n_chunks = C / 128;
      float x[kMaxChunks][4];
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxChunks; ++i) {
        if (i >= n_chunks) break;
        const int c = 4 * lane + 128 * i;
        const float4 ov = *reinterpret_cast<const float4*>(xr + c);
        const uint2 rv = *reinterpret_cast<const uint2*>(rr + c);   // a bf16 is the upper half of an f32
        x[i][0] = ov.x + __uint_as_float(rv.x << 16);
        x[i][1] = ov.y + __uint_as_float(rv.x & 0xffff0000u);
        x[i][2] = ov.z + __uint_as_float(rv.y << 16);
        x[i][3] = ov.w + __uint_as_float(rv.y & 0xffff0000u);
        s += x[i][0] + x[i][1] + x[i][2] + x[i][3];
      }
      const float mean = warp_sum(s) / (float)C;
      float ss = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxChunks; ++i) {
        if (i >= n_chunks) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) ss += (x[i][e] - mean) * (x[i][e] - mean);
      }
      const float var = warp_sum(ss) / (float)(C - 1);
      const float sd = var > 0.f ? sqrtf(var) : 0.f;
#pragma unroll
      for (int i = 0; i < kMaxChunks; ++i) {
        if (i >= n_chunks) break;
        const int c = 4 * lane + 128 * i;
        float y[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) y[e] = gamma[c + e] * (x[i][e] - mean) / (sd + kLnEps) + beta[c + e];
        *reinterpret_cast<uint2*>(orow + c) =
            make_uint2(savqa::pack_bf16(y[0], y[1]), savqa::pack_bf16(y[2], y[3]));
      }
      return;
    }
  }
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += xr[c] + to_float(rr[c]);
  const float mean = warp_sum(s) / (float)C;
  float ss = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = (xr[c] + to_float(rr[c])) - mean;
    ss += d * d;
  }
  const float var = warp_sum(ss) / (float)max(C - 1, 1);
  const float sd = var > 0.f ? sqrtf(var) : 0.f;
  for (int c = lane; c < C; c += 32)
    orow[c] = from_float<T>(gamma[c] * ((xr[c] + to_float(rr[c])) - mean) / (sd + kLnEps) + beta[c]);
}

template <int DH, int NW>
cudaError_t launch_tc_dh(const bf16* q, const bf16* k, const bf16* v, const float* key_mask,
                         const float* query_mask, const float* graph, const bf16* residual,
                         const float* gamma, const float* beta, bf16* out, float* o,
                         float* stats, int B, int Tq, int Tk, int C, int H, int renorm,
                         float scale, cudaStream_t stream) {
  const int n_steps = (Tk + kStep - 1) / kStep;
  const size_t smem = sizeof(bf16) * (NW * 16 + 4 * kStep) * (DH + 8) +
                      sizeof(float) * 2 * n_steps * kStep;
  auto kernel = graph_attention_ln_tc_kernel<DH, NW>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, (Tq + NW * 16 - 1) / (NW * 16), B);
  kernel<<<grid, NW * 32, smem, stream>>>(q, k, v, key_mask, query_mask, graph, o, stats, Tq,
                                          Tk, C, C / H, renorm, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || out == nullptr) return err;   // no out: the attention output alone
  graph_attention_ln_epilogue_kernel<bf16><<<(B * Tq + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      o, residual, gamma, beta, out, B * Tq, C);
  return cudaGetLastError();
}

// q_tile query rows a block: 16, 64 or (instance 256 only) 128, one warp
// each 16 (ops/fused_graph_attention.py:tc_warps).
template <int DH>
cudaError_t launch_tc(const bf16* q, const bf16* k, const bf16* v, const float* key_mask,
                      const float* query_mask, const float* graph, const bf16* residual,
                      const float* gamma, const float* beta, bf16* out, float* o, float* stats,
                      int B, int Tq, int Tk, int C, int H, int renorm, float scale, int q_tile,
                      cudaStream_t stream) {
  auto run = q_tile == 16 ? launch_tc_dh<DH, 1> : launch_tc_dh<DH, 4>;
  if constexpr (DH == 256)
    if (q_tile == 128) run = launch_tc_dh<DH, 8>;
  return run(q, k, v, key_mask, query_mask, graph, residual, gamma, beta, out, o, stats, B, Tq,
             Tk, C, H, renorm, scale, stream);
}

// ---- the f32 kernel (csrc/simt_f32.cuh) ----
//
// graph_attention_ln_f32_kernel, one block of WARPS warps per (head, 16
// WARPS query rows, batch element), heads the fastest grid axis, in three
// passes whose every sum is the first SIMT kernel's (above), in its order,
// so the output is that kernel's bit for bit:
// 1. Scores. Keys stream 64 a step through a two-stage cp.async ring of
//    (K tile, key mask); a lane owns a 4 x 8 tile of S = Q K^T (tile_abt:
//    one ascending-d FMA chain per score, the SIMT kernel's), masked and
//    scaled into the block's score rows P (rows, ld) in shared memory.
// 2. Weights (f32_weights). Each warp its 16 rows, four at a time, the 32
//    lanes over the keys j = lane + 32 t as the SIMT kernel's warp a row:
//    the row maximum, z = sum e, a = e / z g, the renorm's sum of |a| (l1)
//    or a (sum_eps), the weights a / denom * qmask into P (zeros past Tk),
//    the warp sums in the same butterfly. The divisions by z and denom go
//    through their reciprocals (savqa_f32::div_rn), the same quotients.
// 3. O = A V. V streams through the ring; per 64-key step a lane's 4 x
//    (dh / 8) tile of the step's partial sum starts from 0 and sums its keys
//    in order (tile_pv_rows), then adds to O: the SIMT kernel's chunk sums.
// O goes to f32 scratch and graph_attention_ln_epilogue_kernel adds the
// residual and runs the LayerNorm as the SIMT kernel's epilogue does (one
// warp a row, the same sums), counted as one launch with it. The
// attention-only entry runs the first kernel alone, so a model rank's
// heads followed by savqa_attention_ln give one process's bits. 64 rows a
// block up to 192 keys, 48 up to 320, 32 up to 512 (two blocks an SM at
// head width 64 whatever the keys), 16 when Tq <= 16 (the decoder's one
// query); no key split, whatever the head count. Shared memory: Qs (16
// WARPS, DH) | two stages of (K or V (64, DH), key mask (64)) | P (16 WARPS,
// ld), ld = 64 ceil(Tk / 64) + 8.
__host__ __device__ constexpr int f32_ld(int tk) { return (tk + 63) / 64 * 64 + 8; }
__host__ __device__ constexpr int f32_smem_floats(int dh, int rows, int tk) {
  return rows * dh + 2 * (64 * dh + 64) + rows * f32_ld(tk);
}

// Pass 2 of graph_attention_ln_f32_kernel for a warp's 16 score rows of P
// (from row wrow of the block, query row q0 + wrow), four at a time: lane l
// holds keys l + 32 t (t < KT) of each, as the first SIMT kernel's warp a
// row does, and forms the row maximum, e = exp(s - m), z = sum e (the lane's
// keys in order, then the butterfly), a = e / z g, the renorm's sum of |a|
// (l1) or a (sum_eps) alike, and the weights a / denom * qmask into P
// (zeros from Tk to width). Four rows at a time overlap their loads and
// their butterflies.
template <int KT>
__device__ __forceinline__ void f32_weights(float* P, int ld, const float* __restrict__ gb,
                                            const float* __restrict__ qmb, int q0, int wrow,
                                            int Tq, int Tk, int width, int renorm, int lane) {
  for (int r0 = wrow; r0 < wrow + 16; r0 += 4) {
    if (q0 + r0 >= Tq) break;
    float x[4][KT], g[4][KT];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = min(q0 + r0 + i, Tq - 1);   // past Tq: a real row's, never stored
      const float* gr = gb + (size_t)row * Tk;
#pragma unroll
      for (int t = 0; t < KT; ++t) {
        const int j = lane + 32 * t;
        x[i][t] = j < Tk ? P[(r0 + i) * ld + j] : -INFINITY;
        g[i][t] = j < Tk ? gr[j] : 0.f;
      }
    }
    float m[4], z[4], n[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int t = 0; t < KT; ++t) mx = fmaxf(mx, x[i][t]);
      m[i] = warp_max(mx);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float zz = 0.f;
#pragma unroll
      for (int t = 0; t < KT; ++t) {
        if (lane + 32 * t >= Tk) break;
        x[i][t] = expf(x[i][t] - m[i]);
        zz += x[i][t];
      }
      z[i] = warp_sum(zz);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float rz = 1.f / z[i];
      float nn = 0.f;
#pragma unroll
      for (int t = 0; t < KT; ++t) {
        if (lane + 32 * t >= Tk) break;
        const float a = savqa_f32::div_rn(x[i][t], z[i], rz) * g[i][t];
        x[i][t] = a;
        nn += renorm == 0 ? fabsf(a) : a;
      }
      n[i] = warp_sum(nn);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + r0 + i;
      if (row >= Tq) break;
      const float denom = renorm == 0 ? fmaxf(n[i], kL1Eps) : n[i] + kSumEps;
      const float rd = 1.f / denom;
      const float qmr = qmb[row];
      float* pr = P + (r0 + i) * ld;
#pragma unroll
      for (int t = 0; t < KT; ++t) {
        const int j = lane + 32 * t;
        if (j < Tk) pr[j] = savqa_f32::div_rn(x[i][t], denom, rd) * qmr;
      }
      for (int j = Tk + lane; j < width; j += 32) pr[j] = 0.f;   // the last step's tail
    }
  }
}

template <int DH, int WARPS>
__global__ void __launch_bounds__(WARPS * 32, DH <= 64 ? 2 : 1)
graph_attention_ln_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ key_mask,
                              const float* __restrict__ query_mask,
                              const float* __restrict__ graph, float* __restrict__ o, int Tq,
                              int Tk, int C, int dh, int renorm, float scale) {
  namespace f32 = savqa_f32;
  constexpr int kRows = 16 * WARPS;
  constexpr int kThr = 32 * WARPS;
  constexpr int kStageF = 64 * DH + 64;
  extern __shared__ __align__(16) float smem_k1[];
  float* Qs = smem_k1;
  float* ring = Qs + kRows * DH;
  float* P = ring + 2 * kStageF;
  const int ld = f32_ld(Tk);

  const int h = blockIdx.x;
  const int q0 = blockIdx.y * kRows;
  const int b = blockIdx.z;
  const int c0 = h * dh;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ly = lane >> 3, lx = lane & 7;
  const int wrow = warp * 16;
  const int n_steps = (Tk + kStep - 1) / kStep;
  const bool active = q0 + wrow < Tq;   // this warp holds a real row
  const float* kb = k + (size_t)b * Tk * C;
  const float* vb = v + (size_t)b * Tk * C;
  const float* km = key_mask + (size_t)b * Tk;

  // one pass over the keys through the ring: the copies of step j + 1
  // overlap body(j)
  auto key_pass = [&](const float* src, bool with_mask, auto body) {
    auto load = [&](int step) {
      float* base = ring + (step & 1) * kStageF;
      f32::stage_tile<DH, kThr>(base, src, step * kStep, Tk, kStep, C, c0, dh, true,
                                f32::Swz<DH>());
      if (with_mask)
        for (int j = tid; j < kStep; j += kThr) {
          const int key = step * kStep + j;
          f32::cp_async4(base + kStep * DH + j, km + (key < Tk ? key : 0), key < Tk);
        }
    };
    load(0);
    cp_async_commit();
    for (int step = 0; step < n_steps; ++step) {
      cp_async_wait<0>();
      __syncthreads();   // this step's tiles (and Q) have landed; the other stage is free
      if (step + 1 < n_steps) load(step + 1);
      cp_async_commit();
      if (active) body(step, ring + (step & 1) * kStageF);
    }
    cp_async_wait<0>();
  };

  // 1. the masked, scaled scores into P
  f32::stage_tile<DH, kThr>(Qs, q + (size_t)b * Tq * C, q0, Tq, kRows, C, c0, dh, true,
                            f32::Swz<DH>());
  key_pass(kb, true, [&](int step, const float* Ks) {
    const float* kms = Ks + kStep * DH;
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[i][c] = 0.f;
    f32::tile_abt<DH, 8>(s, Qs, wrow, Ks, dh, ly, lx);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int j = lx + 8 * c;
      const bool masked = kms[j] == 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        P[(wrow + ly + 4 * i) * ld + step * kStep + j] = masked ? kNegMask : s[i][c] * scale;
    }
  });

  // 2. the weights (every warp reads and writes only its own rows of P)
  if (active) {
    __syncwarp();
    const int nt = (Tk + 31) / 32;
    const float* gb = graph + (size_t)b * Tq * Tk;
    const float* qmb = query_mask + (size_t)b * Tq;
    if (nt <= 4)
      f32_weights<4>(P, ld, gb, qmb, q0, wrow, Tq, Tk, n_steps * kStep, renorm, lane);
    else if (nt <= 8)
      f32_weights<8>(P, ld, gb, qmb, q0, wrow, Tq, Tk, n_steps * kStep, renorm, lane);
    else if (nt <= 10)   // the variants' 300 keys
      f32_weights<10>(P, ld, gb, qmb, q0, wrow, Tq, Tk, n_steps * kStep, renorm, lane);
    else
      f32_weights<16>(P, ld, gb, qmb, q0, wrow, Tq, Tk, n_steps * kStep, renorm, lane);
    __syncwarp();
  }

  // 3. O = A V, a partial sum a 64-key step added to O as the SIMT kernel adds them
  float acc[4][DH / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < DH / 8; ++e) acc[i][e] = 0.f;
  __syncthreads();   // every warp's readers of the K ring are done
  key_pass(vb, false, [&](int step, const float* Vs) {
    float part[4][DH / 8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < DH / 8; ++e) part[i][e] = 0.f;
    f32::tile_pv_rows<DH, kStep>(part, P + wrow * ld + step * kStep, ld, Vs, ly, lx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < DH / 8; ++e) acc[i][e] = step == 0 ? part[i][e] : acc[i][e] + part[i][e];
  });
  if (!active) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + wrow + ly + 4 * i;
    if (row >= Tq) continue;
#pragma unroll
    for (int g = 0; g < DH / 32; ++g) {
      const int d = 4 * lx + 32 * g;
      if (d >= dh) continue;
      *reinterpret_cast<float4*>(o + ((size_t)b * Tq + row) * C + c0 + d) =
          make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2], acc[i][4 * g + 3]);
    }
  }
}

// o = the attention output (B, Tq, C) f32; with out, then out = LN(o +
// residual) in f32.
template <int DH, int WARPS>
cudaError_t launch_f32_dh(const float* q, const float* k, const float* v, const float* key_mask,
                          const float* query_mask, const float* graph, const float* residual,
                          const float* gamma, const float* beta, float* out, float* o, int B,
                          int Tq, int Tk, int C, int H, int renorm, float scale,
                          cudaStream_t stream) {
  constexpr int kRows = 16 * WARPS;
  auto kernel = graph_attention_ln_f32_kernel<DH, WARPS>;
  // once a process, for the most keys K1 takes: the one-query calls are
  // short enough for the host's attribute calls to show
  static const cudaError_t attributes =
      savqa_f32::allow_smem(kernel, sizeof(float) * f32_smem_floats(DH, kRows, kMaxKeys));
  if (attributes != cudaSuccess) return attributes;
  const size_t smem = sizeof(float) * f32_smem_floats(DH, kRows, Tk);
  const dim3 grid(H, (Tq + kRows - 1) / kRows, B);
  kernel<<<grid, WARPS * 32, smem, stream>>>(q, k, v, key_mask, query_mask, graph, o, Tq, Tk, C,
                                             C / H, renorm, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || out == nullptr) return err;   // no out: the attention output alone
  graph_attention_ln_epilogue_kernel<float><<<(B * Tq + kWarps - 1) / kWarps, kThreads, 0,
                                              stream>>>(o, residual, gamma, beta, out, B * Tq, C);
  return cudaGetLastError();
}

template <int WARPS>
cudaError_t launch_f32(const float* q, const float* k, const float* v, const float* key_mask,
                       const float* query_mask, const float* graph, const float* residual,
                       const float* gamma, const float* beta, float* out, float* o, int B,
                       int Tq, int Tk, int C, int H, int renorm, float scale,
                       cudaStream_t stream) {
  const int dh = C / H;
  auto run = dh <= 32 ? launch_f32_dh<32, WARPS> : dh <= 64 ? launch_f32_dh<64, WARPS>
                                                            : launch_f32_dh<128, WARPS>;
  return run(q, k, v, key_mask, query_mask, graph, residual, gamma, beta, out, o, B, Tq, Tk, C,
             H, renorm, scale, stream);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const float* key_mask,
                   const float* query_mask, const float* graph, const void* residual,
                   const float* gamma, const float* beta, void* out, float* o_out, int B,
                   int Tq, int Tk, int C, int H, int renorm, float scale, int tile,
                   cudaStream_t stream) {
  const int dh = C / H;
  const size_t smem = sizeof(float) * ((size_t)tile * C + (size_t)tile * Tk +
                                       (size_t)tile * dh + (size_t)kKeyChunk * (dh + 1));
  cudaError_t err = cudaFuncSetAttribute(graph_attention_ln_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + tile - 1) / tile, B);
  graph_attention_ln_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), key_mask,
      query_mask, graph, static_cast<const T*>(residual), gamma, beta, static_cast<T*>(out),
      o_out, Tq, Tk, C, H, renorm, scale, tile);
  return cudaGetLastError();
}

// Whether `path` cannot take this call (see savqa_graph_attention_ln).
bool bad_path(int dtype, int Tk, int C, int H, int path, int q_tile, const void* o) {
  const int dh = C / H;
  if (path == 1)
    return dtype != 1 || dh % 16 != 0 || dh > kTcMaxDh || o == nullptr ||
           (q_tile != 16 && q_tile != 64 && (q_tile != 128 || dh <= 128));
  if (path == 2)
    return dtype != 0 || dh % 4 != 0 || dh > 128 || o == nullptr || Tk > kMaxKeys ||
           (q_tile != 16 && q_tile != 32 && q_tile != 48 && q_tile != 64);
  return path != 0 || q_tile < 1 || q_tile > kQTile;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. renorm: 0 = l1, 1 = sum_eps. path: 0 =
// the first SIMT kernel (o unused, may be null; q_tile query rows a block,
// 1 to 16, its shared memory 4 q_tile (C + Tk + dh) + 256 (dh + 1) bytes);
// 1 = the tensor-core kernels (bf16 with a head width that is a multiple of
// 16, at most 256; q_tile query rows a block: 16, 64, or 128 above head
// width 128); 2 = the
// f32 kernel (f32 with a head width that is a multiple of 4, at most 128,
// and at most 512 keys; q_tile query rows a block: 16, 32, 48 or 64). Paths 1 and 2 need o: (B, Tq, C)
// f32 scratch. Returns cudaGetLastError() after the launches (0 = success).
extern "C" int savqa_graph_attention_ln(const void* q, const void* k, const void* v,
                                        const void* key_mask, const void* query_mask,
                                        const void* graph, const void* residual,
                                        const void* gamma, const void* beta, void* out, void* o,
                                        int B, int Tq, int Tk, int C, int H, int renorm,
                                        int dtype, int path, int q_tile, float scale,
                                        void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || C % H != 0 || (renorm != 0 && renorm != 1) ||
      bad_path(dtype, Tk, C, H, path, q_tile, o))
    return (int)cudaErrorInvalidValue;
  const auto* km = static_cast<const float*>(key_mask);
  const auto* qm = static_cast<const float*>(query_mask);
  const auto* g = static_cast<const float*>(graph);
  const auto* ga = static_cast<const float*>(gamma);
  const auto* be = static_cast<const float*>(beta);
  auto s = static_cast<cudaStream_t>(stream);
  if (path == 1) {
    const int dh = C / H;
    auto run = dh <= 16 ? launch_tc<16> : dh <= 32 ? launch_tc<32> : dh <= 64 ? launch_tc<64>
             : dh <= 128 ? launch_tc<128> : launch_tc<256>;
    return (int)run(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                    static_cast<const bf16*>(v), km, qm, g, static_cast<const bf16*>(residual),
                    ga, be, static_cast<bf16*>(out), static_cast<float*>(o), nullptr, B, Tq, Tk,
                    C, H, renorm, scale, q_tile, s);
  }
  if (path == 2) {
    auto run = q_tile == 16 ? launch_f32<1> : q_tile == 32 ? launch_f32<2>
             : q_tile == 48 ? launch_f32<3> : launch_f32<4>;
    return (int)run(static_cast<const float*>(q), static_cast<const float*>(k),
                    static_cast<const float*>(v), km, qm, g, static_cast<const float*>(residual),
                    ga, be, static_cast<float*>(out), static_cast<float*>(o), B, Tq, Tk, C, H,
                    renorm, scale, s);
  }
  if (dtype == 0)
    return (int)launch<float>(q, k, v, km, qm, g, residual, ga, be, out, nullptr, B, Tq, Tk,
                              C, H, renorm, scale, q_tile, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, km, qm, g, residual, ga, be, out, nullptr, B,
                                      Tq, Tk, C, H, renorm, scale, q_tile, s);
  return (int)cudaErrorInvalidValue;
}

// The model axis (ops/fused_graph_attention.py:graph_attention_heads): the
// attention output o (B, Tq, C) f32 of the H heads given, before any
// residual or LayerNorm; C and H are this rank's columns and heads. The
// first kernel of path 1 or 2 alone, or the SIMT kernel writing o and
// skipping its epilogue. The arguments otherwise as savqa_graph_attention_ln's.
extern "C" int savqa_graph_attention(const void* q, const void* k, const void* v,
                                     const void* key_mask, const void* query_mask,
                                     const void* graph, void* o, int B, int Tq, int Tk, int C,
                                     int H, int renorm, int dtype, int path, int q_tile,
                                     float scale, void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || C % H != 0 || (renorm != 0 && renorm != 1) ||
      o == nullptr || bad_path(dtype, Tk, C, H, path, q_tile, o))
    return (int)cudaErrorInvalidValue;
  const auto* km = static_cast<const float*>(key_mask);
  const auto* qm = static_cast<const float*>(query_mask);
  const auto* g = static_cast<const float*>(graph);
  auto* of = static_cast<float*>(o);
  auto s = static_cast<cudaStream_t>(stream);
  if (path == 1) {
    const int dh = C / H;
    auto run = dh <= 16 ? launch_tc<16> : dh <= 32 ? launch_tc<32> : dh <= 64 ? launch_tc<64>
             : dh <= 128 ? launch_tc<128> : launch_tc<256>;
    return (int)run(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                    static_cast<const bf16*>(v), km, qm, g, nullptr, nullptr, nullptr, nullptr,
                    of, nullptr, B, Tq, Tk, C, H, renorm, scale, q_tile, s);
  }
  if (path == 2) {
    auto run = q_tile == 16 ? launch_f32<1> : q_tile == 32 ? launch_f32<2>
             : q_tile == 48 ? launch_f32<3> : launch_f32<4>;
    return (int)run(static_cast<const float*>(q), static_cast<const float*>(k),
                    static_cast<const float*>(v), km, qm, g, nullptr, nullptr, nullptr, nullptr,
                    of, B, Tq, Tk, C, H, renorm, scale, s);
  }
  if (dtype == 0)
    return (int)launch<float>(q, k, v, km, qm, g, nullptr, nullptr, nullptr, nullptr, of, B, Tq,
                              Tk, C, H, renorm, scale, q_tile, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, km, qm, g, nullptr, nullptr, nullptr, nullptr, of,
                                      B, Tq, Tk, C, H, renorm, scale, q_tile, s);
  return (int)cudaErrorInvalidValue;
}

// The attention output o (B, Tq, C) f32 of the tensor-core kernel (bf16,
// a head width that is a multiple of 16 up to 256; q_tile 16, 64 or, at
// instance 256, 128 rows a block) and its pass A's row statistics, stats
// (3, B, H, Tq) f32: m (natural units, as K4 gives it), z and b. K2's
// composed route (ops/fused_graph_attention.py) hands them to K5 and K6.
extern "C" int savqa_graph_attention_stats(const void* q, const void* k, const void* v,
                                           const void* key_mask, const void* query_mask,
                                           const void* graph, void* o, void* stats, int B,
                                           int Tq, int Tk, int C, int H, int renorm, int q_tile,
                                           float scale, void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || C % H != 0 || (renorm != 0 && renorm != 1) ||
      o == nullptr || stats == nullptr || bad_path(1, Tk, C, H, 1, q_tile, o))
    return (int)cudaErrorInvalidValue;
  const int dh = C / H;
  auto run = dh <= 16 ? launch_tc<16> : dh <= 32 ? launch_tc<32> : dh <= 64 ? launch_tc<64>
           : dh <= 128 ? launch_tc<128> : launch_tc<256>;
  return (int)run(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<const float*>(key_mask),
                  static_cast<const float*>(query_mask), static_cast<const float*>(graph),
                  nullptr, nullptr, nullptr, nullptr, static_cast<float*>(o),
                  static_cast<float*>(stats), B, Tq, Tk, C, H, renorm, scale, q_tile,
                  static_cast<cudaStream_t>(stream));
}

// out = LN(o + residual) over n_rows rows of C: o f32, residual and out of
// dtype (0 float32, 1 bfloat16), gamma and beta f32 (the epilogue kernel of
// the tensor-core path, as its own entry).
extern "C" int savqa_attention_ln(const void* o, const void* residual, const void* gamma,
                                  const void* beta, void* out, int n_rows, int C, int dtype,
                                  void* stream) {
  if (n_rows <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const auto* of = static_cast<const float*>(o);
  const auto* ga = static_cast<const float*>(gamma);
  const auto* be = static_cast<const float*>(beta);
  auto s = static_cast<cudaStream_t>(stream);
  const int blocks = (n_rows + kWarps - 1) / kWarps;
  if (dtype == 0)
    graph_attention_ln_epilogue_kernel<float><<<blocks, kThreads, 0, s>>>(
        of, static_cast<const float*>(residual), ga, be, static_cast<float*>(out), n_rows, C);
  else if (dtype == 1)
    graph_attention_ln_epilogue_kernel<bf16><<<blocks, kThreads, 0, s>>>(
        of, static_cast<const bf16*>(residual), ga, be, static_cast<bf16*>(out), n_rows, C);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
