// Register-tiled float32 building blocks of the f32 kernels of K1
// (graph_attention.cu), K2 (graph_attention_bwd.cu), K4
// (flash_graph_attention.cu) and K6 (flash_graph_attention_bwd.cu):
// FFMA on the CUDA cores (TF32 would not hold the 1e-4 the f32 path is
// checked to), operands staged by cp.async into swizzled shared tiles.
//
// Lane layout. A warp owns 4 R rows of its first operand (R = 4: query rows
// in K4 and K2's dq kernel, keys in K2's dkv kernel; R = 8 only in a
// variant scripts/k4_f32_variants.py times, which ran slower: 255 registers,
// 4 warps an SM); lane = 8 ly + lx owns rows ly + 4 i (i < R) of them and,
// of a step's columns, lx + 8 c (c < NC): an R x NC tile of scores per lane.
// The 8 lanes of one ly share rows, so a row's sum or maximum over a step is
// three shuffles (xor 1, 2, 4). Of a DH-wide output (O, dQ, dK, dV) a lane
// owns channels 4 lx + 32 g + e (g < DH / 32, e < 4) of its R rows: float4
// loads and stores.
//
// Tiles. A row-major tile of W floats a row (W a multiple of 32) keeps its
// 16-byte chunks swizzled, chunk ^ (row & 7) (swz): 8 lanes that read one
// chunk of 8 consecutive rows, or 8 consecutive chunks of one row, hit 32
// distinct banks. The graph tile of a row-owning kernel is read as (rows ly
// + 4 i, columns lx + 8 c) and takes gswz (column ^ 8 (row & 3)) instead.
// Both keep a 16-byte chunk whole, so cp.async copies 16 bytes at a time
// where the source is aligned (head widths are multiples of 4 in both
// callers), else 4 (the graph when Tk is no multiple of 4).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "mma_sm90.cuh"

namespace savqa_f32 {

using savqa::cp_async16;
using savqa::cp_async4;

constexpr int kStep = 64;                  // K4: keys a step
constexpr float kNegMask = -4294967295.0f;  // float(-(2**32) + 1)
constexpr float kL1Eps = 1e-12f;
constexpr float kSumEps = 1e-7f;

template <int W>
__device__ __forceinline__ int swz(int row, int col) {
  return row * W + (col ^ ((row & 7) << 2));
}

// (A 16-wide tile, K5's f32 instance 256, swaps its halves on rows 2 and 3
// of every 4: the 4 rows a warp reads at once then fill 32 banks.)
template <int W>
__device__ __forceinline__ int gswz(int row, int col) {
  if constexpr (W == 16) return row * W + (col ^ (((row >> 1) & 1) << 3));
  return row * W + (col ^ ((row & 3) << 3));
}

template <int W>
struct Swz {
  __device__ __forceinline__ int operator()(int row, int col) const { return swz<W>(row, col); }
};

template <int W>
struct GSwz {
  __device__ __forceinline__ int operator()(int row, int col) const { return gswz<W>(row, col); }
};

// Rows [row0, row0 + tile_rows) and columns [col0, col0 + W) of src (rows of
// ld floats) into the tile dst (tile_rows, W) at at(row, col); rows from
// n_rows on and columns from width on are zeros. `vec`: 16-byte copies
// (width, ld and col0 multiples of 4, src 16-byte aligned), else 4-byte.
template <int W, int THREADS, typename At>
__device__ __forceinline__ void stage_tile(float* dst, const float* __restrict__ src, int row0,
                                           int n_rows, int tile_rows, size_t ld, int col0,
                                           int width, bool vec, At at) {
  if (vec) {
    constexpr int kChunks = W / 4;
    for (int i = threadIdx.x; i < tile_rows * kChunks; i += THREADS) {
      const int r = i / kChunks, c = (i - r * kChunks) * 4;
      const bool valid = row0 + r < n_rows && c < width;
      cp_async16(dst + at(r, c), valid ? src + (size_t)(row0 + r) * ld + col0 + c : src, valid);
    }
  } else {
    for (int i = threadIdx.x; i < tile_rows * W; i += THREADS) {
      const int r = i / W, c = i - r * W;
      const bool valid = row0 + r < n_rows && c < width;
      cp_async4(dst + at(r, c), valid ? src + (size_t)(row0 + r) * ld + col0 + c : src, valid);
    }
  }
}

// s[i][c] += sum_{d < dh} A[ar + ly + 4i][d] B[lx + 8c][d], one FMA chain per
// score in ascending d; A and B row-major (DH floats a row, swz), ar a
// multiple of 8. Per 4 d a lane loads R + NC float4 for 4 R NC FMAs.
template <int DH, int NC, int R = 4>
__device__ __forceinline__ void tile_abt(float (&s)[R][NC], const float* A, int ar,
                                         const float* B, int dh, int ly, int lx) {
#pragma unroll 2
  for (int d = 0; d < dh; d += 4) {
    float4 a[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + swz<DH>(ar + ly + 4 * i, d));
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float4 b = *reinterpret_cast<const float4*>(B + swz<DH>(lx + 8 * c, d));
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float x = s[i][c];
        x = fmaf(a[i].x, b.x, x);
        x = fmaf(a[i].y, b.y, x);
        x = fmaf(a[i].z, b.z, x);
        s[i][c] = fmaf(a[i].w, b.w, x);
      }
    }
  }
}

// Where column n of a warp's transposed (N, 4 R) tile keeps float4 slot
// `slot` = ly + 4 q: rows ly + 16 q + 4 e, e < 4, of the lane's rows ly + 4 i
// (conflict-free writes and reads).
template <int R>
__device__ __forceinline__ int pt_at(int n, int slot) {
  return R == 4 ? n * 16 + 4 * (slot ^ ((n >> 1) & 3)) : n * 32 + 4 * (slot ^ (n & 7));
}

// A lane tile (rows ly + 4i, columns lx + 8c) into the warp's transposed tile.
template <int NC, int R = 4>
__device__ __forceinline__ void store_t(float* pt, const float (&s)[R][NC], int ly, int lx) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int q = 0; q < R / 4; ++q)
      *reinterpret_cast<float4*>(pt + pt_at<R>(lx + 8 * c, ly + 4 * q)) =
          make_float4(s[4 * q][c], s[4 * q + 1][c], s[4 * q + 2][c], s[4 * q + 3][c]);
}

// o[i][4g + e] += sum_{n < N} pt[n][ly + 4i] V[n][4 lx + 32 g + e], one FMA
// chain per output in ascending n; V row-major (N, DH), swz. Per n a lane
// loads R / 4 + DH / 32 float4 for R DH / 8 FMAs. Unrolled by 8, n & 7 is
// a constant of each copy of the body and so are the swizzles (by 4: 0.7497
// against 0.6775 ms at K4's B 4, L 1,536, 8 heads; scripts/k4_f32_variants.py).
// Above DH 128 by 2: eight V loads a copy kept 255 registers and 188 bytes
// of spills at DH 256 (1.7805 ms against 1.6084 by 2 at K4's B 2, L 1,536;
// scripts/k4_f32_head256_variants.py).
template <int DH, int N, int R = 4>
__device__ __forceinline__ void tile_pv(float (&o)[R][DH / 8], const float* pt, const float* V,
                                        int ly, int lx) {
#pragma unroll (DH > 128 ? 2 : 8)
  for (int n = 0; n < N; ++n) {
    float pr[R];
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      const float4 p = *reinterpret_cast<const float4*>(pt + pt_at<R>(n, ly + 4 * q));
      pr[4 * q] = p.x, pr[4 * q + 1] = p.y, pr[4 * q + 2] = p.z, pr[4 * q + 3] = p.w;
    }
#pragma unroll
    for (int g = 0; g < DH / 32; ++g) {
      const float4 v = *reinterpret_cast<const float4*>(V + swz<DH>(n, 4 * lx + 32 * g));
#pragma unroll
      for (int i = 0; i < R; ++i) {
        o[i][4 * g + 0] = fmaf(pr[i], v.x, o[i][4 * g + 0]);
        o[i][4 * g + 1] = fmaf(pr[i], v.y, o[i][4 * g + 1]);
        o[i][4 * g + 2] = fmaf(pr[i], v.z, o[i][4 * g + 2]);
        o[i][4 * g + 3] = fmaf(pr[i], v.w, o[i][4 * g + 3]);
      }
    }
  }
}

// o[i][4g + e] += sum_{n < N} P[ly + 4i][n] V[n][4 lx + 32 g + e], one FMA
// chain per output in ascending n, as tile_pv, with the weights row-major:
// P (4 R rows, ld floats a row; ld = 8 mod 32 keeps a lane group's four
// rows in four banks), read a float at a time (the 8 lanes of one ly read
// one word). V row-major (N, DH), swz.
template <int DH, int N>
__device__ __forceinline__ void tile_pv_rows(float (&o)[4][DH / 8], const float* P, int ld,
                                             const float* V, int ly, int lx) {
#pragma unroll 8
  for (int n = 0; n < N; ++n) {
    float pr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pr[i] = P[(ly + 4 * i) * ld + n];
#pragma unroll
    for (int g = 0; g < DH / 32; ++g) {
      const float4 v = *reinterpret_cast<const float4*>(V + swz<DH>(n, 4 * lx + 32 * g));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        o[i][4 * g + 0] = fmaf(pr[i], v.x, o[i][4 * g + 0]);
        o[i][4 * g + 1] = fmaf(pr[i], v.y, o[i][4 * g + 1]);
        o[i][4 * g + 2] = fmaf(pr[i], v.z, o[i][4 * g + 2]);
        o[i][4 * g + 3] = fmaf(pr[i], v.w, o[i][4 * g + 3]);
      }
    }
  }
}

// a / b rounded to nearest, the IEEE quotient, from rb = 1 / b rounded to
// nearest: q = a rb corrected twice by its residual a - b q, each an exact
// FMA (Markstein's correction), where the division takes MUFU.RCP, its
// refinement and a range check. Exact while a and the quotient are normal
// numbers; a subnormal one (a term 2^-126 below its row's largest, which
// no sum of normal terms it enters can see) may land an ulp away. K1's and
// K6's f32 kernels divide every key's term of a row by that row's z and D
// (scripts/k6_f32_variants.py compares it with the division).
__device__ __forceinline__ float div_rn(float a, float b, float rb) {
  float q = a * rb;
  float r = fmaf(-b, q, a);
  q = fmaf(r, rb, q);
  r = fmaf(-b, q, a);
  return fmaf(r, rb, q);
}

// Maximum over the 8 lanes of one ly.
__device__ __forceinline__ float group8_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
}

// The sum over the 8 lanes of one ly of a + b, grouped as the 16-lane
// butterfly (xor 8, 4, 2, 1) of K4's first f32 kernel grouped it: a and b
// stand for its lanes lx and lx + 8.
__device__ __forceinline__ float group8_sum(float a, float b) {
  float x = a + b;
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 1);
}

// Lets `kernel` take `bytes` of dynamic shared memory, with the most shared
// memory the SM can give (two 115 KB blocks of K4's f32 kernel an SM).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
}

// Dynamic shared memory of flash_f32_body with `rows` query rows a block
// and `step` keys a step, in floats: the Q tile, then two stages of (K, V,
// graph tile, key mask).
__host__ __device__ constexpr int flash_stage_floats(int dh, int rows, int step = kStep) {
  return 2 * step * dh + rows * step + step;
}
__host__ __device__ constexpr int flash_smem_floats(int dh, int rows, int step = kStep) {
  return rows * dh + 2 * flash_stage_floats(dh, rows, step);
}

// One key step of flash_f32_body (and of K4's chunked f32 kernel) once s
// holds this lane's scores Q K^T of the step's keys, nk of them real: per
// row, the scores masked and scaled; m_new = max(m, max_j s_j); alpha =
// exp(m - m_new); p_j = exp(s_j - m_new); z = z alpha + sum p_j, b = b
// alpha + sum p_j g_j with g_j from the graph tile Gs; a = a alpha + sum_j
// (p_j g_j) v_j over the V tile Vs (AW channels a row), the weights passed
// to the product through the warp's own rows of Gs, read by then. Keys lx
// + 16 c' (c even) and lx + 8 + 16 c' (c odd) of a row sum as K4's first
// kernel's lanes lx and lx + 8 (group8_sum).
template <int AW, int STEP, int R>
__device__ __forceinline__ void flash_f32_step(float (&s)[R][STEP / 8], float (&m)[R],
                                               float (&z)[R], float (&bs)[R],
                                               float (&acc)[R][AW / 8], float* Gs,
                                               const float* kms, const float* Vs, int nk,
                                               float scale, int wrow, int ly, int lx) {
  constexpr int kNC = STEP / 8;   // a lane's columns of the scores
#pragma unroll
  for (int c = 0; c < kNC; ++c) {
    const int j = lx + 8 * c;
    const bool in_range = j < nk;
    const bool masked = kms[j] == 0.f;
#pragma unroll
    for (int i = 0; i < R; ++i)
      s[i][c] = !in_range ? -INFINITY : masked ? kNegMask : s[i][c] * scale;
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    float mx = s[i][0];
#pragma unroll
    for (int c = 1; c < kNC; ++c) mx = fmaxf(mx, s[i][c]);
    const float m_new = fmaxf(m[i], group8_max(mx));
    const float alpha = expf(m[i] - m_new);
    float sp_a = 0.f, sp_b = 0.f, spg_a = 0.f, spg_b = 0.f;
#pragma unroll
    for (int c = 0; c < kNC; ++c) {
      const float p = expf(s[i][c] - m_new);
      const float g = Gs[gswz<STEP>(wrow + ly + 4 * i, lx + 8 * c)];
      const float pg = p * g;
      if (c & 1) {
        sp_b += p;
        spg_b += pg;
      } else {
        sp_a += p;
        spg_a += pg;
      }
      s[i][c] = pg;
    }
    z[i] = z[i] * alpha + group8_sum(sp_a, sp_b);
    bs[i] = bs[i] * alpha + group8_sum(spg_a, spg_b);
    m[i] = m_new;
#pragma unroll
    for (int e = 0; e < AW / 8; ++e) acc[i][e] *= alpha;
  }
  __syncwarp();   // every lane has read its graph entries: the warp's rows take the weights
  float* pt = Gs + wrow * STEP;
  store_t<kNC, R>(pt, s, ly, lx);
  __syncwarp();
  tile_pv<AW, STEP, R>(acc, pt, Vs, ly, lx);
}

// The epilogue of flash_f32_body (and of K4's chunked f32 kernel) for this
// lane's rows row0 + 4 i: raw (n_split > 1 or emit 2) writes a and m, z, b
// at shard sp; else out = a / denom * query_mask and, with emit 1, m, z,
// b. a holds the head's channels [o0, o0 + ow) (a block of the head's
// first chunk, o0 0, writes the statistics, to m_out[i * stat_stride], z_out
// and b_out alike).
template <int AW, int R>
__device__ __forceinline__ void flash_f32_epilogue(
    const float (&m)[R], const float (&z)[R], const float (&bs)[R], const float (&acc)[R][AW / 8],
    int row0, int lx, int Tq, int C, int H, int dh, int h, int b, int sp, int o0, int ow,
    int stat_stride, int renorm, int emit, int n_split, const float* __restrict__ query_mask,
    float* __restrict__ out, float* __restrict__ a_out, float* __restrict__ m_out,
    float* __restrict__ z_out, float* __restrict__ b_out) {
  constexpr int kNG = AW / 32;
  const int c0 = h * dh;
  const bool raw = n_split > 1 || emit == 2;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = row0 + 4 * i;
    if (row >= Tq) continue;
    const size_t stat_at = (((size_t)sp * gridDim.z + b) * H + h) * Tq + row;
    if ((raw || emit == 1) && lx == 0 && o0 == 0) {
      m_out[stat_at * stat_stride] = m[i];
      z_out[stat_at * stat_stride] = z[i];
      b_out[stat_at * stat_stride] = bs[i];
    }
    const float denom = renorm == 0 ? fmaxf(bs[i], kL1Eps * z[i]) : bs[i] + kSumEps * z[i];
    const float qm = query_mask[(size_t)b * Tq + row];
#pragma unroll
    for (int g = 0; g < kNG; ++g) {
      const int d = 4 * lx + 32 * g;
      if (d >= ow) continue;
      const float* a4 = acc[i] + 4 * g;
      if (raw)
        *reinterpret_cast<float4*>(a_out + stat_at * dh + o0 + d) =
            make_float4(a4[0], a4[1], a4[2], a4[3]);
      else
        *reinterpret_cast<float4*>(out + ((size_t)b * Tq + row) * C + c0 + o0 + d) =
            make_float4(a4[0] / denom * qm, a4[1] / denom * qm, a4[2] / denom * qm,
                        a4[3] / denom * qm);
    }
  }
}

// K4's float32 forward for one block: (head h = blockIdx.x, query tile and
// key shard blockIdx.y = qt n_split + sp, batch b = blockIdx.z), 4 R WARPS
// query rows, keys 64 a step through a two-stage cp.async ring of (K, V,
// graph tile, key mask). Per step, per row: S = Q K^T (tile_abt), masked
// and scaled; m_new = max(m, max_j s_j); alpha = exp(m - m_new); p_j =
// exp(s_j - m_new); z = z alpha + sum p_j, b = b alpha + sum p_j g_j; a =
// a alpha + sum_j (p_j g_j) v_j, the weights passed to the second product
// through the warp's own rows of the graph tile, read by then. Each score,
// each output channel and the sums z and b are summed in the order of K4's
// first f32 kernel (see group8_sum). Outputs as
// flash_graph_attention_tc_kernel's: raw (n_split > 1 or emit 2) writes a
// and m, z, b at shard sp; else out = a / denom * query_mask and, with emit
// 1, m, z, b. Statistics go to m_out[i * stat_stride] (z_out, b_out alike).
// STEP keys a step: 64, or 32 at head widths above 128, where two stages of
// 64-key K and V tiles would not fit beside Q (a lane then owns a 4 x 4
// tile of scores; steps_per_split counts STEP-key steps).
template <int DH, int WARPS, int R = 4, int STEP = kStep>
__device__ __forceinline__ void flash_f32_body(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ key_mask, const float* __restrict__ query_mask,
    const float* __restrict__ graph, float* __restrict__ out, float* __restrict__ a_out,
    float* __restrict__ m_out, float* __restrict__ z_out, float* __restrict__ b_out,
    int stat_stride, int Tq, int Tk, int C, int H, int dh, int renorm, int emit, float scale,
    int n_split, int steps_per_split) {
  constexpr int kBQ = 4 * R * WARPS;
  constexpr int kThr = 32 * WARPS;
  constexpr int kStageF = flash_stage_floats(DH, kBQ, STEP);
  constexpr int kNC = STEP / 8;   // a lane's columns of the scores
  extern __shared__ __align__(16) float smem_f32[];
  float* Qs = smem_f32;
  float* stages = Qs + kBQ * DH;

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
  const int wrow = warp * 4 * R;
  const int n_steps = (Tk + STEP - 1) / STEP;
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
    const int j0 = step * STEP;
    stage_tile<DH, kThr>(base, kb, j0, Tk, STEP, C, c0, dh, true, Swz<DH>());
    stage_tile<DH, kThr>(base + STEP * DH, vb, j0, Tk, STEP, C, c0, dh, true, Swz<DH>());
    stage_tile<STEP, kThr>(base + 2 * STEP * DH, gb, q0, Tq, kBQ, Tk, j0, Tk - j0, gvec,
                            GSwz<STEP>());
    float* kms = base + 2 * STEP * DH + kBQ * STEP;
    for (int j = tid; j < STEP; j += kThr)
      cp_async4(kms + j, km + (j0 + j < Tk ? j0 + j : 0), j0 + j < Tk);
  };

  stage_tile<DH, kThr>(Qs, q + (size_t)b * Tq * C, q0, Tq, kBQ, C, c0, dh, true, Swz<DH>());
  if (step_lo < step_hi) load_step(step_lo);
  savqa::cp_async_commit();

  float m[R], z[R], bs[R], acc[R][DH / 8];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = -INFINITY;
    z[i] = 0.f;
    bs[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DH / 8; ++e) acc[i][e] = 0.f;
  }

  for (int step = step_lo; step < step_hi; ++step) {
    savqa::cp_async_wait<0>();
    __syncthreads();   // this step's tiles (and Q) have landed; the other stage is free
    if (step + 1 < step_hi) load_step(step + 1);
    savqa::cp_async_commit();
    if (!active) continue;
    float* base = stages + ((step - step_lo) & 1) * kStageF;
    const float* Ks = base;
    const float* Vs = base + STEP * DH;
    float* Gs = base + 2 * STEP * DH;
    const float* kms = Gs + kBQ * STEP;
    const int nk = min(STEP, Tk - step * STEP);

    float s[R][kNC];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < kNC; ++c) s[i][c] = 0.f;
    tile_abt<DH, kNC, R>(s, Qs, wrow, Ks, dh, ly, lx);
    flash_f32_step<DH, STEP, R>(s, m, z, bs, acc, Gs, kms, Vs, nk, scale, wrow, ly, lx);
  }
  savqa::cp_async_wait<0>();
  if (!active) return;
  flash_f32_epilogue<DH, R>(m, z, bs, acc, q0 + wrow + ly, lx, Tq, C, H, dh, h, b, sp, 0, dh,
                            stat_stride, renorm, emit, n_split, query_mask, out, a_out, m_out,
                            z_out, b_out);
}

}  // namespace savqa_f32
