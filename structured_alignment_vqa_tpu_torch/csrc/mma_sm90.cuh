// Warp-level building blocks of the tensor-core kernels (K4's forward,
// K2's two launches, K5 and K6): inline PTX for bf16 mma.sync, ldmatrix and
// cp.async, and the two tile products built on them.
//
// Fragment layout of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4; every
// 32-bit register holds two bf16 values, the lower column or k index in the
// low half):
//   A (16 x 16, row-major): a0 = A[g][2t, 2t+1]      a1 = A[g+8][2t, 2t+1]
//                           a2 = A[g][2t+8, 2t+9]    a3 = A[g+8][2t+8, 2t+9]
//   B (16 x 8):             b0 = B[2t, 2t+1][g]      b1 = B[2t+8, 2t+9][g]
//   C, D (16 x 8, f32):     c0, c1 = C[g][2t, 2t+1]  c2, c3 = C[g+8][2t, 2t+1]
// so two neighbouring 8-wide accumulator blocks, packed to bf16 pairs, are
// the A operand of a following product without leaving the registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace savqa {

// Two floats rounded to bf16 (round to nearest even), `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Maximum and sum over the 4 lanes of a quad, which hold the same two rows
// of an accumulator fragment.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 2^x on the special-function unit (2 ulp; 2^-inf = 0, denormals flushed).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// D += A B for one 16 x 8 tile, k = 16, bf16 operands, f32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from shared memory. Lane l gives the address of
// row l % 8 of matrix l / 8 (16 bytes, 16-byte aligned); register i of lane
// l receives elements [l / 4][2 (l % 4), 2 (l % 4) + 1] of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The same with every matrix transposed: register i of lane l receives
// elements [2 (l % 4), 2 (l % 4) + 1][l / 4] of matrix i.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Asynchronous copy of 16 bytes (both addresses 16-byte aligned) or of 4
// bytes from device to shared memory, past L1. With `valid` false nothing
// is read and the destination is filled with zeros; src must still be a
// valid address.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(addr), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [row0, row0 + tile) x head channels [c0, c0 + DH) of x (n_rows, C)
// bf16 into dst (tile, DH + 8), 16 bytes a copy; rows from n_rows on and
// channels from dh on (dh <= DH, both multiples of 8) are zeros. The 8
// padding elements of a row are never read: they make the row stride an odd
// number of 16-byte units, which keeps ldmatrix free of bank conflicts.
template <int DH, int THREADS>
__device__ __forceinline__ void stage_head_tile(__nv_bfloat16* dst,
                                                const __nv_bfloat16* __restrict__ x, int row0,
                                                int n_rows, int tile, int C, int c0, int dh) {
  constexpr int kChunks = DH / 8;
  for (int i = threadIdx.x; i < tile * kChunks; i += THREADS) {
    const int r = i / kChunks, d = (i - r * kChunks) * 8;
    const bool valid = row0 + r < n_rows && d < dh;
    const __nv_bfloat16* src = valid ? x + (size_t)(row0 + r) * C + c0 + d : x;
    cp_async16(dst + r * (DH + 8) + d, src, valid);
  }
}

// The address lane `lane` gives ldmatrix_x4 for the A operand: the 16 x 16
// block at (row0, k0) of a row-major tile with row stride ld.
__device__ __forceinline__ const __nv_bfloat16* frag_a_row(const __nv_bfloat16* tile, int ld,
                                                           int row0, int k0, int lane) {
  return tile + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + k0 + (lane >> 4) * 8;
}

// For the B operand of X Y^T, Y (n, k) row-major: the registers are b0, b1
// of the 8-wide block at n0 and b0, b1 of the block at n0 + 8, k0 .. k0+15.
__device__ __forceinline__ const __nv_bfloat16* frag_b_row(const __nv_bfloat16* tile, int ld,
                                                           int n0, int k0, int lane) {
  return tile + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 + ((lane >> 3) & 1) * 8;
}

// For the B operand of X Y, Y (k, n) row-major, with ldmatrix_x4_trans: the
// registers are b0, b1 of the block at n0 and b0, b1 of the block at n0 + 8,
// k0 .. k0+15.
__device__ __forceinline__ const __nv_bfloat16* frag_bt_row(const __nv_bfloat16* tile, int ld,
                                                            int k0, int n0, int lane) {
  return tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 + (lane >> 4) * 8;
}

// The graph entries of a lane's score fragments for NB 8-wide blocks of
// keys: g[nb] = graph[row_a][j, j + 1], graph[row_b][j, j + 1] at j = j_first
// + 8 nb (j_first even), zeros past n_keys and on a row that is not real.
// graph_a and graph_b point at the two rows (any valid row when not real).
// With `pairs` (n_keys even: two adjacent entries are 8-byte aligned) one
// 8-byte load fetches a pair.
template <int NB>
__device__ __forceinline__ void load_graph_frag(float (&g)[NB][4],
                                                const float* __restrict__ graph_a,
                                                const float* __restrict__ graph_b, int j_first,
                                                int n_keys, bool real_a, bool real_b,
                                                bool pairs) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    const int j = j_first + nb * 8;
    if (pairs) {
      const float2 zero = make_float2(0.f, 0.f);
      const float2 ga =
          j < n_keys && real_a ? __ldg(reinterpret_cast<const float2*>(graph_a + j)) : zero;
      const float2 gb =
          j < n_keys && real_b ? __ldg(reinterpret_cast<const float2*>(graph_b + j)) : zero;
      g[nb][0] = ga.x; g[nb][1] = ga.y; g[nb][2] = gb.x; g[nb][3] = gb.y;
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool in = j + (c & 1) < n_keys && (c < 2 ? real_a : real_b);
        g[nb][c] = in ? __ldg((c < 2 ? graph_a : graph_b) + j + (c & 1)) : 0.f;
      }
    }
  }
}

// acc (16 x 8 NB a warp) = A B^T: A the warp's 16 x DH operand in fragments,
// B the first 8 NB rows of a row-major (rows, DH + 8) bf16 tile. Only the
// first n_real rows of the tile are real: 8-wide blocks past them are
// skipped and left at zero.
template <int DH, int NB>
__device__ __forceinline__ void product_abt(float (&acc)[NB][4], const uint32_t (&af)[DH / 16][4],
                                            const __nv_bfloat16* tile, int lane, int n_real) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
#pragma unroll
  for (int kd = 0; kd < DH / 16; ++kd) {
    uint32_t bfr[NB / 2][4];
#pragma unroll
    for (int nb = 0; nb < NB; nb += 2)
      if (nb * 8 < n_real) ldmatrix_x4(bfr[nb / 2], frag_b_row(tile, DH + 8, nb * 8, kd * 16, lane));
#pragma unroll
    for (int nb = 0; nb < NB; nb += 2) {
      if (nb * 8 < n_real) {
        mma_bf16(acc[nb], af[kd], bfr[nb / 2][0], bfr[nb / 2][1]);
        mma_bf16(acc[nb + 1], af[kd], bfr[nb / 2][2], bfr[nb / 2][3]);
      }
    }
  }
}

// product_abt with A read from shared memory where it is needed: the
// warp's 16 rows from a_row0 of a row-major (rows, DH + 8) bf16 tile, one
// 16-deep block at a time (above head width 128, where A's DH / 4 registers
// a thread would not fit beside the output's DH / 2).
template <int DH, int NB>
__device__ __forceinline__ void product_abt_smem(float (&acc)[NB][4], const __nv_bfloat16* a_tile,
                                                 int a_row0, const __nv_bfloat16* tile, int lane,
                                                 int n_real) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
#pragma unroll
  for (int kd = 0; kd < DH / 16; ++kd) {
    uint32_t af[4];
    ldmatrix_x4(af, frag_a_row(a_tile, DH + 8, a_row0, kd * 16, lane));
    uint32_t bfr[NB / 2][4];
#pragma unroll
    for (int nb = 0; nb < NB; nb += 2)
      if (nb * 8 < n_real) ldmatrix_x4(bfr[nb / 2], frag_b_row(tile, DH + 8, nb * 8, kd * 16, lane));
#pragma unroll
    for (int nb = 0; nb < NB; nb += 2) {
      if (nb * 8 < n_real) {
        mma_bf16(acc[nb], af, bfr[nb / 2][0], bfr[nb / 2][1]);
        mma_bf16(acc[nb + 1], af, bfr[nb / 2][2], bfr[nb / 2][3]);
      }
    }
  }
}

// out (16 x DH a warp) += W B: W (16 x 8 NB) accumulator fragments, rounded
// to bf16 here and used as the A operand as they are, B the first 8 NB rows
// of a row-major (rows, DH + 8) bf16 tile, of which the first n_real are
// real (16-deep blocks past them are skipped: W is zero there). Above head
// width 128 B's fragments are read two 8-wide blocks at a time.
template <int DH, int NB>
__device__ __forceinline__ void accumulate_ab(float (&out)[DH / 8][4], const float (&w)[NB][4],
                                              const __nv_bfloat16* tile, int lane, int n_real) {
#pragma unroll
  for (int kk = 0; kk < NB / 2; ++kk) {
    if (kk * 16 >= n_real) continue;
    uint32_t wf[4];
    wf[0] = pack_bf16(w[2 * kk][0], w[2 * kk][1]);
    wf[1] = pack_bf16(w[2 * kk][2], w[2 * kk][3]);
    wf[2] = pack_bf16(w[2 * kk + 1][0], w[2 * kk + 1][1]);
    wf[3] = pack_bf16(w[2 * kk + 1][2], w[2 * kk + 1][3]);
    if constexpr (DH > 128) {
#pragma unroll
      for (int nd = 0; nd < DH / 8; nd += 2) {
        uint32_t bfr[4];
        ldmatrix_x4_trans(bfr, frag_bt_row(tile, DH + 8, kk * 16, nd * 8, lane));
        mma_bf16(out[nd], wf, bfr[0], bfr[1]);
        mma_bf16(out[nd + 1], wf, bfr[2], bfr[3]);
      }
      continue;
    }
    uint32_t bfr[DH / 16][4];
#pragma unroll
    for (int nd = 0; nd < DH / 8; nd += 2)
      ldmatrix_x4_trans(bfr[nd / 2], frag_bt_row(tile, DH + 8, kk * 16, nd * 8, lane));
#pragma unroll
    for (int nd = 0; nd < DH / 8; nd += 2) {
      mma_bf16(out[nd], wf, bfr[nd / 2][0], bfr[nd / 2][1]);
      mma_bf16(out[nd + 1], wf, bfr[nd / 2][2], bfr[nd / 2][3]);
    }
  }
}

}  // namespace savqa
