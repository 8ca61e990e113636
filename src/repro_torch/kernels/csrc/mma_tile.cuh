// Building blocks shared by the hand-written decode kernels (etap_body.cuh,
// flash_decode.cu): bf16 fragment loads, the m16n8k16 tensor-core product,
// cp.async tile copies, the online-softmax update of one 64-row KV tile, and
// the (Dk, Dv) widths the dense kernels are built for.  Both orientations
// run the SAME update code, so the ETAP and the untransposed kernels differ
// only in which operand rides the M side.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "softmax_state.cuh"

namespace etap {

using bf16 = __nv_bfloat16;

constexpr int LATENT_DK = 576; // MLA latent width: kv_lora 512 + rope 64
constexpr int LATENT_DV = 512; // MLA V = the first 512 latent columns
constexpr int PAGE = 64;       // KV rows per tile (the paged pool's page)

// The (Dk, Dv) pairs the dense decode kernels (K5-K8) are instantiated for:
// DeepSeek's latent, and a 128-wide GQA head (Dk = Dv = head_dim: Qwen3,
// Granite, the Llama family).  The paged and quantized kernels take the
// latent only.
constexpr int N_DENSE_WIDTHS = 2;
constexpr int DENSE_WIDTHS[N_DENSE_WIDTHS][2] = {{LATENT_DK, LATENT_DV},
                                                 {128, 128}};

// f(integral_constant<DK>, integral_constant<DV>) for the DENSE_WIDTHS pair
// (dk, dv), searched from entry I on; cudaErrorInvalidValue for any other
// pair.
template <int I = 0, class F>
int with_dense_widths(int dk, int dv, F&& f) {
  if constexpr (I == N_DENSE_WIDTHS) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    constexpr int DK = DENSE_WIDTHS[I][0], DV = DENSE_WIDTHS[I][1];
    if (dk == DK && dv == DV)
      return f(std::integral_constant<int, DK>{},
               std::integral_constant<int, DV>{});
    return with_dense_widths<I + 1>(dk, dv, f);
  }
}

// Write the DENSE_WIDTHS pairs to out[2 i], out[2 i + 1] (at most cap
// pairs); returns their number.
inline int write_dense_widths(int* out, int cap) {
  for (int i = 0; i < N_DENSE_WIDTHS && i < cap; ++i) {
    out[2 * i] = DENSE_WIDTHS[i][0];
    out[2 * i + 1] = DENSE_WIDTHS[i][1];
  }
  return N_DENSE_WIDTHS;
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D += A(16x16, row) * B(16x8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma16816(float* d, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Copy `rows` rows of `width` bf16 (a multiple of 8) from src (row stride
// ld elements) into smem (row stride sstr) with cp.async; rows in
// [rows, PAGE) are zero-filled when `zero` is set.  All threads take part.
template <int NTHREAD>
__device__ __forceinline__ void load_tile(bf16* smem, int sstr,
                                          const bf16* src, size_t ld,
                                          int rows, int width, bool zero) {
  const int chunks = width / 8;
  for (int i = threadIdx.x; i < PAGE * chunks; i += NTHREAD) {
    const int r = i / chunks, cc = i % chunks;
    if (r < rows)
      cp_async16(&smem[r * sstr + cc * 8], src + (size_t)r * ld + cc * 8);
    else if (zero)
      *reinterpret_cast<uint4*>(&smem[r * sstr + cc * 8]) =
          make_uint4(0u, 0u, 0u, 0u);
  }
}

// Online-softmax update of one query column (ETAP) or head row (standard)
// over a 64-row tile, run by a half-warp: lane r (0..15) holds the scaled,
// masked scores of tile rows r, r+16, r+32, r+48 in sv.  Writes the
// probabilities as bf16 hi + lo terms to p_hi/p_lo[r + 16 i], and advances
// the column's (m, l) in shared memory, leaving its rescale factor in corr.
// The recurrence is softmax_state.update: amla keeps m an integer log2 bias
// and rescales by an exact power of two.
//
// QUANT: the tile's V rows are codes with a per-row (scale, zp) in rsz, so
// V^T P^T = sum_r codes_r (scale_r p_r) + (sum_r zp_r p_r) on every Dv row.
// The hi + lo terms then carry scale_r * p_r, and the column's
// sum_r zp_r p_r goes to *zsum; l still sums the plain p.
template <bool QUANT = false>
__device__ __forceinline__ void tile_update(float sv[4], int r, bool amla,
                                            bf16* p_hi, bf16* p_lo, float* m,
                                            float* l, float* corr,
                                            const float2* rsz = nullptr,
                                            float* zsum = nullptr) {
  float mx = NEG_INF * LOG2E;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (amla) sv[i] = sv[i] * LOG2E;           // log2 domain
    mx = fmaxf(mx, sv[i]);
  }
#pragma unroll
  for (int off = 8; off; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  const float block_m = amla ? ceilf(mx) : mx;
  const float m_old = *m;
  const float m_new = fmaxf(m_old, block_m);
  float sum = 0.f, zs = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float p = prob_exp(sv[i] - m_new, amla);
    sum += p;
    float w = p;
    if constexpr (QUANT) {
      const float2 sz = rsz[r + 16 * i];
      w = p * sz.x;
      zs += p * sz.y;
    }
    const bf16 hi = __float2bfloat16_rn(w);
    p_hi[r + 16 * i] = hi;
    p_lo[r + 16 * i] = __float2bfloat16_rn(w - __bfloat162float(hi));
  }
#pragma unroll
  for (int off = 8; off; off >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if constexpr (QUANT) zs += __shfl_xor_sync(0xffffffffu, zs, off);
  }
  __syncwarp();
  if (r == 0) {
    const float c = stat_weight(m_old - m_new, amla);
    *corr = c;
    *l = *l * c + sum;
    *m = m_new;
    if constexpr (QUANT) *zsum = zs;
  }
}

}  // namespace etap
