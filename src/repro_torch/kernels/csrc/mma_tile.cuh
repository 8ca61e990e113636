// Building blocks of the mma.sync kernel (flash_decode.cu, over code rows;
// the Hopper kernels take the width lists, the Code enum and PAGE): bf16
// fragment loads, the m16n8k16 tensor-core product, the loads of int8 /
// e4m3 code tiles (widened to exact bf16) with their rows' (scale, zp),
// the query tile (bf16, or fp32 as three bf16 terms), the online-softmax
// update of one 64-row tile of code rows, and the (Dk, Dv) widths the
// dense, prefill and separate-V paged kernels are built for.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include "softmax_state.cuh"

namespace etap {

using bf16 = __nv_bfloat16;

constexpr int LATENT_DK = 576; // MLA latent width: kv_lora 512 + rope 64
constexpr int LATENT_DV = 512; // MLA V = the first 512 latent columns
constexpr int PAGE = 64;       // KV rows per tile (the paged pool's page)

// A list of (Dk, Dv) pairs a family of kernels is instantiated for, as
// Widths<dk0, dv0, dk1, dv1, ...>: the dispatch (with_widths) and the
// library's width query (write_widths) both read it, so the two cannot
// drift apart.
template <int... P>
struct Widths {
  static_assert(sizeof...(P) % 2 == 0, "(Dk, Dv) pairs");
  static constexpr int N = sizeof...(P) / 2;
  static constexpr int W[sizeof...(P)] = {P...};
};

// The dense decode kernels (K5-K8) over bf16 rows: DeepSeek's latent, and
// the GQA heads (Dk = Dv = head_dim) at 128 (Qwen3, Granite, LLaVA-NeXT),
// 64 (SmolLM, StableLM, MusicGen) and 256 (RecurrentGemma's local
// attention).  The paged kernels take the widths of PagedSepWidths below.
using DenseWidths =
    Widths<LATENT_DK, LATENT_DV, 128, 128, 64, 64, 256, 256>;
// The baseline over int8 / e4m3 codes (K7q, K8q): the latent, whose
// standard mode decodes the gathered code pool, and the GQA heads a
// quantized paged pool serves (128 and 64; RecurrentGemma's stack has no
// paged layout).
using QuantDenseWidths = Widths<LATENT_DK, LATENT_DV, 128, 128, 64, 64>;
// The ETAP dense kernels over codes (K5q, K6q): the GQA heads at 128 and
// 64 (the latent's ETAP decode reads its code pool in place through K1q /
// K3q).
using EtapQuantDenseWidths = Widths<128, 128, 64, 64>;
// The causal prefill kernel (K9), (D, Dv) of every full-attention model
// served: DeepSeek's decompressed MLA heads (192, 128); the GQA heads at
// 128 (Qwen3, LLaVA-NeXT, Granite) and 64 (StableLM, SmolLM, MusicGen).
// RecurrentGemma's 256-wide heads attend locally and never reach it.
using PrefillWidths = Widths<192, 128, 128, 128, 64, 64>;
// The paged bodies (K1, K3, K4 and their quantized twins) with V in a
// pool of its own: DeepSeek's latent with V beside it (the paper's shape;
// its V pool holds the fused pool's first 512 columns, so the fused
// kernel is an exact yardstick), and Granite-20B's MQA head, one [N, 64,
// 128] K pool and one V pool, the one supported model whose per-layer
// cache has the reference's separate-V layout.  The fused paged bodies
// take the latent only.
using PagedSepWidths = Widths<LATENT_DK, LATENT_DV, 128, 128>;

// f(integral_constant<DK>, integral_constant<DV>) for the pair (dk, dv) of
// list L, searched from entry I on; cudaErrorInvalidValue for any other
// pair.
template <class L, int I = 0, class F>
int with_widths(int dk, int dv, F&& f) {
  if constexpr (I == L::N) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    constexpr int DK = L::W[2 * I], DV = L::W[2 * I + 1];
    if (dk == DK && dv == DV)
      return f(std::integral_constant<int, DK>{},
               std::integral_constant<int, DV>{});
    return with_widths<L, I + 1>(dk, dv, f);
  }
}

// Write list L's pairs to out[2 i], out[2 i + 1] (at most cap pairs);
// returns their number.
template <class L>
int write_widths(int* out, int cap) {
  for (int i = 0; i < L::N && i < cap; ++i) {
    out[2 * i] = L::W[2 * i];
    out[2 * i + 1] = L::W[2 * i + 1];
  }
  return L::N;
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

// The element type of a KV operand: bf16 rows, or 1-byte codes (int8, or
// e4m3) with one fp32 (scale, zp) pair per row.
enum Code { kBf16, kInt8, kE4m3 };

__device__ __forceinline__ uint32_t bf16x2(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two codes (the low byte first) as exact bf16 values: every int8 code
// (-127..127) and every e4m3 code is a bf16 number (e4m3 -> f16 -> bf16).
template <int CODE>
__device__ __forceinline__ uint32_t widen2(uint32_t two) {
  if constexpr (CODE == kInt8) {
    return bf16x2(static_cast<float>(static_cast<int8_t>(two & 0xffu)),
                  static_cast<float>(static_cast<int8_t>((two >> 8) & 0xffu)));
  } else {
    const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(two & 0xffffu), __NV_E4M3);
    const float2 f = __half22float2(__half2(h));
    return bf16x2(f.x, f.y);
  }
}

// Load `rows` rows of `width` codes (a multiple of 16) from src (row
// stride ld bytes; src and ld 16-byte aligned), 16 codes per 16-byte load,
// widened to bf16 into smem (row stride sstr); rows in [rows, PAGE) are
// zero.  All threads take part; the caller synchronises.
template <int CODE, int NTHREAD>
__device__ __forceinline__ void load_code_tile(bf16* smem, int sstr,
                                               const uint8_t* src, size_t ld,
                                               int rows, int width) {
  const int chunks = width / 16;
  for (int i = threadIdx.x; i < PAGE * chunks; i += NTHREAD) {
    const int r = i / chunks, cc = i % chunks;
    uint4* dst = reinterpret_cast<uint4*>(&smem[r * sstr + cc * 16]);
    if (r >= rows) {
      dst[0] = dst[1] = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    const uint4 v =
        __ldg(reinterpret_cast<const uint4*>(src + (size_t)r * ld + cc * 16));
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    uint32_t o[8];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      o[2 * h] = widen2<CODE>(w[h]);
      o[2 * h + 1] = widen2<CODE>(w[h] >> 16);
    }
    dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
    dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
  }
}

// Load the (scale, zp) pairs of rows [0, rows) from sz (row stride ldz
// floats; sz and ldz 8-byte aligned) into dst[PAGE]; rows in [rows, PAGE)
// take (1, 0), so a zero code there decodes to 0.  Threads 0..PAGE-1 take
// part; the caller synchronises.
__device__ __forceinline__ void load_sz_tile(float2* dst, const float* sz,
                                             size_t ldz, int rows) {
  const int r = threadIdx.x;
  if (r < PAGE)
    dst[r] = r < rows ? __ldg(reinterpret_cast<const float2*>(
                            sz + (size_t)r * ldz))
                      : make_float2(1.f, 0.f);
}

// Load the NT query rows [c0, c0 + NT) of batch row b (C rows of DK, row
// stride DK) into q_hi (row stride sstr); rows at or past C are zero.  An
// fp32 q (QF32) is split into three bf16 terms, hi = bf16(x), mid =
// bf16(x - hi) and lo = bf16(x - hi - mid), into q_hi, q_mid and q_lo:
// together they carry the 24 bits of x, so products with exact bf16 codes
// summed in fp32 are the fp32 product's (two terms, 16 bits, leave a score
// 2^-18 sum|q k| off it).  qsum[i] = the fp32 sum of row c0 + i as given
// (the zp term of a code row's score).  All threads take part; the caller
// synchronises.
template <bool QF32, int NT, int NTHREAD, int DK>
__device__ __forceinline__ void load_q_tile(bf16* q_hi, bf16* q_mid,
                                            bf16* q_lo, int sstr,
                                            float* qsum, const void* q, int b,
                                            int C, int c0) {
  using QT = typename std::conditional<QF32, float, bf16>::type;
  const QT* qg = static_cast<const QT*>(q) + ((size_t)b * C + c0) * DK;
  if constexpr (QF32) {
    for (int i = threadIdx.x; i < NT * (DK / 4); i += NTHREAD) {
      const int r = i / (DK / 4), cc = i % (DK / 4);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c0 + r < C)
        v = reinterpret_cast<const float4*>(qg + (size_t)r * DK)[cc];
      const float x[4] = {v.x, v.y, v.z, v.w};
      bf16 hi[4], mid[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hi[e] = __float2bfloat16_rn(x[e]);
        const float rem = x[e] - __bfloat162float(hi[e]);    // exact
        mid[e] = __float2bfloat16_rn(rem);
        lo[e] = __float2bfloat16_rn(rem - __bfloat162float(mid[e]));
      }
      *reinterpret_cast<uint2*>(&q_hi[r * sstr + cc * 4]) =
          make_uint2(pack(hi[0], hi[1]), pack(hi[2], hi[3]));
      *reinterpret_cast<uint2*>(&q_mid[r * sstr + cc * 4]) =
          make_uint2(pack(mid[0], mid[1]), pack(mid[2], mid[3]));
      *reinterpret_cast<uint2*>(&q_lo[r * sstr + cc * 4]) =
          make_uint2(pack(lo[0], lo[1]), pack(lo[2], lo[3]));
    }
  } else {
    for (int i = threadIdx.x; i < NT * (DK / 8); i += NTHREAD) {
      const int r = i / (DK / 8), cc = i % (DK / 8);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (c0 + r < C)
        v = reinterpret_cast<const uint4*>(qg + (size_t)r * DK)[cc];
      *reinterpret_cast<uint4*>(&q_hi[r * sstr + cc * 8]) = v;
    }
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int col = warp; col < NT; col += NTHREAD / 32) {  // a warp a row
    float acc = 0.f;
    if (c0 + col < C)
      for (int d = lane; d < DK; d += 32)
        acc += static_cast<float>(qg[(size_t)col * DK + d]);
#pragma unroll
    for (int off = 16; off; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) qsum[col] = acc;
  }
}

// Online-softmax update of one head row (the baseline over code rows,
// flash_decode.cu) over a 64-row tile, run by a half-warp: lane r (0..15)
// holds the scaled, masked scores of tile rows r, r+16, r+32, r+48 in sv,
// and advances the row's (m, l) in shared memory, leaving its rescale
// factor in corr.  The recurrence is softmax_state.update: amla keeps m an
// integer log2 bias and rescales by an exact power of two.
//
// The tile's V rows are codes with a per-row (scale, zp) in rsz, so
// V^T P^T = sum_r codes_r (scale_r p_r) + (sum_r zp_r p_r) on every Dv row.
// w_r = scale_r * p_r is written as three bf16 terms, hi, mid and lo (to
// p_hi[r + 16 i], p_mid, p_lo), which carry its 24 bits: an output near 0
// is the difference of sum_r codes_r w_r and sum_r zp_r p_r, which
// cancel, so two terms (2^-18 of each w) leave it off the fp32 product by
// more than the fp32 tolerance (1.2e-5 on a Qwen3-8B layer, on an H100).
// The row's sum_r zp_r p_r goes to *zsum; l still sums the plain p.
__device__ __forceinline__ void tile_update(float sv[4], int r, bool amla,
                                            bf16* p_hi, bf16* p_lo, float* m,
                                            float* l, float* corr,
                                            const float2* rsz, float* zsum,
                                            bf16* p_mid) {
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
    const float2 sz = rsz[r + 16 * i];
    const float w = p * sz.x;
    zs += p * sz.y;
    const bf16 hi = __float2bfloat16_rn(w);
    p_hi[r + 16 * i] = hi;
    const float rem = w - __bfloat162float(hi);          // exact
    const bf16 mid = __float2bfloat16_rn(rem);
    p_mid[r + 16 * i] = mid;
    p_lo[r + 16 * i] = __float2bfloat16_rn(rem - __bfloat162float(mid));
  }
#pragma unroll
  for (int off = 8; off; off >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
    zs += __shfl_xor_sync(0xffffffffu, zs, off);
  }
  __syncwarp();
  if (r == 0) {
    const float c = stat_weight(m_old - m_new, amla);
    *corr = c;
    *l = *l * c + sum;
    *m = m_new;
    *zsum = zs;
  }
}

}  // namespace etap
