// What the Hopper kernels share beside hopper.cuh: the (Dk, Dv) widths
// each family of kernels is built for (the dense decode, quantized dense
// decode, causal prefill and separate-V paged kernels) with their dispatch
// and query, the page of 64 KV rows, the element types of a KV operand, and
// the packing of two bf16 values into one 32-bit word.
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

__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The element type of a KV operand: bf16 rows, or 1-byte codes (int8, or
// e4m3) with one fp32 (scale, zp) pair per row.
enum Code { kBf16, kInt8, kE4m3 };

}  // namespace etap
