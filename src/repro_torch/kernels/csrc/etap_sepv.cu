// Paged ETAP attention over separate K and V code pools for Hopper
// (sm_90a): the quantized separate-V instantiations of etap_body.cuh's
// body, which says what they compute and how (its "Address modes").  K and
// V each sit in their own paged pool [N, 64, D*] of int8 / e4m3 codes,
// read through one block table, each with its own (scale, zp) pool
// [N, 64, 2].
//
//   K3q single-pass paged decode   replaces repro/kernels/etap/etap.py:237
//       (_paged_call :185, body _paged_body_quant :110, reached from
//        etap_decode_paged_pallas :247)
//   K1q split-KV phase 1           replaces repro/kernels/etap/etap.py:713
//       (etap_paged_partial_pallas :646, body _paged_partial_body_quant
//        :631)
//
// The bf16 K3 / K1 over separate pools (bodies _paged_body :98 and
// _paged_partial_body :619) are etap_decode.cu's, and K4 / K4q, the
// chunked prefill and verify over bf16 and code pools (bodies
// _etap_prefill_body :271, _verify_body :348, _prefill_body_quant :334 and
// _verify_body_quant :360), etap_prefill.cu's, both on wgmma and TMA.
//
// Built at mma_tile.cuh's PagedSepWidths: DeepSeek's latent (576, 512)
// with V in its own pool, and Granite-20B's MQA head (128, 128), as the
// body's SEPV instances (the fused ones in etap_quant.cu carry none of the
// separate-V code).  The V tile replaces the K tile's first Dv columns
// after the score product, so a separate V adds no shared memory, and at
// the latent, over a V pool that holds the fused pool's first 512 columns
// and pairs, the kernels give the fused ones' bits.
//
// What bounds them on the H100: the K and V code bytes with both pairs,
// each read once per head tile, over 3.35 TB/s: 1104 B a latent row, 272 B
// at 128.
#include "etap_body.cuh"

namespace {

// The instance of list PagedSepWidths at (dk, dv) for STATS, CODE and
// fp32 q: f(launch or attrs of that instance).
template <bool STATS, int CODE, bool QF32, class F>
int with_instance(int dk, int dv, F&& f) {
  return with_widths<PagedSepWidths>(dk, dv, [&](auto DK, auto DV) {
    return f(std::integral_constant<int, decltype(DK)::value>{},
             std::integral_constant<int, decltype(DV)::value>{},
             std::bool_constant<STATS>{}, std::integral_constant<int, CODE>{},
             std::bool_constant<QF32>{});
  });
}

// Launch the paged instance for (dk, dv), STATS, the pools' code type
// (0 int8, 1 e4m3) and whether q is fp32.
template <bool STATS>
int launch(const Params& p, int dk, int dv, int code, int B, int n_splits,
           void* stream) {
  auto go = [&](auto DK, auto DV, auto ST, auto CD, auto QF) {
    return launch_mode<decltype(ST)::value, false, decltype(CD)::value,
                       decltype(QF)::value, decltype(DK)::value,
                       decltype(DV)::value, true>(p, B, n_splits, stream);
  };
  if (code == 0)
    return p.qf32 ? with_instance<STATS, kInt8, true>(dk, dv, go)
                  : with_instance<STATS, kInt8, false>(dk, dv, go);
  if (code == 1)
    return p.qf32 ? with_instance<STATS, kE4m3, true>(dk, dv, go)
                  : with_instance<STATS, kE4m3, false>(dk, dv, go);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The separate-V paged parameters: K's and V's pools (and, over codes,
// their (scale, zp) pools) read through one table.
Params sepv_params(const void* q, const void* k_pool, const float* k_sz,
                   const void* v_pool, const float* v_sz, const int* table,
                   int C, int nbt, float scale, int amla, int qf32) {
  Params p = make_params(q, k_pool, table, C, nbt, scale, amla);
  p.sz = k_sz;
  p.v = v_pool;
  p.vsz = v_sz;
  p.qf32 = qf32;
  return p;
}

template <bool STATS>
int decode(const Params& base, const int* lengths, int dk, int dv, int code,
           int B, int n_splits, void* stream) {
  Params p = base;
  p.npb = p.nbt / n_splits;
  p.base = lengths;
  return launch<STATS>(p, dk, dv, code, B, n_splits, stream);
}

}  // namespace

extern "C" {

// The (Dk, Dv) pairs the separate-V paged kernels take (written to out as
// dk, dv, ...; returns their number).
int etap_paged_sepv_widths(int* out, int cap) {
  return write_widths<PagedSepWidths>(out, cap);
}

// The bf16 decode instances' attributes (etap_decode.cu).
int etap_decode_attrs(int dense, int dk, int dv, int sepv, int stats,
                      int cols, int* out);

// The registers, dynamic shared memory and local memory of the separate-V
// K3 (stats 0) or K1 (stats 1) instance at (dk, dv) over bf16 pools (code
// -1: etap_decode.cu's kernel at its widest units, 32 columns at the
// latent, 64 at 128) or int8 (0) / e4m3 (1) codes, with fp32 q when qf32
// is set, into out[0..2].
int etap_paged_sepv_attrs(int dk, int dv, int stats, int code, int qf32,
                          int* out) {
  if (code < 0)
    return etap_decode_attrs(0, dk, dv, 1, stats, dk >= 256 ? 32 : 64, out);
  auto get = [&](auto DK, auto DV, auto ST, auto CD, auto QF) {
    return attrs_of<decltype(ST)::value, false, decltype(CD)::value,
                    decltype(QF)::value, decltype(DK)::value,
                    decltype(DV)::value, true>(out);
  };
  auto pick = [&](auto ST) {
    constexpr bool S = decltype(ST)::value;
    if (code == 0)
      return qf32 ? with_instance<S, kInt8, true>(dk, dv, get)
                  : with_instance<S, kInt8, false>(dk, dv, get);
    if (code == 1)
      return qf32 ? with_instance<S, kE4m3, true>(dk, dv, get)
                  : with_instance<S, kE4m3, false>(dk, dv, get);
    return static_cast<int>(cudaErrorInvalidValue);
  };
  return stats ? pick(std::true_type{}) : pick(std::false_type{});
}

// K3q / K1q, separate V: as K3 / K1 over int8 (code 0) or e4m3
// (code 1) pools, K's and V's codes each with its own (scale, zp) pool
// [N,PAGE,2] fp32; q bf16, or fp32 with qf32 set, and out in q's type.
int etap_decode_paged_quant(const void* q, const void* k_pool,
                            const float* k_sz, const void* v_pool,
                            const float* v_sz, const int* table,
                            const int* lengths, void* out, int B, int H,
                            int nbt, int dk, int dv, float scale, int amla,
                            int code, int qf32, void* stream) {
  Params p = sepv_params(q, k_pool, k_sz, v_pool, v_sz, table, H, nbt, scale,
                         amla, qf32);
  p.out = out;
  return decode<false>(p, lengths, dk, dv, code, B, 1, stream);
}

int etap_paged_partial_sepv_quant(const void* q, const void* k_pool,
                                  const float* k_sz, const void* v_pool,
                                  const float* v_sz, const int* table,
                                  const int* lengths, float* m_out,
                                  float* l_out, float* acc_out, int B, int H,
                                  int nbt, int n_splits, int dk, int dv,
                                  float scale, int amla, int code, int qf32,
                                  void* stream) {
  Params p = sepv_params(q, k_pool, k_sz, v_pool, v_sz, table, H, nbt, scale,
                         amla, qf32);
  p.m_out = m_out;
  p.l_out = l_out;
  p.acc_out = acc_out;
  return decode<true>(p, lengths, dk, dv, code, B, n_splits, stream);
}

}  // extern "C"
