// Paged ETAP decode over separate K and V code pools for Hopper (sm_90a):
// etap_decode.cuh's kernel (wgmma on the page's 64 rows, a TMA ring,
// warp-specialised; code boxes widened in place to bf16 by the producer
// warpgroup's converters), which says what they compute and how (its
// "Over codes").  K and V each sit in their own paged pool [N, 64, D*] of
// int8 / e4m3 codes, read through one block table, each with its own
// (scale, zp) pool [N, 64, 2].
//
//   K3q single-pass paged decode   replaces repro/kernels/etap/etap.py:237
//       (_paged_call :185, body _paged_body_quant :110, reached from
//        etap_decode_paged_pallas :247)
//   K1q split-KV phase 1           replaces repro/kernels/etap/etap.py:713
//       (etap_paged_partial_pallas :646, body _paged_partial_body_quant
//        :631)
//
// The bf16 K3 / K1 over separate pools (bodies _paged_body :98 and
// _paged_partial_body :619) are etap_decode.cu's instances of the same
// kernel, and K4 / K4q, the chunked prefill and verify over bf16 and code
// pools, etap_prefill.cu's.
//
// Built at mma_tile.cuh's PagedSepWidths: DeepSeek's latent (576, 512)
// with V in its own pool, and Granite-20B's MQA head (128, 128).  The
// fused and separate-V instances differ only in where V's boxes and pairs
// come from, so at the latent, over a V pool that holds the fused pool's
// first 512 columns and pairs, they give the fused kernels' bits.  The
// code type is a run-time argument, fp32 q a template one.
//
// What bounds them on the H100: the K and V code bytes with both pairs
// over 3.35 TB/s: 1104 B a latent row, 272 B at 128.
#include "etap_decode.cuh"

namespace {

// The separate-V instance at (dk, dv) of PagedSepWidths, with fp32 q when
// qf32 is set.
template <bool STATS>
int launch_sepv(const Operands& a, const Params& p, int dk, int dv, int qf32,
                int B, void* stream) {
  return with_widths<PagedSepWidths>(dk, dv, [&](auto DK, auto DV) {
    constexpr int K = decltype(DK)::value, V = decltype(DV)::value;
    return qf32 ? launch_decode<STATS, false, K, V, true, true, true>(
                      a, p, B, stream)
                : launch_decode<STATS, false, K, V, true, true, false>(
                      a, p, B, stream);
  });
}

template <bool STATS>
int attrs_sepv(int dk, int dv, int qf32, int cols, int* out) {
  return with_widths<PagedSepWidths>(dk, dv, [&](auto DK, auto DV) {
    constexpr int K = decltype(DK)::value, V = decltype(DV)::value;
    return qf32 ? attrs_decode<STATS, false, K, V, true, true, true>(cols,
                                                                     out)
                : attrs_decode<STATS, false, K, V, true, true, false>(cols,
                                                                      out);
  });
}

// The separate-V paged parameters: K's and V's code pools and their
// (scale, zp) pools, read through one table.
Params sepv_params(Operands& a, const void* q, const void* k_pool,
                   const float* k_sz, const void* v_pool, const float* v_sz,
                   const int* table, const int* lengths, int C, int nbt,
                   int n_splits, float scale, int amla, int code) {
  a = Operands{};
  a.q = q;
  a.k = k_pool;
  a.v = v_pool;
  a.kvh = 1;
  Params p = decode_params(table, lengths, C, nbt, n_splits, scale, amla);
  quant_params(p, code, k_sz, 0, 0, 0, v_sz, 0, 0, 0);
  return p;
}

}  // namespace

extern "C" {

// The (Dk, Dv) pairs the separate-V paged kernels take (written to out as
// dk, dv, ...; returns their number).
int etap_paged_sepv_widths(int* out, int cap) {
  return write_widths<PagedSepWidths>(out, cap);
}

// The decode instances' attributes (etap_decode.cu).
int etap_decode_attrs(int dense, int dk, int dv, int sepv, int stats,
                      int cols, int q, int* out);

// The registers, dynamic shared memory and local memory of the separate-V
// K3q / K1q instance at (dk, dv) of PagedSepWidths, single pass (stats 0)
// or split (stats 1), with fp32 q when qf32 is set, at units of `cols`
// columns, into out[0..2]; etap_decode_attrs (etap_decode.cu) forwards
// here.
int etap_sepv_cols_attrs(int dk, int dv, int stats, int qf32, int cols,
                         int* out) {
  return stats ? attrs_sepv<true>(dk, dv, qf32, cols, out)
               : attrs_sepv<false>(dk, dv, qf32, cols, out);
}

// The same for the separate-V K3 (stats 0) or K1 (stats 1) instance at
// (dk, dv) over bf16 pools (code -1) or int8 (0) / e4m3 (1) codes (one
// instance: the code type is a run-time argument), with fp32 q when qf32
// is set (codes only), at its widest units (unit_cap).
int etap_paged_sepv_attrs(int dk, int dv, int stats, int code, int qf32,
                          int* out) {
  if (code < -1 || code > 1 || (code < 0 && qf32))
    return static_cast<int>(cudaErrorInvalidValue);
  return etap_decode_attrs(0, dk, dv, 1, stats,
                           unit_cap(dk, code >= 0, qf32 != 0),
                           code < 0 ? -1 : qf32, out);
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
  Operands a;
  Params p = sepv_params(a, q, k_pool, k_sz, v_pool, v_sz, table, lengths,
                         H, nbt, 1, scale, amla, code);
  p.out = out;
  return launch_sepv<false>(a, p, dk, dv, qf32, B, stream);
}

int etap_paged_partial_sepv_quant(const void* q, const void* k_pool,
                                  const float* k_sz, const void* v_pool,
                                  const float* v_sz, const int* table,
                                  const int* lengths, float* m_out,
                                  float* l_out, float* acc_out, int B, int H,
                                  int nbt, int n_splits, int dk, int dv,
                                  float scale, int amla, int code, int qf32,
                                  void* stream) {
  if (n_splits <= 0 || nbt % n_splits != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Operands a;
  Params p = sepv_params(a, q, k_pool, k_sz, v_pool, v_sz, table, lengths,
                         H, nbt, n_splits, scale, amla, code);
  p.m_out = m_out;
  p.l_out = l_out;
  p.acc_out = acc_out;
  return launch_sepv<true>(a, p, dk, dv, qf32, B, stream);
}

}  // extern "C"
