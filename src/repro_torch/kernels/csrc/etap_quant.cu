// ETAP decode over int8 / e4m3 codes for Hopper (sm_90a): etap_decode.cuh's
// kernel (wgmma on the page's 64 rows, a TMA ring, warp-specialised; code
// boxes widened in place to bf16 by the producer warpgroup's converters),
// which says what they compute and how (its "Over codes").
//
//   K3q  single-pass paged decode  replaces the quantized MLA-fused body
//        over the latent code      _paged_body_quant_fused :116 of
//        pool                      repro/kernels/etap/etap.py:237 (built on
//                                  _dequant :31)
//   K1q  split-KV phase 1 over it  replaces _paged_partial_body_quant_fused
//                                  :639 of repro/kernels/etap/etap.py:713
//   K5q  single-pass dense decode  the GQA decode over a quantized paged
//   K6q  dense split-KV phase 1    pool, which gathers the codes and pairs
//                                  (the reference gathers and dequantizes
//                                  them to fp32, repro/models/attention.py:
//                                  249-260, and feeds K5 / K6 the fp32 rows:
//                                  repro/kernels/etap/etap.py:154, :603)
//
// K3q / K1q read the latent code pool [N, 64, 576] in place, V the page's
// first 512 codes with K's pairs; K5q / K6q are built at mma_tile.cuh's
// EtapQuantDenseWidths, the 128- and 64-wide heads, over [B, S, K, hd]
// code caches and their [B, S, K, 2] pairs read in place.  The separate-V
// paged twins are etap_sepv.cu's, K4q (the chunked prefill and verify over
// the same pools) etap_prefill.cu's.  The code type is a run-time
// argument, fp32 q a template one.
//
// What bounds them on the H100: the code bytes (1 per element, plus 8 per
// row for the pair) over 3.35 TB/s, half of the bf16 rows'.
#include "etap_decode.cuh"

namespace {

// The paged instance (the fused latent) or the dense one at (dk, dv) of
// EtapQuantDenseWidths, with fp32 q when qf32 is set.
template <bool STATS, bool DENSE>
int launch_q(const Operands& a, const Params& p, int dk, int dv, int qf32,
             int B, void* stream) {
  if constexpr (DENSE) {
    return with_widths<EtapQuantDenseWidths>(dk, dv, [&](auto DK, auto DV) {
      constexpr int K = decltype(DK)::value, V = decltype(DV)::value;
      return qf32 ? launch_decode<STATS, true, K, V, true, true, true>(
                        a, p, B, stream)
                  : launch_decode<STATS, true, K, V, true, true, false>(
                        a, p, B, stream);
    });
  } else {
    if (dk != LATENT_DK || dv != LATENT_DV)
      return static_cast<int>(cudaErrorInvalidValue);
    return qf32 ? launch_decode<STATS, false, LATENT_DK, LATENT_DV, false,
                                true, true>(a, p, B, stream)
                : launch_decode<STATS, false, LATENT_DK, LATENT_DV, false,
                                true, false>(a, p, B, stream);
  }
}

template <bool STATS, bool DENSE>
int attrs_q(int dk, int dv, int qf32, int cols, int* out) {
  if constexpr (DENSE) {
    return with_widths<EtapQuantDenseWidths>(dk, dv, [&](auto DK, auto DV) {
      constexpr int K = decltype(DK)::value, V = decltype(DV)::value;
      return qf32 ? attrs_decode<STATS, true, K, V, true, true, true>(cols,
                                                                      out)
                  : attrs_decode<STATS, true, K, V, true, true, false>(cols,
                                                                       out);
    });
  } else {
    if (dk != LATENT_DK || dv != LATENT_DV)
      return static_cast<int>(cudaErrorInvalidValue);
    return qf32 ? attrs_decode<STATS, false, LATENT_DK, LATENT_DV, false,
                               true, true>(cols, out)
                : attrs_decode<STATS, false, LATENT_DK, LATENT_DV, false,
                               true, false>(cols, out);
  }
}

// The paged operands: q and the latent code pool.
Operands paged_operands(const void* q, const void* pool) {
  Operands a{};
  a.q = q;
  a.k = pool;
  a.kvh = 1;
  return a;
}

// The dense operands: row b of q's B reads K codes at k + (b / kvh) kb +
// (b % kvh) kh + s ldk for s < S (V alike, or null: K's first dv codes,
// with K's pairs).
Operands dense_operands(const void* q, const void* k, long long kb, int ldk,
                        const void* v, long long vb, int ldv, int S, int kvh,
                        long long kh, long long vh) {
  Operands a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.kb = kb;
  a.kh = kh;
  a.ldk = ldk;
  a.vb = vb;
  a.vh = vh;
  a.ldv = ldv;
  a.S = S;
  a.kvh = kvh;
  return a;
}

}  // namespace

extern "C" {

// The (Dk, Dv) pairs K5q / K6q take (written to out as dk, dv, ...;
// returns their number).
int etap_dense_quant_widths(int* out, int cap) {
  return write_widths<EtapQuantDenseWidths>(out, cap);
}

// The registers, dynamic shared memory and local memory of a quantized
// decode instance into out[0..2]: the fused paged latent K3q / K1q (dense
// 0) or K5q / K6q at (dk, dv) of EtapQuantDenseWidths (dense 1), single
// pass (stats 0) or split (stats 1), with fp32 q when qf32 is set, at
// units of `cols` columns (16 up to unit_cap).
// etap_decode_attrs (etap_decode.cu) forwards here.
int etap_quant_cols_attrs(int dense, int dk, int dv, int stats, int qf32,
                          int cols, int* out) {
  if (dense)
    return stats ? attrs_q<true, true>(dk, dv, qf32, cols, out)
                 : attrs_q<false, true>(dk, dv, qf32, cols, out);
  return stats ? attrs_q<true, false>(dk, dv, qf32, cols, out)
               : attrs_q<false, false>(dk, dv, qf32, cols, out);
}

// The same for K5q (stats 0) or K6q (stats 1) at (dk, dv) over int8 (code
// 0) or e4m3 (code 1) rows at its widest units (32 columns); the code
// type is a run-time argument of the one instance.
int etap_dense_quant_attrs(int dk, int dv, int stats, int code, int qf32,
                           int* out) {
  if (code != 0 && code != 1) return static_cast<int>(cudaErrorInvalidValue);
  return etap_quant_cols_attrs(1, dk, dv, stats, qf32, 32, out);
}

// K3q / K1q: as K3 / K1 over an int8 (code 0) or e4m3 (code 1)
// pool [N,PAGE,DK] with its (scale, zp) pool sz [N,PAGE,2] fp32; q bf16,
// or fp32 with qf32 set, and out in q's type.
int etap_decode_mla_paged_quant(const void* q, const void* pool,
                                const float* sz, const int* table,
                                const int* lengths, void* out, int B, int H,
                                int nbt, float scale, int amla, int code,
                                int qf32, void* stream) {
  Params p = decode_params(table, lengths, H, nbt, 1, scale, amla);
  quant_params(p, code, sz, 0, 0, 0, nullptr, 0, 0, 0);
  p.out = out;
  return launch_q<false, false>(paged_operands(q, pool), p, LATENT_DK,
                                LATENT_DV, qf32, B, stream);
}

int etap_paged_partial_quant(const void* q, const void* pool, const float* sz,
                             const int* table, const int* lengths,
                             float* m_out, float* l_out, float* acc_out,
                             int B, int H, int nbt, int n_splits, float scale,
                             int amla, int code, int qf32, void* stream) {
  if (n_splits <= 0 || nbt % n_splits != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = decode_params(table, lengths, H, nbt, n_splits, scale, amla);
  quant_params(p, code, sz, 0, 0, 0, nullptr, 0, 0, 0);
  p.m_out = m_out;
  p.l_out = l_out;
  p.acc_out = acc_out;
  return launch_q<true, false>(paged_operands(q, pool), p, LATENT_DK,
                               LATENT_DV, qf32, B, stream);
}

// K5q: K5 (etap.cu) over int8 (code 0) or e4m3 (code 1) rows: K codes at
// k + (b / kvh)*kb + (b % kvh)*kh + s*ldk (dk wide, s < S), their pairs at
// kz + (b / kvh)*zb + (b % kvh)*zh + s*ldz; V null (its codes and pairs
// are K's, the first dv columns) or codes at v and pairs at vz with their
// own strides.  Code strides in bytes, pair strides in floats.  q [B,H,dk]
// bf16, or fp32 with qf32 set; out [B,H,dv] fp32.
int etap_decode_dense_quant(const void* q, const void* k, long long kb,
                            int ldk, const void* v, long long vb, int ldv,
                            int S, const int* lengths, int kvh, long long kh,
                            long long vh, int dk, int dv, const float* kz,
                            long long zb, long long zh, int ldz,
                            const float* vz, long long vzb, long long vzh,
                            int ldvz, int code, int qf32, void* out, int B,
                            int H, float scale, int amla, void* stream) {
  if (S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Params p = decode_params(nullptr, lengths, H, (S + PAGE - 1) / PAGE, 1,
                           scale, amla);
  quant_params(p, code, kz, zb, zh, ldz, vz, vzb, vzh, ldvz);
  p.kvh = kvh;
  p.S = S;
  p.out = out;
  return launch_q<false, true>(
      dense_operands(q, k, kb, ldk, v, vb, ldv, S, kvh, kh, vh), p, dk, dv,
      qf32, B, stream);
}

// K6q: as K5q, cut into n_splits splits of tps 64-row tiles each (rows
// past S read as zero); writes fp32 m, l [B,n,H] and acc [B,n,dv,H].
int etap_partial_dense_quant(const void* q, const void* k, long long kb,
                             int ldk, const void* v, long long vb, int ldv,
                             int S, const int* lengths, int kvh,
                             long long kh, long long vh, int dk, int dv,
                             const float* kz, long long zb, long long zh,
                             int ldz, const float* vz, long long vzb,
                             long long vzh, int ldvz, int code, int qf32,
                             float* m_out, float* l_out, float* acc_out,
                             int B, int H, int n_splits, int tps,
                             float scale, int amla, void* stream) {
  if (S <= 0 || n_splits <= 0 || tps <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = decode_params(nullptr, lengths, H, n_splits * tps, n_splits,
                           scale, amla);
  quant_params(p, code, kz, zb, zh, ldz, vz, vzb, vzh, ldvz);
  p.kvh = kvh;
  p.S = S;
  p.m_out = m_out;
  p.l_out = l_out;
  p.acc_out = acc_out;
  return launch_q<true, true>(
      dense_operands(q, k, kb, ldk, v, vb, ldv, S, kvh, kh, vh), p, dk, dv,
      qf32, B, stream);
}

}  // extern "C"
