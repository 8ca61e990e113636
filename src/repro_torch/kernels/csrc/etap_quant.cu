// ETAP attention over int8 / e4m3 codes for Hopper (sm_90a): the quantized
// instantiations of etap_body.cuh's body, which says what they compute and
// how (see its "Numerics of the quantized bodies").
//
//   K3q, K1q  K3 and K1 (etap_decode.cu) over an int8 or e4m3 latent
//       code pool with one fp32 (scale, zp) pair per row: they replace the
//       reference's quantized MLA-fused bodies _paged_body_quant_fused :116
//       (under repro/kernels/etap/etap.py:237) and
//       _paged_partial_body_quant_fused :639 (under :713), both built on
//       _dequant :31.  K4q, the chunked prefill and verify over the same
//       pools, is etap_prefill.cu's.
//   K5q, K6q  K5 and K6 (etap.cu) over dense code rows, K and V each with
//       its own (scale, zp) rows: the GQA decode over a quantized paged
//       pool, which gathers the codes and pairs (the reference gathers and
//       dequantizes them to fp32, repro/models/attention.py:249-260, and
//       feeds K5 / K6 the fp32 rows: repro/kernels/etap/etap.py:154, :603).
//       Built at mma_tile.cuh's EtapQuantDenseWidths, the 128- and
//       64-wide heads.
//
// What bounds them on the H100: the code bytes (1 per element, plus 8 per
// row and granule for the pair) over 3.35 TB/s, half of the bf16 rows'.
#include "etap_body.cuh"

namespace {

template <bool STATS, bool DENSE, int CODE, int DK = LATENT_DK,
          int DV = LATENT_DV>
int launch_q(const Params& p, int B, int n_splits, void* stream) {
  return p.qf32
             ? launch_mode<STATS, DENSE, CODE, true, DK, DV>(p, B, n_splits,
                                                            stream)
             : launch_mode<STATS, DENSE, CODE, false, DK, DV>(p, B, n_splits,
                                                             stream);
}

template <bool STATS>
int launch(const Params& p, int code, int B, int n_splits, void* stream) {
  return code ? launch_q<STATS, false, kE4m3>(p, B, n_splits, stream)
              : launch_q<STATS, false, kInt8>(p, B, n_splits, stream);
}

template <bool STATS>
int launch_dense(const Params& p, int code, int dk, int dv, int B,
                 int n_splits, void* stream) {
  return with_widths<EtapQuantDenseWidths>(dk, dv, [&](auto DK, auto DV) {
    constexpr int K = decltype(DK)::value, V = decltype(DV)::value;
    return code ? launch_q<STATS, true, kE4m3, K, V>(p, B, n_splits, stream)
                : launch_q<STATS, true, kInt8, K, V>(p, B, n_splits, stream);
  });
}

// The paged quantized bodies' parameters: the (scale, zp) pool and whether
// q is fp32.
Params quant_params(const void* q, const void* pool, const float* sz,
                    const int* table, int C, int nbt, float scale, int amla,
                    int qf32) {
  Params p = make_params(q, pool, table, C, nbt, scale, amla);
  p.sz = sz;
  p.qf32 = qf32;
  return p;
}

// The dense quantized kernels' parameters: dense_params over the code rows,
// plus K's pairs kz (strides zb, zh, ldz in floats, as K's in elements) and
// a separate V's pairs vz (null with v: V and its pairs are K's).
Params dense_quant_params(const void* q, const void* k, long long kb,
                          int ldk, const void* v, long long vb, int ldv,
                          int S, const int* lengths, int kvh, long long kh,
                          long long vh, const float* kz, long long zb,
                          long long zh, int ldz, const float* vz,
                          long long vzb, long long vzh, int ldvz, int qf32,
                          int H, int nbt, float scale, int amla) {
  Params p = dense_params(q, k, kb, ldk, v, vb, ldv, S, lengths, kvh, kh, vh,
                          H, nbt, scale, amla);
  p.sz = kz;
  p.zb = zb;
  p.zh = zh;
  p.ldz = ldz;
  p.vsz = vz;
  p.vzb = vzb;
  p.vzh = vzh;
  p.ldvz = ldvz;
  p.qf32 = qf32;
  return p;
}

}  // namespace

extern "C" {

// The (Dk, Dv) pairs K5q / K6q take (written to out as dk, dv, ...;
// returns their number).
int etap_dense_quant_widths(int* out, int cap) {
  return write_widths<EtapQuantDenseWidths>(out, cap);
}

// The registers, dynamic shared memory and local memory of K5q (stats 0)
// or K6q (stats 1) at (dk, dv) over int8 (code 0) or e4m3 (code 1) rows,
// with fp32 q when qf32 is set, into out[0..2].
int etap_dense_quant_attrs(int dk, int dv, int stats, int code, int qf32,
                           int* out) {
  return with_widths<EtapQuantDenseWidths>(dk, dv, [&](auto DK, auto DV) {
    constexpr int K = decltype(DK)::value, V = decltype(DV)::value;
    auto pick = [&](auto S, auto C) {
      constexpr bool ST = decltype(S)::value;
      constexpr int CD = decltype(C)::value;
      return qf32 ? attrs_of<ST, true, CD, true, K, V>(out)
                  : attrs_of<ST, true, CD, false, K, V>(out);
    };
    using T = std::true_type;
    using F = std::false_type;
    using I8 = std::integral_constant<int, kInt8>;
    using E4 = std::integral_constant<int, kE4m3>;
    return stats ? (code ? pick(T{}, E4{}) : pick(T{}, I8{}))
                 : (code ? pick(F{}, E4{}) : pick(F{}, I8{}));
  });
}

// K3q / K1q: as K3 / K1 over an int8 (code 0) or e4m3 (code 1)
// pool [N,PAGE,DK] with its (scale, zp) pool sz [N,PAGE,2] fp32; q bf16,
// or fp32 with qf32 set, and out in q's type.
int etap_decode_mla_paged_quant(const void* q, const void* pool,
                                const float* sz, const int* table,
                                const int* lengths, void* out, int B, int H,
                                int nbt, float scale, int amla, int code,
                                int qf32, void* stream) {
  Params p = quant_params(q, pool, sz, table, H, nbt, scale, amla, qf32);
  p.base = lengths;
  p.out = out;
  return launch<false>(p, code, B, 1, stream);
}

int etap_paged_partial_quant(const void* q, const void* pool, const float* sz,
                             const int* table, const int* lengths,
                             float* m_out, float* l_out, float* acc_out,
                             int B, int H, int nbt, int n_splits, float scale,
                             int amla, int code, int qf32, void* stream) {
  Params p = quant_params(q, pool, sz, table, H, nbt, scale, amla, qf32);
  p.npb = nbt / n_splits;
  p.base = lengths;
  p.m_out = m_out;
  p.l_out = l_out;
  p.acc_out = acc_out;
  return launch<true>(p, code, B, n_splits, stream);
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
  const int nbt = (S + PAGE - 1) / PAGE;
  Params p = dense_quant_params(q, k, kb, ldk, v, vb, ldv, S, lengths, kvh,
                                kh, vh, kz, zb, zh, ldz, vz, vzb, vzh, ldvz,
                                qf32, H, nbt, scale, amla);
  p.out = out;
  return launch_dense<false>(p, code, dk, dv, B, 1, stream);
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
  Params p = dense_quant_params(q, k, kb, ldk, v, vb, ldv, S, lengths, kvh,
                                kh, vh, kz, zb, zh, ldz, vz, vzb, vzh, ldvz,
                                qf32, H, n_splits * tps, scale, amla);
  p.npb = tps;
  p.m_out = m_out;
  p.l_out = l_out;
  p.acc_out = acc_out;
  return launch_dense<true>(p, code, dk, dv, B, n_splits, stream);
}

}  // extern "C"
