// MLA ETAP attention for Hopper (sm_90a): the bf16 decode instantiations
// of etap_body.cuh's body, which says what they compute and how.
//
//   K3  single-pass paged decode   replaces repro/kernels/etap/etap.py:237
//       (_paged_call, reached from etap_decode_mla_paged_pallas :259)
//   K1  split-KV phase 1           replaces repro/kernels/etap/etap.py:713
//       (etap_paged_partial_pallas :646, body _etap_partial_body :506)
//   K5  single-pass dense decode   replaces repro/kernels/etap/etap.py:154
//       (_call :122, reached from etap_decode_pallas :164 and
//        etap_decode_mla_pallas :171)
//   K6  dense split-KV phase 1     replaces repro/kernels/etap/etap.py:603
//       (etap_partial_pallas :557)
//
// The paged kernels (K1, K3) are built at the MLA latent's widths; the
// dense ones (K5, K6) at each (Dk, Dv) of mma_tile.cuh's DenseWidths: the
// latent (576, 512) and the GQA heads (128, 128), (64, 64) and (256, 256).
// K4, the chunked paged prefill and verify over bf16 pools, and K4q over
// code pools are etap_prefill.cu's (wgmma and TMA).
#include "etap_body.cuh"

namespace {

template <bool STATS>
int launch(const Params& p, int B, int n_splits, void* stream) {
  return launch_mode<STATS, false, kBf16, false>(p, B, n_splits, stream);
}

template <bool STATS>
int launch_dense(const Params& p, int dk, int dv, int B, int n_splits,
                 void* stream) {
  return with_widths<DenseWidths>(dk, dv, [&](auto DK, auto DV) {
    return launch_mode<STATS, true, kBf16, false, decltype(DK)::value,
                       decltype(DV)::value>(p, B, n_splits, stream);
  });
}

}  // namespace

extern "C" {

// Shape constants the Python wrappers check their operands against: the
// paged kernels' widths and page, and the dense kernels' (Dk, Dv) pairs
// (written to out as dk, dv, dk, dv, ...; returns their number).
int etap_dk() { return LATENT_DK; }
int etap_dv() { return LATENT_DV; }
int etap_page() { return PAGE; }
int etap_dense_widths(int* out, int cap) {
  return write_widths<DenseWidths>(out, cap);
}

// The registers, dynamic shared memory and local memory of the dense
// instance K5 (stats 0) or K6 (stats 1) at (dk, dv), into out[0..2].
int etap_dense_attrs(int dk, int dv, int stats, int* out) {
  return with_widths<DenseWidths>(dk, dv, [&](auto DK, auto DV) {
    constexpr int K = decltype(DK)::value, V = decltype(DV)::value;
    return stats ? attrs_of<true, true, kBf16, false, K, V>(out)
                 : attrs_of<false, true, kBf16, false, K, V>(out);
  });
}

// K3: q [B,H,DK]; pool [N,PAGE,DK]; table [B,nbt]; lengths [B];
// out [B,H,DV] — all bf16 / int32, contiguous.
int etap_decode_mla_paged(const void* q, const void* pool, const int* table,
                          const int* lengths, void* out, int B, int H,
                          int nbt, float scale, int amla, void* stream) {
  Params p = make_params(q, pool, table, H, nbt, scale, amla);
  p.base = lengths;
  p.out = out;
  return launch<false>(p, B, 1, stream);
}

// K1: as K3, with the table padded to n_splits * npb columns; writes fp32
// m, l [B,n,H] and acc [B,n,DV,H].
int etap_paged_partial(const void* q, const void* pool, const int* table,
                       const int* lengths, float* m_out, float* l_out,
                       float* acc_out, int B, int H, int nbt, int n_splits,
                       float scale, int amla, void* stream) {
  Params p = make_params(q, pool, table, H, nbt, scale, amla);
  p.npb = nbt / n_splits;
  p.base = lengths;
  p.m_out = m_out;
  p.l_out = l_out;
  p.acc_out = acc_out;
  return launch<true>(p, B, n_splits, stream);
}

// K5: q [B,H,dk]; K rows k + (b / kvh)*kb + (b % kvh)*kh + s*ldk for
// s < S (dk wide); V null (the first dv columns of K) or rows at v with
// strides vb, vh, ldv (dv wide); lengths [B]; out [B,H,dv].  Strides in
// elements; (dk, dv) one of etap_dense_widths.  kvh = K reads a GQA cache
// [B/K, S, K, hd] in place as its grouped [B, S, hd] form.
int etap_decode_dense(const void* q, const void* k, long long kb, int ldk,
                      const void* v, long long vb, int ldv, int S,
                      const int* lengths, int kvh, long long kh,
                      long long vh, int dk, int dv, void* out, int B, int H,
                      float scale, int amla, void* stream) {
  const int nbt = (S + PAGE - 1) / PAGE;
  Params p = dense_params(q, k, kb, ldk, v, vb, ldv, S, lengths, kvh, kh, vh,
                          H, nbt, scale, amla);
  p.out = out;
  return launch_dense<false>(p, dk, dv, B, 1, stream);
}

// K6: as K5, cut into n_splits splits of tps 64-row tiles each (rows past S
// read as zero); writes fp32 m, l [B,n,H] and acc [B,n,dv,H].
int etap_partial_dense(const void* q, const void* k, long long kb, int ldk,
                       const void* v, long long vb, int ldv, int S,
                       const int* lengths, int kvh, long long kh,
                       long long vh, int dk, int dv, float* m_out,
                       float* l_out, float* acc_out, int B, int H,
                       int n_splits, int tps, float scale, int amla,
                       void* stream) {
  Params p = dense_params(q, k, kb, ldk, v, vb, ldv, S, lengths, kvh, kh, vh,
                          H, n_splits * tps, scale, amla);
  p.npb = tps;
  p.m_out = m_out;
  p.l_out = l_out;
  p.acc_out = acc_out;
  return launch_dense<true>(p, dk, dv, B, n_splits, stream);
}

}  // extern "C"
