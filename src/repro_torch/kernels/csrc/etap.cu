// The dense bf16 ETAP decode kernels for Hopper (sm_90a): etap_decode.cuh's
// kernel (wgmma on the page's 64 rows, a TMA ring, warp-specialised),
// which says what they compute and how, over dense rows read in place.
//
//   K5  single-pass dense decode   replaces repro/kernels/etap/etap.py:154
//       (_call :122, reached from etap_decode_pallas :164 and
//        etap_decode_mla_pallas :171)
//   K6  dense split-KV phase 1     replaces repro/kernels/etap/etap.py:603
//       (etap_partial_pallas :557)
//
// Built at each (Dk, Dv) of mma_tile.cuh's DenseWidths: the MLA latent
// (576, 512), fused (V = the K rows' first 512 columns, read once) or with
// V rows of its own, and the GQA heads (128, 128), (64, 64) and (256, 256)
// with V rows of their own (a V that is K itself is read through a second
// map over K's rows).  The paged K1 / K3 are etap_decode.cu's instances
// (a separate source, so the two compile in parallel), the instances over
// code rows, K5q / K6q, etap_quant.cu's.
#include "etap_decode.cuh"

namespace {

// The dense instance at (dk, dv): fused at the latent when V is null.
template <bool STATS>
int launch_dense(const Operands& a, const Params& p, int dk, int dv, int B,
                 void* stream) {
  return with_widths<DenseWidths>(dk, dv, [&](auto DK, auto DV) {
    constexpr int K = decltype(DK)::value, V = decltype(DV)::value;
    if constexpr (K == LATENT_DK) {
      if (a.v == nullptr)
        return launch_decode<STATS, true, K, V, false>(a, p, B, stream);
    }
    return launch_decode<STATS, true, K, V, true>(a, p, B, stream);
  });
}

// The dense operands: row b of q's B reads K at k + (b / kvh) kb + (b %
// kvh) kh + s ldk for s < S (V alike, or null: K's first dv columns).
int dense_operands(Operands& a, const void* q, const void* k, long long kb,
                   int ldk, const void* v, long long vb, int ldv, int S,
                   int kvh, long long kh, long long vh) {
  if (S <= 0 || kvh <= 0) return static_cast<int>(cudaErrorInvalidValue);
  a = Operands{};
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
  return 0;
}

template <bool STATS>
int attrs_dense(int dk, int dv, int sepv, int cols, int* out) {
  return with_widths<DenseWidths>(dk, dv, [&](auto DK, auto DV) {
    constexpr int K = decltype(DK)::value, V = decltype(DV)::value;
    if constexpr (K == LATENT_DK) {
      if (!sepv) return attrs_decode<STATS, true, K, V, false>(cols, out);
    }
    if (!sepv) return static_cast<int>(cudaErrorInvalidValue);
    return attrs_decode<STATS, true, K, V, true>(cols, out);
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

// The attributes of the dense instance at (dk, dv) (fused at the latent
// with sepv 0, V of its own with sepv 1) at units of `cols` columns, into
// out[0..2]; etap_decode_attrs (etap_decode.cu) forwards here.
int etap_dense_cols_attrs(int dk, int dv, int sepv, int stats, int cols,
                          int* out) {
  return stats ? attrs_dense<true>(dk, dv, sepv, cols, out)
               : attrs_dense<false>(dk, dv, sepv, cols, out);
}

// The registers, dynamic shared memory and local memory of the dense
// instance K5 (stats 0) or K6 (stats 1) at (dk, dv) as the serve paths
// launch it (fused at the latent, V of its own elsewhere), at its widest
// units, into out[0..2].
int etap_dense_attrs(int dk, int dv, int stats, int* out) {
  return etap_dense_cols_attrs(dk, dv, dk == LATENT_DK ? 0 : 1, stats,
                               dk >= 256 ? 32 : 64, out);
}

// K5: q [B,H,dk]; K rows k + (b / kvh)*kb + (b % kvh)*kh + s*ldk for
// s < S (dk wide); V null (the first dv columns of K) or rows at v with
// strides vb, vh, ldv (dv wide); lengths [B]; out [B,H,dv].  Strides in
// elements, multiples of 8 (16 bytes); (dk, dv) one of etap_dense_widths.
// kvh = K reads a GQA cache [B/K, S, K, hd] in place as its grouped
// [B, S, hd] form.
int etap_decode_dense(const void* q, const void* k, long long kb, int ldk,
                      const void* v, long long vb, int ldv, int S,
                      const int* lengths, int kvh, long long kh,
                      long long vh, int dk, int dv, void* out, int B, int H,
                      float scale, int amla, void* stream) {
  Operands a;
  const int err = dense_operands(a, q, k, kb, ldk, v, vb, ldv, S, kvh, kh,
                                 vh);
  if (err != 0) return err;
  Params p = decode_params(nullptr, lengths, H, (S + PAGE - 1) / PAGE, 1,
                           scale, amla);
  p.kvh = kvh;
  p.out = out;
  return launch_dense<false>(a, p, dk, dv, B, stream);
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
  Operands a;
  const int err = dense_operands(a, q, k, kb, ldk, v, vb, ldv, S, kvh, kh,
                                 vh);
  if (err != 0) return err;
  if (n_splits <= 0 || tps <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = decode_params(nullptr, lengths, H, n_splits * tps, n_splits,
                           scale, amla);
  p.kvh = kvh;
  p.m_out = m_out;
  p.l_out = l_out;
  p.acc_out = acc_out;
  return launch_dense<true>(a, p, dk, dv, B, stream);
}

}  // extern "C"
