// The paged bf16 ETAP decode kernels for Hopper (sm_90a): etap_decode.cuh's
// kernel (wgmma on the page's 64 rows, a TMA ring, warp-specialised),
// which says what they compute and how, over the paged MLA latent pool
// (fused: V is the page's first 512 columns) and over separate K and V
// pools at mma_tile.cuh's PagedSepWidths (the latent with V in a pool of
// its own, Granite-20B's MQA head (128, 128)).
//
//   K3  single-pass paged decode   replaces repro/kernels/etap/etap.py:237
//       (_paged_call :185, bodies _paged_body_fused and _paged_body :98,
//        reached from etap_decode_mla_paged_pallas :259 and
//        etap_decode_paged_pallas :247)
//   K1  split-KV phase 1           replaces repro/kernels/etap/etap.py:713
//       (etap_paged_partial_pallas :646, bodies _etap_partial_body :506
//        and _paged_partial_body :619)
//
// The dense K5 / K6 are etap.cu's instances of the same kernel; its
// instances over code pools, K3q and K1q, etap_quant.cu's (fused) and
// etap_sepv.cu's (separate V).
#include "etap_decode.cuh"

namespace {

// The paged instance at (dk, dv) of PagedSepWidths with a separate V.
template <bool STATS>
int launch_sepv(const Operands& a, const Params& p, int dk, int dv, int B,
                void* stream) {
  return with_widths<PagedSepWidths>(dk, dv, [&](auto DK, auto DV) {
    return launch_decode<STATS, false, decltype(DK)::value,
                         decltype(DV)::value, true>(a, p, B, stream);
  });
}

Operands paged_operands(const void* q, const void* k_pool,
                        const void* v_pool) {
  Operands a{};
  a.q = q;
  a.k = k_pool;
  a.v = v_pool;
  a.kvh = 1;
  return a;
}

// The split parameters: a table of n_splits * npb columns.
int split_params(Params& p, float* m_out, float* l_out, float* acc_out,
                 int nbt, int n_splits) {
  if (n_splits <= 0 || nbt % n_splits != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  p.m_out = m_out;
  p.l_out = l_out;
  p.acc_out = acc_out;
  return 0;
}

template <bool STATS>
int attrs_paged(int dk, int dv, int sepv, int cols, int* out) {
  if (!sepv) {
    if (dk != LATENT_DK || dv != LATENT_DV)
      return static_cast<int>(cudaErrorInvalidValue);
    return attrs_decode<STATS, false, LATENT_DK, LATENT_DV, false>(cols, out);
  }
  return with_widths<PagedSepWidths>(dk, dv, [&](auto DK, auto DV) {
    return attrs_decode<STATS, false, decltype(DK)::value,
                        decltype(DV)::value, true>(cols, out);
  });
}

}  // namespace

extern "C" {

// The dense instances' attributes (etap.cu), and the instances' over
// codes (etap_quant.cu: the fused paged and the dense ones; etap_sepv.cu:
// the paged ones over separate pools).
int etap_dense_cols_attrs(int dk, int dv, int sepv, int stats, int cols,
                          int* out);
int etap_quant_cols_attrs(int dense, int dk, int dv, int stats, int qf32,
                          int cols, int* out);
int etap_sepv_cols_attrs(int dk, int dv, int stats, int qf32, int cols,
                         int* out);

// K3: q [B,H,DK]; pool [N,PAGE,DK]; table [B,nbt]; lengths [B];
// out [B,H,DV] — all bf16 / int32, contiguous, 16-byte aligned.
int etap_decode_mla_paged(const void* q, const void* pool, const int* table,
                          const int* lengths, void* out, int B, int H,
                          int nbt, float scale, int amla, void* stream) {
  Params p = decode_params(table, lengths, H, nbt, 1, scale, amla);
  p.out = out;
  return launch_decode<false, false, LATENT_DK, LATENT_DV, false>(
      paged_operands(q, pool, nullptr), p, B, stream);
}

// K1: as K3, with the table padded to n_splits * npb columns; writes fp32
// m, l [B,n,H] and acc [B,n,DV,H].
int etap_paged_partial(const void* q, const void* pool, const int* table,
                       const int* lengths, float* m_out, float* l_out,
                       float* acc_out, int B, int H, int nbt, int n_splits,
                       float scale, int amla, void* stream) {
  Params p = decode_params(table, lengths, H, nbt, n_splits, scale, amla);
  const int err = split_params(p, m_out, l_out, acc_out, nbt, n_splits);
  if (err != 0) return err;
  return launch_decode<true, false, LATENT_DK, LATENT_DV, false>(
      paged_operands(q, pool, nullptr), p, B, stream);
}

// K3, separate V: q [B,H,dk] bf16; k_pool [N,PAGE,dk], v_pool [N,PAGE,dv]
// bf16; table [B,nbt]; lengths [B]; out [B,H,dv] bf16; (dk, dv) one of
// PagedSepWidths.
int etap_decode_paged(const void* q, const void* k_pool, const void* v_pool,
                      const int* table, const int* lengths, void* out, int B,
                      int H, int nbt, int dk, int dv, float scale, int amla,
                      void* stream) {
  Params p = decode_params(table, lengths, H, nbt, 1, scale, amla);
  p.out = out;
  return launch_sepv<false>(paged_operands(q, k_pool, v_pool), p, dk, dv, B,
                            stream);
}

// K1, separate V: as K3 with the table padded to n_splits * npb columns;
// writes fp32 m, l [B,n,H] and acc [B,n,dv,H].
int etap_paged_partial_sepv(const void* q, const void* k_pool,
                            const void* v_pool, const int* table,
                            const int* lengths, float* m_out, float* l_out,
                            float* acc_out, int B, int H, int nbt,
                            int n_splits, int dk, int dv, float scale,
                            int amla, void* stream) {
  Params p = decode_params(table, lengths, H, nbt, n_splits, scale, amla);
  const int err = split_params(p, m_out, l_out, acc_out, nbt, n_splits);
  if (err != 0) return err;
  return launch_sepv<true>(paged_operands(q, k_pool, v_pool), p, dk, dv, B,
                           stream);
}

// The unit width (16, 32 or 64 columns) the bf16 decode kernels take on
// this device for `rows` = B n_splits row splits of C columns at Dk = dk
// (over codes: the smaller of it and the instance's unit_cap), or a
// negative cudaError_t.
int etap_decode_unit_cols(int dk, long long rows, int C) {
  const int dev = current_device();
  const int sms = dev < 0 ? 0 : sm_count(dev);
  if (sms <= 0) return -static_cast<int>(cudaErrorInvalidDevice);
  return decode_unit_cols(dk, rows, C, sms);
}

// The registers, dynamic shared memory and local memory (spills) of a
// decode instance into out[0..2]: over bf16 rows (q -1) paged (dense 0:
// the fused latent with sepv 0, PagedSepWidths with sepv 1) or dense
// (dense 1: the latent fused with sepv 0, every DenseWidths pair with V
// of its own with sepv 1); over int8 / e4m3 codes (q 0 with bf16 q, 1
// with fp32 q; one instance for both code types) paged (the fused latent
// with sepv 0, PagedSepWidths with sepv 1) or dense (EtapQuantDenseWidths,
// sepv 1); the single pass (stats 0) or the split partial (stats 1), at
// units of `cols` columns (16 up to the instance's unit_cap: 16, 32 or
// 64).  The
// registers are the launch's (168 a thread for 384 threads); setmaxnreg
// moves them to 40 in the producer and 232 in the consumers.
int etap_decode_attrs(int dense, int dk, int dv, int sepv, int stats,
                      int cols, int q, int* out) {
  if (q >= 0) {
    if (q > 1 || (dense && !sepv))
      return static_cast<int>(cudaErrorInvalidValue);
    if (dense || !sepv)
      return etap_quant_cols_attrs(dense, dk, dv, stats, q, cols, out);
    return etap_sepv_cols_attrs(dk, dv, stats, q, cols, out);
  }
  if (dense) return etap_dense_cols_attrs(dk, dv, sepv, stats, cols, out);
  return stats ? attrs_paged<true>(dk, dv, sepv, cols, out)
               : attrs_paged<false>(dk, dv, sepv, cols, out);
}

}  // extern "C"
