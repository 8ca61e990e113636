// MLA ETAP attention over quantized latent pools for Hopper (sm_90a): the
// int8 and e4m3 instantiations of etap_body.cuh's body, which says what they
// compute and how (see its "Numerics of the quantized bodies").
//
//   K3q, K1q, K4q  K3, K1 and K4 (etap.cu) over an int8 or e4m3 code pool
//       with one fp32 (scale, zp) pair per row: they replace the reference's
//       quantized MLA-fused bodies _paged_body_quant_fused :116 (under
//       repro/kernels/etap/etap.py:237), _paged_partial_body_quant_fused
//       :639 (under :713), _prefill_body_quant_fused :340 and
//       _verify_body_quant_fused :367 (under :430), all built on _dequant :31.
#include "etap_body.cuh"

namespace {

template <bool STATS, int MODE>
int launch_code(const Params& p, int B, int n_splits, void* stream) {
  return p.qf32 ? launch_mode<STATS, MODE, true>(p, B, n_splits, stream)
                : launch_mode<STATS, MODE, false>(p, B, n_splits, stream);
}

template <bool STATS>
int launch(const Params& p, int B, int n_splits, void* stream) {
  return p.code ? launch_code<STATS, kE4m3>(p, B, n_splits, stream)
                : launch_code<STATS, kInt8>(p, B, n_splits, stream);
}

// The quantized bodies' parameters: the (scale, zp) pool, the code type and
// whether q is fp32.
Params quant_params(const void* q, const void* pool, const float* sz,
                    const int* table, int C, int nbt, float scale, int amla,
                    int code, int qf32) {
  Params p = make_params(q, pool, table, C, nbt, scale, amla);
  p.sz = sz;
  p.code = code;
  p.qf32 = qf32;
  return p;
}

}  // namespace

extern "C" {

// K3q / K1q / K4q: as K3 / K1 / K4 over an int8 (code 0) or e4m3 (code 1)
// pool [N,PAGE,DK] with its (scale, zp) pool sz [N,PAGE,2] fp32; q bf16,
// or fp32 with qf32 set, and out in q's type.
int etap_decode_mla_paged_quant(const void* q, const void* pool,
                                const float* sz, const int* table,
                                const int* lengths, void* out, int B, int H,
                                int nbt, float scale, int amla, int code,
                                int qf32, void* stream) {
  Params p = quant_params(q, pool, sz, table, H, nbt, scale, amla, code,
                          qf32);
  p.base = lengths;
  p.hz_off = -1;
  p.heads = H;
  p.out = out;
  return launch<false>(p, B, 1, stream);
}

int etap_paged_partial_quant(const void* q, const void* pool, const float* sz,
                             const int* table, const int* lengths,
                             float* m_out, float* l_out, float* acc_out,
                             int B, int H, int nbt, int n_splits, float scale,
                             int amla, int code, int qf32, void* stream) {
  Params p = quant_params(q, pool, sz, table, H, nbt, scale, amla, code,
                          qf32);
  p.npb = nbt / n_splits;
  p.base = lengths;
  p.hz_off = -1;
  p.heads = H;
  p.m_out = m_out;
  p.l_out = l_out;
  p.acc_out = acc_out;
  return launch<true>(p, B, n_splits, stream);
}

int etap_prefill_mla_paged_quant(const void* q, const void* pool,
                                 const float* sz, const int* table,
                                 const int* start, const int* qpos, void* out,
                                 int B, int C, int H, int nbt, float scale,
                                 int amla, int code, int qf32, void* stream) {
  Params p = quant_params(q, pool, sz, table, C, nbt, scale, amla, code,
                          qf32);
  p.base = start;
  p.qpos = qpos;
  p.hz_off = 0;
  p.heads = H;
  p.out = out;
  return launch<false>(p, B, 1, stream);
}

}  // extern "C"
