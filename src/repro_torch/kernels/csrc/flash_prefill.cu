// K9, the causal prefill kernel for Hopper (sm_90a): blockwise causal GQA
// attention, replacing repro/kernels/flash_prefill/flash_prefill.py:78
// (flash_prefill_pallas :62).
//
// What it computes.  q [B, S, H, D], k [B, S, K, D], v [B, S, K, Dv] (read
// in place through their strides), H = K G; query head h attends to kv
// head h / G under the causal mask; out [B, S, H, Dv] bf16.  A CTA owns one
// (b, h, 64-row query tile) and walks the 64-row KV tiles from the first
// up to the one holding the query tile's last row (the diagonal tile):
// the tiles past it are never read, the reference's causal block skip.
// Per tile, each of the 4 warps owns 16 query rows:
//     S = Q K^T * scale       [16, 64]   mma.sync m16n8k16, fp32
//     mask kpos > qpos to -1e30          (the diagonal tile only)
//     online-softmax update of each row's (m, l), in registers
//     O = O * corr + P V      [16, Dv]   P as bf16 hi + lo, fp32 O
// and the epilogue writes O / l for the rows below S.  The recurrence is
// softmax_state.update in both rescale modes (softmax_state.cuh): amla
// keeps m an integer log2 bias and rescales by an exact 2^d.  The
// reference's P.V is fp32 P times bf16 V with fp32 accumulation; P enters
// the tensor cores as two bf16 terms (hi = bf16(p), lo = bf16(p - hi)),
// about 16 significant bits, as in the decode kernels.  (D, Dv) is a
// template parameter, one instantiation per pair of mma_tile.cuh's
// PrefillWidths: (192, 128) DeepSeek's decompressed MLA heads, whose
// Q K^T runs 12 k16 steps and P V 16 n8 tiles; (128, 128) and (64, 64) the
// GQA heads.  S need not be a multiple of 64: the last tiles' rows past S
// are zero-filled in shared memory and never written out.
//
// Data flow.  S and P never leave registers: the accumulator fragment of
// Q K^T (rows g, g + 8, columns 2t, 2t + 1 of each n8 tile) is the A
// fragment of P V, as in FlashAttention-2.  Q, K and V tiles come into
// shared memory with cp.async (16 bytes a thread), the next K / V tile
// while the current one is in use (two buffers), and the mma operands
// come out with ldmatrix (.trans for V).  Rows are padded by 16 bytes, so
// ldmatrix's 8 rows fall in distinct banks.  Shared memory: 64 (D + 8) +
// 2 * 64 (D + 8) + 2 * 64 (Dv + 8) bf16, 111,616 B at (192, 128).
//
// What bounds it on the H100: the operations.  The causal half of the
// two products is 2 B H S (S + 1) / 2 (D + Dv) multiply-adds' worth of
// FLOPs (2.75e12 for a DeepSeek dense-long layer, B 4 x S 4096, H 128:
// 2.8 ms at 989 TFLOP/s), against bytes of q, k, v and out read or
// written once (0.8 ms at 3.35 TB/s).  mma.sync reaches a fraction of the
// wgmma rate, the diagonal tile computes its masked half, and a GQA
// group's G heads read the same K / V tiles (from L2 after the first).
// First version: one CTA per query tile (the longest tiles launched
// first), no persistent schedule, no warp specialisation.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_tile.cuh"

namespace {

using namespace etap;

constexpr int BQ = 64;         // query rows per CTA, 16 per warp
constexpr int BKV = PAGE;      // KV rows per tile
constexpr int NWARP = BQ / 16;
constexpr int NTHREAD = NWARP * 32;

template <int D, int DV>
struct Smem {
  static constexpr int QSTR = D + 8;   // padded row (bf16): Q and K
  static constexpr int VSTR = DV + 8;  // padded row: V
  alignas(16) bf16 q[BQ * QSTR];
  alignas(16) bf16 k[2][BKV * QSTR];
  alignas(16) bf16 v[2][BKV * VSTR];
};

struct Params {
  const bf16* q;       // row (b, s, h) at b*qb + s*qs + h*qh (elements)
  long long qb, qs, qh;
  const bf16* k;       // row (b, s, kvh) at b*kb + s*ks + kvh*kh
  long long kb, ks, kh;
  const bf16* v;       // as k
  long long vb, vs, vh;
  bf16* out;           // [B, S, H, DV], contiguous
  int S;
  int H;
  int G;               // query heads per kv head
  float scale;
  int amla;
};

template <int D, int DV>
__global__ void __launch_bounds__(NTHREAD) flash_prefill_kernel(Params P) {
  static_assert(D % 16 == 0 && DV % 16 == 0, "widths of 16");
  using SM = Smem<D, DV>;
  constexpr int QSTR = SM::QSTR, VSTR = SM::VSTR;
  constexpr int NT = BKV / 8;      // n8 tiles of S
  constexpr int ND = DV / 8;       // n8 tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SM& sm = *reinterpret_cast<SM*>(smem_raw);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;         // mma fragment coordinates
  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;     // the longest tiles first
  const int q0 = qt * BQ;
  const bool amla = P.amla != 0;

  const bf16* kg = P.k + (size_t)b * P.kb + (size_t)(h / P.G) * P.kh;
  const bf16* vg = P.v + (size_t)b * P.vb + (size_t)(h / P.G) * P.vh;
  load_tile<NTHREAD>(sm.q, QSTR,
                     P.q + (size_t)b * P.qb + (size_t)q0 * P.qs +
                         (size_t)h * P.qh,
                     P.qs, min(BQ, P.S - q0), D, true);
  load_tile<NTHREAD>(sm.k[0], QSTR, kg, P.ks, min(BKV, P.S), D, true);
  load_tile<NTHREAD>(sm.v[0], VSTR, vg, P.vs, min(BKV, P.S), DV, true);
  cp_async_commit();

  float o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};               // rows g and g + 8
  float l[2] = {0.f, 0.f};
  const int row0 = 16 * warp;                    // the warp's first row
  // ldmatrix row addresses: A (Q) rows row0 + lane % 16, columns + 8 for
  // the upper lanes; B (K) rows 8 (lane / 16) + lane % 8 of an n8 pair,
  // columns + 8 for odd matrices; V^T rows 8 (matrix % 2) + lane % 8.
  const int mat = lane >> 3, r8 = lane & 7;
  const bf16* qa = &sm.q[(row0 + (lane & 15)) * QSTR + (lane >> 4) * 8];

  for (int j = 0; j <= qt; ++j) {
    if (j < qt) {                                // prefetch tile j + 1
      const int r0 = (j + 1) * BKV;
      const int rows = min(BKV, P.S - r0);
      load_tile<NTHREAD>(sm.k[(j + 1) & 1], QSTR, kg + (size_t)r0 * P.ks,
                         P.ks, rows, D, true);
      load_tile<NTHREAD>(sm.v[(j + 1) & 1], VSTR, vg + (size_t)r0 * P.vs,
                         P.vs, rows, DV, true);
      cp_async_commit();
      cp_async_wait_group<1>();
    } else {
      cp_async_wait_group<0>();
    }
    __syncthreads();
    const bf16* kt = sm.k[j & 1];
    const bf16* vt = sm.v[j & 1];

    // ---- S = Q K^T: 16 rows x 64 KV rows a warp
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < D; k0 += 16) {
      uint32_t a[4];
      ldsm_x4(a, qa + k0);
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t bb[4];
        ldsm_x4(bb, &kt[(8 * (nt + (mat >> 1)) + r8) * QSTR + k0 +
                        (mat & 1) * 8]);
        mma16816(s[nt], a[0], a[1], a[2], a[3], bb[0], bb[1]);
        mma16816(s[nt + 1], a[0], a[1], a[2], a[3], bb[2], bb[3]);
      }
    }

    // ---- scale, causal mask on the diagonal tile, online softmax
    const bool diag = j == qt;
    const int qpos0 = q0 + row0 + g;             // rows of s[.][0..1], +8
    float mx[2] = {NEG_INF * LOG2E, NEG_INF * LOG2E};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = j * BKV + 8 * nt + 2 * t + (e & 1);
        float x = s[nt][e] * P.scale;
        if (diag && kpos > qpos0 + 8 * (e >> 1)) x = NEG_INF;
        if (amla) x *= LOG2E;                    // log2 domain
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1)
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], off));
      const float m_new = fmaxf(m[r], amla ? ceilf(mx[r]) : mx[r]);
      corr[r] = stat_weight(m[r] - m_new, amla);
      m[r] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = prob_exp(s[nt][e] - m[e >> 1], amla);
        s[nt][e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1)
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], off);
      l[r] = l[r] * corr[r] + sum[r];
    }
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      o[nd][0] *= corr[0];
      o[nd][1] *= corr[0];
      o[nd][2] *= corr[1];
      o[nd][3] *= corr[1];
    }

    // ---- O += P V: the S fragments of n8 tiles 2kk, 2kk + 1 are the A
    //      fragment of k16 step kk, split into bf16 hi + lo
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* f = &s[2 * kk + (i >> 1)][2 * (i & 1)];
        const bf16 h0 = __float2bfloat16_rn(f[0]);
        const bf16 h1 = __float2bfloat16_rn(f[1]);
        hi[i] = pack(h0, h1);
        lo[i] = pack(__float2bfloat16_rn(f[0] - __bfloat162float(h0)),
                     __float2bfloat16_rn(f[1] - __bfloat162float(h1)));
      }
#pragma unroll
      for (int nd = 0; nd < ND; nd += 2) {
        uint32_t bb[4];
        ldsm_x4<true>(bb, &vt[(16 * kk + 8 * (mat & 1) + r8) * VSTR +
                              8 * (nd + (mat >> 1))]);
        mma16816(o[nd], hi[0], hi[1], hi[2], hi[3], bb[0], bb[1]);
        mma16816(o[nd], lo[0], lo[1], lo[2], lo[3], bb[0], bb[1]);
        mma16816(o[nd + 1], hi[0], hi[1], hi[2], hi[3], bb[2], bb[3]);
        mma16816(o[nd + 1], lo[0], lo[1], lo[2], lo[3], bb[2], bb[3]);
      }
    }
    __syncthreads();                   // the buffers are refilled next
  }

  // ---- epilogue: O / l for rows g and g + 8 below S
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int sp = q0 + row0 + g + 8 * r;
    if (sp >= P.S) continue;
    bf16* op = P.out + (((size_t)b * P.S + sp) * P.H + h) * DV;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      *reinterpret_cast<__nv_bfloat162*>(&op[8 * nd + 2 * t]) =
          __halves2bfloat162(__float2bfloat16_rn(o[nd][2 * r] / l[r]),
                             __float2bfloat16_rn(o[nd][2 * r + 1] / l[r]));
  }
}

template <int D, int DV>
int launch_widths(const Params& p, int B, void* stream) {
  const int smem = static_cast<int>(sizeof(Smem<D, DV>));
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_kernel<D, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.H, B, (p.S + BQ - 1) / BQ);
  flash_prefill_kernel<D, DV><<<grid, NTHREAD, smem,
                                static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The (D, Dv) pairs K9 takes (written to out as d, dv, ...; returns their
// number).
int flash_prefill_widths(int* out, int cap) {
  return write_widths<PrefillWidths>(out, cap);
}

// The registers, dynamic shared memory and local memory (spills) of K9 at
// (d, dv), into out[0..2].
int flash_prefill_attrs(int d, int dv, int* out) {
  return with_widths<PrefillWidths>(d, dv, [&](auto D, auto DV) {
    constexpr int KD = decltype(D)::value, VD = decltype(DV)::value;
    cudaFuncAttributes a;
    const cudaError_t err =
        cudaFuncGetAttributes(&a, flash_prefill_kernel<KD, VD>);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = a.numRegs;
    out[1] = static_cast<int>(sizeof(Smem<KD, VD>));
    out[2] = static_cast<int>(a.localSizeBytes);
    return 0;
  });
}

// K9: q [B,S,H,d] at q + b*qb + s*qs + h*qh, k [B,S,K,d] and v [B,S,K,dv]
// likewise (strides in elements; unit column stride; 16-byte aligned
// rows), H a multiple of K; out [B,S,H,dv] bf16, contiguous.  (d, dv) one
// of flash_prefill_widths.
int flash_prefill(const void* q, long long qb, long long qs, long long qh,
                  const void* k, long long kb, long long ks, long long kh,
                  const void* v, long long vb, long long vs, long long vh,
                  void* out, int B, int S, int H, int K, int d, int dv,
                  float scale, int amla, void* stream) {
  if (K <= 0 || H % K || S <= 0 || B <= 0 || S > 65535 * BQ)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.q = static_cast<const bf16*>(q);
  p.qb = qb;
  p.qs = qs;
  p.qh = qh;
  p.k = static_cast<const bf16*>(k);
  p.kb = kb;
  p.ks = ks;
  p.kh = kh;
  p.v = static_cast<const bf16*>(v);
  p.vb = vb;
  p.vs = vs;
  p.vh = vh;
  p.out = static_cast<bf16*>(out);
  p.S = S;
  p.H = H;
  p.G = H / K;
  p.scale = scale;
  p.amla = amla;
  return with_widths<PrefillWidths>(d, dv, [&](auto D, auto DV) {
    return launch_widths<decltype(D)::value, decltype(DV)::value>(p, B,
                                                                  stream);
  });
}

}  // extern "C"
