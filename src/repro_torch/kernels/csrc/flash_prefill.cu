// K9, the causal prefill kernel for Hopper (sm_90a): blockwise causal GQA
// attention, replacing repro/kernels/flash_prefill/flash_prefill.py:78
// (flash_prefill_pallas :62).
//
// What it computes.  q [B, S, H, D], k [B, S, K, D], v [B, S, K, Dv] (read
// in place through their strides), H = K G; query head h attends to kv
// head h / G under the causal mask; out [B, S, H, Dv] bf16.  A work item
// is one (b, h, 128-row query tile); it walks the 128-row KV tiles from the
// first up to the one on its diagonal (the tiles past it are never read,
// the reference's causal block skip), and per tile each of its two 64-row
// halves computes
//     S = Q K^T * scale       [64, 128]  wgmma, fp32
//     mask kpos > qpos to -1e30          (the diagonal tile only; the
//                                        score, before the scale: exp
//                                        takes it to 0 all the same, and
//                                        every row keeps a live column)
//     online-softmax update of each row's (m, l), in registers
//     O = O * corr + P V      [64, Dv]   P as bf16 hi + lo, fp32 O
// and the epilogue writes O / l for the rows below S.  The recurrence is
// softmax_state.update in both rescale modes (softmax_state.cuh): amla
// keeps m an integer log2 bias and rescales by an exact 2^d.  The
// reference's P.V is fp32 P times bf16 V with fp32 accumulation; P enters
// the tensor cores as two bf16 terms (hi = bf16(p), lo = bf16(p - hi)),
// about 16 significant bits, as in the decode kernels.  (D, Dv) is a
// template parameter, one instantiation per pair of mma_tile.cuh's
// PrefillWidths: (192, 128) DeepSeek's decompressed MLA heads, (128, 128)
// and (64, 64) the GQA heads.  Any S: TMA reads rows past S as zero, and
// those rows are never written.  Tiles are anchored at row 0 and a masked
// term adds exactly 0, so rows [:T] of a call are bitwise a call on the
// first T rows.
//
// What bounds it on the H100: the operations.  The causal half of the
// two products is 2 B H S (S + 1) / 2 (D + Dv) FLOPs (2.75e12 for a
// DeepSeek dense-long layer, B 4 x S 4096, H 128: 2.78 ms at 989 TFLOP/s)
// against bytes of q, k, v and out read or written once (0.8 ms at 3.35
// TB/s); P's lo term adds the P V product once more (3.89 ms at peak at
// (192, 128)), and exp / the hi-lo split run on the FP32 pipes beside it.
//
// The design (hopper.cuh holds the building blocks).  A CTA is three
// warpgroups.  One warp of the first (the producer, its registers lowered
// to 40 by setmaxnreg) issues every load with TMA: the work item's Q tile
// (128 rows, 64-column boxes, 128-byte swizzle) and the K and V tiles
// into a ring of STAGES buffers, each with a full barrier (the bytes
// landed) and an empty one (both consumers done with it).  The two
// consumer warpgroups (raised to 232 registers) own 64 query rows each:
// S = Q K^T is an SS wgmma (m64n128k16, Q and K K-major in shared memory);
// its fp32 accumulator fragment is, n8 pair by n8 pair, the register A
// fragment of the k16 steps of P V, so P never leaves registers and is
// split into hi and lo in place; O += P V is an RS wgmma (m64nDvk16) with
// V read MN-major through the descriptor's transpose bit.  Per KV tile a
// consumer waits for its S, runs the softmax, then issues and waits for
// P V; the two consumers run unsynchronised, so one's softmax overlaps
// the other's products.  The softmax takes x = c S with c = scale (times
// log2(e) in amla mode) folded into one FMA with -m, the max taken on S
// (c > 0), and the mask written only on the diagonal tile: about 10
// instructions an element, which the tensor cores' time per tile (at
// (192, 128), 14.7 MFLOP a 128-row tile pair) covers only when the two
// consumers overlap.  (Tried on the H100 and dropped: the consumers
// taking turns through named barriers, S_{j+1} issued behind P_j V_j, and
// a second Q buffer; each was slower or no faster, PERF.md's findings.)
//
// The schedule is persistent and static: min(units, SMs) CTAs, CTA c
// taking units c, c + grid, ... .  A unit is one (b, h) and, where the
// single tiles would fill the SMs anyway, the pair of query tiles nqt - 1
// - p and p (the longer first): every pair walks nqt + 1 KV tiles, so a
// round-robin over pairs is even, where single tiles of lengths 1..nqt
// would leave CTAs up to 20% apart.  Units run b, h major, so the CTAs at
// work at one time read the K / V tiles of a few heads, which stay in L2:
// the KV tiles read again by each query tile would otherwise come from
// device memory (22.1 GB at dense-long, 6.6 ms at 3.35 TB/s).  m, l and O
// are reset per item and the barriers' phases carry across items.  BKV is
// 128 at every width, equal to BQ, so only the diagonal tile is masked and
// no 64-row half lies wholly above a KV tile (there is nothing to skip).
// STAGES is what the 227 KB of shared memory holds: 2 at (192, 128) (Q
// 48 KB + 2 x (K 48 + V 32 KB)), 3 at (128, 128), 4 at (64, 64).  One CTA
// an SM (384 threads at 168 registers).
#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "mma_tile.cuh"

namespace {

using namespace etap;
using namespace hopper;

constexpr int BQ = 128;        // query rows a work item: 64 a consumer
constexpr int BKV = 128;       // KV rows a tile
constexpr int BOX = 64;        // columns a TMA box (128 bytes)
constexpr int NCONS = 2;       // consumer warpgroups
constexpr int NTHREAD = 128 * (NCONS + 1);
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int SMEM_LIMIT = 232448;   // a CTA's shared memory on the H100
static_assert(128 * PRODUCER_REGS + 128 * NCONS * CONSUMER_REGS <= 65536,
              "the register file");

template <int D, int DV>
struct Cfg {
  static_assert(D % BOX == 0 && DV % BOX == 0, "whole boxes");
  static constexpr int QBYTES = BQ * D * 2;
  static constexpr int KBYTES = BKV * D * 2;
  static constexpr int VBYTES = BKV * DV * 2;
  // 1024 B of slack align the tiles to the swizzle's period; the
  // barriers are static shared memory
  static constexpr int FIT =
      (SMEM_LIMIT - 1024 - 256 - QBYTES) / (KBYTES + VBYTES);
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static_assert(STAGES >= 2, "a ring of two stages at least");
  static constexpr int SMEM = 1024 + QBYTES + STAGES * (KBYTES + VBYTES);
};

struct Params {
  bf16* out;           // [B, S, H, DV], contiguous
  int S;
  int H;
  int G;               // query heads per kv head
  int nqt;             // query tiles a head
  int per_head;        // work units a head: nqt, or (nqt + 1) / 2 in pairs
  int units;           // B * H * per_head
  int paired;          // a unit is query tiles nqt - 1 - p and p
  float scale;
  int amla;
};

// The work items of this CTA, in order: units blockIdx.x, blockIdx.x +
// gridDim.x, ..., unit u being head u / per_head (b major; the G heads of
// a kv head adjacent, so that their K / V tiles meet in L2) and within it
// query tile nqt - 1 - p, p = u % per_head, then, paired, tile p too (every
// pair but a middle one walks nqt + 1 KV tiles, so the units are even, and
// the longer tile goes first).
struct Items {
  int u = blockIdx.x;
  bool second = false;       // the unit's second tile is next

  __device__ bool next(const Params& P, int& b, int& h, int& qt) {
    if (u >= P.units) return false;
    const int bh = u / P.per_head, p = u % P.per_head;
    b = bh / P.H;
    h = bh % P.H;
    qt = second ? p : P.nqt - 1 - p;
    second = !second && P.paired && p < qt;
    if (!second) u += gridDim.x;
    return true;
  }
};

template <int D, int DV>
__global__ void __launch_bounds__(NTHREAD, 1) flash_prefill_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const Params P) {
  using C = Cfg<D, DV>;
  constexpr int ST = C::STAGES;
  constexpr int NBD = D / BOX, NBV = DV / BOX;
  constexpr int NT = BKV / 8;          // n8 tiles of S
  constexpr int ND = DV / 8;           // n8 tiles of O
  extern __shared__ unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* sk = sq + BQ * D;              // [ST][NBD][BKV][64]
  bf16* sv = sk + ST * BKV * D;        // [ST][NBV][BKV][64]
  __shared__ uint64_t q_full, q_empty;
  __shared__ uint64_t k_full[ST], v_full[ST], kv_empty[ST];

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(&q_full, 1);
    mbar_init(&q_empty, NCONS * 4);    // each consumer warp arrives
    for (int s = 0; s < ST; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&kv_empty[s], NCONS * 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid < 128) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid != 0) return;
    tma_prefetch_map(&tq);
    tma_prefetch_map(&tk);
    tma_prefetch_map(&tv);
    int stage = 0;
    uint32_t round = 0;
    Items items;
    int b, h, qt;
    for (uint32_t n = 0; items.next(P, b, h, qt); ++n) {
      const int kvh = h / P.G;
      mbar_wait(&q_empty, (n & 1) ^ 1);
      mbar_expect_tx(&q_full, C::QBYTES);
#pragma unroll
      for (int x = 0; x < NBD; ++x)
        tma_load_4d(sq + x * BQ * BOX, &tq, &q_full, x * BOX, h, qt * BQ, b);
      for (int j = 0; j <= qt; ++j) {
        mbar_wait(&kv_empty[stage], (round & 1) ^ 1);
        mbar_expect_tx(&k_full[stage], C::KBYTES);
#pragma unroll
        for (int x = 0; x < NBD; ++x)
          tma_load_4d(sk + (stage * NBD + x) * BKV * BOX, &tk, &k_full[stage],
                      x * BOX, kvh, j * BKV, b);
        mbar_expect_tx(&v_full[stage], C::VBYTES);
#pragma unroll
        for (int x = 0; x < NBV; ++x)
          tma_load_4d(sv + (stage * NBV + x) * BKV * BOX, &tv, &v_full[stage],
                      x * BOX, kvh, j * BKV, b);
        if (++stage == ST) {
          stage = 0;
          ++round;
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    setmaxnreg_inc<CONSUMER_REGS>();
    const int cw = tid / 128 - 1;      // rows 64 cw .. 64 cw + 63 of a tile
    const int t = tid % 128;
    const int lane = t & 31;
    const int g = lane >> 2, tq4 = lane & 3;    // fragment coordinates
    const int row = 64 * cw + 16 * (t >> 5) + g;  // tile row of e = 0, 1
    const bool amla = P.amla != 0;
    const bf16* qw = sq + 64 * cw * BOX;   // this half's rows in each box
    // softmax_state's logits: x = S * scale, times log2(e) in amla mode
    // (one factor here; the max of x is this factor times the max of S)
    const float c = amla ? P.scale * LOG2E : P.scale;
    int stage = 0;
    uint32_t round = 0;
    Items items;
    int b, h, qt;
    for (uint32_t n = 0; items.next(P, b, h, qt); ++n) {
      float o[ND * 4];
#pragma unroll
      for (int e = 0; e < ND * 4; ++e) o[e] = 0.f;
      float m[2] = {NEG_INF, NEG_INF};           // rows `row`, `row` + 8
      float l[2] = {0.f, 0.f};
      const int qpos0 = qt * BQ + row;
      mbar_wait(&q_full, n & 1);

      for (int j = 0; j <= qt; ++j) {
        // ---- S = Q K^T: D / 16 k16 steps, 4 to a box
        float s[NT * 4];
        mbar_wait(&k_full[stage], round & 1);
        const bf16* kt = sk + stage * NBD * BKV * BOX;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int x = kk / 4, cc = (kk % 4) * 16;
          const uint64_t dq = desc_sw128(qw + x * BQ * BOX + cc, 16, 1024);
          const uint64_t dk = desc_sw128(kt + x * BKV * BOX + cc, 16, 1024);
          if (kk == 0)
            wgmma_ss_m64n128k16_first(s, dq, dk);
          else
            wgmma_ss_m64n128k16(s, dq, dk);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        if (j == qt) {                   // the item's last read of Q
          __syncwarp();
          if (lane == 0) mbar_arrive(&q_empty);
          // the causal mask: column 8 nt + 2 tq4 + (e & 1) of the tile
          // is masked past the row's own column
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (8 * nt + 2 * tq4 + (e & 1) > row + 8 * (e >> 1))
                s[4 * nt + e] = NEG_INF;
        }

        // ---- online softmax of x = c S: the row max, the new stat and
        //      its rescale factor, p = exp(x - m), the row sum
        float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * nt + e]);
        float corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int off = 1; off < 4; off <<= 1)
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], off));
          mx[r] *= c;
          const float m_new = fmaxf(m[r], amla ? ceilf(mx[r]) : mx[r]);
          corr[r] = stat_weight(m[r] - m_new, amla);
          m[r] = m_new;
        }
        float sum[2] = {0.f, 0.f};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p =
                prob_exp(fmaf(s[4 * nt + e], c, -m[e >> 1]), amla);
            s[4 * nt + e] = p;
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
          o[4 * nd] *= corr[0];
          o[4 * nd + 1] *= corr[0];
          o[4 * nd + 2] *= corr[1];
          o[4 * nd + 3] *= corr[1];
        }

        // ---- P as the A fragments of P V's k16 steps: n8 tiles 2kk and
        //      2kk + 1 of S are step kk, split into bf16 hi + lo
        uint32_t hi[NT / 2][4], lo[NT / 2][4];
#pragma unroll
        for (int kk = 0; kk < NT / 2; ++kk)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const float* f = &s[4 * (2 * kk + (x >> 1)) + 2 * (x & 1)];
            const __nv_bfloat162 h2 = __floats2bfloat162_rn(f[0], f[1]);
            const float2 back = __bfloat1622float2(h2);
            const __nv_bfloat162 l2 =
                __floats2bfloat162_rn(f[0] - back.x, f[1] - back.y);
            hi[kk][x] = *reinterpret_cast<const uint32_t*>(&h2);
            lo[kk][x] = *reinterpret_cast<const uint32_t*>(&l2);
          }

        // ---- O += P V: V MN-major, its 64-column boxes LBO apart
        mbar_wait(&v_full[stage], round & 1);
        const bf16* vt = sv + stage * NBV * BKV * BOX;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < NT / 2; ++kk) {
          const uint64_t dv =
              desc_sw128(vt + 16 * kk * BOX, BKV * BOX * 2, 1024);
          if constexpr (DV == 128) {
            wgmma_rs_m64n128k16(o, hi[kk], dv);
            wgmma_rs_m64n128k16(o, lo[kk], dv);
          } else {
            static_assert(DV == 64, "Dv 64 or 128");
            wgmma_rs_m64n64k16(o, hi[kk], dv);
            wgmma_rs_m64n64k16(o, lo[kk], dv);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(hi);
        fence_regs(lo);
        __syncwarp();
        if (lane == 0) mbar_arrive(&kv_empty[stage]);
        if (++stage == ST) {
          stage = 0;
          ++round;
        }
      }

      // ---- epilogue: O / l for rows `row` and `row` + 8 below S
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int sp = qpos0 + 8 * r;
        if (sp >= P.S) continue;
        bf16* op = P.out + (((size_t)b * P.S + sp) * P.H + h) * DV;
#pragma unroll
        for (int nd = 0; nd < ND; ++nd)
          *reinterpret_cast<__nv_bfloat162*>(&op[8 * nd + 2 * tq4]) =
              __halves2bfloat162(
                  __float2bfloat16_rn(o[4 * nd + 2 * r] / l[r]),
                  __float2bfloat16_rn(o[4 * nd + 2 * r + 1] / l[r]));
      }
    }
  }
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

struct Operands {
  const void* q;       // row (b, s, h) at b*qb + s*qs + h*qh (elements)
  long long qb, qs, qh;
  const void* k;       // row (b, s, kvh) at b*kb + s*ks + kvh*kh
  long long kb, ks, kh;
  const void* v;       // as k
  long long vb, vs, vh;
  int B, S, H, K;
};

template <int D, int DV>
int launch_widths(const Operands& a, const Params& p, int grid,
                  void* stream) {
  using C = Cfg<D, DV>;
  CUtensorMap tq, tk, tv;
  int err = bf16_rows_map(&tq, a.q, D, a.H, a.S, a.B, a.qh, a.qs, a.qb, BQ);
  if (err == 0)
    err = bf16_rows_map(&tk, a.k, D, a.K, a.S, a.B, a.kh, a.ks, a.kb, BKV);
  if (err == 0)
    err = bf16_rows_map(&tv, a.v, DV, a.K, a.S, a.B, a.vh, a.vs, a.vb, BKV);
  if (err != 0) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_prefill_kernel<D, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_prefill_kernel<D, DV><<<grid, NTHREAD, C::SMEM,
                                static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, p);
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
// (d, dv), into out[0..2].  The registers are the launch's (168 a thread
// for 384 threads); setmaxnreg moves them to 40 in the producer and 232 in
// the consumers.
int flash_prefill_attrs(int d, int dv, int* out) {
  return with_widths<PrefillWidths>(d, dv, [&](auto D, auto DV) {
    constexpr int KD = decltype(D)::value, VD = decltype(DV)::value;
    cudaFuncAttributes a;
    const cudaError_t err =
        cudaFuncGetAttributes(&a, flash_prefill_kernel<KD, VD>);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = a.numRegs;
    out[1] = Cfg<KD, VD>::SMEM;
    out[2] = static_cast<int>(a.localSizeBytes);
    return 0;
  });
}

// K9: q [B,S,H,d] at q + b*qb + s*qs + h*qh, k [B,S,K,d] and v [B,S,K,dv]
// likewise (strides in elements; unit column stride; 16-byte aligned base
// and strides, as TMA needs), H a multiple of K; out [B,S,H,dv] bf16,
// contiguous.  (d, dv) one of flash_prefill_widths.
int flash_prefill(const void* q, long long qb, long long qs, long long qh,
                  const void* k, long long kb, long long ks, long long kh,
                  const void* v, long long vb, long long vs, long long vh,
                  void* out, int B, int S, int H, int K, int d, int dv,
                  float scale, int amla, void* stream) {
  if (K <= 0 || H % K || S <= 0 || B <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nqt = (S + BQ - 1) / BQ;
  if (static_cast<long long>(B) * H * nqt > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const Operands a{q, qb, qs, qh, k, kb, ks, kh, v, vb, vs, vh, B, S, H, K};
  Params p{};
  p.out = static_cast<bf16*>(out);
  p.S = S;
  p.H = H;
  p.G = H / K;
  p.nqt = nqt;
  // pairs halve the units: only where single tiles fill the SMs anyway
  p.paired = B * H * nqt > sms;
  p.per_head = p.paired ? (nqt + 1) / 2 : nqt;
  p.units = B * H * p.per_head;
  p.scale = scale;
  p.amla = amla;
  return with_widths<PrefillWidths>(d, dv, [&](auto D, auto DV) {
    return launch_widths<decltype(D)::value, decltype(DV)::value>(
        a, p, p.units < sms ? p.units : sms, stream);
  });
}

}  // extern "C"
