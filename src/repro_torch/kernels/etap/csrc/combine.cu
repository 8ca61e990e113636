// Split-KV phase 2 for Hopper (sm_90a): merge the per-split (m, l, Acc^T)
// of etap.cu's partial kernel into O.  Replaces the Pallas kernel at
// repro/kernels/etap/combine.py:60 (combine_splits_pallas :52, transposed
// orientation).
//
// Per output element: m* = max_s m_s, w_s = stat_weight(m_s - m*),
// l* = sum_s w_s l_s, acc* = sum_s w_s acc_s, O = (acc* / l*)^T in bf16 —
// softmax_state.merge_splits.  No atomics: each output element is owned by
// one thread, which sums its splits in order, so with one split the merge is
// bitwise the single-pass epilogue acc / l.
//
// What bounds it on the H100: bytes.  It reads n * Dv * H fp32 partials
// per batch row and writes H * Dv outputs.  A CTA takes a 32 (H) x 32 (Dv)
// tile: the reads run along H (the partials' minor axis) and the writes
// along Dv (the output's minor axis), through a shared-memory transpose.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "softmax_state.cuh"

namespace {

constexpr int TILE = 32;
constexpr int ROWS = 8;        // threads per tile column; 4 Dv rows each

__global__ void combine_kernel(const float* m, const float* l,
                               const float* acc, __nv_bfloat16* out, int n,
                               int H, int DV, int amla) {
  __shared__ float tile[TILE][TILE + 1];       // [dv][h]
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int dv0 = blockIdx.x * TILE, h0 = blockIdx.y * TILE;
  const int b = blockIdx.z;
  const int h = h0 + tx;
  if (h < H) {
    const float* mb = m + (size_t)b * n * H + h;
    const float* lb = l + (size_t)b * n * H + h;
    float mg = mb[0];
    for (int s = 1; s < n; ++s) mg = fmaxf(mg, mb[(size_t)s * H]);
    float lg = 0.f;
    float ag[TILE / ROWS] = {};
    for (int s = 0; s < n; ++s) {
      const float w = etap::stat_weight(mb[(size_t)s * H] - mg, amla != 0);
      lg += lb[(size_t)s * H] * w;
      const float* as = acc + (((size_t)b * n + s) * DV + dv0) * H + h;
#pragma unroll
      for (int i = 0; i < TILE / ROWS; ++i)
        ag[i] += as[(size_t)(ty + ROWS * i) * H] * w;
    }
#pragma unroll
    for (int i = 0; i < TILE / ROWS; ++i) tile[ty + ROWS * i][tx] = ag[i] / lg;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TILE / ROWS; ++i) {
    const int hh = h0 + ty + ROWS * i;
    if (hh < H)
      out[((size_t)b * H + hh) * DV + dv0 + tx] =
          __float2bfloat16_rn(tile[tx][ty + ROWS * i]);
  }
}

}  // namespace

extern "C" {

// K2: m, l [B,n,H]; acc [B,n,DV,H] fp32; out [B,H,DV] bf16.  DV must be a
// multiple of 32.
int etap_combine_splits(const float* m, const float* l, const float* acc,
                        void* out, int B, int n, int H, int DV, int amla,
                        void* stream) {
  const dim3 grid(DV / TILE, (H + TILE - 1) / TILE, B);
  const dim3 block(TILE, ROWS);
  combine_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      m, l, acc, static_cast<__nv_bfloat16*>(out), n, H, DV, amla);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
