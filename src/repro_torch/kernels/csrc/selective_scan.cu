// Mamba-1 selective scan (K10) for Hopper (sm_90a).  Replaces the Pallas
// kernel at repro/kernels/selective_scan/scan.py:64 (selective_scan_pallas
// :54, body _body :28):
//
//   h_t    = dA_t * h_{t-1} + dBx_t        dA, dBx: [B, L, D, N] fp32
//   y_t    = sum_n C_{t,n} * h_{t,d,n}     C: [B, L, N] fp32 -> y [B, L, D]
//   h_last = h_L                           [B, D, N] fp32
//
// The TPU kernel walks the sequence as a serial grid axis and carries the
// [d_blk, N] state in VMEM scratch from one chunk to the next.  Blocks of a
// CUDA grid run in no order, so here one block owns a [DB, N] slice of the
// state for the whole sequence, one fp32 h[d, n] in a register of each of
// its 256 threads (DB = 256 / N), and walks all L steps in a loop.  Grid
// (ceil(D / DB), B); threads past a ragged D run the loop on zeros and
// store nothing, so their lanes still take part in the shuffles.
//
// What bounds it on the H100: bytes.  Each (t, d, n) reads dA and dBx once
// (8 bytes) for about 3 fp32 operations, far under the card's fp32 rate.
// For fixed (b, t) a block's DB * N values of dA and dBx are contiguous, so
// each warp's loads are 128-byte lines.  The loads do not depend on h: each
// thread keeps the next P steps' dA and dBx in flight in registers while it
// computes the current P steps, so a step does not wait a memory latency.
// C is the same for every thread of a block: it is staged in shared memory
// T steps at a time.  y[b, t, d] is a shuffle reduction over the N lanes
// that share d, written by the lane of n = 0.
//
// Rounding: every multiply and add is __fmul_rn / __fadd_rn, which nvcc
// never contracts into an FMA, so h is bitwise the plain version's eager
// mul then add, and y is too: the plain version sums over n in the
// shuffle's own order, a halving tree (n + N/2 onto n, then n + N/4, ...).
// Offsets are 64-bit: B * L * D * N passes 2^31 at falcon's widths.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int P = 8;            // steps of dA / dBx in flight a thread
constexpr int T = 64;           // steps of C staged in shared memory
static_assert(T % P == 0, "a C tile holds whole prefetch groups");

template <int N>
__global__ void __launch_bounds__(THREADS)
    scan_kernel(const float* __restrict__ dA, const float* __restrict__ dBx,
                const float* __restrict__ c, float* __restrict__ y,
                float* __restrict__ h_out, int L, int D) {
  constexpr int DB = THREADS / N;
  __shared__ float cs[T * N];
  const int tid = threadIdx.x;
  const int n = tid % N;
  const int d = blockIdx.x * DB + tid / N;
  const long long b = blockIdx.y;
  const bool live = d < D;
  const long long step = (long long)D * N;     // elements from t to t + 1
  const long long base = b * L * step + (long long)(live ? d : 0) * N + n;
  const float* pa = dA + base;
  const float* px = dBx + base;
  const float* pc = c + b * L * N;
  float* py = y + b * L * D + d;

  // dA and dBx are read once: streaming loads, evicted first
  auto fetch = [&](float* fa, float* fx, int t0) {
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int t = t0 + k;
      const bool ok = live && t < L;
      fa[k] = ok ? __ldcs(pa + t * step) : 0.f;
      fx[k] = ok ? __ldcs(px + t * step) : 0.f;
    }
  };

  float h = 0.f;
  float a[P], x[P];
  fetch(a, x, 0);
  for (int t0 = 0; t0 < L; t0 += T) {
    __syncthreads();                           // the last tile is read
    for (int i = tid; i < T * N; i += THREADS) {
      const int t = t0 + i / N;
      cs[i] = t < L ? pc[(long long)t * N + i % N] : 0.f;
    }
    __syncthreads();
    const int steps = min(T, L - t0);
    for (int j = 0; j < steps; j += P) {
      float an[P], xn[P];
      fetch(an, xn, t0 + j + P);
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const int t = t0 + j + k;
        if (t < L) {                           // the same for the block
          h = __fadd_rn(__fmul_rn(a[k], h), x[k]);
          float p = __fmul_rn(cs[(j + k) * N + n], h);
#pragma unroll
          for (int off = N / 2; off > 0; off /= 2)
            p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, off));
          if (n == 0 && live) py[(long long)t * D] = p;
        }
      }
#pragma unroll
      for (int k = 0; k < P; ++k) {
        a[k] = an[k];
        x[k] = xn[k];
      }
    }
  }
  if (live) h_out[(b * D + d) * N + n] = h;
}

template <int N>
int launch(const float* dA, const float* dBx, const float* c, float* y,
           float* h, int B, int L, int D, cudaStream_t stream) {
  constexpr int DB = THREADS / N;
  const dim3 grid((D + DB - 1) / DB, B);
  scan_kernel<N><<<grid, THREADS, 0, stream>>>(dA, dBx, c, y, h, L, D);
  return (int)cudaGetLastError();
}

}  // namespace

// dA, dBx [B, L, D, N], c [B, L, N], y [B, L, D], h [B, D, N]: contiguous
// fp32.  N a power of two <= 32; any L >= 1 and any D.  Returns the launch's
// cudaError_t.
extern "C" int selective_scan(const float* dA, const float* dBx,
                              const float* c, float* y, float* h, int B,
                              int L, int D, int N, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (N) {
    case 1: return launch<1>(dA, dBx, c, y, h, B, L, D, s);
    case 2: return launch<2>(dA, dBx, c, y, h, B, L, D, s);
    case 4: return launch<4>(dA, dBx, c, y, h, B, L, D, s);
    case 8: return launch<8>(dA, dBx, c, y, h, B, L, D, s);
    case 16: return launch<16>(dA, dBx, c, y, h, B, L, D, s);
    case 32: return launch<32>(dA, dBx, c, y, h, B, L, D, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
