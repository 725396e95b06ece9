// K1: fused stage-1 mode search for Hopper (sm_90a) -- all-35-mode intra
// prediction + Hadamard SATD, the predictions never leaving the SM.
//
// Replaces the JAX package's Pallas TPU kernel hevctpu/ops/satd_fused.py
// (mode_satd_costs -> _make_kernel, pallas_call at :119). It computes, for
// each of M blocks (n x n, n in {4, 8, 16, 32}) and each of the 35 modes:
//   pred = (refs[m, :] @ P[:, mode, :]) >> shift      (P: static, int32)
//   diff = pred - orig[m, :]
//   cost = sum over SxS subblocks of (sum |H diff H^T| + r) >> s
// with S = 8 ((s+2)>>2) or S = 4 at n = 4 ((s+1)>>1). The DC/VER/HOR
// columns are left unpatched for the caller, as in the JAX package.
//
// What bounds it on an H100: it must read refs and orig and write the
// costs, M*(K + n^2 + 35)*4 bytes (K = 8n+5), ~93 MB for one 1080p frame
// over the four sizes (~28 us at 3.35 TB/s); its integer work (the
// prediction taps plus the butterflies) is ~1e9 operations per frame.
// Design: the TPU kernel's Kronecker [n^2, n^2] product and |t| @ G
// grouping existed only to feed the MXU. Here a block owns TM rows and
// one mode: the references of its rows sit in shared memory, each thread
// accumulates one pixel column of P for several rows in registers (P is
// read once per block, coalesced, and skipped where its weight is 0), the
// residual goes to shared memory, and one thread per subblock runs the
// Hadamard as in-register butterflies. Everything is int32 and exact.
// Not yet done (later work): sparse tap lists instead of the dense P
// column walk, several modes per block to reuse the staged references.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (driven by hevctpu_torch/ops/satd_fused.py).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kModes = 35;

// Rows per block, by block size: keeps refs + residual under 48 KB of
// static shared memory and gives every thread several rows to reuse each
// P weight on.
template <int N> struct RowsPerBlock;
template <> struct RowsPerBlock<4> { static constexpr int value = 64; };
template <> struct RowsPerBlock<8> { static constexpr int value = 32; };
template <> struct RowsPerBlock<16> { static constexpr int value = 16; };
template <> struct RowsPerBlock<32> { static constexpr int value = 8; };

// Sum of |t| over t = H d H^T for an S x S block held in registers (H the
// S-point Walsh-Hadamard matrix; the sum does not depend on its row
// order).
template <int S>
__device__ __forceinline__ int hadamard_abs_sum(int (&d)[S * S]) {
#pragma unroll
  for (int r = 0; r < S; ++r) {
#pragma unroll
    for (int h = 1; h < S; h <<= 1) {
#pragma unroll
      for (int i = 0; i < S; i += 2 * h) {
#pragma unroll
        for (int j = i; j < i + h; ++j) {
          const int a = d[r * S + j], b = d[r * S + j + h];
          d[r * S + j] = a + b;
          d[r * S + j + h] = a - b;
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < S; ++c) {
#pragma unroll
    for (int h = 1; h < S; h <<= 1) {
#pragma unroll
      for (int i = 0; i < S; i += 2 * h) {
#pragma unroll
        for (int j = i; j < i + h; ++j) {
          const int a = d[j * S + c], b = d[(j + h) * S + c];
          d[j * S + c] = a + b;
          d[(j + h) * S + c] = a - b;
        }
      }
    }
  }
  int s = 0;
#pragma unroll
  for (int k = 0; k < S * S; ++k) s += abs(d[k]);
  return s;
}

template <int N>
__global__ void __launch_bounds__(kThreads)
satd_mode_costs_kernel(const int* __restrict__ refs,
                       const int* __restrict__ orig,
                       const int* __restrict__ pmat, int* __restrict__ out,
                       int m, int shift) {
  constexpr int N2 = N * N;
  constexpr int K = 8 * N + 5;                  // 4 ext arrays + constant
  constexpr int TM = RowsPerBlock<N>::value;
  constexpr int PIX = N2 < kThreads ? N2 : kThreads;  // pixels per pass
  constexpr int RPT = TM / (kThreads / PIX);    // rows per thread
  constexpr int S = N == 4 ? 4 : 8;             // Hadamard size
  constexpr int SPR = N / S;                    // subblocks per row
  constexpr int NSB = SPR * SPR;                // subblocks per block
  constexpr int LD = kModes * N2;               // P row stride

  __shared__ int refs_s[TM * K];
  __shared__ int diff_s[TM * N2];
  __shared__ int sum_s[TM];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * TM;
  const int mode = blockIdx.y;
  const int rows = min(TM, m - m0);

  for (int i = tid; i < TM * K; i += kThreads) {
    const int r = i / K;
    refs_s[i] = r < rows ? refs[(size_t)m0 * K + i] : 0;
  }
  if (tid < TM) sum_s[tid] = 0;
  __syncthreads();

  // Prediction and residual: thread owns pixel p of rows rg*RPT + i.
  const int rg = tid / PIX;
  const int* pcol = pmat + mode * N2;
  for (int p = tid % PIX; p < N2; p += PIX) {
    int acc[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) acc[i] = 0;
    for (int k = 0; k < K; ++k) {
      const int w = __ldg(pcol + (size_t)k * LD + p);
      if (w == 0) continue;
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[i] += w * refs_s[(rg * RPT + i) * K + k];
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rg * RPT + i;
      const int o = r < rows ? orig[(size_t)(m0 + r) * N2 + p] : 0;
      diff_s[r * N2 + p] = (acc[i] >> shift) - o;
    }
  }
  __syncthreads();

  // Hadamard per S x S subblock, one thread each.
  for (int sb = tid; sb < TM * NSB; sb += kThreads) {
    const int r = sb / NSB, q = sb % NSB;
    const int by = (q / SPR) * S, bx = (q % SPR) * S;
    int d[S * S];
#pragma unroll
    for (int y = 0; y < S; ++y) {
#pragma unroll
      for (int x = 0; x < S; ++x) d[y * S + x] = diff_s[r * N2 + (by + y) * N + bx + x];
    }
    const int s = hadamard_abs_sum<S>(d);
    atomicAdd(&sum_s[r], N == 4 ? (s + 1) >> 1 : (s + 2) >> 2);
  }
  __syncthreads();
  if (tid < rows) out[(size_t)(m0 + tid) * kModes + mode] = sum_s[tid];
}

template <int N>
void launch(const int* refs, const int* orig, const int* pmat, int* out,
            int m, int shift, cudaStream_t stream) {
  constexpr int TM = RowsPerBlock<N>::value;
  const dim3 grid((m + TM - 1) / TM, kModes);
  satd_mode_costs_kernel<N><<<grid, kThreads, 0, stream>>>(refs, orig, pmat,
                                                            out, m, shift);
}

}  // namespace

// refs [m, 8n+5] int32, orig [m, n*n] int32, pmat [8n+5, 35*n*n] int32,
// out [m, 35] int32, all contiguous on the device; launches on `stream`.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int hevc_satd_mode_costs(const void* refs, const void* orig,
                                    const void* pmat, void* out, int m, int n,
                                    int shift, void* stream) {
  if (m <= 0) return 0;
  const auto* r = static_cast<const int*>(refs);
  const auto* o = static_cast<const int*>(orig);
  const auto* p = static_cast<const int*>(pmat);
  auto* c = static_cast<int*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 4: launch<4>(r, o, p, c, m, shift, s); break;
    case 8: launch<8>(r, o, p, c, m, shift, s); break;
    case 16: launch<16>(r, o, p, c, m, shift, s); break;
    case 32: launch<32>(r, o, p, c, m, shift, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hevc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
