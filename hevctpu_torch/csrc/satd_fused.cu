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
// What bounds it on an H100: integer instruction throughput. The algorithm
// needs one multiply-add per nonzero entry of P (taps and the constant)
// plus, per pixel and mode, 2*log2(S) butterfly adds, one magnitude and
// one sum: 3.27e9 operations for the four luma sizes of one 1080p frame,
// 0.196 ms over 132 SMs x 64 INT32 lanes x 1.98 GHz. Its bytes (refs and
// orig read once, costs written once) are 92.5 MB, 0.028 ms at 3.35 TB/s.
//
// Design, against the four costs of the first port (which walked each
// pixel's dense column of P, one mode per block, with one thread per
// subblock over a residual tile in shared memory and a shared atomic):
// (1) Sparse taps. P is 92-98% zeros, so the kernel never sees it: the
// wrapper derives a tap table from it (ops/satd_fused.py, tap_table). A
// tap word is  idx << 16 | w[idx+1] << 8 | w[idx]  -- the weights of refs
// idx and idx+1 -- and one __dp2a_lo against the staged pair word
// refs[idx] | refs[idx+1] << 16 applies both. An angular pixel reads one
// word (a second only in the modes and warps whose taps are not
// neighbours in refs, ~5% of pixels), a planar pixel four, DC none: its
// 2n-sample sum is taken once per row and scaled by the one weight the
// table records. (2) One staged tile for many modes. A block owns TM rows
// and a group of modes: it stages their refs and orig once into dynamic
// shared memory with cp.async and walks its modes over the staged tile,
// each thread keeping its orig pixels in registers. (3) Hadamard in
// registers. A thread owns R rows (Tile::sub_rows) of an S x S subblock
// of one row: it predicts and subtracts those R*S pixels, runs the row
// butterflies and the first log2(R) column stages in registers and the
// rest across the S/R lanes of its subblock with __shfl_xor_sync; sum
// |t|, the per-subblock rounding and the sum over the subblocks of a row
// are shuffle reductions (no residual tile, no atomics). R = 1 is fastest
// at n = 4 and 8; at n = 16 and 32, R = 2 and 4 trade shuffles for
// registers (timed on an H100 at both main-path shapes, PERF.md). (4) The
// [TM, modes] costs gather in shared memory and leave in one coalesced
// store. Everything is integer and exact for refs in 0..65535 (the pair
// words hold two); the last column of refs, 1 on the main path, scales
// each mode's constant term as in refs @ P.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (driven by hevctpu_torch/ops/satd_fused.py).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kModes = 35;
constexpr unsigned kFullMask = 0xffffffffu;

// Tap table layout, written by ops/satd_fused.py (_tap_table_np), int32:
//   [kTapRows][n*n] tap words: planar (mode 0) in rows 0..3, angular mode
//   m in rows 4 + 2*(m-2) and the next; DC has none;
//   [35] the constant term of each mode (P's row of the trailing 1);
//   [35] 1 where an angular mode uses its second row at all;
//   [1]  DC's weight on each of its 2n references.
constexpr int kPlanarSlots = 4;
constexpr int kAngularSlots = 2;
constexpr int kTapRows = kPlanarSlots + 33 * kAngularSlots;

// Per block size: tile rows and modes per block (256 threads, several
// blocks per SM at the smallest main-path shapes, 416x240 x 8: M = 57344
// / 14336 / 3584 / 896) and the subblock rows each thread owns; the
// fastest of the tables timed on an H100 at both main-path shapes.
template <int N> struct Tile;
template <> struct Tile<4> {
  static constexpr int rows = 64, modes = 35, sub_rows = 1;
};
template <> struct Tile<8> {
  static constexpr int rows = 32, modes = 35, sub_rows = 1;
};
template <> struct Tile<16> {
  static constexpr int rows = 16, modes = 7, sub_rows = 2;
};
template <> struct Tile<32> {
  static constexpr int rows = 8, modes = 7, sub_rows = 4;
};

constexpr int round4(int x) { return (x + 3) & ~3; }

// Dynamic shared memory of one block, in ints: raw refs, pair words, orig,
// costs; each region starts 16-byte aligned.
template <int N> struct Smem {
  static constexpr int K = 8 * N + 5;
  static constexpr int refs = 0;
  static constexpr int pairs = refs + round4(Tile<N>::rows * K);
  static constexpr int orig = pairs + round4(Tile<N>::rows * K);
  static constexpr int costs = orig + Tile<N>::rows * N * N;
  static constexpr int ints = costs + Tile<N>::rows * Tile<N>::modes;
};

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async16(int* dst, const int* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// Starts the copy of count ints into 16-byte-aligned shared memory; 16-byte
// copies where the source allows.
__device__ __forceinline__ void stage(int* dst, const int* src, int count) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int quads = count >> 2;
    for (int i = threadIdx.x; i < quads; i += kThreads)
      cp_async16(dst + 4 * i, src + 4 * i);
    done = quads << 2;
  }
  for (int i = done + threadIdx.x; i < count; i += kThreads)
    cp_async4(dst + i, src + i);
}

// Sum over the lanes that differ only in bits From..To/2 of the lane id.
template <int From, int To>
__device__ __forceinline__ int xor_sum(int v) {
#pragma unroll
  for (int h = From; h < To; h <<= 1) v += __shfl_xor_sync(kFullMask, v, h);
  return v;
}

// acc[x] += the taps of one table row for S consecutive pixels. A Sparse
// row (one only some pixels use) is skipped unless a lane of the warp
// needs it; the branch is warp-uniform.
template <int S, bool Sparse>
__device__ __forceinline__ void add_taps(unsigned* acc, const int* words,
                                         const unsigned* pairs) {
  int w[S];
  int any = 0;
#pragma unroll
  for (int v = 0; v < S / 4; ++v) {
    const int4 t = __ldg(reinterpret_cast<const int4*>(words) + v);
    w[4 * v] = t.x, w[4 * v + 1] = t.y, w[4 * v + 2] = t.z, w[4 * v + 3] = t.w;
    any |= t.x | t.y | t.z | t.w;
  }
  if (Sparse && !__any_sync(kFullMask, any != 0)) return;
#pragma unroll
  for (int x = 0; x < S; ++x) {
    const unsigned u = static_cast<unsigned>(w[x]);
    acc[x] = __dp2a_lo(pairs[u >> 16], u, acc[x]);
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads)
satd_mode_costs_kernel(const int* __restrict__ refs,
                       const int* __restrict__ orig,
                       const int* __restrict__ taps, int* __restrict__ out,
                       int m, int shift) {
  constexpr int NN = N * N;
  constexpr int K = Smem<N>::K;                 // 4 ext arrays + constant
  constexpr int TM = Tile<N>::rows;
  constexpr int MG = Tile<N>::modes;
  constexpr int S = N == 4 ? 4 : 8;             // Hadamard size
  constexpr int R = Tile<N>::sub_rows;          // subblock rows per thread
  constexpr int LS = S / R;                     // lanes per subblock
  constexpr int SPR = N / S;                    // subblocks per block row
  constexpr int U = NN / (S * R);               // threads per (row, mode)
  constexpr int L = U < 32 ? U : 32;            // lanes per tile row
  constexpr int G = L / LS;                     // subblocks in flight per row
  constexpr int Q = SPR * SPR / G;              // subblock passes per thread
  static_assert(TM * L == kThreads && kModes % MG == 0, "tile shape");

  extern __shared__ __align__(16) int smem[];
  int* refs_s = smem + Smem<N>::refs;
  unsigned* pairs_s = reinterpret_cast<unsigned*>(smem + Smem<N>::pairs);
  int* orig_s = smem + Smem<N>::orig;
  int* cost_s = smem + Smem<N>::costs;

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * TM;
  const int mode0 = blockIdx.y * MG;
  const int rows = min(TM, m - m0);

  // Stage the tile once for all its modes; rows past the end are zeros.
  stage(refs_s, refs + static_cast<size_t>(m0) * K, rows * K);
  stage(orig_s, orig + static_cast<size_t>(m0) * NN, rows * NN);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  for (int i = rows * K + tid; i < TM * K; i += kThreads) refs_s[i] = 0;
  for (int i = rows * NN + tid; i < TM * NN; i += kThreads) orig_s[i] = 0;
  __syncthreads();
  for (int i = tid; i < TM * K; i += kThreads) {
    const unsigned next = (i + 1) % K ? refs_s[i + 1] : 0;
    pairs_s[i] = static_cast<unsigned>(refs_s[i]) | next << 16;
  }

  // This thread: tile row r, subblock rows ly*R .. ly*R+R-1 of subblocks
  // grp + q*G.
  const int r = tid / L, j = tid % L;
  const int ly = j % LS, grp = j / LS;
  const int lane = tid & 31;

  // DC: one sum of top_ext[1..n] and left_ext[1..n] per row.
  const int* consts = taps + kTapRows * NN;
  const int* uses_second = consts + kModes;
  int dc_sum = 0;
  for (int e = j; e < 2 * N; e += L)
    dc_sum += refs_s[r * K + (e < N ? 1 + e : N + 2 + e)];
  dc_sum = xor_sum<1, L>(dc_sum);
  const unsigned one = refs_s[r * K + K - 1];   // refs' constant column
  const int dc_pred = (dc_sum * __ldg(uses_second + kModes) +
                       __ldg(consts + 1) * static_cast<int>(one)) >>
                      shift;

  int o[Q][R * S];
  int p0[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int sb = grp + q * G;
    p0[q] = ((sb / SPR) * S + ly * R) * N + (sb % SPR) * S;
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int x = 0; x < S; ++x)
        o[q][i * S + x] = orig_s[r * NN + p0[q] + i * N + x];
    }
  }
  __syncthreads();  // pair words complete

  const unsigned* pairs = pairs_s + r * K;
  for (int mm = 0; mm < MG; ++mm) {
    const int mode = mode0 + mm;                 // warp-uniform
    const unsigned c = __ldg(consts + mode) * one;
    const bool second = mode >= 2 && __ldg(uses_second + mode);
    const int* rows_of_mode =
        taps + (mode == 0 ? 0 : kPlanarSlots + (mode - 2) * kAngularSlots) * NN;
    int total = 0;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      int d[R * S];
      if (mode == 1) {
#pragma unroll
        for (int x = 0; x < R * S; ++x) d[x] = dc_pred - o[q][x];
      } else {
        unsigned acc[R * S];
#pragma unroll
        for (int x = 0; x < R * S; ++x) acc[x] = c;
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int* w = rows_of_mode + p0[q] + i * N;
          add_taps<S, false>(acc + i * S, w, pairs);
          if (mode == 0) {
#pragma unroll
            for (int t = 1; t < kPlanarSlots; ++t)
              add_taps<S, false>(acc + i * S, w + t * NN, pairs);
          } else if (second) {
            add_taps<S, true>(acc + i * S, w + NN, pairs);
          }
        }
#pragma unroll
        for (int x = 0; x < R * S; ++x)
          d[x] = (static_cast<int>(acc[x]) >> shift) - o[q][x];
      }
      // Row butterflies in registers; column butterflies between this
      // thread's rows (row bits below R), then across the LS lanes of the
      // subblock (lane bit h is row bit h*R).
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int h = 1; h < S; h <<= 1) {
#pragma unroll
          for (int b = 0; b < S; b += 2 * h) {
#pragma unroll
            for (int x = i * S + b; x < i * S + b + h; ++x) {
              const int u = d[x], v = d[x + h];
              d[x] = u + v;
              d[x + h] = u - v;
            }
          }
        }
      }
#pragma unroll
      for (int h = 1; h < R; h <<= 1) {
#pragma unroll
        for (int i = 0; i < R; ++i) {
          if (i & h) continue;
#pragma unroll
          for (int x = 0; x < S; ++x) {
            const int u = d[i * S + x], v = d[(i + h) * S + x];
            d[i * S + x] = u + v;
            d[(i + h) * S + x] = u - v;
          }
        }
      }
#pragma unroll
      for (int h = 1; h < LS; h <<= 1) {
        const int sign = lane & h ? -1 : 1;
#pragma unroll
        for (int x = 0; x < R * S; ++x)
          d[x] = __shfl_xor_sync(kFullMask, d[x], h) + sign * d[x];
      }
      int s = 0;
#pragma unroll
      for (int x = 0; x < R * S; ++x) s += abs(d[x]);
      s = xor_sum<1, LS>(s);
      total += N == 4 ? (s + 1) >> 1 : (s + 2) >> 2;
    }
    total = xor_sum<LS, L>(total);
    if (j == 0) cost_s[r * MG + mm] = total;
  }
  __syncthreads();
  for (int i = tid; i < rows * MG; i += kThreads)
    out[static_cast<size_t>(m0 + i / MG) * kModes + mode0 + i % MG] = cost_s[i];
}

template <int N>
int launch(const int* refs, const int* orig, const int* taps, int* out, int m,
           int shift, cudaStream_t stream) {
  constexpr int TM = Tile<N>::rows;
  const int bytes = Smem<N>::ints * static_cast<int>(sizeof(int));
  const cudaError_t e = cudaFuncSetAttribute(
      satd_mode_costs_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((m + TM - 1) / TM, kModes / Tile<N>::modes);
  satd_mode_costs_kernel<N><<<grid, kThreads, bytes, stream>>>(
      refs, orig, taps, out, m, shift);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// refs [m, 8n+5] int32 (values 0..65535), orig [m, n*n] int32, taps the
// tap table of (n, luma/chroma) (layout above), out [m, 35] int32, all
// contiguous on the device; launches on `stream`. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int hevc_satd_mode_costs(const void* refs, const void* orig,
                                    const void* taps, void* out, int m, int n,
                                    int shift, void* stream) {
  if (m <= 0) return 0;
  const auto* r = static_cast<const int*>(refs);
  const auto* o = static_cast<const int*>(orig);
  const auto* t = static_cast<const int*>(taps);
  auto* c = static_cast<int*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 4: return launch<4>(r, o, t, c, m, shift, s);
    case 8: return launch<8>(r, o, t, c, m, shift, s);
    case 16: return launch<16>(r, o, t, c, m, shift, s);
    case 32: return launch<32>(r, o, t, c, m, shift, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Rows of refs one block stages at size n (0 for an unsupported n).
extern "C" int hevc_satd_tile_rows(int n) {
  switch (n) {
    case 4: return Tile<4>::rows;
    case 8: return Tile<8>::rows;
    case 16: return Tile<16>::rows;
    case 32: return Tile<32>::rows;
    default: return 0;
  }
}

// The tap table's layout as the kernel reads it at size n, for the wrapper
// to hold against its own: tap words per planar and per angular pixel, and
// the table's length in ints.
extern "C" void hevc_satd_tap_layout(int n, int* planar, int* angular,
                                     int* ints) {
  *planar = kPlanarSlots;
  *angular = kAngularSlots;
  *ints = kTapRows * n * n + 2 * kModes + 1;
}

extern "C" const char* hevc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
