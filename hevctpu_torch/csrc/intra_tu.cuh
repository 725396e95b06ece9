// Device functions of one intra transform unit coded by a warp, shared by
// the port's kernels that code TUs: stage 2 (stage2_ctu.cu) and stage 1's
// candidate RD (stage1_rd.cu). Each is written out from the plain version
// it stands for (ops/intra.py, ops/transforms.py, ops/quant.py,
// ops/rate.py) and gives its integers exactly; the tables they read come
// from those Python functions through the kernels' wrappers.
//
// Lanes: a function that takes `lane` is called by all 32 lanes of the
// warp in step (it may shuffle or __syncwarp); predict_mode takes a
// segment (`sub` of `width` lanes) and never synchronises, so two half-
// warps may predict two modes side by side. Arrays live in shared memory
// unless said otherwise.
//
// Stage 2 and stage 1 build this header into separate libraries (ops/
// _nvcc.py keys each library on its source and the headers it includes).

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// Weight fields of ops/rate.py (_W_FIELDS order).
enum { kSig0, kSig1, kGt1_0, kGt1_1, kGt2_0, kGt2_1, kCsbf, kLast, kCbf1,
       kCbf0 };

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// ---------------------------------------------------------------------------
// Warp helpers: reductions over aligned segments of `width` lanes (16 or
// 32); every lane of the warp calls them.
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ T seg_sum(T v, int width) {
  for (int o = width >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ int seg_max(int v, int width) {
  for (int o = width >> 1; o > 0; o >>= 1)
    v = max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ int seg_min(int v, int width) {
  for (int o = width >> 1; o > 0; o >>= 1)
    v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// (value, index) minimum, ties to the lower index (torch's argmin).
__device__ __forceinline__ void seg_argmin(float& v, int& i, int width) {
  for (int o = width >> 1; o > 0; o >>= 1) {
    float ov = __shfl_xor_sync(kFull, v, o);
    int oi = __shfl_xor_sync(kFull, i, o);
    if (ov < v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

// ---------------------------------------------------------------------------
// Integer pieces (ops/rate.py, ops/quant.py)
// ---------------------------------------------------------------------------

__device__ __forceinline__ int bit_length(int x) {
  return x > 0 ? 32 - __clz(x) : 0;
}

__device__ __forceinline__ int rice_param(int cg_sum) {
  return min(max(bit_length(cg_sum + 8) - 4, 0), 4);
}

__device__ __forceinline__ int golomb_rice_bits(int v, int k) {
  if ((v >> k) < 3) return (v >> k) + 1 + k;
  int u = max(v - (3 << k), 0);
  int big = max(u + (1 << k), 1);
  return 4 + 2 * (bit_length(big) - 1) - k;
}

__device__ __forceinline__ int level_bits(int a, int k, const int* w) {
  int b = a > 0 ? w[kSig1] : w[kSig0];
  b += a > 1 ? w[kGt1_1] : (a == 1 ? w[kGt1_0] : 0);
  b += a > 2 ? w[kGt2_1] : (a == 2 ? w[kGt2_0] : 0);
  if (a > 2) b += golomb_rice_bits(a - 3, k) * 256;
  if (a > 0) b += 256;
  return b;
}

// The hard-decision quantiser's |level| of |coef| = a (quant.quantize,
// intra rounding offset 171/512).
__device__ __forceinline__ int hard_level(int a, int qs, int qbits) {
  return min((a * qs + (171 << (qbits - 9))) >> qbits, 32767);
}

// The normative dequantisation (H.265 8.6.3, flat scaling m = 16).
__device__ __forceinline__ int dequant(int level, int log2, int qp,
                                       const int* inv_scale) {
  int sc = inv_scale[qp % 6] * 16;
  int e = qp / 6 - (8 + log2 - 5);
  int d = e < 0 ? (level * sc + (1 << (-e - 1))) >> (-e)
                : (level * sc) * (1 << e);
  return min(max(d, -32768), 32767);
}

// ---------------------------------------------------------------------------
// Reference samples (intra.fill_reference, intra.smooth_reference). The
// 4n+1 boundary runs in scan order: the left column bottom to top, the
// corner at 2n, the top row left to right; top_e[k] = fill[2n + k],
// left_e[k] = fill[2n - k].
// ---------------------------------------------------------------------------

// Substitution (H.265 8.4.4.2.2) into fill: sample(i, v) sets v to
// boundary sample i and says whether it is available; an unavailable one
// takes the last available one before it in scan order, the leading ones
// the first available, and none available gives 128. bnd and fidx are
// scratch of 4n+1.
template <class Sample>
__device__ void reference(int* bnd, int* fidx, int* fill, int n,
                          const Sample& sample, int lane) {
  const int L = 4 * n + 1;
  int carry = -1, first = -1;
  for (int base = 0; base < L; base += 32) {
    int i = base + lane;
    bool a = false;
    if (i < L) a = sample(i, bnd[i]);
    unsigned m = __ballot_sync(kFull, a);
    unsigned below = m & ((2u << lane) - 1u);
    if (i < L) fidx[i] = below ? base + 31 - __clz(below) : carry;
    if (m) {
      if (first < 0) first = base + __ffs(m) - 1;
      carry = base + 31 - __clz(m);
    }
  }
  __syncwarp();
  for (int i = lane; i < L; i += 32) {
    int j = fidx[i] < 0 ? first : fidx[i];
    fill[i] = first < 0 ? 128 : bnd[j];
  }
  __syncwarp();
}

// The [1 2 1] smoothing of fill into filt, or at 32x32 the bilinear
// strong filter where both boundaries are flat.
__device__ void smooth(const int* fill, int* filt, int n, int lane) {
  const int L = 4 * n + 1, n2 = 2 * n;
  bool strong = false;
  if (n == 32) {
    int c = fill[n2];
    strong = abs(c + fill[2 * n2] - 2 * fill[n2 + n]) < 8 &&
             abs(c + fill[0] - 2 * fill[n2 - n]) < 8;
  }
  for (int i = lane; i < L; i += 32) {
    int v;
    if (i == 0 || i == L - 1) {
      v = fill[i];
    } else if (strong) {
      int k = i > n2 ? i - n2 : n2 - i;
      int end = i > n2 ? fill[L - 1] : fill[0];
      v = ((64 - k) * fill[n2] + k * end + 32) >> 6;
    } else {
      v = (fill[i - 1] + 2 * fill[i] + fill[i + 1] + 2) >> 2;
    }
    filt[i] = v;
  }
  __syncwarp();
}

// DC's value from the unfiltered references fl (every lane gets it).
__device__ __forceinline__ int dc_value(const int* fl, int n, int log2,
                                        int lane) {
  const int n2 = 2 * n;
  int part = 0;
  for (int k = 1 + lane; k <= n; k += 32) part += fl[n2 + k] + fl[n2 - k];
  return (seg_sum(part, 32) + n) >> (log2 + 1);
}

// One mode's prediction into pred [n][n] (8.4.4.2.4-6): ref the
// references the mode reads (filtered or not), fl the unfiltered ones,
// dc DC's value, edges the luma n < 32 DC and VER/HOR edge filters; src,
// idx, didx, fact the size's angular tables (intra._angular_tables).
// Lanes sub, sub + width, ... of a segment write it; no synchronisation.
__device__ __forceinline__ void predict_mode(
    int* pred, const int* ref, const int* fl, int dc, int n, int log2,
    int mode, bool edges, const int* src, const int* idx, const int* didx,
    const int* fact, int sub, int width) {
  const int nn = n * n, n2 = 2 * n;
  if (mode == 0) {                                   // planar
    for (int e = sub; e < nn; e += width) {
      int y = e >> log2, x = e & (n - 1);
      pred[e] = ((n - 1 - x) * ref[n2 - 1 - y] + (x + 1) * ref[n2 + n + 1] +
                 (n - 1 - y) * ref[n2 + 1 + x] + (y + 1) * ref[n2 - n - 1] +
                 n) >> (log2 + 1);
    }
  } else if (mode == 1) {                            // DC
    for (int e = sub; e < nn; e += width) {
      int y = e >> log2, x = e & (n - 1);
      int v = dc;
      if (edges) {
        if (y == 0 && x == 0)
          v = (fl[n2 - 1] + 2 * dc + fl[n2 + 1] + 2) >> 2;
        else if (y == 0)
          v = (fl[n2 + 1 + x] + 3 * dc + 2) >> 2;
        else if (x == 0)
          v = (fl[n2 - 1 - y] + 3 * dc + 2) >> 2;
      }
      pred[e] = v;
    }
  } else {                                           // angular
    const int mi = mode - 2;
    const int ln = 3 * n + 2;
    src += mi * ln;
    idx += mi * ln;
    didx += mi * n;
    fact += mi * n;
    const bool vertical = mode >= 18;
    const bool edge_mode = edges && (mode == 10 || mode == 26);
    for (int e = sub; e < nn; e += width) {
      int y = e >> log2, x = e & (n - 1);
      int r = vertical ? y : x, c = vertical ? x : y;
      int v;
      if (edge_mode && c == 0) {
        // VER: top_e[1] + (left_e[1+r] - corner) >> 1; HOR transposed
        int main1 = vertical ? fl[n2 + 1] : fl[n2 - 1];
        int side = vertical ? fl[n2 - 1 - r] : fl[n2 + 1 + r];
        v = min(max(main1 + ((side - fl[n2]) >> 1), 0), 255);
      } else {
        int g = min(c + didx[r] + 1 + n, 3 * n + 1);
        int g1 = min(g + 1, 3 * n + 1);
        int a = src[g] == 0 ? ref[n2 + idx[g]] : ref[n2 - idx[g]];
        int b = src[g1] == 0 ? ref[n2 + idx[g1]] : ref[n2 - idx[g1]];
        int f = fact[r];
        v = ((32 - f) * a + f * b + 16) >> 5;
      }
      pred[e] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// The forward transform (transforms.forward_transform) of c TUs of n x n
// int32: TU t's residual at res + t * n * pitch and its first pass at
// tmp + t * n * pitch, rows `pitch` apart (n + 1 keeps a warp's column
// reads off one bank); its coefficients at coef + t * n * n, rows n apart.
// coef[k2][k] = rs(sum_y M[k2][y] rs(sum_x M[k][x] res[y][x], s1), s2)
// ---------------------------------------------------------------------------

__device__ void forward(const int* res, int* tmp, int* coef, const int* m,
                        int n, int log2, int c, int pitch, int lane) {
  const int nn = n * n, tot = c * nn, s1 = log2 - 1, s2 = log2 + 6;
  for (int e = lane; e < tot; e += 32) {
    int t = e >> (2 * log2), f = e & (nn - 1);
    int k = f >> log2, y = f & (n - 1);
    const int* r = res + t * n * pitch + y * pitch;
    int acc = 0;
    for (int x = 0; x < n; ++x) acc += __ldg(m + k * n + x) * r[x];
    tmp[t * n * pitch + k * pitch + y] = (acc + (1 << (s1 - 1))) >> s1;
  }
  __syncwarp();
  for (int e = lane; e < tot; e += 32) {
    int t = e >> (2 * log2), f = e & (nn - 1);
    int k2 = f >> log2, k = f & (n - 1);
    const int* r = tmp + t * n * pitch + k * pitch;
    int acc = 0;
    for (int y = 0; y < n; ++y) acc += __ldg(m + k2 * n + y) * r[y];
    coef[e] = (acc + (1 << (s2 - 1))) >> s2;
  }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// rate.estimate_tu_bits for c TUs of n x n (levels in arr, TU-major,
// signed or not; c == 1 above 4x4): every lane returns the bits of the TU
// of its segment (16 lanes a TU at 4x4, else 32). w the QP's weights, lb
// its last-position bits [n], dpos / didx the diagonal scan and its
// inverse, cgpos the groups' scan; cg scratch of c (n/4)^2.
// ---------------------------------------------------------------------------

__device__ int estimate_tu_bits(int* cg, const int* arr, int c, int n,
                                int log2, const int* w, const int* lb,
                                const int* dpos, const int* didx,
                                const int* cgpos, int lane) {
  const int nn = n * n, tot = c * nn, seg = nn >= 32 ? 32 : 16;
  const int nc = n >> 2, cpc = nc * nc;
  for (int g = lane; g < c * cpc; g += 32) {
    const int* base = arr + (g / cpc) * nn;
    int gy = (g % cpc) / nc * 4, gx = (g % cpc) % nc * 4, sum = 0;
    for (int r = 0; r < 16; ++r)
      sum += abs(base[(gy + (r >> 2)) * n + gx + (r & 3)]);
    cg[g] = sum;
  }
  int last = -1;
  for (int e = lane; e < tot; e += 32)
    if (arr[e] != 0) last = max(last, dpos[e & (nn - 1)]);
  last = seg_max(last, seg);
  __syncwarp();
  int last_cg = -1;
  if (n > 4) {                                       // c == 1
    for (int g = lane; g < cpc; g += 32)
      if (cg[g] > 0) last_cg = max(last_cg, cgpos[g]);
    last_cg = seg_max(last_cg, 32);
  }
  int bits = 0;
  for (int e = lane; e < tot; e += 32) {
    int f = e & (nn - 1), y = f >> log2, x = f & (n - 1);
    int cs = cg[(e >> (2 * log2)) * cpc + (y >> 2) * nc + (x >> 2)];
    if ((n == 4 || cs > 0) && dpos[f] <= last)
      bits += level_bits(abs(arr[e]), rice_param(cs), w);
  }
  bits = seg_sum(bits, seg);
  __syncwarp();                                      // cg is reused
  if (last < 0) return w[kCbf0];
  int lf = didx[last];
  int csbf = n > 4 ? max(last_cg - 1, 0) * w[kCsbf] : 0;
  return w[kCbf1] + lb[lf >> log2] + lb[lf & (n - 1)] + csbf + bits;
}

}  // namespace
