// Shared bodies of the port's line and band kernels: I and H
// (fft_plane.cu), D at N <= 1024 (fft_axis2.cu), A and A64 (fft_axis.cu),
// E and E64 at N = 768 (fft_axis_tp.cu), and the in-place stages of the
// real kernels' column bands (rfft_axis.cu).  Templated on the element
// type T (float or double).
//
// * Line stages (line_stage, line_stages): the Stockham stages of one
//   N-point line held by a group of G = N / P threads, P points a thread
//   in registers, the group inside one warp; each stage's butterflies in
//   registers, the exchange between stages through the group's own buffer
//   in shared memory behind __syncwarp.  I's row kernel and the line body
//   below run them.
// * The line body (line_body): whole lines (post == 1) of an axis whose
//   rows arrive as two halves of h = N/2 rows, each a "Half" with its own
//   base pointer and strides (D's two operands; A64's one tensor is its
//   two halves): every load of a line before its first store, 16-byte
//   vectors, the scale folded into the store; with a row map (below) in
//   its read or its write.
// * In-place decimation-in-frequency stages over a block of rows or
//   columns held in shared memory (dif_stage, dif_pass), one butterfly a
//   thread at a time, and the radix-K step across a cluster of K CTAs
//   (cluster_dif_step): H's and I's stages, the band body below, and
//   rfft_axis.cu's bands; a stage reads its twiddles from a source: a
//   table of powers (Powers), or, in the real bands, their unpack rows
//   (rfft_axis.cu HalfPowers).
// * The band body (axis_band): C adjacent lines of an axis with post > 1
//   held as an N x C band of shared memory by one CTA or a cluster of K
//   CTAs (R = N / K rows each, CTA r rows r R ..; R = 2^a or 3*2^a, whose
//   columns take a radix-3 stage first), loaded and stored as 16-byte
//   vectors of adjacent columns (or single elements), the scale folded
//   into the store.
// * Row maps (AllRows, PadRows, TruncRows) let the read of a line or a
//   band zero-pad a shorter input, or its write truncate the result: the
//   3/2-rule boundary of fft_axis_tp.cu.
// * Work policies say what the line and band bodies do between their
//   load and their store: the transform (AxisWork, every kernel's), or
//   the probe kernel bfly's work (probe_bfly.cu ProbeWork).
// Device bodies take their shared memory as an argument and the kernels
// that run them declare it, so that the CPU emulation of the tests
// (tests/cuda_emu) compiles this header as it is.
#pragma once

#include <cstddef>

#include <cooperative_groups.h>

#include "butterfly.cuh"

namespace mff {

// The least l with 2^l >= n.
inline int log2_of(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

// ---------------------------------------------------------------------------
// clusters
// ---------------------------------------------------------------------------

// This CTA's rank in its cluster, a barrier over every thread of the
// cluster, and the address of the same shared-memory object in CTA
// `rank` (distributed shared memory).
__device__ __forceinline__ unsigned cluster_rank() {
  return cooperative_groups::this_cluster().block_rank();
}
__device__ __forceinline__ void cluster_sync() {
  cooperative_groups::this_cluster().sync();
}
template <class T>
__device__ __forceinline__ T* peer_smem(T* p, unsigned rank) {
  return cooperative_groups::this_cluster().map_shared_rank(p, rank);
}

// A launch of `grid` blocks of `threads` threads and `smem` bytes of
// dynamic shared memory, in clusters of `cluster` CTAs when cluster > 1;
// the error of a refused launch, else cudaGetLastError().
template <class... E, class... A>
inline int launch_ex(void (*kern)(E...), long long grid, int threads,
                     std::size_t smem, int cluster, cudaStream_t stream,
                     A... args) {
  if (grid <= 0 || grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg{};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3{static_cast<unsigned>(grid), 1u, 1u};
  cfg.blockDim = dim3{static_cast<unsigned>(threads), 1u, 1u};
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kern, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// operands
// ---------------------------------------------------------------------------

// One half of an axis: element (plane p, pre index i, row k, column c)
// sits at ptr[p * plane + i * pre + k * post + c].
template <class T>
struct Half {
  T* ptr;
  long long plane;
  long long pre;
};

// Adjacent elements in a 16-byte vector: 4 floats or 2 doubles.
template <class T>
constexpr int kVec16 = static_cast<int>(16 / sizeof(T));

template <class T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
  __device__ __forceinline__ static type make(const float* v) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
  __device__ __forceinline__ static void split(const type& u, float* v) {
    v[0] = u.x;
    v[1] = u.y;
    v[2] = u.z;
    v[3] = u.w;
  }
};
template <>
struct Vec16<double> {
  using type = double2;
  __device__ __forceinline__ static type make(const double* v) {
    return make_double2(v[0], v[1]);
  }
  __device__ __forceinline__ static void split(const type& u, double* v) {
    v[0] = u.x;
    v[1] = u.y;
  }
};

// ---------------------------------------------------------------------------
// row maps
// ---------------------------------------------------------------------------

// Row maps of the line and band bodies: which rows of the axis the N
// rows of a line or band are read from or written to.  AllRows: row r is
// row r, the input and the output both in two halves (a, b; oa, ob).
// PadRows (the 3/2 rule's zero-pad of an nt-row spectrum, nt < N, in the
// read; h' = nt/2, top = N - nt): band row k takes input row k for k < h'
// (and k = h' for odd nt), input row k - top for k > top + h', half of
// input row h' for k = h' and k = top + h' (even nt), and is zero
// otherwise, read from no memory; the input is `a` alone, with nt rows.
// TruncRows (the truncation to nt rows in the write): output row j takes
// band row j for j < h' (and j = h' for odd nt), band row j + top for
// j > h', and for even nt band rows h' + (h' + top) (the Nyquist fold,
// both rows in one CTA: K divides top; in one warp on whole lines); the
// output is `oa` alone, with nt rows.  The maps are _pad_rows and
// _trunc_rows of the JAX package (pallas_butterfly.py:455-481).
struct AllRows {
  static constexpr int kMode = 0;
};
struct PadRows {
  static constexpr int kMode = 1;
  int nt;
};
struct TruncRows {
  static constexpr int kMode = 2;
  int nt;
};

// PadRows: the input row of band row k of an n-row band (-1 for a zero
// row) and its factor (1, or 1/2 for the split row).
template <class T>
__device__ __forceinline__ int pad_source(int k, int n, int nt, T* f) {
  const int hh = nt >> 1, top = n - nt;
  const bool even = (nt & 1) == 0;
  *f = T(1);
  if (k < hh || (!even && k == hh)) return k;
  if (k > top + hh) return k - top;
  if (even && (k == hh || k == top + hh)) {
    *f = T(0.5);
    return hh;
  }
  return -1;
}

// TruncRows: the output row of band row r of an n-row band (-1 if it is
// not kept, or is folded into row h' by the CTA that holds row h'), and
// whether band row r + top is added to it.
__device__ __forceinline__ int trunc_target(int r, int n, int nt,
                                            bool* fold) {
  const int hh = nt >> 1, top = n - nt;
  const bool even = (nt & 1) == 0;
  *fold = even && r == hh;
  if (r < hh || r == hh) return r;
  if (r > top + hh) return r - top;
  return -1;
}

// ---------------------------------------------------------------------------
// work policies
// ---------------------------------------------------------------------------

// What the line and band bodies do between their load and their store.
// AxisWork, the default: the transform, every kernel's body.  Another
// policy sets kTransform false and supplies the work (with the row map
// AllRows):
//   work.line<T, N, P>(zr, zi, br, bi, g, twr, twi, sign) on the loaded
//     line (point row_own(g, s) in zr/zi[s]) leaves it in natural order
//     in the group's buffer, or, with kStoreHeld, leaves the loaded
//     registers for the store;
//   work.band<K, kB, kThreads>(k, lc, lr, elems, kk, twr, twi, sign)
//     runs on the loaded band, from the first cluster barrier after the
//     load to the last before the store;
//   W::band_row<K, kB>(m, lr, kk, &src, &r) gives, for this CTA's m-th
//     row after the work, the row of its shared memory that holds it and
//     the row of the axis it is stored to.
struct AxisWork {
  static constexpr bool kTransform = true;
  static constexpr bool kStoreHeld = false;
};

// What one stage computes (kArith): its DFT and twiddles (kStageFull,
// the transform's), its DFT alone (kStageAdds), or neither (kStageMoves:
// every point read and written back unchanged).
enum { kStageMoves = 0, kStageAdds = 1, kStageFull = 2 };

// A value that a kStageMoves stage reads and writes back unchanged: the
// empty asm hides that it is unchanged, so that neither the read nor the
// write is dropped as redundant.
template <class T>
__device__ __forceinline__ void keep(T& v) {
#ifdef __CUDA_ARCH__
  if constexpr (sizeof(T) == 4)
    asm volatile("" : "+f"(v));
  else
    asm volatile("" : "+d"(v));
#else
  (void)v;
#endif
}

// ---------------------------------------------------------------------------
// line stages
// ---------------------------------------------------------------------------

// Adjacent points of one component a thread loads as one vector: a
// 16-byte vector, or the whole line when it is shorter.
template <class T>
__host__ __device__ constexpr int line_vec(int N) {
  return N >= kVec16<T> ? kVec16<T> : N;
}

// Radix of stage s of an N-point line of P points a thread (0 past the
// last).  A line held whole by one thread (N = P <= 16, a power of two)
// is one stage of radix N.  Otherwise the first stage is radix 8, or 3
// for N = 3*2^a, so that a thread's first-stage butterflies are those of
// the adjacent points of its vector loads; then radix 16 while it divides
// (8 when P is not a multiple of 16), then the remainder.  Every radix
// divides P.
__host__ __device__ constexpr int line_radix(int N, int P, int s) {
  if (N == P && N <= 16 && N % 3 != 0) return s == 0 ? N : 0;
  const int first = N % 3 == 0 ? 3 : 8;
  if (s == 0) return first;
  const int top = P % 16 == 0 ? 16 : 8;
  int rest = N / first;
  for (int i = 1; rest > 1; ++i) {
    const int r = rest >= top ? top : rest;
    if (i == s) return r;
    rest /= r;
  }
  return 0;
}

// Product of the radices before stage s.
__host__ __device__ constexpr int line_span(int N, int P, int s) {
  int m = 1;
  for (int i = 0; i < s; ++i) m *= line_radix(N, P, i);
  return m;
}

// A line's buffer in shared memory: point i at bpad(i), 4 elements of
// gap after every 32 (vectors stay 16-byte aligned; the first stage's
// vector writes and the store's vector reads fall on distinct banks).
__host__ __device__ constexpr int row_buf(int N) {
  return N >= 32 ? N + N / 8 : N;
}
__device__ __forceinline__ int bpad(int i) { return i + ((i >> 5) << 2); }

// Point or butterfly k of thread g in a group of G: g + G k, or, in runs
// of V adjacent ones, V (g + G (k / V)) + k % V.
template <int V, int G>
__device__ __forceinline__ int row_own(int g, int k) {
  return V * (g + G * (k / V)) + k % V;
}

// One Stockham stage of radix R over the N-point line of a group of
// G = N / P threads, with M sub-transforms interleaved (M: the earlier
// radices' product): butterfly b (lp = b / M, m = b % M) takes points
// (j Lq + lp) M + m, j < R, of the stage's input, forms their DFT,
// multiplies output j by w_N^(j lp M) and writes it to point
// (lp R + j) M + m of the buffer.  Thread g owns butterflies b = g + G k,
// k < P/R; in the first stage the butterflies of the points it loaded
// (row_own with V = line_vec), which it reads from its registers (point
// row_own(g, s) in zr/zi[s]) and writes as vectors.  The others read the
// buffer; every stage ends on __syncwarp.  twr, twi: the powers
// w_N^e, e < N (cos and sin of sign 2 pi e / N).  kArith: the stage's
// arithmetic (kStageFull; a probe's kStageAdds or kStageMoves).
template <class T, int N, int P, int R, int M, bool kFirst,
          int kArith = kStageFull>
__device__ __forceinline__ void line_stage(const T* zr, const T* zi, T* br,
                                           T* bi, int g,
                                           const T* __restrict__ twr,
                                           const T* __restrict__ twi,
                                           T sign) {
  constexpr int G = N / P, K = P / R;
  constexpr int V = kFirst ? line_vec<T>(N) : 1;
  constexpr int Lq = N / M / R;
  T vr[K][R], vi[K][R];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int b = row_own<V, G>(g, k);
    const int lp = b / M, m = b % M;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if constexpr (kFirst) {
        vr[k][j] = zr[k + K * j];
        vi[k][j] = zi[k + K * j];
      } else {
        const int s = bpad((j * Lq + lp) * M + m);
        vr[k][j] = br[s];
        vi[k][j] = bi[s];
      }
    }
    if constexpr (kArith == kStageMoves) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        keep(vr[k][j]);
        keep(vi[k][j]);
      }
    } else {
      Dft<R, T>::run(vr[k], vi[k], sign);
    }
    if constexpr (Lq > 1 && kArith == kStageFull) {
#pragma unroll
      for (int j = 1; j < R; ++j) {
        const int e = j * lp * M;
        const T wr = __ldg(twr + e), wi = __ldg(twi + e);
        const T yr = vr[k][j], yi = vi[k][j];
        vr[k][j] = yr * wr - yi * wi;
        vi[k][j] = yr * wi + yi * wr;
      }
    }
  }
  if (!kFirst) __syncwarp();   // the group has read the buffer
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int b = row_own<V, G>(g, k);
    const int lp = b / M, m = b % M;
    if constexpr (kFirst && R % kVec16<T> == 0) {   // M = 1: b R + j
#pragma unroll
      for (int j = 0; j < R; j += kVec16<T>) {
        const int d = bpad(b * R + j);
        using U = typename Vec16<T>::type;
        *reinterpret_cast<U*>(br + d) = Vec16<T>::make(&vr[k][j]);
        *reinterpret_cast<U*>(bi + d) = Vec16<T>::make(&vi[k][j]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int d = bpad((lp * R + j) * M + m);
        br[d] = vr[k][j];
        bi[d] = vi[k][j];
      }
    }
  }
  __syncwarp();
}

// Stages s.. of an N-point line of P points a thread.
template <class T, int N, int P, int S>
__device__ __forceinline__ void line_stages(const T* zr, const T* zi, T* br,
                                            T* bi, int g,
                                            const T* __restrict__ twr,
                                            const T* __restrict__ twi,
                                            T sign) {
  if constexpr (line_radix(N, P, S) != 0) {
    line_stage<T, N, P, line_radix(N, P, S), line_span(N, P, S), S == 0>(
        zr, zi, br, bi, g, twr, twi, sign);
    line_stages<T, N, P, S + 1>(zr, zi, br, bi, g, twr, twi, sign);
  }
}

// Threads a block (128 / G lines) and blocks an SM of the line body's
// kernels.  float: four blocks an SM (128 registers a thread); double:
// the registers a thread needs (up to 255).
template <class T>
struct LineLaunch {
  static constexpr int kThreads = 128;
  static constexpr int kMinBlocks = sizeof(T) == 4 ? 4 : 1;
};

// PadRows on whole lines: the vector of rows p .. p + V - 1 (p a
// multiple of V) of an N-point line from the nt-row input x (its planes
// `plane` apart), where h' = nt/2 and top = N - nt are multiples of V
// (so nt is even): input rows p .. for p < h', rows p - top .. for
// p > top + h', the vector at h' for p = h' and p = top + h' (pad_split
// then halves its first lane, the split row, and zeroes the other lanes
// at p = h'), else zero, read from no memory.
template <class T>
__device__ __forceinline__ void pad_load(const T* x, long long plane, int p,
                                         int n, int nt, T* vr, T* vi) {
  using U = typename Vec16<T>::type;
  constexpr int V = kVec16<T>;
  const int hh = nt >> 1, top = n - nt;
  const int src = p < hh ? p : p > top + hh ? p - top
                : p == hh || p == top + hh ? hh : -1;
  if (src >= 0) {
    Vec16<T>::split(__ldg(reinterpret_cast<const U*>(x + src)), vr);
    Vec16<T>::split(__ldg(reinterpret_cast<const U*>(x + plane + src)), vi);
  } else {
#pragma unroll
    for (int c = 0; c < V; ++c) vr[c] = vi[c] = T(0);
  }
}

// The split row of pad_load's vector at p, once every load is in flight (so
// that no load waits on an earlier one): half of row h' in the first lane
// at p = h' and p = top + h', and zeros in the other lanes at p = h'.
template <class T>
__device__ __forceinline__ void pad_split(int p, int n, int nt, T* vr,
                                          T* vi) {
  const int hh = nt >> 1, top = n - nt;
  if (p == hh || p == top + hh) {
    vr[0] *= T(0.5);
    vi[0] *= T(0.5);
  }
  if (p == hh) {
#pragma unroll
    for (int c = 1; c < kVec16<T>; ++c) vr[c] = vi[c] = T(0);
  }
}

// Lines blk * (threads / G) .. of `lines` whole lines (post == 1) of N
// points, rows below h = N/2 from a and the rest from b, transformed into
// oa and ob with the scale; P points a thread.  Each vector of V adjacent
// points lies in one half (h is a multiple of V G), so each load and
// store picks its half at compile time.  Every load of a line comes
// before its first store, and no two groups share a line, so the
// outputs may be the inputs.  smem: the groups' buffers.  Map: the row
// map (AllRows, or PadRows / TruncRows with `map`'s nt, whose h' and
// N - nt the caller keeps multiples of V): PadRows reads the nt-row line
// from `a` alone (pad_load, then pad_split); TruncRows writes nt rows to
// `oa` alone, vector j of band rows j .. (j < h') or j + top .. (j >=
// h'), band row h' added to the first lane of vector h' (the fold).
// W: the work policy (AxisWork, the transform; or see above).
template <class T, int N, int P, class Map = AllRows, class W = AxisWork>
__device__ __forceinline__ void line_body(Half<const T> a, Half<const T> b,
                                          Half<T> oa, Half<T> ob,
                                          const T* __restrict__ twr,
                                          const T* __restrict__ twi,
                                          long long lines, T sign, T scale,
                                          T* smem, Map map = Map{},
                                          W work = W{}) {
  constexpr int G = N / P, V = kVec16<T>, h = N / 2;
  constexpr int kThreads = LineLaunch<T>::kThreads;
  static_assert(G <= 32 && 32 % G == 0, "a group lies inside one warp");
  static_assert((P / line_radix(N, P, 0)) % V == 0,
                "first-stage butterflies in whole vectors");
  static_assert(h % (V * G) == 0, "each vector lies in one half");
  using U = typename Vec16<T>::type;
  const int grp = threadIdx.x / G, g = threadIdx.x % G;
  T* br = smem + grp * 2 * row_buf(N);
  T* bi = br + row_buf(N);
  const long long line =
      static_cast<long long>(blockIdx.x) * (kThreads / G) + grp;
  const bool live = line < lines;
  const long long i = live ? line : 0;

  // every load first: points row_own(g, s), V adjacent ones a vector
  T zr[P], zi[P];
#pragma unroll
  for (int s = 0; s < P; s += V) {
    const int p = row_own<V, G>(g, s);
    if constexpr (Map::kMode == PadRows::kMode) {
      pad_load(a.ptr + i * a.pre, a.plane, p, N, map.nt, zr + s, zi + s);
    } else {
      const bool lo = V * G * (s / V) < h;
      const Half<const T>& x = lo ? a : b;
      const T* q = x.ptr + i * x.pre + (lo ? p : p - h);
      Vec16<T>::split(__ldg(reinterpret_cast<const U*>(q)), zr + s);
      Vec16<T>::split(__ldg(reinterpret_cast<const U*>(q + x.plane)),
                      zi + s);
    }
  }
  if constexpr (Map::kMode == PadRows::kMode) {
#pragma unroll
    for (int s = 0; s < P; s += V)
      pad_split(row_own<V, G>(g, s), N, map.nt, zr + s, zi + s);
  }
  if constexpr (W::kTransform) {
    line_stages<T, N, P, 0>(zr, zi, br, bi, g, twr, twi, sign);
  } else {
    static_assert(Map::kMode == AllRows::kMode, "a work policy's rows");
    work.template line<T, N, P>(zr, zi, br, bi, g, twr, twi, sign);
  }
  if (!live) return;

  // the line in natural order, V adjacent points a vector, scaled
#pragma unroll
  for (int q = 0; q < N / V / G; ++q) {
    const int p = V * (g + G * q);
    T vr[V], vi[V];
    if constexpr (Map::kMode == TruncRows::kMode) {
      const int hh = map.nt >> 1;
      if (p >= map.nt) continue;
      const int src = p < hh ? p : p + (N - map.nt);
      T* d = oa.ptr + i * oa.pre + p;
      Vec16<T>::split(*reinterpret_cast<const U*>(br + bpad(src)), vr);
      Vec16<T>::split(*reinterpret_cast<const U*>(bi + bpad(src)), vi);
#pragma unroll
      for (int c = 0; c < V; ++c) {
        vr[c] *= scale;
        vi[c] *= scale;
      }
      if (p == hh) {                      // the fold of band row h'
        vr[0] += br[bpad(hh)] * scale;
        vi[0] += bi[bpad(hh)] * scale;
      }
      *reinterpret_cast<U*>(d) = Vec16<T>::make(vr);
      *reinterpret_cast<U*>(d + oa.plane) = Vec16<T>::make(vi);
    } else {
      const bool lo = V * G * q < h;
      const Half<T>& y = lo ? oa : ob;
      T* d = y.ptr + i * y.pre + (lo ? p : p - h);
      if constexpr (W::kStoreHeld) {
        // the loaded vector at p: points row_own(g, V q) ..
#pragma unroll
        for (int c = 0; c < V; ++c) {
          vr[c] = zr[V * q + c];
          vi[c] = zi[V * q + c];
        }
      } else {
        Vec16<T>::split(*reinterpret_cast<const U*>(br + bpad(p)), vr);
        Vec16<T>::split(*reinterpret_cast<const U*>(bi + bpad(p)), vi);
      }
#pragma unroll
      for (int c = 0; c < V; ++c) {
        vr[c] *= scale;
        vi[c] *= scale;
      }
      *reinterpret_cast<U*>(d) = Vec16<T>::make(vr);
      *reinterpret_cast<U*>(d + y.plane) = Vec16<T>::make(vi);
    }
  }
}

// ---------------------------------------------------------------------------
// in-place decimation-in-frequency stages over rows or columns
// ---------------------------------------------------------------------------

// A row's points in shared memory: point p at pad(p), a gap after every
// 16, so that the strided points of a butterfly and the permuted points
// of the store fall on distinct banks; rows are row_stride(n2) apart (odd).
__host__ __device__ __forceinline__ int pad(int p) { return p + (p >> 4); }
__host__ __device__ __forceinline__ int row_stride(int n2) {
  return (n2 + ((n2 - 1) >> 4)) | 1;
}

// Where the decimation-in-frequency stages of a 2^lw-point line (radix 8
// while it divides, then 4 or 2) leave frequency f.
__device__ __forceinline__ int dif_pos(int f, int lw) {
  int p = 0;
  for (int ll = lw; ll > 0;) {
    const int a = ll < 3 ? ll : 3;
    ll -= a;
    p |= (f & ((1 << a) - 1)) << ll;
    f >>= a;
  }
  return p;
}

// The same for a kB 2^lw-point line, kB = 1 or 3: a radix-3 stage first
// leaves the frequencies f = 3 m + a in block a, at dif_pos(m) of it.
template <int kB>
__device__ __forceinline__ int dif_pos_b(int f, int lw) {
  if constexpr (kB == 3) return ((f % 3) << lw) + dif_pos(f / 3, lw);
  return dif_pos(f, lw);
}

// The block's lines: rows (kRows; line c = t R + n, point p at
// c rs + pad(p)) or columns (line c = t n2 + col, point n at
// (t R + n) rs + pad(col)), with T = 2^lt planes of R = 2^lr rows of
// n2 = 2^l2 points.
template <class T>
struct Block {
  T* re;
  T* im;
  int lt, lr, l2, rs;
};

template <bool kRows, class T>
__device__ __forceinline__ int at(const Block<T>& k, int c, int p) {
  if (kRows) return c * k.rs + pad(p);
  return (((c >> k.l2) << k.lr) + p) * k.rs + pad(c & ((1 << k.l2) - 1));
}

// The twiddles of the in-place stages read from a table of the powers of
// w_N: w_N^e = (r[e], i[e]), (cos, sin)(sign 2 pi e / N).
template <class T>
struct Powers {
  const T* __restrict__ r;
  const T* __restrict__ i;
  __device__ __forceinline__ void operator()(int e, T* wr, T* wi) const {
    *wr = __ldg(r + e);
    *wi = __ldg(i + e);
  }
};

// One in-place decimation-in-frequency stage of radix R = 2^lrr over
// sub-blocks of L = 2^ll points of every line of kB 2^lw points (kB = 1,
// or 3 after dif_stage3): butterfly (line c, block, i < L/R) takes the
// points block L + j L/R + i, and writes their DFT over j, output a times
// w_L^(a i), back to the same points.  No other butterfly touches them,
// so a thread takes its butterflies one at a time, and the block
// synchronises once a stage.  tw: the twiddle w_N^e, e < N = kB 2^(lw +
// ls), of sign `sign` (Powers: the table (cos, sin)(sign 2 pi e / N)).
// kArith: as line_stage's.
template <int R, int lrr, bool kRows, int kB = 1, int kArith = kStageFull,
          class T, class Tw>
__device__ __forceinline__ void dif_stage(const Block<T>& k, int lc, int lw,
                                          int ll, int ls, const Tw& tw,
                                          T sign) {
  const int lq = ll - lrr;
  const int nb = kB << (lc + lw - lrr);
#pragma unroll 1
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    const int c = b & ((1 << lc) - 1);
    const int q = b >> lc;
    const int i = q & ((1 << lq) - 1);
    const int p0 = ((q >> lq) << ll) + i;
    T vr[R], vi[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int s = at<kRows>(k, c, p0 + (j << lq));
      vr[j] = k.re[s];
      vi[j] = k.im[s];
    }
    if constexpr (kArith == kStageMoves) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        keep(vr[j]);
        keep(vi[j]);
      }
    } else {
      Dft<R, T>::run(vr, vi, sign);
    }
    if (kArith == kStageFull && lq > 0) {
#pragma unroll
      for (int a = 1; a < R; ++a) {
        T wr, wi;
        tw(kB * ((a * i) << (lw - ll + ls)), &wr, &wi);
        const T yr = vr[a], yi = vi[a];
        vr[a] = yr * wr - yi * wi;
        vi[a] = yr * wi + yi * wr;
      }
    }
#pragma unroll
    for (int a = 0; a < R; ++a) {
      const int s = at<kRows>(k, c, p0 + (a << lq));
      k.re[s] = vr[a];
      k.im[s] = vi[a];
    }
  }
  __syncthreads();
}

// Every stage of the 2^lw-point transforms of the block's 2^lc lines
// (of each of their kB blocks of 2^lw points); tw: the powers of w_N,
// N = kB 2^(lw + ls), whose every kB 2^ls-th power is one of w_(2^lw)
// (Powers: a table of them).
template <bool kRows, int kB = 1, class T, class Tw>
__device__ __forceinline__ void dif_pass(const Block<T>& k, int lc, int lw,
                                         int ls, const Tw& tw, T sign) {
  for (int ll = lw; ll > 0;) {
    const int a = ll < 3 ? ll : 3;
    if (a == 1)
      dif_stage<2, 1, kRows, kB>(k, lc, lw, ll, ls, tw, sign);
    else if (a == 2)
      dif_stage<4, 2, kRows, kB>(k, lc, lw, ll, ls, tw, sign);
    else
      dif_stage<8, 3, kRows, kB>(k, lc, lw, ll, ls, tw, sign);
    ll -= a;
  }
}

// The radix-3 decimation-in-frequency stage that starts the transforms of
// the block's 2^lc columns of 3 L points (L = 2^lw), in place: butterfly
// (column c, i < L) takes points i + j L, j < 3, and writes their DFT over
// j, output a times w_(3L)^(a i), back to the same points; block a then
// holds the L-point sequence of the frequencies 3 m + a.  tw: the powers
// of w_N, N = 3 L 2^ls (Powers: a table of them).
template <class T, class Tw>
__device__ __forceinline__ void dif_stage3(const Block<T>& k, int lc, int lw,
                                           int ls, const Tw& tw, T sign) {
  const int L = 1 << lw;
#pragma unroll 1
  for (int b = threadIdx.x; b < (L << lc); b += blockDim.x) {
    const int c = b & ((1 << lc) - 1);
    const int i = b >> lc;
    T vr[3], vi[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int s = at<false>(k, c, i + j * L);
      vr[j] = k.re[s];
      vi[j] = k.im[s];
    }
    Dft<3, T>::run(vr, vi, sign);
#pragma unroll
    for (int a = 1; a < 3; ++a) {
      T wr, wi;
      tw((a * i) << ls, &wr, &wi);
      const T yr = vr[a], yi = vi[a];
      vr[a] = yr * wr - yi * wi;
      vi[a] = yr * wi + yi * wr;
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int s = at<false>(k, c, i + a * L);
      k.re[s] = vr[a];
      k.im[s] = vi[a];
    }
  }
  __syncthreads();
}

// The radix-K decimation-in-frequency step across a cluster of K CTAs,
// each holding R rows of 2^lc points (elems points, R = elems >> lc;
// CTA j rows j R ..) of n1 = K R-point columns: point (n, col) of every
// CTA's block by one thread of the cluster (kThreads a CTA), which reads
// x_j from every CTA j, forms y_k = sum_j x_j W_K^(jk) W_n1^(n k) and
// writes y_k to CTA k's point (n, col), a place no other thread of the
// cluster touches; CTA k then holds the rows k + K m of the
// decimation.  twr, twi: the powers of w_n1.  Between two cluster
// barriers (the caller's).  kArith: as line_stage's.
template <int K, int kThreads, int kArith = kStageFull, class T>
__device__ __forceinline__ void cluster_dif_step(const Block<T>& k, int lc,
                                                 int elems, unsigned kk,
                                                 const T* __restrict__ twr,
                                                 const T* __restrict__ twi,
                                                 T sign) {
#pragma unroll 1
  for (int p = static_cast<int>(kk) * kThreads + threadIdx.x; p < elems;
       p += K * kThreads) {
    const int n = p >> lc;
    const int s = n * k.rs + pad(p & ((1 << lc) - 1));
    T vr[K], vi[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      vr[j] = *peer_smem(k.re + s, static_cast<unsigned>(j));
      vi[j] = *peer_smem(k.im + s, static_cast<unsigned>(j));
    }
    if constexpr (kArith == kStageMoves) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        keep(vr[j]);
        keep(vi[j]);
      }
    } else {
      Dft<K, T>::run(vr, vi, sign);
    }
#pragma unroll
    for (int j = 1; j < K && kArith == kStageFull; ++j) {
      // output j times w_n1^(n j)
      const int e = n * j;
      const T wr = __ldg(twr + e), wi = __ldg(twi + e);
      const T yr = vr[j], yi = vi[j];
      vr[j] = yr * wr - yi * wi;
      vi[j] = yr * wi + yi * wr;
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      *peer_smem(k.re + s, static_cast<unsigned>(j)) = vr[j];
      *peer_smem(k.im + s, static_cast<unsigned>(j)) = vi[j];
    }
  }
}

// ---------------------------------------------------------------------------
// the band body (post > 1)
// ---------------------------------------------------------------------------

// Points of each component a band CTA holds, its threads, its launch
// bound and the chunks a thread loads at once.  float: 512 threads, two
// CTAs an SM (64 registers), all four chunks at once; double: 4096
// points (64 KB and padding), 256 threads, three CTAs an SM (80
// registers, with spill stores; bound to two, 104-118 registers and no
// spill, the band ran 15-34% slower on an H100), two chunks at once (four
// ran 5-6% slower at N = 1024, where at float four are 3-4% faster).
// A kernel may run the band body on a budget of its own (axis_band's B).
template <class T>
struct BandBudget;
template <>
struct BandBudget<float> {
  static constexpr int kElems = 8192;
  static constexpr int kThreads = 512;
  static constexpr int kMinBlocks = 2;
  static constexpr int kRound = 4;
};
template <>
struct BandBudget<double> {
  static constexpr int kElems = 4096;
  static constexpr int kThreads = 256;
  static constexpr int kMinBlocks = 3;
  static constexpr int kRound = 2;
};

// The band CTA's budget of A and E (fft_axis.cu, fft_axis_tp.cu):
// float64 BandBudget's; float32 the same 8192 points on 256 threads,
// three CTAs an SM (80 registers, no spill), all four chunks of a round
// at once.  At D's 512 threads, two CTAs an SM, A took 12.1-12.5 ms on
// the 1024^3 mid and lead passes of an H100, 10.0-10.2 on 256 (PERF.md
// §6); its loads and stores alone took 6.3-6.8.
template <class T>
struct AxisBandBudget : BandBudget<T> {};
template <>
struct AxisBandBudget<float> {
  static constexpr int kElems = BandBudget<float>::kElems;
  static constexpr int kThreads = 256;
  static constexpr int kMinBlocks = 3;
  static constexpr int kRound = 4;
};

// A's routes at N = 512, 768, 1024 (fft_axis.cu; the probe bfly takes
// them too).  Points a thread of the line kernel holds, so that a line
// lies in one warp: float64 16 at N = 512, 24 at 768 and 32 at 1024;
// float32 32, 24 at 768 (D's lines).
template <class T>
__host__ __device__ constexpr int axis_line_points(int n) {
  return n == 768 ? 24 : n == 1024 || sizeof(T) == 4 ? 32 : 16;
}

// CTAs a band of A's band kernel (a cluster): float64 4 at N = 1024 and
// 768 (16 columns, 128-byte row segments), 2 at 512 (16 columns);
// float32 4 (D's band: 32 columns at 1024 and 768, 64 at 512).
template <class T>
__host__ __device__ constexpr int band_cluster(int n) {
  return sizeof(T) == 4 || n > 512 ? 4 : 2;
}

// log2 of a cluster of K = 1, 2, 4 or 8 CTAs.
template <int K>
constexpr int log2_cluster = K == 8 ? 3 : K == 4 ? 2 : K == 2 ? 1 : 0;

// Dynamic shared memory of a band CTA: `rows` rows of 2^lc points.
template <class T>
inline std::size_t band_smem(int rows, int lc) {
  return 2 * sizeof(T) * static_cast<std::size_t>(rows) *
         row_stride(1 << lc);
}

// The band's columns for R rows a CTA: lc, the most 2^lc with R 2^lc <=
// BandBudget<T>::kElems.
template <class T>
inline int band_log2_cols(int rows) {
  int lc = 0;
  while ((rows << (lc + 1)) <= BandBudget<T>::kElems) ++lc;
  return lc;
}

// The N-point transforms (N = K R, R = kB 2^lr, kB = 1 or 3; n = N) of
// the band blockIdx.x / K of an axis seen as (2, pre, n, post) lines, rows below
// h = n/2 from a and the rest from b, written to oa and ob with the
// scale: the C = 2^lc adjacent lines (pre * post of them, flattened) of
// that band, each CTA (rank kk of its cluster) holding rows kk R .. of
// them.  kVec: 16-byte vectors of V adjacent columns (post a multiple of
// V and every base 16-byte aligned, so no vector straddles two pre
// rows), else single elements.  A thread keeps one column (kThreads V is
// a multiple of C) and loads its chunks in rounds of B::kRound.  With K > 1
// the first radix-K step runs across the cluster, and CTA kk then holds
// output rows kk + K m; with K = 1 the CTA holds all n rows.  Every
// global read of a cluster comes before its first barrier and every write
// after its last, and a cluster owns its lines whole, so the outputs may
// be the inputs.  The R-point columns run as in-place radix-8 stages
// (after one radix-3 stage when kB = 3).  twr, twi: the powers of w_n.
// B: the CTA's budget (BandBudget<T>'s points, its own threads and
// chunks).  smem: band_smem(R, lc).  Map: the row map (AllRows, or
// PadRows / TruncRows with `map`'s nt, see above).  W: the work policy
// (AxisWork, the transform; or see above).
template <class T, int K, bool kVec, int kB, class B = BandBudget<T>,
          class Map = AllRows, class W = AxisWork>
__device__ __forceinline__ void axis_band(Half<const T> a, Half<const T> b,
                                          Half<T> oa, Half<T> ob,
                                          const T* __restrict__ twr,
                                          const T* __restrict__ twi,
                                          long long pre, long long post,
                                          int lr, int lc, T sign, T scale,
                                          T* smem, Map map = Map{},
                                          W work = W{}) {
  static_assert(B::kElems == BandBudget<T>::kElems,
                "band_log2_cols and band_smem size the CTA");
  constexpr int V = kVec ? kVec16<T> : 1;
  constexpr int lk = log2_cluster<K>;
  using U = typename Vec16<T>::type;
  const int C = 1 << lc, R = kB << lr;
  const int h = (R * K) >> 1;
  const int elems = R << lc;
  Block<T> k{smem, nullptr, 0, lr, lc, row_stride(C)};
  k.im = k.re + R * k.rs;
  const unsigned kk = K > 1 ? cluster_rank() : 0u;
  const int row0 = static_cast<int>(kk) * R;
  // this thread's line (pre index li, column col) and its bases in the
  // two input halves
  const int c = (V * static_cast<int>(threadIdx.x)) & (C - 1);
  const long long l = ((static_cast<long long>(blockIdx.x) / K) << lc) + c;
  const bool live = l < pre * post;
  const long long li = live ? l / post : 0;
  const long long col = live ? l - li * post : 0;
  const T* ia = a.ptr + li * a.pre + col;
  const T* ib = b.ptr + li * b.pre + col;

  constexpr int kChunks = B::kElems / V / B::kThreads;
  constexpr int kRound = kChunks < B::kRound ? kChunks : B::kRound;
#pragma unroll
  for (int j0 = 0; j0 < kChunks; j0 += kRound) {
    T vr[kRound][V], vi[kRound][V];
#pragma unroll
    for (int j = 0; j < kRound; ++j) {
      const int e = V * (static_cast<int>(threadIdx.x) +
                         (j0 + j) * B::kThreads);
      const int r = row0 + (e >> lc);
#pragma unroll
      for (int cc = 0; cc < V; ++cc) vr[j][cc] = vi[j][cc] = T(0);
      if constexpr (Map::kMode == PadRows::kMode) {
        // the input row of band row r, or a zero row (no load)
        T f;
        const int src = pad_source(r, R * K, map.nt, &f);
        if (live && e < elems && src >= 0) {
          const T* q = ia + static_cast<long long>(src) * post;
          if constexpr (kVec) {
            Vec16<T>::split(__ldcg(reinterpret_cast<const U*>(q)), vr[j]);
            Vec16<T>::split(__ldcg(reinterpret_cast<const U*>(q + a.plane)),
                            vi[j]);
          } else {
            vr[j][0] = __ldcg(q);
            vi[j][0] = __ldcg(q + a.plane);
          }
#pragma unroll
          for (int cc = 0; cc < V; ++cc) {
            vr[j][cc] *= f;
            vi[j][cc] *= f;
          }
        }
      } else if (live && e < elems) {
        // a CTA of a cluster holds rows of one half
        const bool lo = (K > 1 ? row0 : r) < h;
        const T* q = (lo ? ia : ib) +
                     static_cast<long long>(lo ? r : r - h) * post;
        const long long pl = lo ? a.plane : b.plane;
        if constexpr (kVec) {
          Vec16<T>::split(__ldcg(reinterpret_cast<const U*>(q)), vr[j]);
          Vec16<T>::split(__ldcg(reinterpret_cast<const U*>(q + pl)), vi[j]);
        } else {
          vr[j][0] = __ldcg(q);
          vi[j][0] = __ldcg(q + pl);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kRound; ++j) {
      const int e = V * (static_cast<int>(threadIdx.x) +
                         (j0 + j) * B::kThreads);
      if (e >= elems) continue;
#pragma unroll
      for (int cc = 0; cc < V; ++cc) {
        const int s = at<true>(k, (e + cc) >> lc, (e + cc) & (C - 1));
        k.re[s] = vr[j][cc];
        k.im[s] = vi[j][cc];
      }
    }
  }

  if constexpr (!W::kTransform) {
    static_assert(Map::kMode == AllRows::kMode, "a work policy's rows");
    work.template band<K, kB, B::kThreads>(k, lc, lr, elems, kk, twr, twi,
                                           sign);
    if (!live) return;
    T* ya = oa.ptr + li * oa.pre + col;
    T* yb = ob.ptr + li * ob.pre + col;
    for (int e = V * static_cast<int>(threadIdx.x); e < elems;
         e += V * B::kThreads) {
      int src, r;
      W::template band_row<K, kB>(e >> lc, lr, kk, &src, &r);
      const int s = src * k.rs + pad(e & (C - 1));
      const bool lo = r < h;
      T* q = (lo ? ya : yb) + static_cast<long long>(lo ? r : r - h) * post;
      const long long pl = lo ? oa.plane : ob.plane;
      T vr[V], vi[V];
#pragma unroll
      for (int cc = 0; cc < V; ++cc) {
        vr[cc] = k.re[s + cc] * scale;
        vi[cc] = k.im[s + cc] * scale;
      }
      if constexpr (kVec) {
        *reinterpret_cast<U*>(q) = Vec16<T>::make(vr);
        *reinterpret_cast<U*>(q + pl) = Vec16<T>::make(vi);
      } else {
        q[0] = vr[0];
        q[pl] = vi[0];
      }
    }
    return;
  }

  if constexpr (K > 1) {
    cluster_sync();
    cluster_dif_step<K, B::kThreads>(k, lc, elems, kk, twr, twi, sign);
    cluster_sync();
  } else {
    __syncthreads();
  }

  // each column a line of R points
  const Powers<T> w{twr, twi};
  if constexpr (kB == 3) dif_stage3(k, lc, lr, lk, w, sign);
  dif_pass<false, kB>(k, lc, lr, lk, w, sign);

  // output row kk + K m from where the stages left it, scaled
  if (!live) return;
  T* ya = oa.ptr + li * oa.pre + col;
  T* yb = ob.ptr + li * ob.pre + col;
  for (int e = V * static_cast<int>(threadIdx.x); e < elems;
       e += V * B::kThreads) {
    const int s = dif_pos_b<kB>(e >> lc, lr) * k.rs + pad(e & (C - 1));
    const int r = static_cast<int>(kk) + K * (e >> lc);
    T* q;
    long long pl;
    bool fold = false;     // TruncRows: band row r + top is added, at
    int m2 = 0;            // index m2 of this CTA's rows
    if constexpr (Map::kMode == TruncRows::kMode) {
      const int j = trunc_target(r, R * K, map.nt, &fold);
      if (j < 0) continue;
      q = ya + static_cast<long long>(j) * post;
      pl = oa.plane;
      m2 = (e >> lc) + (R * K - map.nt) / K;
    } else {
      const bool lo = r < h;
      q = (lo ? ya : yb) + static_cast<long long>(lo ? r : r - h) * post;
      pl = lo ? oa.plane : ob.plane;
    }
    T vr[V], vi[V];
#pragma unroll
    for (int cc = 0; cc < V; ++cc) {
      vr[cc] = k.re[s + cc] * scale;
      vi[cc] = k.im[s + cc] * scale;
    }
    if (fold) {
      const int s2 = dif_pos_b<kB>(m2, lr) * k.rs + pad(e & (C - 1));
#pragma unroll
      for (int cc = 0; cc < V; ++cc) {
        vr[cc] += k.re[s2 + cc] * scale;
        vi[cc] += k.im[s2 + cc] * scale;
      }
    }
    if constexpr (kVec) {
      *reinterpret_cast<U*>(q) = Vec16<T>::make(vr);
      *reinterpret_cast<U*>(q + pl) = Vec16<T>::make(vi);
    } else {
      q[0] = vr[0];
      q[pl] = vi[0];
    }
  }
}

}  // namespace mff
