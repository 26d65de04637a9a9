// Butterfly probe: A's kernel bodies (fft_axis.cu) with the work between
// one load and one store chosen by a mode, float32.
//
// Replaces the TPU kernels that split the lead-axis butterfly into its
// parts: scripts/tpu_bfly_dissect.py:77 (`mk_kernel`: body_copy,
// body_concat, body_adds) and :152 (`with_tw`: body_full, the radix plan
// of pallas_butterfly._butterfly), tpu_vpu_probe.py:57 (the butterfly
// applied `reps` times a block), tpu_lead_copy.py:119, :137 and :199 (the
// butterfly on lead blocks, on the 5-D view and on Q-wide blocks) and
// tpu_r3_profile.py:121 (the mid-axis butterfly on whole slabs).  Modes:
//   copy   every load and store (and barrier) of the body, no stage work;
//   moves  the radix-4 stage loop with every output slot taking its input
//          unchanged (body_concat: a fixed permutation);
//   adds   the radix-4 stages with every twiddle at 1 (body_adds);
//   full   A's transform, as fft_axis_p.
// `reps` runs the mode's stage work that many times.  moves and adds take
// N = 4^k, as the JAX bodies assume.
//
// Bound on an H100: bytes for every mode (one read and one write of the
// volume); the modes split A's time into its load/store, its data
// movement, its adds and its twiddles.  So the probe runs A's own
// kernels: at N = 512, 768 and 1024 with no tile width given, A's routes
// (launch_lines_bands in fft_axis.cu): the line body (lines.cuh
// line_body) on whole lines with x and y 16-byte aligned, the band body
// (axis_band) on clusters of band_cluster(N) CTAs with A's
// AxisBandBudget where post > 1, each with the mode as its work policy
// (ProbeWork below, lines.cuh's hook).  On lines, moves and adds run the radix-4
// network as Stockham stages through the group's buffer; on the band the
// cluster's radix-4 step, then in-place radix-4 stages down the columns,
// the store putting each slot where the slice-and-concat network leaves
// it.  reps > 1 runs an instance of its own (kMany), in which the band
// goes back to its loaded layout across the cluster between passes (its
// 32 values a thread in registers spill), so that the one-pass instance
// allocates registers as A does.  Every other length, and every call
// with a tile width `lc`, runs A's tile: its layout, thread count and
// launch bounds (butterfly.cuh), `lc` giving fewer lines a tile than A
// takes.
#include <cstdint>

#include "lines.cuh"

namespace {

enum Mode { kCopy = 0, kMoves = 1, kAdds = 2, kFull = 3 };

// Offset of element 0 of each tile line; -1 past the last line (as in
// fft_axis.cu).
__device__ __forceinline__ void line_bases(long long* base, long long l0,
                                           long long nlines, int C, int n,
                                           long long post) {
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const long long l = l0 + c;
    base[c] = l < nlines ? (l / post) * n * post + l % post : -1;
  }
}

// One radix-4 Stockham stage of mff::stage's data flow at remaining length
// L, without twiddles; with kDft false, without the 4-point DFT too.
template <bool kDft, class T>
__device__ __forceinline__ void stage4(const mff::Tile<T>& t, int W, int L,
                                       int lm, T sign) {
  constexpr int R = 4, K = 4;
  const int Lq = L / R;
  const int C = 1 << t.lc;
  const int M = 1 << lm;
  const int nb = (W / R) << t.lc;
  T vr[K][R], vi[K][R];
  int dst[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int b = threadIdx.x + k * blockDim.x;
    dst[k] = -1;
    if (b < nb) {
      const int c = b & (C - 1);
      const int q = b >> t.lc;
      const int lp = q >> lm;
      const int m = q & (M - 1);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int s = (((j * Lq + lp) << lm) + m) * t.cp + c;
        vr[k][j] = t.re[s];
        vi[k][j] = t.im[s];
      }
      if (kDft) mff::Dft<R, T>::run(vr[k], vi[k], sign);
      dst[k] = ((lp * R << lm) + m) * t.cp + c;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (dst[k] >= 0) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int s = dst[k] + (j << lm) * t.cp;
        t.re[s] = vr[k][j];
        t.im[s] = vi[k][j];
      }
    }
  }
  __syncthreads();
}

template <bool kDft, class T>
__device__ __forceinline__ void radix4_loop(const mff::Tile<T>& t, int W,
                                            T sign) {
  for (int L = W, lm = 0; L > 1; L /= 4, lm += 2)
    stage4<kDft>(t, W, L, lm, sign);
}

// One instance a mode, so that each compiles as A does: the full mode's
// registers and spills are A's, not those of all four modes inlined.
template <class T, int kBlocks, int kMode>
__global__ void __launch_bounds__(mff::Budget<T>::kTile / 16, kBlocks)
bfly_kernel(const T* __restrict__ x, T* __restrict__ y,
            const T* __restrict__ tw, long long tw_len,
            long long pre, int n, long long post, T sign, mff::Plan plan,
            int lc, int reps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = 1 << lc;
  long long* base = reinterpret_cast<long long*>(smem);
  mff::Tile<T> t;
  t.lc = lc;
  t.cp = C + 1;
  t.re = reinterpret_cast<T*>(base + C);
  t.im = t.re + n * t.cp;
  const long long nlines = pre * post;
  const long long plane = nlines * n;
  line_bases(base, static_cast<long long>(blockIdx.x) << lc, nlines, C, n,
             post);
  __syncthreads();

  const int total = n << lc;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    int c, k;
    if (post == 1) {        // whole lines: neighbours along the line
      c = idx / n;
      k = idx - c * n;
    } else {                // neighbours across lines (post columns)
      c = idx & (C - 1);
      k = idx >> lc;
    }
    const long long b = base[c];
    T vr = 0, vi = 0;
    if (b >= 0) {
      const long long a = b + k * post;
      vr = x[a];
      vi = x[plane + a];
    }
    t.re[k * t.cp + c] = vr;
    t.im[k * t.cp + c] = vi;
  }
  __syncthreads();

  for (int r = 0; r < reps; ++r) {
    if (kMode == kMoves) radix4_loop<false>(t, n, sign);
    if (kMode == kAdds) radix4_loop<true>(t, n, sign);
    if (kMode == kFull) mff::run_plan(t, n, plan, tw, tw + tw_len, sign);
  }

  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    int c, k;
    if (post == 1) {
      c = idx / n;
      k = idx - c * n;
    } else {
      c = idx & (C - 1);
      k = idx >> lc;
    }
    const long long b = base[c];
    if (b >= 0) {
      const long long a = b + k * post;
      y[a] = t.re[k * t.cp + c];
      y[plane + a] = t.im[k * t.cp + c];
    }
  }
}

bool pow4(int n) {
  while (n > 1 && n % 4 == 0) n /= 4;
  return n == 1;
}

// ---------------------------------------------------------------------------
// N = 512, 768, 1024: A's line and band bodies under the mode
// ---------------------------------------------------------------------------

using mff::AllRows;
using mff::AxisBandBudget;
using mff::Block;
using mff::Half;
using mff::cluster_sync;
using mff::pad;
using mff::peer_smem;

// The stage arithmetic of a mode's radix-4 network (lines.cuh kArith).
template <int kW>
constexpr int kArithOf = kW == kMoves ? mff::kStageMoves
                         : kW == kAdds ? mff::kStageAdds : mff::kStageFull;

// The base-4 digits of p (nd of them) in reverse order.
__host__ __device__ __forceinline__ int digit_rev4(int p, int nd) {
  int q = 0;
  for (int i = 0; i < nd; ++i) {
    q = (q << 2) | (p & 3);
    p >>= 2;
  }
  return q;
}

// Stages S.. of the radix-4 network on an N-point line (N = 4^k; stage S
// of span 4^S), as Stockham stages of lines.cuh line_stage.
template <class T, int N, int P, int S, int kArith>
__device__ __forceinline__ void line_network(const T* zr, const T* zi,
                                             T* br, T* bi, int g,
                                             const T* __restrict__ twr,
                                             const T* __restrict__ twi,
                                             T sign) {
  if constexpr ((1 << (2 * S)) < N) {
    mff::line_stage<T, N, P, 4, 1 << (2 * S), S == 0, kArith>(
        zr, zi, br, bi, g, twr, twi, sign);
    line_network<T, N, P, S + 1, kArith>(zr, zi, br, bi, g, twr, twi,
                                         sign);
  }
}

// Mode kW's work on the line: full the transform's stages, moves and
// adds the radix-4 network; none for copy.
template <int kW, class T, int N, int P>
__device__ __forceinline__ void line_pass(const T* zr, const T* zi, T* br,
                                          T* bi, int g,
                                          const T* __restrict__ twr,
                                          const T* __restrict__ twi,
                                          T sign) {
  if constexpr (kW == kFull)
    mff::line_stages<T, N, P, 0>(zr, zi, br, bi, g, twr, twi, sign);
  else if constexpr (kW != kCopy)
    line_network<T, N, P, 0, kArithOf<kW>>(zr, zi, br, bi, g, twr, twi,
                                            sign);
}

// For this CTA's m-th row of the band after mode kW's work (m < R), the
// row of its shared memory that holds it (*src) and the row of the axis
// it goes to (*r).  full: as the transform's store, row kk + K m from
// dif_pos_b(m); copy: row kk R + m from row m; moves and adds: in-place
// slot p = kk R + m (the cluster step's output digit kk first) from row
// m to row digit_rev4(p), where the slice-and-concat network leaves it.
template <int kW, int K, int kB>
__device__ __forceinline__ void band_rows(int m, int lr, unsigned kk,
                                          int* src, int* r) {
  constexpr int lk = mff::log2_cluster<K>;
  const int R = kB << lr;
  const int p = static_cast<int>(kk) * R + m;
  if constexpr (kW == kFull) {
    *src = mff::dif_pos_b<kB>(m, lr);
    *r = static_cast<int>(kk) + K * m;
  } else if constexpr (kW == kCopy) {
    *src = m;
    *r = p;
  } else {
    *src = m;
    *r = digit_rev4(p, (lr + lk) / 2);
  }
}

// Between two passes: every CTA's R rows back in their loaded layout,
// row kk R + n of the work's output in row n of CTA kk, each CTA sending
// the rows it holds where band_rows says they go, one component at a
// time (kHold values a thread in registers).  Between the work's last
// barrier and the next pass's first.
template <int kW, int K, int kB, int kThreads, int kHold, class T>
__device__ __forceinline__ void band_regroup(const Block<T>& k, int lc,
                                             int lr, int elems,
                                             unsigned kk) {
  const int C = 1 << lc, R = kB << lr;
  T hold[kHold];
  for (int comp = 0; comp < 2; ++comp) {
    T* base = comp == 0 ? k.re : k.im;
    if constexpr (K > 1) cluster_sync(); else __syncthreads();
#pragma unroll
    for (int j = 0; j < kHold; ++j) {
      const int e = static_cast<int>(threadIdx.x) + j * kThreads;
      int src, r;
      band_rows<kW, K, kB>(e >> lc, lr, kk, &src, &r);
      if (e < elems) hold[j] = base[src * k.rs + pad(e & (C - 1))];
    }
    if constexpr (K > 1) cluster_sync(); else __syncthreads();
#pragma unroll
    for (int j = 0; j < kHold; ++j) {
      const int e = static_cast<int>(threadIdx.x) + j * kThreads;
      if (e >= elems) continue;
      int src, r;
      band_rows<kW, K, kB>(e >> lc, lr, kk, &src, &r);
      T* q = base + (r % R) * k.rs + pad(e & (C - 1));
      if constexpr (K > 1)
        *peer_smem(q, static_cast<unsigned>(r / R)) = hold[j];
      else
        *q = hold[j];
    }
  }
}

// One pass of mode kW's work on the loaded band: copy the cluster
// barriers alone; full the transform's cluster step and column stages;
// moves and adds the radix-K cluster step, then in-place radix-4 stages
// down the columns (R = 4^a), untwiddled.
template <int kW, int K, int kB, int kThreads, class T>
__device__ __forceinline__ void band_pass(const Block<T>& k, int lc, int lr,
                                          int elems, unsigned kk,
                                          const T* __restrict__ twr,
                                          const T* __restrict__ twi,
                                          T sign) {
  constexpr int lk = mff::log2_cluster<K>;
  constexpr int kArith = kArithOf<kW>;
  if constexpr (K > 1) {
    cluster_sync();
    if constexpr (kW != kCopy)
      mff::cluster_dif_step<K, kThreads, kArith>(k, lc, elems, kk, twr, twi,
                                                 sign);
    cluster_sync();
  } else {
    __syncthreads();
  }
  const mff::Powers<T> w{twr, twi};
  if constexpr (kW == kFull) {
    if constexpr (kB == 3) mff::dif_stage3(k, lc, lr, lk, w, sign);
    mff::dif_pass<false, kB>(k, lc, lr, lk, w, sign);
  } else if constexpr (kW != kCopy) {
    static_assert(kB == 1, "the radix-4 network takes N = 4^k");
    for (int ll = lr; ll > 0; ll -= 2)
      mff::dif_stage<4, 2, false, 1, kArith>(k, lc, lr, ll, lk, w, sign);
  }
}

// The probe's work policy (lines.cuh work policies): mode kW's stage
// work between the load and the store of A's line and band bodies, once,
// or with kMany `reps` times on the held line or band, which goes back
// to its loaded layout in between (on the band a regroup across the
// cluster).  Without kMany the body holds no code for more passes, so
// that it allocates registers as A's does.  copy stores the loaded
// values (lines) or the loaded rows (band).
template <int kW, bool kMany>
struct ProbeWork {
  static constexpr bool kTransform = false;
  static constexpr bool kStoreHeld = kW == kCopy;
  int reps;

  template <class T, int N, int P>
  __device__ __forceinline__ void line(T* zr, T* zi, T* br, T* bi, int g,
                                       const T* __restrict__ twr,
                                       const T* __restrict__ twi,
                                       T sign) const {
    constexpr int G = N / P, V = mff::kVec16<T>;
    using U = typename mff::Vec16<T>::type;
    line_pass<kW, T, N, P>(zr, zi, br, bi, g, twr, twi, sign);
    if constexpr (kMany && kW != kCopy) {
      for (int rep = 1; rep < reps; ++rep) {
        // the line, in natural order, back in registers from the buffer
#pragma unroll
        for (int s = 0; s < P; s += V) {
          const int p = mff::bpad(mff::row_own<V, G>(g, s));
          mff::Vec16<T>::split(*reinterpret_cast<const U*>(br + p), zr + s);
          mff::Vec16<T>::split(*reinterpret_cast<const U*>(bi + p), zi + s);
        }
        __syncwarp();     // before the first stage writes the buffer
        line_pass<kW, T, N, P>(zr, zi, br, bi, g, twr, twi, sign);
      }
    }
  }

  template <int K, int kB, int kThreads, class T>
  __device__ __forceinline__ void band(const Block<T>& k, int lc, int lr,
                                       int elems, unsigned kk,
                                       const T* __restrict__ twr,
                                       const T* __restrict__ twi,
                                       T sign) const {
    band_pass<kW, K, kB, kThreads>(k, lc, lr, elems, kk, twr, twi, sign);
    if constexpr (kMany && kW != kCopy) {
      constexpr int kHold = mff::BandBudget<T>::kElems / kThreads;
      for (int rep = 1; rep < reps; ++rep) {
        band_regroup<kW, K, kB, kThreads, kHold>(k, lc, lr, elems, kk);
        band_pass<kW, K, kB, kThreads>(k, lc, lr, elems, kk, twr, twi,
                                       sign);
      }
    }
  }

  template <int K, int kB>
  static __device__ __forceinline__ void band_row(int m, int lr,
                                                  unsigned kk, int* src,
                                                  int* r) {
    band_rows<kW, K, kB>(m, lr, kk, src, r);
  }
};

template <int N, int kMode, bool kMany>
__global__ void __launch_bounds__(mff::LineLaunch<float>::kThreads,
                                  mff::LineLaunch<float>::kMinBlocks)
bfly_lines_kernel(Half<const float> a, Half<const float> b, Half<float> oa,
                  Half<float> ob, const float* __restrict__ twr,
                  const float* __restrict__ twi, long long lines,
                  float sign, int reps) {
  extern __shared__ __align__(16) unsigned char smem[];
  using W = ProbeWork<kMode, kMany>;
  mff::line_body<float, N, mff::axis_line_points<float>(N), AllRows, W>(
      a, b, oa, ob, twr, twi, lines, sign, 1.0f,
      reinterpret_cast<float*>(smem), AllRows{}, W{reps});
}

template <bool kVec, int kB, int kMode, bool kMany>
__global__ void __launch_bounds__(AxisBandBudget<float>::kThreads,
                                  AxisBandBudget<float>::kMinBlocks)
bfly_band_kernel(Half<const float> a, Half<const float> b, Half<float> oa,
                 Half<float> ob, const float* __restrict__ twr,
                 const float* __restrict__ twi, long long pre,
                 long long post, int lr, int lc, float sign, int reps) {
  extern __shared__ __align__(16) unsigned char smem[];
  using W = ProbeWork<kMode, kMany>;
  mff::axis_band<float, mff::band_cluster<float>(1024), kVec, kB,
                 AxisBandBudget<float>, AllRows, W>(
      a, b, oa, ob, twr, twi, pre, post, lr, lc, sign, 1.0f,
      reinterpret_cast<float*>(smem), AllRows{}, W{reps});
}

template <int N, int kMode, bool kMany>
int launch_lines(Half<const float> a, Half<const float> b, Half<float> oa,
                 Half<float> ob, const float* twr, const float* twi,
                 long long lines, float sign, int reps,
                 cudaStream_t stream) {
  constexpr int G = N / mff::axis_line_points<float>(N);
  constexpr int threads = mff::LineLaunch<float>::kThreads;
  const long long blocks = (lines + threads / G - 1) / (threads / G);
  return mff::launch_ex(&bfly_lines_kernel<N, kMode, kMany>, blocks,
                        threads,
                        sizeof(float) * 2 * mff::row_buf(N) * (threads / G),
                        1, stream, a, b, oa, ob, twr, twi, lines, sign,
                        reps);
}

bool misaligned(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 != 0;
}

// The kernel of an n-point pass of x into y, as A routes it (fft_axis.cu
// launch_lines_bands): with no tile width given (lc < 0) at n = 512, 768
// and 1024, the line kernel on whole lines with x and y 16-byte aligned,
// the band kernel where post > 1; else A's tile.
enum Route { kTileRoute = 0, kLinesRoute = 1, kBandRoute = 2 };

Route pick_route(const void* x, const void* y, long long pre, int n,
                 long long post, int lc) {
  if (lc >= 0 || pre < 1 || post < 1 || (n != 512 && n != 768 && n != 1024))
    return kTileRoute;
  if (post > 1) return kBandRoute;
  return misaligned(x) || misaligned(y) ? kTileRoute : kLinesRoute;
}

// The line kernel (`lines`) or the band kernel for an n-point pass of x
// into y in the mode (pick_route's); twr, twi: the powers of w_n.  moves
// and adds come here at n = 1024 alone (4^5).  kMany: the instance that
// runs reps > 1.
template <int kMode, bool kMany>
int launch_lines_bands(bool lines, const float* x, float* y,
                       const float* twr, const float* twi, long long pre,
                       int n, long long post, float sign, int reps,
                       cudaStream_t stream) {
  constexpr bool kAll = kMode == kCopy || kMode == kFull;
  const long long plane = pre * n * post;
  const long long h = (n / 2) * post;
  const Half<const float> a{x, plane, n * post}, b{x + h, plane, n * post};
  const Half<float> oa{y, plane, n * post}, ob{y + h, plane, n * post};
  if (!kAll && n != 1024) return cudaErrorInvalidValue;
  if (lines) {
    if constexpr (kAll) {
      if (n == 512)
        return launch_lines<512, kMode, kMany>(a, b, oa, ob, twr, twi, pre,
                                               sign, reps, stream);
      if (n == 768)
        return launch_lines<768, kMode, kMany>(a, b, oa, ob, twr, twi, pre,
                                               sign, reps, stream);
    }
    return launch_lines<1024, kMode, kMany>(a, b, oa, ob, twr, twi, pre,
                                            sign, reps, stream);
  }
  const bool k3 = n == 768;
  constexpr int K = mff::band_cluster<float>(1024);
  static_assert(mff::band_cluster<float>(512) == K, "one cluster size");
  const int R = n / K;                       // kB 2^lr rows a CTA
  const int lr = mff::log2_of(R / (k3 ? 3 : 1));
  const int lc = mff::band_log2_cols<float>(R);
  const long long grid = K * ((pre * post + (1 << lc) - 1) >> lc);
  const bool vec = post % mff::kVec16<float> == 0 && !misaligned(x) &&
                   !misaligned(y);
  auto kern = vec ? &bfly_band_kernel<true, 1, kMode, kMany>
                  : &bfly_band_kernel<false, 1, kMode, kMany>;
  if constexpr (kAll) {
    if (k3)
      kern = vec ? &bfly_band_kernel<true, 3, kMode, kMany>
                 : &bfly_band_kernel<false, 3, kMode, kMany>;
  }
  return mff::launch_ex(kern, grid, AxisBandBudget<float>::kThreads,
                        mff::band_smem<float>(R, lc), K, stream, a, b, oa,
                        ob, twr, twi, pre, post, lr, lc, sign, reps);
}

template <int kMode>
int launch(const float* x, float* y, const float* tw, long long tw_len,
           long long pre, int n, long long post, int sign,
           const mff::Plan& p, int lc, int reps, long long blocks,
           void* stream) {
  const int C = 1 << lc;
  const int threads = (n << lc) / 16;
  const size_t smem = sizeof(long long) * C +
                      2 * sizeof(float) * static_cast<size_t>(n) * (C + 1);
  using B = mff::Budget<float>;
  auto kern = mff::pick_bound<float>(
      smem, &bfly_kernel<float, B::kMinBlocks, kMode>,
      &bfly_kernel<float, B::kWideMinBlocks, kMode>);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<static_cast<unsigned>(blocks), threads, smem,
         static_cast<cudaStream_t>(stream)>>>(
      x, y, tw, tw_len, pre, n, post, static_cast<float>(sign), p, lc, reps);
  return cudaGetLastError();
}

}  // namespace

// The line or band kernel of the mode, its instance for reps > 1 where
// there are more passes than one (copy has no work to repeat).
template <int kMode>
int launch_reps(bool lines, const float* x, float* y, const float* twr,
                const float* twi, long long pre, int n, long long post,
                float sign, int reps, cudaStream_t stream) {
  if constexpr (kMode != kCopy) {
    if (reps > 1)
      return launch_lines_bands<kMode, true>(lines, x, y, twr, twi, pre, n,
                                             post, sign, reps, stream);
  }
  return launch_lines_bands<kMode, false>(lines, x, y, twr, twi, pre, n,
                                          post, sign, reps, stream);
}

int launch_mode(int mode, bool lines, const float* x, float* y,
                const float* twr, const float* twi, long long pre, int n,
                long long post, float sign, int reps, cudaStream_t stream) {
  switch (mode) {
    case kCopy: return launch_reps<kCopy>(lines, x, y, twr, twi, pre, n,
                                          post, sign, reps, stream);
    case kMoves: return launch_reps<kMoves>(lines, x, y, twr, twi, pre, n,
                                            post, sign, reps, stream);
    case kAdds: return launch_reps<kAdds>(lines, x, y, twr, twi, pre, n,
                                          post, sign, reps, stream);
    default: return launch_reps<kFull>(lines, x, y, twr, twi, pre, n, post,
                                       sign, reps, stream);
  }
}

// x, y: (2, pre, n, post) float32, contiguous; y == x runs in place, as
// A does (every block or cluster loads its own lines whole before it
// stores them, and no other touches them).  tw, plan: A's tables for n
// and sign (_tw_pack_axis, _stage_plan).  mode 0 copy, 1 moves, 2 adds,
// 3 full; reps >= 1; lc: log2 of the lines of A's tile, or -1 for A's
// route (A's line or band kernel at n = 512, 768, 1024, else A's own tile,
// butterfly.cuh tile_log2_lines).  Returns the error of a refused launch,
// else cudaGetLastError().
extern "C" int mff_bfly_f32(const float* x, float* y, const float* tw,
                            long long tw_len, long long pre, int n,
                            long long post, int sign, const int* plan,
                            int nstages, int mode, int reps, int lc,
                            void* stream) {
  mff::Plan p;
  if (!mff::make_plan(plan, nstages, n, &p) || tw_len < n || mode < kCopy ||
      mode > kFull || reps < 1 || ((mode == kMoves || mode == kAdds) &&
                                   (n < 4 || !pow4(n))))
    return cudaErrorInvalidValue;
  const Route route = pick_route(x, y, pre, n, post, lc);
  if (route != kTileRoute) {
    const float* twr = tw + (tw_len - n);
    return launch_mode(mode, route == kLinesRoute, x, y, twr, twr + tw_len,
                       pre, n, post, static_cast<float>(sign), reps,
                       static_cast<cudaStream_t>(stream));
  }
  const int own = mff::tile_log2_lines<float>(n);
  if (lc < 0) lc = own;
  const int C = 1 << lc;
  const long long nlines = pre * post;
  const long long blocks = (nlines + C - 1) / C;
  if (lc > own || nlines <= 0 || blocks > 0x7fffffffLL ||
      ((n << lc) % 16) != 0)
    return cudaErrorInvalidValue;
  switch (mode) {
    case kCopy: return launch<kCopy>(x, y, tw, tw_len, pre, n, post, sign, p,
                                     lc, reps, blocks, stream);
    case kMoves: return launch<kMoves>(x, y, tw, tw_len, pre, n, post, sign,
                                       p, lc, reps, blocks, stream);
    case kAdds: return launch<kAdds>(x, y, tw, tw_len, pre, n, post, sign, p,
                                     lc, reps, blocks, stream);
    default: return launch<kFull>(x, y, tw, tw_len, pre, n, post, sign, p,
                                  lc, reps, blocks, stream);
  }
}

// The kernel mff_bfly_f32 runs with the same tensors, shape and tile
// width: 0 A's tile, 1 the line kernel, 2 the band kernel.  Nothing is
// launched.
extern "C" int mff_bfly_route_f32(const float* x, const float* y,
                                  long long pre, int n, long long post,
                                  int lc) {
  return pick_route(x, y, pre, n, post, lc);
}
