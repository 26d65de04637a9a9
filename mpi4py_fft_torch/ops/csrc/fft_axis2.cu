// fft_axis2_p / fft_axis_pair_p: unnormalized planar c2c Stockham FFT
// along an axis whose N rows arrive as two halves of h = N/2 rows each
// (rows 0..h-1 from operand a, rows h..N-1 from operand b), written as two
// output halves in natural order, for N = 2^a or 3*2^a <= 2048, either
// sign, with an optional scale folded into the last write.  Float32 only,
// as the JAX package gates its pair route: float64 on CUDA takes kernel
// axes up to 1024, and longer float64 axes run on the engine.
//
// Replaces the TPU kernels of mpi4py_fft_tpu/ops/pallas_butterfly.py
// reached from fft_axis2_p :1358 through _dispatch2 :1280 (_kern_lead2,
// _kern_mid2, _kern_last2s :1195-1237) and from fft_axis_pair_p :1476
// through _dispatch2q :1428 (_kern_lead2q, _kern_mid2q, _kern_last2q
// :1386-1423), with their split-input core _butterfly2 :484.
//
// Each operand comes with its own base pointer, plane stride and pre
// stride; the row stride is post and the column stride 1.  So one entry
// takes two separate tensors (the quarters of the quartered schedule), the
// two halves of one contiguous tensor passed as views (no slice copy, no
// concat), and outputs written over their inputs (alias).
//
// Bound on an H100: bytes, as for fft_axis.cu: one pass reads and writes
// both halves once.  Four kernels, chosen by shape and alignment before
// the launch:
//
// * N <= 1024, whole lines (post == 1), N = 512, 768 or 1024: the line
//   kernel.  A group of G threads inside one warp holds a line in
//   registers, P = 32 points a thread (24 at 768; G = 16, 32, 32): it
//   loads rows below h from a and the rest from b as 16-byte vectors of 4
//   adjacent rows (each vector lies in one half, so the half is known at
//   compile time), runs the line as Stockham stages (radix 8, 16, 8 at
//   1024; 8, 16, 4 at 512; 3, 8, 8, 4 at 768), butterflies in registers
//   and the exchange through the group's buffer behind __syncwarp
//   (lines.cuh, I's row stages), and stores rows below h to oa and the
//   rest to ob with the scale.  A's tile took 7.4 ms for this pass on the
//   quartered 1024^3 transform, at 40 registers and 968 B of spill stores
//   a thread, one 4-byte element a load and one operand picked per element.
//   Bound to four blocks an SM: the 1024-point instance spills 8 B at 128
//   registers; at three blocks (168 registers, no spill) it ran no faster
//   on an H100 (PERF.md §6).
// * N <= 1024, post > 1, N = 512, 768 or 1024: the column band kernel, a
//   cluster of K = 4 CTAs a band of C adjacent lines, R = N / 4 rows a
//   CTA, the most C with R C <= 8192 (32 at 1024: 128-byte row segments;
//   64 at 512; 32 at 768).  CTA
//   rank r loads rows r R .. of the band, ranks 0 and 1 from operand a
//   and ranks 2 and 3 from b, as 16-byte vectors of 4 columns; between
//   two cluster barriers one radix-4 step joins the four row blocks
//   (lines.cuh's cluster step, as I's band at 1024 rows); each CTA then
//   runs its R-point columns as in-place radix-8 stages (a radix-3 stage
//   first at 768, R = 3 * 64), one butterfly a thread at a time, and rank
//   r writes rows 4m + r.  Clusters of 2 and 8 CTAs (64- and 256-byte
//   segments) ran 3-7% and 15% slower on the quartered lead pass on an
//   H100 (PERF.md §6).
// * Every other call at N <= 1024 takes A's tile (butterfly.cuh) at
//   W = N: the other lengths, and halves whose rows are not 16-byte
//   aligned (a base pointer off 16 bytes, or a plane or pre stride, or
//   post > 1, not a multiple of 4 elements; the halves may be any views).
//   A block loads C lines, rows below h from a and the rest from b, into
//   one shared-memory tile, runs every stage there and writes rows below
//   h to oa and the rest to ob.
//   The rule is by shape and alignment only, decided before the launch.
// Every kernel reads each line whole before it writes any of it (the
// line kernel in one group, the band kernel before its first cluster
// barrier, the tile in one block), and no two groups, clusters or
// blocks share a line, so alias is safe.
// * N = 1536 and 2048: a cluster of two CTAs (Hopper thread-block
//   clusters, distributed shared memory) owns C lines, C = 8: the lines of
//   A's tile at N = 1024, where one tile holding whole 2048-point lines
//   would keep only 4 (16-byte row segments, 80 KB, two blocks an SM).
//   CTA rank r loads half r from its own operand, so no index picks an
//   operand per element; the 64-bit line bases are computed once a line,
//   and every load of a thread is issued before its first store to the
//   tile.  A warp loads 4 rows of the 8 lines (tile_index's map): with
//   16-byte vectors across the lines (a warp then loads 16 rows) the
//   tile's copy alone ran faster on an H100, but the whole pass ran 4-6%
//   slower (PERF.md §6).  After a cluster barrier each CTA
//   reaches the peer's half through the peer's shared memory for one
//   radix-2 decimation-in-frequency step across the pair: the thread of
//   rank r takes every other element of its map, reads x[k] and x[k+h]
//   there from both tiles and writes x[k] + x[k+h] to rank 0's tile and
//   (x[k] - x[k+h]) w_N^(sign k) to rank 1's, places no other thread of
//   the cluster touches; a second cluster barrier publishes them.  Each
//   CTA then runs butterfly.cuh's unchanged run_plan over its h-point
//   lines: rank 0 holds the even bins X[2m], rank 1 the odd X[2m+1], and
//   writes row 2m+r (to oa below h, else ob), the scale folded in.  Every
//   global read of both CTAs comes before the first cluster barrier and
//   every global write after the second, and a cluster owns its lines
//   whole, so alias is safe although rank 0 writes rows of the half that
//   rank 1 read.
#include <cstdint>

#include "lines.cuh"

namespace {

using mff::cluster_rank;
using mff::cluster_sync;
using mff::Half;
using mff::peer_smem;

// Line c and row k of tile element idx (the map of fft_axis.cu).
__device__ __forceinline__ void tile_index(int idx, int n, int lc,
                                           long long post, int* c, int* k) {
  if (post == 1) {        // whole lines: neighbours along the line
    *c = idx / n;
    *k = idx - *c * n;
  } else {                // neighbours across lines (post columns)
    *c = idx & ((1 << lc) - 1);
    *k = idx >> lc;
  }
}

template <int kBlocks>
__global__ void __launch_bounds__(mff::Budget<float>::kTile / 16, kBlocks)
fft_axis2_kernel(Half<const float> a, Half<const float> b, Half<float> oa,
                 Half<float> ob, const float* __restrict__ tw,
                 long long tw_len, long long pre, int n, long long post,
                 float sign, mff::Plan plan, float scale, int lc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = 1 << lc;
  const int h = n / 2;
  // pre index (-1 past the last line) and column of each tile line
  long long* lpre = reinterpret_cast<long long*>(smem);
  long long* lcol = lpre + C;
  mff::Tile<float> t;
  t.lc = lc;
  t.cp = C + 1;
  t.re = reinterpret_cast<float*>(lcol + C);
  t.im = t.re + n * t.cp;
  const long long nlines = pre * post;
  const long long l0 = static_cast<long long>(blockIdx.x) << lc;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const long long l = l0 + c;
    lpre[c] = l < nlines ? l / post : -1;
    lcol[c] = l % post;
  }
  __syncthreads();

  const int total = n << lc;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    int c, k;
    tile_index(idx, n, lc, post, &c, &k);
    const long long i = lpre[c];
    float vr = 0.f, vi = 0.f;
    if (i >= 0) {
      const bool lo = k < h;
      const float* p = lo ? a.ptr : b.ptr;
      const long long o = i * (lo ? a.pre : b.pre) +
                          static_cast<long long>(lo ? k : k - h) * post +
                          lcol[c];
      vr = p[o];
      vi = p[(lo ? a.plane : b.plane) + o];
    }
    t.re[k * t.cp + c] = vr;
    t.im[k * t.cp + c] = vi;
  }
  __syncthreads();

  mff::run_plan(t, n, plan, tw, tw + tw_len, sign);

  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    int c, k;
    tile_index(idx, n, lc, post, &c, &k);
    const long long i = lpre[c];
    if (i >= 0) {
      const bool lo = k < h;
      float* p = lo ? oa.ptr : ob.ptr;
      const long long o = i * (lo ? oa.pre : ob.pre) +
                          static_cast<long long>(lo ? k : k - h) * post +
                          lcol[c];
      p[o] = t.re[k * t.cp + c] * scale;
      p[(lo ? oa.plane : ob.plane) + o] = t.im[k * t.cp + c] * scale;
    }
  }
}

// The cluster kernel's lines (C = 8) and the elements of a thread: a
// thread owns 16 elements of its CTA's h x C half tile, mapped as in
// tile_index (a warp reads 4 rows of 8 lines, or along a line).
constexpr int kPairLc = 3;
constexpr int kPairPer = 16;

// The N = 2h-point pass for h = 768 or 1024 by a cluster of two CTAs
// (see the note at the top).  tw: the h-point stage twiddles, then at t2
// the h cross twiddles (cos, sin)(sign 2 pi k / N).  Bound to two blocks
// an SM (64 registers), although three tiles fit: at three (40 registers
// and more spills) the pass took 1.36x as long on an H100 (PERF.md §6).
__global__ void __launch_bounds__(mff::Budget<float>::kTile / 16,
                                  mff::Budget<float>::kWideMinBlocks)
fft_pair_cluster_kernel(Half<const float> a, Half<const float> b,
                        Half<float> oa, Half<float> ob,
                        const float* __restrict__ tw, long long tw_len,
                        int t2, long long pre, int h, long long post,
                        float sign, mff::Plan plan, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int C = 1 << kPairLc;
  const unsigned r = cluster_rank();
  // each line's offset in this CTA's input half and in the two output
  // halves (-1 past the last line), computed once
  long long* lin = reinterpret_cast<long long*>(smem);
  long long* loa = lin + C;
  long long* lob = loa + C;
  mff::Tile<float> t;
  t.lc = kPairLc;
  t.cp = C + 1;
  t.re = reinterpret_cast<float*>(lob + C);
  t.im = t.re + h * t.cp;
  const long long nlines = pre * post;
  const long long l0 = static_cast<long long>(blockIdx.x >> 1) << kPairLc;
  const float* src = r ? b.ptr : a.ptr;
  const long long splane = r ? b.plane : a.plane;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const long long l = l0 + c;
    const long long i = l / post, col = l - i * post;
    const bool live = l < nlines;
    lin[c] = live ? i * (r ? b.pre : a.pre) + col : -1;
    loa[c] = live ? i * oa.pre + col : -1;
    lob[c] = live ? i * ob.pre + col : -1;
  }
  __syncthreads();

  // half r from its own operand: every load before the first store
  float vr[kPairPer], vi[kPairPer];
#pragma unroll
  for (int j = 0; j < kPairPer; ++j) {
    int c, k;
    tile_index(threadIdx.x + j * blockDim.x, h, kPairLc, post, &c, &k);
    const long long o = lin[c];
    vr[j] = vi[j] = 0.f;
    if (o >= 0) {
      vr[j] = __ldg(src + o + k * post);
      vi[j] = __ldg(src + splane + o + k * post);
    }
  }
#pragma unroll
  for (int j = 0; j < kPairPer; ++j) {
    int c, k;
    tile_index(threadIdx.x + j * blockDim.x, h, kPairLc, post, &c, &k);
    t.re[k * t.cp + c] = vr[j];
    t.im[k * t.cp + c] = vi[j];
  }
  cluster_sync();

  // the radix-2 DIF step across the pair: rank r takes the elements j
  // with j % 2 == r of its map, reads x[k] and x[k+h] there from the two
  // tiles, and writes x[k] + x[k+h] to rank 0's tile and (x[k] - x[k+h])
  // w_N^(sign k) to rank 1's; no other thread of the cluster touches
  // those places
  float* qre = peer_smem(t.re, r ^ 1u);
  float* qim = peer_smem(t.im, r ^ 1u);
  float* s0re = r ? qre : t.re;
  float* s0im = r ? qim : t.im;
  float* s1re = r ? t.re : qre;
  float* s1im = r ? t.im : qim;
#pragma unroll
  for (int jj = 0; jj < kPairPer / 2; ++jj) {
    int c, k;
    tile_index(threadIdx.x + (2 * jj + static_cast<int>(r)) * blockDim.x, h,
               kPairLc, post, &c, &k);
    const int s = k * t.cp + c;
    const float ar = s0re[s], ai = s0im[s];      // x[k]
    const float br = s1re[s], bi = s1im[s];      // x[k+h]
    const float dr = ar - br, di = ai - bi;
    const float wr = __ldg(tw + t2 + k), wi = __ldg(tw + tw_len + t2 + k);
    s0re[s] = ar + br;
    s0im[s] = ai + bi;
    s1re[s] = dr * wr - di * wi;
    s1im[s] = dr * wi + di * wr;
  }
  cluster_sync();

  mff::run_plan(t, h, plan, tw, tw + tw_len, sign);

  // bin m of this CTA is X[2m + r]: row 2m + r of the output
#pragma unroll
  for (int j = 0; j < kPairPer; ++j) {
    int c, m;
    tile_index(threadIdx.x + j * blockDim.x, h, kPairLc, post, &c, &m);
    const int row = 2 * m + static_cast<int>(r);
    const bool lo = row < h;
    const long long o = (lo ? loa : lob)[c];
    if (o < 0) continue;
    float* dp = (lo ? oa.ptr : ob.ptr) + o +
                static_cast<long long>(lo ? row : row - h) * post;
    dp[0] = t.re[m * t.cp + c] * scale;
    dp[lo ? oa.plane : ob.plane] = t.im[m * t.cp + c] * scale;
  }
}

// The launch of the cluster kernel at h = n/2 on `lines` lines: a config
// of clusters of two CTAs and its shared memory; false if the pass is not
// one it takes.
struct PairLaunch {
  void (*kern)(Half<const float>, Half<const float>, Half<float>,
               Half<float>, const float*, long long, int, long long, int,
               long long, float, mff::Plan, float);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
};

inline bool pair_launch(int h, long long lines, PairLaunch* L) {
  constexpr int C = 1 << kPairLc;
  if (h != 768 && h != 1024) return false;
  const long long clusters = (lines + C - 1) / C;
  if (lines <= 0 || 2 * clusters > 0x7fffffffLL) return false;
  const size_t smem = 3 * sizeof(long long) * C +
                      2 * sizeof(float) * static_cast<size_t>(h) * (C + 1);
  L->kern = &fft_pair_cluster_kernel;
  L->cfg = cudaLaunchConfig_t{};
  L->cfg.gridDim = dim3{static_cast<unsigned>(2 * clusters), 1u, 1u};
  L->cfg.blockDim = dim3{static_cast<unsigned>(h * C / kPairPer), 1u, 1u};
  L->cfg.dynamicSmemBytes = smem;
  L->attr[0].id = cudaLaunchAttributeClusterDimension;
  L->attr[0].val.clusterDim.x = 2;
  L->attr[0].val.clusterDim.y = 1;
  L->attr[0].val.clusterDim.z = 1;
  L->cfg.attrs = L->attr;
  L->cfg.numAttrs = 1;
  return true;
}

// ---------------------------------------------------------------------------
// N <= 1024: the line kernel (post == 1) and the band kernel (post > 1)
// ---------------------------------------------------------------------------

// Points a thread of the line kernel holds: 32, 24 for 3*2^a.
__host__ __device__ constexpr int pair_line_points(int n) { return n % 3 == 0 ? 24 : 32; }

using PairLines = mff::LineLaunch<float>;

// Whole lines of N points (see the note at the top); twr, twi: the powers
// of w_N.
template <int N>
__global__ void __launch_bounds__(PairLines::kThreads, PairLines::kMinBlocks)
fft_pair_lines_kernel(Half<const float> a, Half<const float> b,
                      Half<float> oa, Half<float> ob,
                      const float* __restrict__ twr,
                      const float* __restrict__ twi, long long lines,
                      float sign, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  mff::line_body<float, N, pair_line_points(N)>(
      a, b, oa, ob, twr, twi, lines, sign, scale,
      reinterpret_cast<float*>(smem));
}

template <int N>
int launch_pair_lines(Half<const float> a, Half<const float> b,
                      Half<float> oa, Half<float> ob, const float* twr,
                      const float* twi, long long lines, float sign,
                      float scale, cudaStream_t stream) {
  constexpr int G = N / pair_line_points(N);
  constexpr int threads = PairLines::kThreads;
  const long long blocks = (lines + threads / G - 1) / (threads / G);
  return mff::launch_ex(&fft_pair_lines_kernel<N>, blocks, threads,
                        sizeof(float) * 2 * mff::row_buf(N) * (threads / G),
                        1, stream, a, b, oa, ob, twr, twi, lines, sign,
                        scale);
}

// CTAs a band of the band kernel (a cluster): the first half of them load
// operand a, the others b.
constexpr int kPairBandK = 4;

// Bands of lines on clusters of kPairBandK CTAs, 16-byte vectors, N =
// kB 2^a (see the note at the top); twr, twi: the powers of w_N.
template <int kB>
__global__ void __launch_bounds__(mff::BandBudget<float>::kThreads,
                                  mff::BandBudget<float>::kMinBlocks)
fft_pair_band_kernel(Half<const float> a, Half<const float> b,
                     Half<float> oa, Half<float> ob,
                     const float* __restrict__ twr,
                     const float* __restrict__ twi, long long pre,
                     long long post, int lr, int lc, float sign,
                     float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  mff::axis_band<float, kPairBandK, true, kB>(
      a, b, oa, ob, twr, twi, pre, post, lr, lc, sign, scale,
      reinterpret_cast<float*>(smem));
}

// The line or band kernel for an n-point pass of these halves, or -1 if
// neither takes it (the tile kernel does).
int launch_pair_axis(Half<const float> a, Half<const float> b,
                     Half<float> oa, Half<float> ob, const float* twr,
                     const float* twi, long long pre, int n, long long post,
                     float sign, float scale, cudaStream_t stream) {
  const auto mis = [](const void* p) {
    return reinterpret_cast<std::uintptr_t>(p) % 16 != 0;
  };
  const auto odd = [](long long s) { return s % 4 != 0; };
  if (mis(a.ptr) || mis(b.ptr) || mis(oa.ptr) || mis(ob.ptr) ||
      odd(a.plane) || odd(a.pre) || odd(b.plane) || odd(b.pre) ||
      odd(oa.plane) || odd(oa.pre) || odd(ob.plane) || odd(ob.pre))
    return -1;
  if (post == 1) {
    switch (n) {
      case 512:
        return launch_pair_lines<512>(a, b, oa, ob, twr, twi, pre, sign,
                                      scale, stream);
      case 768:
        return launch_pair_lines<768>(a, b, oa, ob, twr, twi, pre, sign,
                                      scale, stream);
      case 1024:
        return launch_pair_lines<1024>(a, b, oa, ob, twr, twi, pre, sign,
                                       scale, stream);
      default:
        return -1;
    }
  }
  if ((n != 512 && n != 768 && n != 1024) || odd(post)) return -1;
  constexpr int K = kPairBandK;
  const int R = n / K, kB = n % 3 == 0 ? 3 : 1;   // R = kB 2^lr rows a CTA
  const int lr = mff::log2_of(R / kB);
  const int lc = mff::band_log2_cols<float>(R);
  const long long bands = (pre * post + (1 << lc) - 1) >> lc;
  return mff::launch_ex(
      kB == 3 ? &fft_pair_band_kernel<3> : &fft_pair_band_kernel<1>,
      K * bands, mff::BandBudget<float>::kThreads,
      mff::band_smem<float>(R, lc), K, stream, a, b, oa, ob, twr, twi, pre,
      post, lr, lc, sign, scale);
}

}  // namespace

// xa, xb: the input halves, ya, yb: the output halves, each viewed as
// (2, pre, n/2, post) with row stride post and column stride 1;
// strides: their (plane, pre) strides in elements, in the order xa, xb,
// ya, yb.  n <= 1024: plan and tw are the n-point stage plan and the
// (2, tw_len) table of _tw_pack_axis(n, sign) (the stage twiddles of
// _tw_pack(n, sign), then the n powers of w_n, which the line and band
// kernels read).  n = 1536 or 2048: the h = n/2
// plan and the table of _tw_pack_pair(n, sign) (the h-point stage
// twiddles, then the h cross twiddles of n), for the cluster kernel.
// Returns the error of a refused launch (a cluster that does not fit
// included), else cudaGetLastError() after the launch.
extern "C" int mff_fft_axis2_f32(const float* xa, const float* xb, float* ya,
                                 float* yb, const long long* strides,
                                 const float* tw, long long tw_len,
                                 long long pre, int n, long long post,
                                 int sign, const int* plan, int nstages,
                                 float scale, void* stream) {
  mff::Plan p;
  const bool pair = n > 1024;
  if (n < 2 || n % 2 != 0 || n > 2048 ||
      !mff::make_plan(plan, nstages, pair ? n / 2 : n, &p))
    return cudaErrorInvalidValue;
  const Half<const float> a{xa, strides[0], strides[1]};
  const Half<const float> b{xb, strides[2], strides[3]};
  const Half<float> oa{ya, strides[4], strides[5]};
  const Half<float> ob{yb, strides[6], strides[7]};
  const long long nlines = pre * post;
  if (pair) {
    const int h = n / 2;
    PairLaunch L;
    if (tw_len < h || !pair_launch(h, nlines, &L))
      return cudaErrorInvalidValue;
    L.cfg.stream = static_cast<cudaStream_t>(stream);
    cudaError_t e = cudaFuncSetAttribute(
        L.kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L.cfg.dynamicSmemBytes));
    if (e != cudaSuccess) return e;
    e = cudaLaunchKernelEx(&L.cfg, L.kern, a, b, oa, ob, tw, tw_len,
                           static_cast<int>(tw_len - h), pre, h, post,
                           static_cast<float>(sign), p, scale);
    if (e != cudaSuccess) return e;
    return cudaGetLastError();
  }
  if (nlines <= 0 || tw_len < n) return cudaErrorInvalidValue;
  const float* twr = tw + (tw_len - n);
  const int rc = launch_pair_axis(a, b, oa, ob, twr, twr + tw_len, pre, n,
                                  post, static_cast<float>(sign), scale,
                                  static_cast<cudaStream_t>(stream));
  if (rc >= 0) return rc;
  const int lc = mff::tile_log2_lines<float>(n);
  const int C = 1 << lc;
  const long long blocks = (nlines + C - 1) / C;
  if (blocks > 0x7fffffffLL || ((n << lc) % 16) != 0)
    return cudaErrorInvalidValue;
  const int threads = (n << lc) / 16;
  const size_t smem = 2 * sizeof(long long) * C +
                      2 * sizeof(float) * static_cast<size_t>(n) * (C + 1);
  // every tile up to N = 1024 (74 KB at 1024) fits three blocks an SM
  auto kern = &fft_axis2_kernel<mff::Budget<float>::kMinBlocks>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<static_cast<unsigned>(blocks), threads, smem,
         static_cast<cudaStream_t>(stream)>>>(
      a, b, oa, ob, tw, tw_len, pre, n, post, static_cast<float>(sign), p,
      scale, lc);
  return cudaGetLastError();
}

// The most clusters of the n-point pair kernel (n = 1536 or 2048) that
// the device holds at once, into *count
// (cudaOccupancyMaxActiveClusters); 0 if none fits.
extern "C" int mff_fft_axis2_clusters_f32(int n, int* count) {
  PairLaunch L;
  *count = 0;
  if (!pair_launch(n / 2, 1 << kPairLc, &L))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      L.kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.cfg.dynamicSmemBytes));
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveClusters(
      count, reinterpret_cast<const void*>(L.kern), &L.cfg);
}
