// rfft_axis_p and irfft_axis_p: real <-> Hermitian half spectrum along one
// axis by the packed N/2-point method, for N = 2^a or 3*2^a <= 1024; built
// for float32 and for float64.
//
// Replaces the TPU kernels of mpi4py_fft_tpu/ops/pallas_butterfly.py:
// * r2c, reached from rfft_axis_p :1818 through _dispatch_r2c :1749:
//   _kern_lead_r2c/_kern_mid_r2c/_kern_last_r2c :1609-1632, row helpers
//   _r2c_rows :1560, _r2c_rows_full :1545 (N = 2), _herm_trunc_rows :1514;
// * c2r, reached from irfft_axis_p :1980 through _dispatch_c2r :1850:
//   _kern_lead_c2r/_kern_mid_c2r/_kern_last_c2r :1679-1724, row helpers
//   _c2r_rows_packed :1645, _c2r_rows :1635 (N = 2), _herm_pad_rows :1527.
// The float64 builds replace the double-single r2c/c2r of
// mpi4py_fft_tpu/ops/pallas_ds.py, rfft_axis_ds :546 and irfft_axis_ds
// :593 (XLA glue of pack, untangle and interleave around fft_axis_ds
// :368), with every feature of the f32 kernels kept: hext, trunc with
// the Nyquist fold, the Hermitian zero-pad in the read, 3*2^a lengths.
//
// Bound on an H100: bytes, as for fft_axis.cu: a real line of N values
// in, N/2+1 complex rows out (or the reverse), with about 2.5 N log2 N
// flops.
// Design: the same tile of C lines as fft_axis.cu, of the N/2-point packed
// sequence z[m] = x[2m] + i x[2m+1].  The r2c kernel runs the stages in
// shared memory and untangles the spectrum while it writes it (with the
// Hermitian truncation and the zero rows up to hext); the c2r kernel pads
// the spectrum in its read, repacks it in shared memory, runs the inverse
// stages and interleaves the real output in its write.
//
// The float64 r2c on whole lines (post == 1: the last axis, as the DNS
// solvers call it) takes a line kernel instead, at every packed length
// (N = 4 to 1024).  The tile kernel's fp64 build holds 16 lines of 256
// points at N = 512, so three 256-thread blocks an SM cap a thread at 80
// registers, its four radix-4 stages spill 1852 B a thread and need eight
// block-wide barriers, and it reads one 8-byte element at a time.  The
// line kernel gives each line of W = N/2 points to a group of G = W/P
// threads (P = 16 points a thread for W = 2^a, 24 for W = 3*2^a; G <= 32,
// so a group lies inside one warp).  A thread issues all its P loads,
// each point z[m] one 16-byte double2 (a group's load reads 16 G
// contiguous bytes), before it computes.  The W-point transform runs as
// Stockham stages of radix 16 or 8 and one remainder (radix 3 last): two
// stages at W = 256 (16, 16), three at W = 512 (16, 16, 2) and four at
// W = 384 (8, 8, 2, 3); each stage's butterflies
// sit in registers, and the exchange between stages goes through the
// group's own W-point buffer in shared memory behind __syncwarp, with no
// block-wide barrier.  The stage twiddles w_W^e are read from the unpack
// rows of the table ((cos, sin)(2 pi k/N), k <= W; w_W^e = w_N^(2e), with
// w_N^(k+W) = -w_N^k).  The untangle (Z[j] with Z[W-j]) reads the buffer;
// the rows of both planes are written by neighbouring threads, so a
// group's stores are coalesced into the 8-byte-aligned (hext)-row lines,
// with the truncation, the Nyquist fold, the zero rows and the scale as
// in the tile kernel.  The launch bound (128 threads, one block) leaves a
// thread up to 255 registers, so no stage spills.
#include <cstdint>
#include <type_traits>

#include "butterfly.cuh"

namespace {

// Offsets of element 0 of each tile line in the input (rows n_in) and the
// output (rows n_out); -1 past the last line.
__device__ __forceinline__ void line_bases2(long long* bin, long long* bout,
                                            long long l0, long long nlines,
                                            int C, int n_in, int n_out,
                                            long long post) {
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const long long l = l0 + c;
    if (l < nlines) {
      const long long a = l / post, b = l % post;
      bin[c] = a * n_in * post + b;
      bout[c] = a * n_out * post + b;
    } else {
      bin[c] = -1;
      bout[c] = -1;
    }
  }
}

// Element (line c, row k) of a flat index over a tile of rows x C lines:
// neighbours along a line when post == 1, across lines otherwise.
__device__ __forceinline__ void tile_index(int idx, int rows, int lc,
                                           long long post, int* c, int* k) {
  if (post == 1) {
    *c = idx / rows;
    *k = idx - *c * rows;
  } else {
    *c = idx & ((1 << lc) - 1);
    *k = idx >> lc;
  }
}

// Real (pre, n, post) -> planar (2, pre, hext, post).  W = n/2 when
// packed, else n (n = 2).  Rows >= nrows are zero; fold doubles the real
// part and zeroes the imaginary part of row nrows-1 (even truncation).
template <class T, int kBlocks>
__global__ void __launch_bounds__(mff::Budget<T>::kTile / 16, kBlocks)
rfft_axis_kernel(const T* __restrict__ x, T* __restrict__ y,
                 const T* __restrict__ tw, long long tw_len,
                 long long pre, int n, long long post, int hext, int nrows,
                 int fold, int packed, int W, int t2, mff::Plan plan,
                 T scale, int lc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = 1 << lc;
  long long* bin = reinterpret_cast<long long*>(smem);
  long long* bout = bin + C;
  mff::Tile<T> t;
  t.lc = lc;
  t.cp = C + 1;
  t.re = reinterpret_cast<T*>(bout + C);
  t.im = t.re + W * t.cp;
  const long long nlines = pre * post;
  line_bases2(bin, bout, static_cast<long long>(blockIdx.x) << lc, nlines,
              C, n, hext, post);
  __syncthreads();

  for (int idx = threadIdx.x; idx < (n << lc); idx += blockDim.x) {
    int c, k;
    tile_index(idx, n, lc, post, &c, &k);
    const long long b = bin[c];
    const T v = b >= 0 ? x[b + k * post] : T(0);
    if (packed) {            // z[m] = x[2m] + i x[2m+1]
      ((k & 1) ? t.im : t.re)[(k >> 1) * t.cp + c] = v;
    } else {
      t.re[k * t.cp + c] = v;
      t.im[k * t.cp + c] = 0;
    }
  }
  __syncthreads();

  const T* twr = tw;
  const T* twi = tw + tw_len;
  mff::run_plan(t, W, plan, twr, twi, T(-1));

  const long long plane = nlines * hext;
  for (int idx = threadIdx.x; idx < (hext << lc); idx += blockDim.x) {
    int c, j;
    tile_index(idx, hext, lc, post, &c, &j);
    const long long b = bout[c];
    if (b < 0) continue;
    T r = 0, i = 0;
    if (j < nrows) {
      if (packed) {
        // Z[j] (Z[W] = Z[0]) and Z[(W - j) % W]
        const int je = (j == W ? 0 : j) * t.cp + c;
        const int jr = (j == 0 ? 0 : W - j) * t.cp + c;
        const T zre = t.re[je], zie = t.im[je];
        const T zrr = t.re[jr], zir = t.im[jr];
        const T er = T(0.5) * (zre + zrr);
        const T ei = T(0.5) * (zie - zir);
        const T orr = T(0.5) * (zie + zir);
        const T oi = T(0.5) * (zrr - zre);
        const T cw = __ldg(twr + t2 + j), sw = __ldg(twi + t2 + j);
        // X = E + w^j O, w^j = cw - i sw
        r = (er + cw * orr + sw * oi) * scale;
        i = (ei + cw * oi - sw * orr) * scale;
      } else {
        r = t.re[j * t.cp + c] * scale;
        i = t.im[j * t.cp + c] * scale;
      }
      if (fold && j == nrows - 1) {
        r = T(2) * r;
        i = 0;
      }
    }
    const long long a = b + j * post;
    y[a] = r;
    y[plane + a] = i;
  }
}

// Planar (2, pre, hin, post) -> real (pre, n, post).  W = n/2 when packed,
// else n (n = 2); the tile holds W + 1 spectrum rows.  scale carries the
// packed inverse's factor 2.
template <class T, int kBlocks>
__global__ void __launch_bounds__(mff::Budget<T>::kTile / 16, kBlocks)
irfft_axis_kernel(const T* __restrict__ x, T* __restrict__ y,
                  const T* __restrict__ tw, long long tw_len,
                  long long pre, int hin, int n, long long post, int packed,
                  int W, int t2, mff::Plan plan, T scale, int lc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = 1 << lc;
  long long* bin = reinterpret_cast<long long*>(smem);
  long long* bout = bin + C;
  mff::Tile<T> t;
  t.lc = lc;
  t.cp = C + 1;
  t.re = reinterpret_cast<T*>(bout + C);
  t.im = t.re + (W + 1) * t.cp;
  const long long nlines = pre * post;
  const long long plane = nlines * hin;
  line_bases2(bin, bout, static_cast<long long>(blockIdx.x) << lc, nlines,
              C, hin, n, post);
  __syncthreads();

  // read rows 0..nh-1 with the Hermitian zero-padding of a short spectrum
  const int nh = n / 2 + 1;
  const bool halve = hin < nh && hin % 2 == 0;
  for (int idx = threadIdx.x; idx < (nh << lc); idx += blockDim.x) {
    int c, k;
    tile_index(idx, nh, lc, post, &c, &k);
    const long long b = bin[c];
    T vr = 0, vi = 0;
    if (b >= 0 && k < hin) {
      const long long a = b + k * post;
      vr = x[a];
      vi = x[plane + a];
      if (halve && k == hin - 1) {
        vr = T(0.5) * vr;
        vi = 0;
      }
    }
    t.re[k * t.cp + c] = vr;
    t.im[k * t.cp + c] = vi;
  }
  __syncthreads();

  const T* twr = tw;
  const T* twi = tw + tw_len;
  if (packed) {
    // Z[k] = E[k] + i O[k] for k < W, in place: read all, sync, write
    T zr[16], zi[16];
#pragma unroll
    for (int s = 0; s < 16; ++s) {
      const int e = threadIdx.x + s * blockDim.x;
      if (e < (W << lc)) {
        const int c = e & (C - 1), k = e >> lc;
        const T xrh = t.re[k * t.cp + c], xih = t.im[k * t.cp + c];
        const T xrr = t.re[(W - k) * t.cp + c];
        const T xir = t.im[(W - k) * t.cp + c];
        const T er = T(0.5) * (xrh + xrr);
        const T ei = T(0.5) * (xih + xir * T(-1));
        const T dr = xrh - xrr;
        const T di = xih + xir;
        const T cw = __ldg(twr + t2 + k), sw = __ldg(twi + t2 + k);
        const T ore = T(0.5) * (cw * dr - sw * di);
        const T oim = T(0.5) * (cw * di + sw * dr);
        zr[s] = er - oim;
        zi[s] = ei + ore;
      }
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < 16; ++s) {
      const int e = threadIdx.x + s * blockDim.x;
      if (e < (W << lc)) {
        const int c = e & (C - 1), k = e >> lc;
        t.re[k * t.cp + c] = zr[s];
        t.im[k * t.cp + c] = zi[s];
      }
    }
    __syncthreads();
  }

  mff::run_plan(t, W, plan, twr, twi, T(1));

  for (int idx = threadIdx.x; idx < (n << lc); idx += blockDim.x) {
    int c, m;
    tile_index(idx, n, lc, post, &c, &m);
    const long long b = bout[c];
    if (b < 0) continue;
    // packed: out[2m] = Re z[m], out[2m+1] = Im z[m]; else Re x[m]
    const T v = packed ? ((m & 1) ? t.im : t.re)[(m >> 1) * t.cp + c]
                       : t.re[m * t.cp + c];
    y[b + m * post] = v * scale;
  }
}

// ---------------------------------------------------------------------------
// the float64 r2c on whole lines
// ---------------------------------------------------------------------------

constexpr int kLineThreads = 128;

// Points a thread of a W-point line holds: 16 (W = 2^a) or 24 (3*2^a),
// or the whole line when it is shorter.
__host__ __device__ constexpr int line_points(int W) {
  return W % 3 == 0 ? (W >= 24 ? 24 : W) : (W >= 16 ? 16 : W);
}

// Radix of stage s of a W-point line (0 past the last): radix 16 (8 for
// 3*2^a) while the power-of-two part allows, then its remainder, then 3.
// Every radix divides line_points(W).
__host__ __device__ constexpr int line_radix(int W, int s) {
  const bool k3 = W % 3 == 0;
  const int top = k3 ? 8 : 16;
  int rest = k3 ? W / 3 : W;
  int i = 0;
  for (; rest > 1; ++i) {
    const int r = rest >= top ? top : rest;
    if (i == s) return r;
    rest /= r;
  }
  return k3 && i == s ? 3 : 0;
}

// Product of the radices before stage s.
__host__ __device__ constexpr int line_span(int W, int s) {
  int m = 1;
  for (int i = 0; i < s; ++i) m *= line_radix(W, i);
  return m;
}

// One Stockham stage of radix R over the W-point line of a group, with
// M sub-transforms interleaved (M: the earlier radices' product); thread
// g of the group owns butterflies b = g + G k, k < P/R.  The first stage
// reads the thread's own points (z[g + G s] in zr/zi[s]); the others read
// the group's buffer.  Every stage writes its outputs to the buffer.
template <int W, int R, int M, bool kFirst>
__device__ __forceinline__ void line_stage(const double* zr,
                                           const double* zi, double* br,
                                           double* bi, int g,
                                           const double* __restrict__ cw,
                                           const double* __restrict__ sw) {
  constexpr int P = line_points(W), G = W / P, K = P / R;
  constexpr int Lq = W / M / R;
  double vr[K][R], vi[K][R];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int b = g + G * k;
    const int lp = b / M, m = b % M;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if constexpr (kFirst) {
        vr[k][j] = zr[k + K * j];
        vi[k][j] = zi[k + K * j];
      } else {
        const int s = (j * Lq + lp) * M + m;
        vr[k][j] = br[s];
        vi[k][j] = bi[s];
      }
    }
    mff::Dft<R, double>::run(vr[k], vi[k], -1.0);
    if constexpr (Lq > 1) {    // w_L^(j lp) = w_N^(2 j lp M), sign -1
#pragma unroll
      for (int j = 1; j < R; ++j) {
        const int u = 2 * j * lp * M;
        double c, s;
        if (u <= W) {
          c = __ldg(cw + u);
          s = __ldg(sw + u);
        } else {
          c = -__ldg(cw + u - W);
          s = -__ldg(sw + u - W);
        }
        const double yr = vr[k][j], yi = vi[k][j];
        vr[k][j] = yr * c + yi * s;
        vi[k][j] = yi * c - yr * s;
      }
    }
  }
  if (!kFirst) __syncwarp();   // the group has read the buffer
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int b = g + G * k;
    const int lp = b / M, m = b % M;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int d = (lp * R + j) * M + m;
      br[d] = vr[k][j];
      bi[d] = vi[k][j];
    }
  }
  __syncwarp();
}

// Stages s.. of a W-point line.
template <int W, int S>
__device__ __forceinline__ void line_stages(const double* zr,
                                            const double* zi, double* br,
                                            double* bi, int g,
                                            const double* __restrict__ cw,
                                            const double* __restrict__ sw) {
  if constexpr (line_radix(W, S) != 0) {
    line_stage<W, line_radix(W, S), line_span(W, S), S == 0>(zr, zi, br, bi,
                                                             g, cw, sw);
    line_stages<W, S + 1>(zr, zi, br, bi, g, cw, sw);
  }
}

// Real (nlines, 2W) -> planar (2, nlines, hext) with the packed W-point
// transform, a group of W/P threads a line (see the note at the top).
// tw: the table of _tw_pack_packed(2W, -1), its unpack rows at t2.
template <int W>
__global__ void __launch_bounds__(kLineThreads, 1)
rfft_lines_kernel(const double* __restrict__ x, double* __restrict__ y,
                  const double* __restrict__ tw, long long tw_len, int t2,
                  long long nlines, int hext, int nrows, int fold,
                  double scale) {
  constexpr int P = line_points(W), G = W / P;
  extern __shared__ __align__(16) unsigned char smem[];
  const int grp = threadIdx.x / G, g = threadIdx.x % G;
  double* br = reinterpret_cast<double*>(smem) + grp * 2 * W;
  double* bi = br + W;
  const long long line =
      static_cast<long long>(blockIdx.x) * (kLineThreads / G) + grp;
  const bool live = line < nlines;
  const double* cw = tw + t2;
  const double* sw = tw + tw_len + t2;

  // every load first: point g + G s of the line, one double2 each
  const double2* xz =
      reinterpret_cast<const double2*>(x) + (live ? line : 0) * W;
  double zr[P], zi[P];
#pragma unroll
  for (int s = 0; s < P; ++s) {
    const double2 v = __ldg(xz + g + G * s);
    zr[s] = v.x;
    zi[s] = v.y;
  }
  line_stages<W, 0>(zr, zi, br, bi, g, cw, sw);
  if (!live) return;

  // untangle Z[j] with Z[W - j] into row j, both planes
  double* yr = y + line * hext;
  double* yi = yr + nlines * hext;
  for (int j = g; j < hext; j += G) {
    double r = 0, i = 0;
    if (j < nrows) {
      const int je = j == W ? 0 : j;
      const int jr = j == 0 ? 0 : W - j;
      const double zre = br[je], zie = bi[je];
      const double zrr = br[jr], zir = bi[jr];
      const double er = 0.5 * (zre + zrr);
      const double ei = 0.5 * (zie - zir);
      const double orr = 0.5 * (zie + zir);
      const double oi = 0.5 * (zrr - zre);
      const double c = __ldg(cw + j), s = __ldg(sw + j);
      // X = E + w^j O, w^j = c - i s
      r = (er + c * orr + s * oi) * scale;
      i = (ei + c * oi - s * orr) * scale;
      if (fold && j == nrows - 1) {
        r = 2.0 * r;
        i = 0;
      }
    }
    yr[j] = r;
    yi[j] = i;
  }
}

template <int W>
int launch_lines(const double* x, double* y, const double* tw,
                 long long tw_len, long long nlines, int hext, int nrows,
                 int fold, double scale, cudaStream_t stream) {
  constexpr int P = line_points(W), G = W / P;
  static_assert(G <= 32 && 32 % G == 0 && kLineThreads % 32 == 0,
                "a group lies inside one warp");
  constexpr int lines = kLineThreads / G;
  const long long blocks = (nlines + lines - 1) / lines;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = sizeof(double) * 2 * W * lines;
  auto kern = &rfft_lines_kernel<W>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<static_cast<unsigned>(blocks), kLineThreads, smem, stream>>>(
      x, y, tw, tw_len, static_cast<int>(tw_len) - (W + 1), nlines, hext,
      nrows, fold, scale);
  return cudaGetLastError();
}

// The line kernel of W = n/2 (every packed length up to 1024).
int launch_rfft_lines(const double* x, double* y, const double* tw,
                      long long tw_len, long long nlines, int W, int hext,
                      int nrows, int fold, double scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MFF_LINES(w)                                                      \
  case w:                                                                 \
    return launch_lines<w>(x, y, tw, tw_len, nlines, hext, nrows, fold,   \
                           scale, st)
  switch (W) {
    MFF_LINES(2); MFF_LINES(4); MFF_LINES(8); MFF_LINES(16); MFF_LINES(32);
    MFF_LINES(64); MFF_LINES(128); MFF_LINES(256); MFF_LINES(512);
    MFF_LINES(3); MFF_LINES(6); MFF_LINES(12); MFF_LINES(24); MFF_LINES(48);
    MFF_LINES(96); MFF_LINES(192); MFF_LINES(384);
    default: return cudaErrorInvalidValue;
  }
#undef MFF_LINES
}

// Tile of a launch.
template <class T>
bool launch_shape(int W, long long nlines, int* lc, long long* blocks,
                  int* threads) {
  *lc = mff::tile_log2_lines<T>(W);
  const int C = 1 << *lc;
  *blocks = (nlines + C - 1) / C;
  if (nlines <= 0 || *blocks > 0x7fffffffLL || ((W << *lc) % 16) != 0)
    return false;
  *threads = (W << *lc) / 16;
  return true;
}

template <class T>
int launch_rfft_axis(const T* x, T* y, const T* tw, long long tw_len,
                     long long pre, int n, long long post, int hext,
                     int nrows, int fold, int packed, const int* plan,
                     int nstages, T scale, void* stream) {
  const int W = packed ? n / 2 : n;
  mff::Plan p;
  if (!mff::make_plan(plan, nstages, W, &p) || hext < nrows)
    return cudaErrorInvalidValue;
  // float64 whole lines of a packed length, 16-byte aligned: the line
  // kernel (its own stage plan; tw's unpack rows give every twiddle)
  if constexpr (std::is_same<T, double>::value) {
    if (post == 1 && packed &&
        reinterpret_cast<std::uintptr_t>(x) % 16 == 0) {
      if (pre <= 0 || tw_len < W + 1) return cudaErrorInvalidValue;
      return launch_rfft_lines(x, y, tw, tw_len, pre, W, hext, nrows, fold,
                               scale, stream);
    }
  }
  int lc, threads;
  long long blocks;
  if (!launch_shape<T>(W, pre * post, &lc, &blocks, &threads))
    return cudaErrorInvalidValue;
  // stage twiddles first, then the unpack rows
  const int t2 = packed ? static_cast<int>(tw_len) - (W + 1) : 0;
  const int C = 1 << lc;
  const size_t smem = 2 * sizeof(long long) * C +
                      2 * sizeof(T) * static_cast<size_t>(W) * (C + 1);
  using B = mff::Budget<T>;
  auto kern = mff::pick_bound<T>(smem, &rfft_axis_kernel<T, B::kMinBlocks>,
                                 &rfft_axis_kernel<T, B::kWideMinBlocks>);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<static_cast<unsigned>(blocks), threads, smem,
         static_cast<cudaStream_t>(stream)>>>(
      x, y, tw, tw_len, pre, n, post, hext, nrows, fold, packed, W, t2, p,
      scale, lc);
  return cudaGetLastError();
}

template <class T>
int launch_irfft_axis(const T* x, T* y, const T* tw, long long tw_len,
                      long long pre, int hin, int n, long long post,
                      int packed, const int* plan, int nstages, T scale,
                      void* stream) {
  const int W = packed ? n / 2 : n;
  mff::Plan p;
  if (!mff::make_plan(plan, nstages, W, &p) || hin < 1)
    return cudaErrorInvalidValue;
  int lc, threads;
  long long blocks;
  if (!launch_shape<T>(W, pre * post, &lc, &blocks, &threads))
    return cudaErrorInvalidValue;
  const int t2 = packed ? static_cast<int>(tw_len) - (W + 1) : 0;
  const int C = 1 << lc;
  const size_t smem = 2 * sizeof(long long) * C +
                      2 * sizeof(T) * static_cast<size_t>(W + 1) * (C + 1);
  using B = mff::Budget<T>;
  auto kern = mff::pick_bound<T>(smem, &irfft_axis_kernel<T, B::kMinBlocks>,
                                 &irfft_axis_kernel<T, B::kWideMinBlocks>);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<static_cast<unsigned>(blocks), threads, smem,
         static_cast<cudaStream_t>(stream)>>>(
      x, y, tw, tw_len, pre, hin, n, post, packed, W, t2, p, scale, lc);
  return cudaGetLastError();
}

}  // namespace

// x: (pre, n, post) float32; y: (2, pre, hext, post) float32; both
// contiguous on the current device.  tw: (2, tw_len), _tw_pack_packed(n, -1)
// when packed, else _tw_pack(n, -1).  Returns cudaGetLastError().
extern "C" int mff_rfft_axis_f32(const float* x, float* y, const float* tw,
                                 long long tw_len, long long pre, int n,
                                 long long post, int hext, int nrows,
                                 int fold, int packed, const int* plan,
                                 int nstages, float scale, void* stream) {
  return launch_rfft_axis(x, y, tw, tw_len, pre, n, post, hext, nrows, fold,
                          packed, plan, nstages, scale, stream);
}

// The same for float64 x, y and tw, with a double scale.
extern "C" int mff_rfft_axis_f64(const double* x, double* y,
                                 const double* tw, long long tw_len,
                                 long long pre, int n, long long post,
                                 int hext, int nrows, int fold, int packed,
                                 const int* plan, int nstages, double scale,
                                 void* stream) {
  return launch_rfft_axis(x, y, tw, tw_len, pre, n, post, hext, nrows, fold,
                          packed, plan, nstages, scale, stream);
}

// x: (2, pre, hin, post) float32; y: (pre, n, post) float32; both
// contiguous on the current device.  tw: (2, tw_len), _tw_pack_packed(n, +1)
// when packed, else _tw_pack(n, +1).  Returns cudaGetLastError().
extern "C" int mff_irfft_axis_f32(const float* x, float* y, const float* tw,
                                  long long tw_len, long long pre, int hin,
                                  int n, long long post, int packed,
                                  const int* plan, int nstages, float scale,
                                  void* stream) {
  return launch_irfft_axis(x, y, tw, tw_len, pre, hin, n, post, packed, plan,
                           nstages, scale, stream);
}

// The same for float64 x, y and tw, with a double scale.
extern "C" int mff_irfft_axis_f64(const double* x, double* y,
                                  const double* tw, long long tw_len,
                                  long long pre, int hin, int n,
                                  long long post, int packed,
                                  const int* plan, int nstages, double scale,
                                  void* stream) {
  return launch_irfft_axis(x, y, tw, tw_len, pre, hin, n, post, packed, plan,
                           nstages, scale, stream);
}
