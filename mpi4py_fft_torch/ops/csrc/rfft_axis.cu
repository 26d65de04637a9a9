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
// The r2c on whole lines (post == 1: the last axis, as the DNS solvers
// and the dealiased plans call it) takes a line kernel instead, at every
// packed length (N = 4 to 1024), in both builds.  The tile kernel holds
// C lines in one block: its fp64 build at N = 512 caps a thread at 80
// registers, its four radix-4 stages spill 1852 B a thread (f32: 40
// registers, 968 B at N = 768) and need eight block-wide barriers, and
// it reads one element at a time.  The line kernel gives each line of
// W = N/2 points to a group of G = W/P threads (P = 16 points a thread
// for W = 2^a, 24 for W = 3*2^a; G <= 32, so a group lies inside one
// warp; float32 at twice the points a thread, 32 and 48, ran 39% slower
// on an H100 at N = 768, at 238 registers).  A thread issues all its P
// loads, each point z[m] one double2 or float2, before it computes, so
// that a group's load reads 16 G (float32: 8 G) contiguous bytes.  The
// W-point transform runs as Stockham stages of radix 16 or 8 and one
// remainder (radix 3 last): two stages at W = 256 (16, 16), three at
// W = 512 (16, 16, 2) and four at W = 384 (8, 8, 2, 3); each stage's
// butterflies sit in registers, and
// the exchange between stages goes through the group's own W-point
// buffer in shared memory behind __syncwarp, with no block-wide barrier.
// The stage twiddles w_W^e are read from the unpack rows of the table
// ((cos, sin)(2 pi k/N), k <= W; w_W^e = w_N^(2e), with w_N^(k+W) =
// -w_N^k).  The untangle (Z[j] with Z[W-j]) reads the buffer; the rows of
// both planes are written by neighbouring threads, so a group's stores
// are coalesced into the (hext)-row lines, with the truncation, the
// Nyquist fold, the zero rows and the scale as in the tile kernel.  The
// launch bound (128 threads; one block an SM in float64, four in float32,
// kLineMinBlocks) leaves a thread 255 or 128 registers, and no stage
// spills.  An input that is not aligned to a
// packed point, N = 2 and inner axes take the tile kernel.
//
// The c2r on whole lines (C and C64, as the dealiased plans' and the DNS
// solvers' backwards call it) takes the same line kernel run backwards
// (irfft_lines_kernel, the r2c's stages with the sign +1) in both
// builds, at the same packed lengths, when its output is aligned to a
// packed point (it reads the spectrum an element at a time): the tile
// kernel spills 1900 B a thread at 80 registers in float64, 1036 B at
// 40 in float32, and ran 1.6x slower than cuFFT's irfft at the float32
// 768^3 last axis on an H100 (PERF.md §6).  The float32 line kernel
// keeps the r2c's budget, four blocks an SM at 128 registers.  Inner
// axes, N = 2 and a misaligned output take the tile kernel.
//
// dct2_axis and dct3_axis: DCT-II (FFTW's REDFT10) and DCT-III (REDFT01)
// along one axis, unnormalized, for N a multiple of 4 of the lengths
// above.  They replace no TPU kernel: the JAX package computes both in jnp
// glue around its r2c and c2r (mpi4py_fft_tpu/ops/core.py:248-290), which
// XLA fuses into its own passes; on the card the same glue ran as about
// ten eager passes over the tensor an axis.  Here each is one pass: the
// r2c body (DCT-II) and the c2r body (DCT-III) with the row map DctRows,
// Makhoul's method (1980) in their read and write.  DCT-II reads
// v = [x[0], x[2], ..., x[N-2], x[N-1], ..., x[3], x[1]], whose packed
// points are z[m] = x[4m] + i x[4m+2] and z[N/2-1-m] = x[4m+3] + i x[4m+1]
// (the line kernel loads the r2c's vectors and places each packed point
// through its group's buffer; the tile places each row), and writes,
// from V[k] = rfft(v)[k], k = 0..N/2, and w_k = e^{-i pi k/2N},
// X[k] = 2 Re(w_k V[k]) and X[N-k] = -2 Im(w_k V[k]) (0 < k < N/2).
// DCT-III reads W[k] = (y[k] - i y[N-k]) e^{+i pi k/2N} (y[N] := 0; the
// imaginary parts of the DC and Nyquist rows are taken as 0, as every
// c2r here takes them) and writes the un-Makhoul x[2m] = v[m],
// x[2m+1] = v[N-1-m] of v = c2r(W).  The rows (cos, sin)(pi k/2N),
// k = 0..N/2, sit in the table between the stage twiddles and the unpack
// rows.  Bound: bytes, N real values read and N written a line.  The row
// map is a template parameter of the bodies, HalfRows (the r2c and c2r
// themselves) by default, and each kind has kernels of its own names, so
// the r2c and c2r instances compile as before.
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

// Row maps of the r2c and c2r bodies.  HalfRows: the r2c and c2r (the
// real line in order, the half spectrum planar).  DctRows: DCT-II on the
// r2c body, DCT-III on the c2r body (see the note at the top): the real
// line in Makhoul's order in the r2c's read and the c2r's write, the
// twiddle combine in the r2c's write and the c2r's read.
struct HalfRows {
  static constexpr bool kDct = false;
};
struct DctRows {
  static constexpr bool kDct = true;
};

// Makhoul's permutation of an n-point DCT line: row k is point makhoul(k)
// of v = [x[0], x[2], ..., x[n-2], x[n-1], ..., x[3], x[1]].
__host__ __device__ __forceinline__ int makhoul(int k, int n) {
  return (k & 1) ? n - 1 - (k >> 1) : k >> 1;
}

// Row j of the packed r2c's spectrum, unscaled, from Z[j] and Z[W - j]:
// V = E + w_N^j O, w_N^j = c - i s.
template <class T>
__device__ __forceinline__ void untangle(T zre, T zie, T zrr, T zir, T c,
                                         T s, T* r, T* i) {
  const T er = T(0.5) * (zre + zrr);
  const T ei = T(0.5) * (zie - zir);
  const T orr = T(0.5) * (zie + zir);
  const T oi = T(0.5) * (zrr - zre);
  *r = er + c * orr + s * oi;
  *i = ei + c * oi - s * orr;
}

// Real (pre, n, post) -> planar (2, pre, hext, post).  W = n/2 when
// packed, else n (n = 2).  Rows >= nrows are zero; fold doubles the real
// part and zeroes the imaginary part of row nrows-1 (even truncation).
// DctRows (packed): real (pre, n, post) -> its DCT-II, times scale / 2.
template <class T, class Map>
__device__ __forceinline__ void rfft_tile(
    const T* __restrict__ x, T* __restrict__ y, const T* __restrict__ tw,
    long long tw_len, long long pre, int n, long long post, int hext,
    int nrows, int fold, int packed, int W, int t2, mff::Plan plan, T scale,
    int lc) {
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
              C, n, Map::kDct ? n : hext, post);
  __syncthreads();

  for (int idx = threadIdx.x; idx < (n << lc); idx += blockDim.x) {
    int c, k;
    tile_index(idx, n, lc, post, &c, &k);
    const long long b = bin[c];
    const T v = b >= 0 ? x[b + k * post] : T(0);
    if constexpr (Map::kDct) {   // z[m] = v[2m] + i v[2m+1]
      const int p = makhoul(k, n);
      ((p & 1) ? t.im : t.re)[(p >> 1) * t.cp + c] = v;
    } else if (packed) {     // z[m] = x[2m] + i x[2m+1]
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

  if constexpr (Map::kDct) {
    // V[j], j = 0..W, gives X[j] = 2 Re(w_j V[j]) and, for 0 < j < W,
    // X[n - j] = -2 Im(w_j V[j]), w_j = cq - i sq = e^{-i pi j/2n}
    const T* cq = twr + t2 - (W + 1);
    const T* sq = twi + t2 - (W + 1);
    for (int idx = threadIdx.x; idx < ((W + 1) << lc); idx += blockDim.x) {
      int c, j;
      tile_index(idx, W + 1, lc, post, &c, &j);
      const long long b = bout[c];
      if (b < 0) continue;
      const int je = (j == W ? 0 : j) * t.cp + c;
      const int jr = (j == 0 ? 0 : W - j) * t.cp + c;
      T r, i;
      untangle(t.re[je], t.im[je], t.re[jr], t.im[jr],
               __ldg(twr + t2 + j), __ldg(twi + t2 + j), &r, &i);
      const T cd = __ldg(cq + j), sd = __ldg(sq + j);
      y[b + j * post] = (cd * r + sd * i) * scale;
      if (j > 0 && j < W) y[b + (n - j) * post] = (sd * r - cd * i) * scale;
    }
    return;
  }
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

template <class T, int kBlocks>
__global__ void __launch_bounds__(mff::Budget<T>::kTile / 16, kBlocks)
rfft_axis_kernel(const T* __restrict__ x, T* __restrict__ y,
                 const T* __restrict__ tw, long long tw_len,
                 long long pre, int n, long long post, int hext, int nrows,
                 int fold, int packed, int W, int t2, mff::Plan plan,
                 T scale, int lc) {
  rfft_tile<T, HalfRows>(x, y, tw, tw_len, pre, n, post, hext, nrows,
                         fold, packed, W, t2, plan, scale, lc);
}

template <class T, int kBlocks>
__global__ void __launch_bounds__(mff::Budget<T>::kTile / 16, kBlocks)
dct2_axis_kernel(const T* __restrict__ x, T* __restrict__ y,
                 const T* __restrict__ tw, long long tw_len,
                 long long pre, int n, long long post, int hext, int nrows,
                 int fold, int packed, int W, int t2, mff::Plan plan,
                 T scale, int lc) {
  rfft_tile<T, DctRows>(x, y, tw, tw_len, pre, n, post, hext, nrows,
                        fold, packed, W, t2, plan, scale, lc);
}

// Planar (2, pre, hin, post) -> real (pre, n, post).  W = n/2 when packed,
// else n (n = 2); the tile holds W + 1 spectrum rows.  The imaginary parts
// of the DC and Nyquist rows are taken as 0: a real output has no
// component for them (sin(pi m) = 0), and FFTW's c2r drops them.  scale
// carries the packed inverse's factor 2.  DctRows (packed, hin = n): real
// (pre, n, post) -> its DCT-III, times scale / 2.
template <class T, class Map>
__device__ __forceinline__ void irfft_tile(
    const T* __restrict__ x, T* __restrict__ y, const T* __restrict__ tw,
    long long tw_len, long long pre, int hin, int n, long long post,
    int packed, int W, int t2, mff::Plan plan, T scale, int lc) {
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

  // read rows 0..nh-1 with the Hermitian zero-padding of a short spectrum;
  // the DC row and (even n) the Nyquist row are read as real.  DctRows:
  // row k is W[k] = (y[k] - i y[n-k]) (cq + i sq), y[n] := 0
  const int nh = n / 2 + 1;
  const bool halve = hin < nh && hin % 2 == 0;
  for (int idx = threadIdx.x; idx < (nh << lc); idx += blockDim.x) {
    int c, k;
    tile_index(idx, nh, lc, post, &c, &k);
    const long long b = bin[c];
    T vr = 0, vi = 0;
    if constexpr (Map::kDct) {
      if (b >= 0) {
        const T yk = x[b + k * post];
        const T ynk = k > 0 ? x[b + (n - k) * post] : T(0);
        const T cd = __ldg(tw + t2 - (W + 1) + k);
        const T sd = __ldg(tw + tw_len + t2 - (W + 1) + k);
        vr = yk * cd + ynk * sd;
        if (k != 0 && k != n / 2) vi = yk * sd - ynk * cd;
      }
    } else if (b >= 0 && k < hin) {
      const long long a = b + k * post;
      vr = x[a];
      vi = x[plane + a];
      if (halve && k == hin - 1) {
        vr = T(0.5) * vr;
        vi = 0;
      }
      if (k == 0 || (n % 2 == 0 && k == n / 2)) vi = 0;
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
    if constexpr (Map::kDct) {   // out[m] = v[makhoul(m)]
      const int p = makhoul(m, n);
      y[b + m * post] = ((p & 1) ? t.im : t.re)[(p >> 1) * t.cp + c] * scale;
      continue;
    }
    // packed: out[2m] = Re z[m], out[2m+1] = Im z[m]; else Re x[m]
    const T v = packed ? ((m & 1) ? t.im : t.re)[(m >> 1) * t.cp + c]
                       : t.re[m * t.cp + c];
    y[b + m * post] = v * scale;
  }
}

template <class T, int kBlocks>
__global__ void __launch_bounds__(mff::Budget<T>::kTile / 16, kBlocks)
irfft_axis_kernel(const T* __restrict__ x, T* __restrict__ y,
                  const T* __restrict__ tw, long long tw_len,
                  long long pre, int hin, int n, long long post, int packed,
                  int W, int t2, mff::Plan plan, T scale, int lc) {
  irfft_tile<T, HalfRows>(x, y, tw, tw_len, pre, hin, n, post, packed,
                          W, t2, plan, scale, lc);
}

template <class T, int kBlocks>
__global__ void __launch_bounds__(mff::Budget<T>::kTile / 16, kBlocks)
dct3_axis_kernel(const T* __restrict__ x, T* __restrict__ y,
                 const T* __restrict__ tw, long long tw_len,
                 long long pre, int hin, int n, long long post, int packed,
                 int W, int t2, mff::Plan plan, T scale, int lc) {
  irfft_tile<T, DctRows>(x, y, tw, tw_len, pre, hin, n, post, packed,
                         W, t2, plan, scale, lc);
}

// ---------------------------------------------------------------------------
// the r2c on whole lines
// ---------------------------------------------------------------------------

constexpr int kLineThreads = 128;

// Blocks an SM the line kernel is bound to: one for float64 (a thread may
// take 255 registers, 168-241 with no spill), four for float32 (128
// registers, no spill; one block an SM ran 22% slower on an H100 at
// N = 768, at 199 registers).
template <class T>
constexpr int kLineMinBlocks = sizeof(T) == 4 ? 4 : 1;

// Blocks an SM the DCT-II and DCT-III line kernels are bound to, in both
// builds: four (128 registers a thread).  At the float64 r2c's bound of
// one block they took 232 (DCT-II) and 164 (DCT-III) registers at W = 256
// and ran 20% and 50% slower than at four, where they match the r2c and
// c2r on an H100 (a 512^3 last axis; three blocks helped DCT-II alone;
// PERF.md section 6).  They spill 16-64 B in float64 DCT-III at W = 24,
// 96 and 192, and 8 B in float32 DCT-III at W = 384, as C does.
constexpr int kDctLineMinBlocks = 4;

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

// One Stockham stage of radix R and sign kSign (-1 forward, +1 inverse)
// over the W-point line of a group, with M sub-transforms interleaved (M:
// the earlier radices' product); thread g of the group owns butterflies
// b = g + G k, k < P/R.  The first stage reads the thread's own points
// (z[g + G s] in zr/zi[s]); the others read the group's buffer.  Every
// stage writes its outputs to the buffer.
template <class T, int W, int R, int M, bool kFirst, int kSign>
__device__ __forceinline__ void line_stage(const T* zr, const T* zi, T* br,
                                           T* bi, int g,
                                           const T* __restrict__ cw,
                                           const T* __restrict__ sw) {
  constexpr int P = line_points(W), G = W / P, K = P / R;
  constexpr int Lq = W / M / R;
  T vr[K][R], vi[K][R];
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
    mff::Dft<R, T>::run(vr[k], vi[k], T(kSign));
    if constexpr (Lq > 1) {    // w_L^(j lp) = w_N^(2 j lp M), of sign kSign
#pragma unroll
      for (int j = 1; j < R; ++j) {
        const int u = 2 * j * lp * M;
        T c, s;
        if (u <= W) {
          c = __ldg(cw + u);
          s = __ldg(sw + u);
        } else {
          c = -__ldg(cw + u - W);
          s = -__ldg(sw + u - W);
        }
        const T yr = vr[k][j], yi = vi[k][j];
        if constexpr (kSign < 0) {     // times c - i s
          vr[k][j] = yr * c + yi * s;
          vi[k][j] = yi * c - yr * s;
        } else {                       // times c + i s
          vr[k][j] = yr * c - yi * s;
          vi[k][j] = yi * c + yr * s;
        }
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

// Stages s.. of a W-point line of sign kSign.
template <class T, int W, int S, int kSign>
__device__ __forceinline__ void line_stages(const T* zr, const T* zi, T* br,
                                            T* bi, int g,
                                            const T* __restrict__ cw,
                                            const T* __restrict__ sw) {
  if constexpr (line_radix(W, S) != 0) {
    line_stage<T, W, line_radix(W, S), line_span(W, S), S == 0, kSign>(
        zr, zi, br, bi, g, cw, sw);
    line_stages<T, W, S + 1, kSign>(zr, zi, br, bi, g, cw, sw);
  }
}

// A packed point z[m] = x[2m] + i x[2m+1]: one double2 or float2.
template <class T> struct Point;
template <> struct Point<float> { using type = float2; };
template <> struct Point<double> { using type = double2; };

// Real (nlines, 2W) -> planar (2, nlines, hext) with the packed W-point
// transform, a group of W/P threads a line (see the note at the top).
// tw: the table of _tw_pack_packed(2W, -1), its unpack rows at t2.
// DctRows: real (nlines, 2W) -> its DCT-II, times scale / 2; the loaded
// vectors go to their packed points through the group's buffer, and the
// table holds the rows (cos, sin)(pi k/4W) at t2 - (W + 1).
template <class T, int W, class Map>
__device__ __forceinline__ void rfft_lines(
    const T* __restrict__ x, T* __restrict__ y, const T* __restrict__ tw,
    long long tw_len, int t2, long long nlines, int hext, int nrows,
    int fold, T scale) {
  constexpr int P = line_points(W), G = W / P;
  extern __shared__ __align__(16) unsigned char smem[];
  const int grp = threadIdx.x / G, g = threadIdx.x % G;
  T* br = reinterpret_cast<T*>(smem) + grp * 2 * W;
  T* bi = br + W;
  const long long line =
      static_cast<long long>(blockIdx.x) * (kLineThreads / G) + grp;
  const bool live = line < nlines;
  const T* cw = tw + t2;
  const T* sw = tw + tw_len + t2;

  // every load first: point g + G s of the line, one vector each
  using V = typename Point<T>::type;
  const V* xz = reinterpret_cast<const V*>(x) + (live ? line : 0) * W;
  T zr[P], zi[P];
#pragma unroll
  for (int s = 0; s < P; ++s) {
    const V v = __ldg(xz + g + G * s);
    if constexpr (Map::kDct) {     // x[2m], x[2m+1]: v[m], v[2W-1-m]
      const int m = g + G * s;
      const int p0 = makhoul(2 * m, 2 * W), p1 = makhoul(2 * m + 1, 2 * W);
      ((p0 & 1) ? bi : br)[p0 >> 1] = v.x;
      ((p1 & 1) ? bi : br)[p1 >> 1] = v.y;
    } else {
      zr[s] = v.x;
      zi[s] = v.y;
    }
  }
  if constexpr (Map::kDct) {
    __syncwarp();
#pragma unroll
    for (int s = 0; s < P; ++s) {
      zr[s] = br[g + G * s];
      zi[s] = bi[g + G * s];
    }
    __syncwarp();   // the group has read the buffer
  }
  line_stages<T, W, 0, -1>(zr, zi, br, bi, g, cw, sw);
  if (!live) return;

  if constexpr (Map::kDct) {
    // V[j], j = 0..W: X[j] = 2 Re(w_j V[j]), X[2W - j] = -2 Im(w_j V[j])
    T* yl = y + line * (2 * W);
    const T* cq = cw - (W + 1);
    const T* sq = sw - (W + 1);
    for (int j = g; j <= W; j += G) {
      const int je = j == W ? 0 : j;
      const int jr = j == 0 ? 0 : W - j;
      T r, i;
      untangle(br[je], bi[je], br[jr], bi[jr], __ldg(cw + j), __ldg(sw + j),
               &r, &i);
      const T cd = __ldg(cq + j), sd = __ldg(sq + j);
      yl[j] = (cd * r + sd * i) * scale;
      if (j > 0 && j < W) yl[2 * W - j] = (sd * r - cd * i) * scale;
    }
    return;
  }
  // untangle Z[j] with Z[W - j] into row j, both planes
  T* yr = y + line * hext;
  T* yi = yr + nlines * hext;
  for (int j = g; j < hext; j += G) {
    T r = 0, i = 0;
    if (j < nrows) {
      const int je = j == W ? 0 : j;
      const int jr = j == 0 ? 0 : W - j;
      const T zre = br[je], zie = bi[je];
      const T zrr = br[jr], zir = bi[jr];
      const T er = T(0.5) * (zre + zrr);
      const T ei = T(0.5) * (zie - zir);
      const T orr = T(0.5) * (zie + zir);
      const T oi = T(0.5) * (zrr - zre);
      const T c = __ldg(cw + j), s = __ldg(sw + j);
      // X = E + w^j O, w^j = c - i s
      r = (er + c * orr + s * oi) * scale;
      i = (ei + c * oi - s * orr) * scale;
      if (fold && j == nrows - 1) {
        r = T(2) * r;
        i = 0;
      }
    }
    yr[j] = r;
    yi[j] = i;
  }
}

template <class T, int W>
__global__ void __launch_bounds__(kLineThreads, kLineMinBlocks<T>)
rfft_lines_kernel(const T* __restrict__ x, T* __restrict__ y,
                  const T* __restrict__ tw, long long tw_len, int t2,
                  long long nlines, int hext, int nrows, int fold,
                  T scale) {
  rfft_lines<T, W, HalfRows>(x, y, tw, tw_len, t2, nlines, hext, nrows, fold,
                             scale);
}

template <class T, int W>
__global__ void __launch_bounds__(kLineThreads, kDctLineMinBlocks)
dct2_lines_kernel(const T* __restrict__ x, T* __restrict__ y,
                  const T* __restrict__ tw, long long tw_len, int t2,
                  long long nlines, int hext, int nrows, int fold,
                  T scale) {
  rfft_lines<T, W, DctRows>(x, y, tw, tw_len, t2, nlines, hext, nrows, fold,
                            scale);
}

// Launches a line kernel of packed length W on nlines lines, buf points
// of both planes a group in shared memory; the kernel takes x, y, tw,
// tw_len, the unpack rows' offset t2 = tw_len - (W + 1), nlines, then
// args.
template <class T, int W, class K, class... A>
int launch_line_kernel(K kern, int buf, const T* x, T* y, const T* tw,
                       long long tw_len, long long nlines,
                       cudaStream_t stream, A... args) {
  constexpr int P = line_points(W), G = W / P;
  static_assert(G <= 32 && 32 % G == 0 && kLineThreads % 32 == 0,
                "a group lies inside one warp");
  constexpr int lines = kLineThreads / G;
  const long long blocks = (nlines + lines - 1) / lines;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = sizeof(T) * 2 * static_cast<size_t>(buf) * lines;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<static_cast<unsigned>(blocks), kLineThreads, smem, stream>>>(
      x, y, tw, tw_len, static_cast<int>(tw_len) - (W + 1), nlines, args...);
  return cudaGetLastError();
}

// f(std::integral_constant<int, W>) for a packed length W of the line
// kernels (every one up to 512), else cudaErrorInvalidValue.
template <class F>
int with_line_length(int W, F f) {
#define MFF_W(w)                                                          \
  case w:                                                                 \
    return f(std::integral_constant<int, w>{})
  switch (W) {
    MFF_W(2); MFF_W(4); MFF_W(8); MFF_W(16); MFF_W(32); MFF_W(64);
    MFF_W(128); MFF_W(256); MFF_W(512); MFF_W(3); MFF_W(6); MFF_W(12);
    MFF_W(24); MFF_W(48); MFF_W(96); MFF_W(192); MFF_W(384);
    default: return cudaErrorInvalidValue;
  }
#undef MFF_W
}

// Planar (2, nlines, hin) -> real (nlines, 2W) by the packed W-point
// inverse, a group of W/P threads a line: the inverse of
// rfft_lines_kernel.  The group loads spectrum rows 0..W of its line
// (rows at or past hin are zero, and row hin-1 is halved with a zero
// imaginary part when hin is even and short of W+1: the Hermitian
// zero-pad in the read; rows 0 and W are read as real, as FFTW's c2r
// and numpy's irfft read them; rows past W are not read) into its
// buffer of W+1 points, every load first; each thread forms its points
// z[g + G s] = E + i O from X[k] and X[W-k] in registers, then the
// inverse stages run as the r2c's, and out[2m], out[2m+1] = Re z[m],
// Im z[m] go out scaled, one packed point a vector.  tw: the table of
// _tw_pack_packed(2W, +1), its unpack rows at t2; scale carries the
// packed inverse's factor 2.  DctRows (hin = 2W): real (nlines, 2W) -> its
// DCT-III, times scale / 2; row k is read from y[k] and y[2W - k], and
// the stores take the points of the un-Makhoul from the buffer.
template <class T, int W, class Map>
__device__ __forceinline__ void irfft_lines(
    const T* __restrict__ x, T* __restrict__ y, const T* __restrict__ tw,
    long long tw_len, int t2, long long nlines, int hin, T scale) {
  constexpr int P = line_points(W), G = W / P;
  extern __shared__ __align__(16) unsigned char smem[];
  const int grp = threadIdx.x / G, g = threadIdx.x % G;
  T* br = reinterpret_cast<T*>(smem) + grp * 2 * (W + 1);
  T* bi = br + W + 1;
  const long long line =
      static_cast<long long>(blockIdx.x) * (kLineThreads / G) + grp;
  const bool live = line < nlines;
  const T* cw = tw + t2;
  const T* sw = tw + tw_len + t2;

  // rows k = g + G s <= W of both planes (P + 1 a thread), every load
  // first
  const T* xr = x + (live ? line : 0) * hin;
  const T* xi = xr + nlines * hin;
  T hr[P + 1], hi[P + 1];
#pragma unroll
  for (int s = 0; s <= P; ++s) {
    const int k = g + G * s;
    hr[s] = hi[s] = T(0);
    if constexpr (Map::kDct) {     // y[k] and y[2W - k] (y[2W] := 0)
      if (k <= W) {
        hr[s] = __ldg(xr + k);
        if (k > 0) hi[s] = __ldg(xr + 2 * W - k);
      }
    } else if (k <= W && k < hin) {
      hr[s] = __ldg(xr + k);
      hi[s] = __ldg(xi + k);
    }
  }
  const bool halve = hin <= W && hin % 2 == 0;
#pragma unroll
  for (int s = 0; s <= P; ++s) {
    const int k = g + G * s;
    if (k > W) continue;
    if constexpr (Map::kDct) {     // W[k] = (y[k] - i y[2W-k]) (cq + i sq)
      const T yk = hr[s], ynk = hi[s];
      const T cd = __ldg(cw - (W + 1) + k), sd = __ldg(sw - (W + 1) + k);
      hr[s] = yk * cd + ynk * sd;
      hi[s] = yk * sd - ynk * cd;
    }
    if (halve && k == hin - 1) {
      hr[s] = T(0.5) * hr[s];
      hi[s] = T(0);
    }
    if (k == 0 || k == W) hi[s] = T(0);   // real DC and Nyquist rows
    br[k] = hr[s];
    bi[k] = hi[s];
  }
  __syncwarp();

  // Z[k] = E[k] + i O[k]: E = (X[k] + conj X[W-k]) / 2,
  // O = w_N^k (X[k] - conj X[W-k]) / 2
  T zr[P], zi[P];
#pragma unroll
  for (int s = 0; s < P; ++s) {
    const int k = g + G * s;
    const T xrh = br[k], xih = bi[k];
    const T xrr = br[W - k], xir = bi[W - k];
    const T er = T(0.5) * (xrh + xrr);
    const T ei = T(0.5) * (xih - xir);
    const T dr = xrh - xrr;
    const T di = xih + xir;
    const T c = __ldg(cw + k), sn = __ldg(sw + k);
    const T ore = T(0.5) * (c * dr - sn * di);
    const T oim = T(0.5) * (c * di + sn * dr);
    zr[s] = er - oim;
    zi[s] = ei + ore;
  }
  __syncwarp();   // the group has read the buffer
  line_stages<T, W, 0, +1>(zr, zi, br, bi, g, cw, sw);
  if (!live) return;

  using V = typename Point<T>::type;
  V* yz = reinterpret_cast<V*>(y) + line * W;
  if constexpr (Map::kDct) {       // out[2m], out[2m+1] = v[m], v[2W-1-m]
    for (int m = g; m < W; m += G) {
      const int p0 = makhoul(2 * m, 2 * W), p1 = makhoul(2 * m + 1, 2 * W);
      yz[m] = V{((p0 & 1) ? bi : br)[p0 >> 1] * scale,
                ((p1 & 1) ? bi : br)[p1 >> 1] * scale};
    }
    return;
  }
  for (int m = g; m < W; m += G) yz[m] = V{br[m] * scale, bi[m] * scale};
}

template <class T, int W>
__global__ void __launch_bounds__(kLineThreads, kLineMinBlocks<T>)
irfft_lines_kernel(const T* __restrict__ x, T* __restrict__ y,
                   const T* __restrict__ tw, long long tw_len, int t2,
                   long long nlines, int hin, T scale) {
  irfft_lines<T, W, HalfRows>(x, y, tw, tw_len, t2, nlines, hin, scale);
}

template <class T, int W>
__global__ void __launch_bounds__(kLineThreads, kDctLineMinBlocks)
dct3_lines_kernel(const T* __restrict__ x, T* __restrict__ y,
                  const T* __restrict__ tw, long long tw_len, int t2,
                  long long nlines, int hin, T scale) {
  irfft_lines<T, W, DctRows>(x, y, tw, tw_len, t2, nlines, hin, scale);
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

// The r2c (HalfRows) or DCT-II (DctRows, packed, with the DCT rows in tw).
template <class T, class Map = HalfRows>
int launch_rfft_axis(const T* x, T* y, const T* tw, long long tw_len,
                     long long pre, int n, long long post, int hext,
                     int nrows, int fold, int packed, const int* plan,
                     int nstages, T scale, void* stream) {
  const int W = packed ? n / 2 : n;
  mff::Plan p;
  if (!mff::make_plan(plan, nstages, W, &p) || hext < nrows)
    return cudaErrorInvalidValue;
  // whole lines of a packed length, aligned to a packed point (2
  // elements): the line kernel (its own stage plan; tw's unpack rows give
  // every twiddle)
  if (post == 1 && packed &&
      reinterpret_cast<std::uintptr_t>(x) % (2 * sizeof(T)) == 0) {
    if (pre <= 0 || tw_len < W + 1) return cudaErrorInvalidValue;
    return with_line_length(W, [&](auto w) {
      constexpr int kW = decltype(w)::value;
      return launch_line_kernel<T, kW>(
          Map::kDct ? &dct2_lines_kernel<T, kW> : &rfft_lines_kernel<T, kW>,
          kW, x, y, tw, tw_len, pre, static_cast<cudaStream_t>(stream), hext,
          nrows, fold, scale);
    });
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
  auto kern =
      Map::kDct
          ? mff::pick_bound<T>(smem, &dct2_axis_kernel<T, B::kMinBlocks>,
                               &dct2_axis_kernel<T, B::kWideMinBlocks>)
          : mff::pick_bound<T>(smem, &rfft_axis_kernel<T, B::kMinBlocks>,
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

// The c2r (HalfRows) or DCT-III (DctRows, packed, hin = n, with the DCT
// rows in tw).
template <class T, class Map = HalfRows>
int launch_irfft_axis(const T* x, T* y, const T* tw, long long tw_len,
                      long long pre, int hin, int n, long long post,
                      int packed, const int* plan, int nstages, T scale,
                      void* stream) {
  const int W = packed ? n / 2 : n;
  mff::Plan p;
  if (!mff::make_plan(plan, nstages, W, &p) || hin < 1)
    return cudaErrorInvalidValue;
  // whole lines of a packed length, the output aligned to a packed
  // point (16 bytes in float64, 8 in float32; the kernel stores one a
  // vector and reads the spectrum an element at a time): the c2r line
  // kernel
  if (post == 1 && packed &&
      reinterpret_cast<std::uintptr_t>(y) % (2 * sizeof(T)) == 0) {
    if (pre <= 0 || tw_len < W + 1) return cudaErrorInvalidValue;
    return with_line_length(W, [&](auto w) {
      constexpr int kW = decltype(w)::value;
      return launch_line_kernel<T, kW>(
          Map::kDct ? &dct3_lines_kernel<T, kW> : &irfft_lines_kernel<T, kW>,
          kW + 1, x, y, tw, tw_len, pre, static_cast<cudaStream_t>(stream),
          hin, scale);
    });
  }
  int lc, threads;
  long long blocks;
  if (!launch_shape<T>(W, pre * post, &lc, &blocks, &threads))
    return cudaErrorInvalidValue;
  const int t2 = packed ? static_cast<int>(tw_len) - (W + 1) : 0;
  const int C = 1 << lc;
  const size_t smem = 2 * sizeof(long long) * C +
                      2 * sizeof(T) * static_cast<size_t>(W + 1) * (C + 1);
  using B = mff::Budget<T>;
  auto kern =
      Map::kDct
          ? mff::pick_bound<T>(smem, &dct3_axis_kernel<T, B::kMinBlocks>,
                               &dct3_axis_kernel<T, B::kWideMinBlocks>)
          : mff::pick_bound<T>(smem, &irfft_axis_kernel<T, B::kMinBlocks>,
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

// DCT-II (kInverse false) or DCT-III of (pre, n, post) along n, scaled by
// 2 (FFTW's REDFT10 and REDFT01): n a packed length and a multiple of 4,
// tw the table of _tw_pack_dct(n, -1 or +1), whose DCT rows lie before
// the n/2 + 1 unpack rows.
template <class T, bool kInverse>
int launch_dct(const T* x, T* y, const T* tw, long long tw_len,
               long long pre, int n, long long post, const int* plan,
               int nstages, void* stream) {
  const int h = n / 2 + 1;
  if (n < 4 || n % 4 != 0 || tw_len < 2 * h) return cudaErrorInvalidValue;
  if (kInverse)
    return launch_irfft_axis<T, DctRows>(x, y, tw, tw_len, pre, n, n, post,
                                         1, plan, nstages, T(2), stream);
  return launch_rfft_axis<T, DctRows>(x, y, tw, tw_len, pre, n, post, h, h,
                                      0, 1, plan, nstages, T(2), stream);
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

// x, y: (pre, n, post) float32, contiguous on the current device; y = the
// DCT-II of x along n (FFTW's REDFT10).  tw: (2, tw_len),
// _tw_pack_dct(n, -1).  n a multiple of 4 of the packed lengths.  Returns
// cudaGetLastError().
extern "C" int mff_dct2_axis_f32(const float* x, float* y, const float* tw,
                                 long long tw_len, long long pre, int n,
                                 long long post, const int* plan,
                                 int nstages, void* stream) {
  return launch_dct<float, false>(x, y, tw, tw_len, pre, n, post, plan,
                                  nstages, stream);
}

// The same for float64 x, y and tw.
extern "C" int mff_dct2_axis_f64(const double* x, double* y,
                                 const double* tw, long long tw_len,
                                 long long pre, int n, long long post,
                                 const int* plan, int nstages,
                                 void* stream) {
  return launch_dct<double, false>(x, y, tw, tw_len, pre, n, post, plan,
                                   nstages, stream);
}

// x, y: (pre, n, post) float32, contiguous on the current device; y = the
// DCT-III of x along n (FFTW's REDFT01).  tw: (2, tw_len),
// _tw_pack_dct(n, +1).  n a multiple of 4 of the packed lengths.  Returns
// cudaGetLastError().
extern "C" int mff_dct3_axis_f32(const float* x, float* y, const float* tw,
                                 long long tw_len, long long pre, int n,
                                 long long post, const int* plan,
                                 int nstages, void* stream) {
  return launch_dct<float, true>(x, y, tw, tw_len, pre, n, post, plan,
                                 nstages, stream);
}

// The same for float64 x, y and tw.
extern "C" int mff_dct3_axis_f64(const double* x, double* y,
                                 const double* tw, long long tw_len,
                                 long long pre, int n, long long post,
                                 const int* plan, int nstages,
                                 void* stream) {
  return launch_dct<double, true>(x, y, tw, tw_len, pre, n, post, plan,
                                  nstages, stream);
}
