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
// packed point and N = 2 take the tile kernel.
//
// The c2r on whole lines (C and C64, as the dealiased plans' and the DNS
// solvers' backwards call it) takes the same line kernel run backwards
// (irfft_lines_kernel, the r2c's stages with the sign +1) in both
// builds, at the same packed lengths, when its output is aligned to a
// packed point (it reads the spectrum an element at a time): the tile
// kernel spills 1900 B a thread at 80 registers in float64, 1036 B at
// 40 in float32, and ran 1.6x slower than cuFFT's irfft at the float32
// 768^3 last axis on an H100 (PERF.md §6).  The float32 line kernel
// keeps the r2c's budget, four blocks an SM at 128 registers.  N = 2 and
// a misaligned output take the tile kernel.
//
// Inner axes (post > 1) at N = 512, 768 and 1024, with post a multiple
// of a 16-byte vector (2 doubles, 4 floats) and both tensors 16-byte
// aligned, take a column band in every kind (rfft_band_kernel,
// irfft_band_kernel, dct2_band_kernel, dct3_band_kernel), both builds;
// other lengths, a ragged post and misaligned tensors keep the tile.  On
// the r2r cell's 512^3 float64 passes the tile ran at 22-25% of HBM3
// (2.5-2.7 ms a pass on an H100: its spill, eight block-wide barriers a
// pass and one-element loads, 64-byte row segments of one column each).
// The band is A's (lines.cuh axis_band) re-read for the packed method:
// one CTA of AxisBandBudget's 256 threads, three an SM, holds the W = N/2
// packed points of C = 2^lc adjacent lines in shared memory
// (band_log2_cols(W): float64 16 columns at W = 256, 8 at 384 and 512;
// float32 32 and 16), so that the untangle's partner row W - j is in the
// same CTA and no cluster step is needed.  Every load comes first, in
// rounds, as 16-byte vectors of adjacent columns (row segments of 128
// bytes at W = 256); the row work of the tile happens in the read and
// the write: the r2c packs z[m] = x[2m] + i x[2m+1] as it stores the
// loaded rows (DCT-II: Makhoul's point), then runs lines.cuh's in-place
// decimation-in-frequency stages (radix 8, a radix-3 stage first at
// W = 384) with the twiddles w_W^e = w_N^(2e) read from the unpack rows
// (HalfPowers: no new table), and untangles Z[j] with Z[W - j] in its
// write (the truncation, Nyquist fold, zero rows and scale; DCT-II: rows
// j and N - j); the c2r reads the spectrum with the Hermitian pad and
// real DC and Nyquist rows (DCT-III: y[k] and y[N - k]), forms Z[k] and
// Z[W - k] of each pair in place, one thread a pair, runs the inverse
// stages and interleaves the real rows in its write (DCT-III: the
// inverse Makhoul order).  Bound: bytes.  On an H100 every band instance
// takes 77-80 registers with no spill, and the 512^3 float64 passes run
// in 1.01-1.09 ms, 59-64% of HBM3 (a block_copy of the same boxes: 0.79
// ms on axis 0, 0.94 on axis 1; PERF.md §6); float32 in 0.60-0.73 ms
// against the tile's 1.29-1.41.
//
// dct2_axis and dct3_axis: DCT-II (FFTW's REDFT10) and DCT-III (REDFT01)
// along one axis, unnormalized, for N a multiple of 4 of the lengths
// above.  They replace no TPU kernel: the JAX package computes both in jnp
// glue around its r2c and c2r (mpi4py_fft_tpu/ops/core.py:248-290), which
// XLA fuses into its own passes; on the card the same glue ran as about
// ten eager passes over the tensor an axis.  Here each is one pass: the
// r2c bodies (DCT-II) and the c2r bodies (DCT-III: lines, band, tile)
// with the row map DctRows,
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

#include "lines.cuh"

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

// ---------------------------------------------------------------------------
// inner axes (post > 1): the column band
// ---------------------------------------------------------------------------

using mff::AxisBandBudget;

// w_W^e of sign `sign` (-1 forward, +1 inverse), e < W, for the band's
// stages, from the unpack rows (c, s) = (cos, sin)(2 pi u / 2W), u <= W:
// w_W^e = w_2W^(2e), and w_2W^(u + W) = -w_2W^u.
template <class T>
struct HalfPowers {
  const T* __restrict__ c;
  const T* __restrict__ s;
  int W;
  T sign;
  __device__ __forceinline__ void operator()(int e, T* wr, T* wi) const {
    const int u = 2 * e;
    const bool hi = u > W;
    const int v = hi ? u - W : u;
    const T f = hi ? -sign : sign;
    *wr = (hi ? T(-1) : T(1)) * __ldg(c + v);
    *wi = f * __ldg(s + v);
  }
};

// The packed lengths that take the band: W = 256, 384 and 512 (N = 512,
// 768 and 1024, A's band lengths).
constexpr bool band_length(int W) {
  return W == 256 || W == 384 || W == 512;
}

// A thread's column of the band: band blockIdx.x of C = 2^lc adjacent
// lines of the (pre, post) lines, thread t on columns V t .. mod C (V
// t + j V kThreads keeps the column, as kThreads V is a multiple of C).
struct BandLine {
  int c;            // the column in the band
  bool live;        // a line of the axis (the last band may be ragged)
  long long li;     // its pre index
  long long col;    // its post index
};

template <class T>
__device__ __forceinline__ BandLine band_line(long long pre, long long post,
                                              int lc) {
  constexpr int V = mff::kVec16<T>;
  BandLine b;
  b.c = (V * static_cast<int>(threadIdx.x)) & ((1 << lc) - 1);
  const long long l = (static_cast<long long>(blockIdx.x) << lc) + b.c;
  b.live = l < pre * post;
  b.li = b.live ? l / post : 0;
  b.col = b.live ? l - b.li * post : 0;
  return b;
}

// Real (pre, n, post) -> planar (2, pre, hext, post), n = 2W, W = kB 2^lr,
// post > 1 a multiple of V = 16 / sizeof(T), x and y 16-byte aligned: the
// C = 2^lc adjacent lines of band blockIdx.x as W x C packed points in
// shared memory (smem: band_smem(W, lc)), one CTA a band (see the note at
// the top).  Every load first: real row r of the band, V columns a
// vector, to packed point r/2, component r % 2 (DctRows: Makhoul's point
// makhoul(r, n)); then the W-point columns as lines.cuh's in-place
// stages (a radix-3 stage first when kB = 3), the twiddles from the
// unpack rows; then row j < hext of both planes from Z[j] and Z[W - j]
// (untangle), with the truncation to nrows, the Nyquist fold, the zero
// rows and the scale, as the tile.  DctRows (hext = nrows = W + 1): rows
// j and n - j of the real output, X[j] = 2 Re(w_j V[j]) and
// X[n - j] = -2 Im(w_j V[j]), times scale / 2.  tw: the table of
// _tw_pack_packed(n, -1) (DctRows: _tw_pack_dct), its unpack rows at t2.
template <class T, int kB, class Map>
__device__ __forceinline__ void rfft_band(
    const T* __restrict__ x, T* __restrict__ y, const T* __restrict__ tw,
    long long tw_len, int t2, long long pre, long long post, int hext,
    int nrows, int fold, T scale, int lr, int lc, T* smem) {
  using B = AxisBandBudget<T>;
  using U = typename mff::Vec16<T>::type;
  constexpr int V = mff::kVec16<T>;
  const int C = 1 << lc, W = kB << lr, n = 2 * W;
  mff::Block<T> k{smem, nullptr, 0, lr, lc, mff::row_stride(C)};
  k.im = k.re + W * k.rs;
  const BandLine bl = band_line<T>(pre, post, lc);
  const T* xl = x + bl.li * n * post + bl.col;
  const T* cw = tw + t2;
  const T* sw = tw + tw_len + t2;

  // every load first: a thread's vectors of rows r, in rounds
  constexpr int kVecs = 2 * B::kElems / V / B::kThreads;
  constexpr int kRound = 2 * B::kRound;
  const int elems = n << lc;
#pragma unroll
  for (int j0 = 0; j0 < kVecs; j0 += kRound) {
    T v[kRound][V];
#pragma unroll
    for (int j = 0; j < kRound; ++j) {
      const int e = V * (static_cast<int>(threadIdx.x) +
                         (j0 + j) * B::kThreads);
#pragma unroll
      for (int cc = 0; cc < V; ++cc) v[j][cc] = T(0);
      if (bl.live && e < elems)
        mff::Vec16<T>::split(
            __ldcg(reinterpret_cast<const U*>(
                xl + static_cast<long long>(e >> lc) * post)),
            v[j]);
    }
#pragma unroll
    for (int j = 0; j < kRound; ++j) {
      const int e = V * (static_cast<int>(threadIdx.x) +
                         (j0 + j) * B::kThreads);
      if (e >= elems) continue;
      const int r = e >> lc;
      const int p = Map::kDct ? makhoul(r, n) : r;
      T* d = (p & 1) ? k.im : k.re;
#pragma unroll
      for (int cc = 0; cc < V; ++cc)
        d[mff::at<true>(k, p >> 1, bl.c + cc)] = v[j][cc];
    }
  }
  __syncthreads();

  const HalfPowers<T> w{cw, sw, W, T(-1)};
  if constexpr (kB == 3) mff::dif_stage3(k, lc, lr, 0, w, T(-1));
  mff::dif_pass<false, kB>(k, lc, lr, 0, w, T(-1));
  if (!bl.live) return;

  // V[j] = E + w_n^j O from Z[j] (Z[W] = Z[0]) and Z[(W - j) % W], which
  // the stages left at rows dif_pos_b of their frequencies
  const auto spec = [&](int j, int cc, T* r, T* i) {
    const int se = mff::at<true>(
        k, mff::dif_pos_b<kB>(j == W ? 0 : j, lr), bl.c + cc);
    const int sr = mff::at<true>(
        k, mff::dif_pos_b<kB>(j == 0 ? 0 : W - j, lr), bl.c + cc);
    untangle(k.re[se], k.im[se], k.re[sr], k.im[sr], __ldg(cw + j),
             __ldg(sw + j), r, i);
  };
  if constexpr (Map::kDct) {
    T* yl = y + bl.li * n * post + bl.col;
    const T* cq = cw - (W + 1);
    const T* sq = sw - (W + 1);
    for (int e = V * static_cast<int>(threadIdx.x); e < ((W + 1) << lc);
         e += V * B::kThreads) {
      const int j = e >> lc;
      const T cd = __ldg(cq + j), sd = __ldg(sq + j);
      T lo[V], hi[V];
#pragma unroll
      for (int cc = 0; cc < V; ++cc) {
        T r, i;
        spec(j, cc, &r, &i);
        lo[cc] = (cd * r + sd * i) * scale;
        hi[cc] = (sd * r - cd * i) * scale;
      }
      *reinterpret_cast<U*>(yl + static_cast<long long>(j) * post) =
          mff::Vec16<T>::make(lo);
      if (j > 0 && j < W)
        *reinterpret_cast<U*>(yl + static_cast<long long>(n - j) * post) =
            mff::Vec16<T>::make(hi);
    }
    return;
  }
  T* yl = y + bl.li * hext * post + bl.col;
  const long long plane = pre * hext * post;
  for (int e = V * static_cast<int>(threadIdx.x); e < (hext << lc);
       e += V * B::kThreads) {
    const int j = e >> lc;
    T vr[V], vi[V];
#pragma unroll
    for (int cc = 0; cc < V; ++cc) {
      T r = 0, i = 0;
      if (j < nrows) {
        spec(j, cc, &r, &i);
        r *= scale;
        i *= scale;
        if (fold && j == nrows - 1) {
          r = T(2) * r;
          i = 0;
        }
      }
      vr[cc] = r;
      vi[cc] = i;
    }
    T* q = yl + static_cast<long long>(j) * post;
    *reinterpret_cast<U*>(q) = mff::Vec16<T>::make(vr);
    *reinterpret_cast<U*>(q + plane) = mff::Vec16<T>::make(vi);
  }
}

template <class T, int kB>
__global__ void __launch_bounds__(AxisBandBudget<T>::kThreads,
                                  AxisBandBudget<T>::kMinBlocks)
rfft_band_kernel(const T* __restrict__ x, T* __restrict__ y,
                 const T* __restrict__ tw, long long tw_len, int t2,
                 long long pre, long long post, int hext, int nrows,
                 int fold, T scale, int lr, int lc) {
  extern __shared__ __align__(16) unsigned char smem[];
  rfft_band<T, kB, HalfRows>(x, y, tw, tw_len, t2, pre, post, hext, nrows,
                             fold, scale, lr, lc,
                             reinterpret_cast<T*>(smem));
}

template <class T, int kB>
__global__ void __launch_bounds__(AxisBandBudget<T>::kThreads,
                                  AxisBandBudget<T>::kMinBlocks)
dct2_band_kernel(const T* __restrict__ x, T* __restrict__ y,
                 const T* __restrict__ tw, long long tw_len, int t2,
                 long long pre, long long post, int hext, int nrows,
                 int fold, T scale, int lr, int lc) {
  extern __shared__ __align__(16) unsigned char smem[];
  rfft_band<T, kB, DctRows>(x, y, tw, tw_len, t2, pre, post, hext, nrows,
                            fold, scale, lr, lc, reinterpret_cast<T*>(smem));
}

// Planar (2, pre, hin, post) -> real (pre, n, post), n = 2W, W = kB 2^lr,
// on the band of rfft_band (smem: band_smem(W + 1, lc)), the inverse of
// it.  Every load first: spectrum rows k <= W of both planes, V columns a
// vector, with the tile's Hermitian zero-pad (rows at or past hin are
// zero, read from no memory; row hin - 1 is halved with a zero imaginary
// part when hin is even and short of W + 1) and the DC and Nyquist rows
// read as real; then each thread forms Z[k] = E + i O and Z[W - k] of a
// pair of rows k <= W/2 in place; the inverse stages; and real row r of
// the output, V columns a vector, from packed point r/2, component r % 2
// (DctRows: Makhoul's point makhoul(r, n)), scaled.  DctRows (hin = n,
// real x): row k is read from y[k] (rows r <= W) and y[n - k] (rows
// r > W), and the pair step first forms X[k] = (y[k] - i y[n - k])
// (cq + i sq), y[n] := 0, with a zero imaginary part at k = 0 and W, as
// the tile; times scale / 2.  tw: the table of _tw_pack_packed(n, +1)
// (DctRows: _tw_pack_dct), its unpack rows at t2; scale carries the
// packed inverse's factor 2.
template <class T, int kB, class Map>
__device__ __forceinline__ void irfft_band(
    const T* __restrict__ x, T* __restrict__ y, const T* __restrict__ tw,
    long long tw_len, int t2, long long pre, int hin, long long post,
    T scale, int lr, int lc, T* smem) {
  using B = AxisBandBudget<T>;
  using U = typename mff::Vec16<T>::type;
  constexpr int V = mff::kVec16<T>;
  const int C = 1 << lc, W = kB << lr, n = 2 * W;
  mff::Block<T> k{smem, nullptr, 0, lr, lc, mff::row_stride(C)};
  k.im = k.re + (W + 1) * k.rs;
  const BandLine bl = band_line<T>(pre, post, lc);
  const T* cw = tw + t2;
  const T* sw = tw + tw_len + t2;

  // every load first, in rounds of B::kRound chunks.  HalfRows: chunk e
  // is row e >> lc <= W of both planes; DctRows: chunk e is real rows
  // e >> lc and (e >> lc) + n/2 of y, to re and im of packed rows k and
  // n - k (row W to re)
  constexpr int kChunks = (B::kElems / V + B::kThreads - 1) / B::kThreads + 1;
  const int rows = Map::kDct ? W : W + 1;
  const int elems = rows << lc;
  const long long xrow = Map::kDct ? n : hin;
  const T* xa = x + bl.li * xrow * post + bl.col;
  const T* xb = Map::kDct ? xa + static_cast<long long>(W) * post
                          : xa + pre * hin * post;
  const bool halve = hin <= W && hin % 2 == 0;
#pragma unroll
  for (int j0 = 0; j0 < kChunks; j0 += B::kRound) {
    T vr[B::kRound][V], vi[B::kRound][V];
#pragma unroll
    for (int j = 0; j < B::kRound; ++j) {
      const int e = V * (static_cast<int>(threadIdx.x) +
                         (j0 + j) * B::kThreads);
      const int r = e >> lc;
#pragma unroll
      for (int cc = 0; cc < V; ++cc) vr[j][cc] = vi[j][cc] = T(0);
      if (bl.live && e < elems && (Map::kDct || r < hin)) {
        const long long o = static_cast<long long>(r) * post;
        mff::Vec16<T>::split(__ldcg(reinterpret_cast<const U*>(xa + o)),
                             vr[j]);
        mff::Vec16<T>::split(__ldcg(reinterpret_cast<const U*>(xb + o)),
                             vi[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < B::kRound; ++j) {
      const int e = V * (static_cast<int>(threadIdx.x) +
                         (j0 + j) * B::kThreads);
      if (e >= elems) continue;
      const int r = e >> lc;
#pragma unroll
      for (int cc = 0; cc < V; ++cc) {
        if constexpr (Map::kDct) {
          // y[r] is re of row r; y[r + W] is re of row W (r = 0) or im
          // of row n - r - W = W - r
          k.re[mff::at<true>(k, r, bl.c + cc)] = vr[j][cc];
          if (r == 0)
            k.re[mff::at<true>(k, W, bl.c + cc)] = vi[j][cc];
          else
            k.im[mff::at<true>(k, W - r, bl.c + cc)] = vi[j][cc];
        } else {
          T a = vr[j][cc], b = vi[j][cc];
          if (halve && r == hin - 1) {
            a = T(0.5) * a;
            b = T(0);
          }
          if (r == 0 || r == W) b = T(0);   // real DC and Nyquist rows
          const int s = mff::at<true>(k, r, bl.c + cc);
          k.re[s] = a;
          k.im[s] = b;
        }
      }
    }
  }
  __syncthreads();

  // Z[q] = E + i O for the pair q = kk, W - kk: E = (X[q] + conj
  // X[W-q]) / 2, O = w_n^q (X[q] - conj X[W-q]) / 2; no other thread
  // reads or writes these rows of these columns
  const T* cq = cw - (W + 1);
  const T* sq = sw - (W + 1);
  for (int e = V * static_cast<int>(threadIdx.x); e < ((W / 2 + 1) << lc);
       e += V * B::kThreads) {
    const int kk = e >> lc;
#pragma unroll
    for (int cc = 0; cc < V; ++cc) {
      const int s0 = mff::at<true>(k, kk, bl.c + cc);
      const int s1 = mff::at<true>(k, W - kk, bl.c + cc);
      T ar = k.re[s0], ai = k.im[s0], br = k.re[s1], bi = k.im[s1];
      if constexpr (Map::kDct) {   // X[q] = (y[q] - i y[n-q]) (cq + i sq)
        const auto comb = [&](int q, T yq, T ynq, T* xr, T* xi) {
          const T cd = __ldg(cq + q), sd = __ldg(sq + q);
          *xr = yq * cd + ynq * sd;
          *xi = q == 0 || q == W ? T(0) : yq * sd - ynq * cd;
        };
        // y[n] := 0 at q = 0; y[n - W] = y[W] at q = W
        comb(kk, ar, kk == 0 ? T(0) : ai, &ar, &ai);
        comb(W - kk, br, kk == 0 ? br : bi, &br, &bi);
      }
      const auto half = [&](int q, T xr, T xi, T rr, T ri, T* zr, T* zi) {
        const T er = T(0.5) * (xr + rr);
        const T ei = T(0.5) * (xi - ri);
        const T dr = xr - rr;
        const T di = xi + ri;
        const T c = __ldg(cw + q), sn = __ldg(sw + q);
        *zr = er - T(0.5) * (c * di + sn * dr);
        *zi = ei + T(0.5) * (c * dr - sn * di);
      };
      T zr, zi;
      half(kk, ar, ai, br, bi, &zr, &zi);
      if (kk > 0 && kk < W / 2) {
        T wr, wi;
        half(W - kk, br, bi, ar, ai, &wr, &wi);
        k.re[s1] = wr;
        k.im[s1] = wi;
      }
      k.re[s0] = zr;
      k.im[s0] = zi;
    }
  }
  __syncthreads();

  const HalfPowers<T> w{cw, sw, W, T(1)};
  if constexpr (kB == 3) mff::dif_stage3(k, lc, lr, 0, w, T(1));
  mff::dif_pass<false, kB>(k, lc, lr, 0, w, T(1));
  if (!bl.live) return;

  // out[r] = component r % 2 of z[r / 2] (DctRows: v[makhoul(r, n)])
  T* yl = y + bl.li * n * post + bl.col;
  for (int e = V * static_cast<int>(threadIdx.x); e < (n << lc);
       e += V * B::kThreads) {
    const int r = e >> lc;
    const int p = Map::kDct ? makhoul(r, n) : r;
    const T* src = (p & 1) ? k.im : k.re;
    const int m = mff::dif_pos_b<kB>(p >> 1, lr);
    T v[V];
#pragma unroll
    for (int cc = 0; cc < V; ++cc)
      v[cc] = src[mff::at<true>(k, m, bl.c + cc)] * scale;
    *reinterpret_cast<U*>(yl + static_cast<long long>(r) * post) =
        mff::Vec16<T>::make(v);
  }
}

template <class T, int kB>
__global__ void __launch_bounds__(AxisBandBudget<T>::kThreads,
                                  AxisBandBudget<T>::kMinBlocks)
irfft_band_kernel(const T* __restrict__ x, T* __restrict__ y,
                  const T* __restrict__ tw, long long tw_len, int t2,
                  long long pre, int hin, long long post, T scale, int lr,
                  int lc) {
  extern __shared__ __align__(16) unsigned char smem[];
  irfft_band<T, kB, HalfRows>(x, y, tw, tw_len, t2, pre, hin, post, scale,
                              lr, lc, reinterpret_cast<T*>(smem));
}

template <class T, int kB>
__global__ void __launch_bounds__(AxisBandBudget<T>::kThreads,
                                  AxisBandBudget<T>::kMinBlocks)
dct3_band_kernel(const T* __restrict__ x, T* __restrict__ y,
                 const T* __restrict__ tw, long long tw_len, int t2,
                 long long pre, int hin, long long post, T scale, int lr,
                 int lc) {
  extern __shared__ __align__(16) unsigned char smem[];
  irfft_band<T, kB, DctRows>(x, y, tw, tw_len, t2, pre, hin, post, scale,
                             lr, lc, reinterpret_cast<T*>(smem));
}

// Whether a pass of packed length W with post columns of x into y takes
// the band: W a band length, post a multiple of a 16-byte vector and
// both tensors 16-byte aligned (so no vector straddles two pre rows).
template <class T>
bool takes_band(int W, long long post, const void* x, const void* y) {
  return band_length(W) && post % mff::kVec16<T> == 0 &&
         reinterpret_cast<std::uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<std::uintptr_t>(y) % 16 == 0;
}

// A band launch of packed length W: kern<T, 1> or, at W = 3 2^a,
// kern<T, 3>, one CTA a band of C = 2^lc lines (band_log2_cols(W): 16
// columns in float64 and 32 in float32 at W = 256, half that at 384 and
// 512), `rows` rows of shared memory; the kernel takes x, y, tw, tw_len,
// the unpack rows' offset t2 = tw_len - (W + 1), then args, then lr, lc.
template <class T, class K, class... A>
int launch_band(K k1, K k3, int W, int rows, long long lines, const T* x,
                T* y, const T* tw, long long tw_len, cudaStream_t stream,
                A... args) {
  const bool three = W % 3 == 0;
  const int lr = mff::log2_of(three ? W / 3 : W);
  const int lc = mff::band_log2_cols<T>(W);
  return mff::launch_ex(three ? k3 : k1, (lines + (1 << lc) - 1) >> lc,
                        AxisBandBudget<T>::kThreads,
                        mff::band_smem<T>(rows, lc), 1, stream, x, y, tw,
                        tw_len, static_cast<int>(tw_len) - (W + 1), args...,
                        lr, lc);
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
  // inner axes of a band length, aligned to a vector: the column band
  if (post > 1 && packed && takes_band<T>(W, post, x, y)) {
    if (pre <= 0 || tw_len < W + 1) return cudaErrorInvalidValue;
    return launch_band<T>(
        Map::kDct ? &dct2_band_kernel<T, 1> : &rfft_band_kernel<T, 1>,
        Map::kDct ? &dct2_band_kernel<T, 3> : &rfft_band_kernel<T, 3>, W, W,
        pre * post, x, y, tw, tw_len, static_cast<cudaStream_t>(stream),
        pre, post, hext, nrows, fold, scale);
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
  // inner axes of a band length, aligned to a vector: the column band
  if (post > 1 && packed && takes_band<T>(W, post, x, y)) {
    if (pre <= 0 || tw_len < W + 1) return cudaErrorInvalidValue;
    return launch_band<T>(
        Map::kDct ? &dct3_band_kernel<T, 1> : &irfft_band_kernel<T, 1>,
        Map::kDct ? &dct3_band_kernel<T, 3> : &irfft_band_kernel<T, 3>, W,
        W + 1, pre * post, x, y, tw, tw_len,
        static_cast<cudaStream_t>(stream), pre, hin, post, scale);
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
