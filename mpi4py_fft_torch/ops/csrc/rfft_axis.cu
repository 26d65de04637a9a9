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
#include <cstdint>

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
