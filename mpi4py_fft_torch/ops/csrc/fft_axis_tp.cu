// fft_axis_tp: planar c2c Stockham FFT along one axis with the 3/2-rule
// dealiasing boundary fused into the pass, for N = 2^a or 3*2^a <= 1024,
// either sign, with an optional scale folded into the write; built for
// float32 and for float64.
//
// * trunc: an N-row input, an Nt-row output (0 < Nt < N).  The spectrum
//   is truncated in the write: rows 0..Nt/2 and the top rows N-(Nt-1)/2..
//   N-1 are kept, and for even Nt row N-Nt/2 is folded onto row Nt/2.
// * pad: an Nt-row input, an N-row output.  The spectrum is zero-padded
//   in the read: for even Nt, row Nt/2 is split in halves between rows
//   Nt/2 and N-Nt/2.
// The maps are _trunc_rows and _pad_rows of the JAX package
// (pallas_butterfly.py:455-481), the reference's 3/2 rule
// (libfft.py:263-311).
//
// Replaces the TPU kernels of mpi4py_fft_tpu/ops/pallas_butterfly.py
// reached from fft_axis_tp :938 through _dispatch_tp :858: _kern_lead_t
// and _kern_lead_pd :553/:561, _kern_mid_t and _kern_mid_pd :530/:542,
// and the ragged-lane wrapper _kern_lead1_tp :918.  One strided kernel
// covers every axis position, the last one too (the JAX gate's exclusion
// of the last axis and its (8, 128) conditions are TPU layout).  The JAX
// kernel is float32 only; the float64 build computes the same function as
// the JAX package's unfused f64 path (transform, then truncate_planar or
// pad_planar).
//
// Bound on an H100: bytes.  A pass reads (2, pre, Nin, post) and writes
// (2, pre, Nout, post) once, (Nin + Nout) * pre * post * 2 * sizeof(T)
// bytes; at about 3 flops a byte (1.6 at f64) it sits below the card's
// ratio of peak flops to bandwidth, as fft_axis.cu does.  The fused
// boundary saves the separate truncation or padding pass, which would
// read and write the smaller volume once more, and the scale pass.
// Design: fft_axis.cu's tile of C lines (butterfly.cuh), with input and
// output line bases of their own (Nin != Nout).  The load reads only the
// input rows the map takes and writes zeros, or the halves of the split
// row, into the rest of the tile; the store writes Nout rows, reading two
// tile rows for the folded one.  Nothing but the two unavoidable passes
// over device memory.
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

// (2, pre, Nin, post) -> (2, pre, Nout, post) along an n-point transform;
// pad == 0: Nin = n, Nout = nt; pad == 1: Nin = nt, Nout = n.
template <class T, int kBlocks>
__global__ void __launch_bounds__(mff::Budget<T>::kTile / 16, kBlocks)
fft_axis_tp_kernel(const T* __restrict__ x, T* __restrict__ y,
                   const T* __restrict__ tw, long long tw_len,
                   long long pre, int n, int nt, int pad, long long post,
                   T sign, mff::Plan plan, T scale, int lc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = 1 << lc;
  const int n_in = pad ? nt : n;
  const int n_out = pad ? n : nt;
  long long* bin = reinterpret_cast<long long*>(smem);
  long long* bout = bin + C;
  mff::Tile<T> t;
  t.lc = lc;
  t.cp = C + 1;
  t.re = reinterpret_cast<T*>(bout + C);
  t.im = t.re + n * t.cp;
  const long long nlines = pre * post;
  line_bases2(bin, bout, static_cast<long long>(blockIdx.x) << lc, nlines,
              C, n_in, n_out, post);
  __syncthreads();

  // the head keeps rows 0..h (h = nt/2); the top nt-1-h rows of the
  // spectrum sit at n-(nt-1-h)..n-1; for even nt row h is the one split
  // between rows h and n-h (pad) or folded from row n-h (trunc)
  const int h = nt / 2;
  const bool even = (nt & 1) == 0;
  const int top = n - nt;           // shift of the top rows

  const long long pin = nlines * n_in;
  for (int idx = threadIdx.x; idx < (n << lc); idx += blockDim.x) {
    int c, k;
    tile_index(idx, n, lc, post, &c, &k);
    const long long b = bin[c];
    T vr = 0, vi = 0;
    if (b >= 0) {
      int src = k;                  // trunc: the whole line
      T f = 1;
      if (pad) {
        if (k < h || (!even && k == h)) {
          src = k;
        } else if (k > top + h) {
          src = k - top;
        } else if (even && (k == h || k == top + h)) {
          src = h;
          f = T(0.5);
        } else {
          src = -1;
        }
      }
      if (src >= 0) {
        const long long a = b + src * post;
        vr = x[a] * f;
        vi = x[pin + a] * f;
      }
    }
    t.re[k * t.cp + c] = vr;
    t.im[k * t.cp + c] = vi;
  }
  __syncthreads();

  mff::run_plan(t, n, plan, tw, tw + tw_len, sign);

  const long long pout = nlines * n_out;
  for (int idx = threadIdx.x; idx < (n_out << lc); idx += blockDim.x) {
    int c, j;
    tile_index(idx, n_out, lc, post, &c, &j);
    const long long b = bout[c];
    if (b < 0) continue;
    T r, i;
    if (pad || j < h || (!even && j == h)) {
      r = t.re[j * t.cp + c] * scale;
      i = t.im[j * t.cp + c] * scale;
    } else if (j > h) {
      r = t.re[(j + top) * t.cp + c] * scale;
      i = t.im[(j + top) * t.cp + c] * scale;
    } else {                        // even nt, j == h: fold row n-h on h
      const int s = (h + top) * t.cp + c;
      r = t.re[h * t.cp + c] * scale + t.re[s] * scale;
      i = t.im[h * t.cp + c] * scale + t.im[s] * scale;
    }
    const long long a = b + j * post;
    y[a] = r;
    y[pout + a] = i;
  }
}

template <class T>
int launch_fft_axis_tp(const T* x, T* y, const T* tw, long long tw_len,
                       long long pre, int n, int nt, int pad, long long post,
                       int sign, const int* plan, int nstages, T scale,
                       void* stream) {
  mff::Plan p;
  if (!mff::make_plan(plan, nstages, n, &p)) return cudaErrorInvalidValue;
  if (nt < 1 || nt >= n || (pad != 0 && pad != 1))
    return cudaErrorInvalidValue;
  const int lc = mff::tile_log2_lines<T>(n);
  const int C = 1 << lc;
  const long long nlines = pre * post;
  const long long blocks = (nlines + C - 1) / C;
  if (nlines <= 0 || blocks > 0x7fffffffLL || ((n << lc) % 16) != 0)
    return cudaErrorInvalidValue;
  const int threads = (n << lc) / 16;
  const size_t smem = 2 * sizeof(long long) * C +
                      2 * sizeof(T) * static_cast<size_t>(n) * (C + 1);
  using B = mff::Budget<T>;
  auto kern = mff::pick_bound<T>(smem,
                                 &fft_axis_tp_kernel<T, B::kMinBlocks>,
                                 &fft_axis_tp_kernel<T, B::kWideMinBlocks>);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<static_cast<unsigned>(blocks), threads, smem,
         static_cast<cudaStream_t>(stream)>>>(
      x, y, tw, tw_len, pre, n, nt, pad, post, static_cast<T>(sign), p,
      scale, lc);
  return cudaGetLastError();
}

}  // namespace

// x: (2, pre, n, post) (pad == 0) or (2, pre, nt, post) (pad == 1);
// y: (2, pre, nt, post) or (2, pre, n, post); float32, contiguous, on the
// current device.  tw: the (2, tw_len) table of _tw_pack(n, sign).
// Returns cudaGetLastError() after the launch.
extern "C" int mff_fft_axis_tp_f32(const float* x, float* y, const float* tw,
                                   long long tw_len, long long pre, int n,
                                   int nt, int pad, long long post, int sign,
                                   const int* plan, int nstages, float scale,
                                   void* stream) {
  return launch_fft_axis_tp(x, y, tw, tw_len, pre, n, nt, pad, post, sign,
                            plan, nstages, scale, stream);
}

// The same for float64 x, y and tw, with a double scale.
extern "C" int mff_fft_axis_tp_f64(const double* x, double* y,
                                   const double* tw, long long tw_len,
                                   long long pre, int n, int nt, int pad,
                                   long long post, int sign, const int* plan,
                                   int nstages, double scale, void* stream) {
  return launch_fft_axis_tp(x, y, tw, tw_len, pre, n, nt, pad, post, sign,
                            plan, nstages, scale, stream);
}
