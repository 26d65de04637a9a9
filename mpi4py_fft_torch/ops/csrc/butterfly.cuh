// Shared Stockham core of the port's FFT kernels (fft_axis.cu,
// rfft_axis.cu, fft_axis2.cu): the radix-r butterflies and the stage loop
// over a tile of lines held in shared memory, for an element type T:
// float for the f32 kernels, double for their fp64 builds.
//
// Port of the in-VMEM core of mpi4py_fft_tpu/ops/pallas_butterfly.py:
// _butterfly :434, _stage_apply :331, _dft_slabs :301, _finish :427.
// The fp64 build replaces the double-single core of
// mpi4py_fft_tpu/ops/pallas_ds.py (_butterfly_ds :239, _stage_ds :197):
// the H100 has native f64, so the same network runs in double.
// The arithmetic follows the plain versions in butterfly.py term by term
// (same stage plan, twiddle offsets and constants); only the summation
// order inside FMA contraction may differ.
//
// Tile layout: a block holds C = 2^lc lines of length W; element k of line
// c sits at re/im[k * (C + 1) + c].  Neighbouring threads take neighbouring
// lines, and the odd row stride keeps a line's neighbouring elements in
// different banks.  A stage runs in place: every thread reads the inputs of
// its butterflies into registers, the block synchronises, then every
// thread writes its outputs.  The launch uses W * C / 16 threads, so a
// thread owns 16 / r butterflies of a radix-r stage (6 for radix 3).
#pragma once

#include <cstddef>

#include <cuda_runtime.h>

namespace mff {

// The tile budget of an element type: elements per tile (lines x line
// length), and the least number of blocks an SM must hold where that many
// tiles fit its shared memory (kMinBlocks), else kWideMinBlocks (see
// pick_bound).  A thread owns 16 elements, so a block has up to kTile / 16
// threads.
template <class T>
struct Budget;

// float: three 512-thread blocks an SM cap a thread at 40 registers; on
// an H100 the spills cost less than the occupancy buys (PERF.md).  Every
// f32 tile up to W = 1536 (74 KB at W = 1024) fits three times.  The
// pair kernel's cluster pass (N = 1536, 2048) is bound to kWideMinBlocks
// (64 registers a thread) although its tiles fit three times: there the
// spills cost more (fft_axis2.cu).
template <>
struct Budget<float> {
  static constexpr int kTile = 8192;
  static constexpr int kMinBlocks = 3;
  static constexpr int kWideMinBlocks = 2;
};

// double: a thread's 16 complex values take 64 registers, and an
// 8192-element tile (128 KB) would leave one block an SM.  A 4096-element
// tile (64 KB and its row padding) fits three 256-thread blocks an SM up
// to W = 768, which caps a thread at 80 registers.  At W = 1024 the tile
// holds 4 lines (one 32-byte sector a row segment) in 80 KB, so only two
// blocks fit, and the bound gives a thread 128 registers.
template <>
struct Budget<double> {
  static constexpr int kTile = 4096;
  static constexpr int kMinBlocks = 3;
  static constexpr int kWideMinBlocks = 2;
};

// Shared memory an H100 SM gives its blocks, and what it keeps for each.
constexpr std::size_t kSmemPerSm = 233472;
constexpr std::size_t kSmemPerBlock = 1024;

// True if `blocks` blocks of `smem` bytes of dynamic shared memory each
// fit one SM.
inline bool fits_blocks(std::size_t smem, int blocks) {
  return blocks * (smem + kSmemPerBlock) <= kSmemPerSm;
}

// The instance of a kernel to launch with a tile of `smem` bytes: the one
// bound to Budget<T>::kMinBlocks blocks an SM where that many tiles fit,
// else the one bound to kWideMinBlocks.
template <class T, class K>
inline K pick_bound(std::size_t smem, K narrow, K wide) {
  return fits_blocks(smem, Budget<T>::kMinBlocks) ? narrow : wide;
}

constexpr int kMaxStages = 16;

// Stage radices of one transform length, passed by value to a kernel.
struct Plan {
  int nst;
  int r[kMaxStages];
};

// cos and sin of 2*pi*k/16: the double values of the JAX package's Python
// constants, rounded to float in the f32 build.
template <class T>
__device__ __forceinline__ T cos16(int k) {
  switch (k) {
    case 1: return (T)0.9238795325112867;
    case 2: return (T)0.7071067811865476;
    case 3: return (T)0.38268343236508984;
    case 5: return (T)-0.3826834323650897;
    case 6: return (T)-0.7071067811865475;
    case 7: return (T)-0.9238795325112867;
    default: return (T)1;
  }
}

template <class T>
__device__ __forceinline__ T sin16(int k) {
  switch (k) {
    case 1: return (T)0.3826834323650898;
    case 2: return (T)0.7071067811865475;
    case 3: return (T)0.9238795325112867;
    case 5: return (T)0.9238795325112867;
    case 6: return (T)0.7071067811865476;
    case 7: return (T)0.3826834323650899;
    default: return (T)0;
  }
}

// R-point DFT as the recursive radix-2 network of _dft_slabs (R = 8, 16).
template <int R, class T>
struct Slabs {
  __device__ __forceinline__ static void run(T* xr, T* xi, T sign) {
    constexpr int H = R / 2;
    T er[H], ei[H], orr[H], oi[H];
#pragma unroll
    for (int k = 0; k < H; ++k) {
      er[k] = xr[2 * k];
      ei[k] = xi[2 * k];
      orr[k] = xr[2 * k + 1];
      oi[k] = xi[2 * k + 1];
    }
    Slabs<H, T>::run(er, ei, sign);
    Slabs<H, T>::run(orr, oi, sign);
#pragma unroll
    for (int k = 0; k < H; ++k) {
      T tr, ti;
      if (k == 0) {                    // w = 1
        tr = orr[k];
        ti = oi[k];
      } else if (4 * k == R) {         // w = exp(sign*i*pi/2)
        tr = -sign * oi[k];
        ti = sign * orr[k];
      } else {
        const T wr = cos16<T>(k * 16 / R);
        const T wi = sign * sin16<T>(k * 16 / R);
        tr = orr[k] * wr - oi[k] * wi;
        ti = orr[k] * wi + oi[k] * wr;
      }
      xr[k] = er[k] + tr;
      xi[k] = ei[k] + ti;
      xr[k + H] = er[k] - tr;
      xi[k + H] = ei[k] - ti;
    }
  }
};

template <class T>
struct Slabs<1, T> {
  __device__ __forceinline__ static void run(T*, T*, T) {}
};

// r-point DFT across one butterfly's inputs, in place.
template <int R, class T>
struct Dft {
  __device__ __forceinline__ static void run(T (&vr)[R], T (&vi)[R],
                                             T sign) {
    Slabs<R, T>::run(vr, vi, sign);
  }
};

template <class T>
struct Dft<2, T> {
  __device__ __forceinline__ static void run(T (&vr)[2], T (&vi)[2], T) {
    const T ar = vr[0], ai = vi[0], br = vr[1], bi = vi[1];
    vr[0] = ar + br;
    vi[0] = ai + bi;
    vr[1] = ar - br;
    vi[1] = ai - bi;
  }
};

template <class T>
struct Dft<3, T> {
  __device__ __forceinline__ static void run(T (&vr)[3], T (&vi)[3],
                                             T sign) {
    // w3 = exp(sign*2i*pi/3) = c + i*s; w3^2 = conj(w3)
    const T c = (T)-0.5;
    const T s = sign * (T)0.8660254037844386;
    const T q0r = vr[0], q0i = vi[0];
    const T ar = vr[1] + vr[2], ai = vi[1] + vi[2];
    const T br = vr[1] - vr[2], bi = vi[1] - vi[2];
    vr[0] = q0r + ar;
    vi[0] = q0i + ai;
    vr[1] = q0r + c * ar - s * bi;
    vi[1] = q0i + c * ai + s * br;
    vr[2] = q0r + c * ar + s * bi;
    vi[2] = q0i + c * ai - s * br;
  }
};

template <class T>
struct Dft<4, T> {
  __device__ __forceinline__ static void run(T (&vr)[4], T (&vi)[4],
                                             T sign) {
    const T t0r = vr[0] + vr[2], t0i = vi[0] + vi[2];
    const T t1r = vr[1] + vr[3], t1i = vi[1] + vi[3];
    const T t2r = vr[0] - vr[2], t2i = vi[0] - vi[2];
    const T t3r = vr[1] - vr[3], t3i = vi[1] - vi[3];
    // w4 = exp(sign*i*pi/2): w4*z = (-sign*zi, sign*zr)
    const T u3r = -sign * t3i, u3i = sign * t3r;
    vr[0] = t0r + t1r;
    vi[0] = t0i + t1i;
    vr[1] = t2r + u3r;
    vi[1] = t2i + u3i;
    vr[2] = t0r - t1r;
    vi[2] = t0i - t1i;
    vr[3] = t2r - u3r;
    vi[3] = t2i - u3i;
  }
};

// A tile of C = 2^lc lines in shared memory (see the layout above).
template <class T>
struct Tile {
  T* re;
  T* im;
  int lc;
  int cp;   // row stride, C + 1
};

// One Stockham stage of radix R at remaining length L over a tile of
// lines of length W; the state has M = 2^lm interleaved sub-transforms.
// twr/twi: the stage twiddle rows, this stage's block starting at off.
template <int R, class T>
__device__ __forceinline__ void stage(const Tile<T>& t, int W, int L,
                                      int lm, int off,
                                      const T* __restrict__ twr,
                                      const T* __restrict__ twi, T sign) {
  constexpr int K = (16 + R - 1) / R;
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
      Dft<R, T>::run(vr[k], vi[k], sign);
      if (Lq > 1) {          // the last stage of a length has w = 1
#pragma unroll
        for (int j = 1; j < R; ++j) {
          const int w = off + (j - 1) * Lq + lp;
          const T wr = __ldg(twr + w), wi = __ldg(twi + w);
          const T yr = vr[k][j], yi = vi[k][j];
          vr[k][j] = yr * wr - yi * wi;
          vi[k][j] = yr * wi + yi * wr;
        }
      }
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

// The whole W-point transform of every line of the tile, in natural
// output order.  The caller has synchronised after filling the tile; the
// tile is ready to read when this returns.  A radix-3 stage is always
// last (the plan puts it there), so M stays a power of two.
template <class T>
__device__ __forceinline__ void run_plan(const Tile<T>& t, int W,
                                         const Plan& plan,
                                         const T* __restrict__ twr,
                                         const T* __restrict__ twi,
                                         T sign) {
  int L = W, lm = 0, off = 0;
  for (int s = 0; s < plan.nst; ++s) {
    const int r = plan.r[s];
    switch (r) {
      case 2: stage<2>(t, W, L, lm, off, twr, twi, sign); lm += 1; break;
      case 3: stage<3>(t, W, L, lm, off, twr, twi, sign); break;
      case 4: stage<4>(t, W, L, lm, off, twr, twi, sign); lm += 2; break;
      case 8: stage<8>(t, W, L, lm, off, twr, twi, sign); lm += 3; break;
      default: stage<16>(t, W, L, lm, off, twr, twi, sign); lm += 4; break;
    }
    off += (r - 1) * (L / r);
    L /= r;
  }
}

// Lines per block: the largest power of two C <= 1024 with
// W * C <= Budget<T>::kTile.
template <class T>
inline int tile_log2_lines(int W) {
  int lc = 0;
  while (lc < 10 && (W << (lc + 1)) <= Budget<T>::kTile) ++lc;
  return lc;
}

// Copy a host plan into the by-value kernel argument; false if invalid.
inline bool make_plan(const int* radices, int nst, int W, Plan* plan) {
  if (nst < 1 || nst > kMaxStages) return false;
  int prod = 1;
  for (int s = 0; s < nst; ++s) {
    const int r = radices[s];
    if (r != 2 && r != 3 && r != 4 && r != 8 && r != 16) return false;
    if (r == 3 && s != nst - 1) return false;
    plan->r[s] = r;
    prod *= r;
  }
  plan->nst = nst;
  return prod == W;
}

}  // namespace mff
