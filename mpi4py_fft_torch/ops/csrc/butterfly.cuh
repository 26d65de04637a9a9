// Shared Stockham core of the port's FFT kernels (fft_axis.cu,
// rfft_axis.cu): the radix-r butterflies and the stage loop over a tile of
// lines held in shared memory.
//
// Port of the in-VMEM core of mpi4py_fft_tpu/ops/pallas_butterfly.py:
// _butterfly :434, _stage_apply :331, _dft_slabs :301, _finish :427.
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

#include <cuda_runtime.h>

namespace mff {

// Elements per tile (lines x line length) and the least number of blocks
// an SM must hold; a thread owns 16 elements, so a block has up to
// kTile / 16 threads.  Three 512-thread blocks an SM cap a thread at 40
// registers: on an H100 the spills cost less than the occupancy buys
// (PERF.md).
constexpr int kTile = 8192;
constexpr int kMinBlocks = 3;
constexpr int kMaxThreads = kTile / 16;

constexpr int kMaxStages = 16;

// Stage radices of one transform length, passed by value to a kernel.
struct Plan {
  int nst;
  int r[kMaxStages];
};

// cos and sin of 2*pi*k/16, the double values rounded to float as the
// JAX package's Python constants are.
__device__ __forceinline__ float cos16(int k) {
  switch (k) {
    case 1: return (float)0.9238795325112867;
    case 2: return (float)0.7071067811865476;
    case 3: return (float)0.38268343236508984;
    case 5: return (float)-0.3826834323650897;
    case 6: return (float)-0.7071067811865475;
    case 7: return (float)-0.9238795325112867;
    default: return 1.0f;
  }
}

__device__ __forceinline__ float sin16(int k) {
  switch (k) {
    case 1: return (float)0.3826834323650898;
    case 2: return (float)0.7071067811865475;
    case 3: return (float)0.9238795325112867;
    case 5: return (float)0.9238795325112867;
    case 6: return (float)0.7071067811865476;
    case 7: return (float)0.3826834323650899;
    default: return 0.0f;
  }
}

// R-point DFT as the recursive radix-2 network of _dft_slabs (R = 8, 16).
template <int R>
struct Slabs {
  __device__ __forceinline__ static void run(float* xr, float* xi,
                                             float sign) {
    constexpr int H = R / 2;
    float er[H], ei[H], orr[H], oi[H];
#pragma unroll
    for (int k = 0; k < H; ++k) {
      er[k] = xr[2 * k];
      ei[k] = xi[2 * k];
      orr[k] = xr[2 * k + 1];
      oi[k] = xi[2 * k + 1];
    }
    Slabs<H>::run(er, ei, sign);
    Slabs<H>::run(orr, oi, sign);
#pragma unroll
    for (int k = 0; k < H; ++k) {
      float tr, ti;
      if (k == 0) {                    // w = 1
        tr = orr[k];
        ti = oi[k];
      } else if (4 * k == R) {         // w = exp(sign*i*pi/2)
        tr = -sign * oi[k];
        ti = sign * orr[k];
      } else {
        const float wr = cos16(k * 16 / R);
        const float wi = sign * sin16(k * 16 / R);
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

template <>
struct Slabs<1> {
  __device__ __forceinline__ static void run(float*, float*, float) {}
};

// r-point DFT across one butterfly's inputs, in place.
template <int R>
__device__ __forceinline__ void dft(float (&vr)[R], float (&vi)[R],
                                    float sign) {
  Slabs<R>::run(vr, vi, sign);
}

template <>
__device__ __forceinline__ void dft<2>(float (&vr)[2], float (&vi)[2],
                                       float) {
  const float ar = vr[0], ai = vi[0], br = vr[1], bi = vi[1];
  vr[0] = ar + br;
  vi[0] = ai + bi;
  vr[1] = ar - br;
  vi[1] = ai - bi;
}

template <>
__device__ __forceinline__ void dft<3>(float (&vr)[3], float (&vi)[3],
                                       float sign) {
  // w3 = exp(sign*2i*pi/3) = c + i*s; w3^2 = conj(w3)
  const float c = -0.5f;
  const float s = sign * (float)0.8660254037844386;
  const float q0r = vr[0], q0i = vi[0];
  const float ar = vr[1] + vr[2], ai = vi[1] + vi[2];
  const float br = vr[1] - vr[2], bi = vi[1] - vi[2];
  vr[0] = q0r + ar;
  vi[0] = q0i + ai;
  vr[1] = q0r + c * ar - s * bi;
  vi[1] = q0i + c * ai + s * br;
  vr[2] = q0r + c * ar + s * bi;
  vi[2] = q0i + c * ai - s * br;
}

template <>
__device__ __forceinline__ void dft<4>(float (&vr)[4], float (&vi)[4],
                                       float sign) {
  const float t0r = vr[0] + vr[2], t0i = vi[0] + vi[2];
  const float t1r = vr[1] + vr[3], t1i = vi[1] + vi[3];
  const float t2r = vr[0] - vr[2], t2i = vi[0] - vi[2];
  const float t3r = vr[1] - vr[3], t3i = vi[1] - vi[3];
  // w4 = exp(sign*i*pi/2): w4*z = (-sign*zi, sign*zr)
  const float u3r = -sign * t3i, u3i = sign * t3r;
  vr[0] = t0r + t1r;
  vi[0] = t0i + t1i;
  vr[1] = t2r + u3r;
  vi[1] = t2i + u3i;
  vr[2] = t0r - t1r;
  vi[2] = t0i - t1i;
  vr[3] = t2r - u3r;
  vi[3] = t2i - u3i;
}

// A tile of C = 2^lc lines in shared memory (see the layout above).
struct Tile {
  float* re;
  float* im;
  int lc;
  int cp;   // row stride, C + 1
};

// One Stockham stage of radix R at remaining length L over a tile of
// lines of length W; the state has M = 2^lm interleaved sub-transforms.
// twr/twi: the stage twiddle rows, this stage's block starting at off.
template <int R>
__device__ __forceinline__ void stage(const Tile& t, int W, int L, int lm,
                                      int off, const float* __restrict__ twr,
                                      const float* __restrict__ twi,
                                      float sign) {
  constexpr int K = (16 + R - 1) / R;
  const int Lq = L / R;
  const int C = 1 << t.lc;
  const int M = 1 << lm;
  const int nb = (W / R) << t.lc;
  float vr[K][R], vi[K][R];
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
      dft<R>(vr[k], vi[k], sign);
      if (Lq > 1) {          // the last stage of a length has w = 1
#pragma unroll
        for (int j = 1; j < R; ++j) {
          const int w = off + (j - 1) * Lq + lp;
          const float wr = __ldg(twr + w), wi = __ldg(twi + w);
          const float yr = vr[k][j], yi = vi[k][j];
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
__device__ __forceinline__ void run_plan(const Tile& t, int W,
                                         const Plan& plan,
                                         const float* __restrict__ twr,
                                         const float* __restrict__ twi,
                                         float sign) {
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
// W * C <= kTile.
inline int tile_log2_lines(int W) {
  int lc = 0;
  while (lc < 10 && (W << (lc + 1)) <= kTile) ++lc;
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
