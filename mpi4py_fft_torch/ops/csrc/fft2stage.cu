// fft2stage_p (J): unnormalized planar c2c FFT along the last axis of
// (2, B, N) float32 data, N = S * 128 with 1 <= S <= 8, either sign:
//
//   a[k1, n2] = sum_n1 W_S[k1, n1] x[n1*128 + n2]      stage 1, radix S
//   t[k1, n2] = a[k1, n2] * exp(sign*2i*pi*k1*n2/N)     twiddle
//   c[k1, :]  = the 128-point DFT of t[k1, :]           stage 2
//   X[k2*S + k1] = c[k1, k2]                            natural order
//
// Replaces the TPU kernel of mpi4py_fft_tpu/ops/pallas_fft.py reached from
// fft2stage_p :158 through _call :128 (_kernel :56), which matfft's
// _fft_last_p :460-462 dispatches for the engine's f32 last axes.  The
// JAX wrapper's final (k1, k2) swap (:154) is folded into the store.
//
// Stage 1 is the direct S-point DFT with the numpy-built _dft_matrix(S)
// entries, summed over n1 in order as the JAX kernel does.  Stage 2 is
// the 128-point Stockham of butterfly.cuh (the plan of _stage_plan(128))
// where the TPU kernel multiplies by the 128 x 128 DFT matrix on its MXU:
// the direct product would cost about 1 kflop per complex output, 64
// flops a byte, compute bound on this card; the Stockham keeps J at
// about 6 flops a byte (S^2 * 8 for stage 1, 6 for the twiddle and
// 5 * 7 for stage 2 per point, over 16 bytes), below the card's ratio of
// about 20, so J is bound by bytes: one read and one write of the volume.
//
// Design: a block holds C = 64 sub-lines of 128 points in A's tile
// (8192 elements, 3 blocks an SM): G = 64 / S whole input lines, sub-line
// g*S + k1 holding row k1 of line g (C - G*S sub-lines stay zero).  Each
// thread reads the S points x[n1*128 + n2] of one (g, n2) straight from
// device memory (neighbouring threads on neighbouring n2), applies stage
// 1 and the twiddle in registers and writes the S results into the tile;
// the stages of stage 2 run in shared memory; the store writes each line
// in natural order, neighbouring threads on neighbouring outputs.
#include <cstdint>

#include "butterfly.cuh"

namespace {

constexpr int kW = 128;

// tab: the row of real parts then the row of imaginary parts, each of
// `row` floats: W_S (S x S, row-major), the twiddle (S x 128), then the
// 128-point stage twiddles of butterfly._tw_pack(128, sign).
template <int S, int kBlocks>
__global__ void __launch_bounds__(mff::Budget<float>::kTile / 16, kBlocks)
fft2stage_kernel(const float* __restrict__ x, float* __restrict__ y,
                 const float* __restrict__ tab, long long row, long long B,
                 float sign, mff::Plan plan, int lc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = 1 << lc;
  constexpr int N = S * kW;
  const int G = C / S;
  mff::Tile<float> t;
  t.lc = lc;
  t.cp = C + 1;
  t.re = reinterpret_cast<float*>(smem);
  t.im = t.re + kW * t.cp;
  const float* w1r = tab;
  const float* w1i = tab + row;
  const float* twr = tab + S * S;
  const float* twi = twr + row;
  const float* t2r = tab + S * S + S * kW;
  const float* t2i = t2r + row;
  const long long plane = B * N;
  const long long g0 = static_cast<long long>(blockIdx.x) * G;

  // stage 1 and the twiddle, from device memory into the tile
  for (int idx = threadIdx.x; idx < G * kW; idx += blockDim.x) {
    const int g = idx / kW;
    const int n2 = idx - g * kW;
    const long long line = g0 + g;
    float xr[S], xi[S];
#pragma unroll
    for (int n1 = 0; n1 < S; ++n1) {
      xr[n1] = 0.f;
      xi[n1] = 0.f;
    }
    if (line < B) {
      const long long a = line * N + n2;
#pragma unroll
      for (int n1 = 0; n1 < S; ++n1) {
        xr[n1] = x[a + n1 * kW];
        xi[n1] = x[plane + a + n1 * kW];
      }
    }
#pragma unroll
    for (int k1 = 0; k1 < S; ++k1) {
      float ar = 0.f, ai = 0.f;
#pragma unroll
      for (int n1 = 0; n1 < S; ++n1) {
        const float wr = __ldg(w1r + k1 * S + n1);
        const float wi = __ldg(w1i + k1 * S + n1);
        const float pr = wr * xr[n1] - wi * xi[n1];
        const float pi = wr * xi[n1] + wi * xr[n1];
        ar = n1 == 0 ? pr : ar + pr;
        ai = n1 == 0 ? pi : ai + pi;
      }
      const float cr = __ldg(twr + k1 * kW + n2);
      const float ci = __ldg(twi + k1 * kW + n2);
      const int s = n2 * t.cp + g * S + k1;
      t.re[s] = ar * cr - ai * ci;
      t.im[s] = ar * ci + ai * cr;
    }
  }
  // the sub-lines past G*S hold no line
  for (int idx = threadIdx.x; idx < (C - G * S) * kW; idx += blockDim.x) {
    const int c = G * S + idx / kW;
    const int k = idx % kW;
    t.re[k * t.cp + c] = 0.f;
    t.im[k * t.cp + c] = 0.f;
  }
  __syncthreads();

  mff::run_plan(t, kW, plan, t2r, t2i, sign);

  // X[k2*S + k1] = c[k1, k2]
  for (int idx = threadIdx.x; idx < G * N; idx += blockDim.x) {
    const int g = idx / N;
    const int m = idx - g * N;
    const long long line = g0 + g;
    if (line < B) {
      const int k2 = m / S;
      const int k1 = m - k2 * S;
      const int s = k2 * t.cp + g * S + k1;
      y[line * N + m] = t.re[s];
      y[plane + line * N + m] = t.im[s];
    }
  }
}

template <int S>
int launch(const float* x, float* y, const float* tab, long long row,
           long long B, int sign, const mff::Plan& p, void* stream) {
  const int lc = mff::tile_log2_lines<float>(kW);
  const int C = 1 << lc;
  const long long G = C / S;
  const long long blocks = (B + G - 1) / G;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int threads = (kW << lc) / 16;
  const size_t smem = 2 * sizeof(float) * static_cast<size_t>(kW) * (C + 1);
  using Bd = mff::Budget<float>;
  auto kern = mff::pick_bound<float>(
      smem, &fft2stage_kernel<S, Bd::kMinBlocks>,
      &fft2stage_kernel<S, Bd::kWideMinBlocks>);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<static_cast<unsigned>(blocks), threads, smem,
         static_cast<cudaStream_t>(stream)>>>(
      x, y, tab, row, B, static_cast<float>(sign), p, lc);
  return cudaGetLastError();
}

}  // namespace

// x, y: (2, B, S*128) float32, contiguous, on the current device.  tab:
// the (2, row) table of fft2stage._table_tensor(S, sign), row = S*S +
// S*128 + _tw_len(128).  plan: the radices of _stage_plan(128).  Returns
// cudaGetLastError() after the launch.
extern "C" int mff_fft2stage_f32(const float* x, float* y, const float* tab,
                                 long long row, long long B, int S, int sign,
                                 const int* plan, int nstages,
                                 void* stream) {
  mff::Plan p;
  if (!mff::make_plan(plan, nstages, kW, &p) || B <= 0 ||
      (sign != 1 && sign != -1))
    return cudaErrorInvalidValue;
  switch (S) {
    case 1: return launch<1>(x, y, tab, row, B, sign, p, stream);
    case 2: return launch<2>(x, y, tab, row, B, sign, p, stream);
    case 3: return launch<3>(x, y, tab, row, B, sign, p, stream);
    case 4: return launch<4>(x, y, tab, row, B, sign, p, stream);
    case 5: return launch<5>(x, y, tab, row, B, sign, p, stream);
    case 6: return launch<6>(x, y, tab, row, B, sign, p, stream);
    case 7: return launch<7>(x, y, tab, row, B, sign, p, stream);
    case 8: return launch<8>(x, y, tab, row, B, sign, p, stream);
    default: return cudaErrorInvalidValue;
  }
}
