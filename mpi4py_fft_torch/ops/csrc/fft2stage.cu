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
// entries, summed over n1 in order as the JAX kernel does.  Stage 2 is a
// 128-point FFT of radix 16 then 8 where the TPU kernel multiplies by the
// 128 x 128 DFT matrix on its MXU: the direct product would cost about
// 1 kflop per complex output, 64 flops a byte, compute bound on this card;
// the FFT keeps J at about 4-8 flops a byte (S^2 * 8 for stage 1, 6 for
// the twiddle and about 35 for stage 2 per point, over 16 bytes), below
// the card's ratio of about 20, so J is bound by bytes: one read and one
// write of the volume.
//
// Design: a register-resident line kernel, one warp a line (the float64
// r2c line kernel of rfft_axis.cu is its model), four warps a block, four
// blocks an SM (16 warps; a thread may take 128 registers); a warp with
// no line returns, and no barrier spans more than a warp.  Every line
// starts on a 512-byte boundary (N = S * 128 floats), so lane l loads
// points 4l .. 4l + 3 of each of the S rows n1 as one 16-byte vector of
// each plane, all 2S loads before any arithmetic (at S = 8 in two rounds
// of 8-byte vectors, half the columns each, which keeps a round's points
// in registers).  Stage 1 and the twiddle run in the thread that holds the
// S points of a column n2: W_S's values are constants of the template
// (W_S[k1, n1] = w^((k1 n1) mod S)), the twiddle row k1 one vector a row
// from the table.  The results go to the warp's buffer in shared memory,
// rows of 136 floats (8 banks apart).  Stage 2 then runs the S rows'
// 128-point transforms behind __syncwarp: radix 16 in place (butterfly
// (row, i < 8) reads points 8j + i and writes its twiddled outputs back
// to them, so a lane takes its butterflies one at a time), then radix 8
// (butterfly (row, a) reads points 8a .. 8a + 7 as two vectors, one
// butterfly of a lane in flight at a time) writing the line in its natural
// output order X[k2*S + k1], neighbouring lanes on neighbouring outputs.
// The store reads that back as 16-byte vectors and writes contiguous
// 16-byte stores.  No zero-filled rows at any S.  The radix-16 twiddles
// w_128^e come from the first block of butterfly._tw_pack(128, sign)
// (w_128^e for e < 64; w_128^(e+64) = -w_128^e).
#include <cstdint>

#include "butterfly.cuh"

namespace {

constexpr int kW = 128;
constexpr int kWarps = 4;                 // lines a block
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 4;             // 16 warps an SM
constexpr int kRow = kW + 8;              // buffer rows, 8 banks apart

// Offset of the 128-point stage twiddles in a row of _table_tensor(S,
// sign), after the S x 128 twiddle.
__host__ __device__ constexpr int tab_t2(int S) { return S * kW; }

// cos and sin of 2*pi*m/S (0 <= m < S <= 8): the double values of
// _dft_matrix's row 1 (numpy's), rounded to float; W_S[k1, n1] = w^m
// with m = k1 n1 mod S.
__device__ __forceinline__ float wcos(int S, int m) {
  switch (S * 8 + m) {
    case 17: return -1.0f;
    case 25: return (float)-0.4999999999999998;
    case 26: return (float)-0.5000000000000004;
    case 33: return (float)6.123233995736766e-17;
    case 34: return -1.0f;
    case 35: return (float)-1.8369701987210297e-16;
    case 41: return (float)0.30901699437494745;
    case 42: return (float)-0.8090169943749473;
    case 43: return (float)-0.8090169943749476;
    case 44: return (float)0.30901699437494723;
    case 49: return (float)0.5000000000000001;
    case 50: return (float)-0.4999999999999998;
    case 51: return -1.0f;
    case 52: return (float)-0.5000000000000004;
    case 53: return (float)0.5000000000000001;
    case 57: return (float)0.6234898018587336;
    case 58: return (float)-0.22252093395631434;
    case 59: return (float)-0.900968867902419;
    case 60: return (float)-0.9009688679024191;
    case 61: return (float)-0.2225209339563146;
    case 62: return (float)0.6234898018587334;
    case 65: return (float)0.7071067811865476;
    case 66: return (float)6.123233995736766e-17;
    case 67: return (float)-0.7071067811865475;
    case 68: return -1.0f;
    case 69: return (float)-0.7071067811865477;
    case 70: return (float)-1.8369701987210297e-16;
    case 71: return (float)0.7071067811865474;
    default: return 1.0f;
  }
}

__device__ __forceinline__ float wsin(int S, int m) {
  switch (S * 8 + m) {
    case 17: return (float)1.2246467991473532e-16;
    case 25: return (float)0.8660254037844387;
    case 26: return (float)-0.8660254037844384;
    case 33: return 1.0f;
    case 34: return (float)1.2246467991473532e-16;
    case 35: return -1.0f;
    case 41: return (float)0.9510565162951535;
    case 42: return (float)0.5877852522924732;
    case 43: return (float)-0.587785252292473;
    case 44: return (float)-0.9510565162951536;
    case 49: return (float)0.8660254037844386;
    case 50: return (float)0.8660254037844387;
    case 51: return (float)1.2246467991473532e-16;
    case 52: return (float)-0.8660254037844384;
    case 53: return (float)-0.8660254037844386;
    case 57: return (float)0.7818314824680298;
    case 58: return (float)0.9749279121818236;
    case 59: return (float)0.43388373911755823;
    case 60: return (float)-0.433883739117558;
    case 61: return (float)-0.9749279121818236;
    case 62: return (float)-0.7818314824680299;
    case 65: return (float)0.7071067811865475;
    case 66: return 1.0f;
    case 67: return (float)0.7071067811865476;
    case 68: return (float)1.2246467991473532e-16;
    case 69: return (float)-0.7071067811865475;
    case 70: return -1.0f;
    case 71: return (float)-0.7071067811865477;
    default: return 0.0f;
  }
}

// V adjacent floats (V = 4 or 2) as one 16- or 8-byte vector.
template <int V>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
  __device__ __forceinline__ static void get(const T& v, float* a) {
    a[0] = v.x;
    a[1] = v.y;
    a[2] = v.z;
    a[3] = v.w;
  }
  __device__ __forceinline__ static T put(const float* a) {
    return make_float4(a[0], a[1], a[2], a[3]);
  }
};
template <>
struct Vec<2> {
  using T = float2;
  __device__ __forceinline__ static void get(const T& v, float* a) {
    a[0] = v.x;
    a[1] = v.y;
  }
  __device__ __forceinline__ static T put(const float* a) {
    return make_float2(a[0], a[1]);
  }
};

// Stage 1 and the twiddle of the V columns n2 = c0 .. c0 + V - 1 of a
// line (rows x[n1*128 + n2] at xr/xi), into row k1 of the warp's buffer:
// every load first, then the S-point DFT in this thread.  With W_S = c +
// i sign s, xi' = sign xi and a' = sum (c xr - s xi') + i (c xi' + s xr),
// the product is a = (a'r, sign a'i), so W_S's values are constants.
// tw: the S x 128 twiddle at twr/twi.
template <int S, int V>
__device__ __forceinline__ void stage1(const float* __restrict__ xr,
                                       const float* __restrict__ xi,
                                       const float* __restrict__ twr,
                                       const float* __restrict__ twi,
                                       float* br, float* bi, int c0,
                                       float sign) {
  using T = typename Vec<V>::T;
  float vr[S][V], vi[S][V];
#pragma unroll
  for (int n1 = 0; n1 < S; ++n1) {
    Vec<V>::get(__ldg(reinterpret_cast<const T*>(xr + n1 * kW + c0)),
                vr[n1]);
    Vec<V>::get(__ldg(reinterpret_cast<const T*>(xi + n1 * kW + c0)),
                vi[n1]);
  }
#pragma unroll
  for (int n1 = 0; n1 < S; ++n1) {
#pragma unroll
    for (int c = 0; c < V; ++c) vi[n1][c] *= sign;
  }
#pragma unroll
  for (int k1 = 0; k1 < S; ++k1) {
    float ar[V], ai[V], cr[V], ci[V], tr[V], ti[V];
#pragma unroll
    for (int c = 0; c < V; ++c) {
#pragma unroll
      for (int n1 = 0; n1 < S; ++n1) {
        const int m = (k1 * n1) % S;
        const float wr = wcos(S, m), wi = wsin(S, m);
        const float pr = wr * vr[n1][c] - wi * vi[n1][c];
        const float pi = wr * vi[n1][c] + wi * vr[n1][c];
        ar[c] = n1 == 0 ? pr : ar[c] + pr;
        ai[c] = n1 == 0 ? pi : ai[c] + pi;
      }
      ai[c] *= sign;
    }
    Vec<V>::get(__ldg(reinterpret_cast<const T*>(twr + k1 * kW + c0)), cr);
    Vec<V>::get(__ldg(reinterpret_cast<const T*>(twi + k1 * kW + c0)), ci);
#pragma unroll
    for (int c = 0; c < V; ++c) {
      tr[c] = ar[c] * cr[c] - ai[c] * ci[c];
      ti[c] = ar[c] * ci[c] + ai[c] * cr[c];
    }
    *reinterpret_cast<T*>(br + k1 * kRow + c0) = Vec<V>::put(tr);
    *reinterpret_cast<T*>(bi + k1 * kRow + c0) = Vec<V>::put(ti);
  }
}

// tab: the (2, row) table of _table_tensor(S, sign), row % 4 == 0.
template <int S>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fft2stage_lines_kernel(const float* __restrict__ x, float* __restrict__ y,
                       const float* __restrict__ tab, long long row,
                       long long B, float sign) {
  constexpr int N = S * kW;
  constexpr int kBuf = S * kRow;          // floats of one plane
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long line = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (line >= B) return;                  // no line: this warp has no work
  float* br = reinterpret_cast<float*>(smem) + warp * 2 * kBuf;
  float* bi = br + kBuf;
  const long long plane = B * N;

  // stage 1 and the twiddle: lane l takes columns 4l .. 4l + 3 as one
  // 16-byte vector of each row; at S = 8, where one round's 32 points and
  // its twiddle spill, columns 2l, 2l + 1 and then 64 + 2l, 64 + 2l + 1
  // as 8-byte vectors, in two rounds
  constexpr int V = S == 8 ? 2 : 4;
  const float* twr = tab;
  const float* twi = tab + row;
#pragma unroll 1
  for (int h = 0; h < 4 / V; ++h)
    stage1<S, V>(x + line * N, x + plane + line * N, twr, twi, br, bi,
                 V * lane + 32 * V * h, sign);
  __syncwarp();

  // stage 2, radix 16, decimation in frequency, in place: butterfly
  // b = (row r, i < 8) takes points j*8 + i (n = 8 j + i), and writes the
  // DFT over j, output a times w_128^(a i), back to point a*8 + i; one
  // butterfly at a time, since no other lane touches those points
  const float* t2r = tab + tab_t2(S);
  const float* t2i = t2r + row;
#pragma unroll 1
  for (int k = 0; k < (8 * S + 31) / 32; ++k) {
    const int b = lane + 32 * k;
    if (b < 8 * S) {
      const int r = b >> 3, i = b & 7;
      float ur[16], ui[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        ur[j] = br[r * kRow + j * 8 + i];
        ui[j] = bi[r * kRow + j * 8 + i];
      }
      mff::Dft<16, float>::run(ur, ui, sign);
#pragma unroll
      for (int a = 1; a < 16; ++a) {
        const int e = a * i;                    // < 128
        float wr = __ldg(t2r + (e & 63)), wi = __ldg(t2i + (e & 63));
        if (e & 64) {                           // w^(e + 64) = -w^e
          wr = -wr;
          wi = -wi;
        }
        const float yr = ur[a], yi = ui[a];
        ur[a] = yr * wr - yi * wi;
        ui[a] = yr * wi + yi * wr;
      }
#pragma unroll
      for (int a = 0; a < 16; ++a) {
        br[r * kRow + a * 8 + i] = ur[a];
        bi[r * kRow + a * 8 + i] = ui[a];
      }
    }
  }
  __syncwarp();

  // stage 2, radix 8: butterfly b = (row r = b % S, a = b / S) takes the
  // 8 points a*8 .. a*8 + 7 and writes output c[r, a + 16 j] to
  // X[(a + 16 j)*S + r], neighbouring lanes on neighbouring outputs; the
  // natural order overlays the rows, so every lane reads before any writes
  {
    constexpr int nb = 16 * S, K = (nb + 31) / 32;
    float ur[K][8], ui[K][8];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int b = lane + 32 * k;
      if (b < nb) {
        const int r = b % S, a = b / S;
        const float4* pr =
            reinterpret_cast<const float4*>(br + r * kRow + a * 8);
        const float4* pi =
            reinterpret_cast<const float4*>(bi + r * kRow + a * 8);
        const float4 r0 = pr[0], r1 = pr[1], i0 = pi[0], i1 = pi[1];
        ur[k][0] = r0.x; ur[k][1] = r0.y; ur[k][2] = r0.z; ur[k][3] = r0.w;
        ur[k][4] = r1.x; ur[k][5] = r1.y; ur[k][6] = r1.z; ur[k][7] = r1.w;
        ui[k][0] = i0.x; ui[k][1] = i0.y; ui[k][2] = i0.z; ui[k][3] = i0.w;
        ui[k][4] = i1.x; ui[k][5] = i1.y; ui[k][6] = i1.z; ui[k][7] = i1.w;
        mff::Dft<8, float>::run(ur[k], ui[k], sign);
      }
      // one butterfly in flight: its reads wait for the last one's work
      if (k + 1 < K) __syncwarp();
    }
    __syncwarp();   // the warp has read the rows
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int b = lane + 32 * k;
      if (b < nb) {
        const int r = b % S, a = b / S;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          br[(a + 16 * j) * S + r] = ur[k][j];
          bi[(a + 16 * j) * S + r] = ui[k][j];
        }
      }
    }
    __syncwarp();
  }

  // the line in natural order, 16 bytes a lane
  float4* yr = reinterpret_cast<float4*>(y + line * N);
  float4* yi = reinterpret_cast<float4*>(y + plane + line * N);
#pragma unroll
  for (int q = 0; q < S; ++q) {
    const int v = lane + 32 * q;
    yr[v] = reinterpret_cast<const float4*>(br)[v];
    yi[v] = reinterpret_cast<const float4*>(bi)[v];
  }
}

template <int S>
int launch(const float* x, float* y, const float* tab, long long row,
           long long B, int sign, void* stream) {
  const long long blocks = (B + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 2 * S * kRow * kWarps;
  auto kern = &fft2stage_lines_kernel<S>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<static_cast<unsigned>(blocks), kThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(
      x, y, tab, row, B, static_cast<float>(sign));
  return cudaGetLastError();
}

}  // namespace

// x, y: (2, B, S*128) float32, contiguous, on the current device, both
// 16-byte aligned.  tab: the (2, row) table of fft2stage._table_tensor(S,
// sign), 16-byte aligned, row a multiple of 4 of at least S*128 + 64.
// Returns the error of a refused call, else cudaGetLastError() after the
// launch.
extern "C" int mff_fft2stage_f32(const float* x, float* y, const float* tab,
                                 long long row, long long B, int S, int sign,
                                 void* stream) {
  const auto mis = [](const void* p) {
    return reinterpret_cast<std::uintptr_t>(p) % 16 != 0;
  };
  if (B <= 0 || (sign != 1 && sign != -1) || S < 1 || S > 8 || mis(x) ||
      mis(y) || mis(tab) || row % 4 != 0 || row < tab_t2(S) + 64)
    return cudaErrorInvalidValue;
  switch (S) {
    case 1: return launch<1>(x, y, tab, row, B, sign, stream);
    case 2: return launch<2>(x, y, tab, row, B, sign, stream);
    case 3: return launch<3>(x, y, tab, row, B, sign, stream);
    case 4: return launch<4>(x, y, tab, row, B, sign, stream);
    case 5: return launch<5>(x, y, tab, row, B, sign, stream);
    case 6: return launch<6>(x, y, tab, row, B, sign, stream);
    case 7: return launch<7>(x, y, tab, row, B, sign, stream);
    case 8: return launch<8>(x, y, tab, row, B, sign, stream);
    default: return cudaErrorInvalidValue;
  }
}
