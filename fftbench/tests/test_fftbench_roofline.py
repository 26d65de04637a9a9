"""The roofline's bytes and operations against hand arithmetic, and the
rule that tells the port's kernels from PyTorch's and CUDA's."""
import math

import pytest

from fftbench import catalog, roofline, tracewin


def test_r2r_plan_512_moves_2_15_gb_each_way():
    cfg = catalog.config('r2r_dct3_512_d')
    tr = catalog.traffic('roundtrip')
    real = 512 ** 3 * 8                      # 1.0737 GB of float64
    spec = 257 * 512 * 512 * 16              # 1.0779 GB of complex128
    assert real + spec == 2_151_677_952
    least, bound = tr.least_seconds(cfg)
    assert bound == 'bytes'
    assert least == pytest.approx((real + spec) / 3.35e12)
    assert least * 1e3 == pytest.approx(0.6423, abs=1e-4)
    # every axis real (two DCTs, the r2c): 2.5 n log2 n over 512^3 points
    work = roofline.real_transform([512] * 3, [2, 1, 0],
                                   ['r2r', 'r2r', 'r2c'], 'd')
    assert work['ops'] == pytest.approx(2.5 * 512 ** 3 * 27)
    assert work['spectrum_shape'] == (257, 512, 512)


def test_dealiased_backward_moves_1_08_in_3_62_out():
    cfg = catalog.config('tg_dns_512_d_pad')
    w = roofline.dealiased(cfg['N'], cfg['padding'], cfg['dtype'])
    assert w['spectrum_shape'] == (512, 512, 257)
    assert w['spectrum_bytes'] == 512 * 512 * 257 * 16       # 1.078 GB in
    assert w['real_bytes'] == 768 ** 3 * 8                   # 3.624 GB out
    assert round(w['spectrum_bytes'] / 1e9, 2) == 1.08
    assert round(w['real_bytes'] / 1e9, 2) == 3.62
    # r2c on the 768-point last axis over 768^2 lines, then two complex
    # axes over the halved (768, 768, 385) data
    lg = math.log2(768)
    want = 768 ** 2 * 2.5 * 768 * lg + 2 * 768 * 385 * 5 * 768 * lg
    assert w['ops'] == pytest.approx(want)
    least, bound = roofline.transform_least(w, 'd')
    assert bound == 'bytes'
    assert least == pytest.approx((w['spectrum_bytes'] + w['real_bytes'])
                                  / roofline.HBM_BYTES_PER_S)


def test_the_bound_that_holds_is_named():
    assert roofline.least_seconds(3.35e12, 1.0, 'd') == (1.0, 'bytes')
    assert roofline.least_seconds(1.0, 34e12, 'd') == (1.0, 'operations')


KERNELS = [
    ('void at::native::vectorized_elementwise_kernel<2, at::native::'
     'CUDAFunctor_add<double>, std::array<char*, 3ul> >(int, at::native::'
     'CUDAFunctor_add<double>, std::array<char*, 3ul>)', 'torch'),
    ('void at::native::(anonymous namespace)::CatArrayBatchedCopy<at::'
     'native::(anonymous namespace)::OpaqueType<8u>, unsigned int, 3, 64, '
     '64>(at::native::(anonymous namespace)::OpaqueType<8u>*, int)',
     'torch'),
    ('void regular_fft<512u, EPT<8u>, 64u, 16u, 0u, 0u, (padding_t)0, '
     'float2, double2>(kernel_arguments_t<unsigned int>)', 'torch'),
    ('void regular_fft_r2c<768u, 8u>(kernel_arguments_t<unsigned int>)',
     'torch'),
    ('void vector_fft<256u, EPT<16u>, 16u, 4u, (padding_t)1>('
     'kernel_arguments_t<unsigned int>)', 'torch'),
    ('sm90_xmma_gemm_f64f64_f64f64_f64_tn_n_tilesize64x64x16_execute_'
     'kernel__5x_cublas', 'torch'),
    ('Memcpy DtoD (Device -> Device)', 'torch'),
    ('Memset (Device)', 'torch'),
    ('void (anonymous namespace)::irfft_lines_kernel<double, 384>(double '
     'const*, double*, double const*, long long, int, long long, int, '
     'double)', 'port'),
    ('void (anonymous namespace)::fft_axis_tp_band_kernel<double, 4, '
     'false, 3, mff::PadRows>(mff::Half<double const>, double const*)',
     'port'),
    # a kernel of the port whose parameters hold library types, or whose
    # template arguments name one, is still the port's
    ('void (anonymous namespace)::new_kernel<c10::complex<double> >('
     'c10::complex<double> const*, cublasHandle_t, at::Half*)', 'port'),
]


@pytest.mark.parametrize('name,kind', KERNELS, ids=range(len(KERNELS)))
def test_kernels_are_classed_by_their_qualified_name(name, kind):
    assert tracewin.kind_of(name) == kind
