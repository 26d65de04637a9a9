"""Planar 3/2-rule spectral truncation and zero-padding.

Port of ``mpi4py_fft_tpu/libfft.py:116-166`` (``_axslice``,
``truncate_planar``, ``pad_planar``): the same semantics on planar
(2,) + S tensors, with the Nyquist mode folded on truncation and split on
padding for even extents.  The rest of that module (the serial ``FFT``
class) is ROADMAP Queue 1 item 8.
"""
__all__ = ['truncate_planar', 'pad_planar']


def _axslice(p, ax, sl):
    s = [slice(None)] * p.dim()
    s[ax] = sl
    return tuple(s)


def truncate_planar(p, ax, Nt, hermitian):
    """Planar spectral truncation along planar-coords axis ``ax`` to
    length ``Nt``."""
    if hermitian:
        t = p[_axslice(p, ax, slice(0, Nt))].clone()
        if Nt % 2 == 0:
            nyq = _axslice(t, ax, slice(Nt - 1, Nt))[1:]
            t[(0,) + nyq] *= 2.0
            t[(1,) + nyq] = 0.0
        return t
    Np = p.shape[ax]
    sh = list(p.shape)
    sh[ax] = Nt
    t = p.new_zeros(sh)
    t[_axslice(t, ax, slice(0, Nt // 2 + 1))] = \
        p[_axslice(p, ax, slice(0, Nt // 2 + 1))]
    t[_axslice(t, ax, slice(Nt - Nt // 2, Nt))] += \
        p[_axslice(p, ax, slice(Np - Nt // 2, Np))]
    return t


def pad_planar(p, ax, Np, hermitian):
    """Planar spectral zero-padding along planar-coords axis ``ax`` to
    length ``Np``, with the symmetric Fourier interpolator for even
    extents."""
    Nt = p.shape[ax]
    sh = list(p.shape)
    sh[ax] = Np
    out = p.new_zeros(sh)
    if hermitian:
        out[_axslice(out, ax, slice(0, Nt))] = p
        if Nt % 2 == 0:
            nyq = _axslice(out, ax, slice(Nt - 1, Nt))[1:]
            out[(0,) + nyq] *= 0.5
            out[(1,) + nyq] = 0.0
        return out
    out[_axslice(out, ax, slice(0, Nt // 2 + 1))] = \
        p[_axslice(p, ax, slice(0, Nt // 2 + 1))]
    out[_axslice(out, ax, slice(Np - Nt // 2, Np))] = \
        p[_axslice(p, ax, slice(Nt - Nt // 2, Nt))]
    if Nt % 2 == 0:
        out[_axslice(out, ax, slice(Nt // 2, Nt // 2 + 1))] *= 0.5
        out[_axslice(out, ax, slice(Np - Nt // 2, Np - Nt // 2 + 1))] *= 0.5
    return out
