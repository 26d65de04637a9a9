"""The spectral DNS solver's algebra in three float64 kernels a
Runge-Kutta stage (csrc/dns_algebra.cu), each with its plain PyTorch
version, the solver's eager expression:

* ``curl``: W_hat = i K x U_hat on the (3, n0, n1, n2h) complex128
  spectrum, into a new buffer;
* ``cross``: u x w on the physical grid, in place over w;
* ``project_rk``: from the three forwards N of u x w, the right-hand
  side dU = N - K (K . N) / |K|^2 - nu |K|^2 U_hat and both RK4 updates,
  U_next = U_hat0 + b dt dU and U_hat1 + a dt dU.

``K`` is the solver's three wavenumber tensors, broadcastable along one
axis each: shapes (n0, 1, 1), (1, n1, 1) and (1, 1, n2h), float64.  The
kernels read them by each element's index and form |K|^2 and K / |K|^2
per element; the plain versions broadcast them, as the solver did.

Every wrapper checks its tensors (dtype, shapes, contiguity, one device)
on either device and raises on anything else.  On CPU tensors it runs the
plain version; on CUDA tensors it launches its kernel.  Each launch adds
one to its count in ``butterfly.LAUNCHES`` and runs in the span ``kernel.<name>``
with the bytes it cannot avoid moving (each element of each distinct
input read and of each output written, once); a plain version runs in
that span in the kernel's place.
"""
import torch

from . import _build
from . import butterfly as bf

__all__ = ['curl', 'cross', 'project_rk', 'curl_plain', 'cross_plain',
           'project_rk_plain']


def _check(what, ts, dtype, shape):
    """Each of ``ts`` a contiguous ``dtype`` tensor of ``shape``, all on
    one device; raises otherwise."""
    dev = ts[0].device
    for t in ts:
        if t.dtype != dtype:
            raise TypeError(f"{what}: takes {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: expected shape {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: takes contiguous tensors")
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {dev} and {t.device}")


def _spectral(what, U, K):
    """(n0, n1, n2h) of a (3, n0, n1, n2h) complex128 state ``U``, with
    ``K`` checked against it."""
    if U.dim() != 4 or U.shape[0] != 3:
        raise ValueError(f"{what}: the state is (3, n0, n1, n2h), got "
                         f"{tuple(U.shape)}")
    S = tuple(U.shape[1:])
    _check(what, [U], torch.complex128, U.shape)
    if len(K) != 3:
        raise ValueError(f"{what}: K is three wavenumber tensors")
    for i, Ki in enumerate(K):
        _check(what, [Ki], torch.float64,
               [S[d] if d == i else 1 for d in range(3)])
        if Ki.device != U.device:
            raise ValueError(f"{what}: K on {Ki.device}, the state on "
                             f"{U.device}")
    return S


def _kernel(t):
    """False for a CPU tensor (the plain version runs), True for a CUDA
    one; raises on another device."""
    if t.device.type == 'cpu':
        return False
    if t.device.type != 'cuda':
        raise ValueError(f"tensor on {t.device}; the kernels take CUDA "
                         f"tensors and the plain versions CPU tensors")
    return True


def _nbytes(*ts):
    """Bytes of the distinct tensors of ``ts`` (None left out)."""
    seen = {}
    for t in ts:
        if t is not None:
            seen.setdefault(t.data_ptr(), t.numel() * t.element_size())
    return sum(seen.values())


def _ptrs(*ts):
    return [bf._ptr(t) for t in ts]


# ---------------------------------------------------------------------------
# plain versions: the solver's eager expressions
# ---------------------------------------------------------------------------

def curl_plain(U, K):
    """W_hat[c] = 1j * (K[a] * U_hat[b] - K[b] * U_hat[a]) for (c, a, b) =
    (0, 1, 2), (1, 2, 0), (2, 0, 1), into a new buffer."""
    W = torch.empty_like(U)
    for c in range(3):
        a, b = (c + 1) % 3, (c + 2) % 3
        W[c] = 1j * (K[a] * U[b] - K[b] * U[a])
    return W


def cross_plain(u, w):
    """w <- u x w: (u1 w2 - u2 w1, u2 w0 - u0 w2, u0 w1 - u1 w0)."""
    c = [u[1] * w[2] - u[2] * w[1],
         u[2] * w[0] - u[0] * w[2],
         u[0] * w[1] - u[1] * w[0]]
    for wj, cj in zip(w, c):
        wj.copy_(cj)
    return w


def project_rk_plain(N, U, U0, U1, K, nu, adt, bdt=None, inplace=False):
    """The solver's projection, viscous term and RK4 updates, as
    ``project_rk`` (its docstring), in the eager ops it replaces."""
    K2 = K[0] * K[0] + K[1] * K[1] + K[2] * K[2]
    K2s = torch.where(K2 == 0, 1, K2)
    K_over_K2 = torch.stack([Ki / K2s for Ki in K])
    rhs = torch.stack(list(N))
    P_hat = torch.sum(rhs * K_over_K2, 0)
    rhs -= torch.stack([P_hat * Ki for Ki in K])
    rhs -= nu * K2 * U
    U_next = None if bdt is None else U0 + bdt * rhs
    U1 = U1.copy_(U1 + adt * rhs) if inplace else U1 + adt * rhs
    if inplace and U_next is not None:
        U_next = U.copy_(U_next)
    return U_next, U1


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

def curl(U, K):
    """W_hat = i K x U_hat of a (3, n0, n1, n2h) complex128 state, in a
    new buffer: one launch of ``dns_curl_f64``."""
    what = 'dns_curl_f64'
    S = _spectral(what, U, K)
    nbytes = 2 * _nbytes(U) + _nbytes(*K)
    if not _kernel(U):
        return bf._plain(what, nbytes, curl_plain, U, K)
    W = torch.empty_like(U)
    if W.numel() == 0:
        return W
    bf._launch(what, _build.load().dns_curl_f64, U, *_ptrs(U, W, *K), *S,
               nbytes=nbytes)
    return W


def cross(u, w):
    """w <- u x w over the three float64 grids of ``w``, with ``u`` three
    more of the same shape, six distinct contiguous tensors on one
    device; returns ``w``.  One launch of ``dns_cross_f64``."""
    what = 'dns_cross_f64'
    if len(u) != 3 or len(w) != 3:
        raise ValueError(f"{what}: u and w are three grids each")
    ts = [*u, *w]
    _check(what, ts, torch.float64, u[0].shape)
    if len({t.data_ptr() for t in ts}) != 6:
        raise ValueError(f"{what}: the six grids must be distinct tensors")
    nbytes = _nbytes(*ts) + _nbytes(*w)
    if not _kernel(u[0]):
        return bf._plain(what, nbytes, cross_plain, u, w)
    if u[0].numel():
        bf._launch(what, _build.load().dns_cross_f64, u[0], *_ptrs(*ts),
                   u[0].numel(), nbytes=nbytes)
    return w


def project_rk(N, U, U0, U1, K, nu, adt, bdt=None, inplace=False):
    """One RK4 stage's end, from the nonlinear term's three spectra ``N``
    (N_j the forward of (u x w)_j, each (n0, n1, n2h) complex128): the
    right-hand side

        dU = N - K P - nu |K|^2 U,  P = sum_i N_i K_i / K2s

    (K2s = |K|^2, or 1 where |K|^2 = 0; the sum in order i = 0, 1, 2) of
    the stage's state ``U``, then ``U0 + bdt dU`` (the next stage's
    state; None where ``bdt`` is None, the last stage) and ``U1 + adt
    dU`` (the accumulated step).  ``U``, ``U0``, ``U1``: (3, n0, n1,
    n2h) complex128; any may be the same tensor.  Returns (U_next, U1).

    ``inplace``: U_next is written over ``U`` and the accumulated step
    over ``U1``; else both go to new buffers, and no input is written
    (the first stage, whose ``U``, ``U0`` and ``U1`` are the caller's
    state).  One launch of ``dns_project_rk_f64``."""
    what = 'dns_project_rk_f64'
    S = _spectral(what, U, K)
    if len(N) != 3:
        raise ValueError(f"{what}: N is three spectra")
    _check(what, list(N), torch.complex128, S)
    _check(what, [U, U0, U1], torch.complex128, U.shape)
    if N[0].device != U.device:
        raise ValueError(f"{what}: N on {N[0].device}, the state on "
                         f"{U.device}")
    if inplace and bdt is not None and U1.data_ptr() == U.data_ptr():
        raise ValueError(f"{what}: in place, U_next and U1 would share "
                         f"U's buffer")
    outs = 2 if bdt is not None else 1
    nbytes = _nbytes(*N, U, U1, None if bdt is None else U0, *K) \
        + outs * _nbytes(U)
    if not _kernel(U):
        return bf._plain(what, nbytes, project_rk_plain, N, U, U0, U1, K,
                         nu, adt, bdt, inplace)
    if inplace:
        U_next = None if bdt is None else U
        U1_out = U1
    else:
        U_next = None if bdt is None else torch.empty_like(U)
        U1_out = torch.empty_like(U)
    if U.numel() == 0:
        return U_next, U1_out
    bf._launch(what, _build.load().dns_project_rk_f64, U,
               *_ptrs(*N, U, U0, U1),
               None if U_next is None else bf._ptr(U_next),
               *_ptrs(U1_out, *K), *S, float(nu), float(adt),
               0.0 if bdt is None else float(bdt),
               nbytes=nbytes)
    return U_next, U1_out
