"""The number that decides ``correct``: a relative L2 gap."""
import torch


def rel_l2(x, ref):
    """||x - ref|| / ||ref||, taken in float64 whatever the type of
    ``x``; NaN where either holds a NaN, so the check fails."""
    ref = ref.to(torch.complex128 if ref.is_complex() else torch.float64)
    d = torch.linalg.vector_norm(x.to(ref.dtype) - ref)
    return float(d / torch.linalg.vector_norm(ref))
