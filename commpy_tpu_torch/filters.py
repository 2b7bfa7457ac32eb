"""Reference-compatible filters module (commpy.filters API): the host
filter generators of :mod:`commpy_tpu_torch.ops.filters`."""
from .ops.filters import gaussianfilter, rcosfilter, rectfilter, rrcosfilter

__all__ = ["rcosfilter", "rrcosfilter", "gaussianfilter", "rectfilter"]
