"""Reference-compatible sequences module (commpy.sequences API): the host
sequence generators of :mod:`commpy_tpu_torch.ops.sequences`."""
from .ops.sequences import pnsequence, zcsequence

__all__ = ["pnsequence", "zcsequence"]
