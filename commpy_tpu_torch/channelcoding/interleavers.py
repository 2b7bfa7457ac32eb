"""Reference-compatible interleavers module
(commpy.channelcoding.interleavers API)."""
from ..ops.interleave import RandInterlv

__all__ = ["RandInterlv"]
