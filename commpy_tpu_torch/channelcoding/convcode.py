"""Reference-compatible convcode module (commpy.channelcoding.convcode API)."""
from ..ops.trellis import Trellis
from ..ops.convcode import conv_encode, puncturing, depuncturing
from ..ops.viterbi import viterbi_decode

__all__ = ["Trellis", "conv_encode", "viterbi_decode", "puncturing",
           "depuncturing"]
