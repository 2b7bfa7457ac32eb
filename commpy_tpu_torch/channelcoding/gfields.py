"""Reference-compatible gfields module (commpy.channelcoding.gfields API)."""
from ..ops.galois import GF, poly_to_string, polydivide, polymultiply

__all__ = ["GF", "polydivide", "polymultiply", "poly_to_string"]
