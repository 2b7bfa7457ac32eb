"""Reference-compatible algcode module (commpy.channelcoding.algcode API)."""
from ..ops.algebraic import cyclic_code_genpoly

__all__ = ["cyclic_code_genpoly"]
