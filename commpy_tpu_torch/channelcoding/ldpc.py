"""Reference-compatible ldpc module (commpy.channelcoding.ldpc API)."""
from ..ops.ldpc import (
    build_matrix,
    get_ldpc_code_params,
    ldpc_bp_decode,
    triang_ldpc_systematic_encode,
    write_ldpc_params,
)

__all__ = [
    "build_matrix",
    "get_ldpc_code_params",
    "ldpc_bp_decode",
    "write_ldpc_params",
    "triang_ldpc_systematic_encode",
]
