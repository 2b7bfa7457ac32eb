"""Reference-compatible channel-coding package (commpy.channelcoding API).

Counterpart of ``commpy_tpu/channelcoding``: re-exports the FEC surface
as the reference does (commpy/channelcoding/__init__.py:65-71), backed by
:mod:`commpy_tpu_torch.ops`, plus the codecs the reference lacks (BCH,
RS, turbo product and polar codes).  The functions take ``device``
(default ``"cuda"``) and compute there; ``viterbi_decode`` runs the
kernels K1 and K2 on the card, ``turbo_decode`` K3 and ``ldpc_bp_decode``
(for QC designs) K4.
"""
from ..ops.trellis import Trellis
from ..ops.convcode import conv_encode, puncturing, depuncturing
from ..ops.viterbi import viterbi_decode
from ..ops.interleave import RandInterlv
from ..ops.turbo import turbo_encode, map_decode, turbo_decode
from ..ops.ldpc import (
    build_matrix,
    get_ldpc_code_params,
    ldpc_bp_decode,
    triang_ldpc_systematic_encode,
    write_ldpc_params,
)
from ..ops.galois import GF, polydivide, polymultiply, poly_to_string
from ..ops.algebraic import cyclic_code_genpoly

# Beyond the reference surface: BCH, RS, product and polar codecs (no
# CommPy counterpart), so all FEC lives under one namespace.
from ..ops.bch import (  # noqa: F401
    BchCode,
    bch_construct,
    bch_chase_decode,
    bch_decode,
    bch_encode,
)
from ..ops.tpc import tpc_decode, tpc_encode  # noqa: F401
from ..ops.rs import (  # noqa: F401
    RsCode,
    rs_construct,
    rs_decode,
    rs_encode,
    rs_errata_decode,
    rs_gmd_decode,
)
from ..ops.polar import (  # noqa: F401
    PolarCode,
    polar_construct,
    polar_encode,
    polar_sc_decode,
    polar_scl_decode,
)

# Submodules mirroring the reference layout
from . import algcode, convcode, gfields, interleavers, ldpc, turbo  # noqa: F401

__all__ = [
    "Trellis",
    "conv_encode",
    "viterbi_decode",
    "puncturing",
    "depuncturing",
    "RandInterlv",
    "turbo_encode",
    "map_decode",
    "turbo_decode",
    "get_ldpc_code_params",
    "build_matrix",
    "ldpc_bp_decode",
    "triang_ldpc_systematic_encode",
    "write_ldpc_params",
    "BchCode",
    "bch_construct",
    "bch_encode",
    "bch_decode",
    "bch_chase_decode",
    "RsCode",
    "rs_construct",
    "rs_encode",
    "rs_decode",
    "rs_errata_decode",
    "rs_gmd_decode",
    "tpc_encode",
    "tpc_decode",
    "PolarCode",
    "polar_construct",
    "polar_encode",
    "polar_sc_decode",
    "polar_scl_decode",
    "GF",
    "polydivide",
    "polymultiply",
    "poly_to_string",
    "cyclic_code_genpoly",
]
