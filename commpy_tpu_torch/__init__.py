"""PyTorch/CUDA port of commpy_tpu for NVIDIA Hopper GPUs.

The module layout mirrors :mod:`commpy_tpu` so each function has an
obvious counterpart.  Plain tensor code is PyTorch; the Viterbi forward
pass and traceback (``kernels/csrc/viterbi_acs.cu``), the QC-LDPC
resident and streamed belief propagation (``kernels/csrc/qc_bp.cu``) and
the turbo decoder's fused BCJR (``kernels/csrc/bcjr.cu``) are
hand-written CUDA kernels built with ``nvcc`` at first use.

Layout
------
``commpy_tpu_torch.ops``       batched device ops (modem, channels, FEC, DSP)
``commpy_tpu_torch.parallel``  the Monte-Carlo engine (one device)
``commpy_tpu_torch.models``    link models, the IDD loop, 802.11 links
``commpy_tpu_torch.utils``     bits, device resolution, measures, profiling
``commpy_tpu_torch.kernels``   the CUDA kernels and their plain versions

The CommPy-compatible modules (``modulation``, ``channels``, ``links``,
``wifi80211``, ``channelcoding``, ``utilities``, ``filters``,
``sequences``, ``impairments``) keep the reference's API, NumPy in and
out, and compute on ``device`` (default ``"cuda"``).

This package never imports ``jax`` or ``commpy_tpu``.
"""

__version__ = "0.1.0"

from . import ops, utils  # noqa: F401

# the reference's top-level star exports (commpy/__init__.py:17-21)
from .filters import *  # noqa: F401,F403
from .modulation import *  # noqa: F401,F403
from .impairments import *  # noqa: F401,F403
from .sequences import *  # noqa: F401,F403
from .channels import *  # noqa: F401,F403
