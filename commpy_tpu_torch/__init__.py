"""PyTorch/CUDA port of commpy_tpu for NVIDIA Hopper GPUs.

The module layout mirrors :mod:`commpy_tpu` so each function has an
obvious counterpart.  Plain tensor code is PyTorch; the Viterbi forward
pass and traceback (``kernels/csrc/viterbi_acs.cu``), the QC-LDPC
resident and streamed belief propagation (``kernels/csrc/qc_bp.cu``) and
the turbo decoder's fused BCJR (``kernels/csrc/bcjr.cu``) are
hand-written CUDA kernels built with ``nvcc`` at first use.

This package never imports ``jax`` or ``commpy_tpu``.
"""

__version__ = "0.1.0"
