"""Hand-written CUDA kernels (sources in ``csrc/``, built at first use),
and the limits of the H100 that their launch plans are sized by."""
import functools

SMEM_LIMIT = 232_448  # dynamic shared memory one H100 block may opt into
SM_SMEM = 233_472  # shared memory of one H100 SM (228 KB), of which ...
SMEM_PER_BLOCK = 1024  # ... each resident block reserves 1 KB
SM_BLOCKS = 32  # resident blocks one H100 SM holds at most
SM_WARPS = 64  # resident warps one H100 SM holds at most
H100_SMS = 132


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The number of SMs of CUDA device ``index``."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count
