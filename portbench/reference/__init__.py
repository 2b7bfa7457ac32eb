"""Plain PyTorch references of the benchmark's links.

Each module here restates one configuration's link from its published
tables (``data/``) in plain PyTorch and NumPy.  It imports nothing of
the program under test.  ``chain(config, device)`` returns an object
with ``frame_bits``, ``n_symbols``, ``noise_std(snr_db)`` and
``transceive(bits, noise, noise_std, dtype) -> (decoded bits, extras)``;
``dtype`` is ``torch.float32`` for the reference and a lower precision
for the control.
"""
import importlib


def chain(config: dict, device):
    """The reference chain that ``config["reference"]`` names."""
    module = importlib.import_module(f"portbench.reference.{config['reference']}")
    return module.chain(config, device)
