"""ccsmeth_tpu_torch: the PyTorch + CUDA port of ccsmeth_tpu for NVIDIA Hopper.

It keeps ccsmeth_tpu's layout and module names so each part has a counterpart
there. Host code (BAM I/O, feature extraction, MM/ML tagging) is a copy of the
JAX package's numpy modules; the model is torch ``nn.Module``s; every Pallas
TPU kernel on a ported path becomes a CUDA kernel written by hand for sm_90a
(``ops/csrc/``), built with nvcc at first use. Entry points run on ``cuda``
unless the caller asks for the CPU, where each kernel's plain PyTorch version
runs instead.
"""

from ._version import __version__

__all__ = ["__version__"]
