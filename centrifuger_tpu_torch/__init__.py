"""centrifuger_tpu_torch: the PyTorch/CUDA port of centrifuger_tpu.

The same FM-index metagenomic classifier, run on an NVIDIA Hopper card. The
host code (index build, taxonomy, readers, writer, the exact NumPy engine) is
kept as the port's own copy of the JAX package's modules; the device programs
become hand-written CUDA kernels (kernels/csrc) with plain PyTorch twins that
serve CPU tensors and act as the kernels' oracles.

Entry points run on `cuda` unless the caller passes device="cpu"; asking for
`cuda` on a host without a card raises.
"""

__version__ = "0.1.0"

VERSION_STRING = "1.1.3-r331"  # reference-compatible version string for .4.cfr metadata
