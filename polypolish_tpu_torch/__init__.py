"""polypolish_tpu_torch — the PyTorch/CUDA port of polypolish_tpu.

The same Polypolish method as the JAX package beside it (reference:
rrwick/Polypolish v0.6.1, Rust), rebuilt for one NVIDIA Hopper GPU:

- Host layer (Python + the C++ engine via ctypes, its own copy of the
  JAX package's sam_packer.cc): SAM/FASTA I/O, read grouping, CIGAR
  walking, vocab interning, exact f64 depth and thresholds.
- Device layer (PyTorch + hand-written CUDA kernels in ``csrc/``):
  integer vote counting over the lane-aligned pack (lanes vote kernel)
  and its cap-overflow list (overflow vote kernel) or over the chunk
  layout (chunk vote kernel), then the elementwise consensus over the
  (vocab, position) count tensor.

Outputs are byte-identical to ``polypolish_tpu``: all device math is
integer.  The package imports neither jax nor polypolish_tpu.
"""

__version__ = "0.5.0"

TOOL_NAME = "Polypolish-TPU"

from polypolish_tpu_torch import errors as errors  # noqa: E402,F401
