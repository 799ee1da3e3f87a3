"""bpt_tpu_torch — the PyTorch + CUDA port of bpt_tpu.

Module paths mirror ``bpt_tpu`` so each counterpart is easy to find.  The
package imports ``torch`` and ``numpy`` only: never JAX and never
``bpt_tpu``.  Plain tensor code is PyTorch; the hot path (the fused PT
megakernel) is a CUDA C++ kernel for Hopper under ``csrc/``, built on first
use by ``ops/kernels/build.py``.  CPU tensors take each kernel's plain
PyTorch version; CUDA tensors launch the kernel or raise.
"""

__version__ = "0.1.0"
