"""qrag_tpu_torch — the PyTorch/CUDA port of ``qrag_tpu``.

Exact retrieval (norm-bounded window pruning over a device-resident
corpus) and the fused quantum-fidelity rerank, served over HTTP, on
PyTorch with a hand-written CUDA C++ kernel for NVIDIA Hopper.  The JAX
package ``qrag_tpu`` is the reference; this package imports no jax.

Layer map (bottom-up):
  csrc/      CUDA C++ kernels (built with nvcc at first use)
  ops/       plain-torch ops and the kernels' wrappers
  index/     FAISS-format IO, device-resident flat index
  engine.py  retrieval + fused fidelity rerank
  serving/   stdlib HTTP server
"""

import torch

__version__ = "0.1.0"

# Exact paths score in IEEE fp32: a TF32 matmul (~3 decimal digits)
# would void the bounded certificates' margin arithmetic.
if (
    torch.backends.cuda.matmul.allow_tf32
    or torch.get_float32_matmul_precision() != "highest"
):
    raise RuntimeError(
        "qrag_tpu_torch needs IEEE fp32 matmuls: set "
        "torch.backends.cuda.matmul.allow_tf32 = False and "
        "torch.set_float32_matmul_precision('highest')"
    )

from qrag_tpu_torch.device import resolve_device  # noqa: E402

__all__ = ["resolve_device", "__version__"]
