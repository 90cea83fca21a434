"""qrag_tpu_torch — the PyTorch/CUDA port of ``qrag_tpu``.

Exact retrieval (norm-bounded window pruning over a device-resident
corpus, bf16 or int8 scan), the int8-quantized index, and the fused
quantum-fidelity rerank, served over HTTP, on PyTorch with hand-written
CUDA C++ kernels for NVIDIA Hopper; the trained cross-encoder and
bi-encoder, at inference and in training; the MCP ingestion tools and
server.  The JAX
package ``qrag_tpu`` is the reference; this package imports nothing of
jax or ``qrag_tpu``, and no pydantic.

Layer map (bottom-up):
  csrc/      CUDA C++ kernels (built with nvcc at first use)
  ops/       plain-torch ops and the kernels' wrappers
  index/     FAISS-format IO, device-resident flat and quantized indexes
  models/    the trained cross-encoder and bi-encoder (inference, training)
  engine.py  retrieval + fused fidelity rerank
  tools/     the ingestion tools (read, embed, store, search)
  serving/   stdlib HTTP server, MCP server and client
  config.py, pipeline/, utils/   config tree, embedders, storage, metrics
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

from qrag_tpu_torch.config import (  # noqa: E402
    ClassicalConfig,
    ControllerConfig,
    IndexConfig,
    QragConfig,
    QuantumConfig,
    ServingConfig,
)
from qrag_tpu_torch.device import resolve_device  # noqa: E402
from qrag_tpu_torch.documents import Document  # noqa: E402

__all__ = [
    "Document",
    "QragConfig",
    "ControllerConfig",
    "ClassicalConfig",
    "QuantumConfig",
    "IndexConfig",
    "ServingConfig",
    "resolve_device",
    "__version__",
]
