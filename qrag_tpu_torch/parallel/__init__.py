"""Several devices and processes (PyTorch port of ``qrag_tpu.parallel``):
the mesh and ``distributed_init`` on ``torch.distributed``
(``mesh.py``), the collectives the reference leaves to XLA
(``collectives.py``), the row-sharded index (``sharded_index.py``) and
its elastic wrapper (``elastic.py``), within one process or across
several, and training on one device or sharded DP x TP/EP
(``train.py``).  Sequence parallelism is
``qrag_tpu_torch.models.sequence_parallel``."""

from qrag_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    distributed_init,
    make_mesh,
    process_count,
    process_index,
)
from qrag_tpu_torch.parallel.sharded_index import ShardedFlatIndex

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "distributed_init",
    "make_mesh",
    "process_count",
    "process_index",
    "ShardedFlatIndex",
]
