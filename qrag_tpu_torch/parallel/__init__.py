"""The mesh of one process (``mesh.py``), the row-sharded index
(``sharded_index.py``), its elastic wrapper (``elastic.py``) and
training on one device (``train.py``).  Several processes, the sharded
trainer and sequence parallelism are not ported yet (ROADMAP.md,
Queue 1)."""

from qrag_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    distributed_init,
    make_mesh,
)
from qrag_tpu_torch.parallel.sharded_index import ShardedFlatIndex

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "distributed_init",
    "make_mesh",
    "ShardedFlatIndex",
]
