"""Multi-device parallelism: device meshes, sharded extraction, serving and
training.

Port of ``mermaid_classifier_tpu/parallel/``. The JAX package lays a
``jax.sharding.Mesh`` over the chips from one controller and lets XLA derive
the collectives; the port runs one process per device (SPMD, as ``torchrun``
starts them) over ``torch.distributed`` (NCCL on cards, gloo on the CPU when
asked for), every rank given the same global inputs:

- ``mesh``            — mesh construction (data x model dims);
- ``sharded_extract`` — data-parallel backbone feature extraction;
- ``sharded_serve``   — the batch-sharded calibrated head;
- ``sharded_train``   — the data + tensor parallel MLP-head training step;
- ``preflight``       — the production programs at real shapes on ``meta``.
"""

from mermaid_classifier_tpu_torch.parallel.mesh import (  # noqa: F401
    MeshSpec,
    make_mesh,
)
from mermaid_classifier_tpu_torch.parallel.sharded_extract import (  # noqa: F401
    make_sharded_feature_fn,
)
from mermaid_classifier_tpu_torch.parallel.sharded_train import (  # noqa: F401
    ShardedHeadTrainer,
)
