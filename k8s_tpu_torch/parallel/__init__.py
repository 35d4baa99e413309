"""Parallelism layer of the port: the device mesh over the processes of a
``torch.distributed`` world and the FSDP sharding rules (the port of
``k8s_tpu/parallel/mesh.py`` and ``sharding.py``).  Sequence, tensor and
pipeline parallelism come with ROADMAP.md Queue 1 item 8b."""

from k8s_tpu_torch.parallel.mesh import (  # noqa: F401
    AXIS_ORDER,
    DcnConfig,
    MeshConfig,
    data_sharding,
    make_hybrid_mesh,
    make_mesh,
)
from k8s_tpu_torch.parallel.sharding import (  # noqa: F401
    fsdp_sharding,
    logical_to_spec,
)
