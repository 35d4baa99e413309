"""Parallelism layer of the port: the device mesh over the processes of a
``torch.distributed`` world, the FSDP sharding rules, the ring
collectives, the sequence-parallel attention (ring, ring-flash,
Ulysses) with heads on the ``tp`` axis and the pipeline schedules
(GPipe, 1F1B, interleaved) over ``pp`` — the port of
``k8s_tpu/parallel/``.  (``ring_attention`` the function is not
re-exported: the name is its module's.)"""

from k8s_tpu_torch.parallel.collectives import (  # noqa: F401
    MeshRings,
    ProcessGroupRing,
    Ring,
    ThreadRing,
    all_to_all,
    collective_matmul,
    ep_enter,
    ep_exit,
    host_local_array_to_global,
    mesh_rings,
    psum,
    ring_all_gather,
    ring_reduce_scatter,
    ring_shift,
    tp_enter,
    tp_exit,
)
from k8s_tpu_torch.parallel.mesh import (  # noqa: F401
    AXIS_ORDER,
    DcnConfig,
    MeshConfig,
    data_sharding,
    make_hybrid_mesh,
    make_mesh,
)
from k8s_tpu_torch.parallel.pipeline import (  # noqa: F401
    bubble_fraction,
    interleave_chunks,
    peak_activation_microbatches,
    pipeline_apply,
    pipeline_train_step_1f1b,
    pipeline_train_step_interleaved,
)
from k8s_tpu_torch.parallel.ring_attention import (  # noqa: F401
    reference_attention,
    ring_attention_local,
)
from k8s_tpu_torch.parallel.ring_flash import (  # noqa: F401
    ring_flash_attention,
    ring_flash_attention_local,
    ring_flash_backward,
    ring_flash_forward,
)
from k8s_tpu_torch.parallel.sharding import (  # noqa: F401
    fsdp_sharding,
    logical_to_spec,
)
from k8s_tpu_torch.parallel.ulysses import (  # noqa: F401
    ulysses_attention,
    ulysses_attention_local,
    ulysses_flash_backward,
    ulysses_flash_forward,
)
