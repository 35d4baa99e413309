"""In-pod launcher of the port (the operator's env contract)."""

from k8s_tpu_torch.launcher.bootstrap import (  # noqa: F401
    LauncherConfig,
    apply_platform_env,
    barrier,
    initialize_distributed,
    make_training_mesh,
    setup_observability,
    stop_observability,
)
