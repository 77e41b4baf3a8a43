"""Multi-process data parallelism and classifier tensor parallelism on
``torch.distributed`` (JAX ``situation_recognition_tpu/parallel``)."""

from situation_recognition_tpu_torch.parallel.distributed import (  # noqa: F401
    destroy,
    fetch,
    init_distributed,
    is_main_process,
    preempt_agreed,
)
from situation_recognition_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    head_param_sharding,
    make_mesh,
)
