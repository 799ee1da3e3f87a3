"""Multi-device rendering: pixel- and sample-sharded renders over a list
of devices (``mesh``) and over a ``torch.distributed`` process group
(``multiprocess``, ``worker``, ``launch``)."""

from bpt_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    render_distributed,
    render_spp_sharded,
)
from bpt_tpu_torch.parallel.multiprocess import render_multiprocess  # noqa: F401
