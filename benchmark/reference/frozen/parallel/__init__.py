"""Multi-device training and rendering on ``torch.distributed`` (port of
``apnerf/parallel``): the process group (``distributed``) and the ray mesh
with its collectives and the ZeRO-1 split (``mesh``)."""
from .distributed import (host_local_batch, initialize, local_batch_slice,
                          shutdown)
from .mesh import (ZERO1_MIN_SIZE, Mesh, make_mesh, put_replicated,
                   writer)
