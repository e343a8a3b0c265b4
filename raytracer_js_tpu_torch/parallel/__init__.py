"""Multi-device parallelism: rays sharded over the ranks of a
``torch.distributed`` process group, the scene replicated, gradients
all-reduced once (``sharding``); process bootstrap (``distributed``); a
tiny sharded training dry run (``dryrun``)."""
from .sharding import (
    float_leaf_names,
    float_partition,
    make_mesh,
    render_hdr_sharded,
    sharded_fit_step,
)

__all__ = [
    "float_leaf_names",
    "float_partition",
    "make_mesh",
    "render_hdr_sharded",
    "sharded_fit_step",
]
