"""Multi-device parallelism. Only the scene's differentiable-parameter
partition is ported so far; ray sharding over devices is ROADMAP A13."""
from .sharding import float_leaf_names, float_partition

__all__ = ["float_leaf_names", "float_partition"]
