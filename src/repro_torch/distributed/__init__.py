"""Distributed placement of the port (port of ``repro.distributed``): the
DP/FSDP x TP x EP x SP sharding plan, the mapper trainer's data-parallel
mesh, the serving replicas' placement, and GPipe pipeline stages over
``torch.distributed`` point-to-point."""
from .sharding import (param_specs, batch_specs, decode_state_specs_sharded,
                       shard_spec_for_path, data_parallel_mesh,
                       replicate_tree, shard_leading_axis)

__all__ = ["param_specs", "batch_specs", "decode_state_specs_sharded",
           "shard_spec_for_path", "data_parallel_mesh", "replicate_tree",
           "shard_leading_axis"]
