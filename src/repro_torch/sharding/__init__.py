"""Sharding for the port: meshes and collectives over torch.distributed
(``utils``) and the spec rules (``rules``); the JAX package's exports,
without ``shard_hint`` (eager PyTorch has no partitioner to constrain)."""
from repro_torch.sharding.rules import (DRAFTER_RULES, PARAM_RULES,
                                        cache_specs, param_specs,
                                        serve_param_specs, serve_state_specs)
from repro_torch.sharding.utils import (Mesh, Shard, axis_size, batch_axes,
                                        mesh_scope, serving_mesh, spec_for)

__all__ = ["axis_size", "batch_axes", "param_specs", "cache_specs",
           "DRAFTER_RULES", "PARAM_RULES", "serve_param_specs",
           "serve_state_specs", "Mesh", "Shard", "mesh_scope",
           "serving_mesh", "spec_for"]
