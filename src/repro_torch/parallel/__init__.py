from repro_torch.parallel.sharding import (  # noqa: F401
    DEFAULT_RULES, LogicalRules, constrain, distribute, get_rules,
    logical_spec, mesh_placements, placements, set_rules, shard_bytes,
    spec_tree,
)
