from repro_torch.parallel.sharding import (  # noqa: F401
    DEFAULT_RULES, LogicalRules, constrain, get_rules, logical_spec,
    set_rules, shard_bytes, spec_tree,
)
