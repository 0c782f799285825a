from repro_torch.optim.adamw import (  # noqa: F401
    OptimConfig, abstract_opt_state, apply_updates, init_opt_state,
    learning_rate,
)
