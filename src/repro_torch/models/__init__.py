"""The LM stack of the port: configs, layers, flash attention and the dense
decoder (``repro_torch.models.model``)."""
from repro_torch.models.config import ModelConfig, MoESpec, SSMSpec  # noqa: F401
