"""The LM stack of the port: configs, layers, flash attention (forward and
gradient), the fused CE loss, the MoE FFN (``models.moe``), the Mamba2
mixer (``models.ssm``) and the decoder (``repro_torch.models.model``)."""
from repro_torch.models.config import ModelConfig, MoESpec, SSMSpec  # noqa: F401
