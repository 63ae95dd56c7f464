"""A DeepSeek-V3 mixture-of-experts language model (latent attention,
routed and shared experts) as one chip's share of an expert-parallel
layer, trained through the parameter tables' device plane
(``trainer.py``)."""

from multiverso_tpu_torch.models.moe_lm.model import MoeLM, MoeLMConfig  # noqa: F401
from multiverso_tpu_torch.models.moe_lm.trainer import (  # noqa: F401
    MoeLMTrainer, config_from_published)
