"""EfficientNet-attention models (eval and train forward) and checkpoint conversion."""

from psla_tpu_torch.models.effnet_att import EffNetAttention
from psla_tpu_torch.models.registry import MODEL_REGISTRY, create_model

__all__ = ["EffNetAttention", "MODEL_REGISTRY", "create_model"]
