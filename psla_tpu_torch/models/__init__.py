"""The PSLA models (EfficientNet-attention, ResNet50-attention, MobileNetV2;
eval and train forward) and checkpoint conversion."""

from psla_tpu_torch.models.effnet_att import EffNetAttention
from psla_tpu_torch.models.mobilenet import MBNet
from psla_tpu_torch.models.registry import MODEL_REGISTRY, create_model
from psla_tpu_torch.models.resnet import ResNetAttention

__all__ = ["EffNetAttention", "MBNet", "MODEL_REGISTRY", "ResNetAttention", "create_model"]
