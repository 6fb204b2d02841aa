"""The PSLA models (EfficientNet-attention, ResNet50-attention, MobileNetV2;
eval and train forward), the Audio Spectrogram Transformer, and checkpoint
conversion."""

from psla_tpu_torch.models.effnet_att import EffNetAttention
from psla_tpu_torch.models.mobilenet import MBNet
from psla_tpu_torch.models.registry import MODEL_REGISTRY, create_model
from psla_tpu_torch.models.resnet import ResNetAttention
from psla_tpu_torch.models.spectrogram_transformer import ASTModel

__all__ = ["ASTModel", "EffNetAttention", "MBNet", "MODEL_REGISTRY", "ResNetAttention",
           "create_model"]
