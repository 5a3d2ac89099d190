from efficientvideoclassification_youtube8m_torch.models import frame_level, video_level
from efficientvideoclassification_youtube8m_torch.models.base import (
    MODEL_REGISTRY,
    get_model,
    register_model,
)

__all__ = [
    "MODEL_REGISTRY",
    "get_model",
    "register_model",
    "frame_level",
    "video_level",
]
