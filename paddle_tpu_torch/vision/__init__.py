"""paddle.vision's counterpart, PyTorch port: so far the Vision
Transformer of `models` (`paddle_tpu/vision/models/vit.py`)."""
from . import models  # noqa: F401
from .models import VisionTransformer, vit_b_16, vit_l_16, vit_l_32  # noqa: F401

__all__ = ["models", "VisionTransformer", "vit_b_16", "vit_l_16", "vit_l_32"]
