"""paddle.vision's counterpart, PyTorch port: so far the model zoo of
`models` (`paddle_tpu/vision/models`: the conv nets and the Vision
Transformer)."""
from . import models  # noqa: F401
from .models import *  # noqa: F401,F403
from .models import __all__ as _models

__all__ = ["models", *_models]
