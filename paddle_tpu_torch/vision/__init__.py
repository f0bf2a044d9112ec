"""paddle.vision's counterpart, PyTorch port: the model zoo (`models`: the
conv nets and the Vision Transformer), the host transforms
(`transforms`), the synthetic datasets (`datasets`), the detection ops
(`ops`) and the image backend switch (`paddle_tpu/vision/__init__.py`)."""
from . import datasets, models, ops, transforms  # noqa: F401
from .models import *  # noqa: F401,F403
from .models import __all__ as _models

__all__ = ["models", "transforms", "datasets", "ops", "set_image_backend",
           "get_image_backend", "image_load", *_models]

_IMAGE_BACKEND = "pil"


def set_image_backend(backend):
    """'pil' or 'cv2'."""
    global _IMAGE_BACKEND
    if backend not in ("pil", "cv2"):
        raise ValueError(f"backend must be 'pil' or 'cv2', got {backend!r}")
    _IMAGE_BACKEND = backend


def get_image_backend():
    return _IMAGE_BACKEND


def image_load(path, backend=None):
    """Open an image file: a PIL.Image with the 'pil' backend (PIL is
    imported at call time); 'cv2' is not bundled and raises."""
    backend = backend or _IMAGE_BACKEND
    if backend == "cv2":
        raise RuntimeError(
            "the cv2 backend is not bundled; use set_image_backend('pil')")
    from PIL import Image
    return Image.open(path)    # mode preserved (grayscale/palette/RGBA)
