from . import convnext, hf_import, swin, vit, yolo11  # noqa: F401
from .pretrained import load_pretrained  # noqa: F401
from .registry import (ModelEntry, available_models, create_model, get_model,  # noqa: F401
                       get_normalization)
