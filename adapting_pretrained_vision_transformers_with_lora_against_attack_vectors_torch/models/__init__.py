from .registry import ModelEntry, create_model, get_model, get_normalization  # noqa: F401
