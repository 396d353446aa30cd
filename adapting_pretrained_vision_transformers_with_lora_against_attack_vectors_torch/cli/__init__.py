from .main import build_parser, main  # noqa: F401
