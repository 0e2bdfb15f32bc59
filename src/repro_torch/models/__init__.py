from .common import ModelConfig
from .lm import Model, build_model

__all__ = ["Model", "ModelConfig", "build_model"]
