from .config import ModelConfig, ShapeConfig, SHAPES, applicable_shapes  # noqa
from .transformer import Model  # noqa
