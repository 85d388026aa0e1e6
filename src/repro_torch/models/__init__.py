from .config import ModelConfig  # noqa
from .transformer import Model  # noqa
