from .config import ModelConfig  # noqa
from .transformer import Model, pad_cache  # noqa
