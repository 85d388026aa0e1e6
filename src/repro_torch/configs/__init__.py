from .registry import ARCH_IDS, ALIASES, canonical, get_config, get_reduced  # noqa
from .shapes import input_specs  # noqa
