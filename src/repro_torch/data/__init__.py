from .pipeline import DataConfig, TokenPipeline  # noqa
