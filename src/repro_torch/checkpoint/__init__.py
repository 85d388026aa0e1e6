from .manager import CheckpointManager, copy_into  # noqa
