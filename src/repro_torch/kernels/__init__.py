# Hand-written Hopper kernels for the serving hot spots (multi-adapter LoRA
# BGMV/SGMV and split-KV flash-decode), each beside its plain PyTorch version.
from . import ops, ref  # noqa: F401
