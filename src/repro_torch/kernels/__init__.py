# Hand-written Hopper kernels for the serving hot spots (multi-adapter LoRA
# BGMV/SGMV, split-KV flash-decode and flash-decode with the LoRA delta
# fused in), each beside its plain PyTorch version.
from . import ops, ref  # noqa: F401
