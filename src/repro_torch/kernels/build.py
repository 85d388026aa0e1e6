"""Build and load the port's CUDA kernels (``csrc/``) for Hopper (sm_90a).

The build runs at first use, inside the process that launches a kernel, and
writes to ``build/torch_kernels/`` at the root of the checkout (``build/``
is git-ignored).  It is never triggered by an import: the CPU tests import
every module and never build.

One ``torch.utils.cpp_extension.load`` call compiles every ``.cu`` source
(in parallel, through ninja) and the one binding file that includes
PyTorch's headers (``csrc/binding.cpp``).  The extension exposes
``kernels().bgmv(...)``, ``.sgmv(...)``, ``.flash_decode(...)``,
``.flash_decode_int8(...)`` and ``.flash_decode_lora(...)``, taking device
pointers, sizes, dtype codes and the stream as Python numbers.
"""
from __future__ import annotations

import functools
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
CU_SOURCES = ("bgmv.cu", "sgmv.cu", "flash_decode.cu")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NAME = "repro_torch_kernels"
ARCH_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # csrc/common.cuh


def dtype_code(dtype) -> int:
    """The kernels' element-type code."""
    if dtype not in DTYPE_CODES:
        raise TypeError(f"kernels take float32 or bfloat16, not {dtype}")
    return DTYPE_CODES[dtype]


@functools.lru_cache(maxsize=None)
def kernels():
    """Build (once per process) and return the kernel extension."""
    from torch.utils import cpp_extension
    BUILD_DIR.mkdir(parents=True, exist_ok=True)  # load() does not
    return cpp_extension.load(
        name=NAME,
        sources=[str(CSRC / "binding.cpp")] + [str(CSRC / s)
                                               for s in CU_SOURCES],
        build_directory=str(BUILD_DIR),
        extra_cflags=["-O2"],
        extra_cuda_cflags=ARCH_FLAGS,
        verbose=False)


def stream_handle(device) -> int:
    """The current CUDA stream of ``device`` as an integer handle."""
    return torch.cuda.current_stream(device).cuda_stream
