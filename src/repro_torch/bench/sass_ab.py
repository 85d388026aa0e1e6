"""Whether two checkouts' CUDA kernels compile to the same machine code.

    PYTHONPATH=src python3 -m repro_torch.bench.sass_ab \\
        <checkout A> <checkout B> [flash_decode.cu ...]

Compiles each named source of ``src/repro_torch/kernels/csrc`` (default:
every ``.cu`` file) of both checkouts to a cubin with the flags the
extension's build gives ``nvcc``, taken from where the build takes them
(``kernels/build.py``'s ``ARCH_FLAGS`` and ``torch.utils.cpp_extension``'s
``COMMON_NVCC_FLAGS``; the language standard is nvcc's default, where the
build takes torch's, the same for both sides), dumps each with
``cuobjdump -sass`` and
compares the kernels by name: the anonymous namespace's name, which
hashes the source's path, is replaced first, and each body's trailing
blank lines dropped.  Prints one line per source, ``SASS {json}``: the
kernels whose code is the same, those that differ, and those only one
side has.  Needs ``nvcc`` and ``cuobjdump`` (the CUDA toolkit); no GPU.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

from torch.utils.cpp_extension import COMMON_NVCC_FLAGS

from ..kernels.build import ARCH_FLAGS

CSRC = Path("src") / "repro_torch" / "kernels" / "csrc"
FLAGS = [*ARCH_FLAGS, *COMMON_NVCC_FLAGS]
ANON = re.compile(r"\d*_GLOBAL__N__\w+?_cu_[0-9a-f]+")


def kernels(root: Path, source: str, tmp: Path) -> dict:
    """{kernel name: SASS text} of ``source`` in checkout ``root``."""
    cubin = tmp / f"{root.resolve().name}_{source}.cubin"
    subprocess.run(["nvcc", *FLAGS, "-cubin", "-o", str(cubin),
                    str(root / CSRC / source)], check=True)
    dump = subprocess.run(["cuobjdump", "-sass", str(cubin)], check=True,
                          capture_output=True, text=True).stdout
    out, name = {}, None
    for line in dump.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = ANON.sub("ANON", m.group(1))
            out[name] = []
        elif name is not None:
            out[name].append(ANON.sub("ANON", line))
    return {k: "\n".join(v).rstrip() for k, v in out.items()}


def main(argv) -> int:
    a, b = Path(argv[1]), Path(argv[2])
    sources = argv[3:] or sorted(p.name for p in (b / CSRC).glob("*.cu"))
    with tempfile.TemporaryDirectory() as tmp:
        for side in ("a", "b"):
            (Path(tmp) / side).mkdir()
        for source in sources:
            ka = kernels(a, source, Path(tmp) / "a")
            kb = kernels(b, source, Path(tmp) / "b")
            same = sorted(k for k in ka.keys() & kb.keys() if ka[k] == kb[k])
            print("SASS " + json.dumps({
                "source": source, "same": len(same),
                "differ": sorted(k for k in ka.keys() & kb.keys()
                                 if ka[k] != kb[k]),
                "only_a": sorted(ka.keys() - kb.keys()),
                "only_b": sorted(kb.keys() - ka.keys())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
