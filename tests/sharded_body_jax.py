"""The JAX package's sequence-sharded decode body on 4 host devices.

Usage: python tests/sharded_body_jax.py <inputs.npz> <outputs.npz>

Runs ``repro.models.attention.decode_attention_sharded`` under the JAX
package's ``shard_map`` shim, the cache cut over a ``model`` axis of 4, on
the inputs' q, caches (and int8 scales), new K/V and pos, and writes the
output and the updated caches.  A subprocess of
tests/test_torch_distributed.py: the device count must be set before jax
initialises.
"""
import math
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.launch.mesh import make_test_mesh  # noqa: E402
from repro.models.attention import decode_attention_sharded  # noqa: E402
from repro.models.transformer import shard_map  # noqa: E402


def main(src, dst):
    inp = dict(np.load(src))
    n = 4
    mesh = make_test_mesh(1, n)
    quant = "k_scale" in inp
    d = inp["q"].shape[-1]
    cspec, sspec = P(None, "model", None, None), P(None, "model", None)

    def body(q, kc, vc, nk, nv, pos, *scales):
        return decode_attention_sharded(
            q, kc, vc, nk, nv, pos, axis_name="model", n_shards=n,
            scale=1.0 / math.sqrt(d), k_scale=scales[0] if quant else None,
            v_scale=scales[1] if quant else None)

    in_specs = [P(), cspec, cspec, P(), P(), P()] + [sspec, sspec] * quant
    out_specs = [P(), cspec, cspec] + [sspec, sspec] * quant
    args = [inp["q"], inp["k"], inp["v"], inp["new_k"], inp["new_v"],
            jnp.int32(inp["pos"])]
    if quant:
        args += [inp["k_scale"], inp["v_scale"]]
    f = jax.jit(shard_map(body, mesh=mesh, in_specs=tuple(in_specs),
                          out_specs=tuple(out_specs), check_vma=False))
    outs = [np.asarray(o) for o in f(*args)]
    names = ["out", "k", "v", "k_scale", "v_scale"][:len(outs)]
    np.savez(dst, **dict(zip(names, outs)))


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
