"""bf16 products the JAX package keeps in f32, on the CPU.

The JAX package computes the MLP's gate and up, the logits, the MoE
experts' gate and up (and the dropless oracle's down product), the
RG-LRU's ``gate_b`` and the SSD's ``dt`` as products of bf16 operands with
``preferred_element_type=jnp.float32`` and computes on from the f32
result.  The port takes them through ``layers.matmul_f32``/``bmm_f32``,
whose plain version on the CPU is the f32 product of the bf16 values.
Rounding those products to bf16 first, as a bf16 ``x @ w`` does, moves
the logits by ~2e-3 relative and changes ~60 % of the MLP's bf16 outputs.

Inputs are bf16, drawn from numpy generators (seeds below); the same bits
go to both packages.  Limits:

* ``unembed`` (tied, untied, with a softcap): max |port - jax| / max |jax|
  <= 1e-5;
* a bf16 value one f32 product away from the inputs, the MLP's hidden
  (``mlp_hidden``): at most 1 % of it differs from JAX's, each element by
  at most one bf16 spacing (``_held_bf16``);
* the MLP's down product of JAX's own hidden: bit for bit;
* a bf16 output behind a second product, ``apply_mlp`` (SwiGLU, GELU),
  ``apply_moe``'s dense dispatch, ``apply_moe_ref`` and ``apply_rglru``:
  at most 1 % of the outputs differ from JAX's, and none by more than
  2**-8 * max |jax|, one bf16 spacing of the output's scale
  (``_held_out``).  Not one spacing of each element: the two packages'
  BLAS sum the f32 products in different orders, which flips a rare
  rounding tie of the bf16 hidden, and the second product carries that
  one spacing of the hidden onto outputs near zero as several of theirs;
* each of those tests also runs the port with its f32 products rounded to
  bf16 (``_products_in_bf16``), the fault these tests are here for, and
  asserts that its limits refuse it;
* ``apply_ssd``: ``dt`` within 1e-5 of the JAX einsum, and the output bit
  for bit what the port's earlier ``x.float() @ w_dt.float()`` gave.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.models import layers, moe, rglru, ssm  # noqa: E402

D, F, V = 256, 512, 1024
SHAPE = (4, 7, D)
REL_TOL, ULP_SHARE = 1e-5, 0.01


def _bf16(rng, shape, scale=1.0):
    """(jax bf16 array, torch bf16 tensor) of the same bits."""
    j = jnp.asarray((rng.standard_normal(shape) * scale).astype(np.float32),
                    jnp.bfloat16)
    return j, bridge.tensor(np.asarray(j))


def _tree(p):
    return bridge.to_torch(jax.tree.map(np.asarray, p))


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got.float().numpy() - want))
                 / np.max(np.abs(want)))


def _ulps(got, want):
    """Each bf16 output's distance from JAX's in bf16 spacings: the bit
    patterns mapped to integers ordered as the values they encode."""
    def key(a):
        b = a.astype(np.int32)
        return np.where(b < 0, -(b & 0x7FFF), b)
    g = got.view(torch.int16).numpy()
    w = np.asarray(want).view(np.int16)
    return np.abs(key(g) - key(w))


def _held_bf16(got, want):
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    ulps = _ulps(got, want)
    share = float(np.mean(ulps > 0))
    assert ulps.max() <= 1, ulps.max()
    assert share <= ULP_SHARE, share


def _departure(got, want):
    """(the share of bf16 outputs that differ from JAX's, max |port - jax|
    in units of 2**-8 * max |jax|)."""
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    want32 = np.asarray(want, np.float32)
    err = np.max(np.abs(got.float().numpy() - want32))
    return (float(np.mean(_ulps(got, want) > 0)),
            float(err / (2.0 ** -8 * np.max(np.abs(want32)))))


def _held_out(got, want):
    share, err = _departure(got, want)
    assert share <= ULP_SHARE, share
    assert err <= 1.0, err


def _refused(got, want):
    share, err = _departure(got, want)
    assert share > ULP_SHARE or err > 1.0, (share, err)


def _products_in_bf16(monkeypatch):
    """The port's f32 products rounded to bf16 before they are used."""
    monkeypatch.setattr(layers, "matmul_f32", lambda x, w: (x @ w).float())
    monkeypatch.setattr(layers, "bmm_f32",
                        lambda a, b: torch.bmm(a, b).float())


@pytest.mark.parametrize("tied,softcap", [(False, 0.0), (True, 0.0),
                                          (True, 30.0), (False, 30.0)])
def test_unembed_logits_in_f32(tied, softcap):
    rng = np.random.default_rng(0)
    jx, tx = _bf16(rng, SHAPE)
    if tied:
        jw, tw = _bf16(rng, (V, D), 0.02)
        jp, tp = {"embed": jw}, {"embed": tw}
    else:
        jw, tw = _bf16(rng, (D, V), D ** -0.5)
        jp, tp = {"unembed": jw}, {"unembed": tw}
    want = jlayers.unembed(jp, jx, softcap)
    got = layers.unembed(tp, tx, softcap)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got, want) <= REL_TOL


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_apply_mlp_gate_and_up_in_f32(kind, monkeypatch):
    rng = np.random.default_rng(1)
    jx, tx = _bf16(rng, SHAPE)
    names = ("w_gate", "w_up") if kind == "swiglu" else ("w_up",)
    jp, tp = {}, {}
    for name in names:
        jp[name], tp[name] = _bf16(rng, (D, F), D ** -0.5)
    jp["w_down"], tp["w_down"] = _bf16(rng, (F, D), F ** -0.5)
    # JAX's hidden and down product, as jlayers.apply_mlp computes them
    up = jnp.einsum("...d,df->...f", jx, jp["w_up"],
                    preferred_element_type=jnp.float32)
    if kind == "swiglu":
        gate = jnp.einsum("...d,df->...f", jx, jp["w_gate"],
                          preferred_element_type=jnp.float32)
        jh = (jax.nn.silu(gate) * up).astype(jnp.bfloat16)
    else:
        jh = jax.nn.gelu(up).astype(jnp.bfloat16)
    want_down = jnp.einsum("...f,fd->...d", jh, jp["w_down"],
                           preferred_element_type=jnp.float32
                           ).astype(jnp.bfloat16)
    want = jlayers.apply_mlp(kind, jp, jx)
    assert np.array_equal(np.asarray(want_down).view(np.int16),
                          np.asarray(want).view(np.int16))

    _held_bf16(layers.mlp_hidden(kind, tp, tx), jh)
    got_down = bridge.tensor(np.asarray(jh)) @ tp["w_down"]
    assert np.array_equal(got_down.view(torch.int16).numpy(),
                          np.asarray(want_down).view(np.int16))
    _held_out(layers.apply_mlp(kind, tp, tx), want)

    _products_in_bf16(monkeypatch)
    with pytest.raises(AssertionError):
        _held_bf16(layers.mlp_hidden(kind, tp, tx), jh)
    _refused(layers.apply_mlp(kind, tp, tx), want)


def _moe_case(t):
    cfg = jax_reduced("olmoe-1b-7b")
    p = jmoe.init_moe(jax.random.PRNGKey(0), cfg.d_model, cfg.d_ff,
                      cfg.n_experts, jnp.bfloat16)
    jx, tx = _bf16(np.random.default_rng(2), (t, cfg.d_model))
    return dict(top_k=cfg.top_k, n_experts=cfg.n_experts), p, _tree(p), jx, tx


@pytest.mark.parametrize("t", [8, 257])
def test_apply_moe_dense_dispatch_in_f32(t, monkeypatch):
    kw, jp, tp, jx, tx = _moe_case(t)
    want = jmoe.apply_moe(jp, jx, capacity_factor=1.25, **kw)[0]
    _held_out(moe.apply_moe(tp, tx, capacity_factor=1.25, **kw)[0], want)
    _products_in_bf16(monkeypatch)
    _refused(moe.apply_moe(tp, tx, capacity_factor=1.25, **kw)[0], want)


def test_apply_moe_ref_in_f32(monkeypatch):
    kw, jp, tp, jx, tx = _moe_case(257)
    want = jmoe.apply_moe_ref(jp, jx, **kw)
    _held_out(moe.apply_moe_ref(tp, tx, **kw), want)
    _products_in_bf16(monkeypatch)
    _refused(moe.apply_moe_ref(tp, tx, **kw), want)


def test_apply_rglru_gate_in_f32(monkeypatch):
    cfg = dataclasses.replace(jax_reduced("recurrentgemma-9b"),
                              dtype="bfloat16")
    jp = jrglru.init_rglru(jax.random.PRNGKey(1), cfg, jnp.bfloat16)
    jx, tx = _bf16(np.random.default_rng(3), (2, 13, cfg.d_model))
    want = jrglru.apply_rglru(jp, jx)[0]
    _held_out(rglru.apply_rglru(_tree(jp), tx)[0], want)
    _products_in_bf16(monkeypatch)
    _refused(rglru.apply_rglru(_tree(jp), tx)[0], want)


def test_apply_ssd_dt_unchanged(monkeypatch):
    cfg = dataclasses.replace(jax_reduced("mamba2-2.7b"), dtype="bfloat16")
    jp = jssm.init_ssd(jax.random.PRNGKey(1), cfg, jnp.bfloat16)
    tp = _tree(jp)
    jx, tx = _bf16(np.random.default_rng(4), (2, 12, cfg.d_model))
    want_dt = jnp.einsum("bsd,dk->bsk", jx, jp["w_dt"],
                         preferred_element_type=jnp.float32)
    got_dt = layers.matmul_f32(tx, tp["w_dt"])
    assert got_dt.dtype == torch.float32
    assert _rel(got_dt, want_dt) <= REL_TOL
    got = ssm.apply_ssd(tp, tx, cfg)[0]
    # the port's dt before the helper: both operands upcast
    monkeypatch.setattr(layers, "matmul_f32",
                        lambda x, w: x.float() @ w.float())
    assert torch.equal(ssm.apply_ssd(tp, tx, cfg)[0], got)
