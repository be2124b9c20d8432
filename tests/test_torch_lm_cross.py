"""The port's cross-attention (``layers.cross_attn_defs``, ``context_kv``,
``apply_cross_attn``) and encoder (``model.encode``) against the JAX
package's, on the same numpy weights and inputs, at smoke size.

The gate is drawn non-zero: under ``init_params`` it is zero, and tanh(0)
silences the block.  Tolerances: f32 to 2e-6 on the O(1) k, v and gated
outputs (sums over 64 terms in another order), 1e-5 on the encoder's
output after 2 layers; bf16 to 2^-6 of the output's scale.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke_config
from repro.models import layers as jl
from repro.models import model as jm
from repro_torch import configs, convert
from repro_torch.models import layers as tl
from repro_torch.models import model as tm

VLM, AUDIO = "llama-3.2-vision-11b", "seamless-m4t-medium"


def _draw(defs, seed):
    rng = np.random.default_rng(seed)
    return {name: rng.standard_normal(shape, dtype=np.float32)
            * np.float32(1.0 / np.sqrt(shape[0]) if len(shape) >= 2 else 0.5)
            for name, (shape, _axes, _init) in sorted(defs.items())}


def _close(t, j, atol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), atol=atol, rtol=0)


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_context_kv_and_gated_cross_attn_match_reference(arch):
    cfg, jcfg = configs.smoke_config(arch), jsmoke_config(arch)
    p = _draw(tl.cross_attn_defs(cfg), 0)
    assert set(p) == set(jl.cross_attn_defs(jcfg)) and abs(p["gate"][0]) > 0.05
    rng = np.random.default_rng(1)
    ctx = rng.standard_normal((2, cfg.n_context_tokens, cfg.d_model), dtype=np.float32)
    x = rng.standard_normal((2, 5, cfg.d_model), dtype=np.float32)
    jp, tp = jax.tree.map(jnp.asarray, p), jax.tree.map(torch.as_tensor, p)
    jkv = jl.context_kv(jcfg, jp, jnp.asarray(ctx))
    tkv = tl.context_kv(cfg, tp, torch.as_tensor(ctx))
    for t, j in zip(tkv, jkv, strict=True):
        assert t.shape == j.shape == (2, cfg.n_context_tokens, cfg.n_kv_heads, cfg.head_dim)
        _close(t, j, 2e-6)
    jy = jl.apply_cross_attn(jcfg, jp, jnp.asarray(x), context_kv=jkv)
    ty = tl.apply_cross_attn(cfg, tp, torch.as_tensor(x), context_kv=tkv)
    _close(ty, jy, 2e-6)
    assert float(np.abs(np.asarray(jy)).max()) > 0.05       # the gate lets it through
    # bf16 queries against the f32 context's k, v (the launcher's context is f32)
    jy16 = jl.apply_cross_attn(jcfg, jp, jnp.asarray(x).astype(jnp.bfloat16), context_kv=jkv)
    ty16 = tl.apply_cross_attn(cfg, tp, torch.as_tensor(x).to(torch.bfloat16), context_kv=tkv)
    assert ty16.dtype == torch.bfloat16
    _close(ty16, jy16, 2 ** -6 * float(np.abs(np.asarray(jy16, np.float32)).max()))


@pytest.fixture(scope="module")
def chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_cross", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_reference(chip_smoke, dtype):
    """The bidirectional encoder (2 attention + dense-MLP layers at smoke
    size, its own final norm) over stub frames."""
    import dataclasses

    cfg = dataclasses.replace(configs.smoke_config(AUDIO), dtype=dtype)
    jcfg = dataclasses.replace(jsmoke_config(AUDIO), dtype=dtype)
    p = chip_smoke.lm_numpy_params(cfg, 3)
    frames = np.random.default_rng(4).standard_normal((2, cfg.n_context_tokens, cfg.d_model),
                                                      dtype=np.float32)
    jy = jm.encode(jcfg, jax.tree.map(jnp.asarray, p), jnp.asarray(frames))
    ty = tm.encode(cfg, convert.lm_params_from_reference(p, device="cpu"),
                   torch.as_tensor(frames))
    assert str(ty.dtype).removeprefix("torch.") == str(jy.dtype) == dtype
    scale = float(np.abs(np.asarray(jy, np.float32)).max())
    _close(ty, jy, 1e-5 if dtype == "float32" else 2 ** -6 * scale)
    # bidirectional: the first frame's output depends on the last frame
    moved = frames.copy()
    moved[:, -1] += 1.0
    ty2 = tm.encode(cfg, convert.lm_params_from_reference(p, device="cpu"),
                    torch.as_tensor(moved))
    assert float((ty2[:, 0] - ty[:, 0]).abs().max()) > 1e-3
