"""Port parity: the sin-cos position embeddings (pos_embed="cosine") and the
linear head of align3r_tpu_torch against align3r_tpu.

The cosine network is TINY_TEST with pos_embed="cosine", from the same
seeded weights on both sides (carried across by `state_dict_from_jax`, as
tests/test_torch_engine.py does). Tolerances: the tables 1e-6 absolute
(fp32 sin and cos of the same arguments); the fp32 engine 1e-5 relative to
the largest value (same math, other sum order); the linear head 1e-5
absolute, as the JAX test against torch's pixel_shuffle.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from align3r_tpu.inference.engine import inference as jinference
from align3r_tpu.inference.pairs import make_pairs
from align3r_tpu.models.config import TINY_TEST
from align3r_tpu.models.linear_head import apply_linear_head as japply_linear
from align3r_tpu.models.linear_head import init_linear_head
from align3r_tpu.models.rope import make_grid_positions as jgrid
from align3r_tpu.models.rope import sincos_pos_embed as jsincos
from align3r_tpu_torch.inference.engine import inference as tinference
from align3r_tpu_torch.models.align3r import Align3R
from align3r_tpu_torch.models.config import TINY_TEST as T_TINY
from align3r_tpu_torch.models.convert import state_dict_from_jax
from align3r_tpu_torch.models.linear_head import LinearHead, apply_linear_head
from align3r_tpu_torch.models.rope import make_grid_positions, sincos_pos_embed
from test_torch_engine import _numpy_init, _rel

torch.set_num_threads(2)
CFG = dataclasses.replace(TINY_TEST, pos_embed="cosine")
T_CFG = dataclasses.replace(T_TINY, pos_embed="cosine")
N_IMG, H, W = 4, 48, 64


@pytest.mark.parametrize("dim", [16, 64, 1024])
def test_sincos_tables_match_jax(dim):
    got = sincos_pos_embed(make_grid_positions(18, 32), dim).numpy()
    ref = np.asarray(jsincos(jgrid(18, 32), dim))
    assert got.shape == ref.shape == (18 * 32, dim)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def weights():
    params = jax.tree.map(jnp.asarray, _numpy_init(seed=3))
    r = np.random.default_rng(3)
    params["zero_convs"]["kernel"] = jnp.asarray(
        0.05 * r.standard_normal(params["zero_convs"]["kernel"].shape), jnp.float32)
    for h in ("head1", "head2"):
        params[h]["head_conv3"]["kernel"] = params[h]["head_conv3"]["kernel"] * 0.1
    model = Align3R(T_CFG)
    model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params), T_CFG),
                          strict=True)
    return params, model


def test_cosine_engine_matches_jax(weights):
    """The fp32 engine with pos_embed="cosine" (tables on the encoder tokens
    and both decoder streams, identity RoPE tables at the sites) against
    JAX's; and it differs from the same weights under RoPE100."""
    params, model = weights
    r = np.random.default_rng(1)
    imgs = r.uniform(-1, 1, (N_IMG, H, W, 3)).astype(np.float32)
    priors = r.uniform(0, 1, (N_IMG, H, W, 3)).astype(np.float32)
    pairs = make_pairs(N_IMG, "complete", symmetrize=True)
    ref = jinference(pairs, params, CFG, jnp.asarray(imgs), jnp.asarray(priors),
                     batch_size=4, dtype=jnp.float32, head_dtype=jnp.float32)
    pm = model.prepare(torch.float32, torch.float32, device="cpu")
    got = tinference(pairs, pm, imgs, priors, batch_size=4, encode_chunk=4)
    for k, v in (("pred1", "pts3d"), ("pred1", "conf"),
                 ("pred2", "pts3d_in_other_view"), ("pred2", "conf")):
        assert _rel(got[k][v].numpy(), ref[k][v]) <= 1e-5, (k, v)
    rope = tinference(pairs, dataclasses.replace(pm, cfg=T_TINY), imgs, priors,
                      batch_size=4, encode_chunk=4)
    assert _rel(rope["pred1"]["pts3d"].numpy(), ref["pred1"]["pts3d"]) > 1e-3


def test_cosine_training_forward_matches_engine(weights):
    """Align3R.forward (the training path, fp32, plain attention) with
    pos_embed="cosine" gives the engine's outputs on the same pair."""
    _, model = weights
    r = np.random.default_rng(2)
    v = lambda: {"img": torch.from_numpy(r.uniform(-1, 1, (2, H, W, 3)).astype(np.float32)),
                 "pred_depth": torch.from_numpy(r.uniform(0, 1, (2, H, W, 3))
                                                .astype(np.float32))}
    v1, v2 = v(), v()
    with torch.no_grad():
        r1, r2 = model(v1, v2, dtype=torch.float32, attn_impl="xla", remat="none")
    imgs = torch.cat([v1["img"], v2["img"]])
    priors = torch.cat([v1["pred_depth"], v2["pred_depth"]])
    got = tinference([(0, 2), (1, 3)], model.prepare(torch.float32, torch.float32,
                                                     device="cpu"), imgs, priors)
    assert _rel(r1["pts3d"].numpy(), got["pred1"]["pts3d"].numpy()) <= 1e-5
    assert _rel(r2["pts3d_in_other_view"].numpy(),
                got["pred2"]["pts3d_in_other_view"].numpy()) <= 1e-5


def test_linear_head_raises_in_align3r():
    with pytest.raises(NotImplementedError):
        Align3R(dataclasses.replace(T_TINY, head_type="linear"))


@pytest.mark.parametrize("crop", [False, True])
def test_linear_head_matches_jax(crop):
    D, P, nh, nw = 24, 4, 3, 5
    p = init_linear_head(jax.random.PRNGKey(0), D, P, has_conf=True)
    p["proj"]["bias"] = jax.random.normal(jax.random.PRNGKey(2), p["proj"]["bias"].shape)
    tokens = jax.random.normal(jax.random.PRNGKey(1), (2, nh * nw, D))
    img = (nh * P - 3, nw * P - 2) if crop else (nh * P, nw * P)
    head = LinearHead(D, P)
    with torch.no_grad():
        head.proj.weight.copy_(torch.from_numpy(np.array(p["proj"]["kernel"])).T)
        head.proj.bias.copy_(torch.from_numpy(np.array(p["proj"]["bias"])))
    t = torch.from_numpy(np.array(tokens))
    raw = head(t, (nh, nw), img)
    ref = np.asarray(japply_linear(p, tokens, (nh, nw), img, P))
    assert tuple(raw.shape) == ref.shape == (2, *img, 4)
    np.testing.assert_allclose(raw.detach().numpy(), ref, atol=1e-5)
    modes = (TINY_TEST.depth_mode, TINY_TEST.conf_mode)
    out = apply_linear_head(head.proj.weight, head.proj.bias, t, (nh, nw), img, P, *modes)
    jout = japply_linear(p, tokens, (nh, nw), img, P, *modes)
    for k in ("pts3d", "conf"):
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(jout[k]),
                                   rtol=1e-5, atol=1e-5)
