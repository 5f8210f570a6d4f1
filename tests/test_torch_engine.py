"""Port parity: the Align3R network and the pairwise engine of
align3r_tpu_torch against align3r_tpu on TINY_TEST, from the same seeded
JAX weights carried across by `state_dict_from_jax`.

The zero convs are overwritten with seeded random values (random init zeroes
them, and the prior branch would then change nothing) and the final head
conv is scaled by 0.1 (random DPT heads otherwise saturate expm1).
Tolerances:
- fp32: 1e-5 relative to the largest value (same math, other sum order);
- bf16: 5e-2 relative to the largest value — the JAX engine on the CPU runs
  the unfused XLA attention path, which rounds at other points than the
  fused-site semantics the port implements (P normalised before its bf16
  rounding, RoPE by a matmul), and those one-ulp differences compound
  through 4 encoder and 12 decoder layers and the bf16 DPT head.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from align3r_tpu.inference.engine import inference as jinference
from align3r_tpu.inference.pairs import make_pairs
from align3r_tpu.models import blocks as jB
from align3r_tpu.models.align3r import init_align3r
from align3r_tpu.models.config import TINY_TEST
from align3r_tpu.models.convert import export_state_dict
from align3r_tpu.models.dpt_head import apply_dpt_head as japply_head
from align3r_tpu.models.rope import make_grid_positions as jgrid
from align3r_tpu_torch.inference.engine import inference as tinference
from align3r_tpu_torch.models import blocks as tB
from align3r_tpu_torch.models.align3r import Align3R
from align3r_tpu_torch.models.convert import state_dict_from_jax
from align3r_tpu_torch.models.dpt_head import apply_dpt_head as tapply_head

torch.set_num_threads(2)
CFG = TINY_TEST
N_IMG, H, W = 6, 48, 64


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def _numpy_init(seed=0):
    """init_align3r's parameter tree (structure by jax.eval_shape) filled
    from a numpy seed with its distributions: dense kernels xavier-uniform,
    conv kernels U(+-1/sqrt(fan_in)), biases 0, LayerNorm (1, 0). Much
    faster on the CPU than running the JAX initialisers op by op."""
    r = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: init_align3r(k, CFG), jax.random.PRNGKey(0))

    def fill(path, leaf):
        names = [getattr(k, "key", "") for k in path]
        shape, last, parent = leaf.shape, names[-1], names[-2]
        if last == "scale":
            return np.ones(shape, np.float32)
        if last == "bias" or names[0] == "zero_convs":
            return np.zeros(shape, np.float32)
        if parent.endswith("_up"):                      # conv-transpose (in, s, s, out)
            b = shape[-4] ** -0.5
        elif len(shape) - (names[0].startswith("dec_blocks") or names[0] == "enc_blocks") == 4:
            b = float(np.prod(shape[-4:-1])) ** -0.5    # conv HWIO
        else:                                           # dense (in, out)
            b = np.sqrt(6.0 / (shape[-2] + shape[-1]))
        return r.uniform(-b, b, shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def weights():
    params = jax.tree.map(jnp.asarray, _numpy_init())
    r = np.random.default_rng(0)
    params["zero_convs"]["kernel"] = jnp.asarray(
        0.05 * r.standard_normal(params["zero_convs"]["kernel"].shape), jnp.float32)
    for h in ("head1", "head2"):
        params[h]["head_conv3"]["kernel"] = params[h]["head_conv3"]["kernel"] * 0.1
    model = Align3R(CFG)
    model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params), CFG),
                          strict=True)
    return params, model


def test_state_dict_from_jax_matches_export(weights):
    params, model = weights
    ref = export_state_dict(params, CFG)
    got = state_dict_from_jax(jax.tree.map(np.asarray, params), CFG)
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    # the module's own state_dict has exactly the reference keys
    assert set(model.state_dict()) == set(ref)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_engine_matches_jax(weights, dtype):
    params, model = weights
    r = np.random.default_rng(1)
    imgs = r.uniform(-1, 1, (N_IMG, H, W, 3)).astype(np.float32)
    priors = r.uniform(0, 1, (N_IMG, H, W, 3)).astype(np.float32)
    pairs = make_pairs(N_IMG, "swinstride-2-noncyclic", symmetrize=True)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "fp32"
                else (jnp.bfloat16, torch.bfloat16))
    ref = jinference(pairs, params, CFG, jnp.asarray(imgs), jnp.asarray(priors),
                     batch_size=4, dtype=jdt, head_dtype=jdt)
    got = tinference(pairs, model.prepare(tdt, tdt, device="cpu"), imgs, priors, batch_size=4,
                     encode_chunk=4)
    np.testing.assert_array_equal(got["view1"]["idx"], ref["view1"]["idx"])
    np.testing.assert_array_equal(got["view2"]["idx"], ref["view2"]["idx"])
    tol = 1e-5 if dtype == "fp32" else 5e-2
    for k, v in (("pred1", "pts3d"), ("pred1", "conf"),
                 ("pred2", "pts3d_in_other_view"), ("pred2", "conf")):
        a = got[k][v]
        assert tuple(a.shape) == tuple(ref[k][v].shape) and a.dtype == torch.float32
        assert _rel(a.numpy(), ref[k][v]) <= tol, (k, v, _rel(a.numpy(), ref[k][v]))


def test_blocks_match_jax(weights):
    """Encoder block and the stacked dual-stream decoder block on prepared
    weights against the JAX blocks (XLA path), fp32."""
    params, model = weights
    pm = model.prepare(torch.float32, torch.float32, device="cpu")
    r = np.random.default_rng(2)
    gh, gw = 3, 4
    x = r.standard_normal((2, gh * gw, CFG.enc_embed_dim)).astype(np.float32)
    pos = jgrid(gh, gw, batch=2)
    layer = jax.tree.map(lambda a: a[1], params["enc_blocks"])
    ref = jB.apply_block(layer, jnp.asarray(x), pos, CFG.enc_num_heads)
    got = tB.apply_block_prepared(pm.enc_blocks[1], torch.from_numpy(x)[None],
                         torch.from_numpy(np.asarray(pos[0])), CFG.enc_num_heads)[0]
    assert _rel(got.numpy(), ref) <= 1e-5
    y = r.standard_normal((2, 2, gh * gw, CFG.dec_embed_dim)).astype(np.float32)
    lg = jax.tree.map(lambda a, b: jnp.stack([a[3], b[3]]), params["dec_blocks"],
                      params["dec_blocks2"])
    ref = jB.apply_decoder_block_stacked(lg, jnp.asarray(y),
                                         jnp.stack([pos, pos]), CFG.dec_num_heads)
    got = tB.apply_decoder_layer_prepared(pm.dec_layers[3], torch.from_numpy(y),
                                         torch.from_numpy(np.asarray(pos[0])),
                                         CFG.dec_num_heads)
    assert _rel(got.numpy(), ref) <= 1e-5


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_dpt_head_matches_jax(weights, dtype):
    """The DPT head (XLA conv path; final conv and postprocess pinned fp32)."""
    params, model = weights
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "fp32"
                else (jnp.bfloat16, torch.bfloat16))
    pm = model.prepare(tdt, tdt, device="cpu")
    r = np.random.default_rng(3)
    gh, gw = H // 16, W // 16
    hooks = [r.standard_normal((2, gh * gw, d)).astype(np.float32)
             for d in CFG.dpt_dim_tokens()]
    head = jax.jit(lambda p, hk: japply_head(p, hk, (gh, gw), (H, W), CFG.depth_mode,
                                             CFG.conf_mode, dtype=jdt))
    ref = head(params["head1"], [jnp.asarray(h) for h in hooks])
    got = tapply_head(pm.head1, [torch.from_numpy(h) for h in hooks], (gh, gw),
                      (H, W), CFG.depth_mode, CFG.conf_mode, dtype=tdt)
    tol = 1e-5 if dtype == "fp32" else 2e-2
    for k in ("pts3d", "conf"):
        assert got[k].dtype == torch.float32
        assert _rel(got[k].numpy(), ref[k]) <= tol, (k, _rel(got[k].numpy(), ref[k]))
