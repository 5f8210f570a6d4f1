"""Port parity: tensor-parallel serving (align3r_tpu_torch.parallel.shardings,
parallel.mesh.make_mesh, the split K1/K2 sites and inference(mesh=)) against
the JAX package's ('data', 'model') mesh.

- The port's spec table gives every checkpoint tensor JAX's
  align3r_param_specs split (read off export_state_dict of one rank's
  shards), and shard_prepared's proj, fc1, fc2 and cross-attention
  projq/k/v/proj slices are the arrays JAX's shard_params puts on rank r of
  the 'model' axis, bit for bit.
- The pinned deviation: JAX splits the fused qkv kernel over its 3C axis,
  which is not aligned to heads (at m = 2 its rank 0 holds all of q and half
  of k); the port's rank r holds heads r H/m .. of q, of k and of v each.
- For the encoder block, the decoder layer and the prior-branch block at
  TINY_TEST in fp32, the sum over m simulated ranks' partials, finished,
  equals the whole prepared block within atol 1e-5 (the same products, the
  fp32 sums in another order). No process group is needed for this.
- The head-count guard raises with JAX's message.
- Four gloo processes (tests/torch_tp_worker.py) run make_mesh(2, 2) and then
  make_mesh(1, 4) in one world; every rank's result is held against JAX's
  inference(mesh=make_mesh(n_data=2, n_model=2)) and JAX's unsharded engine
  at TINY_TEST in fp32, atol and rtol 1e-4 (JAX's own tolerance,
  tests/test_inference.py:306-310). The JAX side runs in this process.
"""
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from align3r_tpu.inference.engine import inference as jinference
from align3r_tpu.inference.pairs import make_pairs
from align3r_tpu.models.config import Align3RConfig as JConfig
from align3r_tpu.models.convert import export_state_dict
from align3r_tpu.parallel.mesh import make_mesh as jmake_mesh
from align3r_tpu.parallel.shardings import shard_params
from align3r_tpu_torch.inference.engine import inference
from align3r_tpu_torch.models import blocks as B
from align3r_tpu_torch.models.align3r import Align3R
from align3r_tpu_torch.models.config import TINY_TEST, Align3RConfig
from align3r_tpu_torch.models.convert import state_dict_from_jax
from align3r_tpu_torch.models.rope import make_grid_positions
from align3r_tpu_torch.ops import fused_site as FS
from align3r_tpu_torch.parallel import mesh as tm
from align3r_tpu_torch.parallel import shardings as tsh
from test_torch_parallel import _launch
from test_torch_training import _weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JCFG = JConfig(**TINY_TEST.__dict__)


@pytest.fixture(scope="module")
def weights():
    """TINY_TEST's JAX params (test_torch_training._weights) with biases and
    LayerNorms moved off (0, 1) from a numpy seed, and the port's module and
    whole fp32 prepared weights from the same values."""
    r = np.random.default_rng(3)
    params, _ = _weights(TINY_TEST, seed=2)

    def perturb(path, leaf):
        if getattr(path[-1], "key", "") in ("bias", "scale"):
            return leaf + jnp.asarray(0.1 * r.standard_normal(leaf.shape), jnp.float32)
        return leaf

    params = jax.tree_util.tree_map_with_path(perturb, params)
    model = Align3R(TINY_TEST)
    model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params), TINY_TEST),
                          strict=True)
    return params, model, model.prepare(torch.float32, torch.float32, device="cpu")


def _jax_rank_state_dict(params, m, r):
    """export_state_dict of the shards JAX's shard_params puts on rank r of a
    (1, m) mesh's 'model' axis (every leaf's piece on that device)."""
    mesh = jmake_mesh(n_data=1, n_model=m)
    dev = mesh.devices[0, r]
    shards = jax.tree.map(lambda x: next(np.asarray(s.data) for s in x.addressable_shards
                                         if s.device == dev), shard_params(params, mesh))
    return export_state_dict(shards, JCFG)


@pytest.mark.parametrize("m", [2, 4])
def test_spec_table_is_jax_specs(weights, m):
    full = export_state_dict(jax.tree.map(np.asarray, weights[0]), JCFG)
    part = _jax_rank_state_dict(weights[0], m, 1)
    jax_dims = {}
    for name, t in full.items():
        split = [d for d in range(t.ndim) if part[name].shape[d] != t.shape[d]]
        assert len(split) <= 1 and all(part[name].shape[d] * m == t.shape[d] for d in split)
        jax_dims[name] = split[0] if split else None
    assert tsh.param_specs(full) == jax_dims
    assert {n.split(".")[0] for n, d in jax_dims.items() if d is not None} == set(
        tsh.STACK_SPECS)


@pytest.mark.parametrize("m,r", [(2, 0), (2, 1), (4, 2)])
def test_shard_prepared_slices_are_jax_shards(weights, m, r):
    """proj, fc1, fc2 and the cross-attention's projq/k/v and proj of every
    block, both decoder streams and the prior branch: rank r's prepared
    slices (stored (in, out)) are JAX's rank-r shards, bit for bit."""
    ref = _jax_rank_state_dict(weights[0], m, r)
    sh = tsh.shard_prepared(weights[2], m, r)
    assert sh.tp == (m, r)
    pairs = {"attn.proj.weight": ("wo", True), "mlp.fc1.weight": ("w1", True),
             "mlp.fc1.bias": ("b1", False), "mlp.fc2.weight": ("w2", True)}
    cross = {f"cross_attn.proj{x}.{t}": (f"c{x}" if t == "weight" else f"cb{x}",
                                         t == "weight") for x in "qkv" for t in ("weight", "bias")}
    cross["cross_attn.proj.weight"] = ("co", True)
    checked = 0
    for stack, sites, g, table in (
            ("enc_blocks", sh.enc_blocks, 0, pairs), ("dec_blocks", sh.dec_layers, 0,
                                                      {**pairs, **cross}),
            ("dec_blocks2", sh.dec_layers, 1, {**pairs, **cross}),
            ("dec_blocks_pc", sh.pc_blocks, 0, pairs)):
        for layer, site in enumerate(sites):
            for name, (key, weight) in table.items():
                got = site[key][g].numpy()
                want = ref[f"{stack}.{layer}.{name}"]
                np.testing.assert_array_equal(got.T if weight else got, want)
                checked += 1
    cfg = TINY_TEST
    assert checked == 4 * cfg.enc_depth + 11 * 2 * cfg.dec_depth + 4 * cfg.n_pc_blocks


def test_jax_qkv_split_is_not_aligned_to_heads(weights):
    """The pinned deviation at m = 2: JAX's rank 0 holds rows [0, 3C/2) of
    the fused (3C, C) qkv weight, all of q and the first half of k, and no
    v; the port's rank 0 holds the first half of the heads of q, k and v."""
    C = TINY_TEST.enc_embed_dim
    full = export_state_dict(jax.tree.map(np.asarray, weights[0]), JCFG)
    part = _jax_rank_state_dict(weights[0], 2, 0)
    sh = tsh.shard_prepared(weights[2], 2, 0)
    for layer in range(TINY_TEST.enc_depth):
        w = full[f"enc_blocks.{layer}.attn.qkv.weight"]
        jax0 = part[f"enc_blocks.{layer}.attn.qkv.weight"]
        np.testing.assert_array_equal(jax0, np.concatenate([w[:C], w[C:C + C // 2]]))
        port0 = [sh.enc_blocks[layer][k][0].numpy().T for k in ("wq", "wk", "wv")]
        for i, got in enumerate(port0):
            np.testing.assert_array_equal(got, w[i * C:i * C + C // 2])
        assert not np.array_equal(np.concatenate(port0), jax0)


def _steps(kind, p, x, pos, heads):
    fn = B.decoder_layer_steps if kind == "decoder" else B.block_steps
    return fn(p, x, pos, heads)


@pytest.mark.parametrize("kind", ["encoder", "decoder", "prior"])
@pytest.mark.parametrize("m", [2, 4])
def test_split_blocks_sum_to_the_whole_block(weights, kind, m):
    pm = weights[2]
    sites, G, C = {"encoder": ("enc_blocks", 1, 64), "decoder": ("dec_layers", 2, 48),
                   "prior": ("pc_blocks", 1, 48)}[kind]
    heads = TINY_TEST.enc_num_heads if kind == "encoder" else TINY_TEST.dec_num_heads
    pos = make_grid_positions(4, 6)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((G, 3, 24, C)).astype(
        np.float32))
    whole = getattr(pm, sites)[1]
    ref = (B.apply_decoder_layer_prepared if kind == "decoder" else B.apply_block_prepared)(
        whole, x, pos, heads)
    ranks = [_steps(kind, getattr(tsh.shard_prepared(pm, m, r), sites)[1], x, pos, heads)
             for r in range(m)]
    y = x
    for i in range(len(ranks[0])):
        partials = [steps[i][0](y) for steps in ranks]
        assert all(p.dtype == torch.float32 and p.shape == y.shape for p in partials)
        y = FS.finish(sum(partials), ranks[0][i][1], y.dtype, resid=y)
    assert len(ranks[0]) == (3 if kind == "decoder" else 2)
    np.testing.assert_allclose(y.numpy(), ref.numpy(), atol=1e-5, rtol=0)


def test_head_count_guard(weights):
    pm = weights[2]
    with pytest.raises(ValueError, match="divide the head counts"):
        tsh.shard_prepared(pm, 8, 0)
    with pytest.raises(ValueError, match="divide the head counts"):
        inference([(0, 1)], pm, np.zeros((2, 32, 32, 3), np.float32),
                  np.zeros((2, 32, 32, 3), np.float32), mesh=tm.Mesh(1, 8, None, None, 0, 0))
    # JAX's guard test's config: 4 encoder heads, 2 decoder heads
    cfg = Align3RConfig(img_size=(32, 32), enc_embed_dim=64, enc_depth=2, enc_num_heads=4,
                        dec_embed_dim=32, dec_depth=12, dec_num_heads=2)
    small = Align3R(cfg).prepare(torch.float32, torch.float32, device="cpu")
    with pytest.raises(ValueError, match="divide the head counts"):
        tsh.shard_prepared(small, 4, 0)
    assert tsh.shard_prepared(small, 2, 1).tp == (2, 1)
    # a share is refused by a mesh that wants another share, and split once only
    with pytest.raises(ValueError, match="split 2 ways"):
        tsh.for_mesh(tsh.shard_prepared(pm, 2, 0), tm.Mesh(1, 2, None, None, 0, 1))
    with pytest.raises(ValueError, match="already split"):
        tsh.shard_prepared(tsh.shard_prepared(pm, 2, 0), 2, 0)


def test_make_mesh_without_a_process_group():
    mesh = tm.make_mesh()
    assert mesh == tm.Mesh(1, 1, None, None, 0, 0) == tm.make_mesh(1, 1)
    with pytest.raises(ValueError, match="does not cover"):
        tm.make_mesh(2, 2)


def test_block_bytes_of_a_share(weights):
    pm = weights[2]
    whole = tsh.block_bytes(pm)
    for m in (2, 4):
        share = tsh.block_bytes(tsh.shard_prepared(pm, m, m - 1))
        assert whole / m < share < whole / m * 1.1


# ---------------------------------------------------- four-process check

@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory, weights):
    d = str(tmp_path_factory.mktemp("tp"))
    r = np.random.default_rng(11)
    n, H, W = 5, 32, 48
    imgs = r.uniform(-1, 1, (n, H, W, 3)).astype(np.float32)
    priors = r.uniform(0, 1, (n, H, W, 3)).astype(np.float32)
    pairs = np.array(make_pairs(n, "complete", symmetrize=True), np.int32)   # 20 edges
    np.savez(os.path.join(d, "engine.npz"), pairs=pairs, imgs=imgs, priors=priors)
    torch.save(weights[1].state_dict(), os.path.join(d, "weights.pth"))
    _launch([sys.executable, os.path.join(REPO, "tests", "torch_tp_worker.py"), d], n=4)
    kw = dict(batch_size=4, encode_chunk=4, dtype=jnp.float32, head_dtype=jnp.float32,
              attn_impl="xla", encode_attn_impl="xla")
    jpairs = [tuple(p) for p in pairs]
    refs = {"unsharded": jinference(jpairs, weights[0], JCFG, imgs, priors, **kw),
            "tp 2x2": jinference(jpairs, weights[0], JCFG, imgs, priors,
                                 mesh=jmake_mesh(n_data=2, n_model=2), **kw)}
    yield d, refs
    shutil.rmtree(d, ignore_errors=True)


@pytest.mark.parametrize("layout", ["2x2", "1x4"])
def test_tp_engine_matches_jax(four_ranks, layout):
    d, refs = four_ranks
    outs = [np.load(os.path.join(d, f"tp_{layout}.rank{r}.npz")) for r in range(4)]
    for side, key in (("pred1", "pts3d"), ("pred2", "pts3d_in_other_view"),
                      ("pred1", "conf"), ("pred2", "conf")):
        for name, ref in refs.items():
            want = np.asarray(ref[side][key])
            for r, out in enumerate(outs):
                np.testing.assert_allclose(out[f"{side}/{key}"], want, atol=1e-4, rtol=1e-4,
                                           err_msg=f"{layout} rank {r} {side}.{key} vs {name}")
