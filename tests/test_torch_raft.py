"""Port parity: SEA-RAFT (align3r_tpu_torch.models.raft) and classic RAFT
(models/raft1.py) against the JAX package's RAFTs on the CPU, fp32.

Weights reach both sides from the same source: a JAX init_raft tree copied
one to one (raft_from_jax), or a synthetic reference-format state dict (torch
modules, BatchNorm running statistics made non-trivial) through both
packages' converters. Inputs are numpy-seeded. Tolerances are stated per
test: the correlation pyramid and lookup are a few fp32 products, the
forwards chain ~40 convolutions and a refinement loop whose fp32 rounding
differs between XLA and PyTorch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as tnn

from align3r_tpu.models import raft as jraft
from align3r_tpu.models import raft1 as jraft1
from align3r_tpu_torch.models import raft as traft
from align3r_tpu_torch.models import raft1 as traft1

from test_raft1 import _tiny_sd as raft1_state_dict

torch.set_num_threads(2)
TINY = dict(dim=32, radius=2, corr_levels=3, initial_dim=16, block_dims=(16, 24, 32),
            n_blocks=(1, 1, 1), num_refine=1, iters=3)
JTINY, TTINY = jraft.RAFTConfig(**TINY), traft.RAFTConfig(**TINY)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _images(seed, B, H, W):
    r = np.random.default_rng(seed)
    return [r.uniform(0, 255, (B, H, W, 3)).astype(np.float32) for _ in range(2)]


def _raft2_state_dict(cfg, seed=0):
    """Reference-layout SEA-RAFT state dict from torch modules."""
    torch.manual_seed(seed)
    sd = {}

    def conv(name, i, o, k, groups=1):
        c = tnn.Conv2d(i, o, k, groups=groups)
        sd[f"{name}.weight"], sd[f"{name}.bias"] = c.weight.detach(), c.bias.detach()

    def bn(name, c):
        sd[f"{name}.weight"] = 1 + 0.1 * torch.randn(c)
        sd[f"{name}.bias"] = 0.1 * torch.randn(c)
        sd[f"{name}.running_mean"] = 0.1 * torch.randn(c)
        sd[f"{name}.running_var"] = torch.rand(c) * 0.4 + 0.8

    def fpn(pfx, in_dim, out_dim):
        conv(f"{pfx}.conv1", in_dim, cfg.initial_dim, 7)
        bn(f"{pfx}.bn1", cfg.initial_dim)
        ip = cfg.initial_dim
        for li, (n, dim) in enumerate(zip(cfg.n_blocks, cfg.block_dims), start=1):
            for bi in range(n):
                i, q = (ip if bi == 0 else dim), f"{pfx}.layer{li}.{bi}"
                conv(f"{q}.conv1", i, dim, 3)
                conv(f"{q}.conv2", dim, dim, 3)
                bn(f"{q}.bn1", dim)
                bn(f"{q}.bn2", dim)
                if (li > 1 and bi == 0) or i != dim:
                    conv(f"{q}.downsample.0", i, dim, 1)
                    bn(f"{q}.bn3", dim)
            ip = dim
        conv(f"{pfx}.final_conv", cfg.block_dims[-1], out_dim, 1)

    D = cfg.dim
    fpn("module.cnet", 6, 2 * D)
    fpn("module.fnet", 3, 2 * D)
    conv("init_conv", 2 * D, 2 * D, 3)
    conv("flow_head.0", D, 2 * D, 3)
    conv("flow_head.2", 2 * D, 6, 3)
    conv("upsample_weight.0", D, 2 * D, 3)
    conv("upsample_weight.2", 2 * D, 576, 1)
    for name, i, o, k in (("convc1", cfg.corr_channel, 2 * D, 1),
                          ("convc2", 2 * D, D + D // 2, 3), ("convf1", 2, D, 7),
                          ("convf2", D, D // 2, 3), ("conv", 2 * D, D - 2, 3)):
        conv(f"update_block.encoder.{name}", i, o, k)
    for i in range(cfg.num_refine):
        pfx = f"update_block.refine.{i}"
        conv(f"{pfx}.dwconv", 3 * D, 3 * D, 7, groups=3 * D)
        sd[f"{pfx}.norm.weight"] = 1 + 0.1 * torch.randn(3 * D)
        sd[f"{pfx}.norm.bias"] = 0.1 * torch.randn(3 * D)
        for name, (i2, o2) in (("pwconv1", (3 * D, 4 * D)), ("pwconv2", (4 * D, 3 * D))):
            lin = tnn.Linear(i2, o2)
            sd[f"{pfx}.{name}.weight"], sd[f"{pfx}.{name}.bias"] = (lin.weight.detach(),
                                                                    lin.bias.detach())
        sd[f"{pfx}.gamma"] = 0.5 * torch.rand(3 * D)
        conv(f"{pfx}.final", 3 * D, D, 1)
    return {k: v.numpy() for k, v in sd.items()}


def test_corr_pyramid_and_lookup_match_jax():
    """build_corr_pyramid to 1e-6 and lookup_corr (one-hot form, coords
    partly outside the volume) to 1e-5 of the largest value."""
    r = np.random.default_rng(0)
    f1, f2 = (r.standard_normal((2, 6, 10, 16)).astype(np.float32) for _ in range(2))
    coords = r.uniform(-3, 12, (2, 6, 10, 2)).astype(np.float32)
    for jcfg, tcfg in ((JTINY, TTINY), (jraft.SPRING_M, traft.SPRING_M)):
        jp = jraft.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), jcfg)
        tp = traft.build_corr_pyramid(torch.from_numpy(f1), torch.from_numpy(f2), tcfg)
        assert len(tp) == len(jp) == tcfg.corr_levels
        for a, b in zip(tp, jp):
            assert a.shape == b.shape and _rel(a.numpy(), b) <= 1e-6
        jl = jraft.lookup_corr(jp, jnp.asarray(coords), jcfg)
        tl = traft.lookup_corr(tp, torch.from_numpy(coords), tcfg)
        assert tuple(tl.shape) == (2, 6, 10, tcfg.corr_channel)
        assert _rel(tl.numpy(), jl) <= 1e-5
    c0 = np.asarray(jraft1.build_corr_pyramid_raft1(jnp.asarray(f1), jnp.asarray(f2), 3)[-1])
    t0 = traft1.build_corr_pyramid_raft1(torch.from_numpy(f1), torch.from_numpy(f2), 3)[-1]
    assert t0.shape == c0.shape and _rel(t0.numpy(), c0) <= 1e-6


def test_upsample_and_padding_match_jax():
    r = np.random.default_rng(1)
    flow = r.standard_normal((2, 3, 4, 2)).astype(np.float32)
    info = r.standard_normal((2, 3, 4, 4)).astype(np.float32)
    mask = r.standard_normal((2, 3, 4, 576)).astype(np.float32)
    jf, ji = jraft.upsample_data(jnp.asarray(flow), jnp.asarray(info), jnp.asarray(mask))
    tf, ti = traft.upsample_data(*(torch.from_numpy(a) for a in (flow, info, mask)))
    assert _rel(tf.numpy(), jf) <= 1e-6 and _rel(ti.numpy(), ji) <= 1e-6
    assert _rel(traft1.upsample_flow(torch.from_numpy(flow), torch.from_numpy(mask)).numpy(),
                jraft1.upsample_flow(jnp.asarray(flow), jnp.asarray(mask))) <= 1e-6
    img = r.uniform(0, 1, (1, 37, 51, 3)).astype(np.float32)
    jpad, jpads = jraft.pad_to_8(jnp.asarray(img))
    tpad, tpads = traft.pad_to_8(torch.from_numpy(img))
    assert tuple(tpads) == tuple(jpads)
    np.testing.assert_array_equal(tpad.numpy(), np.asarray(jpad))


def test_raft_forward_matches_jax_from_jax_params():
    """SEA-RAFT at a tiny config from JAX init_raft weights (raft_from_jax),
    two pairs at 37x51 (padded to 40x56), 3 refinement steps. Flow to 1e-4
    of its largest value."""
    params = jax.tree.map(np.asarray, jraft.init_raft(jax.random.PRNGKey(0), JTINY))
    a, b = _images(2, 2, 37, 51)
    ref = jraft.raft_forward(jax.tree.map(jnp.asarray, params), jnp.asarray(a),
                             jnp.asarray(b), JTINY)
    model = traft.raft_from_jax(params, TTINY)
    got = traft.raft_forward(model, torch.from_numpy(a), torch.from_numpy(b))
    assert tuple(got.shape) == (2, 37, 51, 2) and got.dtype == torch.float32
    assert _rel(got.numpy(), ref) <= 1e-4, _rel(got.numpy(), ref)


def test_spring_m_from_state_dict_matches_jax():
    """Spring-M at full width on one 32x48 pair, 4 refinement steps, from a
    synthetic reference-format state dict through both converters (BN
    folding included). Flow to 1e-4 of its largest value."""
    sd = _raft2_state_dict(traft.SPRING_M)
    a, b = _images(3, 1, 32, 48)
    jp = jraft.convert_raft2_state_dict(sd, jraft.SPRING_M)
    ref = jraft.raft_forward(jp, jnp.asarray(a), jnp.asarray(b), jraft.SPRING_M, iters=4)
    model = traft.convert_raft2_state_dict(sd)
    got = traft.raft_forward(model, torch.from_numpy(a), torch.from_numpy(b), iters=4)
    assert _rel(got.numpy(), ref) <= 1e-4, _rel(got.numpy(), ref)
    # the converter folds BatchNorm exactly as JAX's does
    np.testing.assert_allclose(model.cnet.layer2[0].bn3.scale.numpy(),
                               np.asarray(jp["cnet"]["layer2"][0]["bn3"]["scale"]), rtol=1e-6)


def test_raft1_forward_matches_jax():
    """Classic RAFT (full-width encoders, InstanceNorm fnet, folded cnet
    BatchNorms) from a synthetic reference state dict through both
    converters, one 48x64 pair, 3 GRU steps. Flow to 1e-4 of its largest
    value."""
    cfg = jraft1.RAFT1Config(iters=3)
    sd = raft1_state_dict(cfg)
    a, b = _images(4, 1, 45, 61)
    ref = jraft1.raft1_forward(jraft1.convert_raft1_state_dict(sd, cfg), jnp.asarray(a),
                               jnp.asarray(b), cfg)
    model = traft1.convert_raft1_state_dict(sd, traft1.RAFT1Config(iters=3))
    got = traft1.raft1_forward(model, torch.from_numpy(a), torch.from_numpy(b))
    assert tuple(got.shape) == (1, 45, 61, 2)
    assert _rel(got.numpy(), ref) <= 1e-4, _rel(got.numpy(), ref)


def test_load_raft_auto_and_device(tmp_path):
    """'M' in the file name picks SEA-RAFT, else RAFT1; the loaders default
    to the card and raise where CUDA is absent."""
    sd2 = _raft2_state_dict(traft.SPRING_M)
    sd1 = raft1_state_dict(jraft1.RAFT1Config())
    torch.save({k: torch.from_numpy(v) for k, v in sd2.items()}, tmp_path / "Tartan-M.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd1.items()}, tmp_path / "raft-sintel.pth")
    m2, kind2 = traft1.load_raft_auto(str(tmp_path / "Tartan-M.pth"), device="cpu")
    m1, kind1 = traft1.load_raft_auto(str(tmp_path / "raft-sintel.pth"), device="cpu")
    assert (kind2, kind1) == ("raft2", "raft1")
    assert isinstance(m2, traft.RAFT2) and isinstance(m1, traft1.RAFT1)
    assert not any(p.requires_grad for p in m2.parameters())
    ref = traft.convert_raft2_state_dict(sd2)
    for (k, v), (k2, v2) in zip(m2.state_dict().items(), ref.state_dict().items()):
        assert k == k2 and torch.equal(v, v2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            traft1.load_raft_auto(str(tmp_path / "Tartan-M.pth"))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            traft1.load_raft_auto(str(tmp_path / "raft-sintel.pth"))


def test_init_raft_is_seeded_and_runs():
    """init_raft_ draws the JAX init_raft distributions from a seed: the
    same seed gives the same weights, the flows are finite."""
    a, b = (torch.from_numpy(x) for x in _images(5, 1, 24, 32))
    m1 = traft.init_raft_(traft.RAFT2(TTINY), seed=3)
    m2 = traft.init_raft_(traft.RAFT2(TTINY), seed=3)
    for v1, v2 in zip(m1.state_dict().values(), m2.state_dict().values()):
        assert torch.equal(v1, v2)
    dw = m1.update_block.refine[0].dwconv.weight
    assert abs(dw.std().item() - 0.02) < 0.005 and (m1.update_block.refine[0].gamma == 1e-6).all()
    assert torch.isfinite(traft.raft_forward(m1, a, b)).all()
    r1 = traft.init_raft_(traft1.RAFT1(traft1.RAFT1Config(iters=2)), seed=0)
    assert torch.isfinite(traft1.raft1_forward(r1, a, b)).all()
