"""The reference at TINY_TEST size: it runs, and it computes what the
program computes (the program's plain float32 path on the CPU)."""
import numpy as np
import pytest
import torch

from benchmark.harness import weights as W
from benchmark.reference import align3r as ref_align3r
from benchmark.reference import common as C
from benchmark.reference import loader as ref_loader
from benchmark.reference import priors as ref_priors
from benchmark.tests import tiny


def test_align3r_matches_the_programs_float32_path():
    from align3r_tpu_torch.inference.engine import inference
    from align3r_tpu_torch.models.align3r import Align3R
    from align3r_tpu_torch.models.config import parse_model_string
    ref = ref_align3r.build(tiny.TINY_NET)
    state = W.make_state(ref, "align3r", 2 ** 35 + 3, "cpu")
    W.load(ref, state)
    with torch.device("meta"):
        net = Align3R(parse_model_string(tiny.TINY_MODEL))
    W.load(net, state)
    pm = net.prepare(dtype=torch.float32, head_dtype=torch.float32, device="cpu")
    g = torch.Generator().manual_seed(0)
    imgs = torch.rand(3, 32, 64, 3, generator=g) * 2 - 1
    clouds = torch.rand(3, 32, 64, 3, generator=g)
    pairs = [(0, 1), (2, 0), (1, 2)]
    out = inference(pairs, pm, imgs, clouds, batch_size=2)
    P = C.Precision()
    r1, r2 = ref.pairs(P, ref.encode(P, imgs), clouds, torch.tensor([0, 2, 1]),
                       torch.tensor([1, 0, 2]), (32, 64))
    for a, b in ((out["pred1"]["pts3d"], r1["pts3d"]), (out["pred1"]["conf"], r1["conf"]),
                 (out["pred2"]["pts3d_in_other_view"], r2["pts3d_in_other_view"])):
        assert torch.linalg.vector_norm(a - b) <= 1e-4 * torch.linalg.vector_norm(b)


@pytest.mark.parametrize("name", ["align3r_vitl512_depthpro", "align3r_vitl512_dav2"])
def test_priors_match_the_programs_float32_path(name):
    from align3r_tpu_torch.models import depth_anything as da
    from align3r_tpu_torch.models import depth_pro as dp
    from align3r_tpu_torch.models import nn as L
    pc = tiny.tiny_config(name)["prior"]
    ref = ref_priors.build(pc)
    state = W.make_state(ref, "prior", 2 ** 36 + 5, "cpu")
    W.load(ref, state)
    x01 = torch.rand(2, 40, 96, 3, generator=torch.Generator().manual_seed(1))
    P = C.Precision()
    with torch.device("meta"):
        if pc["kind"] == "depthpro":
            cfg = dp.config_from_hf_depth_pro(pc)
            m = dp.DepthPro(cfg)
        else:
            cfg = da.config_from_hf(pc)
            m = da.DepthAnything(cfg)
    W.load(m, state)
    with torch.no_grad():
        if pc["kind"] == "depthpro":
            S = cfg.image_size
            got, f = dp.postprocess_depth(*m((L.resize(x01, S, S, "bilinear") - 0.5) / 0.5), S)
            want, fr = ref.depth_focal(P, x01)
            assert torch.allclose(f, fr, rtol=1e-5)
        else:
            got = m(da.preprocess(x01, cfg, pc["input_short_side"]))
            want = ref.depth(P, x01)
    assert got.shape == want.shape and bool((want > 0).all())
    assert torch.linalg.vector_norm(got - want) <= 1e-5 * torch.linalg.vector_norm(want)


def test_loader_matches_the_programs():
    from align3r_tpu_torch.geometry.core import pixel_to_pointcloud
    from align3r_tpu_torch.inference.images import crop_img, normalize_img
    rng = np.random.default_rng(3)
    frame = rng.integers(0, 256, (436, 1024, 3), dtype=np.uint8)
    depth = torch.from_numpy(rng.random((436, 1024), dtype=np.float32) + 0.5)
    cloud = pixel_to_pointcloud(depth, 811.0).numpy()
    img, pri = crop_img(frame, 512, cloud)
    img_r, pri_r = ref_loader.network_view(frame, ref_loader.depth_to_cloud(depth, 811.0).numpy(), 512)
    assert img_r.shape == (208, 512, 3) and np.array_equal(normalize_img(img), img_r)
    assert np.allclose(pri, pri_r, atol=1e-6)


def test_control_rounds_each_part_one_step_below():
    P = C.Precision("control", {"prior": "fp32", "trunk": "bf16"})
    x = torch.linspace(1, 2, 1001)
    assert 0 < float((P.r("prior", x) - x).abs().max()) <= 2.0 ** -11 * 2
    e = float((P.r("trunk", x) - x).abs().max())
    assert 2.0 ** -6 < e <= 2.0 ** -3
    assert torch.equal(C.Precision().r("trunk", x), x)
