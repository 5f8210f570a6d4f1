"""The frozen counts reproduce PERF.md's bound column (section 6's kernel
table) at its shapes."""
import pytest

from benchmark.counts import kernels as K

MS = 1e3


@pytest.mark.parametrize("args,expect_ms", [
    ((1, 16, 576, 1024), 0.100),       # K1 encoder self
    ((2, 32, 576, 768), 0.242),        # K1 decoder self / cross
])
def test_k1_bound(args, expect_ms):
    assert K.bound_s(*K.attention_site(*args), "bf16") * MS == pytest.approx(expect_ms, abs=6e-4)


@pytest.mark.parametrize("args,expect_ms", [
    ((1, 16, 576, 1024, 4096), 0.156),  # K2 encoder
    ((2, 32, 576, 768, 3072), 0.352),   # K2 decoder
])
def test_k2_bound(args, expect_ms):
    assert K.bound_s(*K.mlp_site(*args), "bf16") * MS == pytest.approx(expect_ms, abs=6e-4)


@pytest.mark.parametrize("dtype,backward,expect_ms", [
    ("bf16", False, 0.146), ("bf16", True, 0.159), ("fp32", False, 0.280), ("fp32", True, 0.293)])
def test_k3_k4_bound(dtype, backward, expect_ms):
    got = K.bound_s(*K.edge_loss(380, 147_456, 24, dtype, backward), "fp32") * MS
    assert got == pytest.approx(expect_ms, abs=6e-4)


@pytest.mark.parametrize("shape,expect_ms", [
    ((4, 16, 1024, 64), 0.104), ((35, 16, 577, 64), 0.289), ((140, 16, 577, 64), 1.158),
    ((1, 16, 577, 64), 0.0083), ((4, 16, 2443, 64), 0.593)])
def test_k9_fp32_bound(shape, expect_ms):
    got = K.bound_s(*K.flash_fp32(*shape), "tf32") * MS
    assert got == pytest.approx(expect_ms, rel=2e-3, abs=6e-5)


def test_engine_sites_count_every_layer():
    net = {"enc_embed_dim": 1024, "dec_embed_dim": 768, "mlp_ratio": 4.0, "enc_depth": 24,
           "dec_depth": 12}
    sites = K.engine_sites(24, 552, 8, 416, net)
    # encoder: 2 chunks x 24 layers x 2 sites; decoder: 69 batches x (12 x 3 + 4 x 2)
    assert len(sites) == 2 * 24 * 2 + 69 * (12 * 3 + 4 * 2)
