"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked `cuda`: every test skips where torch.cuda.is_available() is false.
On a machine with an NVIDIA GPU (and nvcc; the kernels build on first use):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(--noconftest because the repository's conftest imports jax, which neither
the port nor this file needs.) Shapes are small but exercise the ragged
edges: token counts that are not a multiple of the 64-row attention tile or
the 128-row GEMM tile, pixel counts that are not a multiple of the 1024-pixel
edge-loss tile, and an image with no edge terms; for K6, query and key
counts that are not multiples of the 64-row tiles, Nq != Nk, and head dims
padded in shared memory (8, 40, 128). Tolerances as in chip_smoke.py: 2 bf16
ulps of the largest output for K1/K2/K6 in bf16, 1e-4 of the largest value
for K3/K4 and for K6 in fp32 (fp32 arithmetic, other sum order). The
gradients of K6 and of the differentiable K1/K2 sites are autograd of their
plain twins on the card, so they are held to those twins' autograd at 1e-5.
"""
import numpy as np
import pytest
import torch

from align3r_tpu_torch.ops import edge_loss as el
from align3r_tpu_torch.ops import fused_site as fs
from align3r_tpu_torch.ops import small_attention as sa
from align3r_tpu_torch.models.rope import make_grid_positions

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _bf16_close(out, ref):
    d = (out.float() - ref.float()).abs().max().item()
    assert torch.isfinite(out.float()).all()
    assert d <= 1.6e-2 * ref.float().abs().max().item(), d


@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("grid", [(5, 8), (9, 16)])
def test_attention_site_kernel(dev, cross, grid):
    g = torch.Generator(device=dev).manual_seed(0)
    G, B, C, H = 2, 3, 128, 2
    pos = make_grid_positions(*grid, device=dev)
    N = pos.shape[0]
    rnd = lambda *s, sc=1.0, dt=torch.bfloat16: (torch.randn(*s, generator=g, device=dev) * sc).to(dt)
    x = rnd(G, B, N, C)
    kv = rnd(G, B, N, C) if cross else x
    w = [rnd(G, C, C, sc=C ** -0.5) for _ in range(4)]
    b = [rnd(G, C, sc=0.1, dt=torch.float32) for _ in range(4)]
    ln = (1 + rnd(G, C, sc=0.1, dt=torch.float32), rnd(G, C, sc=0.1, dt=torch.float32))
    ln_kv = ln if cross else "same"
    before = fs.attention_site.launches
    out = fs.attention_site(x, kv, *w, *b, pos, H, 100.0, ln_q=ln, ln_kv=ln_kv,
                            residual=True)
    assert fs.attention_site.launches == before + 1
    cos, sin = fs.site_tables(pos, C // H, 100.0, torch.bfloat16)
    ref = fs.site_plain(x, kv, *w, *b, cos, sin, H, ln_q=ln, ln_kv=ln_kv, residual=True)
    _bf16_close(out, ref)


def test_mlp_site_kernel(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    G, B, N, C, F = 2, 3, 45, 128, 512
    rnd = lambda *s, sc=1.0, dt=torch.bfloat16: (torch.randn(*s, generator=g, device=dev) * sc).to(dt)
    x = rnd(G, B, N, C)
    w1, w2 = rnd(G, C, F, sc=C ** -0.5), rnd(G, F, C, sc=F ** -0.5)
    b1, b2 = rnd(G, F, sc=0.1, dt=torch.float32), rnd(G, C, sc=0.1, dt=torch.float32)
    ln = (1 + rnd(G, C, sc=0.1, dt=torch.float32), rnd(G, C, sc=0.1, dt=torch.float32))
    for res, lnp in ((True, ln), (False, None)):
        before = fs.mlp_site.launches
        out = fs.mlp_site(x, w1, b1, w2, b2, ln=lnp, residual=res)
        assert fs.mlp_site.launches == before + 1
        _bf16_close(out, fs.mlp_plain(x, w1, b1, w2, b2, ln=lnp, residual=res))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_edge_loss_kernels(dev, dtype):
    g = torch.Generator(device=dev).manual_seed(2)
    n, e2, A = 4, 10, 5000
    proj = torch.randn(n, 3, A, generator=g, device=dev)
    pred = torch.randn(e2, 3, A, generator=g, device=dev).to(dtype)
    w = torch.rand(e2, A, generator=g, device=dev).to(dtype)
    idx = torch.tensor(np.array([0, 1, 3, 3, 0, 1, 1, 3, 0, 0], np.int32), device=dev)
    pw34 = (torch.eye(3, 4, device=dev)[None]
            + 0.1 * torch.randn(e2, 3, 4, generator=g, device=dev)).contiguous()
    order, offsets = (t.to(dev) for t in el.term_csr(idx, n))
    loss = el.edge_loss_fwd(proj, pw34, pred, w, idx)
    ref = el.edge_loss_fwd_plain(proj, pw34, pred, w, idx)
    assert abs(loss.item() - ref.item()) <= 1e-4 * abs(ref.item())
    gval = torch.tensor(0.7, device=dev)
    dp, dm = el.edge_loss_bwd(gval, proj, pw34, pred, w, idx, order, offsets)
    rdp, rdm = el.edge_loss_bwd_plain(gval, proj, pw34, pred, w, idx)
    assert (dp[2] == 0).all()                     # image 2 has no terms
    for a, b in ((dp, rdp), (dm, rdm)):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()


def test_edge_loss_autograd_on_the_card(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    n, e2, A = 3, 6, 2100
    proj = torch.randn(n, 3, A, generator=g, device=dev, requires_grad=True)
    pw34 = torch.randn(e2, 3, 4, generator=g, device=dev, requires_grad=True)
    pred = torch.randn(e2, 3, A, generator=g, device=dev).to(torch.bfloat16)
    w = torch.rand(e2, A, generator=g, device=dev).to(torch.bfloat16)
    idx = torch.tensor([0, 1, 2, 0, 1, 2], dtype=torch.int32, device=dev)
    order, offsets = (t.to(dev) for t in el.term_csr(idx, n))
    before = (el.edge_loss_fwd.launches, el.edge_loss_bwd.launches)
    el.edge_loss(proj, pw34, pred, w, idx, order, offsets).backward()
    assert (el.edge_loss_fwd.launches, el.edge_loss_bwd.launches) == (before[0] + 1,
                                                                      before[1] + 1)
    p2 = proj.detach().clone().requires_grad_(True)
    m2 = pw34.detach().clone().requires_grad_(True)
    el.edge_loss_fwd_plain(p2, m2, pred, w, idx).backward()
    for a, b in ((proj.grad, p2.grad), (pw34.grad, m2.grad)):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("A", [5000, 1001])
def test_permute_packed_kernel(dev, dtype, A):
    """K5 bit-identical to its plain version: a perm over both sources with
    dummy slots (valid 0, perm 0), an out-of-range row (clamped), a weight of
    -inf whose dummy copy is NaN in both, and rows of A = 1001 that are not
    16-byte multiples (the element path)."""
    g = torch.Generator(device=dev).manual_seed(8)
    E = 7
    pi, pj = (torch.randn(E, 3, A, generator=g, device=dev).to(dtype) for _ in range(2))
    wi, wj = (torch.randn(E, A, generator=g, device=dev).to(dtype) for _ in range(2))
    wi[0, 3] = -float("inf")
    perm = torch.tensor([3, 9, 0, 13, 0, 7, 1, 20, 0, 6, 12], dtype=torch.int32, device=dev)
    valid = torch.tensor([1, 1, 0, 1, 0, 1, 1, 1, 1, 1, 0], dtype=torch.int32, device=dev)
    before = el.permute_packed.launches
    pred, w = el.permute_packed(pi, pj, wi, wj, perm, valid)
    assert el.permute_packed.launches == before + 1
    rp, rw = el.permute_packed_plain(pi, pj, wi, wj, perm, valid)
    torch.cuda.synchronize()
    assert pred.dtype == dtype and w.shape == (11, A)
    assert torch.equal(pred, rp)
    assert torch.equal(torch.isnan(w), torch.isnan(rw)) and torch.isnan(w[2, 3])
    assert torch.equal(w.nan_to_num(), rw.nan_to_num())
    assert torch.equal(torch.signbit(w.nan_to_num()), torch.signbit(rw.nan_to_num()))


def test_flow_term_and_image_sorted_solve_on_the_card(dev):
    """flow_forward with the flow term (gate off), dynamic masks and the depth
    regulariser on the card against the CPU: the loss and every gradient to
    1e-4 of their largest value (fp32, TF32 off, other sum order); then a
    20-iteration mixed solve on the card packs through K5 twice."""
    import dataclasses
    from align3r_tpu_torch.alignment import scene as sc
    from align3r_tpu_torch.alignment.flow import flow_forward
    r = np.random.default_rng(9)
    n, h, w = 4, 24, 40
    pairs = [(i, j) for i in range(n) for j in range(n) if i != j]
    E = len(pairs)
    out = {"view1": {"idx": np.array([p[0] for p in pairs])},
           "view2": {"idx": np.array([p[1] for p in pairs])},
           "pred1": {"pts3d": r.normal(0, 1, (E, h, w, 3)) + [0, 0, 4],
                     "conf": 1 + r.uniform(size=(E, h, w))},
           "pred2": {"pts3d_in_other_view": r.normal(0, 1, (E, h, w, 3)) + [0, 0, 4],
                     "conf": 1 + r.uniform(size=(E, h, w))}}
    extra = {"flow_ij": r.normal(0, 2, (E, h, w, 2)), "flow_ji": r.normal(0, 2, (E, h, w, 2)),
             "dynamic_masks": r.uniform(size=(n, h, w)) > 0.7,
             "init_depth": r.uniform(1, 2, (n, h * w))}
    kw = dict(flow_loss_weight=0.01, flow_loss_thre=0.0, flow_loss_start_epoch=0.0,
              depth_regularize_weight=0.01, shared_focal=True)
    got = []
    for d in ("cpu", dev):
        o = {k: ({kk: torch.as_tensor(v, dtype=torch.float32, device=d) if kk != "idx" else v
                  for kk, v in val.items()}) for k, val in out.items()}
        cfg, data, params = sc.build_scene(o, kw)
        data = dataclasses.replace(
            data, **{k: torch.as_tensor(v, dtype=torch.float32, device=d)
                     for k, v in extra.items()})
        leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        loss = flow_forward(leaves, data, cfg, step=5)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        got.append([loss.detach().cpu()] + [g.cpu() for g in grads if g is not None])
    for a, b in zip(got[1], got[0]):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()
    before = el.permute_packed.launches
    _, losses = sc.global_alignment_loop(params, sc.default_masks(cfg, params), data, cfg,
                                         niter=20, loss_fn=flow_forward)
    assert el.permute_packed.launches == before + 2
    assert torch.isfinite(losses).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 3, 80, 64, 80), (1, 2, 48, 40, 100),
                                   (1, 1, 64, 128, 64), (2, 2, 16, 8, 33)])
def test_small_attention_kernel(dev, dtype, shape):
    B, H, Nq, D, Nk = shape
    g = torch.Generator(device=dev).manual_seed(4)
    q, k, v = (torch.randn(B, H, n, D, generator=g, device=dev).to(dtype)
               for n in (Nq, Nk, Nk))
    before = sa.small_attention.launches
    out = sa.small_attention(q, k, v)
    assert sa.small_attention.launches == before + 1 and out.dtype == dtype
    ref = sa.small_attention_plain(q, k, v)
    torch.cuda.synchronize()
    tol = 1.6e-2 if dtype == torch.bfloat16 else 1e-4
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= tol * ref.float().abs().max().item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_small_attention_gradient(dev, dtype):
    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn(2, 3, 96, 64, generator=g, device=dev).to(dtype).requires_grad_(True)
               for _ in range(3))
    gout = torch.randn(2, 3, 96, 64, generator=g, device=dev).to(dtype)
    sa.small_attention(q, k, v).backward(gout)
    q2, k2, v2 = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    sa.small_attention_twin(q2, k2, v2).backward(gout)
    for a, b in ((q, q2), (k, k2), (v, v2)):
        assert (a.grad.float() - b.grad.float()).abs().max().item() <= \
            1e-5 * b.grad.float().abs().max().item()


def test_diff_sites_on_the_card(dev):
    g = torch.Generator(device=dev).manual_seed(6)
    G, B, C, H, F = 2, 2, 128, 2, 512
    pos = make_grid_positions(8, 10, device=dev)
    N = pos.shape[0]
    rnd = lambda *s, sc=1.0, dt=torch.float32: (torch.randn(*s, generator=g, device=dev) * sc).to(dt)
    x = rnd(G, B, N, C, dt=torch.bfloat16)
    w = [rnd(G, C, C, sc=C ** -0.5) for _ in range(4)]
    b = [rnd(G, C, sc=0.1) for _ in range(4)]
    ln = (1 + rnd(G, C, sc=0.1), rnd(G, C, sc=0.1))
    gout = rnd(G, B, N, C, dt=torch.bfloat16)
    leaves = [x, *w, *b, *ln]
    for t in leaves:
        t.requires_grad_(True)
    before = fs.attention_site.launches
    out = fs.attention_site_diff(x, x, *w, *b, pos, H, 100.0, ln_q=ln, ln_kv="same",
                                 residual=True)
    assert fs.attention_site.launches == before + 1
    got = torch.autograd.grad(out, leaves, gout)
    cos, sin = fs.site_tables(pos, C // H, 100.0, torch.bfloat16)
    twin = fs.site_plain(x, x, *[t.to(torch.bfloat16) for t in w], *b, cos, sin, H,
                         ln_q=ln, ln_kv="same", residual=True, twin=True)
    ref = torch.autograd.grad(twin, leaves, gout)
    _bf16_close(out, twin)
    for a, r in zip(got, ref):
        assert (a.float() - r.float()).abs().max().item() <= 1e-5 * r.float().abs().max().item()

    w1, w2 = rnd(G, C, F, sc=C ** -0.5), rnd(G, F, C, sc=F ** -0.5)
    b1, b2 = rnd(G, F, sc=0.1), rnd(G, C, sc=0.1)
    leaves = [x, w1, b1, w2, b2, *ln]
    for t in leaves:
        t.requires_grad_(True)
    before = fs.mlp_site.launches
    out = fs.mlp_site_diff(x, w1, b1, w2, b2, ln=ln, residual=True)
    assert fs.mlp_site.launches == before + 1
    got = torch.autograd.grad(out, leaves, gout)
    twin = fs.mlp_plain(x, w1.to(torch.bfloat16), b1, w2.to(torch.bfloat16), b2, ln=ln,
                        residual=True)
    ref = torch.autograd.grad(twin, leaves, gout)
    _bf16_close(out, twin)
    for a, r in zip(got, ref):
        assert (a.float() - r.float()).abs().max().item() <= 1e-5 * r.float().abs().max().item()


def _tiny_model(dev):
    """A small Align3R whose attentions take the card's routes: 128 tokens
    (128 x 256 images), D = 64 heads, C % 128 == 0 for K1/K2."""
    from align3r_tpu_torch.models.align3r import Align3R, init_align3r_
    from align3r_tpu_torch.models.config import Align3RConfig
    from align3r_tpu_torch.training import step as S
    cfg = Align3RConfig(img_size=(128, 256), enc_embed_dim=128, enc_depth=2,
                        enc_num_heads=2, dec_embed_dim=128, dec_depth=8, dec_num_heads=2)
    with torch.device(dev):
        model = init_align3r_(Align3R(cfg), seed=0)
    with torch.no_grad():
        for z in model.zero_convs:
            z[0].weight.normal_(0, 0.05)
        for h in (model.downstream_head1, model.downstream_head2):
            h.dpt.head[4].weight.mul_(0.1)
    S.freeze_params(model)
    g = torch.Generator(device=dev).manual_seed(7)

    def view():
        pose = torch.eye(4, device=dev).expand(1, 4, 4).clone()
        return {"img": torch.rand(1, 128, 256, 3, generator=g, device=dev) * 2 - 1,
                "pred_depth": torch.rand(1, 128, 256, 3, generator=g, device=dev),
                "pts3d": torch.randn(1, 128, 256, 3, generator=g, device=dev) + 3,
                "camera_pose": pose,
                "valid_mask": torch.rand(1, 128, 256, generator=g, device=dev) > 0.1}
    return model, {"view1": view(), "view2": view()}


def test_remat_modes_on_the_card(dev):
    """Gradients under remat none / full / dots agree (cuDNN's convolution
    backward sums in no fixed order: 1e-4 of the largest gradient), and
    K6 launches 20 times in the forward (2 encoder, 16 decoder, 2 prior
    blocks) plus 18 recomputed under full and dots remat."""
    from align3r_tpu_torch.training import step as S
    model, batch = _tiny_model(dev)
    params = [p for p in model.parameters() if p.requires_grad]
    grads = {}
    for remat in ("none", "full", "dots"):
        before = sa.small_attention.launches
        loss, _ = S.loss_fn(model, batch, remat=remat)
        grads[remat] = torch.autograd.grad(loss, params, allow_unused=True)
        torch.cuda.synchronize()
        assert sa.small_attention.launches - before == (20 if remat == "none" else 38)
    flat = lambda gs: torch.cat([g.float().flatten() for g in gs if g is not None])
    ref = flat(grads["none"])
    assert torch.isfinite(ref).all()
    for remat in ("full", "dots"):
        assert (flat(grads[remat]) - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


def test_fused_training_route_on_the_card(dev):
    """attn_impl="fused" trains through the differentiable K1/K2 sites (one
    attention and one MLP site per block, two attention sites per decoder
    layer): its loss and gradients agree with the "xla" route's within the
    bf16 network's rounding (5e-2 of the largest value: the two routes round
    at other points through 12 blocks)."""
    from align3r_tpu_torch.training import step as S
    model, batch = _tiny_model(dev)
    params = [p for p in model.parameters() if p.requires_grad]
    out = {}
    for impl in ("xla", "fused"):
        before = (fs.attention_site.launches, fs.mlp_site.launches)
        loss, _ = S.loss_fn(model, batch, attn_impl=impl, remat="none")
        out[impl] = (loss.item(), torch.autograd.grad(loss, params, allow_unused=True))
        torch.cuda.synchronize()
        launched = (fs.attention_site.launches - before[0], fs.mlp_site.launches - before[1])
        assert launched == ((0, 0) if impl == "xla" else (2 + 16 + 2, 2 + 8 + 2))
    assert abs(out["fused"][0] - out["xla"][0]) <= 5e-2 * abs(out["xla"][0])
    flat = lambda gs: torch.cat([g.float().flatten() for g in gs if g is not None])
    ref = flat(out["xla"][1])
    assert (flat(out["fused"][1]) - ref).abs().max().item() <= 5e-2 * ref.abs().max().item()
