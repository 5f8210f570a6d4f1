"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked `cuda`: every test skips where torch.cuda.is_available() is false.
On a machine with an NVIDIA GPU (and nvcc; the kernels build on first use):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(--noconftest because the repository's conftest imports jax, which neither
the port nor this file needs.) Shapes are small but exercise the ragged
edges: token counts that are not a multiple of the 64-row attention tile or
the 128-row GEMM tile, pixel counts that are not a multiple of the 1024-pixel
edge-loss tile or whose rows are not 16-byte aligned (odd A), an image with
no edge terms, terms sorted by image and unsorted, a walk longer than K4's
dM slots, and two launches of K3/K4 that give the same bits, K3/K4 with a
scene axis (1 and 3 scenes laid end to end: each scene's loss within 1e-6
of its own launch, its gradients bit for bit) and EdgeLoss under
torch.func.vmap making one launch of each; for K6, query and key
counts that are not multiples of the 64-row tiles, Nq != Nk, and head dims
padded with zeros (8, 40, 128), one key (the P V product alone) and one key
tile against V = I (the first product alone); for K9, sequence lengths that
are not a multiple of its 128-, 64- or 32-row tiles at every head dim it
takes, 2 x 128 + 1, head counts of 5 and 3; for both bf16 forwards, K6's
fp32 forward and K9's bf16 backward, two launches that give the same bits
(K6 fp32 also 8 at the training shape); for that backward
(D = 64, 128 and 256), a single live query row (dV = P^T dO shows P^T) and Q or
K = 0 (uniform P: the transposed operands alone); for K1's attention
launch, K6's bits on the same heads laid out per head; for K1/K2's GEMM
launch (gemm.cuh), every epilogue at 135 rows over G = 2 and at the main
path's shapes, K = 4096 (the ring wraps many times), N = 128 (one tile) and
3072, grids of fewer tiles than SMs (a single row, K = 64), two launches
that give the same bits, and the inputs it refuses; for K7 and K8, pixel counts that are not a multiple of
the 128-pixel conv tile, K7 at each refinenet level's width (128, 64, 32,
16) with a ragged height, K8 at widths that are not a multiple of the
box width, that the bf16 convs launch the sm90 conv kernels and the fp32
ones the 3xTF32 kernel (by the profiler's kernel names), each fp32 epilogue
alone (two launches giving the same bits) and the input channels the bf16
path refuses; for K1/K2's LayerNorm launch, the recipe shapes, C = 128 and
row counts that are not a multiple of the warps.
Tolerances as in chip_smoke.py: 2 bf16 ulps of the largest output for
K1/K2/K6/K7/K8/K9 in bf16 (the kernels and the plain versions round at the
same points after fp32 sums in another order), 1e-4 of the largest value
for K3/K4 and for K6-K9 in fp32 (fp32 arithmetic, other sum order). The
gradients of K6 and of the differentiable K1/K2 sites are autograd of their
plain twins on the card, so they are held to those twins' autograd at 1e-5.
Convolutions of the plain versions run without TF32.
"""
import itertools

import numpy as np
import pytest
import torch

from align3r_tpu_torch.ops import dpt_pipeline as dp
from align3r_tpu_torch.ops import edge_loss as el
from align3r_tpu_torch.ops import flash_attention as fa
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


GEMM_SHAPES = [(2, 135, 128, 128),      # ragged rows, G = 2, one 128-column tile
               (1, 9216, 1024, 1024),   # the encoder's projections
               (2, 18432, 768, 768),    # the decoder's projections
               (1, 9216, 1024, 4096),   # the encoder's fc2: K = 4096, the ring wraps 16 times
               (2, 18432, 3072, 768)]   # the decoder's fc1: N = 3072


def _gemm_inputs(dev, G, M, N, K, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *s, sc=1.0: torch.randn(*s, generator=g, device=dev) * sc
    a = rnd(G, M, K).to(torch.bfloat16)
    w = rnd(G, K, N, sc=K ** -0.5).to(torch.bfloat16)
    bias = rnd(G, N, sc=0.1)
    resid = rnd(G, M, N).to(torch.bfloat16)
    ang = rnd(576, 64, sc=3.0)
    return a, w, bias, resid, torch.cos(ang).to(torch.bfloat16), torch.sin(ang).to(torch.bfloat16)


@pytest.mark.parametrize("epi", ["bias", "rope", "gelu", "resid"])
@pytest.mark.parametrize("shape", GEMM_SHAPES)
def test_gemm_kernel(dev, shape, epi):
    """One GEMM launch (gemm.cuh) against gemm_plain, every epilogue, at the
    main path's shapes and a ragged one; RoPE with 576-token tables (rows
    wrap every 576) at D = 64."""
    G, M, N, K = shape
    a, w, bias, resid, cos, sin = _gemm_inputs(dev, G, M, N, K, 20)
    e = {"bias": fs.EPI_BIAS, "rope": fs.EPI_ROPE, "gelu": fs.EPI_GELU, "resid": fs.EPI_RESID}[epi]
    kw = dict(resid=resid if epi == "resid" else None, cos=cos if epi == "rope" else None,
              sin=sin if epi == "rope" else None, rope_d=64, rope_n=576)
    before = fs.gemm.launches
    out = fs.gemm(a, w, bias, e, **kw)
    assert fs.gemm.launches == before + 1 and out.shape == (G, M, N)
    ref = fs.gemm_plain(a, w, bias, e, **kw)
    torch.cuda.synchronize()
    _bf16_close(out, ref)


@pytest.mark.parametrize("epi", ["bias", "rope", "gelu", "resid"])
@pytest.mark.parametrize("shape", [(1, 1, 128, 64), (2, 64, 256, 192), (3, 129, 384, 128),
                                   (1, 600, 640, 512)])
def test_gemm_kernel_small_grids(dev, shape, epi):
    """Grids of fewer tiles than SMs: one tile (the second consumer idle), a
    single row, 64 rows (the second 64-row half of the tile all past M), 129
    rows over three streams (a tile of one row), K = 64 (one k-tile, the ring
    never full); each epilogue against gemm_plain."""
    G, M, N, K = shape
    a, w, bias, resid, cos, sin = _gemm_inputs(dev, G, M, N, K, 21)
    e = {"bias": fs.EPI_BIAS, "rope": fs.EPI_ROPE, "gelu": fs.EPI_GELU, "resid": fs.EPI_RESID}[epi]
    kw = dict(resid=resid if epi == "resid" else None, cos=cos if epi == "rope" else None,
              sin=sin if epi == "rope" else None, rope_d=64, rope_n=576)
    out = fs.gemm(a, w, bias, e, **kw)
    ref = fs.gemm_plain(a, w, bias, e, **kw)
    torch.cuda.synchronize()
    _bf16_close(out, ref)


def test_gemm_kernel_is_deterministic(dev):
    """Two launches give the same bits (no atomics; each tile's sums in one
    order)."""
    a, w, bias, resid, _, _ = _gemm_inputs(dev, 2, 1000, 1024, 3072, 22)
    x = fs.gemm(a, w, bias, fs.EPI_RESID, resid=resid)
    y = fs.gemm(a, w, bias, fs.EPI_RESID, resid=resid)
    torch.cuda.synchronize()
    assert torch.equal(x, y)


def test_gemm_refuses_unsupported(dev):
    """N or K off the tiles, a RoPE head dim other than 64, a CPU tensor among
    CUDA ones (either way round) and an fp32 operand are refused before any
    launch."""
    a, w, bias, resid, cos, sin = _gemm_inputs(dev, 1, 64, 256, 128, 23)
    before = fs.gemm.launches
    with pytest.raises(ValueError):
        fs.gemm(a, w[..., :96], bias[:, :96], fs.EPI_BIAS)
    with pytest.raises(ValueError):
        fs.gemm(a[..., :96], w[:, :96], bias, fs.EPI_BIAS)
    with pytest.raises(ValueError):
        fs.gemm(a, w, bias, fs.EPI_ROPE, cos=cos[:, :32], sin=sin[:, :32], rope_d=32, rope_n=576)
    with pytest.raises(ValueError):
        fs.gemm(a, w.cpu(), bias, fs.EPI_BIAS)
    with pytest.raises(ValueError):
        fs.gemm(a.cpu(), w, bias, fs.EPI_BIAS)
    with pytest.raises(ValueError):
        fs.gemm(a.float(), w, bias, fs.EPI_BIAS)
    with pytest.raises(ValueError):
        fs.gemm(a, w, bias, fs.EPI_RESID)
    assert fs.gemm.launches == before


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
    loss = el.edge_loss_fwd(proj, pw34, pred, w, idx, order, offsets)
    ref = el.edge_loss_fwd_plain(proj, pw34, pred, w, idx)
    assert abs(loss.item() - ref.item()) <= 1e-4 * abs(ref.item())
    gval = torch.tensor(0.7, device=dev)
    dp, dm = el.edge_loss_bwd(gval, proj, pw34, pred, w, idx, order, offsets)
    rdp, rdm = el.edge_loss_bwd_plain(gval, proj, pw34, pred, w, idx)
    assert (dp[2] == 0).all()                     # image 2 has no terms
    for a, b in ((dp, rdp), (dm, rdm)):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()


def _edge_case(dev, dtype, A, sort, n=5, e2=23, seed=4):
    """Inputs of K3/K4 with image 2 given no terms, the terms sorted by image
    (as the pack lays them out) or in random order, and one exact zero
    residual (pixel 7 of term 0)."""
    r = np.random.default_rng(seed)
    idx = r.choice([0, 1, 3, 4], e2).astype(np.int32)
    idx[:4] = [0, 1, 3, 4]
    idx = np.sort(idx) if sort else r.permutation(idx)
    g = torch.Generator(device=dev).manual_seed(seed)
    proj = torch.randn(n, 3, A, generator=g, device=dev)
    pred = torch.randn(e2, 3, A, generator=g, device=dev).to(dtype)
    w = torch.rand(e2, A, generator=g, device=dev).to(dtype)
    pw34 = (torch.eye(3, 4, device=dev)[None]
            + 0.1 * torch.randn(e2, 3, 4, generator=g, device=dev)).contiguous()
    pw34[0] = torch.eye(3, 4, device=dev)
    idx_t = torch.from_numpy(idx).to(dev)
    proj[int(idx[0]), :, 7] = pred[0, :, 7].float()
    order, offsets = (t.to(dev) for t in el.term_csr(idx_t, n))
    return proj, pw34, pred, w, idx_t, order, offsets


@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("A", [5000, 1001, 4097, 2 * 2048])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_edge_loss_walk(dev, dtype, A, sort):
    """K3 and K4 against their plain versions: A over whole ring tiles and a
    ragged edge tile (5000), whole tiles only (4096), and odd A (1001, 4097:
    rows off 16 bytes, every tile on the element path); an image with no
    terms (its dproj 0), terms sorted and unsorted, a zero residual. Two
    launches give the same bits."""
    proj, pw34, pred, w, idx, order, offsets = _edge_case(dev, dtype, A, sort)
    f = lambda: el.edge_loss_fwd(proj, pw34, pred, w, idx, order, offsets)
    gval = torch.tensor(1.3, device=dev)
    b = lambda: el.edge_loss_bwd(gval, proj, pw34, pred, w, idx, order, offsets)
    loss, (dp, dm) = f(), b()
    ref = el.edge_loss_fwd_plain(proj, pw34, pred, w, idx)
    rdp, rdm = el.edge_loss_bwd_plain(gval, proj, pw34, pred, w, idx)
    assert abs(loss.item() - ref.item()) <= 1e-4 * abs(ref.item())
    for got, want in ((dp, rdp), (dm, rdm)):
        assert torch.isfinite(got).all()
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    assert (dp[2] == 0).all()
    loss2, (dp2, dm2) = f(), b()
    assert torch.equal(loss, loss2) and torch.equal(dp, dp2) and torch.equal(dm, dm2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_edge_loss_same_bits_at_the_main_shape(dev, dtype):
    """Eight launches of K3 and of K4 at the main path's shape (24 images,
    380 terms, 512x288 pixels) give the same bits: a stage of the ring
    overwritten before every warp has read it shows here as a few blocks
    off by 1e-5 to 1e-3, inside the tolerance against the plain version."""
    g = torch.Generator(device=dev).manual_seed(6)
    n, e2, A = 24, 380, 288 * 512
    proj = torch.randn(n, 3, A, generator=g, device=dev)
    pred = torch.randn(e2, 3, A, generator=g, device=dev).to(dtype)
    w = (torch.rand(e2, A, generator=g, device=dev) / (e2 * A)).to(dtype)
    idx = torch.sort(torch.randint(0, n, (e2,), generator=g, device=dev,
                                   dtype=torch.int32)).values
    pw34 = (torch.eye(3, 4, device=dev)[None]
            + 0.1 * torch.randn(e2, 3, 4, generator=g, device=dev)).contiguous()
    order, offsets = (t.to(dev) for t in el.term_csr(idx, n))
    gval = torch.tensor(1.5, device=dev)
    loss = el.edge_loss_fwd(proj, pw34, pred, w, idx, order, offsets)
    dp, dm = el.edge_loss_bwd(gval, proj, pw34, pred, w, idx, order, offsets)
    for _ in range(7):
        assert torch.equal(el.edge_loss_fwd(proj, pw34, pred, w, idx, order, offsets), loss)
        dp2, dm2 = el.edge_loss_bwd(gval, proj, pw34, pred, w, idx, order, offsets)
        assert torch.equal(dp2, dp) and torch.equal(dm2, dm)


def test_edge_loss_long_walk(dev):
    """An image with more terms than the backward's EDGE_MAXT dM slots (the
    block meets more than once) and many (tile, image) pairs for K3's second
    pass (several of its blocks)."""
    n, e2, A = 300, 2 * el.EDGE_MAXT + 5 + 299, 4096
    idx = np.concatenate([np.zeros(2 * el.EDGE_MAXT + 5, np.int32),
                          np.arange(1, 300, dtype=np.int32)])
    g = torch.Generator(device=dev).manual_seed(5)
    proj = torch.randn(n, 3, A, generator=g, device=dev)
    pred = torch.randn(e2, 3, A, generator=g, device=dev).to(torch.bfloat16)
    w = torch.rand(e2, A, generator=g, device=dev).to(torch.bfloat16)
    pw34 = (torch.eye(3, 4, device=dev)[None]
            + 0.1 * torch.randn(e2, 3, 4, generator=g, device=dev)).contiguous()
    idx_t = torch.from_numpy(idx).to(dev)
    order, offsets = (t.to(dev) for t in el.term_csr(idx_t, n))
    assert el.edge_tiles(A) * n > 2 * el.EDGE_SUM_BLOCK
    loss = el.edge_loss_fwd(proj, pw34, pred, w, idx_t, order, offsets)
    ref = el.edge_loss_fwd_plain(proj, pw34, pred, w, idx_t)
    assert abs(loss.item() - ref.item()) <= 1e-4 * abs(ref.item())
    gval = torch.tensor(0.5, device=dev)
    dp, dm = el.edge_loss_bwd(gval, proj, pw34, pred, w, idx_t, order, offsets)
    rdp, rdm = el.edge_loss_bwd_plain(gval, proj, pw34, pred, w, idx_t)
    for got, want in ((dp, rdp), (dm, rdm)):
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


def _scene_axis_case(dev, dtype, S, A, n=5, e2=23):
    """S scenes of _edge_case (each its own seed; image 2 of every scene has
    no terms), stacked: per-scene (S, ...) inputs and their scene-axis
    layout (stack_packs)."""
    cases = [_edge_case(dev, dtype, A, sort=z % 2 == 0, n=n, e2=e2, seed=10 + z)
             for z in range(S)]
    st = [torch.stack(t) for t in zip(*cases)]
    idx, order, offsets = el.stack_packs(st[4], st[5], st[6], n)
    flat = [t.reshape(-1, *t.shape[2:]) for t in st[:4]]
    return cases, flat + [idx, order, offsets]


@pytest.mark.parametrize("A", [5000, 1001])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S", [1, 3])
def test_edge_loss_scene_axis(dev, dtype, S, A):
    """K3/K4 with a scene axis: S scenes laid end to end give S losses, each
    its scene's plain loss (1e-4) and its own S = 1 launch (1e-6 relative;
    the same walk and partials), and K4 with one upstream gradient a scene
    gives each scene's S = 1 gradients; two launches give the same bits."""
    cases, (proj, pw34, pred, w, idx, order, offsets) = _scene_axis_case(dev, dtype, S, A)
    loss = el.edge_loss_fwd(proj, pw34, pred, w, idx, order, offsets, scenes=S)
    ref = el.edge_loss_fwd_plain(proj, pw34, pred, w, idx, scenes=S)
    assert loss.shape == (S,)
    gval = torch.arange(1, S + 1, dtype=torch.float32, device=dev) * 0.7
    dp, dm = el.edge_loss_bwd(gval, proj, pw34, pred, w, idx, order, offsets, scenes=S)
    rdp, rdm = el.edge_loss_bwd_plain(gval, proj, pw34, pred, w, idx, scenes=S)
    for got, want in ((dp, rdp), (dm, rdm)):
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    n, e2 = cases[0][0].shape[0], cases[0][1].shape[0]
    for z, case in enumerate(cases):
        assert abs(loss[z].item() - ref[z].item()) <= 1e-4 * abs(ref[z].item())
        one = el.edge_loss_fwd(*case)
        assert abs(loss[z].item() - one.item()) <= 1e-6 * abs(one.item())
        dp1, dm1 = el.edge_loss_bwd(gval[z], *case)
        assert torch.equal(dp[z * n:(z + 1) * n], dp1)
        assert torch.equal(dm[z * e2:(z + 1) * e2], dm1)
        assert (dp[z * n + 2] == 0).all()
    assert torch.equal(el.edge_loss_fwd(proj, pw34, pred, w, idx, order, offsets, scenes=S),
                       loss)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_edge_loss_vmap_is_one_scene_axis_launch(dev, dtype):
    """EdgeLoss under torch.func.vmap over 3 scenes launches K3 and K4 once
    each, and its losses and gradients are each scene's own (1e-6 relative
    loss; gradients 1e-5 of the largest value)."""
    cases, _ = _scene_axis_case(dev, dtype, 3, 5000)
    st = [torch.stack(t) for t in zip(*cases)]
    proj = st[0].clone().requires_grad_(True)
    pw34 = st[1].clone().requires_grad_(True)
    before = (el.edge_loss_fwd.launches, el.edge_loss_bwd.launches)
    loss = torch.func.vmap(el.edge_loss)(proj, pw34, *st[2:])
    gp, gm = torch.autograd.grad(loss.sum(), [proj, pw34])
    assert (el.edge_loss_fwd.launches - before[0], el.edge_loss_bwd.launches - before[1]) == (1, 1)
    for z, case in enumerate(cases):
        p1 = case[0].clone().requires_grad_(True)
        m1 = case[1].clone().requires_grad_(True)
        l1 = el.edge_loss(p1, m1, *case[2:])
        a, b = torch.autograd.grad(l1, [p1, m1])
        assert abs(loss[z].item() - l1.item()) <= 1e-6 * abs(l1.item())
        for got, want in ((gp[z], a), (gm[z], b)):
            assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_edge_loss_refuses_unsupported(dev):
    proj, pw34, pred, w, idx, order, offsets = _edge_case(dev, torch.bfloat16, 1000, True)
    before = (el.edge_loss_fwd.launches, el.edge_loss_bwd.launches)
    gval = torch.tensor(1.0, device=dev)
    for bad in (dict(pred=pred.half(), w=w.half()), dict(order=order.long()),
                dict(offsets=offsets[:-1]), dict(pred=pred.cpu()),
                dict(pw34=pw34.double()), dict(w=w.float())):
        args = {**dict(proj=proj, pw34=pw34, pred=pred, w=w, idx=idx, order=order,
                       offsets=offsets), **bad}
        with pytest.raises(ValueError):
            el.edge_loss_fwd(**args)
        with pytest.raises(ValueError):
            el.edge_loss_bwd(gval, **args)
    assert (el.edge_loss_fwd.launches, el.edge_loss_bwd.launches) == before


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


# (B, H, Nq, D, Nk); the bf16 kernel's query and key tiles are 64 rows, D is
# padded to 16, 32, 64 or 128 (32-, 64- or 128-byte swizzle)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 3, 80, 64, 80), (1, 2, 48, 40, 100),
                                   (1, 1, 64, 128, 64), (2, 2, 16, 8, 33)] + [
    (1, 3, nq, d, nk) for nq, nk, d in itertools.product((48, 80, 200), (33, 100, 576),
                                                         (8, 40, 64, 128))])
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


@pytest.mark.parametrize("D", [8, 40, 64, 128])
def test_small_attention_one_key_returns_v(dev, D):
    """With one key, p = 1 and the output is v's row, bit for bit: the P V
    product and V's N-major descriptor alone."""
    g = torch.Generator(device=dev).manual_seed(6)
    q = torch.randn(2, 2, 80, D, generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn(2, 2, 1, D, generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    out = sa.small_attention(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(out, v.expand_as(out))


@pytest.mark.parametrize("D", [8, 40, 64, 128])
def test_small_attention_single_tile_scores(dev, D):
    """One key tile with V = the identity: the output is the rounded softmax
    of q k^T itself, so it holds the first product (Q and K descriptors, the
    swizzle, the masked keys past Nk) to the plain version."""
    Nk = min(D, 64)
    g = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn(1, 2, 100, D, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(1, 2, Nk, D, generator=g, device=dev).to(torch.bfloat16)
    v = torch.eye(Nk, D, device=dev, dtype=torch.bfloat16).expand(1, 2, Nk, D).contiguous()
    out = sa.small_attention(q, k, v)
    torch.cuda.synchronize()
    _bf16_close(out, sa.small_attention_plain(q, k, v))


@pytest.mark.parametrize("kernel", ["K6", "K9", "K6 fp32", "K9 fp32"])
def test_attention_forwards_are_deterministic(dev, kernel):
    """Two launches on the same inputs give the same bits (no atomics, no
    split over keys)."""
    g = torch.Generator(device=dev).manual_seed(8)
    shape = (2, 5, 1000, 64) if kernel.startswith("K9") else (2, 5, 576, 64)
    dtype = torch.float32 if kernel.endswith("fp32") else torch.bfloat16
    q, k, v = (torch.randn(*shape, generator=g, device=dev).to(dtype) for _ in range(3))
    if not kernel.startswith("K9"):
        a, b = sa.small_attention(q, k, v), sa.small_attention(q, k, v)
    else:
        (a, la), (b, lb) = fa.flash_attention_fwd(q, k, v), fa.flash_attention_fwd(q, k, v)
        assert torch.equal(la, lb)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_small_attention_f32_same_bits_at_the_training_shape(dev):
    """K6's fp32 kernel (the split pre-pass, then the TMA ring of split K and
    V^T refilled behind fence.proxy.async) launched 8 times at the encoder's
    training shape gives the same bits each time."""
    g = torch.Generator(device=dev).manual_seed(18)
    q, k, v = (torch.randn(4, 16, 576, 64, generator=g, device=dev) for _ in range(3))
    outs = [sa.small_attention(q, k, v) for _ in range(8)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    _close(outs[0], sa.small_attention_plain(q, k, v), torch.float32)


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


def _tiny_model(dev, hw=(128, 256)):
    """A small Align3R whose attentions take the card's routes: 128 tokens
    (128 x 256 images; 1024 at 512 x 512), D = 64 heads, C % 128 == 0 for
    K1/K2."""
    from align3r_tpu_torch.models.align3r import Align3R, init_align3r_
    from align3r_tpu_torch.models.config import Align3RConfig
    from align3r_tpu_torch.training import step as S
    H, W = hw
    cfg = Align3RConfig(img_size=hw, enc_embed_dim=128, enc_depth=2,
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
        return {"img": torch.rand(1, H, W, 3, generator=g, device=dev) * 2 - 1,
                "pred_depth": torch.rand(1, H, W, 3, generator=g, device=dev),
                "pts3d": torch.randn(1, H, W, 3, generator=g, device=dev) + 3,
                "camera_pose": pose,
                "valid_mask": torch.rand(1, H, W, generator=g, device=dev) > 0.1}
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


def _close(out, ref, dtype):
    tol = 1.6e-2 if dtype == torch.bfloat16 else 1e-4
    assert torch.isfinite(out.float()).all()
    d = (out.float() - ref.float()).abs().max().item()
    assert d <= tol * ref.float().abs().max().item(), d


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 3, 130, 64), (1, 2, 1000, 64), (1, 2, 77, 128),
                                   (1, 1, 200, 256), (2, 1, 40, 64), (1, 5, 200, 64),
                                   (3, 1, 257, 64), (1, 3, 129, 128), (1, 3, 333, 256)])
def test_flash_attention_kernels(dev, dtype, shape):
    """K9's forward (o and the log-sum-exp) and backward against their plain
    versions on the same inputs, and the autograd Function through both."""
    g = torch.Generator(device=dev).manual_seed(10)
    q, k, v, do = (torch.randn(*shape, generator=g, device=dev).to(dtype) for _ in range(4))
    before = (fa.flash_attention.launches, fa.flash_attention_bwd.launches)
    o, lse = fa.flash_attention_fwd(q, k, v)
    ro, rlse = fa.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    _close(o, ro, dtype)
    assert (lse - rlse).abs().max().item() <= 1e-5 * rlse.abs().max().item()
    grads = fa.flash_attention_bwd(q, k, v, ro, rlse, do)
    refs = fa.flash_attention_bwd_plain(q, k, v, ro, rlse, do)
    torch.cuda.synchronize()
    for a, r in zip(grads, refs):
        assert a.dtype == dtype
        _close(a, r, dtype)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fa.flash_attention(*leaves).backward(do)
    assert (fa.flash_attention.launches, fa.flash_attention_bwd.launches) == (
        before[0] + 2, before[1] + 2)


# (B, H, N, D): ragged lengths at every head dim of the sm90 backward, with
# 16 query tiles (N = 1000) or one ragged tile (N = 77) per key tile
@pytest.mark.parametrize("shape", [(1, 3, 1000, 64), (2, 2, 77, 64), (1, 3, 1000, 128),
                                   (2, 2, 77, 128), (1, 3, 1000, 256), (2, 2, 77, 256)])
def test_flash_attention_bwd_sm90(dev, shape):
    """K9's bf16 backward on the warpgroup-MMA core (D = 64, 128 and 256: two
    warpgroups per dK/dV block, 32-key dQ tiles) against
    flash_attention_bwd_plain on the plain forward's (o, lse)."""
    g = torch.Generator(device=dev).manual_seed(13)
    q, k, v, do = (torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(4))
    o, lse = fa.flash_attention_plain(q, k, v)
    before = fa.flash_attention_bwd.launches
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do)
    assert fa.flash_attention_bwd.launches == before + 1
    refs = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    for a, r in zip(grads, refs):
        _close(a, r, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_attention_bwd_single_query_row(dev, D, dtype):
    """dO is zero but for query row 37: dV = P^T dO is P's row 37 (one query
    column of P^T per key) times dO's row, so each key's P^T entry is held
    to the plain version (the column's lse2 and Di read from the staged
    vectors; in fp32 the query's place in the transposed copies' 8-row
    order), across four key tiles and a ragged one."""
    g = torch.Generator(device=dev).manual_seed(14)
    shape = (1, 2, 300, D)
    q, k, v = (torch.randn(*shape, generator=g, device=dev).to(dtype) for _ in range(3))
    do = torch.zeros(shape, device=dev, dtype=dtype)
    do[:, :, 37] = torch.randn(1, 2, D, generator=g, device=dev).to(dtype)
    o, lse = fa.flash_attention_plain(q, k, v)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do)
    refs = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    for a, r in zip(grads, refs):
        _close(a, r, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("zero", ["q", "k"])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_attention_bwd_uniform_p(dev, zero, D, dtype):
    """Q = 0 or K = 0 makes S = 0 and P uniform (1/N), so the products that
    take a transposed operand stand alone: dV = P^T dO, and dQ = dS K (K = 0:
    dK = dS^T Q) against the plain version; the gradient through the zero
    operand is exactly 0."""
    g = torch.Generator(device=dev).manual_seed(15)
    shape = (2, 2, 200, D)
    q, k, v, do = (torch.randn(*shape, generator=g, device=dev).to(dtype)
                   for _ in range(4))
    if zero == "q":
        q = torch.zeros_like(q)
    else:
        k = torch.zeros_like(k)
    o, lse = fa.flash_attention_plain(q, k, v)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do)
    rq, rk, rv = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    _close(dv, rv, dtype)
    if zero == "q":
        _close(dq, rq, dtype)
        assert torch.equal(dk, torch.zeros_like(dk))
    else:
        _close(dk, rk, dtype)
        assert torch.equal(dq, torch.zeros_like(dq))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_attention_bwd_is_deterministic(dev, D, dtype):
    """Two launches of the backward give the same bits (two kernels, no
    atomics)."""
    g = torch.Generator(device=dev).manual_seed(16)
    q, k, v, do = (torch.randn(2, 5, 1000, D, generator=g, device=dev).to(dtype)
                   for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v)
    a = fa.flash_attention_bwd(q, k, v, o, lse, do)
    b = fa.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_flash_attention_f32_same_bits_at_the_training_shape(dev):
    """K9's fp32 forward (the split pre-pass, then the K and V^T rings) and
    backward (the pre-pass, then dK/dV and dQ, each with two rings refilled
    behind fence.proxy.async) launched 8 times at the 512x512 training shape
    give the same bits each time, within the fp32 tolerance of their plain
    versions."""
    g = torch.Generator(device=dev).manual_seed(19)
    q, k, v, do = (torch.randn(4, 16, 1024, 64, generator=g, device=dev) for _ in range(4))
    fwd = [fa.flash_attention_fwd(q, k, v) for _ in range(8)]
    o, lse = fwd[0]
    bwd = [fa.flash_attention_bwd(q, k, v, o, lse, do) for _ in range(8)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, o) and torch.equal(b, lse) for a, b in fwd[1:])
    assert all(torch.equal(x, y) for b in bwd[1:] for x, y in zip(b, bwd[0]))
    ro, rlse = fa.flash_attention_plain(q, k, v)
    _close(o, ro, torch.float32)
    for a, r in zip(bwd[0], fa.flash_attention_bwd_plain(q, k, v, o, lse, do)):
        _close(a, r, torch.float32)


@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("grid", [(5, 8), (9, 16), (16, 32)])
def test_site_attention_is_k6_per_head(dev, cross, grid):
    """K1's attention launch on (G, B, N, C) gives K6's bits on the same
    values laid out as (G B, H, N, D): q from one token set, k and v from the
    same (self) or another (cross), N = 40, 144 or 512 (not multiples of the
    64-row tiles but the last)."""
    g = torch.Generator(device=dev).manual_seed(17)
    G, B, H = 2, 3, 3
    C, N = 64 * H, grid[0] * grid[1]
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev)
    x = rnd(G, B, N, C)
    kv = rnd(G, B, N, C) if cross else x
    w = [rnd(C, C) * C ** -0.5 for _ in range(3)]
    q, k, v = ((t @ wi).to(torch.bfloat16) for t, wi in zip((x, kv, kv), w))
    before = fs.attention_site.launches
    out = fs.site_attention(q, k, v, H)
    assert fs.attention_site.launches == before and out.shape == q.shape
    per_head = lambda t: t.reshape(G * B, N, H, 64).transpose(1, 2).contiguous()
    ref = sa.small_attention(per_head(q), per_head(k), per_head(v))
    torch.cuda.synchronize()
    assert torch.equal(per_head(out), ref)
    _bf16_close(out, fs.site_attention_plain(q, k, v, H))


def test_flash_attention_refuses_unsupported(dev):
    x = torch.zeros(1, 1, 64, 96, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="D in"):
        fa.flash_attention_fwd(x, x, x)
    y = torch.zeros(1, 1, 64, 64, device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        fa.flash_attention_fwd(y, y, y)


def _unit(g, dev, C):
    conv = lambda: (torch.randn(C, C, 3, 3, generator=g, device=dev) / (3 * C ** 0.5),
                    0.1 * torch.randn(C, generator=g, device=dev))
    return conv(), conv()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 9, 16, 256), (1, 7, 11, 128), (1, 5, 128, 256),
                                   (2, 9, 64, 256), (1, 7, 32, 256)])
def test_res_unit_kernel(dev, dtype, shape):
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(11)
    v, base = (torch.randn(*shape, generator=g, device=dev).to(dtype) for _ in range(2))
    unit = _unit(g, dev, shape[-1])
    w, b = dp._unit_weights(unit, dtype)
    for bs in (None, base):
        before = dp.fused_res_unit.launches
        out = dp.fused_res_unit(v, unit, bs)
        assert dp.fused_res_unit.launches == before + 1 and out.dtype == dtype
        ref = dp.res_unit_plain(v, bs, w, b)
        torch.cuda.synchronize()
        _close(out, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 12, 20, 256), (1, 8, 16, 128), (1, 9, 100, 128)])
def test_head_final_kernel(dev, dtype, shape):
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn(*shape, generator=g, device=dev).to(dtype)
    C1 = shape[-1]
    p1 = (torch.randn(128, C1, 3, 3, generator=g, device=dev) / (3 * C1 ** 0.5),
          0.1 * torch.randn(128, generator=g, device=dev))
    p2 = (torch.randn(128, 128, 3, 3, generator=g, device=dev) / (3 * 128 ** 0.5),
          0.1 * torch.randn(128, generator=g, device=dev))
    p3 = (torch.randn(4, 128, 1, 1, generator=g, device=dev) / 128 ** 0.5,
          0.1 * torch.randn(4, generator=g, device=dev))
    before = dp.fused_head_final.launches
    out = dp.fused_head_final(x, p1, p2, p3)
    assert dp.fused_head_final.launches == before + 1
    ref = dp.head_final_plain(x, *dp._head_weights(p1, p2, p3, dtype))
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and out.shape == (shape[0], 2 * shape[1], 2 * shape[2], 4)
    _close(out, ref, dtype)


@pytest.mark.parametrize("C3", [1, 3, 16])
def test_head_final_kernel_output_counts(dev, C3):
    """The 1x1 conv's outputs C3 in 1..16: w3 padded to a multiple of 4 in
    shared memory, scalar stores where C3 % 4 != 0; two launches give the
    same bits (no atomics)."""
    g = torch.Generator(device=dev).manual_seed(15)
    x = torch.randn(1, 8, 24, 128, generator=g, device=dev).to(torch.bfloat16)
    p1 = (torch.randn(128, 128, 3, 3, generator=g, device=dev) / 34,
          0.1 * torch.randn(128, generator=g, device=dev))
    p2 = (torch.randn(128, 128, 3, 3, generator=g, device=dev) / 34,
          0.1 * torch.randn(128, generator=g, device=dev))
    p3 = (torch.randn(C3, 128, 1, 1, generator=g, device=dev) / 11,
          0.1 * torch.randn(C3, generator=g, device=dev))
    out, again = dp.fused_head_final(x, p1, p2, p3), dp.fused_head_final(x, p1, p2, p3)
    ref = dp.head_final_plain(x, *dp._head_weights(p1, p2, p3, torch.bfloat16))
    torch.cuda.synchronize()
    assert out.shape == (1, 16, 48, C3) and torch.equal(out, again)
    _close(out, ref, torch.bfloat16)


def _kernel_names(fn):
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def test_bf16_convs_launch_the_sm90_kernels(dev):
    """K7's and K8's bf16 convs run on the GEMM core's conv instances
    (conv_sm90<EPI>: relu, resid; round, head), the fp32 ones on the 3xTF32
    kernel (conv_tf32_sm90<EPI>), and each path's upsample on the 16-byte
    kernel."""
    g = torch.Generator(device=dev).manual_seed(13)
    bf = torch.bfloat16
    v = torch.randn(1, 9, 16, 256, generator=g, device=dev).to(bf)
    unit = _unit(g, dev, 256)
    x = torch.randn(1, 8, 16, 256, generator=g, device=dev).to(bf)
    p1 = (torch.randn(128, 256, 3, 3, generator=g, device=dev) / 48, torch.zeros(128, device=dev))
    p2 = (torch.randn(128, 128, 3, 3, generator=g, device=dev) / 34, torch.zeros(128, device=dev))
    p3 = (torch.randn(4, 128, 1, 1, generator=g, device=dev) / 11, torch.zeros(4, device=dev))
    for dtype, want in ((bf, ("conv_sm90<3>", "conv_sm90<1>", "conv_sm90<0>", "conv_sm90<2>")),
                        (torch.float32, ("conv_tf32_sm90<3>", "conv_tf32_sm90<1>",
                                         "conv_tf32_sm90<0>", "conv_tf32_sm90<2>"))):
        names = _kernel_names(lambda: (dp.fused_res_unit(v.to(dtype), unit, v.to(dtype)),
                                       dp.fused_head_final(x.to(dtype), p1, p2, p3)))
        convs = [n for n in names if "conv" in n]
        assert len(convs) == 4 and all(sum(w in c for c in convs) == 1 for w in want), convs
        assert sum("upsample2x_kernel" in n for n in names) == 1


@pytest.mark.parametrize("epi", ["round", "relu", "resid", "resid+base", "head"])
@pytest.mark.parametrize("shape", [(2, 9, 16, 256), (1, 9, 11, 128), (1, 5, 128, 256),
                                   (1, 7, 32, 128)])
def test_conv_tf32_epilogues(dev, shape, epi):
    """Each fp32 conv launch alone (conv_tf32_sm90<EPI>) against
    conv3x3_plain at 1e-4 of the largest value: the ragged 9-row level, W = 11
    in a 16-wide box, two output-channel tiles at Cout 256 (one for the head);
    two launches give the same bits."""
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(16)
    B, H, W, Cin = shape
    Cout = 128 if epi == "head" else Cin
    x, resid, base = (torch.randn(B, H, W, n, generator=g, device=dev) for n in (Cin, Cout, Cout))
    taps = torch.randn(9, Cin, Cout, generator=g, device=dev) / (3 * Cin ** 0.5)
    bias = 0.1 * torch.randn(Cout, generator=g, device=dev)
    w3 = torch.randn(Cout, 4, generator=g, device=dev) / 11
    b3 = 0.1 * torch.randn(4, generator=g, device=dev)
    e, relu = {"round": (dp.EPI_ROUND, False), "relu": (dp.EPI_RELU, True),
               "resid": (dp.EPI_RESID, False), "resid+base": (dp.EPI_RESID, False),
               "head": (dp.EPI_HEAD, False)}[epi]
    kw = dict(resid=resid if e == dp.EPI_RESID else None,
              base=base if epi == "resid+base" else None,
              w3=w3 if e == dp.EPI_HEAD else None, b3=b3 if e == dp.EPI_HEAD else None)

    def launch():
        out = torch.empty(B, H, W, 4 if e == dp.EPI_HEAD else Cout, device=dev)
        dp._conv(x, taps, bias, out, e, relu, **kw)
        return out

    out, again = launch(), launch()
    ref = dp.conv3x3_plain(x, taps, bias, e, relu_in=relu, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    _close(out, ref, torch.float32)


def _ln_inputs(g, dev, G, rows, C):
    x = torch.randn(G, 1, rows, C, generator=g, device=dev).to(torch.bfloat16)
    return x, (1 + 0.1 * torch.randn(G, C, generator=g, device=dev),
               0.1 * torch.randn(G, C, generator=g, device=dev))


@pytest.mark.parametrize("G, rows, C", [(1, 9216, 1024), (2, 18432, 768), (1, 1000, 128),
                                        (2, 1001, 768), (3, 77, 1024), (1, 5, 264)])
def test_layernorm_launch(dev, G, rows, C):
    """K1/K2's LayerNorm launch against _ln at the encoder's and decoder's
    recipe shapes, the parity phase's C = 128, and row counts that are not a
    multiple of the warps, one stream's rows ending inside a warp's walk and
    a C that leaves lanes idle, within 2 bf16 ulps of the largest value (fp32
    statistics summed in another order, one rounding); each launch counts
    once."""
    g = torch.Generator(device=dev).manual_seed(17)
    x, p = _ln_inputs(g, dev, G, rows, C)
    before = fs._ln_cuda.launches
    from align3r_tpu_torch.ops import _lib
    out = fs._ln_cuda(_lib.library(), x, p, _lib.stream())
    ref = fs._ln(x, p)
    torch.cuda.synchronize()
    assert fs._ln_cuda.launches == before + 1 and out.dtype == torch.bfloat16
    _bf16_close(out, ref)


def test_layernorm_refuses_misaligned_pointers(dev):
    """The LayerNorm launch makes 16-byte loads and stores: a3r_layernorm
    refuses an x, scale, bias or y pointer off a 16-byte boundary with
    cudaErrorInvalidValue (the context stays usable), and _ln_cuda copies a
    misaligned x to an aligned one and still matches _ln."""
    from align3r_tpu_torch.ops import _lib
    g = torch.Generator(device=dev).manual_seed(18)
    G, rows, C = 1, 77, 768
    x, p = _ln_inputs(g, dev, G, rows, C)
    buf = torch.empty(x.numel() + 8, device=dev, dtype=torch.bfloat16)
    xm = buf[1:1 + x.numel()].view(x.shape)
    xm.copy_(x)
    scale, bias = (t.float().contiguous() for t in p)
    y = torch.empty_like(x)
    lib = _lib.library()
    ptrs = [x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr()]
    for i in range(4):
        bad = list(ptrs)
        bad[i] += 4
        rc = lib.a3r_layernorm(*bad, rows, G * rows, C, 1e-6, _lib.stream())
        assert rc == 1, (i, rc)   # cudaErrorInvalidValue
    out = fs._ln_cuda(lib, xm, p, _lib.stream())
    ref = fs._ln(x, p)
    torch.cuda.synchronize()
    _bf16_close(out, ref)


def test_conv_refuses_unsupported(dev):
    """The bf16 convs need Cin % 64 (a k-tile is one 128-byte swizzle row);
    fp32 takes Cin % 32; fp16 is refused."""
    g = torch.Generator(device=dev).manual_seed(14)
    p1 = (torch.randn(128, 96, 3, 3, generator=g, device=dev) / 30, torch.zeros(128, device=dev))
    p2 = (torch.randn(128, 128, 3, 3, generator=g, device=dev) / 34, torch.zeros(128, device=dev))
    p3 = (torch.randn(4, 128, 1, 1, generator=g, device=dev) / 11, torch.zeros(4, device=dev))
    x = torch.randn(1, 8, 16, 96, generator=g, device=dev)
    with pytest.raises(ValueError, match="C1 % 64"):
        dp.fused_head_final(x.to(torch.bfloat16), p1, p2, p3)
    out = dp.fused_head_final(x, p1, p2, p3)
    ref = dp.head_final_plain(x, *dp._head_weights(p1, p2, p3, torch.float32))
    torch.cuda.synchronize()
    _close(out, ref, torch.float32)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        dp.fused_res_unit(torch.zeros(1, 8, 16, 128, device=dev, dtype=torch.float16),
                          _unit(g, dev, 128))


def test_512x512_training_forward_takes_k9(dev):
    """At 512 x 512 (1024 tokens, D = 64, bf16) every attention of the
    training forward fails K6's gate and launches K9: 20 forwards (2 encoder,
    16 decoder, 2 prior blocks) plus the 18 recomputed under full remat, and
    18 backwards (the encoder is frozen); K6 never launches."""
    from align3r_tpu_torch.training import step as S
    model, batch = _tiny_model(dev, (512, 512))
    params = [p for p in model.parameters() if p.requires_grad]
    before = (fa.flash_attention.launches, fa.flash_attention_bwd.launches,
              sa.small_attention.launches)
    loss, _ = S.loss_fn(model, batch, remat="full")
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    torch.cuda.synchronize()
    after = (fa.flash_attention.launches, fa.flash_attention_bwd.launches,
             sa.small_attention.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (38, 18, 0)
    assert torch.isfinite(loss) and all(torch.isfinite(g).all() for g in grads if g is not None)


# the DINOv2 attentions of the monocular priors (fp32, D = 64, 16 heads):
# Depth Pro's 577 tokens, Depth Anything V2's 2443 at 518x924 and PromptDA's
# 2994 at 574x1022; none a multiple of the fp32 key tile (32)
@pytest.mark.parametrize("shape", [(3, 16, 577, 64), (1, 16, 2443, 64), (1, 8, 2994, 64)])
def test_flash_attention_fp32_forward_at_the_prior_shapes(dev, shape):
    """"auto" routes the priors' attentions to K9 (K6 takes Nq % 16 == 0
    only), whose fp32 forward is held to its plain version (1e-4 x max)."""
    from align3r_tpu_torch.ops.attention import attention, route
    g = torch.Generator(device=dev).manual_seed(20)
    q, k, v = (torch.randn(*shape, generator=g, device=dev) for _ in range(3))
    assert route(q, k, v, on_card=True) == "flash"
    before = fa.flash_attention.launches
    o = attention(q, k, v, "auto")
    assert fa.flash_attention.launches == before + 1
    ro, _ = fa.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    _close(o, ro, torch.float32)


@pytest.mark.parametrize("kind", ["depth_anything", "depth_pro"])
def test_prior_model_on_the_card_takes_k9(dev, kind):
    """A narrow prior (D = 64 heads) on the card: one K9 forward a ViT layer
    pass, none of K9's backward, and the depth within 1e-4 of the same model
    with plain attention (impl "xla")."""
    from align3r_tpu_torch.models import depth_anything as tda
    from align3r_tpu_torch.models import depth_pro as tdp
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if kind == "depth_anything":
        cfg = tda.DAConfig(hidden_size=128, num_layers=4, num_heads=2, out_indices=(1, 2, 3, 4),
                           neck_hidden_sizes=(16, 24, 32, 32), fusion_hidden_size=16,
                           head_hidden_size=8, image_size=70)
        with torch.device(dev):
            model = tda.init_prior_(tda.DepthAnything(cfg).eval(), seed=0)
        x, passes = torch.randn(2, 70, 84, 3, generator=torch.Generator(device=dev).manual_seed(0),
                                device=dev), 4
    else:
        vit = tdp.ViTCfg(128, 2, 2, 8, 32)
        cfg = tdp.DepthProConfig(patch_model=vit, image_model=vit, fov_model=vit, patch_size=32,
                                 scaled_images_feature_dims=(32, 32, 16),
                                 intermediate_hook_ids=(1, 0),
                                 intermediate_feature_dims=(16, 16), fusion_hidden_size=16,
                                 image_size=128)
        with torch.device(dev):
            model = tda.init_prior_(tdp.DepthPro(cfg).eval(), seed=0)
        x, passes = torch.randn(1, 128, 128, 3, generator=torch.Generator(device=dev).manual_seed(0),
                                device=dev), 3 * 2
    before = (fa.flash_attention.launches, fa.flash_attention_bwd.launches)
    with torch.inference_mode():
        out = model(x)
        launched = fa.flash_attention.launches - before[0]
        model.attn_impl = "xla"
        ref = model(x)
    torch.cuda.synchronize()
    assert launched == passes and fa.flash_attention_bwd.launches == before[1]
    depth, ref_depth = (out[0], ref[0]) if kind == "depth_pro" else (out, ref)
    _close(depth, ref_depth, torch.float32)


# SAM2.1 Hiera-L's shapes: the stage-3 windows (16 windows x 8 heads x 256
# tokens, D = 72, padded to the DP = 128 instance) and the first stage-4 block
# (query-pooled to 64 of its 256 tokens, 16 heads)
@pytest.mark.parametrize("shape", [(16, 8, 256, 72, 256), (16, 16, 64, 72, 256),
                                   (2, 3, 100, 72, 33)])
def test_small_attention_f32_sam2_head_dim(dev, shape):
    """K6 fp32 at D = 72: the padded lanes of q, k and v must stay zero in
    both halves of the split, the scale is 72^-1/2, and only 72 output
    columns are written (a neighbour's row would show in the next head)."""
    B, H, Nq, D, Nk = shape
    g = torch.Generator(device=dev).manual_seed(21)
    q, k, v = (torch.randn(B, H, n, D, generator=g, device=dev) for n in (Nq, Nk, Nk))
    before = sa.small_attention.launches
    out = sa.small_attention(q, k, v)
    assert sa.small_attention.launches == before + 1
    ref = sa.small_attention_plain(q, k, v)
    torch.cuda.synchronize()
    _close(out, ref, torch.float32)


def test_flash_attention_f32_sam2_memory_shape(dev):
    """K9's fp32 forward at SAM2.1's memory self-attention: one head of 4096
    tokens at D = 256 (64 query blocks on 132 SMs)."""
    g = torch.Generator(device=dev).manual_seed(22)
    q, k, v = (torch.randn(1, 1, 4096, 256, generator=g, device=dev) for _ in range(3))
    (o, lse), (ro, rlse) = fa.flash_attention_fwd(q, k, v), fa.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    _close(o, ro, torch.float32)
    assert (lse - rlse).abs().max().item() <= 1e-5 * rlse.abs().max().item()


def test_sam2_on_the_card_takes_k6_and_k9(dev):
    """A narrow seeded SAM2 video model whose first two Hiera blocks attend in
    16x16 windows (D = 16) and whose memory attention is one head at
    D = 256: propagate_video on 3 frames launches K6 and K9 as
    dispatch_counts says (2 K6 a frame step, one K9 a memory layer of each
    tracked step), no K9 backward, and its logits agree with plain attention
    (impl "xla") within 1e-4 of the largest."""
    from align3r_tpu_torch.models import sam2 as ts
    from align3r_tpu_torch.models import sam2_video as tsv
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hiera = ts.HieraConfig(hidden_size=16, num_heads_per_stage=(1, 2, 4, 8),
                           blocks_per_stage=(1, 1, 1, 1), embed_dim_per_stage=(16, 32, 64, 128),
                           window_size_per_stage=(16, 4, 4, 2), global_attention_blocks=(),
                           window_pos_bg_size=(4, 4), mlp_ratio=2.0)
    image = ts.SAM2Config(hiera=hiera, backbone_channel_list=(128, 64, 32, 16), image_size=256,
                          decoder_mlp_dim=256, iou_head_hidden_dim=64)
    cfg = tsv.SAM2VideoConfig(image=image, num_maskmem=3, max_object_pointers=4,
                              ma_num_layers=2, ma_ff_hidden_size=256, ma_rope_feat_sizes=(16, 16),
                              fuser_intermediate_dim=256)
    trunk, mem = tsv.dispatch_counts(cfg)
    assert trunk["small"] == 2 and mem["flash"] == 2
    with torch.device(dev):
        model = ts.init_sam2_(tsv.SAM2Video(cfg).eval(), seed=0)
    g = torch.Generator(device=dev).manual_seed(23)
    frames = torch.randn(3, 256, 256, 3, generator=g, device=dev)
    seed = torch.zeros(256, 256, 1, device=dev)
    seed[80:170, 60:150] = 1.0
    counters = (sa.small_attention, fa.flash_attention, fa.flash_attention_bwd)
    before = [c.launches for c in counters]
    out = tsv.propagate_video(model, frames, seed)
    launched = [c.launches - b for c, b in zip(counters, before)]
    model.attn_impl = "xla"
    ref = tsv.propagate_video(model, frames, seed)
    torch.cuda.synchronize()
    assert launched == [3 * trunk["small"], 2 * mem["flash"], 0]
    _close(out, ref, torch.float32)


def test_train_from_dataset_strings_on_the_card(dev, tmp_path):
    """The data phase's round trip at a small size: a SceneFlow folder of
    `_rgb.jpg` frames (the port's decoder) and a Sintel folder of PNG frames,
    written by the port's writers, read through dataset expressions by
    `tools.train.main` on the card at a tiny width: finite losses, K6 at
    every micro-step (128 tokens a view at 256x128, head dim 16, K6's gate),
    checkpoint-final.pth reloads."""
    from align3r_tpu_torch.tools import train as cli
    from torch_data_fixtures import write_preprocessed_scene, write_sintel_scene
    sf = tmp_path / "sf"
    for i in range(2):
        write_preprocessed_scene(str(sf / f"FlyingThings3D_proc/TRAIN/A/000{i}/left"), 4,
                                 (144, 256), i)
    sintel = write_sintel_scene(str(tmp_path / "sintel"), "alley_1", 4, (120, 280), 2)
    kw = "resolution=[(256, 128)], aug_crop=8, seed=777"
    expr = (f"4 @ SceneFlowDatasets(split='train', ROOT={str(sf)!r}, {kw}) + "
            f"4 @ SintelDatasets(split='train', ROOT={sintel!r}, {kw})")
    model = ("Align3RConfig(img_size=(128, 256), enc_embed_dim=64, enc_depth=4, "
             "enc_num_heads=4, dec_embed_dim=64, dec_depth=12, dec_num_heads=4)")
    before = sa.small_attention.launches
    res = cli.main(["--model", model, "--train_dataset", expr, "--batch_size", "2",
                    "--accum_iter", "2", "--epochs", "1", "--warmup_epochs", "0",
                    "--num_workers", "2", "--output_dir", str(tmp_path / "out")])
    steps = len(res.history)
    assert steps == 4 and all(np.isfinite(h["loss"]) for h in res.history)
    assert sa.small_attention.launches - before >= steps
    sd = torch.load(tmp_path / "out" / "checkpoint-final.pth", weights_only=True)["model"]
    assert set(sd) == set(res.model.state_dict())
