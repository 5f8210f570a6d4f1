"""The blocked plain versions of K3/K4 (edge_loss_{fwd,bwd}_tiles_plain in
align3r_tpu_torch.ops.edge_loss): the kernels' walk over (pixel tile, image)
pairs through the CSR of each image's terms, their partials and their
second passes, in PyTorch.

They are held to the plain versions edge_loss_{fwd,bwd}_plain with an image
that has no terms, A not a multiple of the tile, an odd A, and terms in
random order; and to JAX's Pallas K3/K4 (align3r_tpu.ops.edge_loss) in
interpret mode at one small shape. Tolerance: 1e-5 of the largest value
(fp32 arithmetic on the stored values, sums in another order). The tile and
stage constants of the wrapper are held to those written in
csrc/edge_loss.cu.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from align3r_tpu.ops import edge_loss as jel
from align3r_tpu_torch.ops import edge_loss as tel

torch.set_num_threads(2)
CSRC = Path(tel.__file__).resolve().parents[1] / "csrc"


def _close(got, ref, rel=1e-5):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rel * max(np.abs(ref).max(), 1e-30), \
        (np.abs(got - ref).max(), np.abs(ref).max())


def _inputs(seed, n, e2, A, dtype, sort=True, empty=None):
    """Channel-major inputs as the pack lays them out: pred (e2, 3, A) and
    w (e2, A) in `dtype`, proj (n, 3, A) fp32, idx (e2,) int32 (sorted by
    image unless sort=False; image `empty` gets no terms), pw34 (e2, 3, 4),
    with one exact zero residual."""
    r = np.random.default_rng(seed)
    imgs = [i for i in range(n) if i != empty]
    idx = r.choice(imgs, e2).astype(np.int32)
    idx[:len(imgs)] = imgs[:e2]                      # every other image has a term
    idx = np.sort(idx) if sort else r.permutation(idx)
    proj = r.standard_normal((n, 3, A)).astype(np.float32)
    pred = r.standard_normal((e2, 3, A)).astype(np.float32)
    w = r.uniform(0, 1, (e2, A)).astype(np.float32) / (e2 * A)
    pw34 = (np.eye(3, 4)[None] + 0.2 * r.standard_normal((e2, 3, 4))).astype(np.float32)
    pw34[1] = np.eye(3, 4)
    pred[1, :, 7] = proj[idx[1], :, 7]               # an exact zero residual
    tdt = {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype]
    pred_t = torch.from_numpy(pred).to(tdt)
    proj_t = torch.from_numpy(proj)
    # the zero residual survives the storage rounding
    proj_t[idx[1], :, 7] = pred_t[1, :, 7].float()
    idx_t = torch.from_numpy(idx)
    order, offsets = tel.term_csr(idx_t, n)
    return (proj_t, torch.from_numpy(pw34), pred_t, torch.from_numpy(w).to(tdt), idx_t,
            order, offsets)


CASES = {
    # name: (n, e2, A, sort, empty image)
    "one tile": (3, 5, 300, True, None),
    "ragged A, empty image": (4, 9, 2 * tel.EDGE_TILE + 904, True, 2),
    "odd A, unsorted": (3, 7, 1001, False, None),
    "odd A over two tiles, unsorted, empty image": (5, 8, tel.EDGE_TILE + 3, False, 0),
    "whole tiles": (2, 4, 2 * tel.EDGE_TILE, True, None),
}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_tiles_plain_matches_plain(case, dtype):
    n, e2, A, sort, empty = CASES[case]
    proj, pw34, pred, w, idx, order, offsets = _inputs(7, n, e2, A, dtype, sort, empty)
    loss = tel.edge_loss_fwd_tiles_plain(proj, pw34, pred, w, idx, order, offsets)
    _close(loss.item(), tel.edge_loss_fwd_plain(proj, pw34, pred, w, idx).item())
    g = torch.tensor(0.7)
    dp, dm = tel.edge_loss_bwd_tiles_plain(g, proj, pw34, pred, w, idx, order, offsets)
    rdp, rdm = tel.edge_loss_bwd_plain(g, proj, pw34, pred, w, idx)
    _close(dp.numpy(), rdp.numpy())
    _close(dm.numpy(), rdm.numpy())
    if empty is not None:
        assert (dp[empty] == 0).all()


def test_tiles_plain_walk_and_second_pass_order():
    """The blocked forward is the image-major partials summed in blocks of
    EDGE_SUM_BLOCK, then the blocks in order: over 300 (tile, image) pairs,
    two blocks of the second pass."""
    n, e2, A = 150, 150, tel.EDGE_TILE + 1
    proj, pw34, pred, w, idx, order, offsets = _inputs(3, n, e2, A, "fp32")
    assert tel.edge_tiles(A) * n > tel.EDGE_SUM_BLOCK
    partials = torch.zeros(n, 2)
    for img, _, r, _, wt in tel._walk(proj, pw34, pred, w, order, offsets):
        sq = (r * r).sum(dim=1)
        d = torch.where(sq > 0, torch.sqrt(torch.clamp(sq, min=tel.EPS)), torch.zeros_like(sq))
        partials[img] = (wt * d).sum(dim=(0, 2))
    flat = partials.reshape(-1)
    want = flat[:tel.EDGE_SUM_BLOCK].sum() + flat[tel.EDGE_SUM_BLOCK:].sum()
    got = tel.edge_loss_fwd_tiles_plain(proj, pw34, pred, w, idx, order, offsets)
    assert got.item() == want.item()
    _close(got.item(), tel.edge_loss_fwd_plain(proj, pw34, pred, w, idx).item())


def test_tiles_plain_matches_pallas_interpret():
    """JAX's K3 and K4 (the Pallas kernels in interpret mode, lane-packed
    with padded pixels) against the blocked plain versions on the same
    values, bf16 observations as the main path stores them, terms unsorted
    and one image without terms."""
    n, e2, A = 4, 8, 300
    proj, pw34, pred, w, idx, order, offsets = _inputs(11, n, e2, A, "bf16", sort=False,
                                                       empty=3)
    la = -(-A // 128)
    la = -(-la // 8) * 8
    jdt = jnp.bfloat16
    meta = jel.EdgeMeta(n=n, e2=e2, la=la, rb=8, eb=8, nc=0, interpret=True)
    as_np = lambda t: t.float().numpy().transpose(0, 2, 1)          # (., A, 3)
    proj_p = jel.pack_points(jnp.asarray(as_np(proj)), la, jnp.float32)
    pred_p = jel.pack_points(jnp.asarray(as_np(pred)), la, jdt)
    w_p = jel.pack_scalars(jnp.asarray(w.float().numpy()), la, jdt)

    def f(pp, m):
        return jel.edge_loss(meta, pp, m, pred_p, w_p, jnp.asarray(idx.numpy()))

    loss_j, (dproj_j, dpw_j) = jax.value_and_grad(f, argnums=(0, 1))(
        proj_p, jnp.asarray(pw34.numpy()))
    dproj_j = np.asarray(jel.unpack_points(dproj_j, A)).transpose(0, 2, 1)
    loss = tel.edge_loss_fwd_tiles_plain(proj, pw34, pred, w, idx, order, offsets)
    dp, dm = tel.edge_loss_bwd_tiles_plain(torch.tensor(1.0), proj, pw34, pred, w, idx,
                                           order, offsets)
    _close(loss.item(), float(loss_j))
    _close(dp.numpy(), dproj_j)
    _close(dm.numpy(), np.asarray(dpw_j))
    assert (dp[3] == 0).all()


def test_gate_constants_match_the_kernel_source():
    """EDGE_THREADS, EDGE_PPT, EDGE_STAGES, EDGE_MAXT and EDGE_SUM_BLOCK are
    ETHREADS, EPT, ESTAGES_BF16 / ESTAGES_F32, EMAXT and EBLOCK_SUM of
    csrc/edge_loss.cu; EPS is its EDGE_EPS."""
    cu = (CSRC / "edge_loss.cu").read_text()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", cu).group(1))
    assert const("ETHREADS") == tel.EDGE_THREADS
    assert const("EPT") == tel.EDGE_PPT
    assert re.search(r"constexpr int ETILE = ETHREADS \* EPT;", cu)
    assert const("ESTAGES_BF16") == tel.EDGE_STAGES[torch.bfloat16]
    assert const("ESTAGES_F32") == tel.EDGE_STAGES[torch.float32]
    assert const("EMAXT") == tel.EDGE_MAXT
    assert const("EBLOCK_SUM") == tel.EDGE_SUM_BLOCK
    eps = float(re.search(r"constexpr float EDGE_EPS = ([0-9.e-]+)f;", cu).group(1))
    assert eps == tel.EPS
    assert tel.edge_tiles(147456) == 144 and tel.edge_tiles(tel.EDGE_TILE + 1) == 2


def test_cpu_wrappers_take_the_plain_versions():
    """Off the card K3's wrapper reads idx alone (the CSR only on the card)
    and K4's is the plain version, launching nothing."""
    proj, pw34, pred, w, idx, order, offsets = _inputs(5, 3, 6, 500, "bf16", sort=False)
    before = (tel.edge_loss_fwd.launches, tel.edge_loss_bwd.launches)
    loss = tel.edge_loss_fwd(proj, pw34, pred, w, idx, order, offsets)
    assert loss.item() == tel.edge_loss_fwd_plain(proj, pw34, pred, w, idx).item()
    dp, dm = tel.edge_loss_bwd(torch.tensor(2.0), proj, pw34, pred, w, idx, order, offsets)
    rdp, rdm = tel.edge_loss_bwd_plain(torch.tensor(2.0), proj, pw34, pred, w, idx)
    assert torch.equal(dp, rdp) and torch.equal(dm, rdm)
    assert (tel.edge_loss_fwd.launches, tel.edge_loss_bwd.launches) == before
