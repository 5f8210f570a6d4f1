"""Port parity: K9 (align3r_tpu_torch.ops.flash_attention), the "flash" route
of the attention dispatch, and the train step on the K9 route, against
align3r_tpu.

Oracles: JAX's stock Pallas flash attention (stock_flash_attention) in
interpret mode at one small ragged shape, jax.grad through it, and the XLA
attention. Tolerances, each with its reason:
- fp32 forward: 2e-5 absolute against the stock kernel (the JAX test's own,
  tests/test_stock_flash.py) and 1e-5 of the largest value against the XLA
  attention: the same math, sums in another order;
- bf16 forward: 1e-2 absolute (outputs of magnitude about 1): the port
  rounds P to bf16 against its running max over 128-key blocks at D = 64
  (block_k), the stock kernel over 128- (N = 300) or 256-key (N = 256)
  blocks here, so one bf16 rounding of P (relative 4e-3) differs;
- gradients: 1e-4 of the largest gradient, the JAX test's tolerance;
- the train step on the K9 route: test_torch_training's tolerances.
On the CPU every wrapper takes its plain version and counts no launch.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from align3r_tpu.ops import attention as jattn
from align3r_tpu_torch.models.config import Align3RConfig
from align3r_tpu_torch.ops import attention as tattn
from align3r_tpu_torch.ops import flash_attention as tfa
from test_torch_training import KW, _run_both

torch.set_num_threads(2)


def _qkv(seed, shape):
    r = np.random.default_rng(seed)
    return [r.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _launches():
    return tfa.flash_attention.launches, tfa.flash_attention_bwd.launches


def test_flash_route_off_the_card_matches_jax():
    """JAX's attention(impl="flash") returns the XLA attention wherever its
    flash_ok fails, which is everywhere off the TPU; the port's does the
    same off the card instead of raising."""
    q, k, v = _qkv(0, (1, 2, 130, 64))
    ref = _f32(jattn.attention(*map(jnp.asarray, (q, k, v)), impl="flash"))
    before = _launches()
    got = tattn.attention(*map(torch.from_numpy, (q, k, v)), impl="flash")
    assert _launches() == before
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5 * np.abs(ref).max())


def test_block_k_is_the_kernels_key_tile():
    """block_k(), which the plain forward runs, is the forward kernel's BK as
    written in csrc/flash_attention.cu (Tiles<T, D>::BK), so the plain version
    and the kernel round P against the same running max."""
    src = (Path(tfa.__file__).parents[1] / "csrc" / "flash_attention.cu").read_text()
    for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "float")):
        body = re.search(r"struct Tiles<%s, D> \{(.*?)\};" % name, src, re.S).group(1)
        d, bk_at_d, bk_else = map(int, re.search(
            r"BK = D == (\d+) \? (\d+) : (\d+);", body).groups())
        for D in tfa.HEAD_DIMS:
            assert tfa.block_k(D, dtype) == (bk_at_d if D == d else bk_else), (name, D)


# N = 300: a ragged length across the 128-key block of the bf16 kernel at D = 64
@pytest.mark.parametrize("n, dtype, atol", [(130, "fp32", 2e-5), (256, "bf16", 1e-2),
                                            (300, "bf16", 1e-2)])
def test_plain_forward_matches_stock_flash_interpret(n, dtype, atol):
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    q, k, v = _qkv(1, (1, 2, n, 64))
    with pltpu.force_tpu_interpret_mode():
        ref = _f32(jattn.stock_flash_attention(*(jnp.asarray(a, jdt) for a in (q, k, v))))
    before = _launches()
    got = tfa.flash_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)))
    assert _launches() == before and got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), ref, atol=atol)


@pytest.mark.parametrize("n", [576, 1024])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_plain_forward_matches_xla_attention(n, d):
    q, k, v = _qkv(2, (1, 1, n, d))
    ref = _f32(jattn.xla_attention(*map(jnp.asarray, (q, k, v))))
    o, lse = tfa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(o.numpy(), ref, atol=1e-5 * np.abs(ref).max())
    s = np.einsum("bhqd,bhkd->bhqk", q, k) * d ** -0.5
    np.testing.assert_allclose(lse.numpy(), np.log(np.exp(s).sum(-1)), rtol=1e-5)


def test_plain_gradients_match_stock_flash_interpret():
    q, k, v = _qkv(3, (1, 2, 130, 64))
    g = np.random.default_rng(4).standard_normal(q.shape).astype(np.float32)

    def loss(q, k, v):
        return jnp.sum(jattn.stock_flash_attention(q, k, v) * g)

    with pltpu.force_tpu_interpret_mode():
        refs = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    before = _launches()
    tfa.flash_attention(*ts).backward(torch.from_numpy(g))
    assert _launches() == before
    for t, r in zip(ts, refs):
        r = np.asarray(r)
        np.testing.assert_allclose(t.grad.numpy(), r, atol=1e-4 * np.abs(r).max())


def test_route_picks_k9_at_512x512_and_k6_at_288x512():
    """What "auto" resolves to, from shapes, dtype and whether the tensors
    are on the card: ViT-L's attentions at 512 x 512 (1024 tokens) fail K6's
    VMEM gate and take K9 on the card; at 288 x 512 (576 tokens) they take
    K6; off the card every one takes the XLA attention."""
    def route(shape, dtype=torch.bfloat16, on_card=True):
        t = torch.empty(shape, dtype=dtype, device="meta")
        return tattn.route(t, t, t, on_card)

    for heads in (16, 12):                      # encoder; decoder and prior branch
        assert route((4, heads, 1024, 64)) == "flash"
        assert route((4, heads, 576, 64)) == "small"
        assert route((4, heads, 1024, 64), on_card=False) == "xla"
    assert route((4, 16, 1000, 64)) == "flash"                  # ragged: not % 16
    assert route((4, 16, 1024, 64), torch.float32) == "flash"
    assert route((1, 2, 1024, 96)) == "xla"                     # D not in K9's set
    q = torch.empty((1, 2, 1024, 64), device="meta")
    assert not tattn.flash_ok(q, torch.empty((1, 2, 512, 64), device="meta"), q, True)


def test_cuda_wrapper_refuses_unsupported_inputs():
    x = torch.zeros(1, 1, 16, 64)
    with pytest.raises(ValueError, match="CUDA"):
        tfa._fwd_cuda(x, x, x)


def test_train_step_on_the_k9_route_matches_jax(monkeypatch):
    """The port's train step with every attention routed to K9 (its plain
    forward and backward on the CPU, through the autograd Function), held to
    the JAX make_train_step, which runs the XLA attention on the CPU. The
    route is forced by making flash_ok hold off the card, in this test only:
    a tiny config at N >= 1024 would put the fixed 256-channel DPT head at
    512 x 512 on the CPU, and the gate is held to the training shapes in
    test_route_picks_k9_at_512x512_and_k6_at_288x512."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = tfa.flash_attention_plain, tfa.flash_attention_bwd_plain

    def counted(key, fn):
        def wrapped(*a):
            calls[key] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(tattn, "flash_ok", lambda q, k, v, on_card=None: True)
    monkeypatch.setattr(tfa, "flash_attention_plain", counted("fwd", fwd))
    monkeypatch.setattr(tfa, "flash_attention_bwd_plain", counted("bwd", bwd))
    before = _launches()
    _run_both(Align3RConfig(img_size=(32, 32), **KW), (32, 32), 2, "auto")
    assert _launches() == before
    # per step: 2 encoder + 8 x 2 decoder + 2 prior-branch attentions, the
    # decoder's and prior branch's again in remat's recompute; the frozen
    # encoder has no backward
    assert calls == {"fwd": 2 * (2 + 2 * (16 + 2)), "bwd": 2 * (16 + 2)}
