"""Port parity: the fine-tuning path of align3r_tpu_torch (losses, optimizer
and schedule, train step, remat, the K6 route) against align3r_tpu.training.

Inputs are made with numpy from a seed; the network weights are
`init_align3r`'s, carried across with `state_dict_from_jax`, with the zero
convs filled from the seed (random init zeroes them, and the prior branch
would then change nothing) and the final head conv scaled by 0.1 (random DPT
heads otherwise saturate expm1). Tolerances, each with its reason:
- losses and their gradients, fp32: 1e-5 relative (the same math, other
  reduction orders; jnp.nanmedian's even-count mean is reproduced), 5e-5 for
  the scale-shift-invariant gradient, whose median element's z-gradient is
  a sum over every valid pixel, summed in another order;
- schedule: 1e-6 relative (optax computes it in fp32, the port in fp64);
- optimizer against optax on the same gradients: 1e-6 relative to the
  parameters' scale (fp32 Adam, other rounding of the same formulas);
- three train steps, fp32 compute: losses and grad norms 1e-4 relative; the
  trainable parameters agree within 1e-3 of the largest update U for all
  but 1e-4 of their elements, and within 2U (one flipped step) for all of
  them: Adam divides each gradient element by its own magnitude, so where
  an element's gradient is near zero, the two frameworks' other summation
  orders move or flip its step. Weight decay is 0 there: the JAX package
  decays its stacked per-layer LayerNorm scales and biases, which stacking
  makes 2-D, and the port, like the reference, does not (its decay mask is
  held to optax on unstacked shapes in the optimizer test);
- one step through K6's route (attn_impl="small") against the JAX step in
  Pallas interpret mode: the same tolerances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from align3r_tpu.models.align3r import init_align3r
from align3r_tpu.models.config import Align3RConfig as JConfig
from align3r_tpu.training import losses as jl
from align3r_tpu.training import step as js
from align3r_tpu_torch.models.align3r import Align3R
from align3r_tpu_torch.models.config import Align3RConfig
from align3r_tpu_torch.models.convert import state_dict_from_jax
from align3r_tpu_torch.ops import small_attention as tsa
from align3r_tpu_torch.training import losses as tl
from align3r_tpu_torch.training import step as ts

torch.set_num_threads(2)

KW = dict(enc_embed_dim=64, enc_depth=2, enc_num_heads=4, dec_embed_dim=48,
          dec_depth=8, dec_num_heads=4)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def _pose(r):
    a = r.uniform(-0.3, 0.3, 3)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    R = np.eye(3) + np.sin(0.5) * K + (1 - np.cos(0.5)) * K @ K
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, r.uniform(-1, 1, 3)
    return T.astype(np.float32)


def make_batch(hw, B=2, seed=0):
    r = np.random.default_rng(seed)
    H, W = hw

    def view():
        return {"img": r.standard_normal((B, H, W, 3)).astype(np.float32),
                "pred_depth": r.uniform(0, 1, (B, H, W, 3)).astype(np.float32),
                "pts3d": (r.standard_normal((B, H, W, 3)) + [0, 0, 4]).astype(np.float32),
                "camera_pose": np.stack([_pose(r) for _ in range(B)]),
                "valid_mask": r.uniform(0, 1, (B, H, W)) > 0.1}
    return {"view1": view(), "view2": view()}


def to_jax(batch):
    return jax.tree.map(jnp.asarray, batch)


def to_torch(batch):
    return {vn: {k: torch.from_numpy(np.asarray(v)) for k, v in bv.items()}
            for vn, bv in batch.items()}


# ------------------------------------------------------------------ losses

def _preds(seed, B=2, H=6, W=8):
    r = np.random.default_rng(seed)
    return ({"pts3d": (r.standard_normal((B, H, W, 3)) + [0, 0, 3]).astype(np.float32),
             "conf": (1 + r.uniform(0, 2, (B, H, W))).astype(np.float32)},
            {"pts3d_in_other_view": (r.standard_normal((B, H, W, 3))
                                     + [0, 0, 3]).astype(np.float32),
             "conf": (1 + r.uniform(0, 2, (B, H, W))).astype(np.float32)})


@pytest.mark.parametrize("odd_count", [False, True])
def test_nanmedian_matches_jnp(odd_count):
    r = np.random.default_rng(7)
    x = r.standard_normal((3, 10)).astype(np.float32)
    x[0, :4] = np.nan                      # 6 valid: even
    x[1, 3] = np.nan if odd_count else x[1, 3]
    x[2, :] = np.nan                       # all NaN
    got = tl.nanmedian(torch.from_numpy(x), dim=1).numpy()
    ref = np.asarray(jnp.nanmedian(jnp.asarray(x), axis=1))
    np.testing.assert_allclose(got[:2], ref[:2], rtol=1e-6)
    assert np.isnan(got[2]) and np.isnan(ref[2])
    # torch.nanmedian takes the lower middle value, which is not the same
    assert got[0] != torch.nanmedian(torch.from_numpy(x[0])).item()


@pytest.mark.parametrize("even", [True, False])
def test_losses_and_gradients_match_jax(even):
    batch = make_batch((6, 8), seed=1)
    if even:   # every valid count even: the median averages two values
        for v in ("view1", "view2"):
            batch[v]["valid_mask"][:] = True
    else:
        batch["view1"]["valid_mask"][:, 0, 0] = False
        batch["view2"]["valid_mask"][:] = True
    p1, p2 = _preds(2)
    jb = to_jax(batch)
    tb = to_torch(batch)

    def jconf(a, c1, b, c2):
        loss, det = jl.conf_regr3d_loss(jb["view1"], jb["view2"],
                                        {"pts3d": a, "conf": c1},
                                        {"pts3d_in_other_view": b, "conf": c2})
        return loss, det

    def jssi(a, b):
        return jl.regr3d_scale_shift_inv_loss(
            jb["view1"], jb["view2"], {"pts3d": a, "conf": None},
            {"pts3d_in_other_view": b, "conf": None})

    args = [p1["pts3d"], p1["conf"], p2["pts3d_in_other_view"], p2["conf"]]
    (jloss, jdet), jg = jax.value_and_grad(jconf, argnums=(0, 1, 2, 3),
                                           has_aux=True)(*map(jnp.asarray, args))
    jssi_v, jssi_g = jax.value_and_grad(jssi, argnums=(0, 1))(
        jnp.asarray(args[0]), jnp.asarray(args[2]))

    t = [torch.from_numpy(a).requires_grad_(True) for a in args]
    loss, det = tl.conf_regr3d_loss(tb["view1"], tb["view2"],
                                    {"pts3d": t[0], "conf": t[1]},
                                    {"pts3d_in_other_view": t[2], "conf": t[3]})
    loss.backward()
    assert _rel(loss.item(), float(jloss)) <= 1e-5
    for k in jdet:
        assert _rel(det[k].item(), float(jdet[k])) <= 1e-5, k
    for a, r in zip(t, jg):
        assert _rel(a.grad.numpy(), r) <= 1e-5
    u = [torch.from_numpy(args[i]).requires_grad_(True) for i in (0, 2)]
    ssi = tl.regr3d_scale_shift_inv_loss(tb["view1"], tb["view2"],
                                         {"pts3d": u[0]},
                                         {"pts3d_in_other_view": u[1]})
    ssi.backward()
    assert _rel(ssi.item(), float(jssi_v)) <= 1e-5
    for a, r in zip(u, jssi_g):
        assert _rel(a.grad.numpy(), r) <= 5e-5


# ------------------------------------------------------ schedule, optimizer

@pytest.mark.parametrize("accum_iter", [1, 2])
def test_lr_schedule_matches_optax(accum_iter):
    steps_per_epoch = 12 // accum_iter
    for warmup in (0, 2):
        ref = js.make_lr_schedule(1e-3, 1e-5, warmup, 5, steps_per_epoch)
        got = ts.make_lr_schedule(1e-3, 1e-5, warmup, 5, steps_per_epoch)
        for c in range(5 * steps_per_epoch + 3):
            assert abs(got(c) - float(ref(c))) <= 1e-6 * 1e-3, (warmup, c)
    assert got(0) == 0.0


@pytest.mark.parametrize("accum_iter", [1, 2])
@pytest.mark.parametrize("clip", [None, 0.5])
def test_optimizer_matches_optax_chain(accum_iter, clip):
    """TrainOptimizer against the JAX make_optimizer chain (freeze mask,
    AdamW with its ndim > 1 decay mask, clip, MultiSteps) on the same
    gradient sequence."""
    r = np.random.default_rng(8)
    params = {"dec_blocks": {"kernel": r.standard_normal((5, 4)).astype(np.float32),
                             "bias": r.standard_normal(4).astype(np.float32)},
              "enc_blocks": {"kernel": r.standard_normal((3, 3)).astype(np.float32)}}
    sched_j = js.make_lr_schedule(1e-2, 1e-4, 0, 3, 2)
    tx = js.make_optimizer(jax.tree.map(jnp.asarray, params), sched_j,
                           max_grad_norm=clip, accum_iter=accum_iter)
    jp = jax.tree.map(jnp.asarray, params)
    st = tx.init(jp)
    tw = torch.from_numpy(params["dec_blocks"]["kernel"].copy())
    tb = torch.from_numpy(params["dec_blocks"]["bias"].copy())
    opt = ts.TrainOptimizer([("dec_blocks.0.weight", tw), ("dec_blocks.0.bias", tb)],
                            ts.make_lr_schedule(1e-2, 1e-4, 0, 3, 2),
                            max_grad_norm=clip, accum_iter=accum_iter)
    for i in range(6):
        g = {"dec_blocks": {"kernel": r.standard_normal((5, 4)).astype(np.float32),
                            "bias": r.standard_normal(4).astype(np.float32)},
             "enc_blocks": {"kernel": r.standard_normal((3, 3)).astype(np.float32)}}
        upd, st = tx.update(jax.tree.map(jnp.asarray, g), st, jp)
        jp = optax.apply_updates(jp, upd)
        applied = opt.update([torch.from_numpy(g["dec_blocks"]["kernel"]),
                              torch.from_numpy(g["dec_blocks"]["bias"])])
        assert applied == ((i + 1) % accum_iter == 0)
        for t, ref in ((tw, jp["dec_blocks"]["kernel"]), (tb, jp["dec_blocks"]["bias"])):
            assert np.abs(t.numpy() - np.asarray(ref)).max() <= 1e-6 * 3, i
        np.testing.assert_array_equal(np.asarray(jp["enc_blocks"]["kernel"]),
                                      params["enc_blocks"]["kernel"])
    assert opt.count == 6 // accum_iter


def test_jax_decays_stacked_layernorm_scales():
    """A JAX deviation the port does not copy: the JAX weight-decay mask is
    ndim > 1 on the stacked layer pytree, so per-layer LayerNorm scales,
    (L, C) once stacked, are decayed; the reference decays no norm or bias,
    and the port's per-layer (C,) scale is not decayed."""
    sched = lambda count: 1e-2
    jp = {"dec_blocks": {"scale": jnp.ones((2, 4))}}
    tx = js.make_optimizer(jp, sched, weight_decay=0.05)
    upd, _ = tx.update({"dec_blocks": {"scale": jnp.zeros((2, 4))}}, tx.init(jp), jp)
    np.testing.assert_allclose(np.asarray(upd["dec_blocks"]["scale"]), -5e-4, rtol=1e-6)
    scale = torch.ones(4)
    opt = ts.TrainOptimizer([("dec_blocks.0.norm1.weight", scale)], sched,
                            weight_decay=0.05)
    opt.update([torch.zeros(4)])
    assert torch.equal(scale, torch.ones(4))


# ------------------------------------------------------------- train steps

def _weights(cfg, seed=0):
    """init_align3r's parameter tree (structure by jax.eval_shape) filled
    from a numpy seed with its distributions (dense xavier-uniform, conv
    U(+-1/sqrt(fan_in)), biases 0, LayerNorm (1, 0)); much faster on the CPU
    than the JAX initialisers op by op. Returns (JAX params, port model)."""
    r = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: init_align3r(k, JConfig(**cfg.__dict__)),
                            jax.random.PRNGKey(0))

    def fill(path, leaf):
        names = [getattr(k, "key", "") for k in path]
        shape, last, parent = leaf.shape, names[-1], names[-2]
        if last == "scale":
            return np.ones(shape, np.float32)
        if last == "bias":
            return np.zeros(shape, np.float32)
        if names[0] == "zero_convs":
            return (0.05 * r.standard_normal(shape)).astype(np.float32)
        if parent.endswith("_up"):                      # conv-transpose
            b = shape[-4] ** -0.5
        elif len(shape) - (names[0].startswith("dec_blocks")
                           or names[0] == "enc_blocks") == 4:
            b = float(np.prod(shape[-4:-1])) ** -0.5    # conv HWIO
        else:                                           # dense (in, out)
            b = np.sqrt(6.0 / (shape[-2] + shape[-1]))
        scale = 0.1 if parent == "head_conv3" else 1.0
        return (scale * r.uniform(-b, b, shape)).astype(np.float32)

    params = jax.tree.map(jnp.asarray, jax.tree_util.tree_map_with_path(fill, shapes))
    model = Align3R(cfg)
    model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params), cfg),
                          strict=True)
    return params, model


def _torch_params_as_jax(model, cfg):
    from align3r_tpu.models.convert import convert_state_dict
    return convert_state_dict({k: v.detach().float().numpy()
                               for k, v in model.state_dict().items()},
                              JConfig(**cfg.__dict__))


def _run_both(cfg, hw, n_steps, attn_impl, lr=1e-4):
    params, model = _weights(cfg)
    frozen0 = {k: v.detach().clone() for k, v in model.state_dict().items()
               if not ts.is_trainable(k)}
    batch = make_batch(hw, seed=3)
    sched = js.make_lr_schedule(lr, lr / 100, 0, 10, 10)
    tx = js.make_optimizer(params, sched, weight_decay=0.0)
    jstate = js.create_train_state(params, tx)
    jstep = jax.jit(js.make_train_step(tx, JConfig(**cfg.__dict__), dtype=jnp.float32,
                                       remat=False, attn_impl=attn_impl))
    opt = ts.make_optimizer(model, ts.make_lr_schedule(lr, lr / 100, 0, 10, 10),
                            weight_decay=0.0)
    tstep = ts.make_train_step(model, opt, dtype=torch.float32, remat="full",
                               attn_impl=attn_impl)
    jb, tb = to_jax(batch), to_torch(batch)
    for i in range(n_steps):
        jstate, jm = jstep(jstate, jb)
        tm = tstep(tb)
        for k in jm:
            assert _rel(tm[k].item(), float(jm[k])) <= 1e-4, (i, k)
    got = _torch_params_as_jax(model, cfg)
    jname = lambda k: {"downstream_head1": "head1", "downstream_head2": "head2"}.get(k, k)
    leaves = [(k, np.asarray(a), np.asarray(b), np.asarray(c))
              for k in ts.TRAINABLE_KEYS
              for a, b, c in zip(jax.tree.leaves(got[jname(k)]),
                                 jax.tree.leaves(jstate.params[jname(k)]),
                                 jax.tree.leaves(params[jname(k)]))]
    U = max(np.abs(b - c).max() for _, _, b, c in leaves)     # largest update
    d = np.concatenate([np.abs(a - b).ravel() for _, a, b, _ in leaves])
    assert U > 0 and d.max() <= 2 * U and (d > 1e-3 * U).mean() <= 1e-4
    for k, v in model.state_dict().items():
        if not ts.is_trainable(k):
            assert torch.equal(v, frozen0[k]), k
    return model


def test_three_train_steps_match_jax():
    cfg = Align3RConfig(img_size=(32, 32), **KW)
    _run_both(cfg, (32, 32), 3, "auto")


def test_train_step_through_k6_route_matches_jax():
    """attn_impl="small" on both sides at 64 x 64 images (16 tokens, a
    multiple of 16): the JAX step runs the Pallas kernel in interpret mode,
    the port K6's plain version; the backward is the twin's on both. Two
    steps, since the first applied update has learning rate 0."""
    cfg = Align3RConfig(img_size=(64, 64), **KW)
    before = tsa.small_attention.launches
    _run_both(cfg, (64, 64), 2, "small")
    assert tsa.small_attention.launches == before       # CPU: plain version


def test_remat_modes_give_identical_gradients():
    cfg = Align3RConfig(img_size=(32, 32), **KW)
    _, model = _weights(cfg)
    ts.freeze_params(model)
    batch = to_torch(make_batch((32, 32), seed=4))
    trainable = [p for p in model.parameters() if p.requires_grad]
    grads = {}
    for remat in ("none", "full", "dots"):
        loss, _ = ts.loss_fn(model, batch, dtype=torch.float32, remat=remat)
        grads[remat] = torch.autograd.grad(loss, trainable, allow_unused=True)
    for remat in ("full", "dots"):
        for a, b in zip(grads[remat], grads["none"]):
            assert (a is None and b is None) or torch.equal(a, b), remat
    # refinenet4 has no skip input, so its first residual unit (two convs,
    # weight and bias each, in each head) is unused
    assert sum(g is None for g in grads["none"]) == 8
    with pytest.raises(ValueError):
        ts.loss_fn(model, batch, dtype=torch.float32, remat="bogus")


def test_cast_frozen_and_freeze():
    cfg = Align3RConfig(img_size=(32, 32), **KW)
    _, model = _weights(cfg)
    ts.cast_frozen_kernels(model)
    opt = ts.make_optimizer(model, ts.make_lr_schedule(1e-4, 1e-6, 0, 2, 2))
    for name, p in model.named_parameters():
        train = ts.is_trainable(name)
        assert p.requires_grad == train, name
        kernel = name.endswith("weight") and p.ndim > 1
        assert p.dtype == (torch.float32 if train or not kernel else torch.bfloat16), name
    assert {id(p) for p in opt.params} == {id(p) for n, p in model.named_parameters()
                                           if ts.is_trainable(n)}
