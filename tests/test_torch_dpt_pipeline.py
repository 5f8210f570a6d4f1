"""Port parity: K7 and K8 (align3r_tpu_torch.ops.dpt_pipeline), the
``conv_impl="pipeline"`` DPT head and the engine's ``head_conv_impl``,
against align3r_tpu.

Oracles: the XLA twin ``_xla_twin``, the Pallas kernels in interpret mode at
one small shape each (K7 at several strips, K8 at two strips), jax.grad
through the custom VJP of ``fused_res_unit``, the JAX pipeline head and the
JAX XLA head, and the JAX engine with pipeline heads. Tolerances, each with
its reason:
- fp32: 1e-5 of the largest value (the same math, sums in another order);
  1e-4 of the largest gradient for K7's gradient (a backward through two
  convolutions, summed in another order);
- bf16 K8: 2 bf16 ulps of the largest value (1.6e-2 x max): both sides round
  h1, the column mix and the row mix to bf16 at the same points after fp32
  sums in another order, and one flipped rounding moves an output by an ulp
  of its inputs;
- the port's pipeline head against the JAX XLA head in fp32 at 128 x 256,
  where every level takes K7 and K8: atol 1e-4, rtol 1e-3, the JAX engine
  test's tolerance for its pipeline head against its XLA head
  (tests/test_inference.py:234-259): bias before or after the rounding and
  rows or columns first only move fp32 sums;
- the engine with pipeline heads: the same atol 1e-4, rtol 1e-3.
On the CPU every wrapper takes its plain version and counts no launch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from align3r_tpu.inference.engine import inference as jinference
from align3r_tpu.models import nn as jnn
from align3r_tpu.models.config import TINY_TEST
from align3r_tpu.models.dpt_head import apply_dpt_head as japply_head
from align3r_tpu.ops import dpt_pipeline as jdp
from align3r_tpu_torch.inference.engine import inference as tinference
from align3r_tpu_torch.models import nn as tnn
from align3r_tpu_torch.models.align3r import Align3R
from align3r_tpu_torch.models.convert import state_dict_from_jax
from align3r_tpu_torch.models.dpt_head import apply_dpt_head as tapply_head
from align3r_tpu_torch.ops import dpt_pipeline as tdp
from test_torch_engine import _numpy_init

torch.set_num_threads(2)
CFG = TINY_TEST


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def _conv(r, cin, cout, k=3, scale=1.0):
    """A JAX conv {'kernel' HWIO, 'bias'} and the port's (weight, bias)."""
    kern = (scale * r.uniform(-1, 1, (k, k, cin, cout)) / np.sqrt(k * k * cin)).astype(np.float32)
    bias = (0.1 * r.standard_normal(cout)).astype(np.float32)
    return ({"kernel": jnp.asarray(kern), "bias": jnp.asarray(bias)},
            (torch.from_numpy(kern.transpose(3, 2, 0, 1).copy()), torch.from_numpy(bias)))


def _unit(r, c):
    (j1, t1), (j2, t2) = _conv(r, c, c), _conv(r, c, c)
    return {"conv1": j1, "conv2": j2}, (t1, t2)


def _launches():
    return tdp.fused_res_unit.launches, tdp.fused_head_final.launches


def test_interp_matrix_matches_jax():
    for n_in, n_out in ((9, 18), (16, 32), (144, 288), (256, 512), (5, 7), (1, 2)):
        for ac in (True, False):
            np.testing.assert_array_equal(tnn._interp_matrix(n_in, n_out, ac),
                                          jnn._interp_matrix(n_in, n_out, ac))


def test_gates_match_jax():
    for shape in ((2, 9, 16, 256), (2, 1, 2, 256), (2, 4, 6, 256), (1, 8, 12, 256),
                  (1, 16, 24, 256), (1, 12, 24, 256), (1, 144, 256, 256), (1, 8, 16, 96)):
        x = jax.ShapeDtypeStruct(shape, jnp.bfloat16)
        t = torch.empty(shape, dtype=torch.bfloat16, device="meta")
        assert tdp.supported(t) == jdp.supported(x), shape
        for th in (8, 16):
            assert tdp.head_trio_supported(t, th) == jdp.head_trio_supported(x, th), shape


@pytest.mark.parametrize("with_base", [False, True])
def test_res_unit_plain_matches_xla_twin(with_base):
    r = np.random.default_rng(0)
    junit, tunit = _unit(r, 128)
    v = r.standard_normal((2, 6, 10, 128)).astype(np.float32)
    base = r.standard_normal(v.shape).astype(np.float32) if with_base else None
    w, b = jdp._unit_weights(junit, jnp.float32)
    ref = jdp._xla_twin(jnp.asarray(v), jnp.asarray(base if with_base else v), w, b,
                        not with_base)
    before = _launches()
    got = tdp.fused_res_unit(torch.from_numpy(v), tunit,
                             None if base is None else torch.from_numpy(base))
    assert _launches() == before
    assert _rel(got.numpy(), ref) <= 1e-5


def test_res_unit_plain_matches_pallas_interpret_strips():
    """(1, 24, 16, 128) with 4-row strips: six strips, their halos and the
    SAME padding at the image's top and bottom."""
    r = np.random.default_rng(1)
    junit, tunit = _unit(r, 128)
    v = r.standard_normal((1, 24, 16, 128)).astype(np.float32)
    base = r.standard_normal(v.shape).astype(np.float32)
    for jb, tb in ((None, None), (jnp.asarray(base), torch.from_numpy(base))):
        ref = jdp.fused_res_unit(jnp.asarray(v), junit, base=jb, interpret=True, th=4)
        got = tdp.fused_res_unit(torch.from_numpy(v), tunit, tb)
        assert _rel(got.numpy(), ref) <= 1e-5


def test_res_unit_gradient_matches_jax():
    r = np.random.default_rng(2)
    junit, tunit = _unit(r, 128)
    v = r.standard_normal((1, 8, 8, 128)).astype(np.float32)
    base = r.standard_normal(v.shape).astype(np.float32)
    g = r.standard_normal(v.shape).astype(np.float32)

    def jloss(v, base, unit):
        return jnp.sum(jdp.fused_res_unit(v, unit, base=base, interpret=True) * g)

    refs = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(v), jnp.asarray(base), junit)
    tv, tb = (torch.from_numpy(a).requires_grad_(True) for a in (v, base))
    leaves = [t.requires_grad_(True) for pair in tunit for t in pair]
    out = tdp.fused_res_unit(tv, tunit, tb)
    grads = torch.autograd.grad(out, [tv, tb, *leaves], torch.from_numpy(g))
    jw = [refs[2][c][k] for c in ("conv1", "conv2") for k in ("kernel", "bias")]
    ref_grads = [refs[0], refs[1]] + [np.asarray(jw[0]).transpose(3, 2, 0, 1), jw[1],
                                      np.asarray(jw[2]).transpose(3, 2, 0, 1), jw[3]]
    for got, ref in zip(grads, ref_grads):
        assert _rel(got.numpy(), ref) <= 1e-4


def _trio(r, c1, c2=128, cout=4):
    (j1, t1), (j2, t2) = _conv(r, c1, c2), _conv(r, c2, c2)
    j3, t3 = _conv(r, c2, cout, k=1)
    return (j1, j2, j3), (t1, t2, t3)


@pytest.mark.parametrize("shape, dtype, th, tol", [
    ((1, 8, 16, 128), "fp32", 8, 1e-5), ((1, 16, 16, 256), "bf16", 16, 1.6e-2)])
def test_head_final_plain_matches_pallas_interpret(shape, dtype, th, tol):
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    r = np.random.default_rng(3)
    jp, tp = _trio(r, shape[-1])
    x = r.standard_normal(shape).astype(np.float32)
    ref = jdp.fused_head_final(jnp.asarray(x, jdt), *jp, TH=th, interpret=True)
    before = _launches()
    got = tdp.fused_head_final(torch.from_numpy(x).to(tdt), *tp)
    assert _launches() == before and got.dtype == torch.float32
    assert got.shape == (shape[0], 2 * shape[1], 2 * shape[2], 4)
    assert _rel(got.numpy(), ref) <= tol


@pytest.fixture(scope="module")
def weights():
    """TINY_TEST weights with non-zero head biases (the zero-init biases would
    hide where each side adds them)."""
    params = jax.tree.map(jnp.asarray, _numpy_init())
    r = np.random.default_rng(4)

    def bias(path, leaf):
        names = [getattr(k, "key", "") for k in path]
        if names[0] in ("head1", "head2") and names[-1] == "bias":
            return jnp.asarray(0.05 * r.standard_normal(leaf.shape), jnp.float32)
        return leaf

    params = jax.tree_util.tree_map_with_path(bias, params)
    for h in ("head1", "head2"):
        params[h]["head_conv3"]["kernel"] = params[h]["head_conv3"]["kernel"] * 0.1
    model = Align3R(CFG)
    model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params), CFG),
                          strict=True)
    return params, model


def _head_inputs(seed, H, W):
    r = np.random.default_rng(seed)
    gh, gw = H // 16, W // 16
    return (gh, gw), [r.standard_normal((1, gh * gw, d)).astype(np.float32)
                      for d in CFG.dpt_dim_tokens()]


def test_pipeline_head_matches_jax_pipeline_head(weights):
    """32 x 48: K7 runs at refinenet1 only (the gates send the three coarser
    levels to the XLA path, in both packages) and K8 at the tail."""
    params, model = weights
    pm = model.prepare(torch.float32, torch.float32, device="cpu")
    (gh, gw), hooks = _head_inputs(5, 32, 48)
    ref = japply_head(params["head1"], [jnp.asarray(h) for h in hooks], (gh, gw), (32, 48),
                      CFG.depth_mode, CFG.conf_mode, conv_impl="pipeline")
    got = tapply_head(pm.head1, [torch.from_numpy(h) for h in hooks], (gh, gw), (32, 48),
                      CFG.depth_mode, CFG.conf_mode, conv_impl="pipeline")
    for k in ("pts3d", "conf"):
        assert _rel(got[k].numpy(), ref[k]) <= 1e-5, k


def test_pipeline_head_matches_jax_xla_head_at_every_level(weights, monkeypatch):
    params, model = weights
    pm = model.prepare(torch.float32, torch.float32, device="cpu")
    (gh, gw), hooks = _head_inputs(6, 128, 256)
    ref = jax.jit(lambda hk: japply_head(params["head2"], hk, (gh, gw), (128, 256),
                                         CFG.depth_mode, CFG.conf_mode))(
        [jnp.asarray(h) for h in hooks])
    calls = []
    for name, tag in (("res_unit_plain", "K7"), ("head_final_plain", "K8")):
        fn = getattr(tdp, name)
        monkeypatch.setattr(tdp, name, lambda *a, fn=fn, tag=tag: calls.append(tag) or fn(*a))
    got = tapply_head(pm.head2, [torch.from_numpy(h) for h in hooks], (gh, gw),
                      (128, 256), CFG.depth_mode, CFG.conf_mode, conv_impl="pipeline")
    assert calls == ["K7"] * 7 + ["K8"]          # every refinenet level, then the tail
    for k in ("pts3d", "conf"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=1e-4, rtol=1e-3)


def test_engine_pipeline_heads_match_jax(weights):
    """The port's inference(head_conv_impl="pipeline") against the JAX
    engine's at the JAX pipeline-head test's setup (3 frames at 32 x 48,
    pairs (0, 1), (1, 2), fp32)."""
    params, model = weights
    r = np.random.default_rng(7)
    imgs = (0.3 * r.standard_normal((3, 32, 48, 3))).astype(np.float32)
    priors = r.uniform(0, 1, (3, 32, 48, 3)).astype(np.float32)
    pairs = [(0, 1), (1, 2)]
    ref = jinference(pairs, params, CFG, jnp.asarray(imgs), jnp.asarray(priors), batch_size=2,
                     dtype=jnp.float32, head_dtype=jnp.float32, head_conv_impl="pipeline")
    before = _launches()
    got = tinference(pairs, model.prepare(torch.float32, torch.float32, device="cpu"), imgs,
                     priors, batch_size=2, head_conv_impl="pipeline")
    assert _launches() == before
    for k, v in (("pred1", "pts3d"), ("pred1", "conf"),
                 ("pred2", "pts3d_in_other_view"), ("pred2", "conf")):
        np.testing.assert_allclose(got[k][v].numpy(), np.asarray(ref[k][v]),
                                   atol=1e-4, rtol=1e-3, err_msg=f"{k}.{v}")


def test_cuda_wrappers_refuse_cpu_tensors():
    x = torch.zeros(1, 8, 16, 128)
    w = torch.zeros(2, 9, 128, 128)
    with pytest.raises(ValueError, match="CUDA"):
        tdp._res_unit_cuda(x, None, w, torch.zeros(2, 128))
    with pytest.raises(ValueError, match="CUDA"):
        tdp._head_final_cuda(x, w[0], torch.zeros(128), w[0], torch.zeros(128),
                             torch.zeros(128, 4), torch.zeros(4))
