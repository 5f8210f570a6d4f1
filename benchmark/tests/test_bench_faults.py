"""The check fails where it should, at the test size on the CPU: the
control (the reference one precision step below the configuration's) and
a run whose timed path is broken underneath each come out not correct,
while the unbroken run comes out correct.

The limits here are the test size's own, set like the cells' (PERF.md)
from readings of this size: the program's plain CPU path reads 0 on the
priors and the initialisation (it computes what the reference does),
1.4-3.4 on the engine's points over the stated precision's gap and
1.8e-4-3.3e-4 on its confidences (bf16 against float32), 1e-7-4e-7 on the
solve's descent and 3.2e-4 on its last loss at the state it returns (at 20
steps the last step still moves the state); the control reads
1.5e-5-3.4e-4, 20-37, 2e-3-3.6e-3, 2e-4 / 1.4e-5-5.2e-5 / 4e-5-8.9e-3 on
the initialisation, 6e-8-3.3e-7 and 3.9e-4. The descent is held to faults of the solve (its
state unchanged, a learning rate 0.9 times the stated one: 4.5e-2 by step
10), which a precision step does not reach (PERF.md). The cells have no
chip exchange, so that fault has no case here.
"""
import time

import pytest
import torch

from benchmark.harness import cell, checks, control
from benchmark.tests import tiny

LIMITS = {"prior_inv_depth": 5e-6, "prior_depth": 5e-6, "prior_focal": 1e-6, "engine_xyz_vs_stated": 8.0,
          "engine_conf": 1.2e-3, "init_depth": 5e-5, "init_pairwise": 5e-6, "init_focal": 2e-5,
          "solve_curve": 2e-6, "solve_loss_at_state": 1e-3}
CELLS = ["depth24.depthpro", "netpass24.dav2"]
SEED = 2 ** 32 + 77


def _run(name):
    torch.manual_seed(0)
    return cell.run_cell(name, SEED, 0.5, False, time.perf_counter(), device="cpu",
                         defs=tiny.tiny_cell(name, LIMITS))


def _halve(real):
    def decode_heads(*a, **k):
        out = real(*a, **k)
        for res in out:
            for v in res.values():
                h = v.shape[0] // 2
                if h:
                    v[h:] = v[:h].mean(0)
        return out
    return decode_heads


def _scale_points(real):
    def decode_heads(*a, **k):
        out = real(*a, **k)
        for res in out:
            res["pts3d"].mul_(1.25)
        return out
    return decode_heads


def _scale_prior(real):
    def forward(self, x):
        out = real(self, x)
        return (out[0] * 1.01, out[1]) if isinstance(out, tuple) else out * 1.01
    return forward


def _unchanged(params, masks, data, lrs, cfg, loss_fn, step0=0, opt_state=None):
    loss = loss_fn(params, data, cfg, step0).detach()
    return params, torch.stack([loss] * len(lrs)), opt_state


def _slower(real):
    def global_alignment_loop(*a, **k):
        return real(*a, **dict(k, lr=k["lr"] * 0.9))
    return global_alignment_loop


def _fault(monkeypatch, kind):
    from align3r_tpu_torch import pipeline
    from align3r_tpu_torch.alignment import scene
    from align3r_tpu_torch.inference import engine
    from align3r_tpu_torch.models import depth_anything, depth_pro
    if kind == "state_unchanged":
        monkeypatch.setattr(scene, "solve", _unchanged)
    elif kind == "solve_lr":
        monkeypatch.setattr(pipeline, "global_alignment_loop",
                            _slower(pipeline.global_alignment_loop))
    elif kind == "half_batch":
        monkeypatch.setattr(engine, "decode_heads", _halve(engine.decode_heads))
    elif kind == "engine_answer":
        monkeypatch.setattr(engine, "decode_heads", _scale_points(engine.decode_heads))
    elif kind == "prior_answer":
        for cls in (depth_pro.DepthPro, depth_anything.DepthAnything):
            monkeypatch.setattr(cls, "forward", _scale_prior(cls.forward))


@pytest.mark.parametrize("name", CELLS)
def test_unbroken_run_is_correct(name):
    res = _run(name)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0


@pytest.mark.parametrize("name,kind", [(c, k) for c in CELLS for k in
                                       ("half_batch", "engine_answer", "prior_answer")]
                         + [("depth24.depthpro", k) for k in ("state_unchanged", "solve_lr")])
def test_broken_run_is_not_correct(monkeypatch, name, kind):
    _fault(monkeypatch, kind)
    res = _run(name)
    assert not res["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    rec = control.readings(name, SEED, "cpu", True, defs=tiny.tiny_cell(name, LIMITS))
    assert checks.verdict(rec["program"], LIMITS)[0], rec["program"]
    assert not checks.verdict(rec["control"], LIMITS)[0], rec["control"]
