"""Port parity: data-parallel training and serving (align3r_tpu_torch.parallel,
the train step and train() over several ranks, the data-parallel engine,
tools.dist_smoke) against one process and against the JAX package.

Two ranks run as two CPU processes over gloo (tests/torch_parallel_worker.py,
launched once for the module). Tolerances:
- the train step under DDP and under ZeRO-1 against the one-process step on
  the same global batch, fp32: losses and grad norms 1e-4 relative (JAX's
  test_train_step_sharded_8dev), parameters as tests/test_torch_training.py
  holds them to JAX (within 2U of the largest update U, all but 1e-4 of
  them within 1e-3 U: Adam divides each element by its own gradient, so
  other summation orders can flip a near-zero element's step); DDP and
  ZeRO-1 against each other bit for bit (the same sums, the same
  element-wise Adam on slices);
- the same step against JAX's n_data=2 step (a 2-device CPU mesh): 1e-4;
- the ZeRO-1 optimizer's gathered state_dict against the one-process
  optimizer's: each moment within 1e-4 of that leaf's largest (the same
  gradients, summed in another order);
- train() with ZeRO-1 and asynchronous or pickle checkpoints, resumed,
  against one process: the micro-steps before the first applied update 1e-4 relative;
  each epoch's mean loss 1e-2 relative, since train()
  computes in bf16, and parameters one fp32 ulp apart (the ranks' partial
  sums) round some bf16 activations the other way;
- the data-parallel engine against one rank: 1e-5 relative to the largest
  value (fp32; other batch sizes may sum in another order).
"""
import json
import os
import shutil
import socket
import subprocess
import sys
import warnings
from concurrent.futures import Future

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as W
from align3r_tpu.inference.pairs import make_pairs
from align3r_tpu.models.config import Align3RConfig as JConfig
from align3r_tpu.parallel.mesh import data_sharding, make_mesh, replicated, zero1_opt_shardings
from align3r_tpu.training import step as js
from align3r_tpu_torch.inference.engine import inference
from align3r_tpu_torch.models.align3r import Align3R, init_align3r_
from align3r_tpu_torch.models.config import TINY_TEST, VIT_L_512
from align3r_tpu_torch.parallel import mesh as tm
from align3r_tpu_torch.training import step as ts
from align3r_tpu_torch.training import train as tt
from test_torch_training import _torch_params_as_jax, _weights, make_batch, to_jax

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(argv, n=2, timeout=300, extra_env=None):
    """n processes of `argv` over a tcp:// rendezvous on localhost (gloo, no
    card); returns their outputs, failing on a non-zero exit."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS",)}
    env.update(ALIGN3R_COORDINATOR=f"localhost:{port}", ALIGN3R_NUM_PROCESSES=str(n),
               CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=REPO, **(extra_env or {}))
    procs = [subprocess.Popen(argv, env=dict(env, ALIGN3R_PROCESS_ID=str(r)), cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    return outs


# ------------------------------------------------------- one-process checks

def test_maybe_init_distributed_reads_the_variables(monkeypatch):
    calls = []
    monkeypatch.setattr(tm.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(tm.dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    for k in ("ALIGN3R_COORDINATOR", "ALIGN3R_DIST", "RANK", "WORLD_SIZE",
              "LOCAL_WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert tm.maybe_init_distributed() is False and calls == []
    monkeypatch.setenv("ALIGN3R_COORDINATOR", "localhost:1234")
    monkeypatch.setenv("ALIGN3R_NUM_PROCESSES", "4")
    monkeypatch.setenv("ALIGN3R_PROCESS_ID", "3")
    monkeypatch.setattr(tm.torch.cuda, "is_available", lambda: False)
    assert tm.maybe_init_distributed() is True
    assert calls[-1] == ("gloo", dict(init_method="tcp://localhost:1234", world_size=4,
                                      rank=3))
    # with CUDA: gloo while this host's ranks outnumber its cards, else NCCL
    devices = []
    monkeypatch.setattr(tm.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tm.torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(tm.torch.cuda, "set_device", devices.append)
    assert tm.maybe_init_distributed() is True and calls[-1][0] == "gloo"
    monkeypatch.setenv("ALIGN3R_NUM_PROCESSES", "2")
    monkeypatch.setenv("ALIGN3R_PROCESS_ID", "1")
    assert tm.maybe_init_distributed() is True and calls[-1][0] == "nccl"
    monkeypatch.setenv("ALIGN3R_COORDINATOR", "node0:1234")     # one rank on this host
    monkeypatch.setenv("ALIGN3R_NUM_PROCESSES", "4")
    assert tm.maybe_init_distributed() is True and calls[-1][0] == "nccl"
    monkeypatch.delenv("ALIGN3R_COORDINATOR")
    monkeypatch.setenv("ALIGN3R_DIST", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert tm.maybe_init_distributed() is True
    assert calls[-1] == ("gloo", dict(init_method="env://"))
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert tm.maybe_init_distributed() is True
    assert calls[-1] == ("nccl", dict(init_method="env://"))
    assert devices == [0, 0, 1]          # rank() is 0: the group is mocked
    # no group: one process
    assert tm.world_size() == 1 and tm.rank() == 0
    assert tm.process_slice(range(5)) == [0, 1, 2, 3, 4]
    assert tm.process_slice(range(5), 2, 1) == [1, 3]


@pytest.mark.parametrize("n", [2, 8])
def test_zero1_shard_dims_match_jax(n):
    """Every trainable leaf of VIT_L_512 (the moments and the accumulation
    buffer share their shapes) and a few made-up shapes: the port's choice of
    dim against JAX zero1_opt_shardings' spec on an n-device mesh."""
    shapes = [tuple(p.shape) for name, p in Align3R(VIT_L_512).to("meta").named_parameters()
              if ts.is_trainable(name)]
    shapes += [(7, 96, 512), (3, 5), (2 ** 16 + 1,), (1024, 1024, 3)]
    mesh = make_mesh(n_data=n)
    specs = zero1_opt_shardings([jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes], mesh)
    want = [next((d for d, a in enumerate(sp.spec) if a == "data"), None) for sp in specs]
    got = tm.zero1_shard_dims(shapes, n)
    assert got == want
    assert any(d is not None for d in got) and any(d is None for d in got)


def test_async_meta_waits_for_the_commit(tmp_path):
    """meta.json appears only once the asynchronous payload has committed
    (dcp.tmp/ becomes dcp/); a failed save gets no meta.json (as the JAX
    package's pending-meta test)."""
    p = str(tmp_path / "ck")
    os.makedirs(os.path.join(p, "dcp.tmp"))
    fut = Future()
    tt._PENDING_META[p] = (fut, {"step": 1, "epoch": 0, "best_so_far": None})
    tt._promote_pending_meta()
    assert p in tt._PENDING_META and not os.path.exists(os.path.join(p, "meta.json"))
    fut.set_result(None)
    tt._promote_pending_meta()
    assert p not in tt._PENDING_META
    assert json.load(open(os.path.join(p, "meta.json")))["epoch"] == 0
    assert os.path.isdir(os.path.join(p, "dcp")) and not os.path.exists(
        os.path.join(p, "dcp.tmp"))
    p2 = str(tmp_path / "ck2")
    bad = Future()
    bad.set_exception(OSError("disk full"))
    tt._PENDING_META[p2] = (bad, {"step": 2, "epoch": 1, "best_so_far": None})
    with pytest.warns(UserWarning, match="failed"):
        tt._promote_pending_meta(assume_finished=True)
    assert p2 not in tt._PENDING_META and not os.path.exists(os.path.join(p2, "meta.json"))


def test_async_checkpoint_round_trip_in_one_process(tmp_path):
    """ckpt_backend="orbax" in one process: an interrupted run leaves dcp/
    and meta.json, and resumed from them it ends where the uninterrupted run
    does, bit for bit (the CPU being deterministic)."""
    try:
        _round_trip(tmp_path)
    finally:                       # the checkpoints take about 1.5 GB
        shutil.rmtree(tmp_path, ignore_errors=True)


def _round_trip(tmp_path):
    straight = tt.train(W.train_args(tmp_path / "a", epochs=3, batch_size=2))
    with pytest.raises(W.Interrupted):
        tt.train(W.train_args(tmp_path / "b", epochs=3, batch_size=2, ckpt_backend="orbax",
                               train_dataset=W.Pairs(8, fail_at=2)))
    resumed = tt.train(W.train_args(tmp_path / "b", epochs=3, batch_size=2,
                                     ckpt_backend="orbax"))
    last = tmp_path / "b" / "checkpoint-last"
    assert (last / "meta.json").exists() and (last / "dcp" / ".metadata").exists()
    assert json.load(open(last / "meta.json"))["epoch"] == 2
    assert [r["epoch"] for r in resumed.log] == [2]
    a, b = straight.model.state_dict(), resumed.model.state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert resumed.optimizer.count == straight.optimizer.count


# ------------------------------------------------------ two-process checks

@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ranks"))
    r = np.random.default_rng(7)
    n = 6
    pairs = np.array(make_pairs(n, "swinstride-2-noncyclic", symmetrize=True), np.int32)
    np.savez(os.path.join(d, "engine.npz"), pairs=pairs,
             imgs=r.uniform(-1, 1, (n, 48, 64, 3)).astype(np.float32),
             priors=r.uniform(0, 1, (n, 48, 64, 3)).astype(np.float32))
    params, model = _weights(W.STEP_CFG)
    torch.save(model.state_dict(), os.path.join(d, "weights.pth"))
    batch = make_batch((32, 32), B=4, seed=5)
    np.savez(os.path.join(d, "batch.npz"), **{f"{vn}/{k}": v for vn, bv in batch.items()
                                              for k, v in bv.items()})
    _launch([sys.executable, os.path.join(REPO, "tests", "torch_parallel_worker.py"), d])
    yield d, params, batch
    shutil.rmtree(d, ignore_errors=True)          # the checkpoints take about 1 GB


def test_dp_engine_matches_one_rank(two_ranks):
    _assert_engine_matches_one_process(two_ranks[0], "engine_out.npz")


def test_engine_without_group_gathers_nothing_while_a_group_is_up(two_ranks):
    """inference() with no group, on a rank of a live two-rank group: this
    rank's whole result, nothing summed over the ranks."""
    _assert_engine_matches_one_process(two_ranks[0], "engine_alone.npz")


def _assert_engine_matches_one_process(d, name):
    e = np.load(os.path.join(d, "engine.npz"))
    got = np.load(os.path.join(d, name))
    pm = init_align3r_(Align3R(TINY_TEST), seed=0).prepare(torch.float32, torch.float32,
                                                           device="cpu")
    ref = inference([tuple(p) for p in e["pairs"]], pm, e["imgs"], e["priors"],
                    batch_size=4, encode_chunk=2)
    for k in ("pred1", "pred2"):
        for v, t in ref[k].items():
            a, b = got[f"{k}/{v}"], t.numpy()
            assert a.shape == b.shape
            assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), (k, v)

def test_dp_engine_refuses_a_batch_the_group_does_not_divide(monkeypatch):
    pm = init_align3r_(Align3R(TINY_TEST), seed=0).prepare(torch.float32, torch.float32,
                                                           device="cpu")
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda g: 2)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda g: 0)
    imgs = np.zeros((2, 32, 32, 3), np.float32)
    for kw in (dict(batch_size=3), dict(encode_chunk=5)):
        with pytest.raises(ValueError, match="multiples of the group size 2"):
            inference([(0, 1)], pm, imgs, imgs, group=object(), **kw)


def _step_model(d, params=None):
    """The step test's network from weights.pth, then `params` (trainable,
    by name) over it."""
    model = Align3R(W.STEP_CFG)
    model.load_state_dict(torch.load(os.path.join(d, "weights.pth")), strict=True)
    if params is not None:
        with torch.no_grad():
            for n, p in model.named_parameters():
                if n in params:
                    p.copy_(params[n])
    return model


def _assert_params_close(got, ref, init):
    """Within 2U of the largest update U, all but 1e-4 of the elements within
    1e-3 U (the module docstring)."""
    U = max(np.abs(ref[k] - init[k]).max() for k in ref)
    d = np.concatenate([np.abs(got[k] - ref[k]).ravel() for k in ref])
    assert U > 0 and d.max() <= 2 * U and (d > 1e-3 * U).mean() <= 1e-4


@pytest.mark.parametrize("zero1", [False, True])
def test_train_step_over_two_ranks_matches_one_process(two_ranks, zero1):
    d, params, batch = two_ranks
    got = torch.load(os.path.join(d, f"step_zero1_{int(zero1)}.pth"))
    ms, opt = W.run_steps(_step_model(d), batch, zero1=False)
    for a, b in zip(got["metrics"], ms):
        for k in ("loss", "grad_norm", "conf_loss_1", "Regr3D_pts3d_2"):
            assert abs(a[k] - b[k]) <= 1e-4 * abs(b[k]), k
    init = torch.load(os.path.join(d, "weights.pth"))
    ref = {n: p.detach().numpy() for n, p in zip(opt.names, opt.params)}
    _assert_params_close({n: got["params"][n].numpy() for n in ref}, ref,
                         {n: init[n].numpy() for n in ref})
    if zero1:
        # the big leaves were split: this rank kept half of each
        assert got["split"], "no leaf was split"
        for n in got["split"]:
            full, half = ref[n].shape, got["shard_shapes"][n]
            assert np.prod(half) * 2 == np.prod(full)
        ddp = torch.load(os.path.join(d, "step_zero1_0.pth"))
        for n in ref:
            assert torch.equal(got["params"][n], ddp["params"][n]), n
        assert got["metrics"] == ddp["metrics"]


def test_train_step_over_two_ranks_matches_jax_n_data_2(two_ranks):
    """The same four micro-steps on JAX's 2-device data mesh."""
    d, params, batch = two_ranks
    got = torch.load(os.path.join(d, "step_zero1_0.pth"))
    mesh = make_mesh(n_data=2)
    sched = js.make_lr_schedule(W.LR, W.LR / 100, 0, 10, 10)
    tx = js.make_optimizer(params, sched, weight_decay=0.0, accum_iter=W.ACCUM)
    state = jax.device_put(js.create_train_state(params, tx), replicated(mesh))
    jb = jax.tree.map(lambda x: jax.device_put(x, data_sharding(mesh)), to_jax(batch))
    step = jax.jit(js.make_train_step(tx, JConfig(**W.STEP_CFG.__dict__), dtype=jnp.float32,
                                      remat=False),
                   in_shardings=(replicated(mesh), data_sharding(mesh)),
                   out_shardings=(replicated(mesh), replicated(mesh)))
    for i in range(W.MICRO_STEPS):
        state, jm = step(state, jb)
        for k in ("loss", "grad_norm"):
            assert abs(got["metrics"][i][k] - float(jm[k])) <= 1e-4 * abs(float(jm[k])), (i, k)
    mine = _torch_params_as_jax(_step_model(d, got["params"]), W.STEP_CFG)
    jname = lambda k: {"downstream_head1": "head1", "downstream_head2": "head2"}.get(k, k)
    leaves = [(np.asarray(a), np.asarray(b), np.asarray(c)) for k in ts.TRAINABLE_KEYS
              for a, b, c in zip(jax.tree.leaves(mine[jname(k)]),
                                 jax.tree.leaves(state.params[jname(k)]),
                                 jax.tree.leaves(params[jname(k)]))]
    _assert_params_close(*({i: t[j] for i, t in enumerate(leaves)} for j in range(3)))


def test_zero1_optimizer_state_dict_matches_one_process(two_ranks):
    """The ZeRO-1 optimizer's state_dict, gathered over the two ranks (and
    loaded back into the slices bit for bit, in the worker), against the
    one-process optimizer's after the same micro-steps: AdamW numbers its
    state in param-group order, so each index must hold the same leaf."""
    d, _, batch = two_ranks
    got = torch.load(os.path.join(d, "zero1_state_dict.pth"))
    _, opt = W.run_steps(_step_model(d), batch, zero1=False)
    ref = opt.state_dict()
    assert got["count"] == ref["count"] and got["mini_step"] == ref["mini_step"]
    assert got["adamw"]["param_groups"] == ref["adamw"]["param_groups"]
    assert got["adamw"]["state"].keys() == ref["adamw"]["state"].keys()
    for j, st in ref["adamw"]["state"].items():
        for k, v in st.items():
            a = got["adamw"]["state"][j][k]
            assert a.shape == v.shape, (j, k)
            assert (a - v).abs().max() <= 1e-4 * v.abs().max(), (j, k)


@pytest.fixture(scope="module")
def one_process_run(tmp_path_factory):
    """train() for 2 epochs, then resumed to 3, in one process (pickle
    checkpoints): (epoch logs, the first call's micro-step history)."""
    out = tmp_path_factory.mktemp("one")
    first = tt.train(W.train_args(out))
    ref = first.log + tt.train(W.train_args(out, epochs=3)).log
    shutil.rmtree(out, ignore_errors=True)
    return ref, first.history


def _assert_resumed_run_matches(d, log, ref, ref_hist):
    res = json.load(open(os.path.join(d, log)))
    assert [r["epoch"] for r in res["first"]] == [0, 1]
    assert [r["epoch"] for r in res["second"]] == [2]
    got = res["first"] + res["second"]
    assert len(got) == len(ref) == 3
    for a, b in zip(res["first_history"][:2], ref_hist[:2]):   # before the first update
        assert abs(a["loss"] - b["loss"]) <= 1e-4 * abs(b["loss"])
    for a, b in zip(got, ref):
        assert abs(a["train_loss"] - b["train_loss"]) <= 1e-2 * abs(b["train_loss"])


def test_train_zero1_async_resume_over_two_ranks(two_ranks, one_process_run):
    """train() with n_data=2, zero1 and ckpt_backend="orbax" for 2 epochs,
    then resumed to 3, against the same two calls in one process (pickle
    checkpoints)."""
    d = two_ranks[0]
    last = os.path.join(d, "run", "checkpoint-last")
    assert os.path.exists(os.path.join(last, "meta.json"))
    assert len([f for f in os.listdir(os.path.join(last, "dcp"))
                if f.endswith(".distcp")]) == 2          # one payload file a rank
    assert os.path.exists(os.path.join(d, "run", "checkpoint-final.pth"))
    _assert_resumed_run_matches(d, "train_log.json", *one_process_run)


def test_train_zero1_pickle_resume_over_two_ranks(two_ranks, one_process_run):
    """The same with the pickle backend: rank 0 writes the gathered
    optimizer state, and every rank loads its slices from it."""
    d = two_ranks[0]
    assert os.path.exists(os.path.join(d, "run_pickle", "checkpoint-last", "state.pth"))
    _assert_resumed_run_matches(d, "train_log_pickle.json", *one_process_run)


def test_dist_smoke_two_processes():
    outs = _launch([sys.executable, "-m", "align3r_tpu_torch.tools.dist_smoke"], timeout=120)
    for r, out in enumerate(outs):
        assert f"DIST_SMOKE_OK pid={r} nproc=2 psum=3.0 slice={list(range(5))[r::2]}" in out


def test_train_refuses_n_data_other_than_the_world(tmp_path):
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 4"):
        tt.train(W.train_args(tmp_path, n_data=4))
