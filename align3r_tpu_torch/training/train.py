"""Training driver: epochs, eval, checkpoints, logging (port of
align3r_tpu/training/train.py:24-377).

``train(TrainArgs(...))`` builds the model from a config expression (or a
reference constructor string), optionally loads a reference ``.pth``
(``pretrained``), freezes the encoder side and stores its matmul and conv
weights in bf16 (``cast_frozen``), then runs the micro-step loop of
``training/step.py`` over a dataset expression (``"1000 @ SceneFlowDatasets(
split='train', ROOT=..., resolution=[(512, 288)])"``, read through
``training.data.build_dataset``) or a dataset object. Per epoch it appends one
JSON line to ``log.txt`` (mean micro-step loss, test loss, seconds, and
``data_s``, the seconds the loop waited on the loader), writes
``checkpoint-last`` (auto-resumed on the next call), ``checkpoint-best`` on
the test loss and a ``checkpoint-{epoch}`` copy every ``keep_freq`` epochs;
at the end it exports ``checkpoint-final.pth`` in the reference format
``{"model": state_dict}`` in fp32.

Checkpoints: ``ckpt_backend="pickle"`` writes ``state.pth`` (torch.save,
the optimizer state whole); ``"orbax"`` (the JAX package's asynchronous
backend, train.py:65-175) saves through ``torch.distributed.checkpoint.
async_save`` into ``dcp.tmp/``, each rank writing its own slices, while
training goes on; once the payload has committed, ``dcp.tmp/`` becomes
``dcp/`` and only then is ``meta.json`` written, so auto-resume never reads
a half-written save.

Data parallelism (steps and optimizer: training/step.py): one process a GPU,
``torchrun --nproc_per_node N -m align3r_tpu_torch.tools.train ...`` (or the
ALIGN3R_COORDINATOR variables, parallel/mesh.py). ``n_data`` (None = the
world size) must equal the world size; ``batch_size`` is the global batch,
each rank loading its 1/N slice of every batch; ``zero1`` splits the Adam
moments and the accumulation buffer over the ranks. Each rank evaluates the
whole test set; rank 0 alone prints and writes ``log.txt`` and the final
export. ``profile`` writes a ``torch.profiler`` trace of the
first epoch to ``output_dir/profile/trace.json`` (the JAX package's
``jax.profiler`` trace); ``python -m align3r_tpu_torch.tools.profile_train``
splits one micro-step. ``python -m align3r_tpu_torch.tools.train`` is the
command line.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import math
import os
import shutil
import time
import warnings
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from align3r_tpu_torch.models.align3r import Align3R, init_align3r_
from align3r_tpu_torch.models.config import (TINY_TEST, VIT_L_512, Align3RConfig,
                                             model_string, parse_model_string)
from align3r_tpu_torch.models.convert import load_torch_checkpoint
from align3r_tpu_torch.parallel.mesh import (local_device_index, maybe_init_distributed,
                                             rank, world_size)
from align3r_tpu_torch.training.data import get_data_loader
from align3r_tpu_torch.training.step import (cast_frozen_kernels, make_eval_step,
                                             make_lr_schedule, make_optimizer,
                                             make_train_step)

BATCH_KEYS = ("img", "pred_depth", "pts3d", "camera_pose", "valid_mask")


@dataclasses.dataclass
class TrainArgs:
    model: str = "Align3RConfig()"            # config expression or ctor string
    pretrained: Optional[str] = None          # reference .pth to start from
    train_dataset: Any = ""                   # an expression or a dataset object
    test_dataset: Any = ""
    seed: int = 0
    batch_size: int = 2
    accum_iter: int = 4
    epochs: int = 50
    start_epoch: int = 0
    lr: float = 5e-5
    min_lr: float = 1e-6
    warmup_epochs: int = 5
    weight_decay: float = 0.05
    alpha: float = 0.2                        # ConfLoss alpha (train.sh:6)
    num_workers: int = 8
    output_dir: str = "./output"
    eval_freq: int = 1
    save_freq: int = 1
    keep_freq: int = 5
    print_freq: int = 20
    n_data: Optional[int] = None              # data-parallel ranks (None = world size)
    ckpt_backend: str = "pickle"              # 'pickle' | 'orbax' (async, dcp)
    cast_frozen: bool = True                  # store frozen kernels in bf16
    zero1: bool = False                       # split the Adam state over the ranks
    remat: str = "full"                       # 'none' | 'full' | 'dots'
    head_bf16: bool = False                   # bf16 DPT conv pyramid
    profile: bool = False                     # trace the first epoch
    max_steps_per_epoch: Optional[int] = None
    device: str = "cuda"


@dataclasses.dataclass
class TrainResult:
    model: Align3R
    optimizer: Any
    history: List[Dict[str, float]]           # every micro-step's metrics
    log: List[Dict[str, Any]]                 # the log.txt records


# asynchronous saves whose meta.json waits for the payload to commit:
# {checkpoint dir: (future, meta)}
_PENDING_META: Dict[str, Any] = {}
_CKPT_GROUP = None


def _ckpt_group():
    """A gloo group of its own for the asynchronous saves' collectives, which
    run on a background thread beside the training's (None: one process)."""
    global _CKPT_GROUP
    if world_size() > 1 and _CKPT_GROUP is None:
        _CKPT_GROUP = dist.new_group(backend="gloo")
    return _CKPT_GROUP


def _promote_pending_meta(assume_finished: bool = False):
    """For each asynchronous save whose payload has committed, make dcp.tmp/
    the checkpoint's dcp/ and write meta.json (rank 0). assume_finished
    waits for every save first; a save that failed is dropped with a
    warning and gets no meta.json."""
    for path, (fut, meta) in list(_PENDING_META.items()):
        if not (assume_finished or fut.done()):
            continue
        del _PENDING_META[path]
        try:
            fut.result()
        except Exception as e:                       # noqa: BLE001 - reported
            warnings.warn(f"asynchronous save to {path} failed ({e!r}): "
                          "checkpoint unusable, meta.json not written")
            continue
        if rank() == 0:
            final = os.path.join(path, "dcp")
            shutil.rmtree(final, ignore_errors=True)
            os.replace(os.path.join(path, "dcp.tmp"), final)
            with open(os.path.join(path, "meta.json"), "w") as f:
                json.dump(meta, f)


def wait_for_checkpoints():
    """Block until every asynchronous save has committed and its meta.json
    is written (before the process exits)."""
    _promote_pending_meta(assume_finished=True)
    if world_size() > 1:
        dist.barrier()


def _dcp_state(model, optimizer):
    """The torch.distributed.checkpoint state of a rank: the model (the same
    on every rank, written once), the optimizer's local_state (split leaves
    under this rank's names) and the counters."""
    return {"model": model.state_dict(), "optim": optimizer.local_state(),
            "counters": {"count": optimizer.count, "mini_step": optimizer.mini_step}}


def save_checkpoint(path, model, optimizer, step, epoch, best_so_far=None,
                    backend: str = "pickle"):
    """backend 'pickle': state.pth (model, the whole optimizer state,
    counters), written by rank 0 atomically (every rank calls it: a split
    optimizer state is gathered). 'orbax': an asynchronous save (see the
    module docstring); at most one save is in flight."""
    import torch.distributed.checkpoint as dcp
    meta = {"step": step, "epoch": epoch, "best_so_far": best_so_far}
    if backend == "orbax":
        _promote_pending_meta(assume_finished=True)
        if rank() == 0:
            os.makedirs(path, exist_ok=True)
            shutil.rmtree(os.path.join(path, "dcp.tmp"), ignore_errors=True)
        if world_size() > 1:
            dist.barrier()
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*assuming the intent")
            fut = dcp.async_save(_dcp_state(model, optimizer),
                                 checkpoint_id=os.path.join(path, "dcp.tmp"),
                                 process_group=_ckpt_group())
        _PENDING_META[path] = (fut, meta)
        return
    if backend != "pickle":
        raise ValueError(f"ckpt_backend {backend!r}: 'pickle' or 'orbax'")
    opt_state = optimizer.state_dict()
    if rank() == 0:
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, "state.pth.tmp")
        torch.save({"model": model.state_dict(), "optimizer": opt_state, **meta}, tmp)
        os.replace(tmp, os.path.join(path, "state.pth"))
    if world_size() > 1:
        dist.barrier()


def load_checkpoint(path, model, optimizer, dev) -> Optional[Dict]:
    """Resume from the checkpoint dir `path` in either format (a committed
    asynchronous save: dcp/ and meta.json; else state.pth) into `model` and
    `optimizer`, in place. Returns the counters (step, epoch, best_so_far),
    or None where `path` holds no usable checkpoint."""
    import torch.distributed.checkpoint as dcp
    _promote_pending_meta(assume_finished=True)
    if (os.path.exists(os.path.join(path, "meta.json"))
            and os.path.isdir(os.path.join(path, "dcp"))):
        state = _dcp_state(model, optimizer)
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*assuming the intent")
            dcp.load(state, checkpoint_id=os.path.join(path, "dcp"),
                     process_group=_ckpt_group())
        optimizer.count = int(state["counters"]["count"])
        optimizer.mini_step = int(state["counters"]["mini_step"])
        optimizer.refresh_shards()
        with open(os.path.join(path, "meta.json")) as f:
            return json.load(f)
    if os.path.exists(os.path.join(path, "state.pth")):
        ck = torch.load(os.path.join(path, "state.pth"), map_location=dev,
                        weights_only=False)
        model.load_state_dict(ck["model"], strict=True)
        optimizer.load_state_dict(ck["optimizer"])
        return {k: ck.get(k) for k in ("step", "epoch", "best_so_far")}
    return None


def export_torch_checkpoint(path, model: Align3R):
    """The reference checkpoint format, {"model": state_dict} in fp32 (the
    bf16-stored frozen kernels are upcast exactly), with "args" {"model":
    the config's constructor string}, so that `load_torch_checkpoint`
    rebuilds the config. args is a dict where the reference stores an
    argparse.Namespace, so the file also loads with weights_only=True."""
    torch.save({"model": {k: v.detach().float().cpu()
                          for k, v in model.state_dict().items()},
                "args": {"model": model_string(model.cfg)}}, path)


def _config(expr: str) -> Align3RConfig:
    if expr.startswith("AsymmetricCroCo3DStereo"):
        return parse_model_string(expr)
    return eval(expr, {"__builtins__": {}},
                {"Align3RConfig": Align3RConfig, "VIT_L_512": VIT_L_512,
                 "TINY_TEST": TINY_TEST})


def _profiler(args: TrainArgs, dev: torch.device):
    os.makedirs(os.path.join(args.output_dir, "profile"), exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def train(args: TrainArgs) -> TrainResult:
    if args.ckpt_backend not in ("pickle", "orbax"):
        raise ValueError(f"ckpt_backend {args.ckpt_backend!r}: 'pickle' or 'orbax'")
    maybe_init_distributed()
    world, me = world_size(), rank()
    n_data = world if args.n_data is None else args.n_data
    if n_data != world:
        raise ValueError(
            f"n_data={n_data} needs {n_data} processes, one GPU each (this run has "
            f"{world}): launch with torchrun --nproc_per_node {n_data} -m "
            "align3r_tpu_torch.tools.train ...")
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"TrainArgs.device={args.device!r} but CUDA is not "
                           "available (pass device='cpu' to train on the CPU)")
    if dev.type == "cuda" and world > 1 and dev.index is None:
        dev = torch.device("cuda", local_device_index())
    # fp32 heads and convolutions run in full fp32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(args.output_dir, exist_ok=True)
    log_path = os.path.join(args.output_dir, "log.txt")
    say = print if me == 0 else (lambda *a, **k: None)

    # ---- model
    cfg = _config(args.model)
    sd = None
    if args.pretrained:
        sd, cfg = load_torch_checkpoint(args.pretrained, cfg)
    with torch.device(dev):
        model = Align3R(cfg)
    init_align3r_(model, seed=args.seed)
    if sd is not None:
        model.load_state_dict(sd, strict=True)
    if args.cast_frozen:
        cast_frozen_kernels(model)

    # ---- data, schedule, optimizer, steps
    train_loader = get_data_loader(args.train_dataset, args.batch_size,
                                   num_workers=args.num_workers, world_size=world,
                                   rank=me)
    test_loader = (get_data_loader(args.test_dataset, args.batch_size,
                                   num_workers=args.num_workers, shuffle=False)
                   if args.test_dataset else None)
    steps_per_epoch = max(len(train_loader), 1)
    sched = make_lr_schedule(args.lr, args.min_lr, args.warmup_epochs,
                             args.epochs, steps_per_epoch)
    opt = make_optimizer(model, sched, weight_decay=args.weight_decay,
                         accum_iter=args.accum_iter, zero1=args.zero1)
    train_step = make_train_step(
        model, opt, alpha=args.alpha, remat=args.remat,
        head_dtype=torch.bfloat16 if args.head_bf16 else torch.float32)
    eval_step = make_eval_step(model)

    step, best_so_far = 0, None
    last = os.path.join(args.output_dir, "checkpoint-last")
    ck = load_checkpoint(last, model, opt, dev)                # auto-resume
    if ck is not None:
        step, best_so_far = ck["step"], ck.get("best_so_far")
        args.start_epoch = ck["epoch"] + 1
        say(f"resumed from {last} at epoch {args.start_epoch}")
    save = lambda path, epoch: save_checkpoint(path, model, opt, step, epoch, best_so_far,
                                               backend=args.ckpt_backend)

    def put_batch(batch):
        return {vn: {k: torch.as_tensor(np.asarray(v)).to(dev)
                     for k, v in bv.items() if k in BATCH_KEYS}
                for vn, bv in batch.items()}

    history, log = [], []
    for epoch in range(args.start_epoch, args.epochs):
        train_loader.set_epoch(epoch)
        t0 = time.time()
        metrics, data_s = [], 0.0
        prof = _profiler(args, dev) if args.profile and epoch == args.start_epoch else None
        if prof is not None:
            prof.__enter__()
        batches = iter(train_loader)
        for it in itertools.count():
            if args.max_steps_per_epoch and it >= args.max_steps_per_epoch:
                break
            t = time.perf_counter()
            batch = next(batches, None)
            data_s += time.perf_counter() - t
            if batch is None:
                break
            metrics.append(train_step(put_batch(batch)))
            step += 1
            _promote_pending_meta()     # a committed asynchronous save, at once
            if it % args.print_freq == 0:
                loss = float(metrics[-1]["loss"])
                if not math.isfinite(loss):
                    raise FloatingPointError(f"loss is {loss}, stopping training")
                say(f"epoch {epoch} it {it}/{steps_per_epoch} loss {loss:.4f} "
                    f"lr {sched(opt.count):.2e}")
        if prof is not None:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(os.path.join(args.output_dir, "profile", "trace.json"))
        # one host sync per epoch: every micro-step's metrics as floats
        host = [{k: float(v) for k, v in m.items()} for m in metrics]
        bad = [i for i, h in enumerate(host) if not math.isfinite(h["loss"])]
        if bad:
            raise FloatingPointError(f"non-finite loss at micro-steps {bad} "
                                     f"of epoch {epoch}")
        history += host
        train_secs = time.time() - t0

        test_loss = None
        if test_loader is not None and (epoch + 1) % args.eval_freq == 0:
            test_loader.set_epoch(0)
            vals = []
            for it, batch in enumerate(test_loader):
                if args.max_steps_per_epoch and it >= args.max_steps_per_epoch:
                    break
                vals.append(float(eval_step(put_batch(batch))))
            test_loss = float(np.mean(vals)) if vals else None
            if test_loss is not None and (best_so_far is None
                                          or test_loss < best_so_far):
                best_so_far = test_loss
                save(os.path.join(args.output_dir, "checkpoint-best"), epoch)

        rec = {"epoch": epoch,
               "train_loss": float(np.mean([h["loss"] for h in host])) if host else None,
               "test_loss": test_loss, "steps": len(host),
               "train_s": train_secs, "data_s": data_s, "time_s": time.time() - t0}
        log.append(rec)
        if me == 0:
            with open(log_path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        if (epoch + 1) % args.save_freq == 0 or epoch + 1 == args.epochs:
            save(last, epoch)
        if (epoch + 1) % args.keep_freq == 0:
            save(os.path.join(args.output_dir, f"checkpoint-{epoch + 1}"), epoch)

    wait_for_checkpoints()
    if me == 0:
        export_torch_checkpoint(os.path.join(args.output_dir, "checkpoint-final.pth"),
                                model)
    return TrainResult(model, opt, history, log)
