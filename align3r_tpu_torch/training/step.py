"""Train and eval steps (port of align3r_tpu/training/step.py:25-181).

The fine-tune recipe trains the decoder side only (reference
training.py:291-298): the groups in ``TRAINABLE_KEYS`` are trained and every
other group (the encoder, ``decoder_embed``) is frozen with
``requires_grad_(False)``, so autograd never builds the encoder's backward
(``Align3R.forward`` runs a frozen encoder under ``torch.no_grad()``).

``TrainOptimizer`` is the JAX optimizer chain: AdamW with betas (0.9, 0.95),
eps 1e-8 and weight decay on parameters with ndim > 1 (optax.adamw with its
mask), an optional global-norm clip, and ``accum_iter`` with
``optax.MultiSteps`` semantics: the micro-step gradients are averaged and
applied every ``accum_iter``-th call, with no update in between; the Adam
step count and the learning-rate schedule count applied updates. State
exists only for the trainable parameters. The schedule starts at 0, so the
first applied update has learning rate 0, as in the JAX package.

Data parallelism (one process a GPU, parallel/mesh.py; the JAX package's
'data' mesh axis): each rank runs its slice of the global batch, its means
divided by the global valid-pixel counts, and the gradients are summed over
the ranks each micro-step: the global batch's gradient on every rank, as
the JAX psum gives. ``zero1`` (JAX zero1_opt_shardings): a leaf the shard
choice splits (``zero1_shard_dims``) keeps only this rank's slice of its
Adam moments and of the accumulation buffer, updates that slice, and the
updated slices are put back together on every rank (one all-reduce of the
slices written into zeros); smaller leaves stay whole on every rank.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch
import torch.distributed as dist

from align3r_tpu_torch.models.align3r import Align3R
from align3r_tpu_torch.parallel.mesh import (all_gather_sum, rank, world_size,
                                             zero1_shard_dims)
from align3r_tpu_torch.training.losses import (conf_regr3d_loss,
                                               regr3d_scale_shift_inv_loss)

# the reference fine-tune list (training.py:291-298), by module name;
# decoder_embed is absent from it, so it stays frozen
TRAINABLE_KEYS = (
    "downstream_head1", "downstream_head2", "dec_blocks", "dec_blocks2",
    "dec_norm", "dec_blocks_pc", "patch_embed_point_cloud", "zero_convs",
)


def is_trainable(name: str) -> bool:
    """Whether the parameter or module called `name` is in the fine-tune set."""
    return name.split(".", 1)[0] in TRAINABLE_KEYS


def freeze_params(model: Align3R) -> Align3R:
    """requires_grad on the trainable groups only."""
    for name, p in model.named_parameters():
        p.requires_grad_(is_trainable(name))
    return model


@torch.no_grad()
def cast_frozen_kernels(model: Align3R, dtype=torch.bfloat16) -> Align3R:
    """Store the frozen groups' matmul and conv weights in `dtype`.

    Every compute path casts weights to the activation dtype at use, so under
    bf16 compute this changes nothing in the forward and halves the frozen
    encoder's memory. Biases and LayerNorm parameters stay fp32: they are
    applied in fp32 where the JAX package applies them in fp32."""
    for name, m in model.named_modules():
        if is_trainable(name) or not isinstance(
                m, (torch.nn.Linear, torch.nn.Conv1d, torch.nn.Conv2d)):
            continue
        m.weight.data = m.weight.data.to(dtype)
    return model


def make_lr_schedule(base_lr: float, min_lr: float, warmup_epochs: float,
                     total_epochs: float, steps_per_epoch: int) -> Callable:
    """Per-update linear warmup from 0 then cosine decay to min_lr:
    optax.warmup_cosine_decay_schedule(0, base_lr, max(warmup, 1),
    max(total, 2), min_lr), as the JAX package builds it."""
    warmup = max(int(warmup_epochs * steps_per_epoch), 1)
    total = max(int(total_epochs * steps_per_epoch), 2)
    alpha = 0.0 if base_lr == 0.0 else min_lr / base_lr
    if total <= warmup:
        raise ValueError(f"the cosine decay needs total steps ({total}) > "
                         f"warmup steps ({warmup})")

    def schedule(count: int) -> float:
        if count < warmup:
            return base_lr * min(max(count, 0), warmup) / warmup
        t = min(count - warmup, total - warmup)
        cosine = 0.5 * (1 + math.cos(math.pi * t / (total - warmup)))
        return base_lr * ((1 - alpha) * cosine + alpha)
    return schedule


class TrainOptimizer:
    """The JAX optimizer chain over `params`, a list of (name, parameter)
    (see the module docstring). ``update(grads)`` takes one micro-step's
    gradients (the global batch's), in the order of `params`. With `zero1`
    over more than one rank, AdamW and the accumulation run on this rank's
    slices (``shards``) of the leaves that ``dims`` splits."""

    def __init__(self, params, lr_schedule: Callable, weight_decay: float = 0.05,
                 betas=(0.9, 0.95), max_grad_norm: float | None = None,
                 accum_iter: int = 1, eps: float = 1e-8, zero1: bool = False):
        self.names = [n for n, _ in params]
        self.params = [p for _, p in params]
        self.schedule = lr_schedule
        self.max_grad_norm = max_grad_norm
        self.accum_iter = accum_iter
        self.world = world_size() if zero1 else 1
        self.dims = (zero1_shard_dims([p.shape for p in self.params], self.world)
                     if self.world > 1 else [None] * len(self.params))
        # what AdamW steps: the parameter itself, or this rank's slice of it
        self.shards = [p if d is None else self._slice(p.detach(), d).clone()
                       for p, d in zip(self.params, self.dims)]
        # AdamW's state_dict numbers the leaves in group order, decay first:
        # leaf order[j] is its state j
        self.order = ([i for i, p in enumerate(self.params) if p.ndim > 1]
                      + [i for i, p in enumerate(self.params) if p.ndim <= 1])
        n_decay = sum(p.ndim > 1 for p in self.params)
        self.adamw = torch.optim.AdamW(
            [{"params": [self.shards[i] for i in self.order[:n_decay]],
              "weight_decay": weight_decay},
             {"params": [self.shards[i] for i in self.order[n_decay:]],
              "weight_decay": 0.0}],
            lr=0.0, betas=betas, eps=eps)
        # the moments exist from the start (a checkpoint's template names them)
        for q in self.shards:
            self.adamw.state[q] = {
                "step": torch.tensor(0.0, dtype=torch.float32),
                "exp_avg": torch.zeros_like(q, memory_format=torch.preserve_format),
                "exp_avg_sq": torch.zeros_like(q, memory_format=torch.preserve_format)}
        self.count = 0            # applied updates
        self.mini_step = 0
        self.acc = ([torch.zeros_like(q, memory_format=torch.preserve_format)
                     for q in self.shards] if accum_iter > 1 else None)

    def _slice(self, t, d):
        """This rank's slice of `t` along dim d (a view)."""
        n = t.shape[d] // self.world
        return t.narrow(d, rank() * n, n)

    def _local(self, grads):
        return [g if d is None else self._slice(g, d) for g, d in zip(grads, self.dims)]

    def _global_norm(self, grads):
        """The global norm of the (sliced) gradients: the split leaves'
        squares summed over the ranks."""
        if self.world == 1:
            return torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        sq = [g.float().pow(2).sum() for g in grads]
        split = torch.stack([x for x, d in zip(sq, self.dims) if d is not None]
                            or [sq[0] * 0]).sum()
        whole = torch.stack([x for x, d in zip(sq, self.dims) if d is None]
                            or [sq[0] * 0]).sum()
        return torch.sqrt(all_gather_sum(split) + whole)

    @torch.no_grad()
    def _gather(self, tensors, full_like):
        """Each split leaf whole again on every rank: this rank's slices
        written into zeros of the full shapes, one all-reduce."""
        split = [i for i, d in enumerate(self.dims) if d is not None]
        if not split:
            return {}
        sizes = [full_like[i].numel() for i in split]
        buf = torch.zeros(sum(sizes), dtype=full_like[split[0]].dtype,
                          device=full_like[split[0]].device)
        views = {}
        for i, v in zip(split, buf.split(sizes)):
            views[i] = v.view(full_like[i].shape)
            self._slice(views[i], self.dims[i]).copy_(tensors[i])
        all_gather_sum(buf)
        return views

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor]) -> bool:
        """Accumulate a micro-step; apply an update on every accum_iter-th.
        Returns whether an update was applied."""
        grads = self._local(grads)
        if self.acc is not None:
            n = self.mini_step          # running mean, as optax.MultiSteps
            for a, g in zip(self.acc, grads):
                a.mul_(n / (n + 1)).add_(g, alpha=1.0 / (n + 1))
            self.mini_step = (n + 1) % self.accum_iter
            if self.mini_step:
                return False
            grads = self.acc
        if self.max_grad_norm:
            norm = self._global_norm(grads)
            scale = torch.where(norm < self.max_grad_norm, 1.0,
                                self.max_grad_norm / norm)
            grads = [g * scale for g in grads]
        for q, g in zip(self.shards, grads):
            q.grad = g.to(q.dtype)
        lr = self.schedule(self.count)
        for group in self.adamw.param_groups:
            group["lr"] = lr
        self.adamw.step()
        for q in self.shards:
            q.grad = None
        for i, full in self._gather(self.shards, self.params).items():
            self.params[i].copy_(full)
        if self.acc is not None:
            for a in self.acc:
                a.zero_()
        self.count += 1
        return True

    def state_dict(self) -> Dict:
        """The whole state (split leaves gathered: every rank calls it)."""
        sd = self.adamw.state_dict()
        acc = self.acc
        if self.world > 1:
            sd = {"param_groups": sd["param_groups"],
                  "state": {i: dict(st) for i, st in sd["state"].items()}}
            state_of = {i: j for j, i in enumerate(self.order)}
            for key in ("exp_avg", "exp_avg_sq"):
                full = self._gather([self.adamw.state[q][key] for q in self.shards],
                                    self.params)
                for i, t in full.items():
                    sd["state"][state_of[i]][key] = t
            if acc is not None:
                acc = list(acc)
                for i, t in self._gather(acc, self.params).items():
                    acc[i] = t
        return {"adamw": sd, "count": self.count, "mini_step": self.mini_step, "acc": acc}

    def load_state_dict(self, state: Dict) -> None:
        """From state_dict()'s whole state; the split leaves take this rank's
        slices, and the slices AdamW steps are re-read from the parameters."""
        sd = state["adamw"]
        if self.world > 1:
            sd = {"param_groups": sd["param_groups"],
                  "state": {j: {k: (self._slice(v, self.dims[i]).clone() if k != "step"
                                    and self.dims[i] is not None else v)
                                for k, v in st.items()}
                            for j, st in sd["state"].items() for i in [self.order[j]]}}
        self.adamw.load_state_dict(sd)
        self.count, self.mini_step = state["count"], state["mini_step"]
        if self.acc is not None:
            for a, s in zip(self.acc, self._local(state["acc"])):
                a.copy_(s)
        self.refresh_shards()

    @torch.no_grad()
    def refresh_shards(self) -> None:
        """Re-read the slices AdamW steps from the parameters (after the
        model's weights were loaded)."""
        for p, q, d in zip(self.params, self.shards, self.dims):
            if d is not None:
                q.copy_(self._slice(p, d))

    def local_state(self) -> Dict:
        """This rank's state as flat tensors under names: a split leaf's
        moments and accumulation under '<name>@<rank>/<world>', the rest
        under '<name>' (the same on every rank). For torch.distributed.
        checkpoint, which writes the shared entries once and loads in place."""
        out = {}
        for i, (name, q, d) in enumerate(zip(self.names, self.shards, self.dims)):
            key = name if d is None else f"{name}@{rank()}/{self.world}"
            st = self.adamw.state[q]
            out[f"{key}.exp_avg"] = st["exp_avg"]
            out[f"{key}.exp_avg_sq"] = st["exp_avg_sq"]
            out[f"{name}.step"] = st["step"]
            if self.acc is not None:
                out[f"{key}.acc"] = self.acc[i]
        return out


def make_optimizer(model: Align3R, lr_schedule: Callable,
                   weight_decay: float = 0.05, betas=(0.9, 0.95),
                   max_grad_norm: float | None = None,
                   accum_iter: int = 1, zero1: bool = False) -> TrainOptimizer:
    """Freeze the non-trainable groups and build the optimizer over the
    trainable parameters."""
    freeze_params(model)
    return TrainOptimizer([(n, p) for n, p in model.named_parameters()
                           if p.requires_grad], lr_schedule, weight_decay,
                          betas, max_grad_norm, accum_iter, zero1=zero1)


def _global_count(count):
    """A valid-pixel count summed over the ranks (no gradient flows)."""
    return all_gather_sum(count.detach().clone())


def loss_fn(model: Align3R, batch, alpha: float = 0.2, dtype=torch.bfloat16,
            remat: str = "full", attn_impl: str = "auto",
            head_dtype=torch.float32):
    """batch: {'view1': {...}, 'view2': {...}} with per-view img, pred_depth
    (inputs) and pts3d, camera_pose, valid_mask (targets), on the model's
    device. Returns (loss, details); over several ranks, this rank's share
    of the global batch's (the module docstring)."""
    v1, v2 = batch["view1"], batch["view2"]
    pred1, pred2 = model(v1, v2, dtype=dtype, attn_impl=attn_impl, remat=remat,
                         head_dtype=head_dtype)
    return conf_regr3d_loss(v1, v2, pred1, pred2, alpha=alpha,
                            reduce=_global_count if world_size() > 1 else None)


def make_train_step(model: Align3R, optimizer: TrainOptimizer,
                    alpha: float = 0.2, dtype=torch.bfloat16,
                    remat: str = "full", attn_impl: str = "auto",
                    head_dtype=torch.float32):
    """train_step(batch) -> metrics: one micro-step, updating `model` and
    `optimizer` in place. Metrics are 0-dim tensors: loss, the four loss
    details and grad_norm, the global norm of this micro-step's gradients
    (frozen parameters have none, as the JAX package's are zero). Over
    several ranks, `batch` is this rank's slice of the global batch; the
    gradients and metrics are the global batch's, summed over the ranks."""
    def train_step(batch) -> Dict[str, torch.Tensor]:
        loss, details = loss_fn(model, batch, alpha, dtype, remat, attn_impl,
                                head_dtype)
        grads = torch.autograd.grad(loss, optimizer.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(optimizer.params, grads)]
        metrics = {**{k: v.detach() for k, v in details.items()}, "loss": loss.detach()}
        if world_size() > 1:
            grads = _sum_over_ranks(grads)
            metrics = dict(zip(metrics, _sum_over_ranks(list(metrics.values()))))
        grad_norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
        optimizer.update(grads)
        return {**metrics, "grad_norm": grad_norm}
    return train_step


def _sum_over_ranks(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """The tensors summed over the ranks, by one all-reduce of one flat
    buffer a dtype."""
    out = list(tensors)
    for dt in {t.dtype for t in tensors}:
        idx = [i for i, t in enumerate(tensors) if t.dtype == dt]
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        for i, v in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = v.view(tensors[i].shape)
    return out


def make_eval_step(model: Align3R, dtype=torch.bfloat16):
    """eval_step(batch) -> the scale-shift-invariant Regr3D loss, with the
    default forward (attn_impl='auto', fp32 heads)."""
    @torch.no_grad()
    def eval_step(batch):
        v1, v2 = batch["view1"], batch["view2"]
        pred1, pred2 = model(v1, v2, dtype=dtype, remat="none")
        return regr3d_scale_shift_inv_loss(v1, v2, pred1, pred2, gt_scale=True)
    return eval_step
