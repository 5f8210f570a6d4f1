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
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch

from align3r_tpu_torch.models.align3r import Align3R
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
    gradients, in the order of `params`."""

    def __init__(self, params, lr_schedule: Callable, weight_decay: float = 0.05,
                 betas=(0.9, 0.95), max_grad_norm: float | None = None,
                 accum_iter: int = 1, eps: float = 1e-8):
        self.params = [p for _, p in params]
        self.schedule = lr_schedule
        self.max_grad_norm = max_grad_norm
        self.accum_iter = accum_iter
        decay = [p for p in self.params if p.ndim > 1]
        no_decay = [p for p in self.params if p.ndim <= 1]
        self.adamw = torch.optim.AdamW(
            [{"params": decay, "weight_decay": weight_decay},
             {"params": no_decay, "weight_decay": 0.0}],
            lr=0.0, betas=betas, eps=eps)
        self.count = 0            # applied updates
        self.mini_step = 0
        self.acc = ([torch.zeros_like(p, memory_format=torch.preserve_format)
                     for p in self.params] if accum_iter > 1 else None)

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor]) -> bool:
        """Accumulate a micro-step; apply an update on every accum_iter-th.
        Returns whether an update was applied."""
        if self.acc is not None:
            n = self.mini_step          # running mean, as optax.MultiSteps
            for a, g in zip(self.acc, grads):
                a.mul_(n / (n + 1)).add_(g, alpha=1.0 / (n + 1))
            self.mini_step = (n + 1) % self.accum_iter
            if self.mini_step:
                return False
            grads = self.acc
        if self.max_grad_norm:
            norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g) for g in grads]))
            scale = torch.where(norm < self.max_grad_norm, 1.0,
                                self.max_grad_norm / norm)
            grads = [g * scale for g in grads]
        for p, g in zip(self.params, grads):
            p.grad = g.to(p.dtype)
        lr = self.schedule(self.count)
        for group in self.adamw.param_groups:
            group["lr"] = lr
        self.adamw.step()
        for p in self.params:
            p.grad = None
        if self.acc is not None:
            for a in self.acc:
                a.zero_()
        self.count += 1
        return True

    def state_dict(self) -> Dict:
        return {"adamw": self.adamw.state_dict(), "count": self.count,
                "mini_step": self.mini_step, "acc": self.acc}

    def load_state_dict(self, state: Dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.count, self.mini_step = state["count"], state["mini_step"]
        if self.acc is not None:
            for a, s in zip(self.acc, state["acc"]):
                a.copy_(s)


def make_optimizer(model: Align3R, lr_schedule: Callable,
                   weight_decay: float = 0.05, betas=(0.9, 0.95),
                   max_grad_norm: float | None = None,
                   accum_iter: int = 1) -> TrainOptimizer:
    """Freeze the non-trainable groups and build the optimizer over the
    trainable parameters."""
    freeze_params(model)
    return TrainOptimizer([(n, p) for n, p in model.named_parameters()
                           if p.requires_grad], lr_schedule, weight_decay,
                          betas, max_grad_norm, accum_iter)


def loss_fn(model: Align3R, batch, alpha: float = 0.2, dtype=torch.bfloat16,
            remat: str = "full", attn_impl: str = "auto",
            head_dtype=torch.float32):
    """batch: {'view1': {...}, 'view2': {...}} with per-view img, pred_depth
    (inputs) and pts3d, camera_pose, valid_mask (targets), on the model's
    device. Returns (loss, details)."""
    v1, v2 = batch["view1"], batch["view2"]
    pred1, pred2 = model(v1, v2, dtype=dtype, attn_impl=attn_impl, remat=remat,
                         head_dtype=head_dtype)
    return conf_regr3d_loss(v1, v2, pred1, pred2, alpha=alpha)


def make_train_step(model: Align3R, optimizer: TrainOptimizer,
                    alpha: float = 0.2, dtype=torch.bfloat16,
                    remat: str = "full", attn_impl: str = "auto",
                    head_dtype=torch.float32):
    """train_step(batch) -> metrics: one micro-step, updating `model` and
    `optimizer` in place. Metrics are 0-dim tensors: loss, the four loss
    details and grad_norm, the global norm of this micro-step's gradients
    (frozen parameters have none, as the JAX package's are zero)."""
    def train_step(batch) -> Dict[str, torch.Tensor]:
        loss, details = loss_fn(model, batch, alpha, dtype, remat, attn_impl,
                                head_dtype)
        grads = torch.autograd.grad(loss, optimizer.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(optimizer.params, grads)]
        grad_norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
        optimizer.update(grads)
        return {**{k: v.detach() for k, v in details.items()},
                "loss": loss.detach(), "grad_norm": grad_norm}
    return train_step


def make_eval_step(model: Align3R, dtype=torch.bfloat16):
    """eval_step(batch) -> the scale-shift-invariant Regr3D loss, with the
    default forward (attn_impl='auto', fp32 heads)."""
    @torch.no_grad()
    def eval_step(batch):
        v1, v2 = batch["view1"], batch["view2"]
        pred1, pred2 = model(v1, v2, dtype=dtype, remat="none")
        return regr3d_scale_shift_inv_loss(v1, v2, pred1, pred2, gt_scale=True)
    return eval_step
