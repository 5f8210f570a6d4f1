"""The port's train driver (align3r_tpu_torch.training.train) on the CPU at a
tiny config, with an in-memory dataset object, and its checkpoints against
the JAX package's converters.

- An interrupted run resumes from checkpoint-last and ends bit-identical to
  an uninterrupted one (the same seed, data order and optimizer state; CPU
  kernels are deterministic).
- checkpoint-final.pth loads into JAX `load_torch_checkpoint`, and a JAX
  `export_torch_checkpoint` file loads into the port with strict=True.
"""
import json
import os

import numpy as np
import pytest
import torch

from align3r_tpu.models.config import Align3RConfig as JConfig
from align3r_tpu.models.convert import convert_state_dict, export_state_dict
from align3r_tpu.models.convert import load_torch_checkpoint as jload
from align3r_tpu.training.train import export_torch_checkpoint as jexport
from align3r_tpu_torch.models.align3r import Align3R, init_align3r_
from align3r_tpu_torch.models.config import Align3RConfig
from align3r_tpu_torch.models.convert import load_torch_checkpoint
from align3r_tpu_torch.training.data import EasyDataset, get_data_loader
from align3r_tpu_torch.training.step import is_trainable
from align3r_tpu_torch.training.train import TrainArgs, train

torch.set_num_threads(2)

KW = dict(img_size=(32, 32), enc_embed_dim=64, enc_depth=2, enc_num_heads=4,
          dec_embed_dim=48, dec_depth=8, dec_num_heads=4)
MODEL = ("Align3RConfig(img_size=(32, 32), enc_embed_dim=64, enc_depth=2, "
         "enc_num_heads=4, dec_embed_dim=48, dec_depth=8, dec_num_heads=4)")


class Interrupted(Exception):
    pass


class Pairs(EasyDataset):
    """n two-view samples at 32 x 32 from a seed; set_epoch(fail_at) raises,
    to interrupt a run."""

    resolutions = [(32, 32)]

    def __init__(self, n, seed=0, fail_at=None):
        self.n, self.seed, self.fail_at = n, seed, fail_at

    def __len__(self):
        return self.n

    def set_epoch(self, epoch):
        if epoch == self.fail_at:
            raise Interrupted(f"before epoch {epoch}")

    def __getitem__(self, idx):
        idx = idx[0] if isinstance(idx, tuple) else idx
        r = np.random.default_rng(1000 * self.seed + idx)

        def view():
            return {"img": r.standard_normal((32, 32, 3)).astype(np.float32),
                    "pred_depth": r.uniform(0, 1, (32, 32, 3)).astype(np.float32),
                    "pts3d": (r.standard_normal((32, 32, 3)) + [0, 0, 4]).astype(np.float32),
                    "camera_pose": np.eye(4, dtype=np.float32),
                    "valid_mask": r.uniform(0, 1, (32, 32)) > 0.1,
                    "instance": f"{idx}"}
        return [view(), view()]


@pytest.fixture(scope="module")
def jax_export(tmp_path_factory):
    """A JAX export_torch_checkpoint file of seeded weights (the port's
    init_align3r_, zero convs filled, carried to a JAX pytree by the JAX
    convert_state_dict)."""
    path = str(tmp_path_factory.mktemp("jax") / "init.pth")
    model = init_align3r_(Align3R(Align3RConfig(**KW)), seed=0)
    with torch.no_grad():
        for z in model.zero_convs:
            z[0].weight.normal_(0, 0.05, generator=torch.Generator().manual_seed(1))
    params = convert_state_dict({k: v.numpy() for k, v in model.state_dict().items()},
                                JConfig(**KW))
    jexport(path, params, JConfig(**KW))
    return path, params


def _args(out, **kw):
    base = dict(model=MODEL, train_dataset=Pairs(4), test_dataset=Pairs(2, seed=1),
                batch_size=2, accum_iter=2, epochs=3, warmup_epochs=0, lr=1e-3,
                num_workers=2, output_dir=str(out), keep_freq=2, print_freq=1,
                remat="none", device="cpu")
    base.update(kw)
    return TrainArgs(**base)


def test_train_resumes_bit_identically_and_exports(tmp_path, jax_export):
    pth, params = jax_export
    straight = train(_args(tmp_path / "a", pretrained=pth))
    with pytest.raises(Interrupted):
        train(_args(tmp_path / "b", pretrained=pth, train_dataset=Pairs(4, fail_at=2)))
    resumed = train(_args(tmp_path / "b", pretrained=pth))
    assert [r["epoch"] for r in resumed.log] == [2]
    log = [json.loads(l) for l in open(tmp_path / "b" / "log.txt")]
    assert [r["epoch"] for r in log] == [0, 1, 2]
    assert all(np.isfinite(r["train_loss"]) and r["steps"] == 2 for r in log)
    assert len(straight.history) == 6 and resumed.optimizer.count == 3
    for d in ("checkpoint-last", "checkpoint-best", "checkpoint-2"):
        assert os.path.exists(tmp_path / "b" / d / "state.pth"), d
    a, b = straight.model.state_dict(), resumed.model.state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k

    # frozen groups: the pretrained values, kernels stored in bf16
    init, _ = load_torch_checkpoint(pth)
    moved = 0
    for k, v in b.items():
        if is_trainable(k):
            moved += not torch.equal(v.float(), init[k])
        else:
            ref = init[k].to(torch.bfloat16) if v.dtype == torch.bfloat16 else init[k]
            assert torch.equal(v, ref), k
    assert moved > 0

    # checkpoint-final.pth: fp32, reference format, readable by the JAX package
    final = str(tmp_path / "b" / "checkpoint-final.pth")
    sd = torch.load(final, weights_only=False)["model"]
    assert set(sd) == set(b) and all(v.dtype == torch.float32 for v in sd.values())
    jparams, _ = jload(final, JConfig(**KW))
    for k, v in export_state_dict(jparams, JConfig(**KW)).items():
        np.testing.assert_array_equal(np.asarray(v), b[k].float().numpy(), err_msg=k)


def test_jax_export_loads_strictly(tmp_path, jax_export):
    pth, params = jax_export
    sd, cfg = load_torch_checkpoint(pth, Align3RConfig(**KW))
    model = Align3R(cfg)
    model.load_state_dict(sd, strict=True)
    ref = export_state_dict(params, JConfig(**KW))
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref[k], np.float32), err_msg=k)
    # the reference's dec_blocks2 duplication rule
    only1 = {k: v for k, v in sd.items() if not k.startswith("dec_blocks2")}
    torch.save({"model": only1}, tmp_path / "one_stream.pth")
    sd2, _ = load_torch_checkpoint(str(tmp_path / "one_stream.pth"), cfg)
    Align3R(cfg).load_state_dict(sd2, strict=True)
    assert torch.equal(sd2["dec_blocks2.3.attn.qkv.weight"], sd["dec_blocks.3.attn.qkv.weight"])


def test_train_refuses_what_is_not_ported(tmp_path):
    # n_data must equal the world size (one process here), and the backend
    # must be one of the two; zero1 and "orbax" run (test_torch_parallel.py)
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        train(_args(tmp_path, n_data=2))
    with pytest.raises(ValueError, match="ckpt_backend"):
        train(_args(tmp_path, ckpt_backend="npz"))
    # dataset strings are ported: build_dataset evaluates them against the
    # registry alone (test_torch_data.py holds the datasets to JAX's)
    with pytest.raises(TypeError, match="ROOT"):
        get_data_loader("1000 @ SintelDatasets(split='train')", 2)
    with pytest.raises(NameError):
        get_data_loader("__import__('os')", 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train(_args(tmp_path, device="cuda"))


def test_dataset_algebra_and_sampler_match_jax():
    from align3r_tpu.training.data import loader as jloader
    from align3r_tpu.training.data.easy_dataset import ResizedDataset as JResized
    ds = 3 * Pairs(5) + 7 @ Pairs(4, seed=2)
    assert len(ds) == 22
    ds.set_epoch(3)
    jds = JResized(7, Pairs(4, seed=2))
    jds.set_epoch(3)
    np.testing.assert_array_equal(ds.datasets[1]._idxs, jds._idxs)
    s = get_data_loader(ds, 4, num_workers=1).sampler
    js = jloader.BatchedRandomSampler(ds, 4, 1)
    s.set_epoch(5)
    js.set_epoch(5)
    assert list(s) == list(js)
    batch = next(iter(get_data_loader(Pairs(6), 3, num_workers=2, shuffle=False)))
    assert batch["view1"]["img"].shape == (3, 32, 32, 3)
    assert batch["view2"]["instance"] == ["0", "1", "2"]
