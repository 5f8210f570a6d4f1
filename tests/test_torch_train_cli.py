"""The training slice on the CPU: `python -m align3r_tpu_torch.tools.train`
(its `main`) at TINY_TEST over a dataset expression on a synthetic
preprocessed folder (`_rgb.jpg` frames through the port's decoder), started
from a checkpoint the JAX package exported, against the JAX `train()` on the
same expression and checkpoint.

- The port runs its epochs to the end with finite losses, writes log.txt,
  and its checkpoint-final.pth loads strictly into the JAX package's
  `load_torch_checkpoint` (every tensor the port's, bit for bit).
- Its first micro-step's loss matches the JAX train()'s first within 1e-2
  relative (2e-3 measured): the same batch (same expression, seed and
  sampler order; the views are held to JAX's in test_torch_data.py) through
  the same weights, but both forwards run the network in bf16 (the recipe's
  AMP boundary), and the two frameworks round their bf16 products and sums
  at other points; the fp32 train steps are held to 1e-4 in
  test_torch_training.py.
- Without `--device` it asks for the card and raises where CUDA is absent.
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch

from align3r_tpu.models.config import TINY_TEST as JTINY
from align3r_tpu.models.convert import convert_state_dict, export_state_dict
from align3r_tpu.models.convert import load_torch_checkpoint as jload
from align3r_tpu.training.train import TrainArgs as JArgs
from align3r_tpu.training.train import export_torch_checkpoint as jexport
from align3r_tpu.training.train import train as jtrain
from align3r_tpu_torch.models.align3r import Align3R, init_align3r_
from align3r_tpu_torch.models.config import TINY_TEST
from align3r_tpu_torch.tools import train as cli
from torch_data_fixtures import write_preprocessed_scene

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    base = tmp_path_factory.mktemp("slice")
    for i in range(2):
        write_preprocessed_scene(str(base / "po" / f"scene_{i}"), 4, (60, 100), i,
                                 world2cam=True)
    expr = (f"8 @ PointodysseyDatasets(split='train', ROOT={str(base / 'po')!r}, "
            f"resolution=[(64, 48)], aug_crop=8, seed=777)")
    # a JAX export of seeded weights: the zero convs filled and the final head
    # conv scaled so that random heads stay inside expm1's range
    model = init_align3r_(Align3R(TINY_TEST), seed=0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for z in model.zero_convs:
            z[0].weight.normal_(0, 0.05, generator=g)
        for h in (model.downstream_head1, model.downstream_head2):
            h.dpt.head[4].weight.mul_(0.1)
    params = convert_state_dict({k: v.numpy() for k, v in model.state_dict().items()}, JTINY)
    pth = str(base / "start.pth")
    jexport(pth, params, JTINY)
    return base, expr, pth


def test_train_cli_runs_the_slice_and_matches_jax(setup):
    base, expr, pth = setup
    out = str(base / "port")
    res = cli.main(["--model", "TINY_TEST", "--pretrained", pth, "--train_dataset", expr,
                    "--test_dataset", expr.replace("8 @", "2 @"), "--batch_size", "2",
                    "--accum_iter", "2", "--epochs", "2", "--warmup_epochs", "0",
                    "--lr", "1e-3", "--num_workers", "2", "--print_freq", "1",
                    "--output_dir", out, "--device", "cpu"])
    losses = [h["loss"] for h in res.history]
    assert len(losses) == 8 and np.isfinite(losses).all()
    assert res.optimizer.count == 4
    log = [json.loads(line) for line in open(os.path.join(out, "log.txt"))]
    assert [r["epoch"] for r in log] == [0, 1]
    assert all(np.isfinite(r["train_loss"]) and np.isfinite(r["test_loss"])
               and 0 <= r["data_s"] <= r["train_s"] for r in log)

    final = os.path.join(out, "checkpoint-final.pth")
    jparams, _ = jload(final, JTINY)
    sd = res.model.state_dict()
    exported = export_state_dict(jparams, JTINY)
    assert set(exported) == set(sd)
    for k, v in exported.items():
        np.testing.assert_array_equal(np.asarray(v), sd[k].float().numpy(), err_msg=k)

    jout = str(base / "jax")
    jtrain(JArgs(model="TINY_TEST", pretrained=pth, train_dataset=expr, batch_size=2,
                 accum_iter=2, epochs=1, warmup_epochs=0, lr=1e-3, num_workers=2,
                 print_freq=1, output_dir=jout, n_data=1, max_steps_per_epoch=1))
    jloss = json.loads(open(os.path.join(jout, "log.txt")).readline())["train_loss"]
    assert abs(losses[0] - jloss) <= 1e-2 * abs(jloss), (losses[0], jloss)
    for d in (out, jout):        # about 2 GB of checkpoints
        shutil.rmtree(d)


def test_train_cli_asks_for_the_card_by_default(setup):
    base, expr, pth = setup
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--model", "TINY_TEST", "--train_dataset", expr,
                  "--output_dir", str(base / "nocuda")])
    assert cli.get_args_parser().parse_args(["--train_dataset", expr]).device == "cuda"
