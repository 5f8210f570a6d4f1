"""Training data: the image datasets over the preprocessed layout and their
registry, the dataset algebra, the batched sampler and the thread-prefetched
loader (port of align3r_tpu/training/data).

`build_dataset` evaluates the reference's dataset expressions
("1000 @ SceneFlowDatasets(split='train', ROOT=..., resolution=[(512,288)])
 + 1000 @ SintelDatasets(...)", dust3r/training.py:126-133) against the
registry of dataset classes only, with no builtins.
"""
from align3r_tpu_torch.training.data.base import BaseStereoViewDataset
from align3r_tpu_torch.training.data.datasets import (
    PointodysseyDatasets, SceneFlowDatasets, SintelDatasets, SpringDatasets,
    TartanairDatasets, VkittiDatasets, read_pfm)
from align3r_tpu_torch.training.data.easy_dataset import (
    CatDataset, EasyDataset, MulDataset, ResizedDataset)
from align3r_tpu_torch.training.data.loader import (
    BatchedRandomSampler, DataLoader, collate_views, get_data_loader)

DATASET_REGISTRY = {
    "SceneFlowDatasets": SceneFlowDatasets,
    "SintelDatasets": SintelDatasets,
    "PointodysseyDatasets": PointodysseyDatasets,
    "TartanairDatasets": TartanairDatasets,
    "VkittiDatasets": VkittiDatasets,
    "SpringDatasets": SpringDatasets,
}


def build_dataset(expr: str):
    """Evaluate a dataset-algebra expression against the registry only."""
    return eval(expr, {"__builtins__": {}}, dict(DATASET_REGISTRY))  # noqa: S307


__all__ = [k for k in dir() if not k.startswith("_")]
