"""Training data: the dataset algebra, the batched sampler and the
thread-prefetched loader (port of align3r_tpu/training/data, without the
image datasets, which need PIL and wait for their own slice)."""
from align3r_tpu_torch.training.data.easy_dataset import (
    CatDataset, EasyDataset, MulDataset, ResizedDataset)
from align3r_tpu_torch.training.data.loader import (
    BatchedRandomSampler, DataLoader, collate_views, get_data_loader)

__all__ = [k for k in dir() if not k.startswith("_")]
