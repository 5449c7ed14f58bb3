"""``paddle.io`` of the port (counterpart of ``paddle_tpu/io``): datasets,
samplers, the ``DataLoader`` with forked workers (numpy across the
process boundary, Tensors on the device at the consumer edge) and the
``DevicePrefetcher`` that copies batches to the card on a side stream
while a step computes."""
from . import prefetch
from .dataloader import DataLoader, get_worker_info
from .dataset import (ChainDataset, ComposeDataset, ConcatDataset, Dataset,
                      IterableDataset, Subset, TensorDataset, random_split)
from .prefetch import DevicePrefetcher
from .sampler import (BatchSampler, DistributedBatchSampler, RandomSampler,
                      Sampler, SequenceSampler, SubsetRandomSampler,
                      WeightedRandomSampler)

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "ConcatDataset", "Subset", "random_split",
           "DataLoader", "get_worker_info", "DevicePrefetcher", "prefetch",
           "Sampler", "SequenceSampler", "RandomSampler",
           "SubsetRandomSampler", "WeightedRandomSampler", "BatchSampler",
           "DistributedBatchSampler"]
