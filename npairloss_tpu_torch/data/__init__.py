"""Data of the port: identity-balanced sampling, list-file datasets (PIL
or the native C++ runtime), augmentation on the device, and synthetic
identity batches."""

from npairloss_tpu_torch.data.dataset import ArrayDataset, ListFileDataset
from npairloss_tpu_torch.data.loader import (
    MultibatchLoader,
    NativeMultibatchLoader,
    PrefetchWorkerError,
    multibatch_loader,
)
from npairloss_tpu_torch.data.sampler import IdentityBalancedSampler
from npairloss_tpu_torch.data.synthetic import synthetic_identity_batches
from npairloss_tpu_torch.data.transforms import (
    apply_transform_param,
    augment,
    data_transformer,
)

__all__ = [
    "ArrayDataset",
    "ListFileDataset",
    "MultibatchLoader",
    "NativeMultibatchLoader",
    "PrefetchWorkerError",
    "multibatch_loader",
    "IdentityBalancedSampler",
    "synthetic_identity_batches",
    "apply_transform_param",
    "augment",
    "data_transformer",
]
