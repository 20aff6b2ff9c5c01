"""TRU-Net model of the port."""

from tinyrecurrentunet_torch.models.trunet import TRUNet  # noqa: F401
