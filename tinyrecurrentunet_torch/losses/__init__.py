"""Training losses of the port: MR-STFT, cosine similarity, the composite."""

from tinyrecurrentunet_torch.losses.composite import loss_fn, per_item_weights  # noqa: F401
from tinyrecurrentunet_torch.losses.cossim import cossim_loss  # noqa: F401
from tinyrecurrentunet_torch.losses.mrstft import MultiResolutionSTFTLoss  # noqa: F401
