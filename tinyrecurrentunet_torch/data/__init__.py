"""Data of the port: WAV I/O, noise augmentation, the DNS-style pair dataset,
the synthetic and procedural datasets and the batching loader."""

from tinyrecurrentunet_torch.data.dataset import (  # noqa: F401
    CleanNoisyPairDataset,
    SyntheticPairDataset,
    load_clean_noisy_dataloader,
)
from tinyrecurrentunet_torch.data.loader import DataLoader  # noqa: F401
from tinyrecurrentunet_torch.data.procgen import ProceduralSpeechDataset  # noqa: F401
