"""Inference of the port: offline denoise, streaming, multi-stream."""

from tinyrecurrentunet_torch.infer.denoise import Denoiser  # noqa: F401
from tinyrecurrentunet_torch.infer.streaming import (  # noqa: F401
    StreamingDenoiser,
    StreamState,
)
