"""tinyrecurrentunet_torch — the TRU-Net speech denoiser in PyTorch for CUDA.

The port of the JAX package (`tinyrecurrentunet_tpu/`, the reference) to
PyTorch on an NVIDIA H100. It imports torch, numpy and scipy, never jax and
nothing of the JAX package. Public functions keep the JAX package's layouts: specs are
(..., T, F), features (..., T, F, C), the model's input and output
(B, T, F, C).

- `config`: the same JSON schema as the JAX package.
- `weights`: reads `pretrained.npz` and converts it into the model's
  `state_dict`.
- `signal/`: STFT/iSTFT, phase unwrap, PCEN and the featurizer.
- `ops/`: the plain PyTorch GRU, the hand-written CUDA recurrence kernel
  (`ops/csrc/gru_fwd.cu`) and its wrapper, conv helpers, the kernel build.
- `models/`: TRUNet blocks, the network and the PHM head.
- `infer/`: the offline `Denoiser` and its CLI (`denoise.py`), the
  streaming denoisers (`streaming.py`, `multistream.py`), the stream CLI
  (`stream.py`) and the wall-clock soak (`soak.py`).
- `runtime/`: ctypes bindings of the C++ stream host under `cpp/`, built at
  first use into `build/trunet_host/`.
- `data/`, `losses/`, `train/`: datasets, losses and float32 training.

Entry points run on `cuda` unless the caller asks for `cpu`; asked for
`cuda` without a card they raise.
"""

__version__ = "0.1.0"

from tinyrecurrentunet_torch.config import Config, load_config  # noqa: F401
