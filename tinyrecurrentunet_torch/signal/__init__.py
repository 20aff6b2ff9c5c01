"""Signal core of the port: STFT, phase, PCEN and the featurizer."""

from tinyrecurrentunet_torch.signal.features import Featurizer  # noqa: F401
