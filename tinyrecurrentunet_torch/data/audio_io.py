"""WAV read/write (host-side), replacing torchaudio.load / scipy wavwrite
usage in the reference (reference `dataset.py:358-359`, `denoise.py:92-95`).

`torchaudio.load(normalize=True)` semantics: integer PCM is scaled to
[-1, 1] float32; float WAVs pass through.
"""

from __future__ import annotations

import numpy as np
from scipy.io import wavfile

_INT_SCALE = {
    np.dtype(np.int16): 32768.0,
    np.dtype(np.int32): 2147483648.0,
    np.dtype(np.uint8): 128.0,
}


def read_wav(path: str, normalize: bool = True):
    """Returns (audio float32 (L,) or (C, L), sample_rate)."""
    sr, data = wavfile.read(path)
    if data.ndim == 2:
        data = data.T  # (C, L) like torchaudio
    if normalize and data.dtype in _INT_SCALE:
        scale = _INT_SCALE[data.dtype]
        if data.dtype == np.uint8:
            data = (data.astype(np.float32) - 128.0) / scale
        else:
            data = data.astype(np.float32) / scale
    else:
        data = data.astype(np.float32)
    return data, int(sr)


def write_wav(path: str, audio: np.ndarray, sample_rate: int):
    """Write float32 audio in [-1, 1] as 16-bit PCM."""
    audio = np.asarray(audio, np.float32)
    clipped = np.clip(audio, -1.0, 1.0)
    wavfile.write(path, sample_rate, (clipped * 32767.0).astype(np.int16))
