"""Native host runtime bindings (C++ ring buffers, WAV IO, stream host)."""

from tinyrecurrentunet_torch.runtime.native import (  # noqa: F401
    NativeLib,
    RingBuffer,
    StreamHost,
    load_native,
    native_available,
)
