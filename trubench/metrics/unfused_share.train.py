"""Device time of elementwise, reduction and copy kernels
(`trace.KERNEL_KINDS`) over all device time of the profiled steps."""

from trubench import readers

LAYER = "model, losses, signal"
UNIT = "%"
MOVES = "train_audio_s_per_s"
WORKLOADS = ["proc16k-train-bf16"]


def read(reading: dict):
    return readers.device_share(reading, readers.trace.UNFUSED_KINDS)
