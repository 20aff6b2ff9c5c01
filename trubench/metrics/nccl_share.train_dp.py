"""Device time of NCCL's kernels over all device time of the profiled
steps, on the rank where that share is highest."""

from trubench import readers

LAYER = "data parallelism"
UNIT = "%"
MOVES = "dp_train_audio_s_per_s"
WORKLOADS = ["proc16k-train-dp4"]


def read(reading: dict):
    return readers.nccl_share(reading)
