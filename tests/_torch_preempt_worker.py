"""Worker of tests/test_torch_preemption.py: a small training job of the
port whose dataset sleeps a while an item, so that the test can SIGKILL it
after its first checkpoint, then run it again to its end, resumed from the
latest checkpoint.

    python tests/_torch_preempt_worker.py <workdir> <seconds an item> <ranks>

One rank trains in this process (`train()`); two or more train as gloo
ranks on the CPU that `parallel.launch` starts, as the CLI's
`--data_parallel` starts them (`main(argv, local_ranks=N)`). 30
iterations at 2 clips of 0.25 s a rank, the tiny network, metrics every 5
iterations into <workdir>/logs, checkpoints every 10 into
<workdir>/preempt/checkpoint (and the last at iteration 29). Prints DONE at
the end.
"""

import sys
import time

from tinyrecurrentunet_torch import config as c
from tinyrecurrentunet_torch import parallel
from tinyrecurrentunet_torch.data import SyntheticPairDataset
from tinyrecurrentunet_torch.train.loop import train

TINY = dict(
    encoder=((8, 5, 2), (16, 3, 1), (16, 5, 2), (16, 3, 2)),
    fgru_hidden=8, fgru_out=8, tgru_hidden=16, tgru_out=8,
    decoder=((8, 3, 2), (8, 5, 2), (8, 3, 1), (8, 5, 2)),
)


class SlowDataset(SyntheticPairDataset):
    """Items that take `delay` seconds each. Not device-cacheable: the
    corpus on the device would make every item before step 0 and pace
    nothing."""

    device_cacheable = False

    def __init__(self, delay: float, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.delay = delay

    def get(self, index, rng=None):
        time.sleep(self.delay)
        return super().get(index, rng)


def config(workdir: str) -> c.Config:
    return c.Config(
        network=c.NetworkConfig(**TINY),
        featurizer=c.FeaturizerConfig(sample_rate=16000),
        train=c.TrainConfig(
            exp_path="preempt",
            log=c.LogConfig(directory=workdir, iters_per_ckpt=10, iters_per_valid=5),
            optimization=c.OptimizationConfig(n_iters=30, batch_size_per_device=2),
            loss_config=c.LossConfig(stft_config=c.STFTLossConfig(fft_sizes=(512,), hop_sizes=(120,),
                                                                  win_lengths=(240,))),
        ),
        trainset=c.TrainsetConfig(sample_rate=16000, crop_length_sec=0.25),
    )


def run(workdir: str, delay: float, data_parallel: bool):
    cfg = config(workdir)
    train(cfg, dataset=SlowDataset(delay, num_items=8, length_sec=0.25, sample_rate=16000),
          log_dir=f"{workdir}/logs", device="cpu", data_parallel=data_parallel)


def main():
    workdir, delay, ranks = sys.argv[1], float(sys.argv[2]), int(sys.argv[3])
    if ranks == 1:
        run(workdir, delay, False)
    else:
        parallel.launch(run, (workdir, delay, True), config(workdir).dist, "cpu", ranks)
    print("DONE", flush=True)


if __name__ == "__main__":
    main()
