"""Helpers of the tests that run the port's training in processes of their
own (tests/test_torch_dp_cli.py, tests/test_torch_preemption.py).

- `cli_env(tmp)`: the environment of such a process: the repository and
  this directory on PYTHONPATH, one OpenMP thread, no launcher variables,
  and TensorFlow hidden (a module of that name that raises ImportError, so
  TensorBoard's writer takes its own stub, as where TensorFlow is not
  installed: where it is, its import costs seconds in every process).
- `start_job`: a job in a session of its own, `kill_job` it whole,
  `wait_gone` until no process of it is left.
- `fail_on_rank_one`: a `parallel.launch` target whose rank 1 raises in
  `train()` while rank 0 waits in the step's first collective.
"""

from __future__ import annotations

import os
import signal
import subprocess
import time

import numpy as np

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
LAUNCHER_VARIABLES = ("RANK", "LOCAL_RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                      "TORCHELASTIC_USE_AGENT_STORE")


def cli_env(tmp) -> dict:
    shim = os.path.join(str(tmp), "no_tensorflow")
    os.makedirs(shim, exist_ok=True)
    with open(os.path.join(shim, "tensorflow.py"), "w") as f:
        f.write('raise ImportError("TensorFlow is hidden from this process")\n')
    env = {k: v for k, v in os.environ.items() if k not in LAUNCHER_VARIABLES}
    env.update(PYTHONPATH=os.pathsep.join((shim, REPO, TESTS)), OMP_NUM_THREADS="1")
    return env


def wait_gone(pgid: int, timeout: float = 10.0) -> bool:
    """Whether every process of the process group `pgid` is gone within
    `timeout` seconds."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            os.killpg(pgid, 0)
        except ProcessLookupError:
            return True
        time.sleep(0.05)
    return False


def kill_job(proc: subprocess.Popen):
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


def start_job(argv: list, cwd, env: dict, log_path) -> subprocess.Popen:
    """A job in a session of its own (`kill_job` ends every process of it),
    its output written to `log_path`."""
    with open(log_path, "w") as out:  # the job writes to its own copy of the file descriptor
        return subprocess.Popen(argv, cwd=str(cwd), env=env, stdout=out, stderr=subprocess.STDOUT, text=True,
                                start_new_session=True)


def fail_on_rank_one(cfg_path: str, log_dir: str):
    """train() over the launcher's group on a synthetic set whose items rank
    1 cannot read: rank 1 raises at its first batch, before the step's
    first collective, where rank 0 waits."""
    import torch.distributed as dist

    from tinyrecurrentunet_torch.config import load_config
    from tinyrecurrentunet_torch.data import SyntheticPairDataset
    from tinyrecurrentunet_torch.train.loop import train

    class Unreadable(SyntheticPairDataset):
        def get(self, index, rng=None):
            if dist.get_rank() == 1:
                raise RuntimeError("rank 1 cannot read its shard")
            return super().get(index, rng)

    cfg = load_config(cfg_path)
    train(cfg, Unreadable(8, cfg.trainset.crop_length_sec, cfg.trainset.sample_rate), max_iters=3,
          log_dir=log_dir, device="cpu", data_parallel=True)


def checkpoint_tensors(path) -> dict:
    """The tensors of a checkpoint of the port, by name, as numpy arrays."""
    import torch

    payload = torch.load(path, map_location="cpu", weights_only=True)
    out = {f"model/{k}": v.numpy() for k, v in payload["model"].items()}
    for index, state in payload["optimizer"]["state"].items():
        out.update({f"optimizer/{index}/{k}": np.asarray(v) for k, v in state.items()})
    out["updates"] = np.asarray(payload["updates"])
    out["iter"] = np.asarray(payload["iter"])
    return out
