"""The training CLI's `--data_parallel` as users start it, on the CPU.

The JAX package's flag trains over a mesh of every local device, at a
global batch of batch_size_per_device x devices. The port's CLI, with no
launcher around it, starts a rank per local card itself (`parallel.launch`;
`main(argv, local_ranks=N)` sets the count, as XLA's host device count does
for the JAX package on the CPU). Four jobs of the tiny config of
tests/test_torch_train.py (2 clips of 0.25 s a rank, 8 synthetic items,
`--max_iters 3`, the final checkpoint at iteration 2) run side by side, each
within its own time limit and leaving no process behind:

- the launcher: two gloo ranks on the CPU (`local_ranks=2`);
- the same command under `python -m torch.distributed.run --nproc_per_node 2`;
- two "hosts" through `cfg.dist` (coordinator on localhost, num_processes
  2, process_id 0 and 1), one rank each;
- the launcher with a rank that raises in `train()`.

Every job that trains exits 0, logs 2 ranks and a global batch of 4, and
writes a final checkpoint bit-equal to the launcher's; the launcher's first
logged loss terms agree with the JAX step over a 2-device CPU mesh on the
same global batch (the ranks' loader shards stacked rank-major) within 1e-5
relative, grad_norm within test_torch_parallel.py's 2e-3. The failing job
exits non-zero well within its limit, naming the rank. In this process:
train() destroys a process group it made and leaves a caller's; the CLI on
the CPU is a group of one in its own process; a launcher's WORLD_SIZE=1
without data_parallel makes no group; hosts that would start different
rank counts refuse before starting any.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist
from _torch_cli import checkpoint_tensors, cli_env, kill_job, start_job, wait_gone
from test_torch_parallel import LOSS_RTOL, NORM_RTOL, _free_port, jax_mesh_step_on
from test_torch_train import CLIP_SEC, SR, _config, _jax_loader_batches

from tinyrecurrentunet_torch import config as tconfig
from tinyrecurrentunet_torch import parallel
from tinyrecurrentunet_torch.data import SyntheticPairDataset as TSynthetic
from tinyrecurrentunet_torch.train import loop as tloop
from tinyrecurrentunet_torch.utils.metrics import MetricsWriter
from tinyrecurrentunet_tpu.data import SyntheticPairDataset as JSynthetic

torch.set_num_threads(2)

ITEMS = 8
ITERS = 3
TIMEOUT = 150  # seconds each job may take
CLI = ["-m", "tinyrecurrentunet_torch.train.loop", "--synthetic", "--synthetic_items", str(ITEMS),
       "--max_iters", str(ITERS), "--device", "cpu", "--data_parallel"]


def _write_config(path, **dist_fields):
    cfg = dataclasses.replace(_config(tconfig, "ckpt"), dist=tconfig.DistConfig(**dist_fields))
    path.write_text(json.dumps(tconfig.config_to_dict(cfg)))
    return str(path)


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """{name: {"rc", "out", "dir"}} of the four jobs (module docstring)."""
    root = tmp_path_factory.mktemp("dp_cli")
    env = cli_env(root)
    port = _free_port()
    specs = {
        "launcher": [[sys.executable, "-c", "import sys; from tinyrecurrentunet_torch.train import loop; "
                      "loop.main(sys.argv[1:], local_ranks=2)", *CLI[2:], "-c", "tiny.json"]],
        "torchrun": [[sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
                      *CLI, "-c", "tiny.json"]],
        "hosts": [[sys.executable, *CLI, "-c", f"host{h}.json"] for h in range(2)],
        "failing": [[sys.executable, "-c", "import sys, _torch_cli; from tinyrecurrentunet_torch import parallel; "
                     "from tinyrecurrentunet_torch.config import DistConfig; parallel.launch("
                     "_torch_cli.fail_on_rank_one, ('tiny.json', 'logs'), DistConfig(), 'cpu', 2)"]],
    }
    procs = {}
    for name, argvs in specs.items():
        workdir = root / name
        workdir.mkdir()
        _write_config(workdir / "tiny.json")
        for h in range(2):
            _write_config(workdir / f"host{h}.json", coordinator_address=f"127.0.0.1:{port}", num_processes=2,
                          process_id=h)
        procs[name] = [(start_job(argv, workdir, env, workdir / f"out{i}.log"), workdir / f"out{i}.log")
                       for i, argv in enumerate(argvs)]
    results = {}
    try:
        for name, started in procs.items():
            codes = []
            for proc, _ in started:
                try:
                    codes.append(proc.wait(timeout=TIMEOUT))
                except subprocess.TimeoutExpired:
                    codes.append(None)  # still running at the limit
            results[name] = {"rc": codes, "dir": root / name, "gone": [wait_gone(p.pid) for p, _ in started],
                             "out": "".join(path.read_text() for _, path in started)}
    finally:
        for started in procs.values():
            for proc, _ in started:
                kill_job(proc)
    return results


def _final_checkpoint(job):
    return job["dir"] / "ckpt" / "TRUNet" / "checkpoint" / f"{ITERS - 1}.pt"


@pytest.mark.parametrize("name", ["launcher", "torchrun", "hosts"])
def test_every_rank_exits_and_the_global_batch_is_the_ranks(jobs, name):
    """Exit 0 within the limit, no process left; rank 0 logs 2 ranks over
    gloo and a global batch of 2 x batch_size_per_device, trains 3
    iterations and saves the last; process 0 alone announces checkpoints;
    each rank prints its end once."""
    job = jobs[name]
    assert job["rc"] == [0] * len(job["rc"]) and all(job["gone"]), job["out"][-4000:]
    assert job["out"].count("data parallel: 2 ranks over gloo, 2 clips a rank, global batch 4") == 1, job["out"]
    assert re.findall(r"^iteration: (\d+)", job["out"], re.M) == ["0", "1", "2"]
    assert job["out"].count(f"model at iteration {ITERS - 1} is saved") == 1
    assert [job["out"].count(f"rank {r} ended") for r in range(2)] == [1, 1], job["out"][-4000:]
    assert os.listdir(_final_checkpoint(job).parent) == [_final_checkpoint(job).name]


@pytest.mark.parametrize("other", ["torchrun", "hosts"])
def test_final_checkpoint_is_bit_equal_to_the_launchers(jobs, other):
    """torchrun's ranks and cfg.dist's hosts train the launcher's run: the
    same parameters, statistics and optimizer state, bit for bit."""
    want = checkpoint_tensors(_final_checkpoint(jobs["launcher"]))
    got = checkpoint_tensors(_final_checkpoint(jobs[other]))
    assert got.keys() == want.keys() and len(want) > 10
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_first_logged_loss_matches_the_jax_mesh_step(jobs):
    """The launcher's iteration 0 against the JAX step over a 2-device mesh
    on the global batch the two ranks read: rank r's batch is the JAX
    loader's shard r (test_torch_parallel.py), stacked rank-major."""
    shards = [_jax_loader_batches(JSynthetic(ITEMS, CLIP_SEC, SR), 1, batch_size=2, shuffle=True, drop_last=True,
                                  seed=0, num_shards=2, shard_index=r)[0] for r in range(2)]
    want = jax_mesh_step_on(tuple(np.concatenate([s[k] for s in shards]) for k in (0, 1)))["metrics"]
    with open(jobs["launcher"]["dir"] / "ckpt" / "TRUNet" / "logs" / "metrics.jsonl") as f:
        first = json.loads(f.readline())
    assert first["step"] == 0
    terms = {k[len("Train/loss-"):]: v for k, v in first.items() if k.startswith("Train/loss-")}
    assert terms.keys() | {"loss", "grad_norm"} == want.keys()
    np.testing.assert_allclose(first["Train/Train-Loss"], want["loss"], rtol=LOSS_RTOL)
    for name, value in terms.items():
        np.testing.assert_allclose(value, want[name], rtol=LOSS_RTOL, err_msg=name)
    np.testing.assert_allclose(first["Train/Gradient-Norm"], want["grad_norm"], rtol=NORM_RTOL["jax_mesh_step"])


def test_a_rank_that_raises_ends_the_job(jobs):
    """Rank 1 raises at its first batch while rank 0 waits in the step's
    first collective: the launcher ends rank 0 and exits non-zero, naming
    rank 1, long before any collective's timeout; no process is left."""
    job = jobs["failing"]
    assert job["rc"][0] not in (0, None) and all(job["gone"]), job["out"][-4000:]
    assert "rank 1 cannot read its shard" in job["out"] and "rank 1 exited with 1" in job["out"], job["out"][-4000:]


@pytest.fixture
def jsonl_metrics(monkeypatch):
    monkeypatch.setattr(tloop, "MetricsWriter", lambda *a, **k: MetricsWriter(*a, use_tensorboard=False, **k))


@pytest.mark.parametrize("owner", ["train", "caller"])
def test_train_destroys_only_a_group_it_made(tmp_path, monkeypatch, jsonl_metrics, owner):
    """A group of one that train() joins from a launcher's environment is
    destroyed when it returns; a group the caller made is left alone."""
    if owner == "train":
        for key, value in (("WORLD_SIZE", "1"), ("RANK", "0"), ("LOCAL_RANK", "0"),
                           ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", str(_free_port()))):
            monkeypatch.setenv(key, value)
    else:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1, rank=0)
    try:
        state, metrics = tloop.train(_config(tconfig, tmp_path / "ckpt"), TSynthetic(4, CLIP_SEC, SR), max_iters=1,
                                     log_dir=str(tmp_path / "logs"), device="cpu", data_parallel=True)
        assert np.isfinite(metrics["loss"])
        assert dist.is_initialized() == (owner == "caller")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_a_launchers_group_of_one_is_joined_only_under_data_parallel(tmp_path, monkeypatch, jsonl_metrics, capsys):
    """WORLD_SIZE=1 in the environment (torchrun --nproc_per_node 1, a
    scheduler that exports it) with no rendezvous and no data_parallel:
    train() makes no group and trains as one process."""
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    for key in ("MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    made = []
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **k: made.append((a, k)))
    state, metrics = tloop.train(_config(tconfig, tmp_path / "ckpt"), TSynthetic(4, CLIP_SEC, SR), max_iters=1,
                                 log_dir=str(tmp_path / "logs"), device="cpu")
    assert np.isfinite(metrics["loss"]) and not made and not dist.is_initialized()
    assert "data parallel:" not in capsys.readouterr().out


def test_cli_on_the_cpu_is_a_group_of_one_in_its_own_process(tmp_path, monkeypatch, jsonl_metrics, capsys):
    """`--data_parallel --device cpu` with no launcher: one rank, this
    process, in a gloo group of one it leaves destroyed, the environment as
    it was."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    path = _write_config(tmp_path / "tiny.json")
    state, metrics = tloop.main(["-c", path, "--synthetic", "--synthetic_items", "4", "--max_iters", "1",
                                 "--device", "cpu", "--data_parallel"])
    assert np.isfinite(metrics["loss"]) and state.step == 1
    assert "data parallel: 1 ranks over gloo, 2 clips a rank, global batch 2" in capsys.readouterr().out
    assert not dist.is_initialized() and "WORLD_SIZE" not in os.environ and "MASTER_PORT" not in os.environ


def test_local_rank_count(monkeypatch):
    """One per visible card for a bare cuda, one on the CPU or a card named
    by index, or as asked; never more NCCL ranks than cards."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert parallel.local_rank_count("cuda") == 4
    assert parallel.local_rank_count("cuda:1") == 1
    assert parallel.local_rank_count("cpu") == 1
    assert parallel.local_rank_count("cpu", 3) == 3
    assert parallel.local_rank_count("cuda", 2) == 2
    for device, requested in (("cuda", 5), ("cpu", 0)):
        with pytest.raises(ValueError, match="local ranks"):
            parallel.local_rank_count(device, requested)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no card"):
        parallel.local_rank_count("cuda")


def test_hosts_with_different_rank_counts_refuse_to_start():
    """Two hosts of cfg.dist, one asking for 1 local rank and one for 2:
    both raise through the coordinator's store, and no rank starts."""
    port = _free_port()
    called, errors = [], {}

    def host(h):
        cfg = tconfig.DistConfig(coordinator_address=f"127.0.0.1:{port}", num_processes=2, process_id=h)
        try:
            parallel.launch(called.append, (h,), cfg, "cpu", h + 1)
        except RuntimeError as e:
            errors[h] = str(e)

    threads = [threading.Thread(target=host, args=(h,)) for h in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not called and sorted(errors) == [0, 1], errors
    assert all("every host must start as many ranks; by process_id: [1, 2]" in e for e in errors.values())
