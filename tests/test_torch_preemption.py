"""Preemption recovery of the port, counterpart of tests/test_preemption.py.

A training job of the port (tests/_torch_preempt_worker.py: 30 iterations,
a checkpoint every 10, metrics every 5, a dataset that sleeps 50 ms an
item) is SIGKILLed after its first checkpoint is committed (the renamed
`<iteration>.pt`, polled for, not waited for), then started again with no
delay. The restart must print `resumed from checkpoint at iteration k`, k
at least the killed job's latest checkpoint, land its last checkpoint at
iteration 29, and the steps of metrics.jsonl must cover the schedule, in
order, across both lifetimes (the writer appends). As one process, and as
two gloo ranks (`parallel.launch`), where the whole job, launcher and
ranks, is killed at once and no process of it may outlive the kill. The
two jobs run side by side.
"""

import json
import os
import re
import signal
import sys
import time

import pytest
import torch
from _torch_cli import TESTS, cli_env, kill_job, start_job, wait_gone

torch.set_num_threads(2)

WORKER = os.path.join(TESTS, "_torch_preempt_worker.py")
DELAY = 0.05  # seconds an item in the killed lifetime
TIMEOUT = 150  # seconds for both lifetimes of both jobs
RANKS = (1, 2)


def _committed(ckpt_dir) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(re.compile(r"^(\d+)\.pt$").match, os.listdir(ckpt_dir)) if m)


@pytest.fixture(scope="module")
def preempted(tmp_path_factory):
    """Both jobs' two lifetimes: {ranks: record}."""
    root = tmp_path_factory.mktemp("preempt")
    env = cli_env(root)
    jobs = {}
    for ranks in RANKS:
        workdir = str(root / f"ranks{ranks}")
        os.makedirs(workdir)
        log = os.path.join(workdir, "first.log")
        jobs[ranks] = {"workdir": workdir, "ckpt_dir": os.path.join(workdir, "preempt", "checkpoint"),
                       "first_log": log, "second_log": os.path.join(workdir, "second.log"), "lifetime": 1,
                       "proc": start_job([sys.executable, WORKER, workdir, str(DELAY), str(ranks)], root, env, log)}
    deadline = time.time() + TIMEOUT
    try:
        while any(job["lifetime"] < 3 for job in jobs.values()):
            assert time.time() < deadline, f"the jobs did not end within {TIMEOUT} s"
            for ranks, job in jobs.items():
                proc = job["proc"]
                if job["lifetime"] == 1 and _committed(job["ckpt_dir"]):
                    os.killpg(proc.pid, signal.SIGKILL)
                    proc.wait()
                    job["gone_after_kill"] = wait_gone(proc.pid)
                    job["killed_at"] = _committed(job["ckpt_dir"])
                    job["lifetime"] = 2
                    job["proc"] = start_job([sys.executable, WORKER, job["workdir"], "0", str(ranks)], root, env,
                                            job["second_log"])
                elif job["lifetime"] == 1 and proc.poll() is not None:
                    job["lifetime"] = 3  # ended before any checkpoint: the test says so
                elif job["lifetime"] == 2 and proc.poll() is not None:
                    job["rc"] = proc.returncode
                    job["gone_at_end"] = wait_gone(proc.pid)
                    job["lifetime"] = 3
            time.sleep(0.02)
    finally:
        for job in jobs.values():
            kill_job(job["proc"])
    for job in jobs.values():
        for key in ("first_log", "second_log"):
            job[key] = open(job[key]).read() if os.path.exists(job[key]) else ""
    return jobs


@pytest.mark.parametrize("ranks", RANKS, ids=["one_process", "two_gloo_ranks"])
def test_sigkill_then_resume_completes(preempted, ranks):
    job = preempted[ranks]
    out1, out2 = job["first_log"], job["second_log"]
    assert "killed_at" in job, f"the job ended before any checkpoint: {out1[-3000:]}"
    assert job["gone_after_kill"], "a process of the killed job outlived the kill"
    assert "DONE" not in out1, "the job finished before the kill: nothing was preempted"
    killed_at = job["killed_at"]
    assert killed_at and killed_at[0] >= 10, killed_at

    # the second lifetime: resumed, to the end, every process gone
    assert job["rc"] == 0 and "DONE" in out2 and job["gone_at_end"], out2[-3000:]
    resumed = [int(line.rsplit(" ", 1)[-1]) for line in out2.splitlines()
               if line.startswith("resumed from checkpoint at iteration")]
    assert len(resumed) == 1 and resumed[0] >= max(killed_at), (resumed, killed_at)
    assert max(_committed(job["ckpt_dir"])) == 29, _committed(job["ckpt_dir"])
    if ranks > 1:
        assert "data parallel: 2 ranks over gloo, 2 clips a rank, global batch 4" in out2, out2[-3000:]

    with open(os.path.join(job["workdir"], "logs", "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    steps = [r["step"] for r in records]
    assert set(steps) == {0, 5, 10, 15, 20, 25}, steps
    assert steps == sorted(steps), steps  # the restart appended, from (not before) its checkpoint
    times = [r["time"] for r in records]
    assert all(b >= a for a, b in zip(times, times[1:]))
