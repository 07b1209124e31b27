"""The port's launcher (``msr3d_tpu_torch/launch.py``) in its three modes,
as ``tests/test_launch_submitit.py`` drives the JAX package's:

* ``python``: the entry in this process;
* ``accelerate``: two CPU ranks of ``configs/debug_synthetic.yaml`` over
  the synthetic tree, with an eval split of odd length: one step, one
  ``results.json`` that scores every sample once, files written once, the
  ranks' parameters bit-equal; and a rank that fails ends the other;
* ``submitit``: a fake ``submitit`` (executor settings, each node's env
  contract) and the actionable exit without it.
"""

import json
import os
import re
import socket
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest

from msr3d_tpu_torch import launch
from msr3d_tpu_torch import run as port_run
from msr3d_tpu_torch.data import synthetic

REPO = Path(__file__).resolve().parent.parent
DEBUG = REPO / "configs" / "debug_synthetic.yaml"
LAUNCH_TIMEOUT_S = 300


def _launch(args, timeout=LAUNCH_TIMEOUT_S):
    env = dict(os.environ, OMP_NUM_THREADS="1", MSR3D_DIST_TIMEOUT_S="120")
    proc = subprocess.Popen([sys.executable, "-m", "msr3d_tpu_torch.launch", *args], cwd=REPO,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)  # the launcher and its ranks
        out, err = proc.communicate()
        raise AssertionError(f"the launcher ran past {timeout} s:\n{err[-3000:]}")
    return proc.returncode, out, err


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_python_mode_runs_the_entry_in_process(monkeypatch):
    calls = []
    monkeypatch.setattr(port_run, "main", lambda argv: calls.append(argv))
    assert launch.main(["--mode", "python", "--config", str(DEBUG), "device=cpu"]) == 0
    assert calls == [["--config", str(DEBUG), "device=cpu"]]


def test_rank_envs_follow_the_env_contract():
    envs = launch.rank_envs(node=1, num_nodes=2, per_node=3, addr="node-a", port=23456)
    assert [e["RANK"] for e in envs] == ["3", "4", "5"]
    assert [e["LOCAL_RANK"] for e in envs] == ["0", "1", "2"]
    assert {e["WORLD_SIZE"] for e in envs} == {"6"}
    assert {e["LOCAL_WORLD_SIZE"] for e in envs} == {"3"}
    assert {(e["MASTER_ADDR"], e["MASTER_PORT"]) for e in envs} == {("node-a", "23456")}


def test_accelerate_two_cpu_ranks_train_and_score_each_sample_once(tmp_path):
    root = synthetic.build_full_tree(tmp_path / "data", np.random.default_rng(7))
    exp = tmp_path / "exp"
    code, out, err = _launch([
        "--mode", "accelerate", "--num_processes", "2", "--port", str(_free_port()),
        "--config", str(DEBUG), "device=cpu", f"exp_dir={exp}",
        f"data.scan_family_base={root}/scan_family", f"data.rscan_base={root}/rscan",
        f"data.ARkit_base={root}/arkit", f"data.msr3d_base={root}/msr3d",
        "debug.debug_size=5", "solver.num_batch_eval=0", "task.msqa_scannet.mode=[val]"])
    assert code == 0, err[-3000:]
    summaries = sorted((json.loads(m) for m in re.findall(r"run summary (\{.*\})", out)),
                       key=lambda s: s["rank"])
    assert [(s["rank"], s["world"], s["backend"], s["device"]) for s in summaries] == [
        (0, 2, "gloo", "cpu"), (1, 2, "gloo", "cpu")]
    # 5 train samples: 2 a rank (the global tail dropped), one step of a
    # group of 1; the ranks end with bit-equal parameters, as each checks
    assert [s["steps"] for s in summaries] == [1, 1]
    digests = re.findall(r"agree across 2 ranks after training \(sha256 (\w+)\)", out)
    assert len(digests) == 2 and digests[0] == digests[1]
    # val of 5: 3 a rank, rank 1's last a duplicate dropped before the gather
    results = json.loads((exp / "eval" / "msqa_scannet" / "results.json").read_text())
    assert sorted(int(r["index"]) for r in results) == list(range(5))
    metrics = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()]
    assert [m["step"] for m in metrics if "train/loss" in m] == [1]
    assert sum(any(k.startswith("val/") for k in m) for m in metrics) == 1
    assert (exp / "config.yaml").exists() and (exp / "ckpt" / "latest.pt").exists()
    assert sorted(p.name for p in (exp / "ckpt" / "state").iterdir()) == ["1.pt"]


def test_accelerate_ends_the_ranks_when_one_fails(tmp_path):
    """Rank 0 cannot listen on a taken rendezvous port and fails; rank 1
    would wait on the rendezvous for its whole timeout. The launcher ends
    it and exits with rank 0's code."""
    with socket.socket() as taken:
        taken.bind(("127.0.0.1", 0))
        taken.listen(8)
        t0 = time.monotonic()
        code, _, err = _launch(["--mode", "accelerate", "--num_processes", "2", "--port",
                                str(taken.getsockname()[1]), "--config", str(DEBUG),
                                "device=cpu", f"exp_dir={tmp_path}"])
        took = time.monotonic() - t0
    assert code == 1 and "EADDRINUSE" in err
    assert took < 100, took  # well inside the ranks' 120 s group timeout


class _FakeJobEnvironment:
    hostnames = ["node-a", "node-b"]
    num_nodes = 2
    node = 1


class _FakeExecutor:
    instances = []

    def __init__(self, folder):
        self.folder, self.params, self.submitted = folder, None, []
        _FakeExecutor.instances.append(self)

    def update_parameters(self, **kw):
        self.params = kw

    def submit(self, fn, *a, **kw):
        self.submitted.append(fn)


def test_submitit_mode_spawns_each_nodes_ranks(monkeypatch, tmp_path):
    fake = types.ModuleType("submitit")
    fake.AutoExecutor, fake.JobEnvironment = _FakeExecutor, _FakeJobEnvironment
    monkeypatch.setitem(sys.modules, "submitit", fake)
    _FakeExecutor.instances.clear()
    spawned = []
    monkeypatch.setattr(launch, "run_ranks", lambda argv, envs: spawned.append((argv, envs))
                        or len(spawned) - 1)
    cfg = tmp_path / "c.yaml"
    cfg.write_text("name: x\n")
    assert launch.main(["--mode", "submitit", "--config", str(cfg), "--partition", "HGX",
                        "--num_nodes", "2", "--num_processes", "4", "--port", "23456",
                        "trainer=LeoTrainer"]) == 0
    (ex,) = _FakeExecutor.instances
    # the reference's SLURM settings, as the JAX launcher's
    assert ex.params["nodes"] == 2 and ex.params["tasks_per_node"] == 1
    assert ex.params["slurm_partition"] == "HGX"
    assert ex.params["slurm_max_num_timeout"] == 30 and ex.params["slurm_signal_delay_s"] == 120
    (job,) = ex.submitted
    job()  # node 1 of 2, 4 ranks a node
    argv, envs = spawned[0]
    assert argv == ["--config", str(cfg), "trainer=LeoTrainer"]
    assert [e["RANK"] for e in envs] == ["4", "5", "6", "7"]
    assert {(e["WORLD_SIZE"], e["MASTER_ADDR"], e["MASTER_PORT"]) for e in envs} == {
        ("8", "node-a", "23456")}
    with pytest.raises(SystemExit) as exc:
        job()  # the fake's second spawn "fails" with code 1
    assert exc.value.code == 1


def test_submitit_missing_is_actionable(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "submitit", None)
    with pytest.raises(SystemExit, match="submitit not installed"):
        launch.main(["--mode", "submitit", "--config", str(tmp_path / "c.yaml")])
