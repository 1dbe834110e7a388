"""The port's launchers on the CPU: the training launcher (gloo, one
process) for 3 steps with a checkpoint, a simulated host failure and the
restart from it, equal to the same 3 steps uninterrupted; the trace job
end to end over a reduced cell's dry run; the dry run's refusals; and
importing the launch and parallel modules starts no process group and
sets no environment variable."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import train, trace_training_job  # noqa: E402
from repro_torch.launch.dryrun import main as dryrun_main  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
ARGS = ["--arch", "granite-3-2b", "--reduced", "--device", "cpu",
        "--steps", "3", "--grad-accum", "2", "--global-batch", "4",
        "--seq", "32", "--log-every", "1"]


def test_launcher_restarts_from_its_checkpoint(tmp_path):
    """A failure after step 2's checkpoint restarts from step 2; steps 1
    to 3 equal an uninterrupted run's bit for bit."""
    torch.set_num_threads(1)
    broken = train.main(ARGS + ["--ckpt-dir", str(tmp_path), "--ckpt-every",
                                "1", "--fail-at-step", "2"])
    whole = train.main(ARGS)
    assert broken["restarts"] == 1 and broken["restored_from"] == [2]
    assert [s["step"] for s in broken["steps"]] == [1, 2, 3]
    assert [(s["loss"], s["grad_norm"]) for s in broken["steps"]] == \
        [(s["loss"], s["grad_norm"]) for s in whole["steps"]]
    assert broken["mesh"] == {"data": 1, "model": 1}
    assert broken["tokens_per_s"] > 0
    assert sorted(os.listdir(tmp_path / "rank_0")) == [
        "LATEST", "step_00000001", "step_00000002", "step_00000003"]


def test_trace_job_runs_end_to_end(tmp_path):
    """The reduced granite train cell's dry run on the two-pod mesh (a
    child process of 512 fake ranks), its DCN flows and their FIM under
    ECMP and static routing."""
    res = trace_training_job.main(["--reduced", "--out", str(tmp_path)])
    assert res["mesh"] == {"pod": 2, "data": 16, "model": 16}
    assert res["dcn_flows"] > 0 and res["dcn_bytes"] > 0
    assert res["host_pairs"] > 0
    assert 0.0 <= res["fim_static"] <= res["fim_ecmp"]
    assert (tmp_path / "multi" / "granite-3-2b__train_4k.json").exists()


@pytest.mark.parametrize("arch,shape,names", [
    ("deepseek-v2-lite-16b", "train_4k", "MLA"),
    ("mamba2-1.3b", "prefill_32k", "ssm"),
    ("granite-3-2b", "decode_32k", "decode"),
    ("jamba-1.5-large-398b", "long_500k", "decode"),
])
def test_dryrun_refuses_cells_outside_the_scope(arch, shape, names):
    with pytest.raises(NotImplementedError, match=names):
        dryrun_main(["--arch", arch, "--shape", shape])


def test_importing_launch_and_parallel_starts_nothing():
    """No process group and no environment variable from importing any
    module of ``repro_torch.launch`` or ``repro_torch.parallel`` (the
    reference's dry run sets ``XLA_FLAGS`` at import; the port's does it
    in ``main``)."""
    code = (
        "import importlib, os, pkgutil\n"
        "before = dict(os.environ)\n"
        "import repro_torch.launch, repro_torch.parallel\n"
        "names = []\n"
        "for pkg in (repro_torch.launch, repro_torch.parallel):\n"
        "    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "        importlib.import_module(m.name)\n"
        "        names.append(m.name)\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()\n"
        "assert dict(os.environ) == before\n"
        "print(' '.join(sorted(names)))\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout.split()
    assert {"repro_torch.launch.collectives", "repro_torch.launch.dryrun",
            "repro_torch.launch.flops", "repro_torch.launch.mesh",
            "repro_torch.launch.specs", "repro_torch.launch.train",
            "repro_torch.launch.trace_training_job",
            "repro_torch.parallel.sharding"} <= set(out)
