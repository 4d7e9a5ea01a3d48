"""The port's training launcher (``launch/train.py``) on the CPU: a smoke
run on the local (1, 1) mesh whose loss falls and whose checkpoints land
at the expected steps, an in-process resume onto the mesh's placements,
the kill-and-resume drill (SIGKILL once step 20 is checkpointed, then the
same command resumes from the newest valid step and finishes), the mesh
the launcher picks, the flags that raise (``--multi-pod`` on a world that
is not 512 ranks; no card and no ``--device``), and the straggler
watchdog. Every subprocess has a timeout; the launcher closes the process
group it opens."""
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from torch.distributed.tensor import DTensor

from repro_torch import tree
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data.tokens import PRODUCER_THREAD
from repro_torch.launch import train

ROOT = Path(__file__).resolve().parents[1]
SMOKE = ["--arch", "qwen2-0.5b", "--smoke", "--device", "cpu"]


def _no_producer():
    return not any(t.name == PRODUCER_THREAD for t in threading.enumerate())


def test_smoke_run_learns_and_checkpoints(tmp_path, capsys):
    """12 steps (qat_w4a8 with ef8): the logged loss falls, checkpoints at
    5 and 10 and the final 11, of which keep=2 leaves 10 and 11; the
    final one restores with every digest verified and holds the last
    loss; the data thread is gone."""
    ck = tmp_path / "ck"
    args = train.main(SMOKE + ["--steps", "12", "--batch", "4", "--seq",
                               "64", "--lr", "3e-3", "--quant", "qat_w4a8",
                               "--grad-compression", "ef8", "--ckpt-every",
                               "5", "--ckpt-dir", str(ck)])
    out = capsys.readouterr().out
    assert [s for s, _, _ in args._log] == [0, 10, 11]
    losses = [f for _, f, _ in args._log]
    assert losses[-1] < losses[0]
    assert "done: first loss" in out and "[resume]" not in out
    mgr = CheckpointManager(str(ck))
    assert mgr.all_steps() == [10, 11]
    assert mgr.extra(11) == {"loss": losses[-1]}
    restored = mgr.restore(11, args._params, device="cpu")
    for a, b in zip(tree.leaves(restored),
                    tree.leaves(args._params)):
        assert torch.equal(a, b)
    assert _no_producer()
    assert not dist.is_initialized()


def test_smoke_resume_onto_the_local_mesh(tmp_path, capsys):
    """A 6-step run, then the same directory taken to 21 steps: the second
    run restores step 5 onto the mesh's placements and logs steps 10 and
    20 (its loss falls); a third run finds step 20 already
    checkpointed."""
    ck = str(tmp_path / "ck")
    flags = SMOKE + ["--batch", "2", "--seq", "32", "--lr", "3e-3",
                     "--ckpt-every", "5", "--ckpt-dir", ck]
    first = train.main(flags + ["--steps", "6"])
    capsys.readouterr()
    again = train.main(flags + ["--steps", "21"])
    out = capsys.readouterr().out
    assert f"[resume] restoring step 5 from {ck}" in out
    assert [s for s, _, _ in again._log] == [10, 20]
    assert all(not isinstance(p, DTensor)
               for p in tree.leaves(again._params))
    assert tree.leaves(first._params)[0].shape == \
        tree.leaves(again._params)[0].shape
    assert CheckpointManager(ck).all_steps() == [15, 20]
    done = train.main(flags + ["--steps", "21"])
    assert "already checkpointed" in capsys.readouterr().out
    assert done._log == []
    assert not dist.is_initialized()


def test_the_launcher_mesh(capsys):
    """One process, no ``--smoke``: the local mesh, announced; ``--smoke``:
    the same mesh, silently; the group is the launcher's to close."""
    dev = torch.device("cpu")
    try:
        mesh = train.launch_mesh(False, False, dev)
        assert "[mesh] local (1, 1)" in capsys.readouterr().out
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (1, 1)
        assert tuple(train.launch_mesh(True, False, dev).shape) == (1, 1)
        assert capsys.readouterr().out == ""
    finally:
        dist.destroy_process_group()


def _cmd(ck):
    return [sys.executable, "-m", "repro_torch.launch.train"] + SMOKE + [
        "--steps", "40", "--batch", "4", "--seq", "64", "--quant",
        "qat_w4a8", "--grad-compression", "ef8", "--ckpt-every", "10",
        "--spmd-timeout", "60", "--ckpt-dir", str(ck)]


def test_kill_and_resume(tmp_path):
    """SIGKILL once step 20 is checkpointed; the same command prints
    ``[resume] restoring step N`` with N the newest valid step, finishes,
    and leaves step 39 valid with no ``step_*.tmp.*`` orphan."""
    ck = tmp_path / "ck"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(_cmd(ck), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and proc.poll() is None:
            if ck.is_dir() and (CheckpointManager(str(ck)).latest_step()
                                or 0) >= 20:
                break
            time.sleep(0.02)
        assert proc.poll() is None, "the run ended before it was killed"
        proc.send_signal(signal.SIGKILL)
        assert proc.wait(timeout=30) == -signal.SIGKILL
    finally:
        proc.kill()
        proc.stdout.close()
    newest = CheckpointManager(str(ck)).latest_step()
    assert 20 <= newest < 39
    out = subprocess.run(_cmd(ck), env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert f"[resume] restoring step {newest} from" in out.stdout
    assert "done: first loss" in out.stdout
    mgr = CheckpointManager(str(ck))
    assert mgr.latest_step() == 39 and mgr.is_valid(39)
    assert not [p for p in os.listdir(ck) if ".tmp." in p]


def test_multi_pod_raises():
    """The two-pod mesh needs 512 ranks: one process raises, naming its
    world's size, and leaves no process group open."""
    with pytest.raises(RuntimeError, match="512 ranks.*a world of 1"):
        train.main(SMOKE + ["--multi-pod"])
    assert not dist.is_initialized()


def test_no_card_and_no_device_raises(monkeypatch, tmp_path):
    """Without ``--device`` the launcher takes the card; with none it
    raises rather than fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "qwen2-0.5b", "--smoke", "--steps", "1",
                    "--ckpt-dir", str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_straggler_watchdog():
    """A step that sleeps past the limit raises ``TimeoutError``; leaving
    the block disarms the timer and restores the previous handler, and 0
    arms nothing."""
    before = signal.getsignal(signal.SIGALRM)
    with pytest.raises(TimeoutError, match="straggler"):
        with train.StragglerWatchdog(0.05):
            time.sleep(1.0)
    assert signal.getitimer(signal.ITIMER_REAL) == (0.0, 0.0)
    with train.StragglerWatchdog(0.5):
        pass
    assert signal.getitimer(signal.ITIMER_REAL) == (0.0, 0.0)
    with train.StragglerWatchdog(0):
        assert signal.getitimer(signal.ITIMER_REAL) == (0.0, 0.0)
    assert signal.getsignal(signal.SIGALRM) == before
