"""The port's training launcher (``repro_torch.launch.train``) on the CPU:
the reference launcher's flags and cadence — the step lines, a coded-parity
snapshot every ``--coded-every`` steps, a checkpoint every ``--ckpt-every``
steps and at the end, and a resume from the latest one — with states held bit
for bit. A mesh runs under torchrun (tests/test_torch_mesh.py): here, one
whose size is not the world's, or with ``--coded-every``, is refused."""

import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.launch.train import main as train_main
from repro_torch.train import latest_step, restore_checkpoint

SMOKE = ["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu", "--batch", "2", "--seq", "16"]


def same_bits(a, b) -> bool:
    la, lb = tree.leaves(a), tree.leaves(b)
    return tree.structure(a) == tree.structure(b) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x.reshape(-1).view(torch.uint8),
                                                                  y.reshape(-1).view(torch.uint8))
        for x, y in zip(la, lb))


def test_launcher_trains_snapshots_checkpoints_and_resumes(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    run = train_main(SMOKE + ["--steps", "3", "--coded-every", "1", "--ckpt", ck, "--profile", "baseline"])
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "step     2 loss" in out and "done: 3 steps in" in out
    assert [h["step"] for h in run["history"]] == [0, 1, 2] and run["start"] == 0
    assert all(np.isfinite(h["loss"]) and h["grad_norm"] > 0 for h in run["history"])
    state = run["state"]
    assert int(state["opt"]["step"]) == 3 and all(t.device.type == "cpu" for t in tree.leaves(state))
    # the guard holds the parity of the last snapshot (after step 2) and rebuilds it without 3 replicas
    guard = run["guard"]
    assert guard.K == 8 and guard.step == 2
    recovered, at = guard.fail_and_recover([1, 4, 6])
    assert at == 2 and same_bits(recovered, state)
    # the final checkpoint, labelled with --steps, in the reference's format
    assert latest_step(ck) == 3 and sorted(os.listdir(ck)) == ["manifest.json", "state_00000003.npz"]
    with open(os.path.join(ck, "manifest.json")) as f:
        assert json.load(f)["format"] == "logical-full-v1"
    restored, step = restore_checkpoint(ck, state, device="cpu")
    assert step == 3 and same_bits(restored, state)
    # a second run resumes from it
    run2 = train_main(SMOKE + ["--steps", "5", "--coded-every", "0", "--ckpt", ck, "--ckpt-every", "4"])
    out = capsys.readouterr().out
    assert "restored checkpoint at step 3" in out and "done: 2 steps in" in out
    assert run2["start"] == 3 and [h["step"] for h in run2["history"]] == [3, 4]
    assert run2["guard"].step == -1  # --coded-every 0: no snapshot
    assert int(run2["state"]["opt"]["step"]) == 5
    assert sorted(os.listdir(ck)) == ["manifest.json", "state_00000003.npz", "state_00000004.npz",
                                      "state_00000005.npz"]


def test_launcher_is_deterministic():
    a = train_main(SMOKE + ["--steps", "2", "--coded-every", "0"])
    b = train_main(SMOKE + ["--steps", "2", "--coded-every", "0"])
    assert [h["loss"] for h in a["history"]] == [h["loss"] for h in b["history"]]
    assert same_bits(a["state"], b["state"])


@pytest.mark.parametrize("mesh", ["2x1", "1x4"])
def test_launcher_refuses_a_mesh(mesh, capsys, tmp_path):
    """A mesh is refused only for want of ranks, with ``--coded-every`` set
    (the default 25) as without it, as the reference's launcher refuses a
    mesh only for want of devices (tests/test_torch_coded_mesh.py trains
    --mesh 2x2 --coded-every 1 on four ranks); a mesh whose size is not the
    world's is refused naming both sizes (here a world of one rank;
    tests/test_torch_mesh.py runs meshes of four)."""
    n = int(np.prod([int(x) for x in mesh.split("x")]))
    with pytest.raises(SystemExit):
        train_main(SMOKE + ["--mesh", mesh])
    err = capsys.readouterr().err
    assert f"needs {n} ranks: run it under torchrun --nproc-per-node {n}" in err and "ROADMAP" not in err
    with pytest.raises(SystemExit):
        train_main(SMOKE + ["--mesh", mesh, "--coded-every", "0"])
    assert f"needs {n} ranks: run it under torchrun --nproc-per-node {n}" in capsys.readouterr().err
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0, world_size=1)
    try:
        with pytest.raises(SystemExit):
            train_main(SMOKE + ["--mesh", mesh, "--coded-every", "0"])
    finally:
        dist.destroy_process_group()
    assert f"--mesh {mesh} holds {n} ranks; the world has 1" in capsys.readouterr().err
