"""The port's examples (``examples/*_torch.py``) and
``tools/trace_encode_torch.py`` on the CPU with ``--device cpu`` at small
arguments, against the reference's scripts where those print the same
thing. The planner and the quickstart (the port's and the reference's) run
in this process, JAX on the CPU; the rest in child processes.

* ``topology_planner_torch`` prints the reference example's output, byte
  for byte, for the same arguments (it plans on the host);
* ``quickstart_torch`` prints the reference's algorithm, C1 and C2 lines
  and its DFT line, and holds its encode against the host oracle;
* ``coded_checkpoint_recovery_torch`` recovers 1, 4 and 8 lost replicas and
  the whole state bit for bit (its own asserts);
* ``serve_lm_torch`` serves the trace on both engines;
* ``train_lm_torch --smoke --steps 2 --batch 2 --seq 64 --fail-at 1
  --coded-every 1`` recovers the snapshot bit for bit (``--smoke``: at the
  example's ~110M parameters the coded guard alone takes minutes on the CPU;
  ``chip_smoke.py`` runs it at that size on the card);
* ``trace_encode_torch`` writes traces that the unchanged
  ``tools/check_trace.py`` accepts, and a metrics snapshot with its rounds.
"""

import json
import os
import runpy
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(*argv, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, *argv], capture_output=True, text=True, env=env, cwd=REPO, timeout=timeout)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return r.stdout


def run_here(path, argv, monkeypatch, capsys) -> str:
    """Run a script in this process (JAX is on the CPU here), its stdout."""
    monkeypatch.setattr(sys, "argv", [path, *argv])
    capsys.readouterr()
    runpy.run_path(os.path.join(REPO, path), run_name="__main__")
    return capsys.readouterr().out


@pytest.mark.parametrize("args", [
    "--K 16 --topology two-level --intra 4",
    "--K 32 --topology hierarchy --levels 4,4,2 --emit-ir",
    "--K 16 --topology torus --intra 4 --generator dft --pipeline remap-digits",
])
def test_topology_planner_prints_the_reference_table(args, monkeypatch, capsys):
    mine = run_here("examples/topology_planner_torch.py", args.split(), monkeypatch, capsys)
    ref = run_here("examples/topology_planner.py", args.split(), monkeypatch, capsys)
    assert mine == ref
    assert "chosen:" in mine


def test_quickstart_prints_the_reference_lines(monkeypatch, capsys):
    mine = run_here("examples/quickstart_torch.py", ["--device", "cpu"], monkeypatch, capsys).splitlines()
    ref = run_here("examples/quickstart.py", [], monkeypatch, capsys).splitlines()
    keys = ("algorithm", "rounds C1", "elements C2", "DFT butterfly")
    pick = lambda lines: [line for line in lines if line.startswith(keys)]
    assert pick(mine) == pick(ref) and len(pick(mine)) == 4
    modelled = next(line for line in mine if line.startswith("modelled time"))
    assert "not measured on this card" in modelled and "v5e" not in modelled


def test_coded_checkpoint_recovery_example():
    out = run("examples/coded_checkpoint_recovery_torch.py", "--device", "cpu")
    assert out.count("recovered bit-exact=True") == 3
    assert "full state reassembly: bit-exact" in out
    assert "C1=4 rounds, C2=6 elements/port" in out


def test_serve_lm_example():
    out = run("examples/serve_lm_torch.py", "--device", "cpu")
    assert out.startswith("continuous: 8 requests")
    assert "fixed batch of 4:" in out and "sampled variant differs: True" in out


def test_train_lm_example_recovers_bit_exactly(tmp_path):
    out = run("examples/train_lm_torch.py", "--smoke", "--device", "cpu", "--steps", "2", "--batch", "2",
              "--seq", "64", "--fail-at", "1", "--coded-every", "1", "--ckpt", str(tmp_path / "ckpt"))
    assert "recovered bit-exactly from snapshot at step 1" in out
    assert out.count("coded parity snapshot") == 2
    assert os.listdir(tmp_path / "ckpt")


def test_trace_encode_torch_passes_check_trace(tmp_path):
    prefix = str(tmp_path / "encode")
    out = run("tools/trace_encode_torch.py", "--device", "cpu", "--out", prefix, "--drift")
    assert "traced 3 comm rounds" in out and "Per-round drift" in out
    for suffix in (".trace.json", ".jsonl"):
        assert run("tools/check_trace.py", prefix + suffix).startswith("OK ")
    with open(prefix + ".metrics.json") as fh:
        metrics = json.load(fh)
    assert metrics["encode.rounds"]["value"] == 6  # warm-up and traced call, 3 rounds each
