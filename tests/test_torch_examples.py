"""The four torch examples on the CPU: the quickstart and the torch-loop
mapper print the JAX examples' IIs (each pair run as scripts, in
subprocesses), the LM trainer exits 0 with finite losses, and the
portfolio mapper (slow: it walks full budgets on UNSAT IIs before the CDCL
fallback) maps every job."""
import math
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, *args, timeout=300, jax=False):
    # one torch thread for the CPU walk, as tests/test_torch_imports.py
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    if jax:
        env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, os.path.join(ROOT, "examples",
                                                       script), *args],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=timeout)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.splitlines()


def test_quickstart_gives_the_reference_ii():
    got = _run("quickstart_torch.py", "--device", "cpu")
    want = _run("quickstart.py", jax=True)

    def ii(lines):
        return [ln.split(" in ")[0] for ln in lines
                if ln.startswith("mapped at")]

    assert ii(got) == ii(want) == ["mapped at II=3 (MII=3)"]
    assert "simulator verification over 10 iterations: OK" in got
    # the same mapping tables
    assert got[got.index("simulator verification over 10 iterations: OK")
               - 1] == want[want.index(
                   "simulator verification over 10 iterations: OK") - 1]


def test_map_torch_loop_gives_the_reference_iis():
    got = _run("map_torch_loop.py", "--device", "cpu")
    want = _run("map_jax_loop.py", jax=True)

    def iis(lines):
        return [" ".join(ln.split()) for ln in lines if "II(" in ln]

    assert iis(got) == iis(want)
    assert len(iis(got)) == 3


def test_train_lm_torch_runs_with_finite_losses(tmp_path):
    lines = _run("train_lm_torch.py", "--steps", "2", "--device", "cpu",
                 "--ckpt-dir", str(tmp_path))
    losses = [float(ln.split("loss=")[1].split()[0]) for ln in lines
              if ln.startswith("step ")]
    assert len(losses) == 2 and all(map(math.isfinite, losses))
    assert os.listdir(tmp_path)            # the final checkpoint
    again = _run("train_lm_torch.py", "--steps", "3", "--device", "cpu",
                 "--ckpt-dir", str(tmp_path))
    assert "resumed from step 2" in again


@pytest.mark.slow
def test_portfolio_mapper_torch_maps_every_job():
    lines = _run("portfolio_mapper_torch.py", "--device", "cpu",
                 timeout=1800)
    mapped = [ln.split()[0] for ln in lines if " II=" in ln]
    assert mapped == ["srand", "bitcount", "gsm", "nw"]
