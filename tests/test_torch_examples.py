"""The port's examples (``examples/torch_*.py``) on the CPU, against the
reference's scripts (``examples/*.py``, run unchanged).

Each port script runs in-process with ``--device cpu`` on one torch
thread (``plan_circuits`` in a process of its own: it starts a fake
process group). Where the script is the numpy control plane, its outputs
must be the reference's bit for bit: ``quickstart`` part 1's weighted CCT,
makespan and each baseline's ratio (the reference's part 1 is run as it
stands in its script, up to its part 2, which trains with JAX); and for
``serve_fabric``, ``fault_recovery`` and ``observe_fabric``, every
coflow's CCT, the program of record array for array, the manager's
summary (wall-clock keys aside) and every printed line that reads no
clock. The model scripts draw their weights from torch's generator, not
JAX's, so their numbers are held to their own checks: a falling loss,
finite tokens of the right shape.
"""
from __future__ import annotations

import importlib.util
import json
import os
import runpy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as ref
from test_torch_service import assert_same_program, assert_same_summary

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"
#: printed lines that read the host clock
CLOCK_WORDS = ("latency", "total 0.", "summary: {", "throughput")


@pytest.fixture(autouse=True)
def one_thread():
    """The examples' tensors are small: one thread keeps a test's time its
    own when the suite runs tests side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_example(name: str, monkeypatch):
    """``examples/torch_<name>.py`` imported as a module (its sibling
    imports resolve), not run."""
    monkeypatch.syspath_prepend(str(EXAMPLES))
    path = EXAMPLES / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ref_example(name: str, capsys, monkeypatch, *args: str) -> tuple:
    """Run the reference's ``examples/<name>.py`` unchanged; returns its
    globals and its printed lines."""
    monkeypatch.setattr(sys, "argv", [str(EXAMPLES / f"{name}.py"), *args])
    capsys.readouterr()
    g = runpy.run_path(str(EXAMPLES / f"{name}.py"), run_name="__main__")
    return g, capsys.readouterr().out.splitlines()


def run_port(name: str, capsys, monkeypatch, *args: str) -> tuple:
    mod = port_example(name, monkeypatch)
    capsys.readouterr()
    out = mod.main([*args, "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert json.loads(lines[-1]).get("device", "cpu") == "cpu"
    return out, lines


def steady(lines: list[str]) -> list[str]:
    return [ln for ln in lines if not any(w in ln for w in CLOCK_WORDS)]


def test_quickstart_part1_equals_reference(capsys, monkeypatch):
    path = EXAMPLES / "quickstart.py"
    src = path.read_text(encoding="utf-8")
    g = {"__name__": "__main__"}
    capsys.readouterr()
    exec(compile(src[:src.index("# --- Part 2")], str(path), "exec"), g)
    ref_lines = capsys.readouterr().out.splitlines()
    out, lines = run_port("quickstart", capsys, monkeypatch)
    paper = [ln for ln in ref_lines if ln.startswith("[paper]")]
    assert len(paper) == 5
    assert [ln for ln in lines if ln.startswith("[paper]")] == paper
    want = g["schedule"]
    assert out["weighted_cct"] == want.total_weighted_cct
    assert out["makespan"] == float(want.ccts.max())
    for alg, ratio in out["ratios"].items():
        assert ratio == ref.run(g["inst"], alg).total_weighted_cct \
            / want.total_weighted_cct, alg
    assert out["loss_last"] < out["loss_first"]
    assert np.asarray(out["tokens"]).shape == (2, 8)


@pytest.mark.parametrize("name", ["serve_fabric", "fault_recovery",
                                  "observe_fabric"])
def test_stream_example_equals_reference(name, capsys, monkeypatch,
                                         tmp_path):
    args = (str(tmp_path / "ref"),) if name == "observe_fabric" else ()
    g, ref_lines = ref_example(name, capsys, monkeypatch, *args)
    args = (str(tmp_path / "port"),) if name == "observe_fabric" else ()
    out, lines = run_port(name, capsys, monkeypatch, *args)
    if name == "observe_fabric":
        ref_lines = [ln.replace(str(tmp_path / "ref"), str(tmp_path / "port"))
                     for ln in ref_lines]
    assert steady(lines[:-1]) == steady(ref_lines)
    rm, pm = g["mgr"], out["manager"]
    np.testing.assert_array_equal(pm.ccts().numpy(), rm.ccts())
    assert out["ccts"] == rm.ccts().tolist()
    assert_same_program(pm.program(), rm.program(), name)
    assert_same_summary(pm, rm)
    assert out["bytes_conserved"] and out["validated"]
    assert out["coflows_finalized"] == rm.summary()["coflows_finalized"]


def test_serve_batched_runs(capsys, monkeypatch):
    out, lines = run_port("serve_batched", capsys, monkeypatch)
    assert lines[0] == "arch=qwen1.5-0.5b (reduced) batch=4 prompt=32 gen=24"
    tokens = np.asarray(out["tokens"])
    assert tokens.shape == (4, 24)
    assert ((tokens >= 0) & (tokens < 512)).all()
    assert [f"  request {b}: {tokens[b].tolist()}" for b in range(4)] == \
        lines[3:7]
    assert out["prefill_s"] > 0 and out["decode_s_per_step"] > 0


def test_train_e2e_small_loss_falls(capsys, monkeypatch, tmp_path):
    out, lines = run_port("train_e2e", capsys, monkeypatch, "--small",
                          "--steps", "12", "--ckpt-dir", str(tmp_path))
    assert lines[0] == ("model: 6L d=256 vocab=8192 -> 8.9M params; 12 steps "
                        "of 4x256 tokens")
    assert out == json.loads(lines[-1])
    assert out["steps"] == 12 and out["params_m"] == 8.9
    assert out["last10_loss"] < out["first10_loss"]


def test_plan_circuits_in_its_own_process():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, str(EXAMPLES / "torch_plan_circuits.py"), "--device",
         "cpu"], capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["blocks"] == 4 and out["coflows"] > 0
    assert out["inter_block_mb"] > 0
    assert sum(out["collectives"].values()) > 0
    wcct = out["weighted_cct"]
    assert set(wcct) == set(ref.ALGORITHMS)
    assert all(v > 0 for v in wcct.values())
