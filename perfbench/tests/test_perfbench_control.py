"""The comparison that decides ``correct`` fails the control and every
planted fault: the reference's assignment one precision below the
configuration's in the program's place, a choice altered where it is made,
half of each batch left out, and a step that returns its state unchanged.
(On the chip, ``perfbench/control.py`` runs the same at each cell's own
size.)"""
import pytest

from perfbench import control
from perfbench.tests.conftest import run_small, small

CASES = [(w, k) for w in ("offline_k16", "stream_k3")
         for k in control.BREAKS if (w, k) != ("stream_k3", "lowprec")]


@pytest.mark.parametrize("workload,kind", CASES)
def test_break_is_caught(workload, kind):
    cfg, tr = small(workload)
    with control.broken(tr["driver"], kind, cfg):
        res = run_small(workload, seconds=1.0, config=cfg, traffic=tr)
    assert res["correct"] is False
    bad = {k for k, c in res["checks"].items() if c["value"] != 0}
    assert bad - {"wcct_rel_gap"}


def test_stream_control_float32_is_caught():
    """float32 state for the stream's float64 assignment. It departs from
    float64 only on a long enough stream, at 32 ports as at 150 (where
    some seeds pass a 10 s window and fail a 45 s one); this stream, 250
    ticks of set-up, is one that does."""
    cfg, tr = small("stream_k3", warm_span=16000.0, block=48)
    cfg["N"] = 32
    with control.broken(tr["driver"], "lowprec", cfg):
        res = run_small("stream_k3", seed=2, seconds=0.2, config=cfg,
                        traffic=tr)
    assert res["correct"] is False
    assert res["checks"]["choice_diff"]["value"] > 0


def test_sound_runs_pass():
    for workload in ("offline_k16", "stream_k3"):
        assert run_small(workload, seconds=1.0)["correct"] is True
