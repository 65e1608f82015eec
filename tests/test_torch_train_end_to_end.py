"""The port's twin of ``examples/train_end_to_end.py`` (``python -m repro_torch.launch.train_end_to_end``).

Its ~100M config holds every field of the example's ``build_100m_config``;
it runs the example's flags on the CPU; with ``--fail-at`` it restarts from
the checkpoint an SDS search finds and ends equal to the run that never
failed.  That last property is asserted in torch, as
``tests/test_torch_checkpoint.py::test_restart_equals_the_uninterrupted_run``
does: the example itself builds the reference's meshed Trainer, whose step
fails under this container's jax (ROADMAP.md queue 3), so it is no oracle.
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from repro_torch import convert
from repro_torch.configs import ModelConfig
from repro_torch.launch import train_end_to_end as e2e

LOSS_RTOL = 1e-5
# per parameter leaf, ||restarted - clean|| / ||clean||, chip_smoke.py's ckpt gate: at this size two runs on the
# CPU that never fail already differ by about 1e-8 of a leaf (threaded sums in the backward), so not bitwise
LEAF_REL = 1e-5
EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / "train_end_to_end.py"
# 6 steps of 2 x 64 tokens: the loss falls within the example's 20-step warmup; one save, at step 4
ARGV = ["--device", "cpu", "--steps", "6", "--seq-len", "64", "--global-batch", "2", "--ckpt-every", "4"]


def test_config_is_the_examples():
    spec = importlib.util.spec_from_file_location("train_end_to_end_example", EXAMPLE)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)   # defines build_100m_config; main() runs only as a script
    want, got = example.build_100m_config(), e2e.build_100m_config()
    for f in dataclasses.fields(ModelConfig):
        w, g = getattr(want, f.name), getattr(got, f.name)
        if f.name == "pattern":
            assert [(s.mixer, s.ffn) for s in g] == [(s.mixer, s.ffn) for s in w]
        elif f.name in ("moe", "mamba", "rwkv"):
            assert g is None and w is None, f.name
        else:
            assert g == w, f.name


def test_restart_from_the_sds_step_equals_the_uninterrupted_run(capsys):
    """--fail-at 5: the node failure before step 6 restores step 4, the one checkpoint an SDS search finds,
    replays steps 5-6 and ends on the run without a failure, the loss falling in both."""
    runs = {}
    for fail_at in (0, 5):
        out, trainer = e2e.run(e2e.parse_args(ARGV + ["--fail-at", str(fail_at)]))
        params = {p: t.detach().clone() for p, t in convert.flatten(trainer.state["params"]).items()}
        runs[fail_at] = (out, trainer.metrics_log, params)
        del trainer
    assert capsys.readouterr().out.count("model: gemma2-100m  params=100.7M") == 2
    (clean, clean_log, clean_params), (out, log, params) = runs[0], runs[5]
    assert clean["restarts"] == 0 and out["restarts"] == 1
    assert out["final_step"] == clean["final_step"] == 6
    assert out["ckpt_steps_discovered_via_sds"] == clean["ckpt_steps_discovered_via_sds"] == [4]
    events = [m for m in log if "event" in m]
    assert len(events) == 1 and events[0]["restored_step"] == 4 and events[0]["step"] == 4
    assert [m["step"] for m in log if "loss" in m] == [1, 2, 3, 4, 5, 5, 6]
    np.testing.assert_allclose([m["loss"] for m in log if "loss" in m][-2:], [m["loss"] for m in clean_log][-2:],
                               rtol=LOSS_RTOL)
    for path, t in params.items():
        ref = clean_params[path]
        assert (t - ref).norm() <= LEAF_REL * ref.norm(), path
    for result in (clean, out):
        assert result["last_loss"] < result["first_loss"]


def test_main_prints_the_examples_json_and_fails_unless_the_loss_fell(monkeypatch, capsys):
    """The example's keys: the Trainer's result, first and last loss, the steps SDS finds; then its check."""
    keys = ["final_step", "restarts", "wall_s", "final_loss", "first_loss", "last_loss",
            "ckpt_steps_discovered_via_sds"]
    fell = dict(zip(keys, [6, 1, 1.0, 9.9, 10.5, 9.9, [4]]))
    monkeypatch.setattr(e2e, "run", lambda args: (dict(fell), None))
    assert e2e.main(ARGV) == 0
    assert json.loads(capsys.readouterr().out) == fell
    monkeypatch.setattr(e2e, "run", lambda args: (dict(fell, last_loss=10.6), None))
    with pytest.raises(AssertionError, match="loss should decrease"):
        e2e.main(ARGV)
    assert list(json.loads(capsys.readouterr().out)) == keys
