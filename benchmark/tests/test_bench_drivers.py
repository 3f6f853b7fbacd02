"""Each driver at a tiny size on the CPU against the reference, with the
run's harness look for a chip skipped: sound runs come out correct, the
control and each planted fault of the cell come out not correct."""

import math

import pytest
import torch

from benchmark import harness

from .conftest import tiny_cell

TRAINING = ["hand_r101.adapt_spd4", "hand_r101.adapt_spd1", "adain_vgg19.decoder_b4"]


def _run(cell, device):
    return harness.load_module("drivers", cell.traffic["driver"]).run(cell, device)


def _fails_a_limit(numbers, limits):
    """Whether one of the numbers read is over its limit (a number that
    the seed's draws do not give reads None)."""
    read = {k: numbers.get(k, math.inf) for k in limits}
    return any(v is not None and v > limits[k] for k, v in read.items())


def _failed(run):
    return [c["name"] for c in run["checks"] if not c["ok"]]


@pytest.mark.parametrize("name", TRAINING + ["hand_r101.serve_b256"])
def test_sound_run_is_correct(name, cpu, in_tmp):
    cell = tiny_cell(name, seconds=3.0, trace=True)
    run = _run(cell, cpu)
    assert run["correct"], run["checks"]
    assert run["attempted"] > 0 and run["window_s"] >= cell.seconds
    rate = next(iter(run["e2e"].values()))
    assert rate > 0
    assert run["trace"]["steps"] > 0 and run["trace"]["window_s"] > 0
    metrics = harness.per_layer(cell, run)
    # the CPU trace holds no device time: no device metric is read from it
    device = {m["name"] for m in cell.per_layer if m["source"] == "device_trace"}
    assert device and not device & set(metrics)


@pytest.mark.parametrize("name", TRAINING)
def test_state_left_unchanged_is_not_correct(name, cpu, in_tmp, monkeypatch):
    """A step that returns its state unchanged: every update of zero size."""
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    run = _run(tiny_cell(name), cpu)
    assert not run["correct"]
    assert "change_student" in _failed(run)


@pytest.mark.parametrize("name", TRAINING[:2])
def test_replays_left_unchanged_are_not_correct(name, cpu, in_tmp, monkeypatch):
    """Steps from the replay check's snapshot on that return their state
    unchanged, as a stale captured graph would: the start check passes, the
    replay check does not."""
    driver = harness.load_module("drivers", "adapt_epoch")
    stage = driver.replay_stage

    def stale_stage(*args):
        with monkeypatch.context() as m:
            m.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
            return stage(*args)

    monkeypatch.setattr(driver, "replay_stage", stale_stage)
    run = driver.run(tiny_cell(name), cpu)
    failed = _failed(run)
    assert "replay_change_student" in failed and "change_student" not in failed, failed


@pytest.mark.parametrize("name", TRAINING)
def test_half_batch_is_not_correct(name, cpu, in_tmp, monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    if name.startswith("hand_r101"):
        from uda_poseestimation_torch.parallel import train_step as ts

        mse, cons = ts.joints_mse_loss, ts.cons_loss
        monkeypatch.setattr(ts, "joints_mse_loss", lambda y, t, w: mse(
            y[: len(y) // 2], t[: len(t) // 2], w[: len(w) // 2]))
        monkeypatch.setattr(ts, "cons_loss", lambda s, t, tea_mask: cons(
            s[: len(s) // 2], t[: len(t) // 2], tea_mask=tea_mask[: len(tea_mask) // 2]))
    else:
        from uda_poseestimation_torch.models import style_net

        forward = style_net.StyleNet.forward
        monkeypatch.setattr(style_net.StyleNet, "forward", lambda self, c, s, alpha=1.0: forward(
            self, c[: len(c) // 2], s[: len(s) // 2], alpha))
    run = _run(tiny_cell(name), cpu)
    assert not run["correct"], run["checks"]


def test_altered_answer_is_not_correct(cpu, in_tmp, monkeypatch):
    """The serving artifact's argmax decode altered where it is produced."""
    from uda_poseestimation_torch.tools import export_inference as ei

    decode = ei.get_max_preds

    def shifted(heatmaps):
        preds, maxvals = decode(heatmaps)
        return (preds + 1.0) % heatmaps.shape[-1], maxvals

    monkeypatch.setattr(ei, "get_max_preds", shifted)
    run = _run(tiny_cell("hand_r101.serve_b256"), cpu)
    assert not run["correct"] and "pred" in _failed(run)


@pytest.mark.parametrize("name", TRAINING + ["hand_r101.serve_b256"])
def test_control_is_not_correct(name, cpu):
    """The reference one precision below the configuration's, in the
    program's place, fails one of the cell's limits (tiny size)."""
    cell = tiny_cell(name, float32=False)
    driver = harness.load_module("drivers", cell.traffic["driver"])
    numbers = driver.control_numbers(cell, 7, cpu, "control")
    assert _fails_a_limit(numbers, cell.limits["numbers"]), numbers


@pytest.mark.gpu
@pytest.mark.parametrize("name", TRAINING + ["hand_r101.serve_b256"])
def test_control_is_not_correct_on_card(name, cuda):
    """The same at the cell's own size on the card (PERF.md gives the
    readings this was measured at)."""
    cell = harness.load_cell(name)
    driver = harness.load_module("drivers", cell.traffic["driver"])
    for seed in (101, 102, 103):
        numbers = driver.control_numbers(cell, seed, cuda, "control")
        assert _fails_a_limit(numbers, cell.limits["numbers"]), numbers
