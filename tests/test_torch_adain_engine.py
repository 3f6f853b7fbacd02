"""The port's AdaIN decoder pretraining (``uda_poseestimation_torch.
adain_engine`` and ``adain/train_human.py``) against the JAX package's
(``uda_poseestimation_tpu/adain_engine.py``, ``adain/train/train_human.py``).

- One decoder step with SGD injected on both sides (``optimizer=`` here,
  ``tx=optax.sgd`` there), elementwise: the update is linear in the
  gradient. One step with the default Adam, in norm: Adam's first update
  is ~sign(g)·lr, so a gradient entry near 0 may flip its sign between two
  float32 implementations (tests/test_adain_composed_parity.py says the
  same).
- The encoder is frozen: it gets no gradient and no change, and only the
  stylized image's re-encode records an autograd graph.
- ``run_decoder_training`` on injected iterators, the same
  ``np.random.seed``, vgg file and initial decoder (JAX's
  ``StyleNet.init(PRNGKey(0))``): the same swap decisions, log lines of the
  same format, PNGs at the same iterations with byte-equal content and
  style thirds, checkpoints at the same iterations with the same keys,
  which load through the JAX package's ``load_style_net_params`` and the
  port's ``load_style_net_files``.
- The loop's spans (``utils/trace.py``), under the profiler: one
  ``decoder.fetch`` and ``decoder.step`` an iteration, the flush's
  ``decoder.log`` and the checkpoint's ``decoder.save``, none inside
  another (on the CPU no readback waits: ``decoder.readback`` is the card's).
- The step's CUDA graph (``DecoderStepGraph``): on the CPU every iteration
  runs eagerly, with no warm-up, capture or replay span; what a graph holds
  (``_held``) moves with the learning rate and an optimizer restore, not
  with a step or a decoder restore; and, marked ``gpu``, the loop graphed
  on the card (3 eager warm-ups, a capture, 9 replays) against the same
  loop with every iteration eager from the same weights, batches and numpy
  seed: the log lines, PNGs and trained decoder equal bit for bit, and a
  replay after the learning rate moved raises.
- The CLI's parser has every flag and default of JAX's, plus ``--device``
  and the trainers' ``--dist-*`` flags;
  ``main`` runs on tiny fake RHD and H3D trees with ``--device cpu``, and
  without a card it raises unless ``--device cpu`` is given.

The StyleNet weights of the step tests are JAX's, with the decoder's last
kernel scaled by 100 (``test_torch_style_net.style_params``): a random
decoder's output is ~1e-3 and its style losses eps-dominated.

Tolerance (float32, XLA's against ATen's CPU convolutions; measured
margins in parentheses): losses 1e-4 relative (1e-7); the SGD update
within 1e-4 of each tensor's largest entry (5e-6); the Adam update within
5e-3 in norm (4e-4); ``run_decoder_training``'s logged losses 2e-5
relative over 6 Adam steps (2e-6), the checkpoint's decoder update within
1e-3 in norm (4e-5); the PNG's stylized third within one grey level (a
truncation to uint8).

JAX is imported inside the tests that use it, so that the card test runs
where only PyTorch is installed (``-m gpu --noconftest``).
"""

import argparse
import copy
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from tools.make_fixtures import make_rhd
from uda_poseestimation_torch import adain_engine as tengine
from uda_poseestimation_torch import weights
from uda_poseestimation_torch.adain import train_human as tcli
from uda_poseestimation_torch.models import StyleNet
from uda_poseestimation_torch.utils import trace

REPO = Path(__file__).resolve().parents[1]
SIZE = 32


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _images(seed=7, b=2):
    rng = np.random.RandomState(seed)
    return (rng.rand(b, SIZE, SIZE, 3).astype(np.float32),
            rng.rand(b, SIZE, SIZE, 3).astype(np.float32))


@pytest.fixture(scope="module")
def params():
    from test_torch_style_net import style_params

    return style_params()


@pytest.fixture(scope="module")
def h3d_root(tmp_path_factory):
    from test_torch_human_datasets import write_h3d

    return write_h3d(tmp_path_factory.mktemp("h3d"))


def _jax_step(params, tx, content, style):
    import jax

    from uda_poseestimation_tpu import adain_engine as jengine

    step, tx = jengine.make_decoder_step(1.0, 2.0, 1e-3, tx=tx)
    dec, _, loss, loss_c, loss_s, g_t = step(params["decoder"], tx.init(params["decoder"]),
                                             params["encoder"], content, style)
    return weights.decoder_state_dict(jax.device_get(dec)), (loss, loss_c, loss_s)


def _port_step(params, optimizer=None, lr=1e-3):
    net = weights.load_style_net(StyleNet("meanstd"), params)
    if optimizer is not None:
        optimizer = optimizer(net.decoder.parameters(), lr=lr)
    step, _ = tengine.make_decoder_step(net, 1.0, 2.0, lr, optimizer=optimizer)
    return net, step


def _updates(new, old):
    return {k: np.asarray(new[k]) - np.asarray(old[k]) for k in old}


def test_sgd_decoder_step_matches_jax(params):
    import optax

    content, style = _images()
    want_dec, want_losses = _jax_step(params, optax.sgd(1e-1), content, style)
    net, step = _port_step(params, torch.optim.SGD, lr=1e-1)
    old = weights.decoder_state_dict(params["decoder"])
    loss, loss_c, loss_s, g_t = step(_nchw(content), _nchw(style))
    assert g_t.shape == (2, 3, SIZE, SIZE) and not g_t.requires_grad
    np.testing.assert_allclose([float(loss), float(loss_c), float(loss_s)],
                               [float(x) for x in want_losses], rtol=1e-4)
    np.testing.assert_allclose(float(loss), float(loss_c) + float(loss_s), rtol=1e-6)
    got = _updates({k: v.numpy() for k, v in net.decoder.state_dict().items()}, old)
    want = _updates(want_dec, old)
    for k in want:
        err, scale = np.abs(got[k] - want[k]).max(), np.abs(want[k]).max()
        assert scale > 0 and err <= 1e-4 * scale, (k, err, scale)


def test_adam_decoder_step_matches_jax_in_norm(params):
    content, style = _images(seed=8)
    want_dec, want_losses = _jax_step(params, None, content, style)
    net, step = _port_step(params)
    old = weights.decoder_state_dict(params["decoder"])
    losses = step(_nchw(content), _nchw(style))[:3]
    np.testing.assert_allclose([float(x) for x in losses],
                               [float(x) for x in want_losses], rtol=1e-4)
    got = _updates({k: v.numpy() for k, v in net.decoder.state_dict().items()}, old)
    want = _updates(want_dec, old)
    diff = np.sqrt(sum(np.sum((got[k] - want[k]) ** 2) for k in want))
    norm = np.sqrt(sum(np.sum(want[k] ** 2) for k in want))
    assert diff <= 5e-3 * norm, (diff, norm)


def test_encoder_receives_no_gradient(params):
    net, step = _port_step(params, torch.optim.SGD)
    before = {k: v.clone() for k, v in net.encoder.state_dict().items()}
    graphs = []
    net.encoder[0].register_forward_hook(lambda m, i, out: graphs.append(out.requires_grad))
    content, style = _images(seed=9)
    step(_nchw(content), _nchw(style))
    # style, content, then the stylized image's re-encode
    assert graphs == [False, False, True]
    for k, p in net.encoder.named_parameters():
        assert not p.requires_grad and p.grad is None, k
        assert torch.equal(p, before[k]), k
    assert all(p.grad is not None for p in net.decoder.parameters())


def _batches(seed):
    """Source-like and target-like tuples, as the loaders give them:
    ``src[0]`` is the image batch, ``tgt[4][0]`` the first teacher view."""
    rng = np.random.RandomState(seed)
    while True:
        img = rng.rand(2, SIZE, SIZE, 3).astype(np.float32)
        yield (img, None, None, {}, [img.copy()], None, None, [{}])


def _decoder_training(run, tmp_path, monkeypatch, name, **kwargs):
    """One package's ``run_decoder_training`` under ``tmp_path/name``:
    returns its swap draws and the iterations at which it saved."""
    draws, saves = [], []
    rand, save = np.random.rand, torch.save

    def spy_rand():
        draws.append(rand())
        return draws[-1]

    def spy_save(obj, path, *a, **k):
        saves.append(len(draws))
        return save(obj, path, *a, **k)

    os.makedirs(tmp_path / name)
    monkeypatch.chdir(tmp_path / name)
    monkeypatch.setattr(np.random, "rand", spy_rand)
    monkeypatch.setattr(torch, "save", spy_save)
    np.random.seed(0)
    args = argparse.Namespace(
        exp_name="e2e", save_model_dir="ckpt", vgg=str(tmp_path / "vgg_normalised.pth"),
        image_size=SIZE, content_weight=1.0, style_weight=1.0, lr=1e-4,
        max_iter=6, log_img_interval=2, save_model_interval=4)
    try:
        run(args, _batches(1), _batches(2), denormalize=tcli.denormalize, **kwargs)
    finally:
        monkeypatch.setattr(np.random, "rand", rand)
        monkeypatch.setattr(torch, "save", save)
    return [d > 0.5 for d in draws], saves


def test_run_decoder_training_matches_jax(params, tmp_path, monkeypatch):
    import jax
    import jax.numpy as jnp

    from tools.port_torch_weights import load_style_net_params
    from uda_poseestimation_tpu import adain_engine as jengine
    from uda_poseestimation_tpu.models import StyleNet as JStyleNet

    vgg = tmp_path / "vgg_normalised.pth"
    torch.save({k: torch.tensor(v) for k, v in
                weights.vgg_state_dict(params["encoder"]).items()}, str(vgg))
    # the JAX engine's initial decoder (adain_engine.py:117-119)
    jstyle = JStyleNet(style_loss_kind="meanstd")
    dummy = jnp.zeros((1, SIZE, SIZE, 3), jnp.float32)
    dec0 = weights.decoder_state_dict(jax.device_get(
        jax.jit(lambda r: jstyle.init(r, dummy, dummy))(jax.random.PRNGKey(0))
        ["params"]["decoder"]))
    want_swaps, want_saves = _decoder_training(jengine.run_decoder_training, tmp_path,
                                               monkeypatch, "jax", mesh=None)
    got_swaps, got_saves = _decoder_training(
        tengine.run_decoder_training, tmp_path, monkeypatch, "torch",
        decoder_state={k: torch.tensor(v) for k, v in dec0.items()}, device="cpu")
    assert got_swaps == want_swaps and len(set(got_swaps)) == 2, got_swaps
    assert got_saves == want_saves == [4, 6]

    line = re.compile(r"^iter: (\d+), decoder_loss: (\S+), content loss: (\S+), "
                      r"style loss: (\S+)$")
    logs = [(tmp_path / side / "logs/e2e/log_e2e.txt").read_text().splitlines()
            for side in ("torch", "jax")]
    assert len(logs[0]) == len(logs[1]) == 6
    for i, (got, want) in enumerate(zip(*logs)):
        got_m, want_m = line.match(got), line.match(want)
        assert got_m and want_m and int(got_m[1]) == int(want_m[1]) == i, (got, want)
        np.testing.assert_allclose([float(x) for x in got_m.groups()[1:]],
                                   [float(x) for x in want_m.groups()[1:]], rtol=2e-5)

    pngs = "logs/e2e/save_imgs/save_img_e2e"
    assert sorted(os.listdir(tmp_path / "torch" / pngs)) == \
        sorted(os.listdir(tmp_path / "jax" / pngs)) == ["0.png", "2.png", "4.png"]
    for name in ("0.png", "2.png", "4.png"):
        got, want = (np.asarray(Image.open(tmp_path / side / pngs / name))
                     for side in ("torch", "jax"))
        assert got.shape == want.shape == (SIZE, 3 * SIZE, 3)
        np.testing.assert_array_equal(got[:, SIZE:], want[:, SIZE:])
        assert np.abs(got[:, :SIZE].astype(int) - want[:, :SIZE]).max() <= 1

    ckpts = [tmp_path / side / "logs/e2e/ckpt/decoder_e2e.pth.tar" for side in ("torch", "jax")]
    got, want = (torch.load(str(p), map_location="cpu", weights_only=True) for p in ckpts)
    assert list(got) == list(want) == list(StyleNet().decoder.state_dict())
    assert all(v.dtype == torch.float32 and v.device.type == "cpu" for v in got.values())
    upd = _updates({k: v.numpy() for k, v in got.items()}, dec0)
    ref = _updates({k: v.numpy() for k, v in want.items()}, dec0)
    diff = np.sqrt(sum(np.sum((upd[k] - ref[k]) ** 2) for k in ref))
    assert diff <= 1e-3 * np.sqrt(sum(np.sum(ref[k] ** 2) for k in ref))

    # the port's checkpoint loads through both packages' style-file readers
    jparams = load_style_net_params(str(vgg), str(ckpts[0]))
    for k, v in weights.decoder_state_dict(jparams["decoder"]).items():
        np.testing.assert_array_equal(v, got[k].numpy(), err_msg=k)
    tstyle = weights.load_style_net_files(StyleNet(), str(vgg), str(ckpts[0]))
    for k, v in tstyle.decoder.state_dict().items():
        assert torch.equal(v, got[k]), k


def test_decoder_loop_spans_lie_side_by_side(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = argparse.Namespace(exp_name="t", save_model_dir="ckpt", vgg=None, lr=1e-4,
                              content_weight=1.0, style_weight=1.0, max_iter=3,
                              log_img_interval=2, save_model_interval=2)
    np.random.seed(0)
    t0 = time.perf_counter_ns()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tengine.run_decoder_training(args, _batches(1), _batches(2), lambda x: x,
                                     device="cpu")
    events = prof.profiler.kineto_results.events()
    spans = sorted(((e.name(), e.start_ns(), e.end_ns()) for e in events
                    if e.name().startswith("decoder.")), key=lambda e: e[1])
    assert [s[0] for s in spans] == [
        "decoder.fetch", "decoder.step", "decoder.fetch", "decoder.step", "decoder.log",
        "decoder.save", "decoder.fetch", "decoder.step", "decoder.log", "decoder.save",
        "decoder.log"]
    assert all(a[2] <= b[1] for a, b in zip(spans, spans[1:]))  # none inside another
    counts = {n: c for n, (c, _) in trace.counters(t0).items()}
    assert {n: counts[n] for n in ("decoder.fetch", "decoder.step", "decoder.log",
                                   "decoder.save")} == \
        {"decoder.fetch": 3, "decoder.step": 3, "decoder.log": 3, "decoder.save": 2}
    assert os.path.exists("logs/t/ckpt/decoder_t.pth.tar")


def test_decoder_loop_never_captures_on_the_cpu(tmp_path, monkeypatch):
    """On the CPU the step wrapper runs every iteration eagerly: it counts
    ``max_iter`` eager steps, and the loop opens no warm-up, capture or
    replay span."""
    monkeypatch.chdir(tmp_path)
    args = argparse.Namespace(exp_name="t", save_model_dir="ckpt", vgg=None, lr=1e-4,
                              content_weight=1.0, style_weight=1.0, max_iter=4,
                              log_img_interval=2, save_model_interval=10)
    np.random.seed(0)
    t0 = time.perf_counter_ns()
    step = tengine.run_decoder_training(args, _batches(1), _batches(2), lambda x: x,
                                        device="cpu")
    assert not step.graphed
    assert (step.eager_steps, step.captures, step.replays) == (4, 0, 0)
    counts = trace.counters(t0)
    assert counts["decoder.step"][0] == 4
    assert not {"decoder.warm_up", "decoder.capture", "decoder.replay"} & set(counts)
    assert len(open("logs/t/log_t.txt").read().splitlines()) == 4


def test_held_sees_what_the_decoder_graph_holds():
    """What a captured decoder step holds moves with the learning rate, a
    hyper-parameter and an optimizer restore (which replaces Adam's state
    tensors), and not with a step's in-place update or a decoder restore's
    copy into its parameters."""
    net = StyleNet("meanstd")
    net.reset_parameters(torch.Generator().manual_seed(3))
    step, optimizer = tengine.make_decoder_step(net, 1.0, 1.0, 1e-4)
    content, style = (_nchw(x) for x in _images(seed=10))
    step(content, style)
    first = tengine._held(optimizer)
    step(content, style)
    assert tengine._held(optimizer) == first
    net.decoder.load_state_dict(copy.deepcopy(net.decoder.state_dict()))
    assert tengine._held(optimizer) == first
    optimizer.param_groups[0]["lr"] = 2e-4
    assert tengine._held(optimizer) != first
    optimizer.param_groups[0]["lr"] = 1e-4
    optimizer.param_groups[0]["betas"] = (0.8, 0.999)
    assert tengine._held(optimizer) != first
    optimizer.param_groups[0]["betas"] = (0.9, 0.999)
    assert tengine._held(optimizer) == first
    optimizer.load_state_dict(copy.deepcopy(optimizer.state_dict()))
    assert tengine._held(optimizer) != first


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    return torch.device("cuda")


def _pinned_batches(seed, b=4, size=64):
    """NHWC float32 batches in page-locked memory, as the card's loaders
    give them."""
    rng = np.random.RandomState(seed)
    while True:
        yield torch.from_numpy(rng.rand(b, size, size, 3).astype(np.float32)).pin_memory()


def _card_run(root, monkeypatch, warm_up, vgg, decoder_state):
    """``run_decoder_training`` on the card for 12 iterations under
    ``root``, with ``WARM_UP_STEPS`` at ``warm_up``, under deterministic
    cuDNN (TF32 on, PyTorch's default); returns the step wrapper and the
    run's span counts."""
    monkeypatch.setattr(tengine, "WARM_UP_STEPS", warm_up)
    os.makedirs(root)
    monkeypatch.chdir(root)
    np.random.seed(0)
    args = argparse.Namespace(exp_name="g", save_model_dir="ckpt", vgg=vgg, lr=1e-4,
                              content_weight=1.0, style_weight=1.0, max_iter=12,
                              log_img_interval=5, save_model_interval=100)
    t0 = time.perf_counter_ns()
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=True):
        step = tengine.run_decoder_training(
            args, _pinned_batches(1), _pinned_batches(2), tcli.denormalize,
            get_target_view=lambda t: t, get_source_image=lambda s: s,
            decoder_state=decoder_state, device="cuda")
        torch.cuda.synchronize()
    return step, {n: c for n, (c, _) in trace.counters(t0).items()}


@pytest.mark.gpu
def test_graphed_decoder_loop_matches_eager_loop_on_card(cuda, tmp_path, monkeypatch):
    """The loop on the card replays its step from one CUDA graph after 3
    eager warm-ups: its log lines, the PNGs of iterations 0, 5 and 10 (5
    and 10 replays) and the decoder after 12 iterations equal bit for bit
    those of the same loop with every iteration eager (the same kernels and
    the same capturable Adam). A replay after the learning rate moved
    raises, as does a batch of another shape."""
    style = StyleNet("meanstd")
    style.reset_parameters(torch.Generator().manual_seed(4))
    with torch.no_grad():  # a random decoder's output is ~1e-3 (module docstring)
        style.decoder[-1].weight.mul_(100.0)
    vgg = str(tmp_path / "vgg.pth")
    torch.save(style.encoder.state_dict(), vgg)
    dec = style.decoder.state_dict()
    graphed, counts = _card_run(tmp_path / "graphed", monkeypatch, 3, vgg, dec)
    eager, eager_counts = _card_run(tmp_path / "eager", monkeypatch, 12, vgg, dec)

    assert graphed.graphed and eager.graphed
    assert (graphed.eager_steps, graphed.captures, graphed.replays) == (3, 1, 9)
    assert (eager.eager_steps, eager.captures, eager.replays) == (12, 0, 0)
    assert {n: counts.get(n) for n in ("decoder.step", "decoder.warm_up", "decoder.capture",
                                       "decoder.replay")} == \
        {"decoder.step": 12, "decoder.warm_up": 3, "decoder.capture": 1, "decoder.replay": 9}
    assert eager_counts["decoder.warm_up"] == 12 and "decoder.replay" not in eager_counts

    logs = [(tmp_path / side / "logs/g/log_g.txt").read_text().splitlines()
            for side in ("graphed", "eager")]
    assert len(logs[0]) == 12 and logs[0] == logs[1]
    pngs = "logs/g/save_imgs/save_img_g"
    assert sorted(os.listdir(tmp_path / "graphed" / pngs)) == ["0.png", "10.png", "5.png"]
    for name in ("0.png", "5.png", "10.png"):
        assert (tmp_path / "graphed" / pngs / name).read_bytes() == \
            (tmp_path / "eager" / pngs / name).read_bytes(), name
    got, want = (torch.load(str(tmp_path / side / "logs/g/ckpt/decoder_g.pth.tar"),
                            weights_only=True) for side in ("graphed", "eager"))
    assert list(got) == list(dec)
    for k in dec:
        assert torch.equal(got[k], want[k]), k
        assert not torch.equal(got[k], dec[k].cpu()), k  # the decoder trained

    monkeypatch.setattr(tengine, "WARM_UP_STEPS", 3)  # the graphed run's
    batch = next(_pinned_batches(3))
    graphed._optimizer.param_groups[0]["lr"] = 2e-4
    with pytest.raises(RuntimeError, match="at its capture"):
        graphed(batch, batch)
    graphed._optimizer.param_groups[0]["lr"] = 1e-4
    with pytest.raises(ValueError, match="static batches"):
        graphed(batch[:2], batch[:2])
    assert graphed.replays == 9


def test_encoder_fallback_is_random_and_seeded(tmp_path, capsys):
    a = tengine.load_encoder_params(str(tmp_path / "missing.pth"))
    assert "WARNING: vgg weights not found" in capsys.readouterr().out
    b = tengine.load_encoder_params(None, torch.Generator().manual_seed(0))
    c = tengine.load_encoder_params(None, torch.Generator().manual_seed(1))
    assert list(a) == list(StyleNet().encoder.state_dict())
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["2.weight"], c["2.weight"])
    assert all(not v.any() for k, v in a.items() if k.endswith(".bias"))


def test_encoder_loads_by_key_from_a_whole_vgg_file(tmp_path, capsys):
    """``vgg_normalised.pth`` holds all of vgg_normalised: the encoder takes
    its first 31 layers' entries; a file without them raises."""
    sd = tengine.load_encoder_params(None, torch.Generator().manual_seed(2))
    capsys.readouterr()
    whole = dict(sd, **{"31.weight": torch.ones(512, 512, 3, 3), "31.bias": torch.ones(512)})
    torch.save(whole, str(tmp_path / "vgg.pth"))
    got = tengine.load_encoder_params(str(tmp_path / "vgg.pth"))
    assert "WARNING" not in capsys.readouterr().out
    assert list(got) == list(sd) and all(torch.equal(got[k], sd[k]) for k in sd)
    torch.save({k: v for k, v in sd.items() if k != "2.bias"}, str(tmp_path / "part.pth"))
    with pytest.raises(KeyError, match="2.bias"):
        tengine.load_encoder_params(str(tmp_path / "part.pth"))


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_parser_matches_jax():
    from adain.train import train_human as jcli

    jact, tact = _actions(jcli.build_parser()), _actions(tcli.build_parser())
    assert set(tact) - set(jact) == {"device", "dist_coordinator", "dist_num_processes",
                                     "dist_process_id"} and set(jact) <= set(tact)
    for dest, j in jact.items():
        t = tact[dest]
        assert (t.option_strings, t.default, t.type, t.nargs, t.const, t.choices, type(t)) == \
            (j.option_strings, j.default, j.type, j.nargs, j.const, j.choices, type(j)), dest
    assert tact["device"].option_strings == ["--device"] and tact["device"].default is None


def test_cli_needs_a_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = tcli.build_parser().parse_args(["--source", "RenderedHandPose"])
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is available")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(args)
    assert not os.listdir(tmp_path)


def test_cli_main_on_fake_trees(tmp_path, h3d_root):  # noqa: F811 (fixture)
    """``python -m uda_poseestimation_torch.adain.train_human`` on a fake RHD
    source and an H3D ``_mt`` target (8 and 5 usable training samples: one
    batch of 4 a pass), 3 iterations on the CPU, with the r2h line's
    augmentation flags."""
    make_rhd(str(tmp_path / "rhd"), n_train=8, n_eval=4)
    style = StyleNet()
    style.reset_parameters(torch.Generator().manual_seed(1))
    torch.save(style.encoder.state_dict(), str(tmp_path / "vgg.pth"))
    argv = ["--source", "RenderedHandPose", "--target", "Hand3DStudio_mt",
            "--source_root", "rhd", "--target_root", h3d_root, "--vgg", "vgg.pth",
            "--image-size", str(SIZE), "--max_iter", "3", "--save_model_interval", "2",
            "--log_img_interval", "2", "--exp_name", "smoke", "--device", "cpu",
            "--rotation_stu", "180", "--shear_stu", "-30", "30", "--translate_stu", "0.05",
            "0.05", "--color_stu", "0.25", "--rotation_tea", "180", "--shear_tea", "-30",
            "30", "--translate_tea", "0.05", "0.05", "--color_tea", "0.25"]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-m", "uda_poseestimation_torch.adain.train_human",
                           *argv], cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "WARNING" not in proc.stdout
    root = tmp_path / "logs" / "smoke"
    lines = (root / "log_smoke.txt").read_text().splitlines()
    assert [int(ln.split(",")[0].split()[1]) for ln in lines] == [0, 1, 2]
    losses = [float(x) for ln in lines for x in re.findall(r"loss: ([^,]+)", ln)]
    assert len(losses) == 9 and np.isfinite(losses).all()
    assert sorted(os.listdir(root / "save_imgs" / "save_img_smoke")) == ["0.png", "2.png"]
    assert Image.open(root / "save_imgs" / "save_img_smoke" / "0.png").size == (3 * SIZE, SIZE)
    sd = torch.load(str(root / "saved_model" / "decoder_smoke.pth.tar"), weights_only=True)
    assert list(sd) == list(style.decoder.state_dict())
    assert all(torch.isfinite(v).all() for v in sd.values())
