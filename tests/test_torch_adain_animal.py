"""The port's AdaIN decoder trainer for the animal datasets (``python -m
uda_poseestimation_torch.adain.train_animal``) against the JAX package's
``adain/train/train_animal.py``.

- The parser: every option of the JAX parser, with the same option
  strings, destination, default, type, nargs and action; the port adds
  only ``--device`` and the trainers' ``--dist-*`` flags.
- ``denormalize``: the mean-only inverse with the clip, equal to JAX's.
- The CLI through ``python -m`` on ``tools/make_fixtures.make_animal``'s
  tree at 32² (synthetic horse/tiger to TigDog ``_mt``), 4 iterations on
  the CPU: finite log lines, the PNGs and the decoder file, which loads
  through the port's ``--decoder-name`` reader and the JAX package's
  ``load_style_net_params`` to the same weights.

Tolerance: none; parsed values and loaded weights are compared for
equality, the run for finite logged values.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from adain.train import train_animal as jcli
from tools.make_fixtures import make_animal
from tools.port_torch_weights import load_style_net_params
from uda_poseestimation_torch import weights
from uda_poseestimation_torch.adain import train_animal as tcli
from uda_poseestimation_torch.models import StyleNet

REPO = Path(__file__).resolve().parents[1]
SIZE = 32


PORT_ONLY = ("dist_coordinator", "dist_num_processes", "dist_process_id", "device")


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_parser_matches_jax():
    jact, tact = _actions(jcli.build_parser()), _actions(tcli.build_parser())
    assert list(jact) == [d for d in tact if d not in PORT_ONLY]
    for dest, j in jact.items():
        t = tact[dest]
        assert (t.option_strings, t.default, t.type, t.nargs, t.const, t.choices, type(t)) == \
            (j.option_strings, j.default, j.type, j.nargs, j.const, j.choices, type(j)), dest
    assert tact["device"].option_strings == ["--device"] and tact["device"].default is None


def test_denormalize_matches_jax():
    x = np.random.RandomState(0).uniform(-0.8, 1.2, (2, 5, 5, 3)).astype(np.float32)
    got, want = tcli.denormalize(x), jcli.denormalize(x)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert got.min() == 0.0 and got.max() == 1.0  # the clip


def test_cli_needs_a_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is available")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(tcli.build_parser().parse_args([]))
    assert not os.listdir(tmp_path)


def test_cli_main_on_the_animal_fixture(tmp_path):
    make_animal(str(tmp_path))
    style = StyleNet()
    style.reset_parameters(torch.Generator().manual_seed(2))
    torch.save(style.encoder.state_dict(), str(tmp_path / "vgg.pth"))
    argv = ["--source", "synthetic_animal_sp_all", "--target_ssl", "real_animal_all_mt",
            "--image-path", str(tmp_path / "animal_data"), "--train_on_all_cat",
            "--vgg", "vgg.pth", "--image-size", str(SIZE), "--inp-res", str(SIZE),
            "--out-res", "8", "--batch_size", "2", "--max_iter", "4",
            "--save_model_interval", "2", "--log_img_interval", "2", "--exp_name", "animal",
            "--device", "cpu", "--rotation_stu", "60", "--shear_stu", "-30", "30",
            "--translate_stu", "0.05", "0.05"]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2",
               UDA_CACHED_DATA_DIR=str(tmp_path / "cached_data"))
    proc = subprocess.run([sys.executable, "-m", "uda_poseestimation_torch.adain.train_animal",
                           *argv], cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "WARNING" not in proc.stdout
    root = tmp_path / "logs" / "animal"
    lines = (root / "log_animal.txt").read_text().splitlines()
    assert [int(ln.split(",")[0].split()[1]) for ln in lines] == [0, 1, 2, 3]
    losses = [float(x) for ln in lines for x in re.findall(r"loss: ([^,]+)", ln)]
    assert len(losses) == 12 and np.isfinite(losses).all()
    pngs = root / "save_imgs" / "save_img_animal"
    assert sorted(os.listdir(pngs)) == ["0.png", "2.png"]
    assert Image.open(pngs / "0.png").size == (3 * SIZE, SIZE)

    decoder = str(root / "saved_model" / "decoder_animal.pth.tar")
    sd = torch.load(decoder, weights_only=True)
    assert list(sd) == list(style.decoder.state_dict())
    assert all(torch.isfinite(v).all() for v in sd.values())
    # the file feeds --decoder-name in both packages: the same weights
    vgg = str(tmp_path / "vgg.pth")
    got = weights.load_style_net_files(StyleNet(), vgg, decoder).state_dict()
    want = weights.load_style_net(StyleNet(), load_style_net_params(vgg, decoder)).state_dict()
    assert list(got) == list(want)
    for key, value in got.items():
        assert torch.equal(value, want[key]), key
    for key, value in sd.items():
        assert torch.equal(got["decoder." + key], value), key
