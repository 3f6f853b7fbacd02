"""Carry the JAX package's parameters into the port's modules.

Input is a Flax variable tree as nested dicts of numpy arrays,
``{"params": ..., "batch_stats": ...}`` (``jax.device_get`` of the JAX
state gives one). Output is the reference's torch state-dict layout, which
is what the port's modules use:

- conv kernels (kh, kw, in, out) -> (out, in, kh, kw);
- deconv kernels (kh, kw, in, out) -> (in, out, kh, kw), unflipped: the JAX
  ``Deconv`` convolves the 2x-dilated input with the spatially flipped
  kernel, which is what ``ConvTranspose2d`` computes with the plain one;
- BatchNorm scale/bias -> weight/bias, mean/var -> running_mean/var.

``load_style_net_files`` reads the style network from the reference's torch
files instead (the trainers' ``--decoder-name``).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

# Sequential indices of the reference vgg_normalised / decoder convs
_VGG_LAYERS = {0: "conv0", 2: "conv1_1", 5: "conv1_2", 9: "conv2_1",
               12: "conv2_2", 16: "conv3_1", 19: "conv3_2", 22: "conv3_3",
               25: "conv3_4", 29: "conv4_1"}
_DECODER_LAYERS = {1: "conv0", 5: "conv1", 8: "conv2", 11: "conv3", 14: "conv4",
                   18: "conv5", 21: "conv6", 25: "conv7", 28: "conv8"}


def _conv(kernel) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(kernel).transpose(3, 2, 0, 1))


def _deconv(kernel) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(kernel).transpose(2, 3, 0, 1))


def _bn(sd, key, params, stats):
    sd[key + ".weight"] = np.asarray(params["scale"])
    sd[key + ".bias"] = np.asarray(params["bias"])
    if stats is not None:
        sd[key + ".running_mean"] = np.asarray(stats["mean"])
        sd[key + ".running_var"] = np.asarray(stats["var"])


def resnet_state_dict(params, stats=None) -> Dict[str, np.ndarray]:
    """Headless-ResNet variables -> torchvision-style state dict."""
    sd: Dict[str, np.ndarray] = {"conv1.weight": _conv(params["conv1"]["kernel"])}
    _bn(sd, "bn1", params["bn1"], None if stats is None else stats["bn1"])
    for name in sorted(k for k in params if k.startswith("layer")):
        stage, block = name[len("layer"):].split("_")
        dst = f"layer{stage}.{block}"
        p = params[name]
        s = None if stats is None else stats[name]
        for i in (1, 2, 3):
            if f"conv{i}" in p:
                sd[f"{dst}.conv{i}.weight"] = _conv(p[f"conv{i}"]["kernel"])
                _bn(sd, f"{dst}.bn{i}", p[f"bn{i}"],
                    None if s is None else s[f"bn{i}"])
        if "downsample_conv" in p:
            sd[f"{dst}.downsample.0.weight"] = _conv(p["downsample_conv"]["kernel"])
            _bn(sd, f"{dst}.downsample.1", p["downsample_bn"],
                None if s is None else s["downsample_bn"])
    return sd


def pose_resnet_state_dict(variables: Mapping) -> Dict[str, np.ndarray]:
    """PoseResNet ``{"params"[, "batch_stats"]}`` -> the reference's keys
    (``backbone.*``, ``upsampling.{0..8}.*``, ``head.*``). Without
    ``batch_stats`` (e.g. a gradient tree) only parameters come out."""
    params = variables["params"]
    stats = variables.get("batch_stats")
    sd = {"backbone." + k: v for k, v in resnet_state_dict(
        params["backbone"], None if stats is None else stats["backbone"]).items()}
    up_p = params["upsampling"]
    up_s = None if stats is None else stats["upsampling"]
    for i in range(3):
        sd[f"upsampling.{3 * i}.weight"] = _deconv(up_p[f"deconv{i}"]["kernel"])
        if "bias" in up_p[f"deconv{i}"]:
            sd[f"upsampling.{3 * i}.bias"] = np.asarray(up_p[f"deconv{i}"]["bias"])
        _bn(sd, f"upsampling.{3 * i + 1}", up_p[f"bn{i}"],
            None if up_s is None else up_s[f"bn{i}"])
    sd["head.weight"] = _conv(params["head"]["kernel"])
    sd["head.bias"] = np.asarray(params["head"]["bias"])
    return sd


def vgg_state_dict(params) -> Dict[str, np.ndarray]:
    """VGGEncoder params -> vgg_normalised Sequential-index state dict."""
    sd = {}
    for idx, name in _VGG_LAYERS.items():
        leaf = params[name] if name == "conv0" else params[name]["Conv_0"]
        sd[f"{idx}.weight"] = _conv(leaf["kernel"])
        sd[f"{idx}.bias"] = np.asarray(leaf["bias"])
    return sd


def decoder_state_dict(params) -> Dict[str, np.ndarray]:
    """Decoder params -> the reference decoder's Sequential-index state dict."""
    sd = {}
    for idx, name in _DECODER_LAYERS.items():
        leaf = params[name]["Conv_0"]
        sd[f"{idx}.weight"] = _conv(leaf["kernel"])
        sd[f"{idx}.bias"] = np.asarray(leaf["bias"])
    return sd


def _load(module: nn.Module, sd: Mapping[str, np.ndarray]):
    """load_state_dict (strict) from numpy, keeping the module's own entries
    that the JAX tree has no counterpart for (``num_batches_tracked``) and
    the parameters' dtypes and device."""
    own = module.state_dict()
    full = dict(own)
    for k, v in sd.items():
        if k not in own:
            raise KeyError(f"{k} has no counterpart in {type(module).__name__}")
        if tuple(own[k].shape) != tuple(np.shape(v)):
            raise ValueError(f"{k}: shape {np.shape(v)} vs {tuple(own[k].shape)}")
        full[k] = torch.tensor(np.asarray(v), dtype=own[k].dtype,
                               device=own[k].device)
    missing = [k for k in own if k not in sd and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"no value for {missing[:5]} ({len(missing)} entries)")
    module.load_state_dict(full, strict=True)
    return module


def load_pose_resnet(model: nn.Module, variables: Mapping) -> nn.Module:
    """Load Flax PoseResNet ``{"params", "batch_stats"}`` into ``model``."""
    return _load(model, pose_resnet_state_dict(variables))


def load_style_net(style_net: nn.Module, params: Mapping) -> nn.Module:
    """Load Flax StyleNet params (``{"encoder": ..., "decoder": ...}``)."""
    _load(style_net.encoder, vgg_state_dict(params["encoder"]))
    _load(style_net.decoder, decoder_state_dict(params["decoder"]))
    return style_net


def load_by_key(module: nn.Module, path: str) -> nn.Module:
    """Load a torch state dict with the reference's keys from ``path`` into
    ``module``, taking the entries that ``module`` has: ``vgg_normalised.pth``
    may hold the whole vgg_normalised, of which the encoder is the first 31
    layers. Raises ``KeyError`` when the file lacks one of ``module``'s
    entries."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    own = module.state_dict()
    missing = [k for k in own if k not in sd]
    if missing:
        raise KeyError(f"{path}: no value for {missing[:5]} ({len(missing)} entries)")
    module.load_state_dict({k: sd[k] for k in own})
    return module


def load_style_net_files(style_net: nn.Module, vgg_path: str, decoder_path: str) -> nn.Module:
    """Load ``vgg_normalised.pth`` and a decoder ``.pth`` into ``style_net``.

    Both are torch state dicts with the reference's Sequential-index keys,
    which are the port's ``VGGEncoder`` and ``Decoder`` keys, so they load
    as they are (``load_by_key``; the JAX package converts them, in
    ``tools/port_torch_weights.py::load_style_net_params``). Decoders saved
    by the JAX package's AdaIN pretraining in Flax's msgpack format are not
    read here.
    """
    load_by_key(style_net.encoder, vgg_path)
    load_by_key(style_net.decoder, decoder_path)
    return style_net
