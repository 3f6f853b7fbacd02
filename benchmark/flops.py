"""Operations and bytes the algorithm needs, from the configurations' shapes.

FLOPs count the convolutions (2 per multiply-add), forward and backward,
with nothing recomputed: a backward pass is the weight gradient of each
trained layer plus the input gradient of every layer whose input needs one
(none for the first layer fed by data). Elementwise work, BatchNorm and the
warps are not counted, as model FLOPs leave them out.

Bytes of kernel B1 (the occlusion warp): each input byte read once and each
output byte written once.
"""

from __future__ import annotations

from typing import Mapping


def _conv(cin, cout, k, h_out, w_out):
    return 2.0 * cin * cout * k * k * h_out * w_out


def pose_resnet_layers(image_size: int, num_keypoints: int, stage_sizes=(3, 4, 23, 3),
                       deconv_dim: int = 256) -> list:
    """Forward FLOPs of each conv of a Bottleneck PoseResNet, one image, in
    order (the stem first)."""
    s = image_size // 2
    layers = [_conv(3, 64, 7, s, s)]
    s //= 2  # max-pool
    inplanes, planes = 64, 64
    for stage, n in enumerate(stage_sizes):
        for i in range(n):
            stride = 2 if stage > 0 and i == 0 else 1
            out = s // stride
            layers.append(_conv(inplanes, planes, 1, s, s))
            layers.append(_conv(planes, planes, 3, out, out))
            layers.append(_conv(planes, planes * 4, 1, out, out))
            if i == 0:
                layers.append(_conv(inplanes, planes * 4, 1, out, out))
            inplanes, s = planes * 4, out
        planes *= 2
    cin = inplanes
    for _ in range(3):
        # ConvTranspose2d(4, s2, p1): each input pixel scatters a 4x4 patch
        layers.append(2.0 * cin * deconv_dim * 16 * s * s)
        cin, s = deconv_dim, s * 2
    layers.append(_conv(cin, num_keypoints, 1, s, s))
    return layers


def vgg_encoder_layers(image_size: int) -> list:
    """vgg_normalised to relu4_1, one image."""
    s = image_size
    plan = [(3, 3, 1), (3, 64, 3), (64, 64, 3), "pool", (64, 128, 3), (128, 128, 3), "pool",
            (128, 256, 3), (256, 256, 3), (256, 256, 3), (256, 256, 3), "pool", (256, 512, 3)]
    out = []
    for p in plan:
        if p == "pool":
            s = (s + 1) // 2
        else:
            out.append(_conv(p[0], p[1], p[2], s, s))
    return out


def decoder_layers(image_size: int) -> list:
    s = image_size // 8
    plan = [(512, 256), "up", (256, 256), (256, 256), (256, 256), (256, 128), "up",
            (128, 128), (128, 64), "up", (64, 64), (64, 3)]
    out = []
    for p in plan:
        if p == "up":
            s *= 2
        else:
            out.append(_conv(p[0], p[1], 3, s, s))
    return out


def train_flops(layers, input_grad_first: bool = False, weight_grads: bool = True) -> float:
    """Forward and backward FLOPs of a stack of convs."""
    fwd = sum(layers)
    wgrad = fwd if weight_grads else 0.0
    dgrad = fwd - (0.0 if input_grad_first else layers[0])
    return fwd + wgrad + dgrad


def adapt_step_flops(cfg: Mapping, batch: int, n_directions: int) -> float:
    """One adaptation step with ``n_directions`` style directions drawn:
    each image encoded once when any fires, one decode per direction and
    image; the teacher's forward; two student forwards and backwards."""
    s = cfg["image_size"]
    pose = pose_resnet_layers(s, cfg["num_keypoints"], tuple(cfg["stage_sizes"]),
                              cfg["deconv_dim"])
    per_image = sum(pose) + 2 * train_flops(pose)
    if n_directions:
        per_image += 2 * sum(vgg_encoder_layers(s)) + n_directions * sum(decoder_layers(s))
    return batch * per_image


def decoder_step_flops(cfg: Mapping) -> float:
    """One AdaIN decoder step: style encode to its taps, content encode,
    the decode trained, and the stylized image's re-encode back to the
    decoder (input gradients only: the encoder is frozen)."""
    s = cfg["image_size"]
    enc, dec = vgg_encoder_layers(s), decoder_layers(s)
    per_image = (2 * sum(enc) + train_flops(dec)
                 + train_flops(enc, input_grad_first=True, weight_grads=False))
    return cfg["batch"] * per_image


def serve_batch_flops(cfg: Mapping, batch: int) -> float:
    return batch * sum(pose_resnet_layers(cfg["image_size"], cfg["num_keypoints"],
                                          tuple(cfg["stage_sizes"]), cfg["deconv_dim"]))


def occlusion_warp_bytes(batch: int, channels: int, size: int) -> int:
    """Kernel B1 at (B, C, S, S) float32: the images read and written once,
    the (B, 4, 6) float32 coefficients and the (B, 6) int32 rectangles."""
    image = batch * channels * size * size * 4
    return 2 * image + batch * 4 * 6 * 4 + batch * 6 * 4
