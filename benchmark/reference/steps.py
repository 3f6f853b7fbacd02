"""The reference's training steps and serving forward, float32 with TF32
off unless a control asks for less (``precision.py``).

- ``AdaptReference``: the UDA mean-teacher step (train_human.py:305-458 of
  the UDA reference, arXiv:2204.00172): the drawn style directions against
  the original views (one VGG encode of each image, one decode of each
  drawn target), the teacher forward in train mode and its inverse warp,
  keypoint occlusion, rectify and the kth-value confidence mask, the two
  student forwards, JointsMSE plus the masked consistency loss, Adam and
  the EMA teacher (parameters only).
- ``DecoderReference``: AdaIN decoder training (adain/train/train_human.py:
  208-215): content plus mean/std style loss, Adam on the decoder only.
- ``serve_forward``: the eval-mode forward and the argmax decode.

Departures from the published description (the program's as well): the
styled views are clamped to the normalized image range; the occlusion's
source offsets and keypoint choice come from uniforms the caller draws
(``occlusion_draws``), in the order the program's stream gives them.
"""

from __future__ import annotations

import copy
from typing import Mapping

import torch

from . import ops
from .models import PoseResNet, StyleNet, adain

RECOVER_MIN = (-2.1179, -2.0357, -1.8044)
RECOVER_MAX = (2.2489, 2.4285, 2.64)


def nchw(x):
    return x.permute(0, 3, 1, 2)


def occlusion_draws(batch: int, keypoints: int, generator: torch.Generator, device):
    """One step's occlusion uniforms, in the order the step's stream draws
    them: Gumbel noise (B, K) first, then the gate ``u`` and the two source
    offsets (B,) each."""
    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=device)

    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(uniform(batch, keypoints).clamp_(min=tiny)))
    return {"u": uniform(batch), "gumbel": gumbel, "u1": uniform(batch), "u2": uniform(batch)}


def _clamp(x):
    lo = torch.tensor(RECOVER_MIN, device=x.device, dtype=x.dtype).view(1, 3, 1, 1)
    hi = torch.tensor(RECOVER_MAX, device=x.device, dtype=x.dtype).view(1, 3, 1, 1)
    return torch.maximum(torch.minimum(x, hi), lo)


def style_views(style: StyleNet, x_s, x_t, do_s2t, alpha_s2t, do_t2s, alpha_t2s):
    """NHWC source and teacher views after the drawn directions."""
    if not (do_s2t or do_t2s):
        return x_s, x_t
    f_s, f_t = style.encode(nchw(x_s)), style.encode(nchw(x_t))
    if do_s2t:
        x_s = _clamp(style.decode(alpha_s2t * adain(f_s, f_t) + (1 - alpha_s2t) * f_s)
                     ).permute(0, 2, 3, 1)
    if do_t2s:
        x_t = _clamp(style.decode(alpha_t2s * adain(f_t, f_s) + (1 - alpha_t2s) * f_t)
                     ).permute(0, 2, 3, 1)
    return x_s, x_t


def occlude(x_t_stu, y_recon, aug_stu, draws, image_size, ratio, rate=0.5, thresh=0.9,
            size=10):
    """Occluded NHWC student views (train_human.py:376-413), the per-sample
    gate, and the warp's operands and output (images, coeffs, rect, out)."""
    s = image_size
    conf = y_recon.amax(dim=(2, 3))
    preds, _ = ops.get_max_preds(y_recon)
    table = conf >= thresh
    do = (table.sum(dim=1) > 0) & (draws["u"] <= rate)
    choice = torch.where(table, draws["gumbel"], float("-inf")).argmax(dim=1)
    pos = (preds[torch.arange(len(preds), device=preds.device), choice] * ratio).to(torch.int32)
    left, right = (pos[:, 1] - size).clamp(min=0), (pos[:, 1] + size).clamp(max=s)
    upper, bottom = (pos[:, 0] - size).clamp(min=0), (pos[:, 0] + size).clamp(max=s)
    left_src = torch.floor(draws["u1"] * (s - (right - left) + 1).float()).to(torch.int32)
    upper_src = torch.floor(draws["u2"] * (s - (bottom - upper) + 1).float()).to(torch.int32)
    angle, tx, ty, shx, shy, scale = aug_stu.float().unbind(-1)
    c1, c2, c3 = ops.chain_coeffs(angle, tx / ratio, ty / ratio, shx, shy, scale)
    cb = ops.inverse_affine_coeffs(-angle, -tx / ratio, -ty / ratio, -shx, -shy, 1.0 / scale)
    rect = torch.stack([left, right, upper, bottom, left_src, upper_src], -1).to(torch.int32)
    imgs = nchw(x_t_stu)
    coeffs = torch.stack([cb, c1, c2, c3], dim=1)
    out = ops.occlusion_warp(imgs, coeffs, rect)
    return (torch.where(do[:, None, None, None], out, imgs).permute(0, 2, 3, 1), do,
            (imgs, coeffs, rect, out))


class AdaptReference:
    """Student, EMA teacher, Adam and the frozen style net, from one weight
    dict; ``step`` runs one adaptation step and returns its losses.

    By default training starts: the teacher is the student and Adam has no
    state. A run that goes on from a state that training reached gives the
    teacher's weights and Adam's state by parameter name ({"step",
    "exp_avg", "exp_avg_sq"} each)."""

    def __init__(self, pose_weights: Mapping, style_weights: Mapping, num_keypoints: int,
                 cfg: Mapping, device, stage_sizes=(3, 4, 23, 3),
                 teacher_weights: Mapping = None, adam_state: Mapping = None):
        self.cfg = dict(cfg)
        self.student = PoseResNet(num_keypoints, stage_sizes).to(device)
        self.student.load_state_dict({k: v.float() for k, v in pose_weights.items()})
        self.teacher = copy.deepcopy(self.student).requires_grad_(False)
        if teacher_weights is not None:
            self.teacher.load_state_dict({k: v.float() for k, v in teacher_weights.items()})
        self.style = StyleNet().to(device)
        self.style.load_state_dict({k: v.float() for k, v in style_weights.items()})
        self.style.requires_grad_(False)
        self.optimizer = torch.optim.Adam(self.student.parameters(), lr=cfg["lr"],
                                          betas=(0.9, 0.999), eps=1e-8, foreach=False)
        for name, p in self.student.named_parameters():
            st = (adam_state or {}).get(name, {})
            if "step" in st:  # a parameter that Adam has stepped
                self.optimizer.state[p] = {
                    "step": torch.tensor(float(st["step"])),
                    "exp_avg": st["exp_avg"].to(p.device, torch.float32, copy=True),
                    "exp_avg_sq": st["exp_avg_sq"].to(p.device, torch.float32, copy=True)}

    def modules(self):
        return self.student, self.teacher, self.style

    def step(self, batch: Mapping, gates, draws, half_batch: bool = False):
        """``gates`` (do_s2t, alpha_s2t, do_t2s, alpha_t2s). ``half_batch``
        plants a fault: the losses are the means over the first half of the
        rows. Returns {"loss_all", "loss_s", "loss_c"} as floats."""
        cfg = self.cfg
        ratio = cfg["image_size"] / cfg["heatmap_size"]
        do_s2t, a_s2t, do_t2s, a_t2s = gates
        x_s, x_t_stu = batch["image_s"], batch["image_t_stu"]
        x_t_tea, aug_tea = batch["images_t_tea"][0], batch["aug_params_tea"][0]
        self.student.train()
        self.teacher.train()
        with torch.no_grad():
            x_s, x_t_tea = style_views(self.style, x_s, x_t_tea, do_s2t, a_s2t, do_t2s, a_t2s)
            y_recon = ops.inverse_warp_heatmaps(self.teacher(nchw(x_t_tea)), aug_tea, ratio)
            x_t_stu, do, self.occlusion_call = occlude(x_t_stu, y_recon, batch["aug_param_stu"], draws,
                                 cfg["image_size"], ratio, cfg["occlude_rate"],
                                 cfg["occlude_thresh"])
            self.occluded = int(do.sum())
            act = y_recon.amax(dim=(2, 3))
            y_rect = ops.rectify(y_recon, cfg["sigma"])
            kth = max(int(cfg["mask_ratio"] * act.numel()), 1)
            mask = act > torch.kthvalue(act.reshape(-1), kth).values
        y_s = self.student(nchw(x_s))
        self.y_s = y_s.detach().clone()
        y_t = ops.inverse_warp_heatmaps(self.student(nchw(x_t_stu)), batch["aug_param_stu"],
                                        ratio)
        rows = slice(0, len(y_s) // 2) if half_batch else slice(None)
        loss_s = ops.joints_mse_loss(y_s[rows], batch["target_s"][rows],
                                     batch["weight_s"][rows][..., 0])
        loss_c = ops.cons_loss(y_t[rows], y_rect[rows], mask[rows])
        loss = loss_s + cfg["lambda_c"] * loss_c
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        with torch.no_grad():
            for t, s in zip(self.teacher.parameters(), self.student.parameters()):
                t.mul_(cfg["teacher_alpha"]).add_(s.detach() * (1.0 - cfg["teacher_alpha"]))
        return {"loss_all": loss.item(), "loss_s": loss_s.item(), "loss_c": loss_c.item()}


class DecoderReference:
    """The AdaIN decoder's training: frozen encoder, Adam on the decoder."""

    def __init__(self, encoder_weights: Mapping, decoder_weights: Mapping, cfg: Mapping,
                 device):
        self.cfg = dict(cfg)
        self.net = StyleNet().to(device)
        self.net.encoder.load_state_dict({k: v.float() for k, v in encoder_weights.items()})
        self.net.decoder.load_state_dict({k: v.float() for k, v in decoder_weights.items()})
        self.net.encoder.requires_grad_(False)
        self.optimizer = torch.optim.Adam(self.net.decoder.parameters(), lr=cfg["lr"],
                                          foreach=False)

    def modules(self):
        return (self.net,)

    def step(self, content, style, half_batch: bool = False):
        if half_batch:
            content, style = content[: len(content) // 2], style[: len(style) // 2]
        loss_c, loss_s, _ = self.net(content, style)
        loss_c = self.cfg["content_weight"] * loss_c
        loss_s = self.cfg["style_weight"] * loss_s
        loss = loss_c + loss_s
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return {"loss": loss.item(), "loss_c": loss_c.item(), "loss_s": loss_s.item()}


@torch.no_grad()
def serve_forward(model: PoseResNet, images):
    """NHWC images -> heatmaps, preds, maxvals of the eval-mode model."""
    model.eval()
    heatmaps = model(nchw(images))
    preds, maxvals = ops.get_max_preds(heatmaps)
    return heatmaps, preds, maxvals
