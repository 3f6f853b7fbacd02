"""Plain PyTorch ops of the adaptation step, frozen from their published
definitions (the UDA reference's train_human.py and utils.py):

- the inverse heatmap warp: the trainer's translate -> rotate/scale -> shear
  chain of nearest warps (torchvision's inverse affine, centered
  coordinates, round half to even, zero outside), composed into one gather;
- keypoint occlusion: a confident keypoint drawn per sample, a rectangle of
  +-10 pixels around it replaced by a random patch of the same image, in the
  student view's original frame: backward warp, paste, forward chain;
- ``get_max_preds`` (argmax decode), ``rectify`` (a unit Gaussian at each
  argmax, with the reference's swapped h/w bounds check), Gaussian targets;
- the JointsMSE and masked consistency losses.
"""

from __future__ import annotations

import torch


def rss_coeffs(angle_deg, shear_x_deg, shear_y_deg):
    rot, sx, sy = (torch.deg2rad(t) for t in (angle_deg, shear_x_deg, shear_y_deg))
    a = torch.cos(rot - sy) / torch.cos(sy)
    b = -torch.cos(rot - sy) * torch.tan(sx) / torch.cos(sy) - torch.sin(rot)
    c = torch.sin(rot - sy) / torch.cos(sy)
    d = -torch.sin(rot - sy) * torch.tan(sx) / torch.cos(sy) + torch.cos(rot)
    return a, b, c, d


def inverse_affine_coeffs(angle, tx, ty, shx, shy, scale):
    """torchvision's ``_get_inverse_affine_matrix`` with center (0, 0): the
    six output->input coefficients, (..., 6)."""
    a, b, c, d = rss_coeffs(angle, shx, shy)
    inv = 1.0 / scale
    m0, m1, m3, m4 = d * inv, -b * inv, -c * inv, a * inv
    m2 = m0 * (-tx) + m1 * (-ty)
    m5 = m3 * (-tx) + m4 * (-ty)
    return torch.stack(torch.broadcast_tensors(m0, m1, m2, m3, m4, m5), dim=-1)


def chain_coeffs(angle, tx, ty, shx, shy, scale):
    zero = torch.zeros_like(angle)
    one = torch.ones_like(zero)
    return (inverse_affine_coeffs(zero, tx, ty, zero, zero, one),
            inverse_affine_coeffs(angle, zero, zero, zero, zero, scale),
            inverse_affine_coeffs(zero, zero, zero, shx, shy, one))


def _grid(h, w, device):
    ys = torch.arange(h, device=device, dtype=torch.float32)
    xs = torch.arange(w, device=device, dtype=torch.float32)
    ys, xs = torch.meshgrid(ys, xs, indexing="ij")
    return ys - (h - 1) / 2.0, xs - (w - 1) / 2.0


def _coef(m, i, xs):
    c = m[..., i]
    return c.reshape(c.shape + (1,) * (xs.dim() - c.dim()))


def _to_int32(v):
    # NaN -> 0 and saturation, as CUDA converts, on any device
    return v.clamp(-2.0 ** 31, 2.0 ** 31 - 128).nan_to_num(0.0).to(torch.int32)


def compose_nearest(coeff_list, xs, ys, valid, h, w):
    """Back through nearest warps [first, ..., last]: each stage rounds,
    ANDs its in-bounds flag into ``valid`` and clips."""
    hw, hh = (w - 1) / 2.0, (h - 1) / 2.0
    for m in reversed(list(coeff_list)):
        x_in = _coef(m, 0, xs) * xs + _coef(m, 1, xs) * ys + _coef(m, 2, xs) + hw
        y_in = _coef(m, 3, xs) * xs + _coef(m, 4, xs) * ys + _coef(m, 5, xs) + hh
        ix, iy = _to_int32(torch.round(x_in)), _to_int32(torch.round(y_in))
        valid = valid & (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        xs = ix.clamp(0, w - 1).float() - hw
        ys = iy.clamp(0, h - 1).float() - hh
    return xs, ys, valid


def _gather(imgs, xs, ys, valid):
    b, c, h, w = imgs.shape
    idx = ((ys + (h - 1) / 2.0).long() * w + (xs + (w - 1) / 2.0).long())
    out = imgs.reshape(b, c, h * w).gather(2, idx.reshape(b, 1, h * w).expand(b, c, h * w))
    return torch.where(valid[:, None], out.reshape(b, c, h, w), 0.0)


def inverse_warp_heatmaps(heatmaps, aug_param, ratio: float):
    """Undo the dataset's affine on (B, K, h, w) heatmaps; ``aug_param`` (B,
    6) holds the inverse (angle, tx, ty, shear_x, shear_y, scale)."""
    angle, tx, ty, shx, shy, scale = aug_param.float().unbind(-1)
    b, _, h, w = heatmaps.shape
    ys, xs = _grid(h, w, heatmaps.device)
    valid = torch.ones((b, h, w), dtype=torch.bool, device=heatmaps.device)
    xs, ys, valid = compose_nearest(chain_coeffs(angle, tx / ratio, ty / ratio, shx, shy, scale),
                                    xs.expand(b, h, w), ys.expand(b, h, w), valid, h, w)
    return _gather(heatmaps, xs, ys, valid)


def occlusion_warp(imgs, coeffs, rect):
    """backward(paste(forward(x))) of (B, C, S, S) images, coeffs (B, 4, 6)
    [cb, c1, c2, c3], rect (B, 6) [left, right, upper, bottom, left_src,
    upper_src] (left/right bound rows)."""
    b, _, s, _ = imgs.shape
    half = (s - 1) / 2.0
    ys0, xs0 = _grid(s, s, imgs.device)
    valid = torch.ones((b, s, s), dtype=torch.bool, device=imgs.device)
    cb, c1, c2, c3 = coeffs.unbind(1)
    qx, qy, valid = compose_nearest([cb], xs0.expand(b, s, s), ys0.expand(b, s, s), valid, s, s)
    qr, qc = (qy + half).to(torch.int32), (qx + half).to(torch.int32)
    lt, rb, up, bb, ls, us = (t.view(b, 1, 1) for t in rect.unbind(1))
    inside = (qr >= lt) & (qr < rb) & (qc >= up) & (qc < bb)
    rr = torch.where(inside, qr - lt + ls, qr)
    rc = torch.where(inside, qc - up + us, qc)
    fx, fy, valid = compose_nearest([c1, c2, c3], rc.float() - half, rr.float() - half,
                                    valid, s, s)
    return _gather(imgs, fx, fy, valid)


def get_max_preds(heatmaps):
    """(B, K, H, W) -> preds (B, K, 2) (x, y), zero where maxval <= 0, and
    maxvals (B, K, 1); the first maximum wins."""
    b, k, h, w = heatmaps.shape
    flat = heatmaps.reshape(b, k, h * w)
    idx = flat.argmax(dim=2)
    maxvals = flat.amax(dim=2)
    preds = torch.stack([(idx % w).float(), torch.floor(idx.float() / w)], dim=-1)
    return preds * (maxvals > 0.0).float()[..., None], maxvals[..., None]


def render_gaussian(mu_x, mu_y, sigma, size_wh, clip_xy=None):
    """Unit-peak Gaussians at integer centers with the reference's patch
    math (``ul = int(mu - 3 sigma)``, the 3-sigma window)."""
    w, h = size_wh
    tmp = 3.0 * sigma
    x0 = float((2.0 * tmp + 1.0) // 2)
    ys = torch.arange(h, device=mu_x.device, dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=mu_x.device, dtype=torch.float32)[None, :]
    mu_x, mu_y = mu_x[..., None, None], mu_y[..., None, None]
    ul_x, ul_y = torch.trunc(mu_x - tmp), torch.trunc(mu_y - tmp)
    g = torch.exp(-((xs - ul_x - x0) ** 2 + (ys - ul_y - x0) ** 2) / (2.0 * sigma * sigma))
    br_x, br_y = torch.trunc(mu_x + tmp + 1.0), torch.trunc(mu_y + tmp + 1.0)
    cx, cy = clip_xy if clip_xy is not None else (w, h)
    inside = ((xs >= ul_x) & (xs < torch.clamp(br_x, max=cx))
              & (ys >= ul_y) & (ys < torch.clamp(br_y, max=cy)))
    return torch.where(inside, g, 0.0)


def generate_targets(keypoints, visible, heatmap_size: int, sigma: float, image_size: int):
    """Gaussian targets (B, K, h, h) and weights (B, K, 1) from keypoints (B,
    K, 2) at image scale and visibilities (B, K)."""
    stride = image_size / heatmap_size
    mu_x = torch.trunc(keypoints[..., 0] / stride + 0.5)
    mu_y = torch.trunc(keypoints[..., 1] / stride + 0.5)
    inb = (mu_x >= 0) & (mu_x < heatmap_size) & (mu_y >= 0) & (mu_y < heatmap_size)
    weight = torch.where(inb, visible.float(), 0.0)
    g = render_gaussian(mu_x, mu_y, sigma, (heatmap_size, heatmap_size))
    return torch.where((weight > 0.5)[..., None, None], g, 0.0), weight[..., None]


def rectify(heatmaps, sigma: float):
    b, k, h, w = heatmaps.shape
    preds, _ = get_max_preds(heatmaps)
    mu_x, mu_y = preds[..., 0], preds[..., 1]
    ok = (mu_x >= 0) & (mu_x < h) & (mu_y >= 0) & (mu_y < w)
    g = render_gaussian(mu_x, mu_y, sigma, (w, h), clip_xy=(h, w))
    return torch.where(ok[..., None, None], g, 0.0)


def joints_mse_loss(output, target, weight):
    b, k = output.shape[:2]
    loss = 0.5 * (output.reshape(b, k, -1) - target.reshape(b, k, -1)) ** 2
    return (loss * weight.reshape(b, k, 1)).mean()


def cons_loss(stu, tea, tea_mask):
    diff = (stu - tea) * tea_mask[:, :, None, None].to(stu.dtype)
    return torch.mean(diff ** 2, dim=1).mean()
