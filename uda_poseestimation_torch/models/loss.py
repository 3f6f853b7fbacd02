"""Keypoint losses on NCHW (B, K, H, W) heatmaps.

PyTorch twin of ``uda_poseestimation_tpu/models/loss.py`` (reference
lib/models/loss.py):

- ``joints_mse_loss``: elementwise 0.5*MSE with per-joint weights broadcast
  as (B, K, 1); 'mean' averages over B*K*HW (the weights do not renormalize),
  'none' returns (B, K);
- ``cons_loss``: the difference times ``tea_mask`` (B, K) broadcast over
  pixels, squared, averaged over channels and then over everything;
- the variants that no trainer calls, kept for the reference's API:
  ``joints_kl_loss``, ``ent_loss``, ``cons_softmax_loss``, ``cons_kl_loss``
  (with the JAX package's guard on its log-probability target) and
  ``coral_loss``.
"""

from __future__ import annotations

import torch


def joints_mse_loss(output, target, target_weight=None, reduction: str = "mean"):
    b, k = output.shape[:2]
    pred = output.reshape(b, k, -1)
    gt = target.reshape(b, k, -1)
    loss = 0.5 * (pred - gt) ** 2
    if target_weight is not None:
        loss = loss * target_weight.reshape(b, k, 1)
    if reduction == "mean":
        return loss.mean()
    return loss.mean(dim=-1)


def cons_loss(stu_out, tea_out, valid_mask=None, tea_mask=None):
    diff = stu_out - tea_out
    if tea_mask is not None:
        diff = diff * tea_mask[:, :, None, None].to(diff.dtype)
    loss_map = torch.mean(diff ** 2, dim=1)  # (B, H, W)
    if valid_mask is not None:
        denom = max(int(valid_mask.sum()) * loss_map.shape[-1] * loss_map.shape[-2], 1)
        return torch.where(valid_mask[:, None, None], loss_map, 0.0).sum() / denom
    return loss_map.mean()


def joints_kl_loss(output, target, target_weight=None, reduction: str = "mean",
                   epsilon: float = 0.0):
    """KL(target / target.sum() || softmax(output)) per joint (reference
    loss.py:52-95), as torch's ``KLDivLoss`` on log-probabilities with
    0 log 0 := 0; per-joint weights multiply the (B, K) divergences."""
    b, k = output.shape[:2]
    pred = torch.log_softmax(output.reshape(b, k, -1), dim=-1)
    gt = target.reshape(b, k, -1) + epsilon
    gt = gt / gt.sum(dim=-1, keepdim=True)
    log_gt = torch.where(gt > 0, torch.log(torch.clamp(gt, min=1e-38)), 0.0)
    loss = (gt * (log_gt - pred)).sum(dim=-1)  # (B, K)
    if target_weight is not None:
        loss = loss * target_weight.reshape(b, k)
    if reduction == "mean":
        return loss.mean()
    return loss.mean(dim=-1)


def ent_loss(x, threshold: float = -1.0, reduction: str = "mean"):
    """Each heatmap's softmax entropy over its pixels, normalized by
    log(H*W) (reference loss.py:97-117). With ``threshold > 0`` the mean of
    the entropies below it (0 when there is none), as a masked mean."""
    n, c, h, w = x.shape
    flat = x.reshape(n, c, -1)
    logp = torch.log_softmax(flat, dim=2)
    ent = -(logp.exp() * logp).sum(dim=2) / torch.log(torch.tensor(float(h * w)))
    if threshold > 0:
        mask = ent < threshold
        return torch.where(mask, ent, 0.0).sum() / mask.sum().clamp(min=1)
    if reduction == "mean":
        return ent.mean()
    return ent.mean(dim=-1)


def cons_softmax_loss(stu_out, tea_out, valid_mask=None, tea_mask=None):
    """``cons_loss`` of the per-joint spatial softmaxes (reference
    loss.py:135-148)."""
    b, k, h, w = stu_out.shape
    stu = torch.softmax(stu_out.reshape(b, k, -1), dim=-1).reshape(b, k, h, w)
    tea = torch.softmax(tea_out.reshape(b, k, -1), dim=-1).reshape(b, k, h, w)
    return cons_loss(stu, tea, valid_mask, tea_mask)


def cons_kl_loss(stu_out, tea_out, valid_mask=None, tea_mask=None):
    """The reference's ConsKLLoss (loss.py:151-173), which passes the
    teacher's LOG-probabilities as KLDivLoss's target. torch's
    ``target * log(target)`` is NaN for those negative targets, so the
    reference's value is always NaN. As the JAX package does, the same
    log-probability target is kept and log(t) guarded for t <= 0, which
    gives the finite ``-t * stu`` in place of NaN: a deliberate deviation."""
    b, k, h, w = stu_out.shape
    stu = torch.log_softmax(stu_out.reshape(b, k, -1), dim=-1)
    t = torch.log_softmax(tea_out.reshape(b, k, -1), dim=-1)
    log_t = torch.where(t > 0, torch.log(torch.clamp(t, min=1e-38)), 0.0)
    loss_map = (t * (log_t - stu)).reshape(b, k, h, w)
    if tea_mask is not None:
        loss_map = loss_map * tea_mask[:, :, None, None].to(loss_map.dtype)
    loss_map = loss_map.mean(dim=1)
    if valid_mask is not None:
        denom = valid_mask.sum().clamp(min=1) * (h * w)
        return torch.where(valid_mask[:, None, None], loss_map, 0.0).sum() / denom
    return loss_map.mean()


def _bilinear_downsample(x, factor: int):
    """``F.interpolate(mode="bilinear")`` to ``int(size / factor)``: the
    half-pixel point sample of a 2x2 neighbourhood, no antialias."""
    h, w = x.shape[-2:]
    return torch.nn.functional.interpolate(
        x, size=(int(h / factor), int(w / factor)), mode="bilinear",
        align_corners=False, antialias=False)


def _covariance(x):
    """The reference's ``(x^T x - (1 x)^T (1 x) / n) / (n - 1)`` of (n, d)
    ``x``. It subtracts two nearly equal matrices, so its products run in
    full float32: TF32 is turned off around them on the card."""
    n = x.shape[0]
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        tmp = torch.ones((1, n), dtype=x.dtype, device=x.device) @ x
        return (x.T @ x - tmp.T @ tmp / n) / (n - 1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def coral_loss(src_out, tgt_out, coral_downsample: int = 1, prior=None):
    """CORAL: the Frobenius distance of the source's and the target's
    covariances over the flattened (C*H*W) features, over 4 (C*H*W)^2
    (reference loss.py:176-208). ``prior`` replaces the source covariance;
    ``coral_downsample > 1`` first shrinks the maps bilinearly."""
    if coral_downsample > 1:
        tgt_out = _bilinear_downsample(tgt_out, coral_downsample)
    n, c, h, w = tgt_out.shape
    if prior is not None:
        cs = prior
    else:
        if coral_downsample > 1:
            src_out = _bilinear_downsample(src_out, coral_downsample)
        cs = _covariance(src_out.reshape(n, -1))
    ct = _covariance(tgt_out.reshape(n, -1))
    loss = torch.sqrt(((cs - ct) ** 2).sum())
    return loss / (4.0 * (c * h * w) ** 2)
