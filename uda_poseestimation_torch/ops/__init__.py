"""Tensor ops of the port: warps, heatmaps, PCK, AdaIN, and the kernels'
wrappers (occlusion warp, 1x1 conv + BatchNorm statistics, warp gather)."""

from .adain import adain, calc_mean_std, gram_matrix
from .affine import (chain_coeffs, compose_inverse_coeffs, compose_nearest_indices,
                     gather_nearest, inverse_affine_coeffs, inverse_warp_heatmaps,
                     rss_coeffs, warp_affine_chain)
from .bn_fuse import conv1x1_bn_stats, matmul_stats, matmul_stats_plain
from .heatmap import (generate_target, generate_target_batch, get_max_preds,
                      rectify, render_gaussian)
from .occlusion_warp import (occlusion_indices_plain, occlusion_warp,
                             occlusion_warp_plain)
from .pck import keypoint_pck_accuracy
from .warp_gather import warp_gather, warp_gather_plain

__all__ = [
    "adain", "calc_mean_std", "chain_coeffs", "compose_inverse_coeffs",
    "compose_nearest_indices", "conv1x1_bn_stats", "gather_nearest",
    "generate_target", "generate_target_batch", "get_max_preds", "gram_matrix",
    "inverse_affine_coeffs", "inverse_warp_heatmaps", "keypoint_pck_accuracy",
    "matmul_stats", "matmul_stats_plain", "occlusion_indices_plain",
    "occlusion_warp", "occlusion_warp_plain", "rectify", "render_gaussian",
    "rss_coeffs", "warp_affine_chain", "warp_gather", "warp_gather_plain",
]
