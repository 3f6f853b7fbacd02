"""The port's data pipeline and its dataset registry.

The trainer looks datasets up by name in this module's ``__dict__``, as the
reference (train_human.py:87) and the JAX package do. Every human dataset of
the JAX registry is ported: RHD, Hand-3D-Studio and FreiHAND (hands, 21
keypoints), SURREAL, LSP and Human3.6M (bodies, 16 keypoints). The animal
datasets wait (ROADMAP.md, A10).
"""

from .freihand import FreiHand
from .hand_3d_studio import Hand3DStudio, Hand3DStudio_mt, Hand3DStudioAll, Hand3DStudioAll_mt
from .human36m import Human36M, Human36M_mt
from .keypoint_dataset import Body16KeypointDataset, Hand21KeypointDataset, KeypointDataset
from .loader import ForeverDataIterator, default_collate, make_loader
from .lsp import LSP, LSP_mt
from .rendered_hand_pose import RenderedHandPose, RenderedHandPose_mt
from .surreal import SURREAL

__all__ = [
    "Body16KeypointDataset", "ForeverDataIterator", "FreiHand", "Hand21KeypointDataset",
    "Hand3DStudio", "Hand3DStudioAll", "Hand3DStudioAll_mt", "Hand3DStudio_mt", "Human36M",
    "Human36M_mt", "KeypointDataset", "LSP", "LSP_mt", "RenderedHandPose",
    "RenderedHandPose_mt", "SURREAL", "default_collate", "make_loader",
]
