"""The port's data pipeline and its dataset registry.

The trainer looks datasets up by name in this module's ``__dict__``, as the
reference (train_human.py:87) and the JAX package do. The RHD datasets are
ported; the other human datasets wait (ROADMAP.md, A7).
"""

from .keypoint_dataset import Body16KeypointDataset, Hand21KeypointDataset, KeypointDataset
from .loader import ForeverDataIterator, default_collate, make_loader
from .rendered_hand_pose import RenderedHandPose, RenderedHandPose_mt

__all__ = [
    "Body16KeypointDataset", "ForeverDataIterator", "Hand21KeypointDataset",
    "KeypointDataset", "RenderedHandPose", "RenderedHandPose_mt", "default_collate",
    "make_loader",
]
