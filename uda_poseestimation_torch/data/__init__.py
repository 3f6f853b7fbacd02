"""The port's data pipeline and its dataset registry.

The trainers look datasets up by name in this module's ``__dict__``, as the
reference (train_human.py:87, train_animal.py:68) and the JAX package do.
Every dataset of the JAX registry is ported: RHD, Hand-3D-Studio and
FreiHAND (hands, 21 keypoints), SURREAL, LSP and Human3.6M (bodies, 16
keypoints), the synthetic animals and TigDog (18 keypoints), and the
synthetic hound and sheep and AnimalPose (14 keypoints); and so are the
generic transforms and the samplers that the JAX registry exports.
"""

from .animal_pose import Animal_Pose, Animal_Pose_mt, animal_pose, animal_pose_mt
from .freihand import FreiHand
from .generic_transforms import (
    DeNormalizeAndTranspose,
    Denormalize,
    MultipleApply,
    NormalizeAndTranspose,
    RandomErasing,
    ResizeImage,
)
from .hand_3d_studio import Hand3DStudio, Hand3DStudio_mt, Hand3DStudioAll, Hand3DStudioAll_mt
from .human36m import Human36M, Human36M_mt
from .keypoint_dataset import (
    Animal14KeypointDataset,
    Animal18KeypointDataset,
    Body16KeypointDataset,
    Hand21KeypointDataset,
    KeypointDataset,
)
from .loader import ForeverDataIterator, default_collate, make_loader
from .lsp import LSP, LSP_mt
from .real_animal import Real_Animal_All, Real_Animal_All_mt, real_animal_all, real_animal_all_mt
from .rendered_hand_pose import RenderedHandPose, RenderedHandPose_mt
from .samplers import CombineDataset, RandomMultipleGallerySampler, concatenate
from .surreal import SURREAL
from .synthetic_animal import (
    Synthetic_Animal_SP_All,
    Synthetic_Animal_SP_All_Other,
    generate_data_file,
    synthetic_animal_sp_all,
    synthetic_animal_sp_all_other,
)

__all__ = [
    "Animal14KeypointDataset", "Animal18KeypointDataset", "Body16KeypointDataset",
    "ForeverDataIterator", "FreiHand", "Hand21KeypointDataset", "Hand3DStudio",
    "Hand3DStudioAll", "Hand3DStudioAll_mt", "Hand3DStudio_mt", "Human36M", "Human36M_mt",
    "KeypointDataset", "LSP", "LSP_mt", "RenderedHandPose", "RenderedHandPose_mt",
    "SURREAL", "animal_pose", "animal_pose_mt", "default_collate", "generate_data_file",
    "make_loader", "real_animal_all", "real_animal_all_mt", "synthetic_animal_sp_all",
    "synthetic_animal_sp_all_other",
]
