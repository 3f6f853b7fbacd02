"""Animal UDA trainer of the port, synthetic hound and sheep to AnimalPose
(``python -m uda_poseestimation_torch.train_animal_other``, 14 keypoints).

The reference's train_animal_other.py is its train_animal.py with the
per-category evaluation on dog and sheep; this module runs
``train_animal.main`` with those categories, as the JAX package's does.
"""

from .train_animal import build_parser, main

if __name__ == "__main__":
    main(build_parser().parse_args(), eval_categories=("dog", "sheep"))
