"""AdaIN decoder pretraining CLIs of the port (the JAX package's
``adain/train/``): ``python -m uda_poseestimation_torch.adain.train_human``
and ``python -m uda_poseestimation_torch.adain.train_animal``."""
