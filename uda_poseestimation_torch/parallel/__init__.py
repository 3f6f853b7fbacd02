"""Training steps of the port, on one device or on one device a rank of a
process group (``distributed``, ``sync_bn``)."""

from .train_step import (AdaptStepBundler, PretrainStepBundler, StepConfig, UDAState,
                         create_state, draw_occlusion, make_adapt_step, make_capturable,
                         make_eval_step, make_pretrain_step, make_tx)

__all__ = ["AdaptStepBundler", "PretrainStepBundler", "StepConfig", "UDAState",
           "create_state", "draw_occlusion", "make_adapt_step", "make_capturable",
           "make_eval_step", "make_pretrain_step", "make_tx"]
