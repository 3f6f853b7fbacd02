"""Training steps of the port (single device; multi-GPU comes later)."""

from .train_step import (StepConfig, UDAState, create_state, draw_occlusion,
                         make_adapt_step, make_eval_step, make_pretrain_step,
                         make_tx)

__all__ = ["StepConfig", "UDAState", "create_state", "draw_occlusion",
           "make_adapt_step", "make_eval_step", "make_pretrain_step", "make_tx"]
