"""Training of the port: steps, optimizer, checkpoints, Trainer."""
from .checkpoint import load_checkpoint, load_checkpoint_raw, save_checkpoint
from .state import TrainState, create_train_state, make_optimizer
from .steps import (FAMILY_OF_MODEL, LossConfig, make_eval_step,
                    make_multi_train_step, make_train_step)
from .trainer import (Trainer, get_trainer, loss_config_from_args,
                      weight_annealing_schedule)

__all__ = ["FAMILY_OF_MODEL", "LossConfig", "TrainState", "Trainer",
           "create_train_state", "get_trainer", "load_checkpoint",
           "load_checkpoint_raw", "loss_config_from_args", "make_eval_step",
           "make_multi_train_step", "make_optimizer", "make_train_step",
           "save_checkpoint", "weight_annealing_schedule"]
