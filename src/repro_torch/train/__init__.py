from .checkpoint import latest_step, load_checkpoint, save_checkpoint
from .fault import PreemptionHandler, StragglerMonitor
from .trainer import TrainConfig, Trainer, init_train_state, make_train_step

__all__ = ["Trainer", "TrainConfig", "make_train_step", "init_train_state",
           "save_checkpoint", "load_checkpoint", "latest_step",
           "PreemptionHandler", "StragglerMonitor"]
