from repro_torch.train.loss import cross_entropy_loss
from repro_torch.train.state import TrainState, init_train_state
from repro_torch.train.step import eval_step, make_train_step, train_step

__all__ = ["TrainState", "cross_entropy_loss", "eval_step", "init_train_state",
           "make_train_step", "train_step"]
