"""Training on one device (port of repro.train): AdamW in plain tensor
ops and the trainer with checkpoint-resume."""
from . import optim
from .trainer import Trainer, TrainerConfig, make_train_step
