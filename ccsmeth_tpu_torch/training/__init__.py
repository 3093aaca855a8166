from .train import TrainConfig, train
from .optim import build_optimizer, LrSchedule

__all__ = ["TrainConfig", "train", "build_optimizer", "LrSchedule"]
