from repro_torch.runtime.trainer import Trainer, TrainConfig

__all__ = ["Trainer", "TrainConfig"]
