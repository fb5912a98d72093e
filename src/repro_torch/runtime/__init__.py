from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.runtime.straggler import StragglerMonitor
