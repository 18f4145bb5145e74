from .config import TrainConfig, StepFlags
