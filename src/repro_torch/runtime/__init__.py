from .controller import (SimulatedFailure, TrainController, run_resilient)

__all__ = ["TrainController", "SimulatedFailure", "run_resilient"]
