from .controller import (SimulatedFailure, TrainController, deterministic,
                         run_resilient)

__all__ = ["TrainController", "SimulatedFailure", "deterministic",
           "run_resilient"]
