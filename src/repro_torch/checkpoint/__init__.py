"""Checkpoints of the LM trainer (atomic, with retention and optional
NeurLZ-compressed weights) and fault tolerance (straggler watchdog,
failure injection, restart)."""
from .checkpoint import CheckpointManager
from .fault_tolerance import (FailureInjector, SimulatedFailure, StepWatchdog,
                              run_with_restarts)

__all__ = ["CheckpointManager", "FailureInjector", "SimulatedFailure",
           "StepWatchdog", "run_with_restarts"]
