"""Distributed runtime of the port: fault tolerance, straggler mitigation,
elastic re-meshing (``ft``, a copy of the reference's), and the
checkpoint/restart training driver (CPU-simulated cluster events around a
real train loop on the card)."""
from .ft import ElasticPlan, SimCluster, StragglerDetector, plan_elastic_remesh
from .driver import TrainDriver, TrainRunConfig

__all__ = ["SimCluster", "StragglerDetector", "ElasticPlan",
           "plan_elastic_remesh", "TrainDriver", "TrainRunConfig"]
