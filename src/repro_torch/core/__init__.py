"""The paper's primary contribution: the KubeAdaptor docking framework."""
from repro_torch.core.calibration import (DEFAULT_CLUSTER, DEFAULT_PARAMS,
                                    ClusterParams, PaperCluster)
from repro_torch.core.cluster import Cluster, PodObj
from repro_torch.core.dag import Task, Workflow, make_workflow, parse_configmap
from repro_torch.core.engine import KubeAdaptorEngine
from repro_torch.core.injector import StreamSpec, WorkflowGateway, WorkflowInjector
from repro_torch.core.resources import (ADMISSION_POLICIES, AdmissionArbiter,
                                  ResourceGatherer)
from repro_torch.core.runner import (ENGINES, ControlPlane, RunResult,
                               run_experiment)
from repro_torch.core.sim import Sim

__all__ = [
    "ClusterParams", "PaperCluster", "DEFAULT_PARAMS", "DEFAULT_CLUSTER",
    "Cluster", "PodObj", "Task", "Workflow", "make_workflow",
    "parse_configmap", "KubeAdaptorEngine", "ENGINES", "RunResult",
    "run_experiment", "Sim", "ControlPlane", "StreamSpec", "WorkflowGateway",
    "WorkflowInjector", "AdmissionArbiter", "ResourceGatherer",
    "ADMISSION_POLICIES",
]
