"""Shared storage: StorageClass/PVC/PV analogue + per-namespace data store.

Task data dependencies (the DAG edges) flow through a ``SharedVolume``
— the stand-in for the NFS-backed PersistentVolume every task pod of a
workflow mounts. Real ML payloads put/get numpy arrays (activations,
checkpoint refs); the stress workload just writes completion markers.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from repro_torch.core import calibration as cal
from repro_torch.core.cluster import Cluster
from repro_torch.core.sim import Sim


class SharedVolume:
    """The PV: a namespace-scoped key-value store (NFS directory analogue)."""

    def __init__(self, name: str):
        self.name = name
        self._data: Dict[str, Any] = {}

    def put(self, key: str, value: Any):
        self._data[key] = value

    def get(self, key: str, default=None):
        return self._data.get(key, default)

    def keys(self):
        return list(self._data)

    def __contains__(self, key):
        return key in self._data


class VolumeManager:
    """StorageClass + NFS provisioner: dynamic PVC->PV per workflow ns."""

    def __init__(self, sim: Sim, cluster: Cluster,
                 params: cal.ClusterParams = cal.DEFAULT_PARAMS):
        self.sim = sim
        self.cluster = cluster
        self.p = params
        self.volumes: Dict[str, SharedVolume] = {}

    def provision(self, namespace: str, cb: Optional[Callable] = None) -> str:
        """Create the namespace PVC; PV binds via StorageClass dynamically."""
        pvc_name = f"{namespace}-pvc"

        def bound(pvc):
            self.volumes[pvc_name] = SharedVolume(pvc_name)
            if cb:
                cb(pvc_name)

        self.cluster.create_pvc(namespace, pvc_name, cb=bound)
        return pvc_name

    def volume(self, pvc_name: str) -> Optional[SharedVolume]:
        return self.volumes.get(pvc_name)

    def release(self, namespace: str):
        self.volumes.pop(f"{namespace}-pvc", None)
