"""Cluster-event kinds (port of `scheduler_plugins_tpu.api.events`).

The "Resource/Action" strings the store's mutators note
(`Cluster.note_event`) and a plugin's `events_to_register()` names: a pod
that plugin failed re-enters the queue only on one of its events. The kinds
of the objects the port's store holds (nodes, pods, PodGroups,
ElasticQuotas, NodeResourceTopologies, AppGroups, NetworkTopologies,
SeccompProfiles, PriorityClasses, PodDisruptionBudgets, Namespaces).
"""

from __future__ import annotations

NODE_ADD = "Node/Add"
NODE_UPDATE = "Node/Update"
NODE_DELETE = "Node/Delete"
POD_ADD = "Pod/Add"
POD_UPDATE = "Pod/Update"
POD_DELETE = "Pod/Delete"
POD_GROUP_ADD = "PodGroup/Add"
POD_GROUP_UPDATE = "PodGroup/Update"
POD_GROUP_DELETE = "PodGroup/Delete"
ELASTIC_QUOTA_ADD = "ElasticQuota/Add"
ELASTIC_QUOTA_UPDATE = "ElasticQuota/Update"
ELASTIC_QUOTA_DELETE = "ElasticQuota/Delete"
NRT_ADD = "NodeResourceTopology/Add"
NRT_UPDATE = "NodeResourceTopology/Update"
NRT_DELETE = "NodeResourceTopology/Delete"
APP_GROUP_ADD = "AppGroup/Add"
APP_GROUP_UPDATE = "AppGroup/Update"
APP_GROUP_DELETE = "AppGroup/Delete"
NETWORK_TOPOLOGY_ADD = "NetworkTopology/Add"
NETWORK_TOPOLOGY_UPDATE = "NetworkTopology/Update"
NETWORK_TOPOLOGY_DELETE = "NetworkTopology/Delete"
SECCOMP_PROFILE_ADD = "SeccompProfile/Add"
SECCOMP_PROFILE_UPDATE = "SeccompProfile/Update"
SECCOMP_PROFILE_DELETE = "SeccompProfile/Delete"
PRIORITY_CLASS_ADD = "PriorityClass/Add"
PRIORITY_CLASS_UPDATE = "PriorityClass/Update"
PRIORITY_CLASS_DELETE = "PriorityClass/Delete"
PDB_ADD = "PodDisruptionBudget/Add"
PDB_UPDATE = "PodDisruptionBudget/Update"
PDB_DELETE = "PodDisruptionBudget/Delete"
NAMESPACE_ADD = "Namespace/Add"
NAMESPACE_UPDATE = "Namespace/Update"
