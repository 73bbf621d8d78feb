"""Cluster-event kinds (port of `scheduler_plugins_tpu.api.events`).

The "Resource/Action" strings the store's mutators note
(`Cluster.note_event`) and a plugin's `events_to_register()` names: a pod
that plugin failed re-enters the queue only on one of its events. The
table is the one copy of the strings, so a registration can be checked
against the kinds the store emits (`EVENT_KINDS`).

It is also the delta taxonomy of the serving engine (`serving.deltas`):
`NODE_COLUMN_EVENTS` names the kinds that can change the resident node
tensors, and `SERVE_REBASE_EVENTS` the kinds whose effects the O(changed)
scatter-adds cannot express (row order), on which the engine rebuilds.
The `LIFECYCLE_*` kinds are the pod-lifecycle ledger's transitions, never
store mutations.
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
NAMESPACE_DELETE = "Namespace/Delete"

#: every kind the store can emit: a registration naming another kind could
#: never fire
EVENT_KINDS = frozenset({
    NODE_ADD, NODE_UPDATE, NODE_DELETE,
    POD_ADD, POD_UPDATE, POD_DELETE,
    POD_GROUP_ADD, POD_GROUP_UPDATE, POD_GROUP_DELETE,
    ELASTIC_QUOTA_ADD, ELASTIC_QUOTA_UPDATE, ELASTIC_QUOTA_DELETE,
    NRT_ADD, NRT_UPDATE, NRT_DELETE,
    APP_GROUP_ADD, APP_GROUP_UPDATE, APP_GROUP_DELETE,
    NETWORK_TOPOLOGY_ADD, NETWORK_TOPOLOGY_UPDATE, NETWORK_TOPOLOGY_DELETE,
    SECCOMP_PROFILE_ADD, SECCOMP_PROFILE_UPDATE, SECCOMP_PROFILE_DELETE,
    PRIORITY_CLASS_ADD, PRIORITY_CLASS_UPDATE, PRIORITY_CLASS_DELETE,
    NAMESPACE_ADD, NAMESPACE_UPDATE, NAMESPACE_DELETE,
    PDB_ADD, PDB_UPDATE, PDB_DELETE,
})

#: kinds whose effects land entirely in the resident node tensors (alloc,
#: capacity, mask, usage columns): the serving engine applies them as
#: O(changed) scatter-adds
NODE_COLUMN_EVENTS = frozenset({
    NODE_ADD, NODE_UPDATE, POD_ADD, POD_UPDATE, POD_DELETE,
})

#: kinds that invalidate the resident row order: the serving engine
#: rebuilds from a full snapshot when one fires
SERVE_REBASE_EVENTS = frozenset({NODE_DELETE})

# -- pod-lifecycle ledger transitions ---------------------------------------
#: the ledger's transition vocabulary: not store mutation kinds (never in
#: `EVENT_KINDS` or requeue gating), registered here so every seam spells
#: one set of strings
LIFECYCLE_FIRST_SEEN = "PodLifecycle/FirstSeen"
LIFECYCLE_WAIT = "PodLifecycle/Wait"
LIFECYCLE_UNSCHEDULABLE = "PodLifecycle/Unschedulable"
LIFECYCLE_NOMINATED = "PodLifecycle/Nominated"
LIFECYCLE_NOMINATION_CLEARED = "PodLifecycle/NominationCleared"
LIFECYCLE_RESERVED = "PodLifecycle/Reserved"
LIFECYCLE_BOUND = "PodLifecycle/Bound"
LIFECYCLE_TERMINATING = "PodLifecycle/Terminating"
LIFECYCLE_DELETED = "PodLifecycle/Deleted"
LIFECYCLE_GATE = "PodLifecycle/Gate"

#: every transition the ledger can record
LIFECYCLE_KINDS = frozenset({
    LIFECYCLE_FIRST_SEEN, LIFECYCLE_WAIT, LIFECYCLE_UNSCHEDULABLE,
    LIFECYCLE_NOMINATED, LIFECYCLE_NOMINATION_CLEARED, LIFECYCLE_RESERVED,
    LIFECYCLE_BOUND, LIFECYCLE_TERMINATING, LIFECYCLE_DELETED,
    LIFECYCLE_GATE,
})
assert not (LIFECYCLE_KINDS & EVENT_KINDS)

#: the kinds a rank-aware gang phase emits or gates on: elastic growth
#: arrives as Pod/Add, binds as Pod/Update, shrink as Pod/Delete, spec
#: changes as PodGroup/Update
GANG_EVENTS = frozenset({
    POD_ADD, POD_UPDATE, POD_DELETE,
    POD_GROUP_ADD, POD_GROUP_UPDATE, POD_GROUP_DELETE,
    NODE_ADD, NODE_UPDATE,
    NETWORK_TOPOLOGY_ADD, NETWORK_TOPOLOGY_UPDATE,
})
assert GANG_EVENTS <= EVENT_KINDS
