"""Cluster-event kinds (port of `scheduler_plugins_tpu.api.events`).

The "Resource/Action" strings a plugin's `events_to_register()` names: a
pod that plugin failed re-enters the queue only on one of its events. The
kinds of the ported plugins only; the rest come with their plugins.
"""

from __future__ import annotations

NODE_ADD = "Node/Add"
NODE_UPDATE = "Node/Update"
POD_ADD = "Pod/Add"
POD_DELETE = "Pod/Delete"
POD_GROUP_ADD = "PodGroup/Add"
POD_GROUP_UPDATE = "PodGroup/Update"
ELASTIC_QUOTA_ADD = "ElasticQuota/Add"
ELASTIC_QUOTA_UPDATE = "ElasticQuota/Update"
ELASTIC_QUOTA_DELETE = "ElasticQuota/Delete"
