"""Plain references the benchmark judges the program against. A module
here imports NumPy and the standard library only: nothing of the
program, nothing of JAX.

A configuration names its reference (`reference`: `<name>.py` here),
which has a `Reference(nodes, plugins, broken=None)` over the cluster's
nodes at set-up (`traffic.NodeSpec`), the profile's plugins and, for the
control, the guarantee to break. It offers
- `add(record)`: every record of the generator (`traffic` names the
  kinds), in the order the program got them; it raises
  `NotImplementedError` on a kind or a pod it does not model;
- `remove(uid)`: a pod deleted;
- `pending()`: the pending pods, in queue order;
- `judge(bound, reserved, preempted, pending)`: the program's outcome of
  a cycle, judged on the model without committing it: (overcommitted
  pods, stranded pods, or None where it cannot tell which pods are
  stranded);
- `cycle()`: its own cycle, committed: (bound, reserved, preempted);
- `apply(bound, reserved, preempted)`: the program's outcome, committed;
- `usage()`, `names`, `where`: the nodes' (N, 3) cpu, memory and pod
  count, their names, {uid: node index} of the bound pods.
An outcome is {uid: node} of the pods bound, {uid: node} of the Permit
reservations standing after the cycle, {preemptor uid: (nominated node,
[victim uids])}."""
