"""Placement-quality telemetry and hard-constraint oracles (port of
`scheduler_plugins_tpu.tuning`): the per-cycle objectives `run_cycle`
stamps on its report, their tensor gauges, and the replay oracles
(`gates`) that certify a packing solve. The counterfactual sweep and the
tuner come with their slice."""
