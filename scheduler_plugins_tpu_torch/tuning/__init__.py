"""Placement-quality telemetry (port of `scheduler_plugins_tpu.tuning`):
the per-cycle objectives `run_cycle` stamps on its report. The
counterfactual sweep and the tuner come with their slice."""
