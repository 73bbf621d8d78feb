"""Resilience: deterministic fault injection (`faults`). The solve
watchdog and the host solve come with their own slice."""
