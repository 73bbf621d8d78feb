"""Command-line tools of the port (`python -m
scheduler_plugins_tpu_torch.tools.<name>`)."""
