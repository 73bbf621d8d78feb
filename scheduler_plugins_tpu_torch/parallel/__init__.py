"""The batched solver over node rank blocks and its exchange kernels."""
