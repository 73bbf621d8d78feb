"""Cluster object model and resource vocabulary."""
