"""Runnable examples of the port, each run as
``python -m repro_torch.examples.<name>`` (see this directory's README.md).
"""
