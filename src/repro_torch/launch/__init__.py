"""Launchers of the port: the stencil and LM servers, the tuner, the sweep,
the fit, the trainer, the dry-run, and the multi-process stencil run."""
