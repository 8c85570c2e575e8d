"""Launchers of the port: the stencil request-queue server and its telemetry."""
