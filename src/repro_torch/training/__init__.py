"""Training steps of the port (`repro.training`): the generic fit step."""
