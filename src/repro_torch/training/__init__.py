"""Training steps of the port (`repro.training`): the LM train, serve and
prefill steps and the generic fit step."""
