"""The LM substrate's data pipeline (`repro.data` on tensors)."""
