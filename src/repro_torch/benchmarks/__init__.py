"""The paper's benchmark harness on the port (`benchmarks.run`)."""
