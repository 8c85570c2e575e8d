"""The plain reference the benchmark judges the program's answers by."""
