"""Benchmarks of the port's simulator (`python -m repro_torch.benchmarks.<name>`)."""
