"""The paper's measurement suites on the port (`python -m
repro_torch.benchmarks.run`): one module per table or figure, each a
``run(csv, ...)`` that prints ``name,us_per_call,derived`` rows."""
