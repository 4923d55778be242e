"""Core of the port: placement, cost model, RMW semantics, engine, BFS.

Submodules are imported by name (`repro_torch.core.rmw`, ...); this package
module imports nothing so that importing one of them stays cheap.
"""
