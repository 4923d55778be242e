"""Core of the port: placement, cost model, RMW semantics, engine, BFS.

Submodules are imported by name (`repro_torch.core.rmw`, ...).  The one
name this package module exports is `scatter_add_grads`, as the
reference's `repro.core` does; `core.rmw` imports only torch and numpy,
so importing the package stays cheap.
"""

from repro_torch.core.rmw import scatter_add_grads  # noqa: F401
