"""Logical-axis sharding rules, divisibility-aware.

Port of `repro.sharding`.  Models annotate tensors with *logical* axis
names ("batch", "seq", "embed", "ffn", "heads", "kv_heads", "vocab",
"layers", ...); the launcher installs a mapping logical name -> mesh axes
with the mesh, and `logical_to_physical` resolves a leaf's names to a
partition spec **only for the dims whose size divides the mesh axes**
(gemma's one KV head on a 2-way model axis stays whole), each mesh axis
used once.

A partition spec here is a tuple with one entry per leading dim, each
None, an axis name or a tuple of axis names, trailing Nones dropped: the
entries of the `jax.sharding.PartitionSpec` the reference builds for the
same mesh shape.  `launch.mesh.shard_of` / `gather_full` cut a leaf into
this rank's block by one and put it back together.

`use_mesh(mesh, rules)` installs both in `launch.mesh`'s own state, so
`launch.mesh.active_mesh()` answers for them as for a mesh installed
alone.  Without an installed mesh every spec is empty and `hint` does
nothing.  `hint` checks the rank and returns its input: eager torch has
no sharding propagation to constrain (a difference by design; the
reference applies ``with_sharding_constraint``, which changes no value
either).  The reference's ``shard_map_compat`` has no meaning in torch.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

from repro_torch.launch import mesh as mesh_lib

AxisVal = Union[str, Tuple[str, ...], None]
Spec = Tuple[AxisVal, ...]

use_mesh = mesh_lib.use_mesh
active_mesh = mesh_lib.active_mesh


def mesh_axis_size(*names: str) -> int:
    mesh = active_mesh()
    if mesh is None:
        return 1
    size = 1
    for n in names:
        size *= mesh.shape.get(n, 1)
    return size


def logical_to_physical(logical: Sequence[Optional[str]],
                        shape: Sequence[int]) -> Spec:
    """Resolve logical names to a partition spec under the active mesh and
    rules, dropping axes whose size does not divide the dim."""
    mesh, rules = active_mesh(), mesh_lib.active_rules()
    if mesh is None:
        return ()
    spec = []
    used: set = set()
    for name, dim in zip(logical, shape):
        phys = rules.get(name) if name else None
        if phys is None:
            spec.append(None)
            continue
        axes = (phys,) if isinstance(phys, str) else tuple(phys)
        axes = tuple(a for a in axes if a not in used and a in mesh.shape)
        size = 1
        for a in axes:
            size *= mesh.shape[a]
        if size <= 1 or dim % size != 0:
            spec.append(None)
            continue
        used.update(axes)
        spec.append(axes[0] if len(axes) == 1 else axes)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def model_dim(spec: Spec, axis: str = "model") -> Optional[int]:
    """The dim ``spec`` shards over ``axis`` alone, None where no dim is
    (a dim sharded over ``axis`` and another axis is not)."""
    for dim, entry in enumerate(spec):
        if entry == axis or entry == (axis,):
            return dim
    return None


def hint(x, *logical: Optional[str]):
    """The reference's sharding constraint by logical names: the rank is
    checked under a mesh, and ``x`` comes back unchanged."""
    if active_mesh() is None:
        return x
    if len(logical) != x.ndim:
        raise ValueError(f"hint rank mismatch: {logical} vs "
                         f"{tuple(x.shape)}")
    return x


#: default logical->physical rules used by the launcher.  "fsdp" combines the
#: pod and data axes (params + optimizer state ZeRO-3 sharded across both).
DEFAULT_RULES: Dict[str, AxisVal] = {
    "batch": ("pod", "data"),
    "seq": None,                # sequence stays unsharded in activations
    "act_seq": None,            # residual-carry seq sharding (SP) — opt-in
                                # via rules override ("model") in the launcher
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "qkv": "model",
    "ffn": "model",
    "vocab": "model",
    "experts": "model",
    "expert_ffn": None,
    "fsdp": ("pod", "data"),
    "layers": None,
    "kv_seq": None,
    "state": None,
    # RMW tables (core/rmw_sharded.py): owner-major over the EP/model axis,
    # matching the subsystem's slot->shard layout (g // m_local)
    "rmw_table": "model",
}


def rule_axes(rules: Dict[str, AxisVal]) -> set:
    """Every mesh axis name the rules map a logical name onto."""
    out: set = set()
    for phys in rules.values():
        if phys is not None:
            out.update((phys,) if isinstance(phys, str) else phys)
    return out
