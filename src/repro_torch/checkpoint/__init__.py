"""Checkpointing of state trees with `AtomicTable` leaves (port of
`repro.checkpoint`)."""
