"""Runtime: seeded fault injection, the recovery loop and elastic restarts
(port of `repro.runtime`)."""
