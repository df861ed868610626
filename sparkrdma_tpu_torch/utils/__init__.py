"""Cross-cutting utilities: lifecycle state machines, the debug lock,
the resource ledger and the block types (copies of the JAX package's
``utils/`` modules of the same names)."""
