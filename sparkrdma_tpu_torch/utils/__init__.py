"""Cross-cutting utilities: lifecycle state machines, the debug lock,
the resource ledger, the block types, serializers and columnar
batches, the tracer and the wire-frame validator (copies of the JAX
package's ``utils/`` modules of the same names)."""
