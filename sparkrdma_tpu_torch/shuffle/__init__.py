"""Shuffle data plane: manager, writer, reader, resolver, map-output index."""
