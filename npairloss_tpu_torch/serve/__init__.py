"""The serving slice of the port: gallery indexes (flat and IVF), the
query engine, the micro-batcher and the JSONL server."""
