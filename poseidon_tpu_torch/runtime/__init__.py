"""Runtime of the port: checkpoint reading, metrics, retry, CLI."""
