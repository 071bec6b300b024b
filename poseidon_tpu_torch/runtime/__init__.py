"""Runtime of the port: checkpoints (CNN and LM), metrics, retry, CLI."""
