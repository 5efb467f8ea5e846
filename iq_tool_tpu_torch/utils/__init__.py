"""Host-side infrastructure: ring buffers, logging, watchdog, checkpoints."""
