"""Runtime state of the HTTP fan-out: the per-job result queues."""
