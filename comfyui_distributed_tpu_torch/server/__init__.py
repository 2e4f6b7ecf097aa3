"""The master/worker HTTP server of the fan-out."""
