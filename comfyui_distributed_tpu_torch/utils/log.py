"""The port's log lines: ``dtpu-torch <message>`` on standard output,
flushed, one a line (``chip_smoke.py`` reads the servers' logs)."""


def log(msg: str) -> None:
    print(f"dtpu-torch {msg}", flush=True)
