"""``comm_dev_ms``: the comm step's time on the card a round, the mean
``comm_device_seconds`` of the window's round records: the program's own
CUDA events at the entry and exit of its comm step, read after the
round's wait (inside the benchmark's events of ``comm_ms``)."""


def read(ctx):
    rounds = [r["comm_device_seconds"] for r in ctx.rounds
              if "comm_device_seconds" in r]
    return 1e3 * sum(rounds) / len(rounds) if rounds else None
