"""``eval_ms``: the evaluation's time a round, the mean ``eval_seconds``
of the window's round records (the program's ``evaluate`` on the host
clock, ending in its read of the totals, so execution included)."""


def read(ctx):
    rounds = [r["eval_seconds"] for r in ctx.rounds
              if "eval_seconds" in r]
    return 1e3 * sum(rounds) / len(rounds) if rounds else None
