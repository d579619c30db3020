"""``train_ms``: the local epoch's time a round, the mean
``train_seconds`` of the window's round records (the program's span; on a
fused round it holds the comm step too)."""


def read(ctx):
    rounds = [r["train_seconds"] for r in ctx.rounds if "train_seconds" in r]
    return 1e3 * sum(rounds) / len(rounds) if rounds else None
