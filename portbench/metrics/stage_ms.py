"""``stage_ms``: the data layer's time a round, the mean ``stage_seconds``
of the window's round records (the program's span: staging an epoch's
rows or batches onto the card, ending in a sync while a recorder
writes)."""


def read(ctx):
    rounds = [r["stage_seconds"] for r in ctx.rounds if "stage_seconds" in r]
    return 1e3 * sum(rounds) / len(rounds) if rounds else None
