"""``busy_ms``: the card's busy time a round, over the rounds traced after
the window (``trace.reduce``'s union of device events): what a round
would take were the host never late.  It stands beside
``train_images_per_s``, which the host's pace moves, as the steadier
reading of the same work."""


def read(ctx):
    tr = ctx.trace
    if not tr or tr["busy_s"] <= 0 or not ctx.traced_rounds:
        return None
    return 1e3 * tr["busy_s"] / ctx.traced_rounds
