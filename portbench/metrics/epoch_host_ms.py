"""``epoch_host_ms``: the host's time in the local epoch a round, the mean
``epoch_host_seconds`` of the window's round records: the program's
``train_epoch`` calls from entry to return on the host clock, with no
sync, so the time to enqueue the epoch (in the host-paced cells close to
``train_ms``; where the launch queue fills, the card's pace)."""


def read(ctx):
    rounds = [r["epoch_host_seconds"] for r in ctx.rounds
              if "epoch_host_seconds" in r]
    return 1e3 * sum(rounds) / len(rounds) if rounds else None
