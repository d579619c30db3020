"""``host_syncs``: the host's waits on the card a round, the mean
``host_syncs`` of the window's round records (the program's count of the
round's blocking sites: pageable host-to-device copies, its syncs, the
wait for the round's reads and the evaluation's read)."""


def read(ctx):
    rounds = [r["host_syncs"] for r in ctx.rounds
              if "host_syncs" in r]
    return sum(rounds) / len(rounds) if rounds else None
