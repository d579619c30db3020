"""``graph_step_share``: the share of the window's client-steps that the
program replayed from CUDA graphs, in percent: the sum of the round
records' ``graph_steps`` over that of ``graph_steps + eager_steps``
(nothing where the program counts neither)."""


def read(ctx):
    rounds = [r for r in ctx.rounds
              if "graph_steps" in r and "eager_steps" in r]
    total = sum(r["graph_steps"] + r["eager_steps"] for r in rounds)
    if not total:
        return None
    return 100.0 * sum(r["graph_steps"] for r in rounds) / total
