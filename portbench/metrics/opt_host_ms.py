"""``opt_host_ms``: the host's time in the client-steps' optimizer a
round, the mean ``step_optimizer_seconds`` of the window's round records
(Adam's update summed over every client-step, or a whole L-BFGS step;
host clock, no sync)."""


def read(ctx):
    rounds = [r["step_optimizer_seconds"] for r in ctx.rounds
              if "step_optimizer_seconds" in r]
    return 1e3 * sum(rounds) / len(rounds) if rounds else None
