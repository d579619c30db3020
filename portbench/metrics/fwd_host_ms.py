"""``fwd_host_ms``: the host's time in the client-steps' forward a round,
the mean ``step_forward_seconds`` of the window's round records (setting
the block's values, the model's loss, the algorithm's penalty and the
regulariser, summed over every client-step; host clock, no sync)."""


def read(ctx):
    rounds = [r["step_forward_seconds"] for r in ctx.rounds
              if "step_forward_seconds" in r]
    return 1e3 * sum(rounds) / len(rounds) if rounds else None
