"""``bwd_host_ms``: the host's time in the client-steps' backward a round,
the mean ``step_backward_seconds`` of the window's round records
(``torch.autograd.grad`` summed over every client-step; host clock, no
sync)."""


def read(ctx):
    rounds = [r["step_backward_seconds"] for r in ctx.rounds
              if "step_backward_seconds" in r]
    return 1e3 * sum(rounds) / len(rounds) if rounds else None
